"""The last line of a run: exactly the contract's keys, ``checks`` last,
and the cell's own metrics; the traced line's device fields and
breakdown; each reader on a summary it can and cannot read."""

import json
import time

import pytest
import torch

from perfbench import harness

SMALL = {"streams": 2, "particles": 300, "frames_per_stream": 240, "check_banks": 2}


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(2)
    return harness.run_cell("d4_live_b32_p10k", 2**31 + 11, 0.5, False, "cpu",
                            time.perf_counter(), overrides=SMALL)


def test_line_keys(run):
    line = harness.result_line(run, "cpu", 1, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    spec = harness.load_spec()
    want = {m["name"] for m in spec["end_to_end"] if harness.applies(m, "d4_live_b32_p10k")}
    assert set(line["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["checks"]) == set(harness.load_json("workloads", "d4_live_b32_p10k")["limits"])
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    json.loads(json.dumps(line))


def test_traced_line_keys(run):
    prof = {"steps": 4, "window_s": 0.5, "busy_s": 0.4, "kernels": {},
            "breakdown": {"device_ops": [["k", 0.1]], "idle_gaps": [["aten::copy_", 0.01]]}}
    line = harness.result_line({**run, "profile": prof}, "cpu", 1, True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["device"]["busy_s"] == 0.4 and line["device"]["window_s"] == 0.5


def _summary(kind, kernels, work=None):
    return {"kind": kind, "timed": {"steps": 100, "seconds": 2.0, "frame_p95_ms": 13.0},
            "profile": {"steps": 10, "window_s": 0.2, "busy_s": 0.15, "kernels": kernels},
            "model_flops_per_step": 2.0e11, "work": work or {}, "peaks": (67e12, 3.35e12)}


def test_readers():
    kernels = {"void (anonymous namespace)::posterior_core<128, 2>(float)": (10, 0.05),
               "void (anonymous namespace)::x_onepass<128, 512>(float)": (10, 0.01),
               "void kernel_trsm_l_mul32<float, 8>": (20, 0.02),
               "Memcpy HtoD (Pinned -> Device)": (10, 0.001)}
    work = {"k1": (6.7e10, 1e6), "k2": (3.35e11, 1e6)}
    s = _summary("filter", kernels, work)
    read = lambda name: harness.load_module("metrics", name).read(s)  # noqa: E731
    assert read("kernels_per_frame") == 4.0
    assert read("trsm_ms_per_frame") == pytest.approx(2.0)
    # K2: 5 ms least time over 5 ms a step; K1: 1 ms over 1 ms
    assert read("k2_roofline") == pytest.approx(100.0)
    assert read("k1_roofline") == pytest.approx(100.0)
    assert read("mfu.filter") == pytest.approx(100 * 2e11 * 50 / 67e12)
    # 15 busy ms a profiled step against 20 wall ms a step untraced
    assert read("idle_share.filter") == pytest.approx(25.0)
    assert read("frame_p95_ms") == 13.0
    t = _summary("train", {"sm80_xmma_gemm_f32f32": (30, 0.01)})
    for name in ("kernels_per_frame", "k1_roofline", "k2_roofline", "trsm_ms_per_frame",
                 "mfu.filter", "idle_share.filter"):
        assert harness.load_module("metrics", name).read(t) is None


def test_idle_share_takes_the_untraced_step():
    """The profiler's own span plays no part: the same busy time a step
    reads the same share whatever the profiled stretch's wall time."""
    read = harness.load_module("metrics", "idle_share.filter").read
    s = _summary("filter", {})
    slow = {**s, "profile": {**s["profile"], "window_s": 0.9}}
    assert read(slow) == read(s) == pytest.approx(25.0)
