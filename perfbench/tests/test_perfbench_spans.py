"""The readers of the program's own spans, ``host_ms_per_frame`` and
``program_setup_s``, on a record that a small run of a filter cell fills
on the CPU, on a training summary and on an empty record."""

import time

import pytest
import torch

from perfbench import harness

SMALL = {"streams": 2, "particles": 300, "frames_per_stream": 240, "check_banks": 2}
READERS = ("host_ms_per_frame", "program_setup_s")


#: Host seconds that the loop spends after each step, outside the program
#: (on the card: the readouts' wait and the loop's own Python).  On the CPU
#: the step's work is done on the host, inside the span, and leaves the
#: loop too little else for the comparison to be told from the noise.
AFTER_STEP_S = 0.003


def _wrap(kind, fn):
    if kind != "step":
        return fn

    def step(*args):
        out = fn(*args)
        time.sleep(AFTER_STEP_S)
        return out

    return step


@pytest.fixture(scope="module")
def run():
    from gpmdm_tpu_torch.utils import profiling

    torch.set_num_threads(2)
    profiling.reset()
    out = harness.run_cell("d4_live_b32_p10k", 2**31 + 29, 0.5, False, "cpu",
                           time.perf_counter(), overrides=SMALL, wrap=_wrap)
    return out, profiling.snapshot()


def _summary(kind, timed):
    return {"kind": kind, "timed": timed, "profile": None, "model_flops_per_step": 0.0,
            "work": {}, "peaks": (67e12, 3.35e12)}


def _read(name, summary):
    return harness.load_module("metrics", name).read(summary)


def test_host_ms_per_frame_is_within_the_window_step(run):
    out, snap = run
    timed = out["timed"]
    got = _read("host_ms_per_frame", _summary("filter", timed))
    assert snap["spans"]["pf.step"]["calls"] >= timed["steps"]
    assert 0 < got <= 1e3 * timed["seconds"] / timed["steps"]


def test_program_setup_s_is_part_of_setup_s(run):
    out, snap = run
    got = _read("program_setup_s", _summary("filter", out["timed"]))
    spans = snap["spans"]
    assert spans["io.load_model"]["calls"] == spans["pf.resolve_posterior"]["calls"] == 1
    # no card: the kernels' library is never loaded
    assert "ops.library" not in spans
    want = (spans["io.load_model"]["incl_ns"] + spans["pf.resolve_posterior"]["incl_ns"]) * 1e-9
    assert got == pytest.approx(want)
    assert 0 < got < out["e2e"]["setup_s"]


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_of_training_or_an_empty_record(run, name):
    from gpmdm_tpu_torch.utils import profiling

    timed = run[0]["timed"]
    assert _read(name, _summary("train", timed)) is None
    profiling.reset()
    assert _read(name, _summary("filter", timed)) is None
