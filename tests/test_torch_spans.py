"""The port's spans and counters (``gpmdm_tpu_torch.utils.profiling``) on
the CPU, on bench_assets/bench_model.npz at B = 2 banks of 32 particles:

- a bank step records ``pf.step`` once and each of its five stages once
  inside it; a scan of T frames one ``pf.scan`` and T steps; ``pf.init``
  each bank initialisation;
- a span's time holds the spans opened inside it, so a parent's own
  time is its time less its children's; the ring keeps the last ``RING``
  durations, counters add and ``reset`` clears;
- under ``torch.profiler`` the spans are host operations (``cpu_op``, not
  user annotations) nested as in the program, and the record stands
  still; ``record_function`` is never called, with or without a profiler;
- the set-up spans ``io.load_model``, ``pf.resolve_posterior`` and
  ``ops.library`` hold no other span, so their times add up;
- the private torch names the spans rest on exist.
"""

import statistics
import types
from pathlib import Path

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from gpmdm_tpu_torch import PFConfig
from gpmdm_tpu_torch.filter import particle_filter as tpf
from gpmdm_tpu_torch.ops import _build
from gpmdm_tpu_torch.utils import profiling
from gpmdm_tpu_torch.utils.io import load_model

ASSET = Path(__file__).resolve().parents[1] / "bench_assets" / "bench_model.npz"
STAGES = ("pf.transition", "pf.dynamics", "pf.observation", "pf.readouts", "pf.resample")
B, PB, T = 2, 32, 3


@pytest.fixture(scope="module")
def bank():
    model = load_model(ASSET, device="cpu")
    post = tpf.resolve_posterior(model, "auto")
    pf_cfg = PFConfig(num_particles=PB)
    log_T = torch.log(torch.tensor([[0.9, 0.1], [0.1, 0.9]], dtype=model.dtype))
    g = torch.Generator().manual_seed(5)
    states = tpf.pf_init_bank(post, model.layout.y_class_offsets, g, pf_cfg, B)
    Z = torch.randn(B, T, model.D, generator=g, dtype=model.dtype)
    return types.SimpleNamespace(model=model, post=post, pf_cfg=pf_cfg, log_T=log_T,
                                 states=states, Z=Z)


def _step(b, seed=0):
    g = torch.Generator().manual_seed(seed)
    m = b.model
    return tpf.pf_step_bank(b.states, b.Z[:, 0], b.post, m.params, b.log_T, m.config, b.pf_cfg,
                            generator=g)


@pytest.fixture
def fake_clock(monkeypatch):
    """``profiling``'s host clock, read from a list of nanoseconds."""
    ticks = []
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: ticks.pop(0)))
    return ticks


def test_step_records_pf_step_and_each_stage_once(bank):
    profiling.reset()
    _step(bank)
    spans = profiling.snapshot()["spans"]
    assert set(spans) == {"pf.step", *STAGES}
    assert all(spans[n]["calls"] == 1 and spans[n]["incl_ns"] > 0 for n in spans)
    step = spans["pf.step"]
    # the stages are pf.step's children: their time lies inside its time
    assert sum(spans[n]["incl_ns"] for n in STAGES) <= step["incl_ns"]
    assert step["ring"] == [step["incl_ns"]]


def test_scan_records_one_scan_and_a_step_a_frame(bank):
    m = bank.model
    profiling.reset()
    g = torch.Generator().manual_seed(1)
    _, outs = tpf.pf_scan_bank(bank.states, bank.Z, bank.post, m.params, bank.log_T, m.config,
                               bank.pf_cfg, generator=g)
    assert outs.class_probs.shape == (B, T, 2)
    spans = profiling.snapshot()["spans"]
    assert spans["pf.scan"]["calls"] == 1
    assert spans["pf.step"]["calls"] == T and len(spans["pf.step"]["ring"]) == T
    assert all(spans[n]["calls"] == T for n in STAGES)
    assert 0 < spans["pf.step"]["incl_ns"] <= spans["pf.scan"]["incl_ns"]


def test_init_bank_records_pf_init(bank):
    profiling.reset()
    tpf.pf_init_bank(bank.post, bank.model.layout.y_class_offsets,
                     torch.Generator().manual_seed(2), bank.pf_cfg, B)
    spans = profiling.snapshot()["spans"]
    assert list(spans) == ["pf.init"] and spans["pf.init"]["calls"] == 1


@pytest.mark.parametrize("profiler", ["off", "on"])
def test_step_never_calls_record_function(bank, monkeypatch, profiler):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    profiling.reset()
    if profiler == "on":
        with profile(activities=[ProfilerActivity.CPU]):
            _, out = _step(bank)
    else:
        _, out = _step(bank)
        assert profiling.snapshot()["spans"]["pf.step"]["calls"] == 1
    assert torch.isfinite(out.class_probs).all()


def test_spans_under_the_profiler_are_cpu_ops_inside_pf_step(bank):
    profiling.reset()
    _step(bank)
    before = profiling.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(bank)
    assert profiling.snapshot() == before
    events = {}
    for e in prof.events():
        if e.name in ("pf.step", *STAGES):
            assert e.name not in events
            events[e.name] = e
    assert set(events) == {"pf.step", *STAGES}
    step = events["pf.step"].time_range
    for name, e in events.items():
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert e.is_user_annotation is False
        if name != "pf.step":
            assert step.start <= e.time_range.start <= e.time_range.end <= step.end
            assert e.cpu_parent is events["pf.step"]


def test_ring_keeps_the_last_entries_and_its_median(fake_clock):
    profiling.reset()
    n = profiling.RING + 6
    for i in range(1, n + 1):
        fake_clock += [0, i]
        with profiling.span("x"):
            pass
    rec = profiling.snapshot()["spans"]["x"]
    assert rec["calls"] == n and rec["incl_ns"] == n * (n + 1) // 2
    assert rec["ring"] == list(range(7, n + 1)) and len(rec["ring"]) == profiling.RING
    assert statistics.median(rec["ring"]) == (7 + n) / 2


def test_self_time_leaves_out_children_only(fake_clock):
    """Each span's time holds its children's, so a span's own time is its
    time less that of the spans it opens, and no more."""
    profiling.reset()
    # parent 0..100; children 10..30 and 40..45 (a grandchild 41..44)
    fake_clock += [0, 10, 30, 40, 41, 44, 45, 100]
    with profiling.span("p"):
        with profiling.span("c"):
            pass
        with profiling.span("c"):
            with profiling.span("g"):
                pass
    spans = profiling.snapshot()["spans"]
    assert (spans["p"]["calls"], spans["p"]["incl_ns"]) == (1, 100)
    assert (spans["c"]["calls"], spans["c"]["incl_ns"], spans["c"]["ring"]) == (2, 25, [20, 5])
    assert (spans["g"]["calls"], spans["g"]["incl_ns"]) == (1, 3)
    assert spans["p"]["incl_ns"] - spans["c"]["incl_ns"] == 75
    assert spans["c"]["incl_ns"] - spans["g"]["incl_ns"] == 22


def test_span_records_when_its_region_raises(fake_clock):
    profiling.reset()
    fake_clock += [0, 7]
    with pytest.raises(ValueError):
        with profiling.span("boom"):
            raise ValueError
    assert profiling.snapshot()["spans"]["boom"] == {"calls": 1, "incl_ns": 7, "ring": [7]}
    fake_clock += [10, 12]
    with profiling.span("after"):
        pass
    assert profiling.snapshot()["spans"]["after"]["incl_ns"] == 2


def test_counter_adds_and_reset_clears():
    profiling.reset()
    for name in ("a", "a", "b", "a"):
        profiling.counter(name)
    with profiling.span("s"):
        pass
    snap = profiling.snapshot()
    assert snap["counters"] == {"a": 3, "b": 1} and snap["spans"]["s"]["calls"] == 1
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_setup_spans_hold_no_other_span(monkeypatch):
    """``io.load_model``, ``pf.resolve_posterior`` and ``ops.library`` open
    no span inside them, so none runs inside another and their sum counts
    no second of set-up twice.  ``ops.library`` runs once a process: a
    build is stood in for, and its cache cleared around."""
    opened, nested = [], []
    enter, leave = profiling.span.__enter__, profiling.span.__exit__

    def watch_enter(self):
        if opened:
            nested.append((opened[-1], self.name))
        opened.append(self.name)
        return enter(self)

    def watch_exit(self, *exc):
        opened.pop()
        return leave(self, *exc)

    monkeypatch.setattr(profiling.span, "__enter__", watch_enter)
    monkeypatch.setattr(profiling.span, "__exit__", watch_exit)
    profiling.reset()
    model = load_model(ASSET, device="cpu")
    tpf.resolve_posterior(model, "auto")
    stub = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in _build._SIGNATURES})
    monkeypatch.setattr(_build, "build", lambda defines=(): Path("stub.so"))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: stub)
    _build.library.cache_clear()
    try:
        assert _build.library(("STUB",)) is stub and _build.library(("STUB",)) is stub
    finally:
        _build.library.cache_clear()
    spans = profiling.snapshot()["spans"]
    assert nested == [] and opened == []
    assert set(spans) == {"io.load_model", "pf.resolve_posterior", "ops.library"}
    for name in spans:
        assert spans[name]["calls"] == 1 and spans[name]["incl_ns"] > 0


def test_private_torch_names_exist():
    """The flag a span reads and the host operation it enters under a
    profiler are private to torch: an upgrade that moves either fails
    here."""
    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        rf = torch._C._profiler._RecordFunctionFast("probe")
        rf.__enter__()
        rf.__exit__(None, None, None)
    assert autograd_profiler._is_profiler_enabled is False
    assert profiling._RecordFunctionFast is torch._C._profiler._RecordFunctionFast
