"""The port's utilities on the CPU: ``utils.profiling`` (the torch.profiler
trace, with the program's spans in it; the spans themselves are
tests/test_torch_spans.py's), ``utils.debug`` (the finiteness
checks that stand in for checkify) and the additions to
``utils.asset_guard`` (``guard_score`` at a small particle count,
``make_receipt``'s platform, ``load_asset``'s class and
``params_fingerprint`` equal to the JAX package's, which the committed
receipts carry).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import threadpoolctl
import torch

from gpmdm_tpu import GPMDM as JGPMDM
from gpmdm_tpu.utils import asset_guard as jguard
from gpmdm_tpu_torch import BCGPMDM, GPMDM, SparseGPMDM
from gpmdm_tpu_torch.data import synthetic
from gpmdm_tpu_torch.models import core
from gpmdm_tpu_torch.utils import asset_guard as tguard
from gpmdm_tpu_torch.utils import debug, profiling

ASSETS = Path(__file__).resolve().parents[1] / "bench_assets"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with threadpoolctl.threadpool_limits(1):
        yield


def _small_model(cls=GPMDM, **kw):
    tr, tl, _, _ = synthetic.make_dataset(n_classes=2, n_train_seqs=2, n_test_seqs=1,
                                          seq_len=30, D=8, seed=3)
    m = cls(D=8, d=2, n_classes=2, dtype="float64", y_sigma_n_init=0.1, x_sigma_n_init=0.1,
            device="cpu", **kw)
    for Y, c in zip(tr, tl):
        m.add_data(Y, c)
    m.init_X()
    return m


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    """``trace`` writes a Chrome trace in which the program's spans show as
    host operations (``cpu_op``) beside aten's."""
    from gpmdm_tpu_torch import PFConfig
    from gpmdm_tpu_torch.filter import particle_filter as tpf
    from gpmdm_tpu_torch.utils.io import load_model

    m = load_model(ASSETS / "bench_model.npz", device="cpu")
    post = tpf.resolve_posterior(m, "auto")
    pf_cfg = PFConfig(num_particles=16)
    g = torch.Generator().manual_seed(0)
    states = tpf.pf_init_bank(post, m.layout.y_class_offsets, g, pf_cfg, 2)
    log_T = torch.log(torch.tensor([[0.9, 0.1], [0.1, 0.9]], dtype=m.dtype))
    with profiling.trace(str(tmp_path)) as prof:
        tpf.pf_step_bank(states, torch.zeros(2, m.D, dtype=m.dtype), post, m.params, log_T,
                         m.config, pf_cfg, generator=g)
    assert prof.key_averages()
    (path,) = tmp_path.glob("trace_*.json")
    cats = {e.get("name"): e.get("cat") for e in json.loads(path.read_text())["traceEvents"]}
    assert cats["pf.step"] == cats["pf.dynamics"] == "cpu_op"
    assert "aten::bmm" in cats


def test_checked_passes_finite_work_and_names_the_first_non_finite_op():
    m = _small_model()
    assert debug.check_loss(m) == pytest.approx(m.gpdm_loss(), rel=1e-12)
    Y = torch.as_tensor(m.get_Y())
    assert torch.isfinite(debug.checked(core.nll, m.params, Y, m.config, m.layout))
    bad = dataclasses.replace(m.params, X=m.params.X * float("nan"))
    with pytest.raises(FloatingPointError, match="sqrt"):
        debug.checked(lambda p: torch.sqrt(p.X.sum() * 0 - 1.0), m.params)
    with pytest.raises(FloatingPointError, match="log"):
        debug.checked(lambda t: torch.log(t - 2.0), torch.ones(3))
    with pytest.raises(FloatingPointError, match="non-finite result"):
        debug.checked(lambda p: p.X.sum(), bad)


def test_guard_score_is_the_guard_reports_frame_metrics():
    m = GPMDM.load(ASSETS / "bench_model.npz", device="cpu")
    acc, f1 = tguard.guard_score(m, "headlinef", particles=32)
    rep = tguard.guard_report(m, "headlinef", particles=32)
    assert (acc, f1) == (rep.frame_metrics["accuracy"], rep.frame_metrics["f1"])
    assert 0.5 < acc <= 1.0 and 0.0 < f1 <= 1.0


def test_receipt_fingerprint_and_load_asset(tmp_path):
    """params_fingerprint equals the JAX package's and the committed
    receipt's; make_receipt has the JAX package's keys with the port's
    platform; load_asset loads each family as its class."""
    path = ASSETS / "bench_model.npz"
    tm, jm = tguard.load_asset(path, device="cpu"), JGPMDM.load(path)
    fp = tguard.params_fingerprint(tm.params)
    assert fp == jguard.params_fingerprint(jm.params) == tm._guard_receipt["params_sha256"]
    receipt = tguard.make_receipt(tm, "headlinef", 500, 0.987654, 0.9)
    jreceipt = jguard.make_receipt(jm, "headlinef", 500, 0.987654, 0.9)
    assert receipt.keys() == jreceipt.keys()
    assert receipt["platform"] == "cpu" and receipt["frame_acc"] == 0.9877
    assert {k: v for k, v in receipt.items() if k != "platform"} == {
        k: v for k, v in jreceipt.items() if k != "platform"}
    for cls, kw in ((GPMDM, {}), (SparseGPMDM, {"n_inducing_y": 8, "n_inducing_x": 8}),
                    (BCGPMDM, {})):
        p = tmp_path / f"{cls.__name__}.npz"
        _small_model(cls, **kw).save(p)
        assert type(tguard.load_asset(p, device="cpu")) is cls
    with np.load(path) as z:
        assert json.loads(bytes(z["meta_json"]).decode())["guard_receipt"]["platform"] == "tpu"
