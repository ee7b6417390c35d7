"""The sparse family's deployment in the port against the JAX package's, on
the CPU, on the committed assets: ``SparseGPMDM`` checkpoints
(``bench_model_hourlong.npz``, ``_hourlongh.npz``: Ny = 108,000, M = 128;
``_sparse10240.npz``), the ``sparsified_*`` caches of the exact assets
(c8's kmeans-128 and c8n5120's kmeans-384 recommendations, the headline
asset's stride-128 entry) and the ``'auto'`` policy on both families.

- The sparse assets load with the JAX package's parameters and factors,
  bit for bit, and with its Adam state (an L-BFGS state is not read).
- ``'auto'`` on c8 and c8n5120 returns the persisted cache entry itself,
  with no exact build and no distillation; on a ``SparseGPMDM`` it never
  builds a compressed posterior (at Ny = 108,000 that is a 93 GB
  eigendecomposition); a model that cannot honour a 'sparsified'
  recommendation warns as the JAX package does and falls back.
- Checkpoints round-trip port -> port, port -> JAX and JAX -> port, for a
  ``SparseGPMDM`` and for an exact model that holds a sparsified cache.
"""

import dataclasses
import json
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import threadpoolctl
import torch

from gpmdm_tpu import GPMDM as JGPMDM
from gpmdm_tpu import SparseGPMDM as JSparseGPMDM
from gpmdm_tpu.filter import particle_filter as jpf
from gpmdm_tpu_torch import GPMDM, GPMDM_PF, PFConfig, SparseGPMDM
from gpmdm_tpu_torch.filter import particle_filter as tpf
from gpmdm_tpu_torch.models import compressed as tcomp
from gpmdm_tpu_torch.models import core as tcore
from gpmdm_tpu_torch.models import sparse as tsp
from gpmdm_tpu_torch.utils import asset_guard as tguard
from gpmdm_tpu_torch.utils.io import load_model

ASSETS = Path(__file__).resolve().parents[1] / "bench_assets"
SPARSE = ("hourlong", "hourlongh", "sparse10240")
SPARSIFIED = {"c8": (128, None, "kmeans"), "c8n5120": (384, None, "kmeans")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS and OpenMP thread: idle pool threads spinning between
    calls would take cores from the suite's other workers."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _path(name):
    return ASSETS / (f"bench_model_{name}.npz" if name else "bench_model.npz")


def _refuse(monkeypatch, *targets):
    """Any call of the (module, name) targets fails the test."""
    for mod, name in targets:
        def refuse(*a, _n=name, **k):
            raise AssertionError(f"{_n} was called")

        monkeypatch.setattr(mod, name, refuse)


def _assert_same(tobj, jobj, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(tobj, f).numpy(), np.asarray(getattr(jobj, f)),
                                      err_msg=f)


@pytest.mark.parametrize("name", SPARSE)
def test_sparse_assets_load_like_jax(name):
    jm, tm = JSparseGPMDM.load(_path(name)), load_model(_path(name), device="cpu")
    assert type(tm) is SparseGPMDM and not tm._deploys_core_posterior
    assert (tm.n_inducing_y, tm.n_inducing_x) == (jm.n_inducing_y, jm.n_inducing_x) == (128, 128)
    assert isinstance(tm.params, tsp.SparseParams)
    _assert_same(tm.params, jm.params, tsp.SPARSE_PARAM_FIELDS)
    assert isinstance(tm.posterior, tsp.SparsePosterior) and not tm.posterior.distilled
    _assert_same(tm.posterior, jm.posterior, tsp.POSTERIOR_FIELDS)
    assert tm._guard_receipt == jm._guard_receipt
    assert jm._opt_state is not None
    if name == "hourlongh":  # an L-BFGS state, not read (ROADMAP A.1b)
        assert tm._opt_state is None
    else:
        for a, b in zip(tm._opt_state.to_numpy(), jax.tree.leaves(jm._opt_state)):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert tm._compressed_cache == {} and tm._sparsified_cache == {}


@pytest.mark.parametrize("name", list(SPARSIFIED))
def test_auto_serves_the_persisted_sparsified_entry(monkeypatch, name):
    jm = JGPMDM.load(_path(name))
    want = jpf.resolve_posterior(jm, "auto")
    _refuse(monkeypatch, (tcore, "precompute_host"), (tsp, "distill_host"),
            (tcomp, "compress_host"))
    tm = load_model(_path(name), device="cpu")
    got = tpf.resolve_posterior(tm, "auto")
    assert got is tm._sparsified_cache[SPARSIFIED[name]]
    assert got.distilled and want.distilled
    _assert_same(got, want, tsp.POSTERIOR_FIELDS)
    assert tpf._effective_quad_precision(PFConfig(), got) == "high"
    flt = GPMDM_PF(tm, tguard.guard_trials(name)[2], 16, seed=0)
    out = flt.run(tguard.guard_trials(name)[0][0][:3])
    assert flt._post is got and torch.isfinite(out.class_probs).all()
    assert tm._posterior is None


def test_sparse_model_never_builds_a_compressed_posterior(monkeypatch):
    _refuse(monkeypatch, (GPMDM, "compressed_posterior"), (tcomp, "compress_host"),
            (tcore, "precompute_host"))
    tm = load_model(_path("hourlong"), device="cpu")
    assert tm.layout.Ny == 108_000 > tpf.AUTO_COMPRESS_N
    for mode in ("auto", "exact", None):
        assert tpf.resolve_posterior(tm, mode) is tm.posterior
    seqs, _, T = tguard.guard_trials("hourlong")
    out = GPMDM_PF(tm, T, 32, seed=0).run(seqs[0][:3])
    assert out.class_probs.shape == (3, 2) and torch.isfinite(out.class_probs).all()
    with pytest.raises(TypeError, match="deploys its own posterior family"):
        tm.sparsified_posterior(16)


def test_unhonourable_sparsified_recommendation_warns_and_falls_back():
    rec = {"family": "sparsified", "M": 64, "method": "kmeans"}
    jm, tm = JSparseGPMDM.load(_path("sparse10240")), load_model(_path("sparse10240"),
                                                                 device="cpu")
    jm._deploy_recommendation, tm._deploy_recommendation = dict(rec), dict(rec)
    caught = []
    for mod, m in ((tpf, tm), (jpf, jm)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert mod.resolve_posterior(m, "auto") is m.posterior
        caught.append([str(x.message) for x in w])
    assert caught[0] == caught[1] and "cannot honor it" in caught[0][0]


def test_sparse_model_training_is_not_ported():
    """The calls that raised before the sparse family's training was
    ported run on the loaded fp32 asset: its loss (off the float64 loss by
    at most 4x the JAX package's fp32 loss: the trace term cancels at Ny =
    10,240), one Adam step resumed from the stored state, a rollout, and
    init_X."""
    jm, tm = JSparseGPMDM.load(_path("sparse10240")), load_model(_path("sparse10240"),
                                                                 device="cpu")
    p64 = tsp.SparseParams(**{f: getattr(tm.params, f).double()
                              for f in tsp.SPARSE_PARAM_FIELDS})
    loss64 = float(tsp.sparse_nll(p64, torch.as_tensor(tm.get_Y()).double(),
                                  dataclasses.replace(tm.config, dtype="float64"), tm.layout))
    assert abs(tm.gpdm_loss() - loss64) <= 4 * abs(jm.gpdm_loss() - loss64)
    count = int(tm._opt_state.count)
    losses = tm.train_adam(1)
    assert len(losses) == 1 and np.isfinite(losses[0]) and int(tm._opt_state.count) == count + 1
    traj = tm.rollout(tm.params.X[0].numpy(), 3, 0)
    assert traj.shape == (3, 2) and torch.isfinite(traj).all()
    tm.init_X()
    assert tm._opt_state is None and torch.isfinite(tm.posterior.beta_y).all()


def test_sparse_model_maps_match_jax():
    """The ``map_*`` predictions of the loaded float32 model: each
    package's error against the port's float64 evaluation of the same
    float32 posterior, the port's within 4x the JAX package's (the
    repo's fp32 rule: beta up to ~65 amplifies the star kernel's
    rounding, so the two fp32 sums differ by ~1e-4)."""
    jm, tm = JSparseGPMDM.load(_path("sparse10240")), load_model(_path("sparse10240"),
                                                                 device="cpu")
    q = np.asarray(jm.params.X, np.float64)[::997] + 0.01
    post64 = tsp.SparsePosterior(**{f: getattr(tm.posterior, f).double()
                                    for f in tsp.POSTERIOR_FIELDS})
    par64 = tsp.SparseParams(**{f: getattr(tm.params, f).double()
                                for f in tsp.SPARSE_PARAM_FIELDS})
    cfg64, q64 = dataclasses.replace(tm.config, dtype="float64"), torch.as_tensor(q)
    cases = [
        (tm.map_x_to_y(q, True), jm.map_x_to_y(q, True),
         tsp.predict_y(post64, par64, q64, cfg64, with_noise=True)),
        (tm.map_x_dynamics(q), jm.map_x_dynamics(q), tsp.predict_x(post64, par64, q64, cfg64)),
        (tm.map_x_dynamics_for_class(q, 1), jm.map_x_dynamics_for_class(q, 1),
         tsp.predict_x_for_class(post64, par64, q64, 1, cfg64)),
    ]
    for got, want, ref in cases:
        for g, w, r in zip(got, want, ref):
            assert g.dtype == torch.float32
            t_err = (g.double() - r).abs().max().item()
            j_err = np.abs(np.asarray(w, np.float64) - r.numpy()).max()
            assert t_err <= 4 * j_err + 1e-6, (t_err, j_err)


def test_guard_report_runs_on_a_sparse_model():
    """The asset guard on the model's own posterior (P = 64: the score is
    a deterministic CPU draw, not the receipt's)."""
    tm = load_model(_path("sparse10240"), device="cpu")
    rep = tguard.guard_report(tm, "sparse10240", particles=64)
    seqs = tguard.guard_trials("sparse10240")[0]
    assert rep.total_frames == sum(len(s) for s in seqs)
    assert rep.frame_metrics["accuracy"] > 0.5


def test_warn_if_unsafe_exact_is_silent_on_sparse_posteriors():
    post = tsp.SparsePosterior(torch.zeros(108_000, 2), *([torch.zeros(1)] * 8))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tpf.warn_if_unsafe_exact(post, PFConfig())


def test_sparsified_posterior_cache(monkeypatch):
    """Keys as the JAX package's, a cache miss on a lazily loaded model
    built from the load's float64 parameters with no exact build (the
    entry equal to the JAX package's), and a refresh empties the cache."""
    tm, jm = load_model(_path(""), device="cpu"), JGPMDM.load(_path(""))
    seen = []
    real = tsp.distill_host

    def spy(params, *a, **k):
        seen.append(type(params))
        return real(params, *a, **k)

    monkeypatch.setattr(tsp, "distill_host", spy)
    _refuse(monkeypatch, (tcore, "precompute_host"))
    got = tm.sparsified_posterior(np.int64(24), n_inducing_x=np.int32(12), method="kmeans")
    assert seen == [dict] and tm._posterior is None and got.distilled
    assert tm.sparsified_posterior(24, 12, "kmeans") is got
    assert tm.sparsified_posterior(24, 12) is not got
    assert set(tm._sparsified_cache) == {(128, None), (24, 12, "kmeans"), (24, 12)}
    want = jm.sparsified_posterior(24, n_inducing_x=12, method="kmeans")
    jm.sparsified_posterior(24, 12)
    assert set(jm._sparsified_cache) == set(tm._sparsified_cache)
    _assert_same(got, want, tsp.POSTERIOR_FIELDS)
    monkeypatch.undo()
    tm._precompute_kernel_inverses()
    assert tm._sparsified_cache == {}


def _meta(path):
    with np.load(path) as data:
        return json.loads(bytes(data["meta_json"]).decode()), set(data.files)


def test_sparse_model_round_trips(tmp_path):
    """port -> port, port -> JAX and JAX -> port: the same class, inducing
    counts, parameters, persisted posterior, receipt and Adam state."""
    src = _path("sparse10240")
    tm = load_model(src, device="cpu")
    tm.save(tmp_path / "port.npz")
    meta, files = _meta(tmp_path / "port.npz")
    assert meta["model_class"] == "SparseGPMDM" and meta["posterior_class"] == "SparsePosterior"
    assert (meta["n_inducing_y"], meta["n_inducing_x"]) == (128, 128)
    assert meta["has_opt_state"] and meta["n_opt_leaves"] == 21
    assert len([f for f in files if f.startswith("opt_")]) == 21
    back = load_model(tmp_path / "port.npz", device="cpu")
    jback = JSparseGPMDM.load(tmp_path / "port.npz")
    JSparseGPMDM.load(src).save(tmp_path / "jax.npz")
    from_jax = load_model(tmp_path / "jax.npz", device="cpu")
    for m in (back, from_jax):
        assert type(m) is SparseGPMDM and (m.n_inducing_y, m.n_inducing_x) == (128, 128)
        for f in tsp.SPARSE_PARAM_FIELDS:
            assert torch.equal(getattr(m.params, f), getattr(tm.params, f)), f
        for f in tsp.POSTERIOR_FIELDS:
            assert torch.equal(getattr(m.posterior, f), getattr(tm.posterior, f)), f
        assert m._guard_receipt == tm._guard_receipt
        for a, b in zip(m._opt_state.to_numpy(), tm._opt_state.to_numpy()):
            np.testing.assert_array_equal(a, b)
    assert type(jback).__name__ == "SparseGPMDM"
    for a, b in zip(tm._opt_state.to_numpy(), jax.tree.leaves(jback._opt_state)):
        np.testing.assert_array_equal(a, np.asarray(b))
    _assert_same(tm.params, jback.params, tsp.SPARSE_PARAM_FIELDS)
    _assert_same(tm.posterior, jback.posterior, tsp.POSTERIOR_FIELDS)


def test_exact_model_with_a_sparsified_cache_round_trips(tmp_path):
    """c8's persisted entry and a second one aliased under another key:
    port -> port and -> JAX keep the keys, write the alias once and keep
    the recommendation; JAX -> port reads the alias as one object."""
    src = _path("c8")
    tm = load_model(src, device="cpu")
    entry = tm._sparsified_cache[(128, None, "kmeans")]
    tm._sparsified_cache[(64, None)] = entry
    tm.save(tmp_path / "port.npz")
    meta, files = _meta(tmp_path / "port.npz")
    assert meta["sparsified_keys"] == [[128, None, "kmeans"], [64, None]]
    assert meta["sparsified_entry_idx"] == [0, 0]
    assert not [f for f in files if f.startswith("sparsified_1_")]
    assert meta["deploy_recommendation"] == tm._deploy_recommendation
    back = load_model(tmp_path / "port.npz", device="cpu")
    assert back._sparsified_cache[(64, None)] is back._sparsified_cache[(128, None, "kmeans")]
    assert tpf.resolve_posterior(back, "auto").distilled
    for f in tsp.POSTERIOR_FIELDS:
        assert torch.equal(getattr(back._sparsified_cache[(64, None)], f), getattr(entry, f))
    jm = JGPMDM.load(tmp_path / "port.npz")
    jentry = jm._sparsified_cache[(128, None, "kmeans")]
    assert jm._sparsified_cache[(64, None)] is jentry and jentry.distilled
    _assert_same(entry, jentry, tsp.POSTERIOR_FIELDS)
    assert jpf.resolve_posterior(jm, "auto") is jentry
    jm.save(tmp_path / "jax.npz")
    from_jax = load_model(tmp_path / "jax.npz", device="cpu")
    assert set(from_jax._sparsified_cache) == {(128, None, "kmeans"), (64, None)}
    _assert_same(from_jax._sparsified_cache[(64, None)], jentry, tsp.POSTERIOR_FIELDS)
    assert from_jax._deploy_recommendation == jm._deploy_recommendation


def test_posterior_to_keeps_the_flag():
    post = tsp.SparsePosterior(*([torch.zeros(2, 2)] * len(tsp.POSTERIOR_FIELDS)),
                               distilled=True)
    moved = post.to("cpu")
    assert moved.distilled and dataclasses.fields(moved) == dataclasses.fields(post)
