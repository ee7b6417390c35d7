"""The port's deployment layer against the JAX package's, on the CPU: the
``'auto'`` policy (``resolve_posterior``), ``warn_if_unsafe_exact``, the
lazily built exact posterior, the compressed-posterior cache in
checkpoints both ways, ``GPMDM_PF(posterior=...)`` and the asset guard's
trials and fingerprint.

The policy runs on ``bench_model_n2048.npz`` and ``bench_model_n5120.npz``
as committed: their persisted compressed caches (ranks 148/113 and
188/136) answer ``'auto'``, so no eigendecomposition runs and the exact
posterior is never built.  The recommendation families and the
FLOP-parity and flat-spectrum thresholds run on the headline asset
(Ny = 480) with the thresholds lowered in both packages alike.
"""

import dataclasses
import json
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from gpmdm_tpu import GPMDM as JGPMDM
from gpmdm_tpu.config import PFConfig as JPFConfig
from gpmdm_tpu.filter import particle_filter as jpf
from gpmdm_tpu.models import compressed as jcomp
from gpmdm_tpu.models import core as jcore
from gpmdm_tpu.utils import asset_guard as jguard
from gpmdm_tpu_torch import GPMDM, GPMDM_PF, PFConfig
from gpmdm_tpu_torch.filter import particle_filter as tpf
from gpmdm_tpu_torch.models import compressed as tcomp
from gpmdm_tpu_torch.models import core as tcore
from gpmdm_tpu_torch.utils import asset_guard as tguard
from gpmdm_tpu_torch.utils.io import load_model

ASSETS = Path(__file__).resolve().parents[1] / "bench_assets"
HEADLINE = ASSETS / "bench_model.npz"
LARGE = {"n2048": (ASSETS / "bench_model_n2048.npz", 148, 113),
         "n5120": (ASSETS / "bench_model_n5120.npz", 188, 136)}
FIELDS = [f.name for f in dataclasses.fields(tcomp.CompressedPosterior)]



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS and OpenMP thread: idle pool threads spinning between
    calls would take cores from the suite's other workers."""
    with threadpoolctl.threadpool_limits(1):
        yield

def _no_exact_build(monkeypatch):
    """Any build of the exact posterior fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the exact posterior was built")

    monkeypatch.setattr(tcore, "precompute_host", refuse)


def _family(post):
    return type(post).__name__, getattr(post, "rank_y", None), getattr(post, "rank_x", None)


@pytest.mark.parametrize("name", ["n2048", "n5120"])
def test_auto_serves_the_persisted_cache_like_jax(monkeypatch, name):
    path, ry, rx = LARGE[name]
    jm = JGPMDM.load(path)
    want = jpf.resolve_posterior(jm, "auto")
    _no_exact_build(monkeypatch)
    tm = load_model(path, device="cpu")
    assert tm._posterior is None and tm._posterior_pending
    got = tpf.resolve_posterior(tm, "auto")
    assert _family(got) == _family(want) == ("CompressedPosterior", ry, rx)
    assert got is tm._compressed_cache[(None, None, 1e-6)]
    assert tpf.resolve_posterior(tm, "compressed") is got
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert tm._guard_receipt == jm._guard_receipt
    assert tm._guard_receipt["posterior"] == "CompressedPosterior"
    assert tm._posterior is None


def test_policy_cases_match_jax():
    """Below AUTO_COMPRESS_N 'auto' is the exact posterior; 'exact' and
    None are too; an object passes through; a bad string raises."""
    jm, tm = JGPMDM.load(HEADLINE), load_model(HEADLINE, device="cpu")
    assert tm.layout.Ny <= tpf.AUTO_COMPRESS_N
    for mode in ("auto", "exact", None):
        assert _family(tpf.resolve_posterior(tm, mode)) == _family(
            jpf.resolve_posterior(jm, mode)) == ("Posterior", None, None)
        assert tpf.resolve_posterior(tm, mode) is tm.posterior
    cp = tm.compressed_posterior(rank_y=9, rank_x=7)
    assert tpf.resolve_posterior(tm, cp) is cp
    for mod, m in ((tpf, tm), (jpf, jm)):
        with pytest.raises(ValueError, match="expected 'auto'"):
            mod.resolve_posterior(m, "bogus")


def test_policy_constants_match_jax():
    for name in ("_EXACT_QUAD_SAFE_N", "AUTO_COMPRESS_N", "AUTO_COMPRESS_MAX_Q_FRAC",
                 "AUTO_COMPRESS_FLAT_Q_FRAC"):
        assert getattr(tpf, name) == getattr(jpf, name), name


@pytest.fixture(scope="module")
def headline_pair():
    """The headline asset in both packages, its tol-selected compressed
    posterior built once in each."""
    jm, tm = JGPMDM.load(HEADLINE), load_model(HEADLINE, device="cpu")
    return jm, tm, jm.compressed_posterior(), tm.compressed_posterior()


def _lower(monkeypatch, **consts):
    for k, v in consts.items():
        monkeypatch.setattr(jpf, k, v)
        monkeypatch.setattr(tpf, k, v)


def test_flop_parity_fallback_keeps_the_cache_and_save_skips_it(headline_pair, monkeypatch,
                                                                 tmp_path):
    """Past q = N/2 (here a lowered bound) 'auto' warns and deploys the
    exact posterior in both packages; the entry stays cached, and
    save_model leaves it out, as the JAX package's does."""
    jm, tm, jcp, tcp = headline_pair
    q_frac = 0.5 * tcp.rank_y / tm.layout.Ny  # the rank is twice the bound
    _lower(monkeypatch, AUTO_COMPRESS_N=10, AUTO_COMPRESS_MAX_Q_FRAC=q_frac)
    for mod, m in ((tpf, tm), (jpf, jm)):
        with pytest.warns(UserWarning, match="FLOP-parity"):
            assert _family(mod.resolve_posterior(m, "auto"))[0] == "Posterior"
    assert tm._compressed_cache[(None, None, 1e-6)] is tcp
    path = tmp_path / "skip.npz"
    tm.save(path)
    with np.load(path) as data:
        assert not [k for k in data.files if k.startswith("comp_")]
    assert load_model(path, device="cpu")._compressed_cache == {}
    jm.save(tmp_path / "jskip.npz")
    with np.load(tmp_path / "jskip.npz") as data:
        assert not [k for k in data.files if k.startswith("comp_")]


def test_flat_band_warns_and_compresses(headline_pair, monkeypatch):
    jm, tm, jcp, tcp = headline_pair
    flat = 0.5 * tcp.rank_y / tm.layout.Ny
    _lower(monkeypatch, AUTO_COMPRESS_N=10, AUTO_COMPRESS_FLAT_Q_FRAC=flat)
    for mod, m, cp in ((tpf, tm, tcp), (jpf, jm, jcp)):
        with pytest.warns(UserWarning, match="flat-spectrum band"):
            assert mod.resolve_posterior(m, "auto") is cp


@pytest.mark.parametrize("rec", [
    {"family": "compressed", "rank_y": 12, "rank_x": 9},
    {"family": "compressed"},
    {"family": "exact"},
    {"family": "future-family"},
], ids=["compressed-pinned", "compressed", "exact", "unknown"])
def test_recommendation_families_match_jax(headline_pair, rec):
    jm, tm, _, _ = headline_pair
    jm._deploy_recommendation, tm._deploy_recommendation = dict(rec), dict(rec)
    try:
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = jpf.resolve_posterior(jm, "auto")
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            got = tpf.resolve_posterior(tm, "auto")
    finally:
        jm._deploy_recommendation = tm._deploy_recommendation = None
    assert _family(got) == _family(want)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]


def test_sparsified_recommendation_raises(monkeypatch):
    """The c8 assets recommend a sparsified posterior: 'auto' serves the
    persisted distillation, as the JAX package does, with no exact build
    and no distillation (it raised while the sparse family was not
    ported); an explicit choice still serves."""
    _no_exact_build(monkeypatch)
    for name in ("bench_model_c8.npz", "bench_model_c8n5120.npz"):
        tm = load_model(ASSETS / name, device="cpu")
        assert tm._deploy_recommendation["family"] == "sparsified"
        got = tpf.resolve_posterior(tm, "auto")
        assert got is next(iter(tm._sparsified_cache.values())) and got.distilled
        assert GPMDM_PF(tm, np.eye(tm.n_classes), 16)._post is got
    cp = tpf.resolve_posterior(tm, "compressed")
    assert (cp.rank_y, cp.rank_x) == (1149, 331) and tm._posterior is None


def _fake_exact(module, N, dtype):
    """An exact posterior of module (core of either package) holding only
    an (N, 2) latent snapshot: what warn_if_unsafe_exact reads."""
    z = np.zeros((N, 2), dtype)
    if module is tcore:
        return tcore.Posterior(**{f.name: torch.as_tensor(z)
                                  for f in dataclasses.fields(tcore.Posterior)})
    return jcore.Posterior(**{f.name: jnp.asarray(z) for f in dataclasses.fields(jcore.Posterior)})


@pytest.mark.parametrize("N,dtype,cfg", [
    (5120, np.float32, {}),
    (4097, np.float32, {"precision": "default"}),
    (4096, np.float32, {}),
    (5120, np.float32, {"precision": "highest"}),
    (5120, np.float32, {"quad_precision": "highest"}),
    (5120, np.float32, {"precision": "highest", "quad_precision": "high"}),
    (5120, np.float64, {}),
])
def test_warn_if_unsafe_exact_matches_jax(N, dtype, cfg):
    fired = []
    for mod, core_mod, cfg_cls in ((tpf, tcore, PFConfig), (jpf, jcore, JPFConfig)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            mod.warn_if_unsafe_exact(_fake_exact(core_mod, N, dtype), cfg_cls(**cfg))
        fired.append([str(x.message) for x in w if "Ny=" in str(x.message)])
    assert bool(fired[0]) == bool(fired[1])
    if fired[0]:
        assert f"Ny={N} > 4096" in fired[0][0]


def test_compressed_posterior_never_warns_unsafe():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cp = tcomp.CompressedPosterior(**{f: torch.zeros(5120, 2) for f in FIELDS})
        tpf.warn_if_unsafe_exact(cp, PFConfig())


@pytest.mark.parametrize("name", ["n2048", "n5120"])
def test_lazy_load_serves_auto_without_the_exact_posterior(monkeypatch, name):
    """A few 'auto' frames on the loaded asset with the exact build made
    to fail: the filter serves the persisted compressed posterior; then a
    failed build stays retryable."""
    path, ry, _ = LARGE[name]
    real = tcore.precompute_host
    _no_exact_build(monkeypatch)
    tm = load_model(path, device="cpu")
    seqs, _, T = tguard.guard_trials(name)
    flt = GPMDM_PF(tm, T, 64, seed=0)
    out = flt.run(seqs[0][:5])
    assert out.class_probs.shape == (5, 2) and torch.isfinite(out.class_probs).all()
    assert flt._post.rank_y == ry and tm._posterior is None
    with pytest.raises(AssertionError, match="exact posterior was built"):
        tm.posterior
    assert tm._posterior_pending and tm._lazy_host_params is not None
    monkeypatch.setattr(tcore, "precompute_host", real)
    if name == "n2048":  # the n5120 build is the same code at 12x the cost
        assert isinstance(tm.posterior, tcore.Posterior)
        assert not tm._posterior_pending and tm._lazy_host_params is None


def test_compressed_miss_while_deferred_uses_the_loads_parameters(monkeypatch):
    """A cache miss on a lazily loaded model builds from the checkpoint's
    float64 parameters, not from the model's device tensors."""
    tm = load_model(HEADLINE, device="cpu")
    seen = []
    real = tcomp.compress_host

    def spy(params, *a, **k):
        seen.append(type(params))
        return real(params, *a, **k)

    monkeypatch.setattr(tcomp, "compress_host", spy)
    _no_exact_build(monkeypatch)
    assert tm.compressed_posterior(rank_y=5, rank_x=5).rank_y == 5
    assert seen == [dict] and tm._posterior is None


def test_port_resave_is_read_by_jax(tmp_path):
    """The port re-saves n2048 with its cache, its recommendation slot and
    its receipt; the JAX package reads the same cache and deploys it."""
    path, ry, rx = LARGE["n2048"]
    tm = load_model(path, device="cpu")
    out = tmp_path / "resaved.npz"
    tm.save(out)
    with np.load(path) as a, np.load(out) as b:
        for f in FIELDS:
            np.testing.assert_array_equal(b[f"comp_0_{f}"], a[f"comp_0_{f}"], err_msg=f)
        meta = json.loads(bytes(b["meta_json"]).decode())
    assert meta["compressed_keys"] == [[None, None, 1e-6]]
    assert meta["guard_receipt"] == tm._guard_receipt
    jm = JGPMDM.load(out)
    assert jm._posterior is None
    assert _family(jpf.resolve_posterior(jm, "auto")) == ("CompressedPosterior", ry, rx)
    assert jm._guard_receipt == tm._guard_receipt


def test_jax_cache_is_read_by_the_port(headline_pair, tmp_path):
    """The JAX package saves pinned-rank entries, one aliased under a
    second key, and a recommendation; the port reads the same arrays
    (the alias one object) and honours the recommendation."""
    jm = JGPMDM.load(HEADLINE)
    pinned = jm.compressed_posterior(rank_y=np.int64(11), rank_x=np.int32(6))
    jm._compressed_cache[(None, None, 1e-6)] = pinned
    jm._deploy_recommendation = {"family": "compressed", "rank_y": 11, "rank_x": 6}
    path = tmp_path / "jax_saved.npz"
    jm.save(path)
    tm = load_model(path, device="cpu")
    assert set(tm._compressed_cache) == {(11, 6, 1e-6), (None, None, 1e-6)}
    got = tm._compressed_cache[(11, 6, 1e-6)]
    assert tm._compressed_cache[(None, None, 1e-6)] is got
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(pinned, f)))
    assert tpf.resolve_posterior(tm, "auto") is got
    # and back: the alias is written once
    out = tmp_path / "port_saved.npz"
    tm.save(out)
    with np.load(out) as data:
        meta = json.loads(bytes(data["meta_json"]).decode())
        assert not [k for k in data.files if k.startswith("comp_1_")]
    assert meta["compressed_entry_idx"] == [0, 0]
    assert meta["deploy_recommendation"] == jm._deploy_recommendation


def test_cache_keys_are_normalised(tmp_path):
    tm = load_model(HEADLINE, device="cpu")
    cp = tm.compressed_posterior(rank_y=np.int64(6), rank_x=np.int32(5), tol=np.float32(1e-6))
    key = (6, 5, float(np.float32(1e-6)))
    assert list(tm._compressed_cache) == [key]
    assert all(type(k) in (int, float) for k in key)
    tm.save(tmp_path / "keys.npz")
    jm = JGPMDM.load(tmp_path / "keys.npz")
    np.testing.assert_array_equal(np.asarray(jm._compressed_cache[key].Uy), cp.Uy.numpy())


def test_gpmdm_pf_reresolves_after_training(monkeypatch):
    """A string mode stays live: after train_adam the filter serves the
    refreshed compressed posterior; an object stays pinned."""
    monkeypatch.setattr(tpf, "AUTO_COMPRESS_N", 100)
    # this untrained model's Gram is flat: keep 'auto' on the compressed side
    monkeypatch.setattr(tpf, "AUTO_COMPRESS_MAX_Q_FRAC", 1.0)
    from gpmdm_tpu_torch.data import synthetic

    tr, tl, te, _ = synthetic.make_dataset(n_classes=2, n_train_seqs=2, n_test_seqs=1,
                                           seq_len=40, D=6, seed=4)
    m = GPMDM(D=6, d=2, n_classes=2, dtype="float64", y_sigma_n_init=0.1,
              x_sigma_n_init=0.1, device="cpu")
    for Y, c in zip(tr, tl):
        m.add_data(Y, c)
    m.init_X()
    T = [[0.9, 0.1], [0.1, 0.9]]
    flt = GPMDM_PF(m, T, 32, seed=0)
    first = flt._post
    assert isinstance(first, tcomp.CompressedPosterior)
    flt.update(te[0][0])
    pinned = GPMDM_PF(m, T, 32, seed=0, posterior=first)
    exact = GPMDM_PF(m, T, 32, seed=0, posterior="exact")
    m.train_adam(2)
    assert isinstance(flt._post, tcomp.CompressedPosterior) and flt._post is not first
    assert not torch.equal(flt._post.Ay, first.Ay)
    assert pinned._post is first
    assert exact._post is m.posterior
    flt.update(te[0][1])


def test_guard_shapes_match_jax():
    assert tguard.SHAPES == jguard.SHAPES


@pytest.mark.parametrize("name", [n for n, s in tguard.SHAPES.items()
                                  if s.get("C", 2) <= 8 and n != "hourlong"])
def test_guard_trials_match_jax(name):
    seqs, labels, T = tguard.guard_trials(name)
    jseqs, jlabels, jT = jguard.guard_trials(name)
    assert list(labels) == list(jlabels)
    np.testing.assert_array_equal(T, jT)
    assert len(seqs) == len(jseqs)
    for a, b in zip(seqs, jseqs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fname", ["bench_model.npz", "bench_model_n2048.npz",
                                   "bench_model_n5120.npz", "bench_model_c8.npz",
                                   "bench_model_c8n5120.npz", "bench_model_sparse10240.npz",
                                   "bench_model_hourlong.npz", "bench_model_hourlongh.npz"])
def test_params_fingerprint_matches_the_receipts(fname):
    """The port's fingerprint of a loaded asset is the JAX package's, the
    one its receipt was stamped with, for either family (the sparse
    assets' ``SparseParams`` in the JAX field order)."""
    tm = load_model(ASSETS / fname, device="cpu")
    jm = JGPMDM.load(ASSETS / fname)  # the JAX reader picks the family
    fp = tguard.params_fingerprint(tm.params)
    assert fp == jguard.params_fingerprint(jm.params) == tm._guard_receipt["params_sha256"]
