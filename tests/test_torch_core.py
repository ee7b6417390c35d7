"""The PyTorch port's posterior, checkpoint loading, layout, data and
metrics against the JAX package, on the CPU.

The posterior comparisons run in float64 on both sides, rtol 1e-10: the two
packages do the same float64 host factorization and the same prediction
algebra.  Loading compares exact float32 values: both packages cast one
float64 precompute to float32 with round-to-nearest.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmdm_tpu import GPMDM as JGPMDM
from gpmdm_tpu.config import GPMDMConfig as JConfig
from gpmdm_tpu.config import PFConfig as JPFConfig
from gpmdm_tpu.data import synthetic as jsynthetic
from gpmdm_tpu.models import core as jcore
from gpmdm_tpu.ops import kernels as jkernels
from gpmdm_tpu.ops import layout as jlayout
from gpmdm_tpu.utils import metrics as jmetrics
from gpmdm_tpu_torch import GPMDMConfig, PFConfig
from gpmdm_tpu_torch.data import synthetic
from gpmdm_tpu_torch.models import core
from gpmdm_tpu_torch.models.gpmdm import params_from_numpy
from gpmdm_tpu_torch.ops import kernels as tkernels
from gpmdm_tpu_torch.ops import layout
from gpmdm_tpu_torch.utils import metrics
from gpmdm_tpu_torch.utils.io import load_model

ASSETS = Path(__file__).resolve().parents[1] / "bench_assets"
FIELDS = core.PARAM_FIELDS


def _random_problem(dyn_target, back_step, seed=0):
    """Small model: 3 sequences of unequal length over 2 classes, so the
    per-class dynamics blocks are zero-padded."""
    rng = np.random.default_rng(seed)
    D, d = 5, 2
    lengths, classes = [12, 15, 10], [0, 0, 1]
    kw = dict(D=D, d=d, n_classes=2, dyn_target=dyn_target, dyn_back_step=back_step,
              dtype="float64", sigma_n_num_Y=0.01)
    din = d * back_step
    params = {
        "y_log_lengthscales": 0.3 * rng.normal(size=d),
        "y_log_lambdas": 0.2 * rng.normal(size=D),
        "y_log_sigma_n": np.array(-1.5),
        "x_log_lengthscales": 0.3 * rng.normal(size=din),
        "x_log_lambdas": 0.2 * rng.normal(size=d),
        "x_log_sigma_n": np.array(-2.0),
        "x_log_lin_coeff": 0.3 * rng.normal(size=din + 1) - 0.5,
        "X": rng.normal(size=(sum(lengths), d)),
    }
    Y = rng.normal(size=(sum(lengths), D))
    Xstar = rng.normal(size=(40, din))
    return kw, lengths, classes, params, Y, Xstar


@pytest.mark.parametrize("dyn_target,back_step", [("full", 1), ("delta", 2)])
def test_posterior_and_predictions_match_jax_f64(dyn_target, back_step):
    kw, lengths, classes, params, Y, Xstar = _random_problem(dyn_target, back_step)
    jcfg, tcfg = JConfig(**kw), GPMDMConfig(**kw)
    jl = jlayout.build_layout(lengths, classes, 2, back_step)
    tl = layout.build_layout(lengths, classes, 2, back_step)
    jparams = jcore.GPMDMParams(**{f: jnp.asarray(params[f]) for f in FIELDS})
    tparams = params_from_numpy(params, torch.float64, "cpu")

    jpost = jcore.precompute_host(jparams, Y, jcfg, jl)
    tpost = core.precompute_host(params, Y, tcfg, tl, "cpu")
    for f in dataclasses.fields(core.Posterior):
        np.testing.assert_allclose(getattr(tpost, f.name).numpy(),
                                   np.asarray(getattr(jpost, f.name)),
                                   rtol=1e-10, atol=1e-12, err_msg=f.name)

    xs = Xstar[:, :2]
    for noise in (False, True):
        jm, jv = jcore.predict_y(jpost, jparams, jnp.asarray(xs), jcfg, with_noise=noise)
        tm, tv = core.predict_y(tpost, tparams, torch.as_tensor(xs), tcfg, with_noise=noise)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10, atol=1e-12)
    jm, jv = jcore.predict_x_all_classes(jpost, jparams, jnp.asarray(Xstar), jcfg)
    tm, tv = core.predict_x_all_classes(tpost, tparams, torch.as_tensor(Xstar), tcfg)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10, atol=1e-12)


def test_predict_y_at_training_inputs_and_far_away_matches_jax():
    """At training inputs the variance collapses toward the noise (the
    cancellation-prone end); far from the data it returns to the prior."""
    kw, lengths, classes, params, Y, _ = _random_problem("full", 1, seed=3)
    jcfg, tcfg = JConfig(**kw), GPMDMConfig(**kw)
    tl = layout.build_layout(lengths, classes, 2, 1)
    jl = jlayout.build_layout(lengths, classes, 2, 1)
    tparams = params_from_numpy(params, torch.float64, "cpu")
    jparams = jcore.GPMDMParams(**{f: jnp.asarray(params[f]) for f in FIELDS})
    tpost = core.precompute_host(params, Y, tcfg, tl, "cpu")
    jpost = jcore.precompute_host(jparams, Y, jcfg, jl)
    xs = np.concatenate([params["X"][:5], 50.0 * np.ones((1, 2))])
    _, tv = core.predict_y(tpost, tparams, torch.as_tensor(xs), tcfg)
    _, jv = jcore.predict_y(jpost, jparams, jnp.asarray(xs), jcfg)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tv[-1].numpy(), np.exp(-2 * params["y_log_lambdas"]), rtol=1e-12)


@pytest.mark.parametrize("asset", ["bench_model.npz", "bench_model_d4.npz"])
def test_load_model_matches_jax(asset):
    jm = JGPMDM.load(ASSETS / asset)
    tm = load_model(ASSETS / asset, device="cpu")
    assert tm.config.to_dict() == jm.config.to_dict()
    for f in dataclasses.fields(jlayout.DataLayout):
        a, b = getattr(tm.layout, f.name), getattr(jm.layout, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tm.params, f).numpy(),
                                      np.asarray(getattr(jm.params, f)), err_msg=f)
    for f in dataclasses.fields(core.Posterior):
        np.testing.assert_array_equal(getattr(tm.posterior, f.name).numpy(),
                                      np.asarray(getattr(jm.posterior, f.name)),
                                      err_msg=f.name)
    assert tm.posterior.Ky_inv.dtype == torch.float32
    np.testing.assert_array_equal(tm.get_Y(), jm.get_Y())


def test_load_model_rejects_other_families(tmp_path):
    """A family the port does not know is refused by name, and so is a
    checkpoint whose parameters do not fit the family it names.  The
    back-constrained family, once refused, loads: the X slot is W, and X
    is rematerialized as K_b W."""
    src = np.load(ASSETS / "bench_model.npz")
    arrays = {k: src[k] for k in src.files}
    meta = json.loads(bytes(arrays["meta_json"]).decode())

    def write(family, **config):
        meta["model_class"] = family
        meta["config"].update(config)
        arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        np.savez(tmp_path / "other.npz", **arrays)
        return tmp_path / "other.npz"

    for family, match in (("MysteryGPMDM", "unknown model_class 'MysteryGPMDM'"),
                          ("SparseGPMDM", "unexpected parameter fields")):
        with pytest.raises(ValueError, match=match):
            load_model(write(family), device="cpu")
    m = load_model(write("BCGPMDM", back_constraint_ls=2.5), device="cpu")
    assert type(m).__name__ == "BCGPMDM" and m.config.back_constraint_ls == 2.5
    W = torch.as_tensor(arrays["param_X"])
    assert torch.equal(m._W, W)
    from gpmdm_tpu_torch.models.back_constrained import back_kernel

    Y = torch.as_tensor(m.get_Y())
    torch.testing.assert_close(m.params.X, back_kernel(Y, Y, 2.5, torch.float32) @ W)


@pytest.mark.parametrize("seed,kw", [(0, {}), (7, {"n_classes": 3, "D": 9, "seq_len": 25}),
                                     (3, {"center_spread": 1.5, "class_signature": 0.8})])
def test_synthetic_dataset_matches_jax(seed, kw):
    a = synthetic.make_dataset(seed=seed, **kw)
    b = jsynthetic.make_dataset(seed=seed, **kw)
    for xs, ys in zip(a, b):
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("back_step", [1, 2])
def test_layout_and_xin_xout_match_jax(back_step):
    lengths, classes = [7, 9, 5, 6], [0, 1, 1, 2]
    tl = layout.build_layout(lengths, classes, 3, back_step)
    jl = jlayout.build_layout(lengths, classes, 3, back_step)
    for f in dataclasses.fields(jlayout.DataLayout):
        np.testing.assert_array_equal(np.asarray(getattr(tl, f.name)),
                                      np.asarray(getattr(jl, f.name)), err_msg=f.name)
    X = np.random.default_rng(0).normal(size=(sum(lengths), 2))
    for target in ("full", "delta"):
        for a, b in zip(layout.xin_xout(X, tl, target), jlayout.xin_xout(jnp.asarray(X), jl, target)):
            np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="class-major"):
        layout.build_layout([5, 5], [1, 0], 2)


def test_configs_match_jax_fields_and_validation():
    jfields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(GPMDMConfig)}
    assert tfields == jfields
    jpf = {f.name: f.default for f in dataclasses.fields(JPFConfig)}
    tpf = {f.name: f.default for f in dataclasses.fields(PFConfig)}
    assert tpf == jpf
    for bad in ({"resampling": "stratified"}, {"pallas": "maybe"}, {"precision": "low"},
                {"resample_threshold": 0.5}, {"num_particles": 0}):
        with pytest.raises(ValueError):
            PFConfig(**bad)
        with pytest.raises(ValueError):
            JPFConfig(**bad)
    with pytest.raises(ValueError):
        GPMDMConfig(D=3, d=2, n_classes=1, dyn_back_step=3)
    cfg = GPMDMConfig(D=3, d=2, n_classes=2, hyperprior_centers=[0.0] * 7)
    assert GPMDMConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.to_dict() == JConfig(D=3, d=2, n_classes=2, hyperprior_centers=[0.0] * 7).to_dict()


@pytest.mark.parametrize("C", [2, 3])
def test_metrics_match_jax(C):
    rng = np.random.default_rng(C)
    pred, true = rng.integers(0, C, 200), rng.integers(0, C, 200)
    cm = metrics.confusion_matrix(pred, true, C)
    np.testing.assert_array_equal(cm, jmetrics.confusion_matrix(pred, true, C))
    assert metrics.macro_prf(cm) == jmetrics.macro_prf(cm)
    assert metrics.binary_prf(cm, 1) == jmetrics.binary_prf(cm, 1)


def test_gp_kernel_functions_match_jax_f64():
    rng = np.random.default_rng(11)
    X1, X2 = rng.normal(size=(9, 3)), rng.normal(size=(7, 3))
    ls, sn, lin = 0.3 * rng.normal(size=3), np.array(-1.2), 0.4 * rng.normal(size=4)
    j = lambda *a: [jnp.asarray(x) for x in a]
    t = lambda *a: [torch.as_tensor(x) for x in a]
    cases = [
        ("weighted_sqdist", (X1, X2, ls), {}),
        ("rbf_kernel", (X1, X2, ls), {}),
        ("rbf_kernel", (X1, X1, ls, sn), {"sigma_n_num": 0.05, "with_noise": True}),
        ("linear_kernel", (X1, X2, lin), {}),
        ("y_kernel", (X1, X1, ls, sn), {"sigma_n_num": 0.05}),
        ("x_kernel", (X1, X1, ls, sn, lin), {"sigma_n_num": 0.02}),
        ("x_kernel", (X1, X2, ls, sn, lin), {"with_noise": False}),
        ("y_diag_kernel", (X1, sn), {"sigma_n_num": 0.05, "with_noise": True}),
        ("x_diag_kernel", (X1, lin, sn), {"sigma_n_num": 0.02, "with_noise": True}),
        ("x_diag_kernel", (X1, lin, sn), {}),
    ]
    for name, args, kw in cases:
        want = getattr(jkernels, name)(*j(*args), **kw)
        got = getattr(tkernels, name)(*t(*args), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12,
                                   err_msg=name)
