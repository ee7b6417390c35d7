"""The sparse family's training in the port against the JAX package's, on
the CPU in float64 unless named: the synthetic task at C = 2 classes of 2 x
25 frames (Ny = 100), D = 8, d = 2, My = 12 and Mx = 10 inducing inputs.

- ``_lb_via_qr`` in float32 and float64, ``_sgpr_terms`` on both
  capacitance paths (QR, Cholesky).
- ``sparse_nll``, ``y_sparse_nll``, ``x_sparse_nll`` and the gradient of
  every ``SparseParams`` leaf against ``jax.value_and_grad``, rtol 1e-8,
  at back_step 1 and 2 ('delta'), with the hyperprior, and through the QR
  path (torch's QR backward against JAX's).
- ``sparse_trainable_mask`` in every mode; ``SparseGPMDM.init_X`` to
  1e-12; 5 Adam steps (params, mu, nu, count) to 1e-8 and the NaN freeze
  against the JAX trainer; a saved model with its Adam state resumed 2
  steps across the packages; ``rollout`` (sample=False) to 1e-10; the
  float64 evaluation of the fp32 objective (a float32 config on float64
  tensors).
- The committed assets: the diagnostics of ``bench_model_sparse10240.npz``
  in float64 against the JAX package's, and the Adam state of it and of
  ``bench_model_hourlong.npz`` (21 leaves) kept through a load and a save.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import threadpoolctl
import torch

from gpmdm_tpu import SparseGPMDM as JSparseGPMDM
from gpmdm_tpu.models import sparse as jsp
from gpmdm_tpu.train import trainer as jtrainer
from gpmdm_tpu_torch import SparseGPMDM, TrainConfig
from gpmdm_tpu_torch.data import synthetic
from gpmdm_tpu_torch.models import core
from gpmdm_tpu_torch.models import sparse as tsp
from gpmdm_tpu_torch.train import trainer
from gpmdm_tpu_torch.utils.io import load_model

ASSETS = Path(__file__).resolve().parents[1] / "bench_assets"
FIELDS = tsp.SPARSE_PARAM_FIELDS
MY, MX = 12, 10
GRAD_RTOL, PRED_RTOL, INIT_RTOL = 1e-8, 1e-10, 1e-12
# the asset's dynamics means sum kernel values weighted by a beta of up to
# ~1e3: float64 keeps about 9 digits of the largest
ASSET_RTOL = 1e-8
TR, TL, _, _ = synthetic.make_dataset(n_classes=2, n_train_seqs=2, n_test_seqs=1, seq_len=25,
                                      D=8, seed=3)
CASES = {"base": {}, "back_step_2_delta": {"dyn_back_step": 2, "dyn_target": "delta"},
         "hyperprior": {"hyperprior_weight": 0.5}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS and OpenMP thread: idle pool threads spinning between
    calls would take cores from the suite's other workers."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _model(cls, dtype="float64", **kw):
    extra = {} if cls is JSparseGPMDM else {"device": "cpu"}
    m = cls(D=8, d=2, n_classes=2, dtype=dtype, n_inducing_y=MY, n_inducing_x=MX,
            y_sigma_n_init=0.1, x_sigma_n_init=0.1, **extra, **kw)
    for Y, c in zip(TR, TL):
        m.add_data(Y, c)
    m.init_X()
    return m


@pytest.fixture(scope="module")
def pairs():
    """One (JAX, port) pair of PCA-initialized float64 models per case."""
    return {name: (_model(JSparseGPMDM, **kw), _model(SparseGPMDM, **kw))
            for name, kw in CASES.items()}


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rtol, msg=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=msg)


def _assert_fields(tobj, jobj, fields, rtol):
    for f in fields:
        _close(getattr(tobj, f), getattr(jobj, f), rtol, f)


def _assert_adam_state(tstate, jstate, rtol):
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    tleaves = tstate.to_numpy()
    assert len(tleaves) == len(jleaves) == 1 + 2 * len(FIELDS) == 21
    assert int(tleaves[0]) == int(jleaves[0])
    for i, (a, b) in enumerate(zip(tleaves[1:], jleaves[1:])):
        _close(a, b, rtol, f"opt leaf {i + 1}")


# ------------------------------------------------------------------ the loss


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lb_via_qr_matches_jax(dtype):
    """Both packages' LB on the same A (two classes batched in the port,
    one at a time in JAX): lower, positive diagonal, LB LB^T = I + A A^T."""
    A = np.random.default_rng(0).normal(size=(2, MY, 100)).astype(dtype)
    got = tsp._lb_via_qr(torch.as_tensor(A))
    rtol = 1e-12 if dtype == "float64" else 2e-5
    for c in range(2):
        want = jsp._lb_via_qr(jnp.asarray(A[c]))
        _close(got[c], want, rtol)
        B = np.eye(MY) + A[c].astype(np.float64) @ A[c].T.astype(np.float64)
        L = _np(got[c]).astype(np.float64)
        assert np.all(np.diag(L) > 0) and np.allclose(np.triu(L, 1), 0)
        _close(L @ L.T, B, 10 * rtol)


@pytest.mark.parametrize("qr_b", [True, False])
def test_sgpr_terms_match_jax_on_both_paths(qr_b):
    """nll, Lm, LB and c of one GP with padded columns, on the QR and the
    Cholesky capacitance; the two paths agree with each other too."""
    rng = np.random.default_rng(1)
    Z, X = rng.normal(size=(MY, 2)), rng.normal(size=(40, 2))
    ls = np.log([0.8, 1.3])
    mask = (np.arange(40) < 33).astype(np.float64)
    Y = rng.normal(size=(40, 3))
    args = dict(Kmm=np.exp(-((Z[:, None] - Z[None]) ** 2 / np.exp(2 * ls)).sum(-1)),
                Kmn=np.exp(-((Z[:, None] - X[None]) ** 2 / np.exp(2 * ls)).sum(-1)),
                knn_diag=np.ones(40), Y=Y, log_sigma=np.log(0.2), w2=np.array([1.0, 2.0, 0.5]),
                n_valid=mask.sum(), col_mask=mask)
    got = tsp._sgpr_terms(**{k: torch.as_tensor(v) for k, v in args.items()},
                          dtype=torch.float64, sigma_n_num=0.01, qr_b=qr_b)
    want = jsp._sgpr_terms(**{k: jnp.asarray(v) for k, v in args.items()}, sigma_n_num=0.01,
                           qr_b=qr_b)
    other = tsp._sgpr_terms(**{k: torch.as_tensor(v) for k, v in args.items()},
                            dtype=torch.float64, sigma_n_num=0.01, qr_b=not qr_b)
    for g, w, o in zip(got, want, other):
        _close(g, w, 1e-10)
        _close(g, o, 1e-10)


def _jax_loss_and_grads(jm, qr_b):
    """``jax.value_and_grad`` of JAX's sparse_nll at balance 0.7, through
    its QR capacitance with ``qr_b`` (``_sgpr_terms`` is looked up while
    the loss is traced)."""
    fn = jax.jit(jax.value_and_grad(jsp.sparse_nll), static_argnames=("cfg", "layout"))
    orig = jsp._sgpr_terms
    if qr_b:
        jsp._sgpr_terms = functools.partial(orig, qr_b=True)
    try:
        return fn(jm.params, jnp.asarray(jm.get_Y()), jm.config, jm.layout, 0.7)
    finally:
        jsp._sgpr_terms = orig


@pytest.mark.parametrize("case,qr_b", [("back_step_2_delta", False), ("hyperprior", False),
                                       ("hyperprior", True)])
def test_sparse_nll_and_gradients_match_jax(pairs, monkeypatch, case, qr_b):
    jm, tm = pairs[case]
    jloss, jgrads = _jax_loss_and_grads(jm, qr_b)
    if qr_b:
        monkeypatch.setattr(tsp, "_sgpr_terms",
                            functools.partial(tsp._sgpr_terms, qr_b=True))
    leaves = [getattr(tm.params, f).clone().requires_grad_(True) for f in FIELDS]
    params = tsp.SparseParams(**dict(zip(FIELDS, leaves)))
    Y = torch.as_tensor(tm.get_Y())
    loss = tsp.sparse_nll(params, Y, tm.config, tm.layout, 0.7)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, jloss, GRAD_RTOL)
    for f, g in zip(FIELDS, grads):
        _close(g, getattr(jgrads, f), GRAD_RTOL, f)
    jY = jnp.asarray(jm.get_Y())
    _close(tsp.y_sparse_nll(tm.params, Y, tm.config), jsp.y_sparse_nll(jm.params, jY, jm.config),
           GRAD_RTOL)
    pads = tsp.class_pads(tm.layout, "cpu", torch.float64)
    _close(tsp.x_sparse_nll(tm.params, tm.config, pads),
           jsp.x_sparse_nll(jm.params, jm.config, jsp._pads_jnp(jm.layout, jY.dtype)), GRAD_RTOL)
    if not qr_b:
        np.testing.assert_allclose(tm.gpdm_loss(0.7), _np(jloss), rtol=GRAD_RTOL)


def test_float64_evaluation_of_the_fp32_objective(pairs):
    """A float32 config on float64 tensors is the fp32 objective (Kuu's
    1e-4 jitter, the relative floor, the QR capacitance) without its
    rounding: the fp32 loss sits far closer to it than to the float64
    objective, which the float64 config gives."""
    _, tm = pairs["base"]
    Y = torch.as_tensor(tm.get_Y())
    cfg32 = tm.config.replace(dtype="float32")
    p32 = tsp.SparseParams(**{f: getattr(tm.params, f).float() for f in FIELDS})
    loss32 = float(tsp.sparse_nll(p32, Y.float(), cfg32, tm.layout))
    of32 = float(tsp.sparse_nll(tm.params, Y, cfg32, tm.layout))
    loss64 = float(tsp.sparse_nll(tm.params, Y, tm.config, tm.layout))
    assert tm.config.dtype == "float64" and loss64 == tm.gpdm_loss()
    assert abs(loss32 - of32) <= 1e-3 * abs(loss64 - of32)


# ---------------------------------------------------------------- training


@pytest.mark.parametrize("mode", ["all", "latent", "dynamics"])
def test_sparse_trainable_mask_matches_jax(pairs, mode):
    jm, tm = pairs["base"]
    cfg = tm.config.replace(flg_train_y_sigma_n=False)
    jmask = jtrainer.sparse_trainable_mask(jm.config.replace(flg_train_y_sigma_n=False), mode)
    tmask = trainer.sparse_trainable_mask(cfg, mode)
    assert type(tmask) is tsp.SparseParams
    for f in FIELDS:
        assert float(getattr(tmask, f)) == float(getattr(jmask, f)), f


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_X_matches_jax(pairs, case):
    jm, tm = pairs[case]
    assert type(tm.params) is tsp.SparseParams and tm._opt_state is None
    _assert_fields(tm.params, jm.params, FIELDS, INIT_RTOL)
    _assert_fields(tm.posterior, jm.posterior, tsp.POSTERIOR_FIELDS, PRED_RTOL)


@pytest.fixture(scope="module")
def adam_runs(pairs):
    """5 steps of the port's trainer (the sparse objective) and of the JAX
    trainer's from the same state."""
    jm, tm = pairs["back_step_2_delta"]
    tc = dict(num_steps=5, lr=0.01, print_every=2)
    jres = jtrainer.train_adam(jm.params, jm.get_Y(), jm.config, jm.layout,
                               jtrainer.TrainConfig(**tc), kind="sparse")
    tres = trainer.train_adam(tm.params, tm.get_Y(), tm.config, tm.layout, TrainConfig(**tc),
                              objective=trainer.sparse_objective)
    return jm, tm, jres, tres


def test_adam_matches_the_jax_trainer(adam_runs):
    """The losses, the parameters and the Adam state, leaf by leaf."""
    jm, tm, jres, tres = adam_runs
    assert type(tres.params) is tsp.SparseParams and type(tres.opt_state.mu) is tsp.SparseParams
    _close(tres.losses, jres.losses, GRAD_RTOL)
    _assert_fields(tres.params, jres.params, FIELDS, GRAD_RTOL)
    _assert_adam_state(tres.opt_state, jres.opt_state, GRAD_RTOL)
    with pytest.raises(ValueError, match="Adam state over SparseParams"):
        trainer.train_adam(tm.params, tm.get_Y(), tm.config, tm.layout, TrainConfig(5),
                           opt_state=trainer.AdamState.init(core.GPMDMParams(
                               **{f: getattr(tm.params, f) for f in core.PARAM_FIELDS})),
                           objective=trainer.sparse_objective)


def test_nan_freeze_matches_jax(adam_runs):
    """After the 5 steps, one whose loss is NaN: the parameters and the
    whole Adam state stay as they were, in both packages."""
    jm, tm, jres, tres = adam_runs

    def poison(mod, lib):
        def loss(p, Y, cfg, layout, balance, **kw):
            return mod.sparse_nll(p, Y, cfg, layout, balance, **kw) + lib.log(
                p.Zy.reshape(-1)[0] * 0 - 1.0)
        return loss

    jstep = jax.jit(jtrainer.make_update_step(
        jm.config, jm.layout, optax.adam(0.01), 1.0,
        jtrainer.sparse_trainable_mask(jm.config), poison(jsp, jnp)))
    tstep = trainer.make_update_step(tm.config, tm.layout, 0.01, 1.0,
                                     trainer.sparse_trainable_mask(tm.config), poison(tsp, torch))
    (jp, jstate, _), jloss = jstep((jres.params, jres.opt_state, jnp.asarray(jm.get_Y())), None)
    tp, ts, tloss = tstep(tres.params, tres.opt_state, torch.as_tensor(tm.get_Y()))
    assert not np.isfinite(float(tloss)) and not np.isfinite(float(jloss))
    assert all(torch.equal(getattr(tp, f), getattr(tres.params, f)) for f in FIELDS)
    assert all(np.array_equal(a, b) for a, b in zip(ts.to_numpy(), tres.opt_state.to_numpy()))
    _assert_fields(tp, jp, FIELDS, GRAD_RTOL)
    _assert_adam_state(ts, jstate, GRAD_RTOL)
    assert int(ts.count) == 5


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_saved_adam_state_resumes_across_packages(tmp_path, direction):
    """2 steps in one package, then a save that the other package loads
    with the same parameters and Adam state; a JAX-saved model then trains
    2 more steps in both packages to the same losses, parameters,
    posterior and state (count 4)."""
    path = tmp_path / "sparse.npz"
    src = _model(JSparseGPMDM if direction == "jax_to_port" else SparseGPMDM)
    src.train_adam(num_opt_steps=2, lr=0.02)
    src.save(path)
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta_json"]).decode())
    assert meta["has_opt_state"] and meta["n_opt_leaves"] == 21
    assert meta["optimizer_name"] == "adam"
    dst = (load_model(path, device="cpu") if direction == "jax_to_port"
           else JSparseGPMDM.load(path))
    port, jax_m = (dst, src) if direction == "jax_to_port" else (src, dst)
    _assert_fields(port.params, jax_m.params, FIELDS, 0.0)
    _assert_adam_state(port._opt_state, jax_m._opt_state, 0.0)
    if direction == "port_to_jax":
        return
    np.testing.assert_allclose(dst.train_adam(num_opt_steps=2, lr=0.02),
                               src.train_adam(num_opt_steps=2, lr=0.02), rtol=GRAD_RTOL)
    _assert_fields(port.params, jax_m.params, FIELDS, GRAD_RTOL)
    _assert_fields(port.posterior, jax_m.posterior, tsp.POSTERIOR_FIELDS, 1e-7)
    _assert_adam_state(port._opt_state, jax_m._opt_state, GRAD_RTOL)
    assert int(port._opt_state.count) == 4


@pytest.mark.parametrize("case", ["base", "back_step_2_delta"])
def test_rollout_matches_jax(pairs, case):
    jm, tm = pairs[case]
    X = np.asarray(jm.params.X)
    x0 = X[3] if jm.config.dyn_back_step == 1 else X[[3, 2]]
    got = tm.rollout(x0, 6, 1)
    assert got.shape == (6, 2)
    _close(got, jm.rollout(x0, 6, 1), PRED_RTOL)


# ------------------------------------------------------- the committed assets


def _float64_copy(src: Path, dst: Path) -> Path:
    """The checkpoint with its config in float64 and no persisted posterior:
    each package loads it in float64 and factors the posterior itself."""
    with np.load(src) as data:
        arrays = {k: data[k] for k in data.files if not k.startswith("post_")}
    meta = json.loads(bytes(arrays["meta_json"]).decode())
    meta["config"]["dtype"] = "float64"
    meta.pop("posterior_class")
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(dst, **arrays)
    return dst


@pytest.fixture(scope="module")
def sparse10240_f64(tmp_path_factory):
    path = _float64_copy(ASSETS / "bench_model_sparse10240.npz",
                         tmp_path_factory.mktemp("c8") / "sparse10240_f64.npz")
    return JSparseGPMDM.load(path), load_model(path, device="cpu")


@pytest.mark.parametrize("floored", [False, True])
def test_sparse_diagnostics_match_jax_in_float64(sparse10240_f64, floored):
    """get_latent_map_performance and get_dynamics_map_performance_for_class
    of every class, on the sparse10240 asset's parameters in float64."""
    jm, tm = sparse10240_f64
    assert tm.dtype == torch.float64 and tm.params.X.dtype == torch.float64
    got, want = tm.get_latent_map_performance(floored=floored), \
        jm.get_latent_map_performance(floored=floored)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, ASSET_RTOL)
    np.testing.assert_allclose(got[3], want[3], rtol=ASSET_RTOL)
    for c in range(tm.n_classes):
        got = tm.get_dynamics_map_performance_for_class(c, floored=floored)
        want = jm.get_dynamics_map_performance_for_class(c, floored=floored)
        lo, hi = tm.layout.x_class_offsets[c], tm.layout.x_class_offsets[c + 1]
        assert got[0].shape == (hi - lo, 2)
        for g, w in zip(got[:4], want[:4]):
            _close(g, w, ASSET_RTOL)
        np.testing.assert_allclose(got[4], want[4], rtol=ASSET_RTOL)


@pytest.mark.parametrize("name", ["sparse10240", "hourlong"])
def test_asset_adam_state_survives_load_and_save(tmp_path, name):
    """The 21 Adam leaves of the asset load as they are in the npz (the
    moments over SparseParams), and a save by the port writes them back."""
    src = ASSETS / f"bench_model_{name}.npz"
    with np.load(src) as data:
        meta = json.loads(bytes(data["meta_json"]).decode())
        leaves = [data[f"opt_{i}"] for i in range(meta["n_opt_leaves"])]
    assert meta["has_opt_state"] and len(leaves) == 21
    tm = load_model(src, device="cpu")
    state = tm._opt_state
    assert type(state.mu) is type(state.nu) is tsp.SparseParams
    for a, b in zip(state.to_numpy(), leaves):
        np.testing.assert_array_equal(a, b)
    tm.save(tmp_path / "resaved.npz")
    with np.load(tmp_path / "resaved.npz") as data:
        meta2 = json.loads(bytes(data["meta_json"]).decode())
        assert meta2["has_opt_state"] and meta2["optimizer_name"] == "adam"
        assert meta2["n_opt_leaves"] == 21
        for i, b in enumerate(leaves):
            np.testing.assert_array_equal(data[f"opt_{i}"], b)
