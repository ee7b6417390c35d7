"""The back-constrained GPMDM in the port against the JAX package's, on the
CPU in float64: the synthetic task at C = 2 classes of 2 x 25 frames (Ny =
100), D = 8, d = 2, the median lengthscale.

- ``back_kernel`` and ``median_lengthscale`` as the JAX package's;
  ``bc_nll`` and the gradient of every leaf (W in the X slot) against
  ``jax.value_and_grad``, rtol 1e-8, with K_b passed in and built inside.
- ``BCGPMDM.init_X`` (W0, X = K_b W0, the lengthscale) to 1e-12; 5 Adam
  steps (W, the hyperparameters, mu, nu, count) to 1e-8 against the JAX
  model's; ``map_y_to_x`` of the training observations is X.
- Checkpoints both ways: W in the X slot, X rematerialized, the Adam state,
  and the compressed cache restored after the rematerialization (as
  ``tests/test_back_constrained.py`` checks it in the JAX package).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from gpmdm_tpu import BCGPMDM as JBCGPMDM
from gpmdm_tpu.models import back_constrained as jbc
from gpmdm_tpu_torch import BCGPMDM, GPMDM, GPMDM_PF
from gpmdm_tpu_torch.data import synthetic
from gpmdm_tpu_torch.models import back_constrained as tbc
from gpmdm_tpu_torch.models import compressed as tcomp
from gpmdm_tpu_torch.models import core
from gpmdm_tpu_torch.utils.io import load_model

FIELDS = core.PARAM_FIELDS
GRAD_RTOL, PRED_RTOL, INIT_RTOL = 1e-8, 1e-10, 1e-12
TR, TL, TE, TEL = synthetic.make_dataset(n_classes=2, n_train_seqs=2, n_test_seqs=1,
                                         seq_len=25, D=8, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS and OpenMP thread: idle pool threads spinning between
    calls would take cores from the suite's other workers."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _model(cls):
    extra = {} if cls is JBCGPMDM else {"device": "cpu"}
    m = cls(D=8, d=2, n_classes=2, dtype="float64", y_sigma_n_init=0.1, x_sigma_n_init=0.1,
            **extra)
    for Y, c in zip(TR, TL):
        m.add_data(Y, c)
    m.init_X()
    return m


@pytest.fixture(scope="module")
def pair():
    """(JAX, port) BC models, PCA-initialized through the constraint."""
    return _model(JBCGPMDM), _model(BCGPMDM)


@pytest.fixture(scope="module")
def trained():
    """The pair after 5 Adam steps in each package, and their losses."""
    jm, tm = _model(JBCGPMDM), _model(BCGPMDM)
    return jm, tm, jm.train_adam(num_opt_steps=5, lr=0.01), tm.train_adam(num_opt_steps=5,
                                                                            lr=0.01)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rtol, msg=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=msg)


def _assert_params(tparams, jparams, rtol):
    for f in FIELDS:
        _close(getattr(tparams, f), getattr(jparams, f), rtol, f)


def _assert_adam_state(tstate, jstate, rtol):
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    tleaves = tstate.to_numpy()
    assert len(tleaves) == len(jleaves) == 17
    assert int(tleaves[0]) == int(jleaves[0])
    for i, (a, b) in enumerate(zip(tleaves[1:], jleaves[1:])):
        _close(a, b, rtol, f"opt leaf {i + 1}")


def test_back_kernel_and_median_lengthscale_match_jax():
    Y = np.concatenate(TR)
    ls = tbc.median_lengthscale(Y)
    assert ls == jbc.median_lengthscale(Y) > 0
    got = tbc.back_kernel(torch.as_tensor(Y[:30]), torch.as_tensor(Y), ls, torch.float64)
    _close(got, jbc.back_kernel(Y[:30], Y, ls, jnp.float64), PRED_RTOL)
    np.testing.assert_allclose(_np(got).sum(1), 1.0, rtol=1e-14)


@pytest.fixture(scope="module")
def jax_loss_and_grads(pair):
    """JAX's bc_nll and its gradient at the initial W, balance 0.7."""
    jm, _ = pair
    return jax.jit(jax.value_and_grad(jbc.bc_nll), static_argnames=("cfg", "layout"))(
        jm._params_for_save(), jnp.asarray(jm.get_Y()), jm.config, jm.layout, 0.7)


@pytest.mark.parametrize("prebuilt", [False, True])
def test_bc_nll_and_gradients_match_jax(pair, jax_loss_and_grads, prebuilt):
    jm, tm = pair
    jloss, jgrads = jax_loss_and_grads
    Y = torch.as_tensor(tm.get_Y())
    Kb = tbc.back_kernel(Y, Y, tm.config.back_constraint_ls, Y.dtype) if prebuilt else None
    leaves = [getattr(tm._params_for_save(), f).clone().requires_grad_(True) for f in FIELDS]
    loss = tbc.bc_nll(core.GPMDMParams(**dict(zip(FIELDS, leaves))), Y, tm.config, tm.layout,
                      0.7, Kb=Kb)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, jloss, GRAD_RTOL)
    for f, g in zip(FIELDS, grads):
        _close(g, getattr(jgrads, f), GRAD_RTOL, f)
    np.testing.assert_allclose(tm.gpdm_loss(0.7), _np(jloss), rtol=GRAD_RTOL)


def test_init_X_matches_jax(pair):
    jm, tm = pair
    assert tm.config.back_constraint_ls == jm.config.back_constraint_ls > 0
    _close(tm._W, jm._W, INIT_RTOL, "W0")
    _assert_params(tm.params, jm.params, INIT_RTOL)
    _close(tm.posterior.Ay, jm.posterior.Ay, PRED_RTOL)
    assert tm._opt_state is None


def test_adam_matches_jax(trained):
    """5 steps of ``train_adam`` in each package: the losses, W, the
    hyperparameters, the rematerialized X and the Adam state over W."""
    jm, tm, jlosses, tlosses = trained
    _close(np.asarray(tlosses), np.asarray(jlosses), GRAD_RTOL)
    _close(tm._W, jm._W, GRAD_RTOL, "W")
    _assert_params(tm.params, jm.params, GRAD_RTOL)
    _assert_adam_state(tm._opt_state, jm._opt_state, GRAD_RTOL)
    Y = torch.as_tensor(tm.get_Y())
    Kb = tbc.back_kernel(Y, Y, tm.config.back_constraint_ls, torch.float64)
    _close(tm.params.X, Kb @ tm._W, INIT_RTOL)
    assert tlosses[-1] < tlosses[0]


def test_map_y_to_x_matches_jax(trained):
    jm, tm, _, _ = trained
    _close(tm.map_y_to_x(tm.get_Y()), tm.params.X, PRED_RTOL)
    q = TE[0][:7]
    got = tm.map_y_to_x(q)
    assert got.shape == (7, 2)
    _close(got, jm.map_y_to_x(q), GRAD_RTOL)
    _close(tm.map_y_to_x(q[0]), got[:1], PRED_RTOL)


@pytest.mark.parametrize("direction", ["port_to_port", "port_to_jax", "jax_to_port"])
def test_checkpoint_round_trips(trained, tmp_path, monkeypatch, direction):
    """W in the X slot, X = K_b W rematerialized at load, the Adam state,
    the lengthscale; the compressed cache restored after the
    rematerialization (no compression at load; equal to a fresh one of
    the loaded model's parameters)."""
    jm, tm, _, _ = trained
    src = jm if direction == "jax_to_port" else tm
    cp = src.compressed_posterior(rank_y=8, rank_x=6)
    path = tmp_path / "bc.npz"
    src.save(path)
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta_json"]).decode())
        np.testing.assert_array_equal(data["param_X"], _np(src._W))
    assert meta["model_class"] == "BCGPMDM" and meta["has_opt_state"]
    assert meta["config"]["back_constraint_ls"] == tm.config.back_constraint_ls
    if direction == "port_to_jax":
        back = JBCGPMDM.load(path)
        assert type(back).__name__ == "BCGPMDM"
        _close(back._W, tm._W, 0.0)
        _close(back.params.X, tm.params.X, INIT_RTOL)
        _assert_adam_state(tm._opt_state, back._opt_state, 0.0)
        np.testing.assert_array_equal(np.asarray(back.compressed_posterior(8, 6).Uy),
                                      _np(cp.Uy))
        return
    calls, real = [], tcomp.compress_host
    monkeypatch.setattr(tcomp, "compress_host",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    back = load_model(path, device="cpu")
    got = back.compressed_posterior(rank_y=8, rank_x=6)
    assert type(back) is BCGPMDM and calls == []
    assert back.config.back_constraint_ls == src.config.back_constraint_ls
    _close(back._W, src._W, 0.0)
    _close(back.params.X, src.params.X, INIT_RTOL)
    for f in FIELDS[:-1]:
        _close(getattr(back.params, f), getattr(src.params, f), 0.0, f)
    if direction == "jax_to_port":
        _assert_adam_state(back._opt_state, jm._opt_state, 0.0)
    else:
        assert all(np.array_equal(a, b) for a, b in zip(back._opt_state.to_numpy(),
                                                         tm._opt_state.to_numpy()))
    np.testing.assert_array_equal(_np(got.Uy), _np(cp.Uy))
    back._precompute_kernel_inverses()
    fresh = back.compressed_posterior(rank_y=8, rank_x=6)
    _close(fresh.inv_mu_y, cp.inv_mu_y, 1e-9)
    if direction == "port_to_port":
        np.testing.assert_allclose(back.gpdm_loss(), tm.gpdm_loss(), rtol=1e-10)


def test_bc_model_filters_and_loads_through_gpmdm(trained, tmp_path):
    """GPMDM.load dispatches on the saved class, and the filter runs on the
    model's exact posterior of X = K_b W."""
    _, tm, _, _ = trained
    tm.save(tmp_path / "bc.npz")
    m = GPMDM.load(tmp_path / "bc.npz", device="cpu")
    assert type(m) is BCGPMDM
    out = GPMDM_PF(m, [[0.9, 0.1], [0.1, 0.9]], 64, seed=0).run(TE[0][:5])
    assert out.class_probs.shape == (5, 2) and torch.isfinite(out.class_probs).all()
