"""The PyTorch port's fused GP-posterior functions (gpmdm_tpu_torch.ops.
gp_posterior) against the JAX package's Pallas kernels, run in interpret
mode on the CPU.  The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py.

Both sides run in float32 on the same inputs, made from a seed with numpy.
Tolerance rtol 1e-5, atol 1e-6: the two sides sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmdm_tpu.ops.pallas import gp_posterior as jgp
from gpmdm_tpu_torch.ops import gp_posterior as tgp

RTOL, ATOL = 1e-5, 1e-6
D_OUT = 5
# (N, P, d): N training rows (not a multiple of any tile), P particles
# (ragged against every particle tile), d latent dimensions
CASES = [(37, 50, 2), (130, 300, 3), (37, 300, 3), (130, 50, 2)]


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(N, P, d, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    M = rng.normal(size=(N, N))
    return dict(
        Xt=rng.normal(size=(N, d)).astype(f32),
        Xs=rng.normal(size=(P, d)).astype(f32),
        A=rng.normal(size=(N, D_OUT)).astype(f32),
        Kinv=(M @ M.T / N + np.eye(N)).astype(f32),
        inv_ls=np.exp(0.3 * rng.normal(size=d)).astype(f32),
        lin_w=np.exp(0.3 * rng.normal(size=d + 1)).astype(f32),
        z=rng.normal(size=D_OUT).astype(f32),
        lam2=np.exp(rng.normal(size=D_OUT)).astype(f32),
    )


def _t(a, device="cpu"):
    return torch.as_tensor(a, device=device)


def _close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("N,P,d", CASES)
def test_fused_rbf_posterior_plain_matches_pallas(interpret, N, P, d):
    x = _inputs(N, P, d, seed=N + P + d)
    want = jgp.fused_rbf_posterior(*(jnp.asarray(x[k]) for k in ("Xt", "Xs", "A", "Kinv", "inv_ls")))
    got = tgp.fused_rbf_posterior(*(_t(x[k]) for k in ("Xt", "Xs", "A", "Kinv", "inv_ls")))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("N,P,d", CASES)
@pytest.mark.parametrize("n_cut", [0, 7])
def test_fused_x_posterior_plain_matches_pallas(interpret, N, P, d, n_cut):
    """Includes n_valid < N: the masked rows must contribute exactly 0."""
    x = _inputs(N, P, d, seed=2 * N + P + d)
    keys = ("Xt", "Xs", "A", "Kinv", "inv_ls", "lin_w")
    n_valid = N - n_cut
    want = jgp.fused_x_posterior(*(jnp.asarray(x[k]) for k in keys), n_valid=n_valid)
    got = tgp.fused_x_posterior(*(_t(x[k]) for k in keys), n_valid)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("N,P,d", CASES)
def test_fused_obs_loglik_plain_matches_pallas(interpret, N, P, d):
    x = _inputs(N, P, d, seed=3 * N + P + d)
    keys = ("Xt", "Xs", "A", "Kinv", "inv_ls", "z", "lam2")
    want = jgp.fused_obs_loglik(*(jnp.asarray(x[k]) for k in keys))
    got = tgp.fused_obs_loglik(*(_t(x[k]) for k in keys))
    for g, w in zip(got, want):
        _close(g, w)


def test_masked_rows_are_exactly_zero():
    """Rows >= n_valid of the star kernel are exactly 0: garbage in the
    masked rows of A and Kinv cannot reach the outputs."""
    x = _inputs(40, 33, 2, seed=5)
    Xt, Xs, A, Kinv, inv_ls, lin_w = (_t(x[k]) for k in ("Xt", "Xs", "A", "Kinv", "inv_ls", "lin_w"))
    ref = tgp.fused_x_posterior(Xt[:30], Xs, A[:30], Kinv[:30, :30], inv_ls, lin_w, 30)
    A, Kinv = A.clone(), Kinv.clone()
    A[30:] = 1e3
    Kinv[30:, :] = 1e3
    Kinv[:, 30:] = 1e3
    got = tgp.fused_x_posterior(Xt, Xs, A, Kinv, inv_ls, lin_w, 30)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL)


def test_cpu_wrappers_count_no_launches():
    tgp.reset_launches()
    x = _inputs(20, 10, 2, seed=6)
    tgp.fused_obs_loglik(*(_t(x[k]) for k in ("Xt", "Xs", "A", "Kinv", "inv_ls", "z", "lam2")))
    tgp.fused_x_posterior(*(_t(x[k]) for k in ("Xt", "Xs", "A", "Kinv", "inv_ls", "lin_w")), 20)
    assert all(v == 0 for v in tgp.LAUNCHES.values())


def test_launcher_codes_become_clear_errors():
    """A launcher's 0 passes; any other code is a CUDA error (the kernels
    no longer refuse any number of training rows); a tile outside
    ``TILES`` is refused before any launch."""
    tgp._raise_on_error("fused_obs_loglik", 0)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tgp._raise_on_error("fused_x_posterior", 700)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tgp._raise_on_error("fused_obs_loglik", 1)
    for tile in tgp.TILES:
        tgp._check_tile("fused_obs_loglik", tile)
    with pytest.raises(ValueError, match="tile must be one of"):
        tgp._check_tile("fused_obs_loglik", 48)
