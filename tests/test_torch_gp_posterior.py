"""The PyTorch port's fused GP-posterior functions (gpmdm_tpu_torch.ops.
gp_posterior) against the JAX package's Pallas kernels, run in interpret
mode on the CPU.  The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py.

Both sides run in float32 on the same inputs, made from a seed with numpy.
Tolerance rtol 1e-5, atol 1e-6: the two sides sum in different orders.
The class-batched dynamics function must equal the per-class calls bit for
bit: its plain version is their stack.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmdm_tpu.ops.pallas import gp_posterior as jgp
from gpmdm_tpu_torch.ops import gp_posterior as tgp
from gpmdm_tpu_torch.utils import profiling

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


# K1's cases with C class blocks: one class (ids as CASES), and two and
# three classes through the class-batched function in one call
X_CASES = ([pytest.param(*c, 1, id="-".join(map(str, c))) for c in CASES]
           + [pytest.param(*c, C, id="-".join(map(str, c)) + f"-C{C}")
              for C in (2, 3) for c in CASES])


@pytest.mark.parametrize("N,P,d,C", X_CASES)
@pytest.mark.parametrize("n_cut", [0, 7])
def test_fused_x_posterior_plain_matches_pallas(interpret, N, P, d, C, n_cut):
    """Includes n_valid < N: the masked rows must contribute exactly 0.
    ``fused_x_posterior_classes`` over C stacked class blocks (its own
    training rows, weights and Kinv each; shared particles and
    hyperparameters): every class equals the port's per-class call bit for
    bit and matches the JAX package's per-class ``fused_x_posterior``;
    class 0 (the C = 1 case's inputs) at the file's tolerance, the other
    classes within the fp32 summation bound ``_fp32_bound`` (+ atol), since
    two fp32 sums of N terms in different orders may differ by that much
    where the terms cancel."""
    blocks = [_inputs(N, P, d, seed=2 * N + P + d + 101 * ci) for ci in range(C)]
    x = blocks[0]
    n_valid = N - n_cut
    stacked = [_t(np.stack([b[k] for b in blocks])) for k in ("Xt", "A", "Kinv")]
    shared = [_t(x[k]) for k in ("Xs", "inv_ls", "lin_w")]
    means, quads = tgp.fused_x_posterior_classes(stacked[0], shared[0], stacked[1], stacked[2],
                                                 shared[1], shared[2], n_valid)
    assert means.shape == (C, P, D_OUT) and quads.shape == (C, P)
    for ci, b in enumerate(blocks):
        want = jgp.fused_x_posterior(
            *(jnp.asarray(v) for v in (b["Xt"], x["Xs"], b["A"], b["Kinv"], x["inv_ls"],
                                       x["lin_w"])), n_valid=n_valid)
        one = tgp.fused_x_posterior(_t(b["Xt"]), shared[0], _t(b["A"]), _t(b["Kinv"]),
                                    shared[1], shared[2], n_valid)
        bounds = _fp32_bound(b, x, n_valid)
        for g, o, w, bound in zip((means[ci], quads[ci]), one, want, bounds):
            assert torch.equal(g, o)
            if ci == 0:
                _close(g, w)
            else:
                assert np.all(np.abs(g.numpy() - np.asarray(w, np.float64)) <= bound + ATOL)


def _fp32_bound(b, x, n_valid):
    """Bounds on the error of any fp32 evaluation of K1's mean and quad, in
    any order of summation: 2 N u times the sum of the terms' magnitudes
    (u = 2^-24), from a float64 star kernel of the block ``b``."""
    f = lambda a: np.asarray(a, np.float64)  # noqa: E731
    il, w = f(x["inv_ls"]), f(x["lin_w"])
    xt, xs = f(b["Xt"]), f(x["Xs"])
    sq = np.sum((xt[:, None, :] * il - xs[None, :, :] * il) ** 2, axis=2)
    ks = np.abs(np.exp(-sq) + (xt * w[:-1]) @ (xs * w[:-1]).T + w[-1] ** 2)
    ks[n_valid:] = 0.0
    g = 2 * xt.shape[0] * 2.0 ** -24
    return g * (ks.T @ np.abs(f(b["A"]))), g * np.sum(ks * (np.abs(f(b["Kinv"])) @ ks), axis=0)


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
    profiling.reset()
    x = _inputs(20, 10, 2, seed=6)
    tgp.fused_obs_loglik(*(_t(x[k]) for k in ("Xt", "Xs", "A", "Kinv", "inv_ls", "z", "lam2")))
    tgp.fused_x_posterior(*(_t(x[k]) for k in ("Xt", "Xs", "A", "Kinv", "inv_ls", "lin_w")), 20)
    tgp.fused_x_posterior_classes(*(_t(x[k])[None] if k in ("Xt", "A", "Kinv") else _t(x[k])
                                    for k in ("Xt", "Xs", "A", "Kinv", "inv_ls", "lin_w")), 20)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


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
