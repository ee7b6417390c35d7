"""The port's distributed Cholesky, triangular solve and observation-NLL
core (gpmdm_tpu_torch.parallel.dist_chol) on 4 gloo ranks on the CPU, in
float64, and its launcher's limits.

One group of 4 ranks (``tests/torch_dist_ranks.dist_chol_checks``, a 60 s
wall limit) runs every check; each rank returns its row panels, which the
parent stacks in rank order.  On tests/test_dist_chol.py's problem (N =
64, D = 5, a seeded SPD K):

- ``chol_rowblock`` against numpy's Cholesky, ``tri_solve_lower_rowblock``
  against scipy's triangular solve (rtol 1e-10, atol 1e-12);
- ``y_nll_dist``: the shares summed against JAX's single-device formula
  (rtol 1e-12), and its gradients in K, Y and w2 against ``jax.grad`` of
  that formula (rtol 1e-9, atol 1e-11; dK symmetrized on both sides, as
  the JAX package's test does: the closed-form adjoint is the symmetric
  representative);
- the collectives of each function, pinned.

The launcher: a rank that fails raises its traceback in the parent, and a
rank that hangs is killed at the wall limit.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sl

import torch_dist_ranks as ranks
from gpmdm_tpu_torch import parallel as par

N, D, RANKS = 64, 5, 4
WALL_LIMIT_S = 60


@pytest.fixture(scope="module")
def spd():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(N, N))
    K = M @ M.T / N + np.eye(N) * 2.0
    Y = rng.normal(size=(N, D))
    w2 = np.exp(rng.normal(size=(D,)))
    return {"K": K, "Y": Y, "w2": w2}


@pytest.fixture(scope="module")
def results(spd):
    return par.launch(ranks.dist_chol_checks, RANKS, spd, device="cpu", timeout_s=WALL_LIMIT_S)


def _ref_value(K, Y, w2):
    L = jnp.linalg.cholesky(K)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    V = jax.scipy.linalg.solve_triangular(L, Y, lower=True)
    return 0.5 * D * logdet + 0.5 * jnp.sum(w2 * jnp.sum(V * V, axis=0))


def test_ranks_import_neither_jax_nor_the_jax_package(results):
    assert [r["jax_imported"] for r in results] == [False] * RANKS


def test_chol_rowblock_matches_numpy(spd, results):
    L = np.concatenate([r["L"] for r in results])
    np.testing.assert_allclose(L, np.linalg.cholesky(spd["K"]), rtol=1e-10, atol=1e-12)


def test_tri_solve_lower_matches_scipy(spd, results):
    X = np.concatenate([r["X"] for r in results])
    want = sl.solve_triangular(np.linalg.cholesky(spd["K"]), spd["Y"], lower=True)
    np.testing.assert_allclose(X, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("which", ["value", "K", "Y", "w2"])
def test_y_nll_dist_value_and_grads_match_jax(spd, results, which):
    K, Y, w2 = (jnp.asarray(spd[k]) for k in ("K", "Y", "w2"))
    if which == "value":
        got = sum(r["value"] for r in results)
        np.testing.assert_allclose(got, float(_ref_value(K, Y, w2)), rtol=1e-12)
        return
    i = ("K", "Y", "w2").index(which)
    want = np.asarray(jax.grad(_ref_value, argnums=i)(K, Y, w2))
    if which == "w2":  # replicated: each rank holds its share
        got = sum(r["grads"][2] for r in results)
    else:  # row-sharded: each rank holds its rows
        got = np.concatenate([r["grads"][i] for r in results])
    if which == "K":
        sym = lambda A: 0.5 * (A + A.T)  # noqa: E731
        got, want = sym(got), sym(want)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)


def test_collectives_of_dist_chol_pinned(results):
    """One panel all-gather a block step (4) in the factorization; one
    broadcast a block step (4) in the solve; y_nll_dist's value and
    gradient: the factorization, the forward solve, the backward's solve
    against I and its 3 all-gathers (Z = L^-1, Y, K^-1 Y)."""
    for r in results:
        assert r["counts"] == {
            "chol": {"all_gather": RANKS},
            "solve": {"pbroadcast": RANKS},
            "value_and_grad": {"all_gather": RANKS + 3, "pbroadcast": 2 * RANKS}}


def test_launch_raises_a_failed_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank failure 7"):
        par.launch(ranks.fails, 2, 7, device="cpu", timeout_s=WALL_LIMIT_S)


def test_launch_kills_ranks_past_its_wall_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        par.launch(ranks.hangs, 2, device="cpu", timeout_s=5)
    assert time.monotonic() - t0 < 30
