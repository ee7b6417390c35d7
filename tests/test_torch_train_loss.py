"""The port's MAP loss against the JAX package's, on the CPU in float64.

Each loss term is compared in value and in the gradient of every parameter
leaf (``jax.value_and_grad`` against ``torch.autograd``), on a small model
(3 classes, 4 sequences of 18-22 frames, D = 6, d = 2 or 3) whose class
blocks are unequal, so the batched form pads.  Tolerances: value rtol
1e-9; each gradient leaf rtol 1e-7, with atol 1e-7 x that leaf's largest
JAX magnitude (entries near zero would otherwise be held to nothing).
Both packages do the same float64 algebra, in a different order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from gpmdm_tpu.config import GPMDMConfig as JConfig
from gpmdm_tpu.models import core as jcore
from gpmdm_tpu.ops import layout as jlayout
from gpmdm_tpu.ops import linalg as jlinalg
from gpmdm_tpu_torch import GPMDMConfig
from gpmdm_tpu_torch.models import core
from gpmdm_tpu_torch.ops import layout
from gpmdm_tpu_torch.ops import linalg

FIELDS = core.PARAM_FIELDS
VALUE_RTOL, GRAD_RTOL = 1e-9, 1e-7
LENGTHS, CLASSES, C, D = [21, 18, 22, 19], [0, 0, 1, 2], 3, 6
MODES = [(1, "full"), (1, "delta"), (2, "full"), (2, "delta")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS and OpenMP thread: these shapes are small, and idle pool
    threads spinning between calls would take cores from the suite's other
    workers (this file's CPU time falls by a factor of 2-5)."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _problem(back_step, target, seed=0, **cfg_kw):
    """Configs, layouts, float64 parameters and observations of one mode."""
    rng = np.random.default_rng(seed)
    d = 2 if back_step == 1 else 3
    din = d * back_step
    kw = dict(D=D, d=d, n_classes=C, dyn_target=target, dyn_back_step=back_step,
              dtype="float64", sigma_n_num_X=1e-3, **cfg_kw)
    params = {
        "y_log_lengthscales": 0.3 * rng.normal(size=d),
        "y_log_lambdas": 0.2 * rng.normal(size=D),
        "y_log_sigma_n": np.array(-1.5),
        "x_log_lengthscales": 0.3 * rng.normal(size=din),
        "x_log_lambdas": 0.2 * rng.normal(size=d),
        "x_log_sigma_n": np.array(-2.0),
        "x_log_lin_coeff": 0.3 * rng.normal(size=din + 1) - 0.5,
        "X": rng.normal(size=(sum(LENGTHS), d)),
    }
    Y = rng.normal(size=(sum(LENGTHS), D))
    return (JConfig(**kw), GPMDMConfig(**kw),
            jlayout.build_layout(LENGTHS, CLASSES, C, back_step),
            layout.build_layout(LENGTHS, CLASSES, C, back_step), params, Y)


def _block(X, lay, target, c, pad):
    """Class c's (Xin, Xout), zero-padded by ``pad`` rows, and its mask."""
    xin, xout = (jlayout.xin_xout if isinstance(X, jax.Array) else layout.xin_xout)(
        X, lay, target)
    lo, hi = int(lay.x_class_offsets[c]), int(lay.x_class_offsets[c + 1])
    xin, xout = xin[lo:hi], xout[lo:hi]
    if not pad:
        return xin, xout, None
    if isinstance(X, jax.Array):
        return (jnp.pad(xin, ((0, pad), (0, 0))), jnp.pad(xout, ((0, pad), (0, 0))),
                jnp.concatenate([jnp.ones(hi - lo), jnp.zeros(pad)]))
    z = lambda a: torch.cat([a, a.new_zeros((pad, a.shape[1]))])  # noqa: E731
    return z(xin), z(xout), torch.cat([torch.ones(hi - lo, dtype=X.dtype),
                                       torch.zeros(pad, dtype=X.dtype)])


def _deflated(pad):
    def term(mod, p, Y, cfg, lay):
        xin, xout, mask = _block(p.X, lay, cfg.dyn_target, 1, pad)
        w2 = (jnp if mod is jcore else torch).exp(p.x_log_lambdas) ** 2
        ld, quad = mod.x_block_terms_deflated(xin, xout, mask, p.x_log_lengthscales,
                                              p.x_log_sigma_n, p.x_log_lin_coeff, w2,
                                              cfg.sigma_n_num_X)
        return ld + 0.5 * quad
    return term


def _padded_blocks(mod, p, Y, cfg, lay):
    idx = (jlayout if mod is jcore else layout).padded_class_indices(lay)
    to = jnp.asarray if mod is jcore else torch.as_tensor
    return mod.x_nll_padded_blocks(p, cfg, to(idx["idx_in"]), to(idx["idx_prev"]),
                                   to(idx["idx_out"]), to(idx["mask"])).sum()


# (name, loss term(module, params, Y, cfg, layout), config overrides)
TERMS = {
    "y_nll": (lambda mod, p, Y, cfg, lay: mod.y_neg_log_likelihood(p, Y, cfg), {}),
    "deflated": (_deflated(0), {}),
    "deflated_padded": (_deflated(5), {}),
    "x_nll_deflated": (lambda mod, p, Y, cfg, lay: mod.x_neg_log_likelihood(p, cfg, lay), {}),
    "x_nll_direct": (lambda mod, p, Y, cfg, lay: mod.x_neg_log_likelihood(p, cfg, lay),
                     {"deflate_x_linear": False}),
    "padded_blocks_deflated": (_padded_blocks, {}),
    "padded_blocks_direct": (_padded_blocks, {"deflate_x_linear": False}),
    "hyperprior_uniform": (lambda mod, p, Y, cfg, lay: mod.hyperprior_penalty(p, cfg),
                           {"hyperprior_weight": 2.5}),
    "hyperprior_per_group": (lambda mod, p, Y, cfg, lay: mod.hyperprior_penalty(p, cfg),
                             {"hyperprior_weights": (0.0, 1.0, 30.0, 2.0, 0.0, 30.0, 5.0),
                              "hyperprior_centers": (0.1, -0.2, -2.0, 0.0, 0.3, -1.0, 0.2)}),
    "nll": (lambda mod, p, Y, cfg, lay: mod.nll(p, Y, cfg, lay, 0.7),
            {"hyperprior_weight": 0.5}),
}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grads(back_step, target):
    """JAX's value and gradient of every term at one mode, in one jitted
    call (one compile per mode, not one per term and operation)."""
    problems = {t: _problem(back_step, target, **kw) for t, (_, kw) in TERMS.items()}
    params, Y = problems["nll"][4], jnp.asarray(problems["nll"][5])

    def all_terms(p):
        return {t: jax.value_and_grad(
            lambda q, fn=TERMS[t][0], pr=problems[t]: fn(jcore, q, Y, pr[0], pr[2]))(p)
            for t in TERMS}

    return jax.jit(all_terms)(jcore.GPMDMParams(**{f: jnp.asarray(params[f]) for f in FIELDS}))


@pytest.mark.parametrize("back_step,target", MODES, ids=[f"bs{b}-{t}" for b, t in MODES])
@pytest.mark.parametrize("term", sorted(TERMS))
def test_loss_value_and_grad_match_jax_f64(term, back_step, target):
    fn, cfg_kw = TERMS[term]
    _, tcfg, _, tl, params, Y = _problem(back_step, target, **cfg_kw)
    jval, jgrad = _jax_value_and_grads(back_step, target)[term]
    leaves = {f: torch.tensor(params[f], requires_grad=True) for f in FIELDS}
    tval = fn(core, core.GPMDMParams(**leaves), torch.as_tensor(Y), tcfg, tl)
    tgrads = torch.autograd.grad(tval, list(leaves.values()), allow_unused=True)

    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=VALUE_RTOL)
    for f, g in zip(FIELDS, tgrads):
        want = np.asarray(getattr(jgrad, f))
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(want).max(), err_msg=f)


def test_padded_blocks_sum_to_the_class_loop():
    """The batched form plus its -Nx log|W^2| term is the per-class loop."""
    _, tcfg, _, tl, params, _ = _problem(2, "delta")
    p = core.GPMDMParams(**{f: torch.as_tensor(params[f]) for f in FIELDS})
    idx = {k: torch.as_tensor(v) for k, v in layout.padded_class_indices(tl).items()}
    batched = core.x_nll_padded_blocks(p, tcfg, idx["idx_in"], idx["idx_prev"],
                                       idx["idx_out"], idx["mask"]).sum()
    batched = batched - tl.Nx * 2.0 * p.x_log_lambdas.sum()
    np.testing.assert_allclose(float(batched), float(core.x_neg_log_likelihood(p, tcfg, tl)),
                               rtol=VALUE_RTOL)


@pytest.mark.parametrize("jitter", [0.0, 0.3])
def test_chol_lower_f32_relative_jitter_matches_jax(jitter):
    """f32 factors carry 1e-5 x the mean diagonal on the diagonal, f64 none:
    the jittered f32 factor matches JAX's at f32 round-off (rtol 1e-5) and
    differs from an unjittered one; f64 matches JAX's at rtol 1e-12."""
    rng = np.random.default_rng(3)
    B = rng.normal(size=(12, 12))
    K = B @ B.T + 40.0 * np.eye(12)
    got32 = linalg.chol_lower(torch.as_tensor(K, dtype=torch.float32), jitter).numpy()
    want32 = np.asarray(jlinalg.chol_lower(jnp.asarray(K, dtype=jnp.float32), jitter))
    np.testing.assert_allclose(got32, want32, rtol=1e-5, atol=1e-5)
    floor = 1e-5 * np.mean(np.diag(K))
    np.testing.assert_allclose(got32, np.linalg.cholesky(K + (jitter + floor) * np.eye(12)),
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(got32, np.linalg.cholesky(K + jitter * np.eye(12)), rtol=1e-7,
                           atol=0)
    got64 = linalg.chol_lower(torch.as_tensor(K), jitter).numpy()
    np.testing.assert_allclose(got64, np.asarray(jlinalg.chol_lower(jnp.asarray(K), jitter)),
                               rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_non_positive_definite_factor_is_nan_in_both(dtype):
    """A matrix that is not positive definite factors to NaN on and below
    the diagonal in both packages (zero above it), alone and inside a batch
    (where only its own factor is NaN), and its log-determinant is NaN
    rather than an error."""
    K = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype=dtype)
    want = np.asarray(jlinalg.chol_lower(jnp.asarray(K)))
    got = linalg.chol_lower(torch.as_tensor(K)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[np.tril_indices(3)]).all() and (np.triu(want, 1) == 0).all()
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))
    L = linalg.chol_lower(torch.as_tensor(np.stack([np.eye(3, dtype=dtype), K])))
    assert torch.isfinite(L[0]).all() and torch.isnan(L[1][np.tril_indices(3)]).all()
    assert torch.isnan(linalg.chol_logdet(L[1]))


@pytest.mark.parametrize("batch", [(), (3,)], ids=["one", "batched"])
def test_linalg_helpers_match_jax_f64(batch):
    """chol_solve, chol_inverse, tri_solve (lower and upper) and quad_trace
    on float64 SPD matrices, alone and batched (JAX vmapped), rtol 1e-10."""
    rng = np.random.default_rng(5)
    B = rng.normal(size=batch + (9, 9))
    K = B @ np.swapaxes(B, -1, -2) + 9.0 * np.eye(9)
    R = rng.normal(size=batch + (9, 4))
    w = rng.uniform(0.5, 2.0, size=4)
    L = linalg.chol_lower(torch.as_tensor(K))
    jL = jlinalg.chol_lower(jnp.asarray(K)) if not batch else jax.vmap(jlinalg.chol_lower)(
        jnp.asarray(K))
    jmap = (lambda f: f) if not batch else jax.vmap
    pairs = [
        (linalg.chol_solve(L, torch.as_tensor(R)), jmap(jlinalg.chol_solve)(jL, jnp.asarray(R))),
        (linalg.chol_inverse(L), jmap(jlinalg.chol_inverse)(jL)),
        (linalg.tri_solve(L, torch.as_tensor(R)), jmap(jlinalg.tri_solve)(jL, jnp.asarray(R))),
        (linalg.tri_solve(L.mT, torch.as_tensor(R), lower=False),
         jmap(lambda a, b: jlinalg.tri_solve(a.T, b, lower=False))(jL, jnp.asarray(R))),
        (linalg.quad_trace(L, torch.as_tensor(R), torch.as_tensor(w)),
         jmap(lambda a, b: jlinalg.quad_trace(a, b, jnp.asarray(w)))(jL, jnp.asarray(R))),
        (linalg.chol_logdet(L), jmap(jlinalg.chol_logdet)(jL)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-13)
