"""GPMDM core: parameters, the MAP loss, exact posterior precompute and
prediction.

Counterpart of ``gpmdm_tpu/models/core.py``.  Parameters live in log
space, as in the reference; the latent matrix X is (Ny, d).

- The MAP loss (:func:`nll`) is L_y + balance * L_x (+ an optional
  log-hyperprior).  The class-block-masked dynamics Gram is block diagonal
  in the class-major layout, so it is factored one dense class block at a
  time, with the linear kernel term deflated out of each factorization by
  default (:func:`x_block_terms_deflated`).  Every term is differentiable
  by ``torch.autograd``.
- The posterior is factored once on the host in float64 numpy
  (``precompute_host``: trained Gram matrices sit near the fp32 Cholesky
  cliff) and deployed in the model dtype on the device — factor high,
  deploy low.  Per-class dynamics quantities are zero-padded to ``n_max``
  rows and stacked on a leading class axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import GPMDMConfig
from ..ops import kernels as K
from ..ops import kernels_host as KH
from ..ops import linalg as LA
from ..ops.layout import DataLayout, xin_xout

PARAM_FIELDS = (
    "y_log_lengthscales",
    "y_log_lambdas",
    "y_log_sigma_n",
    "x_log_lengthscales",
    "x_log_lambdas",
    "x_log_sigma_n",
    "x_log_lin_coeff",
    "X",
)


def tensor_from_numpy(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A C-contiguous copy of the array ``a`` on ``device`` in ``dtype``,
    0-d kept: a checkpoint may store arrays in Fortran order, which
    ``torch.tensor`` would keep, and the CUDA kernels take C order only."""
    return torch.tensor(np.asarray(a), device=device).to(dtype).contiguous()


@dataclasses.dataclass
class GPMDMParams:
    """Trained state: log-space hyperparameters and the (Ny, d) latent matrix."""

    y_log_lengthscales: torch.Tensor  # (d,)
    y_log_lambdas: torch.Tensor  # (D,)
    y_log_sigma_n: torch.Tensor  # ()
    x_log_lengthscales: torch.Tensor  # (d * back_step,)
    x_log_lambdas: torch.Tensor  # (d,)
    x_log_sigma_n: torch.Tensor  # ()
    x_log_lin_coeff: torch.Tensor  # (d * back_step + 1,)
    X: torch.Tensor  # (Ny, d)


@dataclasses.dataclass
class Posterior:
    """Precomputed exact-GP posterior; per-class arrays zero-padded to n_max."""

    X: torch.Tensor  # (Ny, d) latent matrix snapshot
    Y: torch.Tensor  # (Ny, D) observation matrix
    Ky_inv: torch.Tensor  # (Ny, Ny)
    Ay: torch.Tensor  # (Ny, D) = Ky_inv @ Y
    Xin: torch.Tensor  # (Nx, din) dynamics inputs
    Xout: torch.Tensor  # (Nx, d) dynamics outputs
    Kx_inv: torch.Tensor  # (Nx, Nx) block-diagonal inverse of K_x * M
    Ax: torch.Tensor  # (Nx, d) = Kx_inv @ Xout
    Xin_c: torch.Tensor  # (C, n_max, din) per-class dynamics inputs
    mask_c: torch.Tensor  # (C, n_max) 1.0 valid / 0.0 pad
    Kxc_inv: torch.Tensor  # (C, n_max, n_max) per-class (K_c + jitter I)^-1
    Axc: torch.Tensor  # (C, n_max, d) = Kxc_inv @ Xout_c


def init_params(cfg: GPMDMConfig, y_lengthscales_init, y_lambdas_init, y_sigma_n_init,
                x_lengthscales_init, x_lambdas_init, x_sigma_n_init, x_lin_coeff_init,
                X0=None, device="cuda") -> GPMDMParams:
    """Params from *linear-space* initial hyperparameters (the reference
    constructor takes linear values and stores logs), cast to the model
    dtype before the log as the JAX package does."""
    dt = cfg.torch_dtype

    def log_of(v, shape):
        arr = torch.as_tensor(np.asarray(v, dtype=np.float64), device=device).to(dt)
        return torch.log(torch.broadcast_to(arr, shape))

    d, D, bs = cfg.d, cfg.D, cfg.dyn_back_step
    if X0 is None:
        X0 = np.zeros((0, d))
    return GPMDMParams(
        y_log_lengthscales=log_of(y_lengthscales_init, (d,)),
        y_log_lambdas=log_of(y_lambdas_init, (D,)),
        y_log_sigma_n=log_of(y_sigma_n_init, ()),
        x_log_lengthscales=log_of(x_lengthscales_init, (d * bs,)),
        x_log_lambdas=log_of(x_lambdas_init, (d,)),
        x_log_sigma_n=log_of(x_sigma_n_init, ()),
        x_log_lin_coeff=log_of(x_lin_coeff_init, (d * bs + 1,)),
        X=torch.as_tensor(np.ascontiguousarray(X0), device=device).to(dt),
    )


def pca_init_x(Y: np.ndarray, d: int) -> np.ndarray:
    """PCA latent initialization matching sklearn's ``PCA.fit_transform``:
    center, SVD, deterministic sign flip (per component, the max-|v| entry
    of the right singular vector is made positive), project."""
    Y = np.asarray(Y, dtype=np.float64)
    Yc = Y - Y.mean(axis=0, keepdims=True)
    U, S, Vt = np.linalg.svd(Yc, full_matrices=False)
    max_cols = np.argmax(np.abs(Vt), axis=1)
    signs = np.sign(Vt[np.arange(Vt.shape[0]), max_cols])
    signs[signs == 0] = 1.0
    U = U * signs
    return (U[:, :d] * S[:d]).astype(Y.dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def y_neg_log_likelihood(params: GPMDMParams, Y: torch.Tensor, cfg: GPMDMConfig) -> torch.Tensor:
    """Observation-map NLL ``L_y = D/2 log|K_y| + 1/2 trace(K_y^-1 Y W^2 Y^T)
    - N log|W^2|`` with W = diag(exp(y_log_lambdas))."""
    N = Y.shape[0]
    Ky = K.y_kernel(params.X, params.X, params.y_log_lengthscales, params.y_log_sigma_n,
                    cfg.sigma_n_num_Y, with_noise=True)
    L = LA.chol_lower(Ky)
    w2 = torch.exp(params.y_log_lambdas) ** 2
    log_det_W = 2.0 * torch.sum(params.y_log_lambdas)
    return cfg.D / 2.0 * LA.chol_logdet(L) + 0.5 * LA.quad_trace(L, Y, w2) - N * log_det_W


def x_block_terms_deflated(Xin_b, Xout_b, mask, x_log_lengthscales, x_log_sigma_n,
                           x_log_lin_coeff, w2, sigma_n_num: float = 0.0):
    """(logdet, quad) of dynamics class blocks with the LINEAR kernel term
    deflated out of the Cholesky.

    The dynamics Gram is ``K = K0 + V V^T`` with ``K0 = RBF + noise I`` and
    ``V = [Xin, 1] diag(exp(x_log_lin_coeff))``, the rank-(din+1) linear
    factor whose growth drives a trained block's condition to the f32
    cliff.  Only K0 is factored; the low-rank term is folded in exactly:

      ``logdet K = logdet K0 + logdet(I + V^T K0^-1 V)``   (det lemma)
      ``quad_j  = ||L0^-1 y_j||^2 - ||Lc^-1 A^T (L0^-1 y_j)||^2``
      with ``A = L0^-1 V``, ``Lc = chol(I + A^T A)``       (Woodbury)

    ``Xin_b`` (..., n, din) and ``Xout_b`` (..., n, dout) may carry a
    leading class axis.  ``mask`` (..., n) marks valid rows (1.0) against
    zero-padding; padded rows get identity K0 rows (logdet contribution 0)
    and zeroed V rows.
    """
    K0 = K.rbf_kernel(Xin_b, Xin_b, x_log_lengthscales, x_log_sigma_n, sigma_n_num,
                      with_noise=True)
    ones = torch.ones(Xin_b.shape[:-1] + (1,), dtype=Xin_b.dtype, device=Xin_b.device)
    V = torch.cat([Xin_b, ones], dim=-1) * torch.exp(x_log_lin_coeff)
    if mask is not None:
        K0 = K0 * (mask[..., :, None] * mask[..., None, :]) + torch.diag_embed(1.0 - mask)
        V = V * mask[..., :, None]
    L0 = LA.chol_lower(K0)
    A = LA.tri_solve(L0, V)  # (..., n, r)
    B = LA.tri_solve(L0, Xout_b)  # (..., n, dout)
    r = V.shape[-1]
    Cap = torch.eye(r, dtype=K0.dtype, device=K0.device) + A.mT @ A
    Lc = LA.cholesky(Cap)  # r x r, diag >= 1: no jitter needed
    G = LA.tri_solve(Lc, A.mT @ B)
    logdet = LA.chol_logdet(L0) + LA.chol_logdet(Lc)
    quad = torch.sum((torch.sum(B * B, dim=-2) - torch.sum(G * G, dim=-2)) * w2, dim=-1)
    return logdet, quad


def x_neg_log_likelihood(params: GPMDMParams, cfg: GPMDMConfig, layout: DataLayout) -> torch.Tensor:
    """Dynamics-map NLL ``L_x = d/2 log|K_x * M| + 1/2 trace((K_x * M)^-1
    Xout W^2 Xout^T) - Nx log|W^2|`` over the dense class blocks of the
    block-diagonal ``K_x * M``, one class at a time.  Each block's linear
    term is deflated out of the factorization unless
    ``cfg.deflate_x_linear`` is False (the direct Cholesky of the block)."""
    Xin, Xout = xin_xout(params.X, layout, cfg.dyn_target)
    w2 = torch.exp(params.x_log_lambdas) ** 2
    total_logdet = 0.0
    total_trace = 0.0
    for c in range(layout.n_classes):
        lo, hi = int(layout.x_class_offsets[c]), int(layout.x_class_offsets[c + 1])
        Xin_c, Xout_c = Xin[lo:hi], Xout[lo:hi]
        if cfg.deflate_x_linear:
            ld, tr = x_block_terms_deflated(
                Xin_c, Xout_c, None, params.x_log_lengthscales, params.x_log_sigma_n,
                params.x_log_lin_coeff, w2, cfg.sigma_n_num_X)
        else:
            Kc = K.x_kernel(Xin_c, Xin_c, params.x_log_lengthscales, params.x_log_sigma_n,
                            params.x_log_lin_coeff, cfg.sigma_n_num_X, with_noise=True)
            Lc = LA.chol_lower(Kc)
            ld, tr = LA.chol_logdet(Lc), LA.quad_trace(Lc, Xout_c, w2)
        total_logdet = total_logdet + ld
        total_trace = total_trace + tr
    log_det_W = 2.0 * torch.sum(params.x_log_lambdas)
    return cfg.d / 2.0 * total_logdet + 0.5 * total_trace - layout.Nx * log_det_W


def x_nll_padded_blocks(params: GPMDMParams, cfg: GPMDMConfig, idx_in, idx_prev, idx_out,
                        mask) -> torch.Tensor:
    """Per-class dynamics NLL terms from zero-padded class blocks, all
    classes in one batched factorization (the batched form of
    :func:`x_neg_log_likelihood`'s loop).

    ``idx_*``: (C, n_max) integer gathers into the Ny axis (x(t), x(t-1),
    x(t+1) of each class's dynamics pairs, 0-padded); ``mask``: (C, n_max)
    1/0 validity.  Padding is exact: padded Gram entries become identity
    rows and columns and padded targets are zero.

    Returns the (C,) vector of ``d/2 log|K_c| + 1/2 trace(K_c^-1 Xout_c
    W^2 Xout_c^T)``; the caller adds the ``- Nx log|W^2|`` term.
    """
    X = params.X
    m3 = mask[:, :, None]
    x_t = X[idx_in] * m3  # (C, n_max, d)
    Xin_c = x_t if cfg.dyn_back_step == 1 else torch.cat([x_t, X[idx_prev] * m3], dim=2)
    Xout_c = X[idx_out] * m3
    if cfg.dyn_target == "delta":
        Xout_c = Xout_c - x_t
    w2 = torch.exp(params.x_log_lambdas) ** 2
    if cfg.deflate_x_linear:
        logdets, traces = x_block_terms_deflated(
            Xin_c, Xout_c, mask, params.x_log_lengthscales, params.x_log_sigma_n,
            params.x_log_lin_coeff, w2, cfg.sigma_n_num_X)
    else:
        Kb = K.x_kernel(Xin_c, Xin_c, params.x_log_lengthscales, params.x_log_sigma_n,
                        params.x_log_lin_coeff, cfg.sigma_n_num_X, with_noise=True)
        Kb = Kb * (mask[:, :, None] * mask[:, None, :]) + torch.diag_embed(1.0 - mask)
        Lb = LA.chol_lower(Kb)
        logdets, traces = LA.chol_logdet(Lb), LA.quad_trace(Lb, Xout_c, w2)
    return cfg.d / 2.0 * logdets + 0.5 * traces


def hyperprior_penalty(params, cfg: GPMDMConfig):
    """Gaussian log-hyperprior ``w * sum((log_h - center)^2)`` over the seven
    log-hyperparameter groups, centered at the constructor's init values;
    X is not penalized.  A plain 0.0 at the default config (weight 0), so
    the loss is then exactly the reference MAP objective.
    ``cfg.hyperprior_weights`` (one weight per group) overrides the
    uniform weight."""
    ws = cfg.hyperprior_weights
    if ws is None:
        w = cfg.hyperprior_weight
        if w == 0.0:
            return 0.0
        ws = (w,) * 7
    elif all(v == 0.0 for v in ws):
        return 0.0
    c = cfg.hyperprior_centers or cfg._HYPERPRIOR_DEFAULT_CENTERS
    groups = (
        (params.y_log_lengthscales, c[0], ws[0]),
        (params.y_log_lambdas, c[1], ws[1]),
        (params.y_log_sigma_n, c[2], ws[2]),
        (params.x_log_lengthscales, c[3], ws[3]),
        (params.x_log_lambdas, c[4], ws[4]),
        (params.x_log_sigma_n, c[5], ws[5]),
        (params.x_log_lin_coeff, c[6], ws[6]),
    )
    return sum(wi * torch.sum((g - ci) ** 2) for g, ci, wi in groups if wi)


def nll(params: GPMDMParams, Y: torch.Tensor, cfg: GPMDMConfig, layout: DataLayout,
        balance: float = 1.0) -> torch.Tensor:
    """Total MAP loss L = L_y + balance * L_x + the optional log-hyperprior.
    With ``cfg.balance_fix=False`` balance is 1, the reference's behavior
    (its ``train_adam`` binds balance to an unused argument)."""
    b = balance if cfg.balance_fix else 1.0
    return (y_neg_log_likelihood(params, Y, cfg)
            + b * x_neg_log_likelihood(params, cfg, layout)
            + hyperprior_penalty(params, cfg))


# ---------------------------------------------------------------------------
# Posterior precompute + prediction
# ---------------------------------------------------------------------------


def precompute_host(params, Y: np.ndarray, cfg: GPMDMConfig,
                    layout: DataLayout, device="cuda") -> Posterior:
    """Exact posterior factored on the host in float64, cast to the model
    dtype on ``device``.  ``params`` is a ``GPMDMParams`` or a dict of
    numpy arrays keyed by field name (a checkpoint's float64 originals);
    either is widened to float64 first."""
    def f64(name):
        v = params[name] if isinstance(params, dict) else getattr(params, name)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return KH.f64(v)

    X = f64("X")
    Y64 = KH.f64(Y)
    y_ls = np.exp(f64("y_log_lengthscales"))
    y_sn2 = float(np.exp(f64("y_log_sigma_n"))) ** 2 + cfg.sigma_n_num_Y**2
    x_ls = np.exp(f64("x_log_lengthscales"))
    x_sn2 = float(np.exp(f64("x_log_sigma_n"))) ** 2 + cfg.sigma_n_num_X**2
    x_lw = np.exp(f64("x_log_lin_coeff")) ** 2

    Ky = KH.rbf(X, X, y_ls) + y_sn2 * np.eye(X.shape[0])
    Ky_inv = np.linalg.inv(Ky)
    Ay = np.linalg.solve(Ky, Y64)

    x_t = X[layout.xin_idx]
    Xin = x_t if layout.back_step == 1 else np.concatenate(
        [x_t, X[layout.xin_prev_idx]], axis=1
    )
    Xout = X[layout.xout_idx]
    if cfg.dyn_target == "delta":
        Xout = Xout - x_t

    C, n_max = layout.n_classes, layout.n_max
    din = Xin.shape[1]
    Xin_c = np.zeros((C, n_max, din))
    Kxc_inv = np.zeros((C, n_max, n_max))
    Axc = np.zeros((C, n_max, cfg.d))
    Kx_inv = np.zeros((layout.Nx, layout.Nx))
    for c in range(C):
        lo, hi = int(layout.x_class_offsets[c]), int(layout.x_class_offsets[c + 1])
        n_c = hi - lo
        blk = Xin[lo:hi]
        Kc = KH.x_kernel(blk, blk, x_ls, x_lw) + x_sn2 * np.eye(n_c)
        Kx_inv[lo:hi, lo:hi] = np.linalg.inv(Kc)
        Kcj = Kc + cfg.class_jitter * np.eye(n_c)
        Kxc_inv[c, :n_c, :n_c] = np.linalg.inv(Kcj)
        Xin_c[c, :n_c] = blk
        Axc[c, :n_c] = np.linalg.solve(Kcj, Xout[lo:hi])
    Ax = Kx_inv @ Xout

    def cast(a):
        return tensor_from_numpy(np.asarray(a, dtype=np.float64), cfg.torch_dtype, device)

    return Posterior(
        X=cast(X), Y=cast(Y64), Ky_inv=cast(Ky_inv), Ay=cast(Ay), Xin=cast(Xin),
        Xout=cast(Xout), Kx_inv=cast(Kx_inv), Ax=cast(Ax), Xin_c=cast(Xin_c),
        mask_c=cast(layout.class_pair_mask), Kxc_inv=cast(Kxc_inv), Axc=cast(Axc),
    )


def predict_y(post: Posterior, params: GPMDMParams, Xstar: torch.Tensor,
              cfg: GPMDMConfig, with_noise: bool = False):
    """Latent -> observation GP posterior (reference map_x_to_y): mean
    (N*, D) and per-dimension variance (N*, D), the common variance scaled
    by exp(y_log_lambdas)^-2 and clamped at 1e-9."""
    Kstar = K.rbf_kernel(post.X, Xstar, params.y_log_lengthscales)  # (Ny, N*)
    mean = Kstar.T @ post.Ay
    KiK = post.Ky_inv @ Kstar
    diag_common = K.y_diag_kernel(
        Xstar, params.y_log_sigma_n, cfg.sigma_n_num_Y, with_noise
    ) - torch.sum(Kstar * KiK, dim=0)
    # the subtraction can go slightly negative in fp32 near training points
    diag_common = torch.clamp(diag_common, min=1e-9)
    var = diag_common[:, None] * torch.exp(params.y_log_lambdas)[None, :] ** -2
    return mean, var


def predict_x_all_classes(post: Posterior, params: GPMDMParams, Xstar: torch.Tensor,
                          cfg: GPMDMConfig, with_noise: bool = False):
    """Per-class dynamics GP posterior for every class at once: means and
    variances (C, N*, d); padded training rows are masked out of the star
    kernel and the common variance is clamped at 1e-9."""
    kst = torch.stack([
        K.x_kernel(Xin_blk, Xstar, params.x_log_lengthscales,
                   params.x_log_sigma_n, params.x_log_lin_coeff, with_noise=False)
        for Xin_blk in post.Xin_c
    ])  # (C, n_max, N*)
    kst = kst * post.mask_c[:, :, None]
    mean = torch.einsum("cnp,cnd->cpd", kst, post.Axc)
    KiK = torch.einsum("cnm,cmp->cnp", post.Kxc_inv, kst)
    diag_star = K.x_diag_kernel(
        Xstar, params.x_log_lin_coeff, params.x_log_sigma_n, cfg.sigma_n_num_X, with_noise
    )
    diag_common = torch.clamp(diag_star[None, :] - torch.sum(kst * KiK, dim=1), min=1e-9)
    var = diag_common[:, :, None] * torch.exp(params.x_log_lambdas)[None, None, :] ** -2
    return mean, var


def predict_x(post: Posterior, params: GPMDMParams, Xstar: torch.Tensor, cfg: GPMDMConfig,
              with_noise: bool = False):
    """All-class dynamics GP posterior on the block-diagonal inverse
    (reference map_x_dynamics): mean and variance (N*, d)."""
    Kstar = K.x_kernel(post.Xin, Xstar, params.x_log_lengthscales, params.x_log_sigma_n,
                       params.x_log_lin_coeff, with_noise=False)  # (Nx, N*)
    mean = Kstar.T @ post.Ax
    KiK = post.Kx_inv @ Kstar
    diag_common = torch.clamp(
        K.x_diag_kernel(Xstar, params.x_log_lin_coeff, params.x_log_sigma_n,
                        cfg.sigma_n_num_X, with_noise) - torch.sum(Kstar * KiK, dim=0),
        min=1e-9)
    var = diag_common[:, None] * torch.exp(params.x_log_lambdas)[None, :] ** -2
    return mean, var


def predict_x_for_class(post: Posterior, params: GPMDMParams, Xstar: torch.Tensor,
                        class_index: int, cfg: GPMDMConfig, with_noise: bool = False):
    """Single-class dynamics posterior (reference map_x_dynamics_for_class)."""
    mean, var = predict_x_all_classes(post, params, Xstar, cfg, with_noise)
    return mean[class_index], var[class_index]


def next_x(mean: torch.Tensor, var: torch.Tensor, Xold: torch.Tensor, cfg: GPMDMConfig,
           sample: bool = False, generator: torch.Generator | None = None,
           noise: torch.Tensor | None = None) -> torch.Tensor:
    """A dynamics-GP output turned into the next latent state (reference
    get_next_x): 'full' returns the prediction, 'delta' adds it to the
    current state.  ``sample`` draws from the Gaussian with standard normal
    ``noise`` when given (the JAX package's own draws, for parity), else
    from ``generator``."""
    out = mean
    if sample:
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                                device=mean.device)
        out = mean + torch.sqrt(var) * noise
    if cfg.dyn_target == "delta":
        out = Xold + out
    return out


def rollout(post: Posterior, params: GPMDMParams, x0: torch.Tensor, n_steps: int,
            class_index: int, cfg: GPMDMConfig, sample: bool = False,
            generator: torch.Generator | None = None,
            noise: torch.Tensor | None = None) -> torch.Tensor:
    """Autoregressive latent rollout under one class's dynamics.

    x0: (d,) (back_step=1) or (2, d) [x(t), x(t-1)] (back_step=2);
    ``noise`` (n_steps, d), when given, holds the standard normal draws of
    each step.  Returns the (n_steps, d) trajectory of x(t+1..t+n_steps).
    """
    x_t, x_tm1 = (x0, None) if cfg.dyn_back_step == 1 else (x0[0], x0[1])
    traj = []
    for i in range(n_steps):
        xin = x_t if cfg.dyn_back_step == 1 else torch.cat([x_t, x_tm1])
        mean, var = predict_x_for_class(post, params, xin[None, :], class_index, cfg)
        xn = next_x(mean[0], var[0], x_t, cfg, sample, generator,
                    None if noise is None else noise[i])
        x_t, x_tm1 = xn, x_t
        traj.append(xn)
    return torch.stack(traj)


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------


def latent_map_nmse(post: Posterior, params: GPMDMParams, cfg: GPMDMConfig, Xstar, Y_true,
                    with_noise: bool = False, floored: bool = False) -> torch.Tensor:
    """Mean squared z-score of the latent -> observation map (reference
    get_latent_map_performance); ``floored=True`` reproduces the
    reference's floor division, the default divides."""
    mean, var = predict_y(post, params, Xstar, cfg, with_noise)
    z2 = (Y_true - mean) ** 2 / var
    if floored:
        z2 = torch.floor(z2)
    return torch.mean(z2)


def dynamics_map_nmse_for_class(post: Posterior, params: GPMDMParams, cfg: GPMDMConfig,
                                class_index: int, with_noise: bool = False,
                                floored: bool = False) -> torch.Tensor:
    """Mean squared z-score of one class's dynamics map on the training
    pairs (reference get_dynamics_map_performance_for_class)."""
    mean, var = predict_x_for_class(post, params, post.Xin, class_index, cfg, with_noise)
    z2 = (post.Xout - mean) ** 2 / var
    if floored:
        z2 = torch.floor(z2)
    return torch.mean(z2)
