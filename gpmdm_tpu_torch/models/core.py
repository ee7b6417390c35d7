"""GPMDM core: parameters, exact posterior precompute and prediction.

Counterpart of the inference half of ``gpmdm_tpu/models/core.py``.
Parameters live in log space, as in the reference; the latent matrix X is
(Ny, d).  The posterior is factored once on the host in float64 numpy
(``precompute_host``: trained Gram matrices sit near the fp32 Cholesky
cliff) and deployed in the model dtype on the device — factor high, deploy
low.  Per-class dynamics quantities are zero-padded to ``n_max`` rows and
stacked on a leading class axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import GPMDMConfig
from ..ops import kernels as K
from ..ops import kernels_host as KH
from ..ops.layout import DataLayout

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
        # C order: a checkpoint may store arrays in Fortran order
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                               device=device).to(cfg.torch_dtype)

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
