"""Deploy-time low-rank compression of the exact GP posterior's quad term.

Counterpart of ``gpmdm_tpu/models/compressed.py``.  Every trained Gram
here is ``K = K_smooth + s I`` with ``K_smooth`` PSD and numerically low
rank.  Eigendecomposed once on the host in float64,
``K = U diag(mu) U^T`` with ``mu_i >= s``, and truncated to its top q
pairs, the predictive variance's quad becomes

    quad(k) ~= sum_{i<=q} (u_i^T k)^2 / mu_i  +  ||k - U_q U_q^T k||^2 / s

two O(N q P) products in place of one O(N^2 P).  The residual is a
VECTOR, ``k`` minus its top-q reconstruction, squared and summed.  The
algebraically equal scalar form ``||k||^2/s - ||U_q^T k||^2 ...`` is a
catastrophic cancellation: the linear dynamics kernel makes ``||k||^2/s``
orders of magnitude larger than the quad, and its fp32 rounding swamps
the result (the JAX package measured a rank-independent 0.927 frame
accuracy against 0.958 exact on the headline asset before it moved to
this form).  Truncation over-estimates the quad by
``sum_{i>q} (1/s - 1/mu_i) (u_i^T k)^2 >= 0``: the variance comes out a
little low, and the accuracy guard decides whether a rank is usable.
The predictive MEAN stays exact (O(N D P)).

The JAX package computes these predictions in XLA, outside any Pallas
kernel, so the port computes them with ``torch.matmul`` and elementwise
PyTorch: on the card every product is a cuBLAS fp32 call (TF32 is never
enabled), so the JAX package's precision choices and its fused/unfused
gate (MXU passes) have no counterpart here: the mean and the eigenbasis
projection always come from one product of ``[A^T; U^T]`` by the star
kernel.

Usage: ``GPMDM.compressed_posterior(rank_y=..., rank_x=...)``, or
``GPMDM_PF(..., posterior='compressed')``; the filter dispatches on the
posterior's type.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import GPMDMConfig
from ..ops import kernels as K
from ..ops import kernels_host as KH
from ..ops.layout import DataLayout
from .core import host_f64, tensor_from_numpy


@dataclasses.dataclass
class CompressedPosterior:
    """Exact-mean, low-rank-variance GP posterior; the fields of the JAX
    package's, in its order (the checkpoint's ``comp_<j>_<field>``).
    ``inv_s2y`` and ``inv_s2x`` are 0-d: 1/s, the inverse total diagonal
    shift.  Per-class arrays and eigen slots are zero-padded."""

    X: torch.Tensor  # (Ny, d) latent matrix snapshot
    Ay: torch.Tensor  # (Ny, D) observation predictive weights (exact mean)
    Uy: torch.Tensor  # (Ny, qy) the observation Gram's top eigenvectors
    inv_mu_y: torch.Tensor  # (qy,) their inverse eigenvalues
    inv_s2y: torch.Tensor  # () 1 / (sigma_n^2 + sigma_num^2)
    Xin_c: torch.Tensor  # (C, n_max, din) per-class dynamics inputs
    mask_c: torch.Tensor  # (C, n_max) 1.0 valid / 0.0 pad
    Axc: torch.Tensor  # (C, n_max, d) per-class dynamics weights (exact mean)
    Uxc: torch.Tensor  # (C, n_max, qx) per-class top eigenvectors
    inv_mu_xc: torch.Tensor  # (C, qx) inverse eigenvalues
    inv_s2x: torch.Tensor  # () 1 / (x noise + x sigma_num^2 + class_jitter)

    @property
    def rank_y(self) -> int:
        return self.Uy.shape[1]

    @property
    def rank_x(self) -> int:
        return self.Uxc.shape[2]

    @classmethod
    def from_numpy(cls, arrays: dict, dtype: torch.dtype, device) -> "CompressedPosterior":
        """From numpy arrays keyed by field name, each a C-contiguous
        tensor in ``dtype`` on ``device`` (0-d fields stay 0-d)."""
        return cls(**{f.name: tensor_from_numpy(arrays[f.name], dtype, device)
                      for f in dataclasses.fields(cls)})

    def to(self, device) -> "CompressedPosterior":
        return type(self)(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


def _quad_factor(Kmat: np.ndarray, shift: float, rank, tol: float):
    """Top-q eigenpairs ``(U_q (N, q), 1/mu_q (q,), q)`` of the shifted
    Gram ``Kmat`` (float64, shift included): the pairs with
    ``(mu_i - s) / mu_i > tol``, or exactly ``rank`` of them, largest
    first; at least one."""
    N = Kmat.shape[0]
    mu, U = np.linalg.eigh(Kmat)  # ascending
    mu = mu[::-1]
    U = U[:, ::-1]
    d = np.clip((mu - shift) / np.maximum(mu, 1e-300), 0.0, 1.0)
    q = int(np.sum(d > tol)) if rank is None else min(int(rank), N)
    q = max(q, 1)
    # eigh's rounding can put mu_i a little below the shift; 1/mu > 1/s
    # would over-weight a discarded direction
    inv_mu = 1.0 / np.maximum(mu[:q], shift)
    return U[:, :q], inv_mu, q


def compress_host(params, Y: np.ndarray, cfg: GPMDMConfig, layout: DataLayout,
                  rank_y: int | None = None, rank_x: int | None = None, tol: float = 1e-6,
                  device="cuda") -> CompressedPosterior:
    """A :class:`CompressedPosterior` built on the host in float64 and cast
    to the model dtype on ``device``.  ``params`` is a ``GPMDMParams`` or a
    dict of numpy arrays keyed by field name.  ``rank_y`` / ``rank_x`` pin
    the kept ranks; otherwise ``tol`` cuts the spectrum at
    ``(mu_i - s) / mu_i``.  Costs two eigendecompositions, O(N^3)."""
    def f64(name):
        return host_f64(params, name)

    X = f64("X")
    Y64 = KH.f64(Y)
    y_ls = np.exp(f64("y_log_lengthscales"))
    s_y = float(np.exp(f64("y_log_sigma_n"))) ** 2 + cfg.sigma_n_num_Y**2
    x_ls = np.exp(f64("x_log_lengthscales"))
    s_x = (float(np.exp(f64("x_log_sigma_n"))) ** 2 + cfg.sigma_n_num_X**2
           + cfg.class_jitter)
    x_lw = np.exp(f64("x_log_lin_coeff")) ** 2

    Ky = KH.rbf(X, X, y_ls) + s_y * np.eye(X.shape[0])
    Ay = np.linalg.solve(Ky, Y64)
    Uy, inv_mu_y, _ = _quad_factor(Ky, s_y, rank_y, tol)

    x_t = X[layout.xin_idx]
    Xin = x_t if layout.back_step == 1 else np.concatenate(
        [x_t, X[layout.xin_prev_idx]], axis=1)
    Xout = X[layout.xout_idx]
    if cfg.dyn_target == "delta":
        Xout = Xout - x_t

    C, n_max = layout.n_classes, layout.n_max
    Xin_c = np.zeros((C, n_max, Xin.shape[1]))
    Axc = np.zeros((C, n_max, cfg.d))
    blocks = []
    for c in range(C):
        lo, hi = int(layout.x_class_offsets[c]), int(layout.x_class_offsets[c + 1])
        n_c = hi - lo
        blk = Xin[lo:hi]
        Kc = KH.x_kernel(blk, blk, x_ls, x_lw) + s_x * np.eye(n_c)
        Axc[c, :n_c] = np.linalg.solve(Kc, Xout[lo:hi])
        Xin_c[c, :n_c] = blk
        blocks.append(_quad_factor(Kc, s_x, rank_x, tol))
    # zero-padded eigen slots are discarded directions: nothing in the
    # top-q term, everything through the 1/s residual
    q_max = max(q for _, _, q in blocks)
    Uxc = np.zeros((C, n_max, q_max))
    inv_mu_xc = np.zeros((C, q_max))
    for c, (Uc, imu_c, q) in enumerate(blocks):
        Uxc[c, :Uc.shape[0], :q] = Uc
        inv_mu_xc[c, :q] = imu_c

    return CompressedPosterior.from_numpy(dict(
        X=X, Ay=Ay, Uy=Uy, inv_mu_y=inv_mu_y, inv_s2y=np.float64(1.0 / s_y), Xin_c=Xin_c,
        mask_c=layout.class_pair_mask, Axc=Axc, Uxc=Uxc, inv_mu_xc=inv_mu_xc,
        inv_s2x=np.float64(1.0 / s_x)), cfg.torch_dtype, device)


def predict_y(post: CompressedPosterior, params, Xstar: torch.Tensor, cfg: GPMDMConfig,
              with_noise: bool = False):
    """Latent -> observation posterior with the compressed quad: mean
    (N*, D), exact, and per-dimension variance (N*, D), the common
    variance clamped at 1e-9 before the lambda scaling.  One product of
    ``[Ay^T; Uy^T]`` by the star kernel gives the mean and the eigenbasis
    projection."""
    Kstar = K.rbf_kernel(post.X, Xstar, params.y_log_lengthscales)  # (Ny, N*)
    D = post.Ay.shape[1]
    out = torch.cat([post.Ay.T, post.Uy.T], dim=0) @ Kstar  # (D + qy, N*)
    # a copy, so the returned mean does not keep the projection alive
    mean, UK = out[:D].T.contiguous(), out[D:]
    # the residual k - U (U^T k), a vector per point (module docstring),
    # in Kstar's own storage: Kstar is not read again
    resid = Kstar.addmm_(post.Uy, UK, alpha=-1.0)
    quad = (torch.sum(post.inv_mu_y[:, None] * UK * UK, dim=0)
            + post.inv_s2y * torch.sum(resid.square_(), dim=0))
    diag_common = K.y_diag_kernel(Xstar, params.y_log_sigma_n, cfg.sigma_n_num_Y,
                                  with_noise) - quad
    diag_common = torch.clamp(diag_common, min=1e-9)
    var = diag_common[:, None] * torch.exp(params.y_log_lambdas)[None, :] ** -2
    return mean, var


def predict_x_all_classes(post: CompressedPosterior, params, Xstar: torch.Tensor,
                          cfg: GPMDMConfig, with_noise: bool = False):
    """Per-class dynamics posterior for every class with compressed quads:
    means and variances (C, N*, d); padded rows and eigen slots are zero
    and drop out of both terms.  One batched product per class stack, as
    in :func:`predict_y`."""
    kst = K.x_kernel(post.Xin_c, Xstar, params.x_log_lengthscales, params.x_log_sigma_n,
                     params.x_log_lin_coeff, with_noise=False)  # (C, n_max, N*)
    kst.mul_(post.mask_c[:, :, None])
    d = post.Axc.shape[2]
    lhs = torch.cat([post.Axc.mT, post.Uxc.mT], dim=1)  # (C, d + qx, n_max)
    out = torch.bmm(lhs, kst)
    mean, UK = out[:, :d].mT.contiguous(), out[:, d:]  # see predict_y
    resid = kst.baddbmm_(post.Uxc, UK, alpha=-1.0)
    quad = (torch.sum(post.inv_mu_xc[:, :, None] * UK * UK, dim=1)
            + post.inv_s2x * torch.sum(resid.square_(), dim=1))
    diag_star = K.x_diag_kernel(Xstar, params.x_log_lin_coeff, params.x_log_sigma_n,
                                cfg.sigma_n_num_X, with_noise)  # (N*,)
    diag_common = torch.clamp(diag_star[None, :] - quad, min=1e-9)  # (C, N*)
    var = diag_common[:, :, None] * torch.exp(params.x_log_lambdas)[None, None, :] ** -2
    return mean, var
