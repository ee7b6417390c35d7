"""Sparse (inducing-point) GPMDM posteriors: the SGPR predictions, their
float64 host precompute, and the post-hoc distillation of an exact model.

Counterpart of the serving half of ``gpmdm_tpu/models/sparse.py``.  Both
GPMDM maps are sparse GPs (Titsias 2009 VFE / SGPR): the observation map
one GP over M_y inducing inputs in latent space, the dynamics map one GP
per class over M_x inducing inputs each.  With

    Kmm = k(Z,Z) + jitter,  Lm = chol(Kmm),  A = Lm^-1 k(Z,X) / sigma,
    B = I + A A^T,  LB = chol(B),  c = LB^-1 A Y,
    beta = sigma^-2 Lm^-T LB^-T c,

the predictive mean at x* is k*m beta and the common variance
k** - |Lm^-1 km*|^2 + |LB^-1 Lm^-1 km*|^2, scaled by the per-dimension
output scales exp(log_lambdas)^-2: the (mean, per-dimension variance)
contract of the exact posterior, so the filter runs on either.  A frame's
star kernel is (M, P) instead of (Ny, P).

The variance takes one of two paths (``quad_precision``): per-frame
triangular solves against Lm and LB (None), or products by the inverses
Lm^-1 and (Lm LB)^-1 (any other value), which the JAX package hoists out
of its filter scans and this module computes once per posterior
(``SparsePosterior.inverses``).  The port has one matmul precision, IEEE
fp32 (TF32 is never enabled), so the value picks the algorithm only.
The JAX package computes these predictions in XLA, outside any Pallas
kernel.  Here the solve path is ``ops.sgpr.sgpr_predict``: on the card
one hand-written kernel (K4) from the star kernel to the mean and the
variance, on the CPU ``torch.linalg.solve_triangular``; the hoisted path
is ``torch.matmul``, in the span ``sgpr.hoisted``.

The factors come from the host in float64 (``precompute_host``), cast to
the model dtype.  ``distill_host`` builds them for a trained exact model
from its own hyperparameters and latents, with inducing inputs chosen as
an even-stride subset of the latents or as their k-means centroids.

Training minimises the VFE objective per GP (multi-output, with the
per-dimension output scales w = exp(log_lambdas) and noise sigma^2):

    L = Dout/2 (log|B| + N log sigma^2) + 1/(2 sigma^2) sum_j w_j^2 (|y_j|^2 - |c_j|^2)
        - N log|W| + Dout/(2 sigma^2) tr(Knn - Qnn)

(``sparse_nll``: the observation GP, plus the dynamics GPs of every class
in one batched factorization), differentiated by ``torch.autograd``.  The
objective's jitters and capacitance follow the model dtype
(``cfg.dtype``), whatever the tensors' dtype: in float32 the capacitance
factor LB comes from a QR of ``[A^T; I]`` (``_lb_via_qr``), never from a
Cholesky of ``B``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..config import GPMDMConfig
from ..ops import kernels as K
from ..ops import kernels_host as KH
from ..ops import linalg as LA
from ..ops.sgpr import sgpr_predict, star_block
from ..ops.layout import DataLayout, padded_class_indices
from ..utils.profiling import span
from .core import PARAM_FIELDS, host_f64, hyperprior_penalty, tensor_from_numpy

#: The fields of ``SparseParams``, in the JAX package's order.
SPARSE_PARAM_FIELDS = PARAM_FIELDS + ("Zy", "Zx")


@dataclasses.dataclass
class SparseParams:
    """Trainable state of the sparse model: the exact model's parameters
    (log-space hyperparameters and the latent X) and the free inducing
    inputs, in the JAX package's field order (``utils.asset_guard``'s
    fingerprint reads them in this order)."""

    y_log_lengthscales: torch.Tensor  # (d,)
    y_log_lambdas: torch.Tensor  # (D,)
    y_log_sigma_n: torch.Tensor  # ()
    x_log_lengthscales: torch.Tensor  # (d * back_step,)
    x_log_lambdas: torch.Tensor  # (d,)
    x_log_sigma_n: torch.Tensor  # ()
    x_log_lin_coeff: torch.Tensor  # (d * back_step + 1,)
    X: torch.Tensor  # (Ny, d)
    Zy: torch.Tensor  # (My, d) observation-GP inducing inputs
    Zx: torch.Tensor  # (C, Mx, d * back_step) per-class dynamics inducing inputs

    @classmethod
    def from_numpy(cls, arrays: dict, dtype: torch.dtype, device) -> "SparseParams":
        """From numpy arrays keyed by field name: a checkpoint's ``param_*``
        entries, or the JAX package's ``SparseParams`` through ``np.asarray``."""
        return cls(**{f: tensor_from_numpy(arrays[f], dtype, device)
                      for f in SPARSE_PARAM_FIELDS})


@dataclasses.dataclass
class SparsePosterior:
    """SGPR posterior state of both maps; the tensor fields are the JAX
    package's, in its order (a checkpoint's ``post_<field>`` and
    ``sparsified_<j>_<field>``).

    ``distilled`` is True for a post-hoc distillation of an exact model
    (``distill_host``), False for a sparse model's own posterior.  The
    filter picks its default variance path by it
    (``filter.particle_filter._effective_quad_precision``)."""

    X: torch.Tensor  # (Ny, d) latent snapshot, for the filter's initial cloud
    Zy: torch.Tensor  # (My, d)
    Ly: torch.Tensor  # (My, My) chol(Kmm_y)
    LBy: torch.Tensor  # (My, My) chol(B_y)
    beta_y: torch.Tensor  # (My, D)
    Zx: torch.Tensor  # (C, Mx, din)
    Lx: torch.Tensor  # (C, Mx, Mx)
    LBx: torch.Tensor  # (C, Mx, Mx)
    beta_x: torch.Tensor  # (C, Mx, d)
    distilled: bool = False

    @classmethod
    def from_numpy(cls, arrays: dict, dtype: torch.dtype, device,
                   distilled: bool = False) -> "SparsePosterior":
        """From numpy arrays keyed by field name, each a C-contiguous
        tensor in ``dtype`` on ``device``."""
        return cls(**{f: tensor_from_numpy(arrays[f], dtype, device) for f in POSTERIOR_FIELDS},
                   distilled=distilled)

    def to(self, device) -> "SparsePosterior":
        return type(self)(**{f: getattr(self, f).to(device) for f in POSTERIOR_FIELDS},
                          distilled=self.distilled)

    @functools.cached_property
    def inverses(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[Lm^-1; (Lm LB)^-1]`` stacked on the row axis, (2 My, My) for
        the observation GP and (C, 2 Mx, Mx) for the dynamics GPs: the
        hoisted variance path's operands, computed once in the posterior's
        dtype (the JAX package's loop-invariant triangular solves)."""
        return _inverses(self.Ly, self.LBy), _inverses(self.Lx, self.LBx)


#: The tensor fields of ``SparsePosterior``, in order.
POSTERIOR_FIELDS = tuple(f.name for f in dataclasses.fields(SparsePosterior)
                         if f.name != "distilled")

_JITTER = 1e-6

# Kuu's jitter by dtype: inducing inputs taken from consecutive motion
# frames are near-duplicates, so Kuu's smallest eigenvalues sit at the f32
# kernel-evaluation noise floor (the JAX package measured a min eigenvalue
# of -8.5e-6 at M = 256, condition ~1e7).  1e-4 keeps the condition ~2e5;
# the VFE with a jittered Kuu is still a valid bound.
_KUU_JITTER = {"float32": 1e-4, "float64": 1e-6}


def _kuu_jitter(dtype) -> float:
    """Kuu's jitter for a torch dtype or a model dtype name
    (``GPMDMConfig.dtype``)."""
    return _KUU_JITTER.get(str(dtype).removeprefix("torch."), 1e-4)


def _lb_via_qr(A: torch.Tensor) -> torch.Tensor:
    """``chol(I + A A^T)`` for A (..., M, N), N >= 0, without forming
    ``I + A A^T``: the R factor of the reduced QR of ``[A^T; I]`` satisfies
    ``R^T R = A A^T + I``, so ``LB = R^T`` with its diagonal made positive
    (a sign of 0 taken as 1).

    At Ny ~ 54,000 rows a class and a trained sigma_n ~ 0.04, ``B = I +
    A A^T`` reaches a condition of ~3.4e7.  Its exact Cholesky pivots are
    all >= 1, but fp32 pivots carry an absolute error ~ eps ||B|| ~ 2, and
    the JAX package's f32 training froze on a NaN there.  The stacked QR's
    error scales with ||[A^T; I]|| = sqrt(||B||), ~7e-4 against pivots of
    1.  The cost is the same O(N M^2) as forming A A^T."""
    M = A.shape[-2]
    eye = torch.eye(M, dtype=A.dtype, device=A.device).expand(A.shape[:-2] + (M, M))
    _, R = torch.linalg.qr(torch.cat([A.mT, eye], dim=-2), mode="reduced")  # (..., M, M)
    s = torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return (R * s[..., :, None]).mT


def _sgpr_terms(Kmm, Kmn, knn_diag, Y, log_sigma, w2, n_valid, dtype: torch.dtype,
                col_mask=None, sigma_n_num: float = 0.0, qr_b: bool | None = None):
    """The VFE pieces of one GP, or of a batch of GPs on a leading axis:
    Kmm (..., M, M), Kmn (..., M, N), knn_diag (..., N), Y (..., N, Dout),
    w2 (Dout,).  ``dtype`` is the model dtype (``cfg.torch_dtype``): it sets
    Kuu's jitter and the relative floors, so float64 tensors with a float32
    model evaluate the float32 objective without its rounding.
    ``col_mask`` (..., N) zeroes padded data columns and ``n_valid`` is the
    true data count.  ``qr_b`` picks the capacitance factorization: the
    stacked QR (``_lb_via_qr``) or the Cholesky of ``I + A A^T``; None takes
    the QR for a float32 model and the Cholesky for a float64 one.  Returns
    (nll (...), Lm, LB, c) with c = LB^-1 A Y."""
    M = Kmm.shape[-1]
    sigma2 = torch.exp(log_sigma) ** 2 + sigma_n_num**2 + _JITTER
    if col_mask is not None:
        Kmn = Kmn * col_mask[..., None, :]
        knn_diag = knn_diag * col_mask
        Y = Y * col_mask[..., :, None]
    Lm = LA.chol_lower(Kmm, jitter=_kuu_jitter(dtype), floor_dtype=dtype)
    A = LA.tri_solve(Lm, Kmn) / torch.sqrt(sigma2)  # (..., M, N)
    if qr_b is None:
        qr_b = dtype == torch.float32
    if qr_b:
        LB = _lb_via_qr(A)
    else:
        LB = LA.chol_lower(torch.eye(M, dtype=Kmm.dtype, device=Kmm.device) + A @ A.mT,
                           floor_dtype=dtype)
    logdet_B = LA.chol_logdet(LB)
    c = LA.tri_solve(LB, A @ Y)  # (..., M, Dout)
    quad = (torch.sum(Y * Y, dim=-2) - torch.sum(c * c, dim=-2)) / sigma2[..., None]
    # a cancellation at large N, kept in this order
    trace = (torch.sum(knn_diag, dim=-1) - sigma2 * torch.sum(A * A, dim=(-2, -1))) / sigma2
    Dout = Y.shape[-1]
    nll = (Dout / 2.0 * (logdet_B + n_valid * torch.log(sigma2))
           + 0.5 * torch.sum(w2 * quad, dim=-1)
           - n_valid * 0.5 * torch.sum(torch.log(w2))
           + Dout / 2.0 * trace)
    return nll, Lm, LB, c


def class_pads(layout: DataLayout, device, dtype: torch.dtype) -> dict:
    """``padded_class_indices`` as tensors on ``device``: the (C, n_max)
    gathers as int64 and the mask in ``dtype``.  A training run makes them
    once, not once a step."""
    pads = padded_class_indices(layout)
    out = {k: torch.as_tensor(pads[k], dtype=torch.int64, device=device)
           for k in ("idx_in", "idx_prev", "idx_out")}
    out["mask"] = torch.as_tensor(pads["mask"], device=device).to(dtype)
    return out


def _class_xin_xout(params, cfg: GPMDMConfig, pads: dict):
    """Padded per-class (Xin_c, Xout_c, mask) from the latent matrix:
    (C, n_max, d * back_step), (C, n_max, d) and (C, n_max)."""
    X, mask = params.X, pads["mask"]
    x_t = X[pads["idx_in"]] * mask[:, :, None]
    if cfg.dyn_back_step == 1:
        Xin_c = x_t
    else:
        Xin_c = torch.cat([x_t, X[pads["idx_prev"]] * mask[:, :, None]], dim=2)
    Xout_c = X[pads["idx_out"]] * mask[:, :, None]
    if cfg.dyn_target == "delta":
        Xout_c = Xout_c - x_t
    return Xin_c, Xout_c, mask


def y_sparse_nll(params: SparseParams, Y: torch.Tensor, cfg: GPMDMConfig) -> torch.Tensor:
    """The observation map's VFE NLL (the sparse form of
    ``core.y_neg_log_likelihood``)."""
    Kmm = K.rbf_kernel(params.Zy, params.Zy, params.y_log_lengthscales)
    Kmn = K.rbf_kernel(params.Zy, params.X, params.y_log_lengthscales)
    knn_diag = torch.ones(params.X.shape[0], dtype=Y.dtype, device=Y.device)
    return _sgpr_terms(Kmm, Kmn, knn_diag, Y, params.y_log_sigma_n,
                       torch.exp(params.y_log_lambdas) ** 2, Y.shape[0], cfg.torch_dtype,
                       sigma_n_num=cfg.sigma_n_num_Y)[0]


def x_sparse_nll(params: SparseParams, cfg: GPMDMConfig, pads: dict) -> torch.Tensor:
    """The dynamics maps' VFE NLL, every class's GP batched on the class
    axis and summed (``pads`` from :func:`class_pads`)."""
    Xin_c, Xout_c, mask = _class_xin_xout(params, cfg, pads)
    ls, sn, lin = params.x_log_lengthscales, params.x_log_sigma_n, params.x_log_lin_coeff
    Kmm = K.x_kernel(params.Zx, params.Zx, ls, sn, lin, with_noise=False)
    Kmn = K.x_kernel(params.Zx, Xin_c, ls, sn, lin, with_noise=False)
    knn_diag = K.x_diag_kernel(Xin_c, lin, sn)
    nll = _sgpr_terms(Kmm, Kmn, knn_diag, Xout_c, sn, torch.exp(params.x_log_lambdas) ** 2,
                      torch.sum(mask, dim=-1), cfg.torch_dtype, col_mask=mask,
                      sigma_n_num=cfg.sigma_n_num_X)[0]
    return torch.sum(nll)


def sparse_nll(params: SparseParams, Y: torch.Tensor, cfg: GPMDMConfig, layout: DataLayout,
               balance: float = 1.0, pads: dict | None = None) -> torch.Tensor:
    """The sparse MAP objective L_y + balance * L_x plus the optional
    log-hyperprior (``core.hyperprior_penalty``); ``balance`` applies under
    ``cfg.balance_fix`` only.  ``pads`` (:func:`class_pads`) is made here
    when not given."""
    if pads is None:
        pads = class_pads(layout, Y.device, Y.dtype)
    b = balance if cfg.balance_fix else 1.0
    return (y_sparse_nll(params, Y, cfg) + b * x_sparse_nll(params, cfg, pads)
            + hyperprior_penalty(params, cfg))


def _inverses(Lm: torch.Tensor, LB: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(Lm.shape[-1], dtype=Lm.dtype, device=Lm.device).expand_as(Lm)
    Vi = torch.linalg.solve_triangular(Lm, eye, upper=False)  # Lm^-1
    Wi = torch.linalg.solve_triangular(LB, Vi, upper=False)  # (Lm LB)^-1
    return torch.cat([Vi, Wi], dim=-2)


def _sgpr_predict(Z, Xstar, Lm, LB, beta, inverses, log_lengthscales, log_sigma_n,
                  sigma_n_num: float, with_noise: bool, log_lin_coeff=None):
    """The SGPR predictive mean (..., N*, Dout) and common variance
    (..., N*), clamped at 1e-12, at ``Xstar`` against the inducing inputs
    ``Z`` (``ops.sgpr`` has the kernels).  ``inverses`` (``[Lm^-1; (Lm
    LB)^-1]``) selects the hoisted variance path; None, the per-frame
    triangular solves (K4 on the card).  The hoisted path runs in the span
    ``sgpr.hoisted`` (``utils.profiling``)."""
    if inverses is None:
        return sgpr_predict(Z, Xstar.contiguous(), Lm, LB, beta, log_lengthscales, log_sigma_n,
                            sigma_n_num, with_noise, log_lin_coeff)
    with span("sgpr.hoisted"):
        Kstar_m, kss_diag = star_block(Z, Xstar, log_lengthscales, log_sigma_n, sigma_n_num,
                                       with_noise, log_lin_coeff)
        mean = Kstar_m.mT @ beta
        M = Lm.shape[-1]
        # both products at once; squared in place, nothing else reads them
        sq = (inverses @ Kstar_m).square_()  # (..., 2M, N*)
        s1, s2 = torch.sum(sq[..., :M, :], dim=-2), torch.sum(sq[..., M:, :], dim=-2)
        return mean, torch.clamp(kss_diag - s1 + s2, min=1e-12)


def precompute_host(params, Y, cfg: GPMDMConfig, layout: DataLayout,
                    device="cuda") -> SparsePosterior:
    """The SGPR posterior of both maps, factored on the host in float64 and
    cast to the model dtype on ``device`` (factor high, deploy low).
    ``params`` is a ``SparseParams`` or a dict of numpy arrays keyed by
    field name; either is widened to float64 first.  Costs O(N M^2)."""
    import scipy.linalg as sl

    X = host_f64(params, "X")
    Y64 = KH.f64(Y)
    Zy, Zx = host_f64(params, "Zy"), host_f64(params, "Zx")
    y_ls = np.exp(host_f64(params, "y_log_lengthscales"))
    x_ls = np.exp(host_f64(params, "x_log_lengthscales"))
    x_lw = np.exp(host_f64(params, "x_log_lin_coeff")) ** 2
    sigma2_y = (float(np.exp(host_f64(params, "y_log_sigma_n"))) ** 2
                + cfg.sigma_n_num_Y**2 + _JITTER)
    sigma2_x = (float(np.exp(host_f64(params, "x_log_sigma_n"))) ** 2
                + cfg.sigma_n_num_X**2 + _JITTER)
    # the jitter that the training loss of the model dtype uses, so that the
    # deployed posterior matches the trained objective: keyed on the DEPLOY
    # dtype (cfg.dtype), not on these float64 copies
    kuu_jitter = _kuu_jitter(cfg.dtype)

    def sgpr(Kmm, Kmn, Ydata, sigma2):
        M = Kmm.shape[0]
        Lm = np.linalg.cholesky(Kmm + kuu_jitter * np.eye(M))
        A = sl.solve_triangular(Lm, Kmn, lower=True) / np.sqrt(sigma2)
        LB = np.linalg.cholesky(np.eye(M) + A @ A.T)
        c = sl.solve_triangular(LB, A @ Ydata, lower=True)
        beta = sl.solve_triangular(
            Lm.T, sl.solve_triangular(LB.T, c, lower=False), lower=False
        ) / np.sqrt(sigma2)
        return Lm, LB, beta

    Ly, LBy, beta_y = sgpr(KH.rbf(Zy, Zy, y_ls), KH.rbf(Zy, X, y_ls), Y64, sigma2_y)

    Xin_c, Xout_c, mask = KH.class_xin_xout(X, layout, cfg, padded_class_indices(layout))
    C, Mx = Zx.shape[0], Zx.shape[1]
    Lx = np.zeros((C, Mx, Mx))
    LBx = np.zeros((C, Mx, Mx))
    beta_x = np.zeros((C, Mx, cfg.d))
    for c in range(C):
        Kmn = KH.x_kernel(Zx[c], Xin_c[c], x_ls, x_lw) * mask[c][None, :]
        Lx[c], LBx[c], beta_x[c] = sgpr(KH.x_kernel(Zx[c], Zx[c], x_ls, x_lw), Kmn,
                                        Xout_c[c], sigma2_x)

    return SparsePosterior.from_numpy(
        dict(X=X, Zy=Zy, Ly=Ly, LBy=LBy, beta_y=beta_y, Zx=Zx, Lx=Lx, LBx=LBx,
             beta_x=beta_x), cfg.torch_dtype, device)


def predict_y(post: SparsePosterior, params, Xstar: torch.Tensor, cfg: GPMDMConfig,
              with_noise: bool = False, quad_precision=None):
    """Latent -> observation posterior: mean and per-dimension variance
    (N*, D).  ``quad_precision`` other than None takes the hoisted
    variance path (module docstring)."""
    inv = None if quad_precision is None else post.inverses[0]
    mean, var_common = _sgpr_predict(post.Zy, Xstar, post.Ly, post.LBy, post.beta_y, inv,
                                     params.y_log_lengthscales, params.y_log_sigma_n,
                                     cfg.sigma_n_num_Y, with_noise)
    return mean, var_common[:, None] * torch.exp(params.y_log_lambdas)[None, :] ** -2


def _predict_x_per_class(post: SparsePosterior, params, Xstar: torch.Tensor,
                         cfg: GPMDMConfig, with_noise: bool, quad_precision=None):
    """Per-class dynamics posteriors: means (C, N*, d) and common
    variances (C, N*) before the lambda scaling."""
    inv = None if quad_precision is None else post.inverses[1]
    return _sgpr_predict(post.Zx, Xstar, post.Lx, post.LBx, post.beta_x, inv,
                         params.x_log_lengthscales, params.x_log_sigma_n, cfg.sigma_n_num_X,
                         with_noise, params.x_log_lin_coeff)


def predict_x_all_classes(post: SparsePosterior, params, Xstar: torch.Tensor,
                          cfg: GPMDMConfig, with_noise: bool = False, quad_precision=None):
    """Every class's dynamics posterior at once: means and variances
    (C, N*, d).  ``quad_precision``: see :func:`predict_y`."""
    means, var_common = _predict_x_per_class(post, params, Xstar, cfg, with_noise,
                                             quad_precision)
    return means, var_common[:, :, None] * torch.exp(params.x_log_lambdas)[None, None, :] ** -2


def predict_x(post: SparsePosterior, params, Xstar: torch.Tensor, cfg: GPMDMConfig,
              with_noise: bool = False, quad_precision=None):
    """All-class dynamics posterior (reference map_x_dynamics): mean and
    variance (N*, d).  The exact model's block-diagonal masked Gram makes
    the all-class map additive over classes (mean = sum_c mean_c, variance
    reduction = sum_c (kss - var_common_c)); each class's inducing set
    stands in for its training block here."""
    means, var_common = _predict_x_per_class(post, params, Xstar, cfg, with_noise,
                                             quad_precision)
    kss = K.x_diag_kernel(Xstar, params.x_log_lin_coeff, params.x_log_sigma_n,
                          cfg.sigma_n_num_X, with_noise)
    var_all = torch.clamp(kss - torch.sum(kss[None, :] - var_common, dim=0), min=1e-9)
    return (torch.sum(means, dim=0),
            var_all[:, None] * torch.exp(params.x_log_lambdas)[None, :] ** -2)


def predict_x_for_class(post: SparsePosterior, params, Xstar: torch.Tensor,
                        class_index: int, cfg: GPMDMConfig, with_noise: bool = False):
    """Single-class dynamics posterior (reference map_x_dynamics_for_class)."""
    mean, var = predict_x_all_classes(post, params, Xstar, cfg, with_noise)
    return mean[class_index], var[class_index]


def _kmeans(X: np.ndarray, M: int, iters: int = 25) -> np.ndarray:
    """Deterministic Lloyd's k-means on the host in float64: initialised
    on an even-stride subset, an empty cluster re-seeded at the point
    farthest from its centroid.  Centroids cover the trained manifold more
    evenly than strided rows at small M."""
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    if M >= n:
        return X.copy()
    idx = np.linspace(0, n - 1, M).round().astype(int)
    C = X[idx].copy()
    X2 = (X * X).sum(1)[:, None]  # (n, 1), loop-invariant
    for _ in range(iters):
        # (n, M) squared distances by the matmul form: the broadcast form
        # would hold (n, M, dim) float64 temporaries (~0.4 GB at Ny = 108k)
        d2 = X2 + (C * C).sum(1)[None, :] - 2.0 * (X @ C.T)
        a = d2.argmin(1)
        newC = np.zeros_like(C)
        counts = np.bincount(a, minlength=M).astype(np.float64)
        np.add.at(newC, a, X)
        empty = counts == 0
        counts[empty] = 1.0
        newC /= counts[:, None]
        if empty.any():
            far = d2[np.arange(n), a].argsort()[::-1]
            newC[empty] = X[far[: int(empty.sum())]]
        if np.allclose(newC, C):
            C = newC
            break
        C = newC
    return C


def distill_host(params, Y, cfg: GPMDMConfig, layout: DataLayout,
                 n_inducing_y: int = 128, n_inducing_x: int | None = None,
                 method: str = "stride", device="cuda") -> SparsePosterior:
    """Post-hoc SGPR distillation of a trained EXACT model: its
    hyperparameters and latents as they are, inducing inputs selected from
    the trained latents, and the SGPR factors of ``precompute_host``,
    marked ``distilled``.  ``params`` is a ``GPMDMParams`` or a dict of
    numpy arrays.  ``n_inducing_x`` defaults to ``n_inducing_y``; both
    are clamped to the available rows (the observation GP's Ny, each
    class's dynamics pairs).  ``method``: ``'stride'`` (an even-stride
    subset, :func:`init_inducing`) or ``'kmeans'`` (:func:`_kmeans` per
    GP and class)."""
    if method not in ("stride", "kmeans"):
        raise ValueError("method must be 'stride' or 'kmeans'")
    if n_inducing_x is None:
        n_inducing_x = n_inducing_y
    My = int(min(n_inducing_y, int(layout.Ny)))
    Mx = int(min(n_inducing_x, int(np.min(np.asarray(layout.class_x_counts)))))
    X0 = host_f64(params, "X")
    if method == "kmeans":
        Zy = _kmeans(X0, My)
        Xin_c, _, mask = KH.class_xin_xout(X0, layout, cfg, padded_class_indices(layout))
        Zx = np.stack([_kmeans(Xin_c[c][mask[c].astype(bool)], Mx)
                       for c in range(layout.n_classes)])
    else:
        Zy, Zx = init_inducing(X0, layout, cfg, My, Mx)
    sp = {f: host_f64(params, f) for f in PARAM_FIELDS}
    post = precompute_host({**sp, "Zy": Zy, "Zx": Zx}, Y, cfg, layout, device)
    post.distilled = True
    return post


def init_inducing(X0: np.ndarray, layout: DataLayout, cfg: GPMDMConfig,
                  n_inducing_y: int, n_inducing_x: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic inducing inputs: an even-stride subset of the latents
    (observation GP) and of each class's dynamics inputs."""
    Ny = X0.shape[0]
    idx = np.linspace(0, Ny - 1, n_inducing_y).round().astype(int)
    Zy = X0[idx].copy()

    pads = padded_class_indices(layout)
    C = layout.n_classes
    din = cfg.d * cfg.dyn_back_step
    Zx = np.zeros((C, n_inducing_x, din), dtype=X0.dtype)
    for c in range(C):
        n_c = int(layout.class_x_counts[c])
        sel = np.linspace(0, n_c - 1, n_inducing_x).round().astype(int)
        x_t = X0[pads["idx_in"][c, sel]]
        if cfg.dyn_back_step == 1:
            Zx[c] = x_t
        else:
            Zx[c] = np.concatenate([x_t, X0[pads["idx_prev"][c, sel]]], axis=1)
    return Zy, Zx
