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
kernel, so here they are ``torch.linalg.solve_triangular`` and
``torch.matmul``.

The factors come from the host in float64 (``precompute_host``), cast to
the model dtype.  ``distill_host`` builds them for a trained exact model
from its own hyperparameters and latents, with inducing inputs chosen as
an even-stride subset of the latents or as their k-means centroids.  The
sparse family's training (``sparse_nll`` and the device precompute) is
not ported yet.
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
from ..ops.layout import DataLayout, padded_class_indices
from .core import PARAM_FIELDS, host_f64, tensor_from_numpy

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


def _kuu_jitter(dtype: str) -> float:
    """Kuu's jitter for the model dtype name (``GPMDMConfig.dtype``)."""
    return _KUU_JITTER.get(dtype, 1e-4)


def _inverses(Lm: torch.Tensor, LB: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(Lm.shape[-1], dtype=Lm.dtype, device=Lm.device).expand_as(Lm)
    Vi = torch.linalg.solve_triangular(Lm, eye, upper=False)  # Lm^-1
    Wi = torch.linalg.solve_triangular(LB, Vi, upper=False)  # (Lm LB)^-1
    return torch.cat([Vi, Wi], dim=-2)


def _sgpr_predict(Lm, LB, beta, Kstar_m, kss_diag, inverses=None):
    """The SGPR predictive mean (..., N*, Dout) and common variance
    (..., N*), clamped at 1e-12, from the star kernel against the inducing
    inputs ``Kstar_m`` (..., M, N*).  ``inverses`` (``[Lm^-1; (Lm
    LB)^-1]``) selects the hoisted variance path; None, the per-frame
    triangular solves."""
    mean = Kstar_m.mT @ beta
    M = Lm.shape[-1]
    if inverses is None:
        v1 = torch.linalg.solve_triangular(Lm, Kstar_m, upper=False)  # (..., M, N*)
        v2 = torch.linalg.solve_triangular(LB, v1, upper=False)
        s1, s2 = torch.sum(v1.square_(), dim=-2), torch.sum(v2.square_(), dim=-2)
    else:
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
    Kstar = K.rbf_kernel(post.Zy, Xstar, params.y_log_lengthscales)  # (My, N*)
    kss = K.y_diag_kernel(Xstar, params.y_log_sigma_n, cfg.sigma_n_num_Y, with_noise)
    inv = None if quad_precision is None else post.inverses[0]
    mean, var_common = _sgpr_predict(post.Ly, post.LBy, post.beta_y, Kstar, kss, inv)
    return mean, var_common[:, None] * torch.exp(params.y_log_lambdas)[None, :] ** -2


def _predict_x_per_class(post: SparsePosterior, params, Xstar: torch.Tensor,
                         cfg: GPMDMConfig, with_noise: bool, quad_precision=None):
    """Per-class dynamics posteriors: means (C, N*, d), common variances
    (C, N*) before the lambda scaling, and the star prior diagonal (N*,)."""
    kss = K.x_diag_kernel(Xstar, params.x_log_lin_coeff, params.x_log_sigma_n,
                          cfg.sigma_n_num_X, with_noise)
    Kstar = K.x_kernel(post.Zx, Xstar, params.x_log_lengthscales, params.x_log_sigma_n,
                       params.x_log_lin_coeff, with_noise=False)  # (C, Mx, N*)
    inv = None if quad_precision is None else post.inverses[1]
    means, var_common = _sgpr_predict(post.Lx, post.LBx, post.beta_x, Kstar, kss, inv)
    return means, var_common, kss


def predict_x_all_classes(post: SparsePosterior, params, Xstar: torch.Tensor,
                          cfg: GPMDMConfig, with_noise: bool = False, quad_precision=None):
    """Every class's dynamics posterior at once: means and variances
    (C, N*, d).  ``quad_precision``: see :func:`predict_y`."""
    means, var_common, _ = _predict_x_per_class(post, params, Xstar, cfg, with_noise,
                                                quad_precision)
    return means, var_common[:, :, None] * torch.exp(params.x_log_lambdas)[None, None, :] ** -2


def predict_x(post: SparsePosterior, params, Xstar: torch.Tensor, cfg: GPMDMConfig,
              with_noise: bool = False, quad_precision=None):
    """All-class dynamics posterior (reference map_x_dynamics): mean and
    variance (N*, d).  The exact model's block-diagonal masked Gram makes
    the all-class map additive over classes (mean = sum_c mean_c, variance
    reduction = sum_c (kss - var_common_c)); each class's inducing set
    stands in for its training block here."""
    means, var_common, kss = _predict_x_per_class(post, params, Xstar, cfg, with_noise,
                                                  quad_precision)
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
