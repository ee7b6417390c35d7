"""Row-sharded GP posterior predictions: the training-row axis over a mesh.

Counterpart of ``gpmdm_tpu/parallel/sp_predict.py``, the sequence-parallel
analogue for this model family: for one filter over a large training set
the per-frame cost is the (Ny, P) star kernel and the (Ny, Ny) x (Ny, P)
variance contraction, and both shard over the Ny axis.  Each rank

- takes its row shard of (X, Ay, Ky_inv) from the posterior (every rank
  holds the posterior; only its rows are read),
- computes its star-kernel rows and all-gathers the full star kernel (the
  one all-gather),
- contracts locally and all-reduces the mean and the quad, packed into one
  tensor (the one all-reduce).

Exact: equal to the single-device predictions up to summation order.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import GPMDMConfig
from ..models import core
from ..ops import kernels as K
from . import collectives as C
from .mesh import axis_size, round_up


def predict_y_rowsharded(post: core.Posterior, params: core.GPMDMParams, Xstar: torch.Tensor,
                         cfg: GPMDMConfig, mesh: DeviceMesh, axis: str = "sp",
                         with_noise: bool = False):
    """Row-sharded observation posterior == ``core.predict_y``: mean (P, D)
    and variance (P, D), on every rank.  Ny must be divisible by |axis|."""
    n, i = axis_size(mesh, axis), mesh.get_local_rank(axis)
    Ny = post.X.shape[0]
    if Ny % n != 0:
        raise ValueError(f"Ny={Ny} not divisible by |{axis}|={n}")
    rows = slice(i * (Ny // n), (i + 1) * (Ny // n))
    group = mesh.get_group(axis)
    ks_loc = K.rbf_kernel(post.X[rows], Xstar, params.y_log_lengthscales)  # (Ny/n, P)
    ks_full = C.all_gather(ks_loc, group)  # (Ny, P)
    mean_part = ks_loc.T @ post.Ay[rows]  # (P, D)
    quad_part = torch.sum(ks_loc * (post.Ky_inv[rows] @ ks_full), dim=0)  # (P,)
    summed = C.all_reduce(torch.cat([mean_part, quad_part[:, None]], dim=1), group)
    mean, quad = summed[:, :-1], summed[:, -1]
    diag = K.y_diag_kernel(Xstar, params.y_log_sigma_n, cfg.sigma_n_num_Y, with_noise)
    diag_common = torch.clamp(diag - quad, min=1e-9)
    var = diag_common[:, None] * torch.exp(params.y_log_lambdas)[None, :] ** -2
    return mean, var


def predict_x_all_classes_rowsharded(post: core.Posterior, params: core.GPMDMParams,
                                     Xstar: torch.Tensor, cfg: GPMDMConfig, mesh: DeviceMesh,
                                     axis: str = "sp", with_noise: bool = False):
    """Row-sharded per-class dynamics posterior ==
    ``core.predict_x_all_classes``: means and variances (C, P, d), on every
    rank.  The padded pair axis (n_max) is sharded over ``axis``; where
    |axis| does not divide n_max it is zero-padded further to a multiple
    (the posterior's counterpart of ``padded_class_indices(n_max_pad=)``):
    a padded row is masked out of the star kernel, so it adds nothing."""
    n, i = axis_size(mesh, axis), mesh.get_local_rank(axis)
    n_max = post.Xin_c.shape[1]
    n_pad = round_up(n_max, n)
    rows = slice(i * (n_pad // n), (i + 1) * (n_pad // n))

    def pad(a, dim):  # the pair axis zero-padded to n_pad
        if n_pad == n_max:
            return a
        shape = list(a.shape)
        shape[dim] = n_pad - n_max
        return torch.cat([a, a.new_zeros(shape)], dim=dim)

    Kinv_rows = pad(pad(post.Kxc_inv, 1)[:, rows], 2)  # (C, n_pad / n, n_pad)
    ks_loc = K.x_kernel(pad(post.Xin_c, 1)[:, rows], Xstar, params.x_log_lengthscales,
                        params.x_log_sigma_n, params.x_log_lin_coeff,
                        with_noise=False) * pad(post.mask_c, 1)[:, rows, None]
    group = mesh.get_group(axis)
    ks_full = C.all_gather(ks_loc, group, dim=1)  # (C, n_pad, P)
    mean_part = torch.einsum("cnp,cnd->cpd", ks_loc, pad(post.Axc, 1)[:, rows])  # (C, P, d)
    quad_part = torch.sum(ks_loc * torch.einsum("cmn,cnp->cmp", Kinv_rows, ks_full), dim=1)
    summed = C.all_reduce(torch.cat([mean_part, quad_part[:, :, None]], dim=2), group)
    mean, quad = summed[:, :, :-1], summed[:, :, -1]
    diag = K.x_diag_kernel(Xstar, params.x_log_lin_coeff, params.x_log_sigma_n,
                           cfg.sigma_n_num_X, with_noise)
    diag_common = torch.clamp(diag[None, :] - quad, min=1e-9)  # (C, P)
    var = diag_common[:, :, None] * torch.exp(params.x_log_lambdas)[None, None, :] ** -2
    return mean, var
