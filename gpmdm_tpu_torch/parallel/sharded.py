"""Sharded MAP training: expert-parallel dynamics and tensor-parallel
observation NLL over an ('ep', 'tp') mesh.

Counterpart of ``gpmdm_tpu/parallel/sharded.py``:

- **ep**: the dynamics NLL is a sum of independent per-class Gram
  factorizations.  Class blocks are padded to one size
  (``core.x_nll_padded_blocks``, exact identity padding; the class axis
  padded to a multiple of |ep|) and each rank factors its classes' blocks.
- **tp**: the observation trace ``sum_j w_j^2 y_j^T K_y^-1 y_j`` sums over
  Y's D columns, padded to a multiple of |tp| (lambda = 1, zero data: the
  trace and ``-N log|W|`` do not move); each rank solves its columns
  against a replicated Cholesky factor of K_y.  With ``shard_chol=True``
  the O(Ny^3) factorization itself is sharded instead: K_y is row-panel
  sharded over ``tp`` and factored by ``dist_chol`` (Y row-sharded; Ny
  must be divisible by |tp|).

Gradients, by local shares.  Torch's differentiable collectives all-reduce
a cotangent again in the backward, so a replicated loss summed by one
would count its gradient |tp| or |ep| times.  Instead each rank computes
its SHARE of the loss, every term replicated over an axis weighted by one
over that axis's size (the replicated logdet of K_y by 1 / (ep tp), the
trace columns by 1 / ep, the dynamics classes by 1 / tp, the
parameter-only terms by 1 / (ep tp)), and differentiates it alone; then
ONE all-reduce over the mesh sums the shares and the flat gradient.  No
autograd passes through a collective, except inside ``y_nll_dist``'s own
``torch.autograd.Function``.  Parameters are replicated on every rank
and stay equal: every rank applies the same summed gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import GPMDMConfig, TrainConfig
from ..models import core
from ..ops import kernels as K
from ..ops import linalg as LA
from ..ops.layout import DataLayout, padded_class_indices
from ..train.trainer import (AdamState, _finite_step, _leaves, _like, _mask_grad, adam_update,
                             trainable_mask)
from . import collectives as C
from .dist_chol import y_nll_dist
from .mesh import axis_size, mesh_device, replicated, round_up


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedTrainContext:
    """This rank's padded class gathers and its place on the mesh, built
    once per (layout, mesh) pair.

    ``local`` holds this rank's rows (its classes, the class axis padded to
    a multiple of |ep|) of ``padded_class_indices``' ``idx_in``,
    ``idx_prev``, ``idx_out`` and ``mask``, on its device.
    ``shard_chol=True`` selects the distributed-Cholesky loss (see the
    module docstring)."""

    mesh: DeviceMesh
    cfg: GPMDMConfig
    layout: DataLayout
    local: tuple
    D_pad: int
    shard_chol: bool

    @property
    def ep(self) -> int:
        return axis_size(self.mesh, "ep")

    @property
    def tp(self) -> int:
        return axis_size(self.mesh, "tp")


def make_context(cfg: GPMDMConfig, layout: DataLayout, mesh: DeviceMesh,
                 shard_chol: bool = False) -> ShardedTrainContext:
    ep, tp = axis_size(mesh, "ep"), axis_size(mesh, "tp")
    if shard_chol and layout.Ny % tp != 0:
        raise ValueError(
            f"shard_chol requires Ny ({layout.Ny}) divisible by the tp axis "
            f"({tp}); pad the data or use shard_chol=False")
    pads = padded_class_indices(layout, n_class_pad=round_up(layout.n_classes, ep))
    n_local = pads["mask"].shape[0] // ep
    rows = slice(mesh.get_local_rank("ep") * n_local, (mesh.get_local_rank("ep") + 1) * n_local)
    dev = mesh_device(mesh)
    local = tuple(torch.as_tensor(pads[k][rows], dtype=torch.int64, device=dev)
                  for k in ("idx_in", "idx_prev", "idx_out"))
    local += (torch.as_tensor(pads["mask"][rows], device=dev),)
    return ShardedTrainContext(mesh=mesh, cfg=cfg, layout=layout, local=local,
                               D_pad=cfg.D if shard_chol else round_up(cfg.D, tp),
                               shard_chol=shard_chol)


def pad_Y(Y: torch.Tensor, ctx: ShardedTrainContext) -> torch.Tensor:
    """Observation columns padded to a multiple of |tp| with zeros."""
    extra = ctx.D_pad - ctx.cfg.D
    return Y if extra == 0 else torch.nn.functional.pad(Y, (0, extra))


def _pad_lambdas(y_log_lambdas: torch.Tensor, ctx: ShardedTrainContext) -> torch.Tensor:
    """Per-dimension output scales padded with lambda = 1 (log 0): nothing
    in the trace or the log|W| terms."""
    extra = ctx.D_pad - ctx.cfg.D
    return y_log_lambdas if extra == 0 else torch.nn.functional.pad(y_log_lambdas, (0, extra))


def nll_share(params: core.GPMDMParams, Y_padded: torch.Tensor, ctx: ShardedTrainContext,
              balance: float = 1.0) -> torch.Tensor:
    """This rank's share of the MAP loss L_y + balance L_x (+ the
    log-hyperprior); the shares of all ranks sum to ``core.nll``.
    Differentiable by autograd on this rank alone.  ``Y_padded`` (from
    :func:`pad_Y`) is the whole Y, on every rank."""
    cfg, layout = ctx.cfg, ctx.layout
    ep, tp = ctx.ep, ctx.tp
    i_tp = ctx.mesh.get_local_rank("tp")
    b = balance if cfg.balance_fix else 1.0
    idx_in, idx_prev, idx_out, mask = ctx.local
    x_share = b * torch.sum(core.x_nll_padded_blocks(
        params, cfg, idx_in, idx_prev, idx_out, mask.to(params.X.dtype))) / tp
    consts = (-b * layout.Nx * 2.0 * torch.sum(params.x_log_lambdas)
              + core.hyperprior_penalty(params, cfg))
    N = layout.Ny
    if ctx.shard_chol:
        nb = N // tp
        rows = slice(i_tp * nb, (i_tp + 1) * nb)
        K_i = K.y_kernel(params.X[rows], params.X, params.y_log_lengthscales,
                         params.y_log_sigma_n, cfg.sigma_n_num_Y, with_noise=False)
        # the global diagonal's noise and the dtype-relative jitter that
        # linalg.chol_lower adds (Ky's mean diagonal is exactly 1 + noise)
        noise = torch.exp(params.y_log_sigma_n) ** 2 + cfg.sigma_n_num_Y**2
        rel = LA._REL_JITTER.get(K_i.dtype, 0.0)
        diag = torch.zeros_like(K_i)
        diag[:, rows] = torch.eye(nb, dtype=K_i.dtype, device=K_i.device)
        K_i = K_i + (noise + rel * (1.0 + noise)) * diag
        w2 = torch.exp(params.y_log_lambdas) ** 2
        y_share = y_nll_dist(K_i, Y_padded[rows], w2, ctx.mesh.get_group("tp")) / ep
        consts = consts - N * 2.0 * torch.sum(params.y_log_lambdas)
    else:
        Ky = K.y_kernel(params.X, params.X, params.y_log_lengthscales, params.y_log_sigma_n,
                        cfg.sigma_n_num_Y, with_noise=True)
        Ly = LA.chol_lower(Ky)
        cols = slice(i_tp * (ctx.D_pad // tp), (i_tp + 1) * (ctx.D_pad // tp))
        lam = _pad_lambdas(params.y_log_lambdas, ctx)[cols]
        trace = LA.quad_trace(Ly, Y_padded[:, cols], torch.exp(lam) ** 2)
        y_share = (cfg.D / 2.0 * LA.chol_logdet(Ly) / (ep * tp)
                   + (0.5 * trace - N * 2.0 * torch.sum(lam)) / ep)
    return y_share + x_share + consts / (ep * tp)


def nll_sharded_value_and_grad(params: core.GPMDMParams, Y_padded: torch.Tensor,
                               ctx: ShardedTrainContext, balance: float = 1.0,
                               latent_map: Callable | None = None):
    """(loss, gradient leaves in field order), equal on every rank: each
    rank differentiates its share (:func:`nll_share`, of
    ``latent_map(params)`` when given), then one all-reduce over the mesh
    sums the shares and the flat gradient."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    with torch.enable_grad():
        p = _like(params, leaves)
        share = nll_share(latent_map(p) if latent_map is not None else p, Y_padded, ctx,
                          balance)
        grads = torch.autograd.grad(share, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
    flat = torch.cat([share.detach().reshape(1)] + [g.reshape(-1) for g in grads])
    C.all_reduce(flat, replicated(ctx.mesh))
    out, at = [], 1
    for g in grads:
        out.append(flat[at:at + g.numel()].reshape(g.shape))
        at += g.numel()
    return flat[0], out


def nll_sharded(params: core.GPMDMParams, Y_padded: torch.Tensor, ctx: ShardedTrainContext,
                balance: float = 1.0) -> torch.Tensor:
    """The MAP loss over the mesh, equal on every rank and to ``core.nll``
    up to summation order (not differentiable: see
    :func:`nll_sharded_value_and_grad`).  ``Y_padded`` comes from
    :func:`pad_Y`."""
    with torch.no_grad():
        share = nll_share(params, Y_padded, ctx, balance).reshape(1).clone()
    return C.all_reduce(share, replicated(ctx.mesh))[0]


def make_sharded_update_step(ctx: ShardedTrainContext, lr: float, balance: float, mask,
                             latent_map: Callable | None = None) -> Callable:
    """One sharded Adam step ``(params, opt_state, Y_padded) -> (params,
    opt_state, loss)``, the counterpart of ``trainer.make_update_step``:
    the summed loss and gradient, masked by select, the port's
    ``adam_update``, and the freeze of the parameters and the whole Adam
    state on a non-finite loss or gradient (the same decision on every
    rank: both are summed first).  ``latent_map`` transforms the
    parameters before the loss (the back-constrained family's X = K_b W)."""
    flags = _leaves(mask)

    def step(params, opt_state: AdamState, Y_padded: torch.Tensor):
        loss, grads = nll_sharded_value_and_grad(params, Y_padded, ctx, balance, latent_map)
        with torch.no_grad():
            old = [t.detach() for t in _leaves(params)]
            grads = [_mask_grad(g, m) for g, m in zip(grads, flags)]
            updates, new_state = adam_update(grads, opt_state, lr)
            ok = _finite_step(loss, grads)
            keep = lambda new, prev: torch.where(ok, new, prev)  # noqa: E731
            new_params = _like(params, [keep(p + u, p) for p, u in zip(old, updates)])
            new_state = AdamState(
                count=keep(new_state.count, opt_state.count),
                mu=_like(params, [keep(a, b) for a, b in zip(_leaves(new_state.mu),
                                                             _leaves(opt_state.mu))]),
                nu=_like(params, [keep(a, b) for a, b in zip(_leaves(new_state.nu),
                                                             _leaves(opt_state.nu))]))
        return new_params, new_state, loss

    return step


def train_adam_sharded(params: core.GPMDMParams, Y, cfg: GPMDMConfig, layout: DataLayout,
                       mesh: DeviceMesh, train_cfg: TrainConfig = TrainConfig(),
                       mode: str = "all", opt_state: AdamState | None = None,
                       shard_chol: bool = False, latent_map: Callable | None = None):
    """Sharded counterpart of ``trainer.train_adam``: ``train_cfg.num_steps``
    Adam steps (``train_cfg.lr``) over the mesh.  ``opt_state`` resumes an
    ``AdamState`` (a checkpoint's); ``shard_chol`` and ``latent_map`` as in
    :func:`make_context` and :func:`make_sharded_update_step`.  The losses
    stay on the device.  Returns (params, opt_state, losses)."""
    if train_cfg.optimizer != "adam":
        raise ValueError("the sharded trainer runs Adam only")
    ctx = make_context(cfg, layout, mesh, shard_chol=shard_chol)
    if opt_state is None:
        opt_state = AdamState.init(params)
    step = make_sharded_update_step(ctx, train_cfg.lr, train_cfg.balance,
                                    trainable_mask(cfg, mode), latent_map)
    dev = params.X.device
    Y = pad_Y(torch.as_tensor(Y).to(device=dev, dtype=params.X.dtype), ctx)
    losses = []
    for _ in range(train_cfg.num_steps):
        params, opt_state, loss = step(params, opt_state, Y)
        losses.append(loss)
    return params, opt_state, torch.stack(losses) if losses else torch.zeros(0, device=dev)
