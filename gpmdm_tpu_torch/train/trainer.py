"""MAP training of every GPMDM family with Adam or L-BFGS.

Counterpart of ``gpmdm_tpu/train/trainer.py``:

- Adam over all parameters (hyperparameters and the latent X jointly, and
  a sparse model's inducing inputs), written as a small functional update
  that matches ``optax.adam(lr)`` step for step (b1 0.9, b2 0.999, eps
  1e-8, eps_root 0; the count is incremented before the bias correction).
  It is not ``torch.optim.Adam``: the NaN freeze below must revert the
  moments and the count as well as the parameters, which an in-place
  optimizer cannot.
- L-BFGS with the zoom line search (``TrainConfig(optimizer='lbfgs')``),
  ``optax.lbfgs(memory_size)`` step for step (``train.lbfgs``; ``lr`` is
  ignored).  The line search sees the unmasked loss and gradient, as the
  JAX step gives it ``value_fn``; the direction is built from the masked
  gradient, so frozen leaves never move.  It is not
  ``torch.optim.LBFGS``, whose line search is another, and which cannot
  revert its state on the freeze.
- The model family's ``objective`` gives the trainability mask and the
  loss: :func:`exact_objective` (``core.nll``), :func:`sparse_objective`
  (``sparse.sparse_nll`` over ``SparseParams``) or the back-constrained
  model's ``back_constrained.bc_objective`` (W in the X slot).  The
  parameters, the optimizer state and the masks are all over the
  parameters' class.
- Trainability flags and training modes are gradient masks that select,
  never multiply, so a non-finite gradient on a frozen leaf is dropped.
- A step whose loss or (unfrozen) gradient is not finite keeps the
  previous parameters and the whole optimizer state: for Adam one
  ``torch.where`` per leaf on the device, the JAX package's freeze; for
  L-BFGS, whose step reads the loss on the host anyway, the step returns
  its inputs.

The Adam loss history stays on the device; the host reads it once a chunk
of ``print_every`` steps (the JAX package's ``lax.scan`` chunks), where the
logging, checkpointing and the stop after a frozen step happen.  An L-BFGS
step decides its line search on the host (``train.lbfgs``): 1 + k loss and
gradient evaluations and as many reads of two scalars for a search of k
candidates.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, List

import numpy as np
import torch

from ..config import GPMDMConfig, TrainConfig
from ..models import core, sparse
from ..ops.layout import DataLayout
from . import lbfgs
from .lbfgs import LBFGSState

B1, B2, EPS = 0.9, 0.999, 1e-8
_INT32_MAX = 2**31 - 1


def _names(p) -> List[str]:
    return [f.name for f in dataclasses.fields(p)]


def _leaves(p) -> List[torch.Tensor]:
    """The fields of a parameter dataclass (``GPMDMParams`` or
    ``SparseParams``), in its field order: the JAX package's leaf order."""
    return [getattr(p, f) for f in _names(p)]


def _like(template, leaves):
    """A parameter dataclass of ``template``'s class holding ``leaves``."""
    return type(template)(**dict(zip(_names(template), leaves)))


@dataclasses.dataclass
class AdamState:
    """``optax.adam``'s state: the int32 step count and the first and
    second moments of every parameter, each moment of the parameters'
    class.  ``to_numpy`` lists the leaves in optax's order (count, then
    ``mu`` and ``nu`` in field order), the ``opt_*`` order of a
    checkpoint."""

    count: torch.Tensor  # () int32
    mu: object  # the parameters' class
    nu: object

    @classmethod
    def init(cls, params) -> "AdamState":
        zeros = lambda: _like(params, [torch.zeros_like(t) for t in _leaves(params)])  # noqa: E731
        return cls(count=torch.zeros((), dtype=torch.int32, device=params.X.device),
                   mu=zeros(), nu=zeros())

    def to_numpy(self) -> List[np.ndarray]:
        return [t.detach().cpu().numpy()
                for t in [self.count] + _leaves(self.mu) + _leaves(self.nu)]

    @classmethod
    def from_numpy(cls, leaves, dtype: torch.dtype, device="cuda",
                   param_cls=core.GPMDMParams) -> "AdamState":
        """The state over ``param_cls`` from numpy leaves in optax's order
        (a checkpoint's ``opt_*`` entries, or ``jax.tree.leaves`` of an
        ``optax.adam`` state); the moments are cast to ``dtype``."""
        names = [f.name for f in dataclasses.fields(param_cls)]
        n = len(names)
        if len(leaves) != 1 + 2 * n:
            raise ValueError(f"an Adam state over {param_cls.__name__} has {1 + 2 * n} "
                             f"leaves, got {len(leaves)}")
        t = [core.tensor_from_numpy(a, dtype, device) for a in leaves[1:]]
        count = core.tensor_from_numpy(leaves[0], torch.int32, device).reshape(())
        return cls(count=count, mu=param_cls(**dict(zip(names, t[:n]))),
                   nu=param_cls(**dict(zip(names, t[n:]))))


def adam_update(grads: List[torch.Tensor], state: AdamState, lr: float):
    """One ``optax.adam(lr)`` update: (parameter increments in field order,
    new state).  The bias correction ``1 - b**count`` is computed in the
    moments' dtype."""
    mu = [(1 - B1) * g + B1 * m for g, m in zip(grads, _leaves(state.mu))]
    nu = [(1 - B2) * g ** 2 + B2 * v for g, v in zip(grads, _leaves(state.nu))]
    count = torch.where(state.count < _INT32_MAX, state.count + 1, state.count)
    updates = []
    for m, v in zip(mu, nu):
        c = count.to(m.dtype)
        m_hat = m / (1 - B1 ** c)
        v_hat = v / (1 - B2 ** c)
        updates.append(-lr * (m_hat / (torch.sqrt(v_hat) + EPS)))
    return updates, AdamState(count=count, mu=_like(state.mu, mu), nu=_like(state.nu, nu))


def trainable_mask(cfg: GPMDMConfig, mode: str = "all") -> core.GPMDMParams:
    """Per-parameter trainability (1.0 trainable / 0.0 frozen): the
    config's ``flg_train_*`` flags combined with the training mode ('all' |
    'latent' | 'dynamics').  The latent matrix X always trains.  The flags
    and the mode are honored, where the reference's ``train_adam`` resets
    them (the JAX package's documented divergence)."""
    if mode not in ("all", "latent", "dynamics"):
        raise ValueError("mode must be 'all', 'latent' or 'dynamics'")
    y_on = mode in ("all", "latent")
    x_on = mode in ("all", "dynamics")
    m = lambda flag: 1.0 if flag else 0.0  # noqa: E731
    return core.GPMDMParams(
        y_log_lengthscales=m(y_on and cfg.flg_train_y_lengthscales),
        y_log_lambdas=m(y_on and cfg.flg_train_y_lambdas),
        y_log_sigma_n=m(y_on and cfg.flg_train_y_sigma_n),
        x_log_lengthscales=m(x_on and cfg.flg_train_x_lengthscales),
        x_log_lambdas=m(x_on and cfg.flg_train_x_lambdas),
        x_log_sigma_n=m(x_on and cfg.flg_train_x_sigma_n),
        x_log_lin_coeff=m(x_on and cfg.flg_train_x_lin_coeff),
        X=1.0,
    )


def sparse_trainable_mask(cfg: GPMDMConfig, mode: str = "all"):
    """``SparseParams``' trainability: the exact model's mask, with the
    inducing inputs Zy trained with the observation group and Zx with the
    dynamics group."""
    base = trainable_mask(cfg, mode)
    return sparse.SparseParams(**{f: getattr(base, f) for f in core.PARAM_FIELDS},
                               Zy=1.0 if mode in ("all", "latent") else 0.0,
                               Zx=1.0 if mode in ("all", "dynamics") else 0.0)


def exact_objective(cfg: GPMDMConfig, mode: str, Y: torch.Tensor, layout: DataLayout):
    """The exact family's (trainability mask, loss_fn) for ``train_adam``.
    An objective takes the run's Y on its device, and makes once what is
    constant over the run."""
    return trainable_mask(cfg, mode), core.nll


def sparse_objective(cfg: GPMDMConfig, mode: str, Y: torch.Tensor, layout: DataLayout):
    """The sparse family's (mask, loss_fn), with the padded class gathers
    made once on Y's device from the host ``layout``."""
    return sparse_trainable_mask(cfg, mode), functools.partial(
        sparse.sparse_nll, pads=sparse.class_pads(layout, Y.device, Y.dtype))


def _mask_grad(g: torch.Tensor, m: float) -> torch.Tensor:
    """The gradient of a trainable leaf, zeros for a frozen one.  Select,
    never multiply: ``g * 0`` keeps a NaN, and the finite-step check would
    then veto every step for a gradient that does not matter."""
    return g if m != 0 else torch.zeros_like(g)


def _finite_step(loss: torch.Tensor, grads: List[torch.Tensor]) -> torch.Tensor:
    """True (a 0-d bool tensor on the device) iff the loss and every masked
    gradient are finite."""
    return torch.isfinite(loss) & torch.stack([torch.isfinite(g).all() for g in grads]).all()


def make_update_step(cfg: GPMDMConfig, layout: DataLayout, lr: float, balance: float,
                     mask, loss_fn: Callable | None = None) -> Callable:
    """One Adam step ``(params, opt_state, Y) -> (params, opt_state, loss)``:
    the loss and its gradient by autograd, masked by ``mask``, the Adam
    update, and the NaN freeze.  ``loss_fn(params, Y, cfg, layout,
    balance)`` defaults to the exact-GP loss ``core.nll``."""
    if loss_fn is None:
        loss_fn = core.nll
    flags = _leaves(mask)

    def step(params, opt_state: AdamState, Y: torch.Tensor):
        old = [t.detach() for t in _leaves(params)]
        with torch.enable_grad():
            leaves = [t.clone().requires_grad_(True) for t in old]
            loss = loss_fn(_like(params, leaves), Y, cfg, layout, balance)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            grads = [_mask_grad(torch.zeros_like(t) if g is None else g, m)
                     for g, t, m in zip(grads, old, flags)]
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
        return new_params, new_state, loss.detach()

    return step


def make_lbfgs_step(cfg: GPMDMConfig, layout: DataLayout, balance: float, mask,
                    loss_fn: Callable | None = None, stats: dict | None = None) -> Callable:
    """One L-BFGS step ``(params, opt_state, Y) -> (params, opt_state,
    loss)``, the counterpart of the JAX package's ``make_lbfgs_step`` over
    ``optax.lbfgs``: the loss and its gradient by autograd, the gradient
    masked by ``mask``, the direction from the memory (``lbfgs.direction``)
    and the zoom line search on the unmasked loss and gradient
    (``lbfgs.zoom_linesearch``).  The loss returned is the one at the
    step's start.  A step whose loss or masked gradient is not finite
    returns its parameters and state as they were.  ``stats``, a dict with
    the keys ``'evals'`` and ``'host_reads'`` when given, counts the
    loss-and-gradient evaluations and the host reads."""
    if loss_fn is None:
        loss_fn = core.nll
    counts = {"evals": 0, "host_reads": 0} if stats is None else stats
    flags = _leaves(mask)

    def step(params, state: LBFGSState, Y: torch.Tensor):
        names, cls = _names(params), type(params)
        shapes = [tuple(getattr(params, f).shape) for f in names]
        x = lbfgs.flatten(params)
        keep = None
        if not all(m != 0 for m in flags):
            keep = torch.cat([torch.full((int(np.prod(sh, dtype=np.int64)),), m != 0,
                                         device=x.device) for sh, m in zip(shapes, flags)])

        def value_and_grad(v):
            with torch.enable_grad():
                v = v.detach().requires_grad_(True)
                loss = loss_fn(lbfgs.unflatten(v, cls, shapes), Y, cfg, layout, balance)
                (g,) = torch.autograd.grad(loss, v, allow_unused=True)
            counts["evals"] += 1
            return loss.detach(), torch.zeros_like(v) if g is None else g

        def read(*scalars):
            counts["host_reads"] += 1
            return torch.stack([t.to(x.dtype) for t in scalars]).cpu().numpy()

        with torch.no_grad():
            loss, g = value_and_grad(x)
            if keep is not None:
                g = torch.where(keep, g, torch.zeros_like(g))
            u, dpm, dum, wm = lbfgs.direction(g, x, state)
            ok, value0, slope0 = read(_finite_step(loss, [g]), loss, torch.dot(u, g))
            if not ok:
                return params, state, loss

            def evaluate(stepsize):
                value, grad = value_and_grad(x + u * float(stepsize))
                value_h, slope = read(value, torch.dot(grad, u))
                return value_h, grad, slope

            ls = lbfgs.zoom_linesearch(evaluate, value0, slope0, g, value0.dtype)
            tail = torch.tensor([ls.stepsize, ls.value, ls.decrease_error, ls.curvature_error],
                                dtype=x.dtype, device=x.device)
            new_state = LBFGSState(
                count=torch.where(state.count < _INT32_MAX, state.count + 1, state.count),
                params=x, updates=g, diff_params_memory=dpm, diff_updates_memory=dum,
                weights_memory=wm, learning_rate=tail[0], value=tail[1], grad=ls.grad,
                num_linesearch_steps=torch.tensor(ls.num_steps, dtype=torch.int32,
                                                  device=x.device),
                decrease_error=tail[2], curvature_error=tail[3], param_cls=cls,
                shapes=tuple(shapes))
            new_params = lbfgs.unflatten(x + u * float(ls.stepsize), cls, shapes)
        return new_params, new_state, loss

    return step


@dataclasses.dataclass
class TrainResult:
    params: object  # the class of the parameters trained
    opt_state: object  # AdamState or LBFGSState
    losses: torch.Tensor  # (steps run,) on the parameters' device
    wall_time_s: float
    steps_per_sec: float
    loss_evals: int = 0  # loss-and-gradient evaluations
    host_reads: int = 0  # reads of device values by the host


def train_adam(params, Y, cfg: GPMDMConfig, layout: DataLayout,
               train_cfg: TrainConfig = TrainConfig(), mode: str = "all",
               opt_state=None, log_fn: Callable[[int, float, float], None] | None = None,
               objective: Callable = exact_objective, logger=None) -> TrainResult:
    """Run ``train_cfg.num_steps`` steps of ``train_cfg.optimizer`` ('adam'
    or 'lbfgs', the JAX package's name for both) on the parameters' device
    (reference train_adam).  ``objective`` is the model family's (the JAX
    package's ``kind``): :func:`exact_objective` over ``GPMDMParams``,
    :func:`sparse_objective` over ``SparseParams``, or
    ``back_constrained.bc_objective`` over ``GPMDMParams`` with W in the X
    slot.  ``opt_state`` resumes an ``AdamState`` or an ``LBFGSState`` (of
    ``train_cfg.lbfgs_memory``) over the parameters' class; one of another
    optimizer or class raises ``ValueError``.

    Steps run in chunks of ``print_every`` (the whole run when 0, and at
    most ``checkpoint_every``); after each chunk the host reads its losses
    once, calls ``log_fn(step, loss, seconds)``, logs loss and steps/s (and
    for L-BFGS the evaluations a step) to ``logger`` (a
    ``utils.logging.MetricLogger``), writes a train-state snapshot whenever
    a ``checkpoint_every`` boundary was crossed, and stops if the chunk's
    last loss is not finite (the parameters are then frozen).  Returns the
    parameters, the optimizer state, the per-step loss history and the
    counts of evaluations and host reads."""
    device = params.X.device
    stats = {"evals": 0, "host_reads": 0}
    if train_cfg.optimizer == "adam":
        if opt_state is None:
            opt_state = AdamState.init(params)
        elif not isinstance(opt_state, AdamState) or type(opt_state.mu) is not type(params):
            raise ValueError(f"opt_state is not an Adam state over {type(params).__name__}; "
                             "pass opt_state=None to start fresh")
    elif train_cfg.optimizer == "lbfgs":
        if opt_state is None:
            opt_state = LBFGSState.init(params, train_cfg.lbfgs_memory)
        elif (not isinstance(opt_state, LBFGSState) or not opt_state.matches(params)
              or opt_state.memory_size != train_cfg.lbfgs_memory):
            raise ValueError(f"opt_state is not an L-BFGS state of memory "
                             f"{train_cfg.lbfgs_memory} over these {type(params).__name__}; "
                             "pass opt_state=None to start fresh")
    else:
        raise ValueError(f"unknown optimizer {train_cfg.optimizer!r}")

    chunk = train_cfg.print_every if train_cfg.print_every > 0 else train_cfg.num_steps
    if train_cfg.checkpoint_every > 0:
        chunk = min(chunk, train_cfg.checkpoint_every)
    chunk = max(1, min(chunk, train_cfg.num_steps))

    if not torch.is_tensor(Y):
        Y = torch.as_tensor(np.asarray(Y))
    Y = Y.to(device=device, dtype=cfg.torch_dtype)
    mask, loss_fn = objective(cfg, mode, Y, layout)
    if train_cfg.optimizer == "lbfgs":
        step = make_lbfgs_step(cfg, layout.to(device), train_cfg.balance, mask, loss_fn, stats)
    else:
        step = make_update_step(cfg, layout.to(device), train_cfg.lr, train_cfg.balance, mask,
                                loss_fn)
    t0 = time.perf_counter()
    all_losses: List[torch.Tensor] = []
    done = 0
    while done < train_cfg.num_steps:
        n = min(chunk, train_cfg.num_steps - done)
        chunk_losses = []
        for _ in range(n):
            params, opt_state, loss = step(params, opt_state, Y)
            chunk_losses.append(loss)
        losses = torch.stack(chunk_losses)
        last = float(losses[-1])  # the host's one read of the chunk
        stats["host_reads"] += 1
        all_losses.append(losses)
        done += n
        if log_fn is not None:
            log_fn(done, last, time.perf_counter() - t0)
        if logger is not None:
            wall = time.perf_counter() - t0
            extra = ({"evals_per_step": stats["evals"] / done,
                      "host_reads_per_step": stats["host_reads"] / done}
                     if train_cfg.optimizer == "lbfgs" else {})
            logger.log(step=done, loss=last, steps_per_sec=done / wall if wall > 0 else 0.0,
                       **extra)
        if (train_cfg.checkpoint_every > 0 and train_cfg.checkpoint_path
                and done // train_cfg.checkpoint_every
                > (done - n) // train_cfg.checkpoint_every):
            from ..utils.checkpoint import save_train_state

            save_train_state(train_cfg.checkpoint_path, params, opt_state, done,
                             torch.cat(all_losses))
        if not np.isfinite(last):
            break  # the freeze tripped inside the chunk; parameters are frozen
    wall = time.perf_counter() - t0
    losses = torch.cat(all_losses) if all_losses else torch.zeros(0, device=device)
    return TrainResult(params=params, opt_state=opt_state, losses=losses, wall_time_s=wall,
                       steps_per_sec=done / wall if wall > 0 else float("inf"),
                       loss_evals=stats["evals"] if train_cfg.optimizer == "lbfgs" else done,
                       host_reads=stats["host_reads"])
