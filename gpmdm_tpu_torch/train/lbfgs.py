"""L-BFGS with the zoom line search: ``optax.lbfgs`` as plain functions on
tensors.

Counterpart of what ``gpmdm_tpu/train/trainer.py`` runs for
``TrainConfig(optimizer='lbfgs')``: ``optax.lbfgs(memory_size)``, the chain
of

1. ``scale_by_lbfgs(memory_size, scale_init_precond=True)``: the memory of
   parameter and gradient differences is updated with the fresh point, and
   the gradient is multiplied by the inverse-Hessian approximation (the
   two-loop recursion), the first step scaled by min(1, 1 / |g|);
2. ``scale(-1)``: the descent direction;
3. ``scale_by_zoom_linesearch(max_linesearch_steps=20,
   initial_guess_strategy='one')`` with ``zoom_linesearch``'s defaults
   (slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6, increase_factor
   2, interval threshold 1e-5, no maximal step): an interval search from
   step 1, then a zoom by cubic, quadratic or bisection interpolation,
   and the safe step (the best one of sufficient decrease seen) when the
   search fails.

The parameters are handled as one flat vector in their class's field
order (the concatenation of the leaves), so every vector operation of a
step is one call whatever the number of fields.  The memory and the
two-loop recursion stay on the device.  The line search's decisions are
taken on the host: each candidate step costs one loss-and-gradient
evaluation and one read of two scalars (the value and the slope), and the
state machine runs on numpy scalars of the parameters' dtype, in the same
order of operations as optax's.  A step whose search stops after k
candidates therefore costs 1 + k evaluations and 1 + k host reads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from ..models import core

# optax.lbfgs's line search (scale_by_zoom_linesearch / zoom_linesearch)
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
INCREASE_FACTOR, INTERVAL_THRESHOLD = 2.0, 1e-5


def _names(param_cls) -> List[str]:
    return [f.name for f in dataclasses.fields(param_cls)]


def flatten(params) -> torch.Tensor:
    """The leaves of a parameter dataclass concatenated in field order,
    detached: (n,)."""
    return torch.cat([getattr(params, f).detach().reshape(-1) for f in _names(type(params))])


def unflatten(flat: torch.Tensor, param_cls, shapes) -> object:
    """A ``param_cls`` whose leaves are views of ``flat`` (..., n) in field
    order, each of its shape (with ``flat``'s leading dimensions)."""
    out, o = {}, 0
    lead = tuple(flat.shape[:-1])
    for name, shape in zip(_names(param_cls), shapes):
        k = int(np.prod(shape, dtype=np.int64))
        out[name] = flat[..., o:o + k].reshape(lead + tuple(shape))
        o += k
    return param_cls(**out)


@dataclasses.dataclass
class LBFGSState:
    """``optax.lbfgs``'s state, with every tree held flat over the
    parameters (see :func:`flatten`).  ``to_numpy`` lists the leaves in
    optax's flatten order, a checkpoint's ``opt_*`` order:

    - ``ScaleByLBFGSState``: ``count`` (int32), ``params``, ``updates``,
      ``diff_params_memory`` and ``diff_updates_memory`` (each leaf with
      the memory as its first axis), ``weights_memory`` (m,);
    - ``EmptyState`` (the sign flip): no leaf;
    - ``ScaleByZoomLinesearchState``: ``learning_rate``, ``value``, ``grad``;
    - ``ZoomLinesearchInfo``: ``num_linesearch_steps`` (int32),
      ``decrease_error``, ``curvature_error``;

    each tree over the parameters' fields in field order: 5 n + 7 leaves
    for n fields (47 for ``GPMDMParams``, 57 for ``SparseParams``)."""

    count: torch.Tensor  # () int32
    params: torch.Tensor  # (n,)
    updates: torch.Tensor  # (n,)
    diff_params_memory: torch.Tensor  # (m, n)
    diff_updates_memory: torch.Tensor  # (m, n)
    weights_memory: torch.Tensor  # (m,)
    learning_rate: torch.Tensor  # ()
    value: torch.Tensor  # ()
    grad: torch.Tensor  # (n,)
    num_linesearch_steps: torch.Tensor  # () int32
    decrease_error: torch.Tensor  # ()
    curvature_error: torch.Tensor  # ()
    param_cls: type = None
    shapes: Tuple[tuple, ...] = ()

    @property
    def memory_size(self) -> int:
        return int(self.weights_memory.shape[0])

    @classmethod
    def init(cls, params, memory_size: int = 10) -> "LBFGSState":
        """optax's ``init``: zeros, the line search's learning rate 1, its
        value and errors +inf."""
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        x = flatten(params)
        dt, dev = x.dtype, x.device
        zeros = torch.zeros_like(x)
        mem = torch.zeros((memory_size, x.shape[0]), dtype=dt, device=dev)
        inf = torch.tensor(float("inf"), dtype=dt, device=dev)
        return cls(count=torch.zeros((), dtype=torch.int32, device=dev), params=zeros,
                   updates=zeros, diff_params_memory=mem, diff_updates_memory=mem,
                   weights_memory=torch.zeros(memory_size, dtype=dt, device=dev),
                   learning_rate=torch.ones((), dtype=dt, device=dev), value=inf, grad=zeros,
                   num_linesearch_steps=torch.zeros((), dtype=torch.int32, device=dev),
                   decrease_error=inf, curvature_error=inf, param_cls=type(params),
                   shapes=tuple(tuple(getattr(params, f).shape)
                                for f in _names(type(params))))

    def matches(self, params) -> bool:
        """Whether this state is over ``params``' class and shapes."""
        return (self.param_cls is type(params)
                and self.shapes == tuple(tuple(getattr(params, f).shape)
                                         for f in _names(type(params))))

    def _trees(self, flat):
        tree = unflatten(flat, self.param_cls, self.shapes)
        return [getattr(tree, f).detach().cpu().numpy() for f in _names(self.param_cls)]

    def to_numpy(self) -> List[np.ndarray]:
        scalar = lambda t: t.detach().cpu().numpy()  # noqa: E731
        return ([scalar(self.count)] + self._trees(self.params) + self._trees(self.updates)
                + self._trees(self.diff_params_memory) + self._trees(self.diff_updates_memory)
                + [scalar(self.weights_memory), scalar(self.learning_rate), scalar(self.value)]
                + self._trees(self.grad)
                + [scalar(self.num_linesearch_steps), scalar(self.decrease_error),
                   scalar(self.curvature_error)])

    @classmethod
    def from_numpy(cls, leaves, dtype: torch.dtype, device="cuda",
                   param_cls=core.GPMDMParams) -> "LBFGSState":
        """The state over ``param_cls`` from numpy leaves in optax's order (a
        checkpoint's ``opt_*`` entries, or ``jax.tree.leaves`` of an
        ``optax.lbfgs`` state).  Floating leaves are cast to ``dtype``, the
        two counts to int32; the memory size is read from the shapes."""
        n = len(dataclasses.fields(param_cls))
        if len(leaves) != 5 * n + 7:
            raise ValueError(f"an L-BFGS state over {param_cls.__name__} has {5 * n + 7} "
                             f"leaves, got {len(leaves)}")
        shapes = tuple(tuple(np.shape(a)) for a in leaves[1:1 + n])

        def t(a, dt=dtype):
            return torch.tensor(np.array(a, order="C"), device=device).to(dt).contiguous()

        def flat(trees, lead=()):
            return torch.cat([t(a).reshape(lead + (-1,)) for a in trees], dim=-1)

        m = int(np.shape(leaves[1 + 4 * n])[0])
        i = 1
        params, updates = flat(leaves[i:i + n]), flat(leaves[i + n:i + 2 * n])
        i += 2 * n
        dpm, dum = flat(leaves[i:i + n], (m,)), flat(leaves[i + n:i + 2 * n], (m,))
        i += 2 * n
        weights, lr, value = t(leaves[i]), t(leaves[i + 1]), t(leaves[i + 2])
        i += 3
        grad = flat(leaves[i:i + n])
        i += n
        return cls(count=t(leaves[0], torch.int32).reshape(()), params=params, updates=updates,
                   diff_params_memory=dpm, diff_updates_memory=dum, weights_memory=weights,
                   learning_rate=lr.reshape(()), value=value.reshape(()), grad=grad,
                   num_linesearch_steps=t(leaves[i], torch.int32).reshape(()),
                   decrease_error=t(leaves[i + 1]).reshape(()),
                   curvature_error=t(leaves[i + 2]).reshape(()),
                   param_cls=param_cls, shapes=shapes)


def direction(g: torch.Tensor, x: torch.Tensor, state: LBFGSState):
    """``scale_by_lbfgs`` then ``scale(-1)``, on the device: the memory
    updated with the point ``x`` and its (masked) gradient ``g``, and the
    descent direction -P g by the two-loop recursion.  Returns
    (direction, diff_params_memory, diff_updates_memory, weights_memory)."""
    m = state.memory_size
    count = state.count.long()
    started = count > 0
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    diff_params = torch.where(started, x - state.params, zero)
    diff_updates = torch.where(started, g - state.updates, zero)
    vdot = torch.dot(diff_updates, diff_params)
    weight = torch.where(started & (vdot != 0), 1.0 / vdot, zero)
    prev = torch.remainder(count - 1, m).reshape(1)
    dpm = state.diff_params_memory.index_copy(0, prev, diff_params[None])
    dum = state.diff_updates_memory.index_copy(0, prev, diff_updates[None])
    wm = state.weights_memory.index_copy(0, prev, weight.reshape(1))
    # gamma: <s, y> / <y, y> of the newest pair, min(1, 1/|g|) on the first step
    denominator = torch.dot(diff_updates, diff_updates)
    scale = torch.where(denominator > 0, vdot / denominator, torch.ones_like(zero))
    scale = torch.where(started, scale, torch.clamp(1.0 / torch.sqrt(torch.dot(g, g)), max=1.0))
    # the two-loop recursion over the memory, oldest entry first
    idx = torch.remainder(count + torch.arange(m, device=x.device), m)
    dw, du, rho = dpm.index_select(0, idx), dum.index_select(0, idx), wm.index_select(0, idx)
    vec, alphas = g, [None] * m
    for i in reversed(range(m)):
        alphas[i] = rho[i] * torch.dot(dw[i], vec)
        vec = vec + (-alphas[i]) * du[i]
    vec = scale * vec
    for i in range(m):
        beta = rho[i] * torch.dot(du[i], vec)
        vec = vec + (alphas[i] - beta) * dw[i]
    return -vec, dpm, dum, wm


class LineSearchResult(NamedTuple):
    stepsize: np.floating
    value: np.floating
    grad: torch.Tensor
    num_steps: int
    decrease_error: np.floating
    curvature_error: np.floating


def _cubicmin(a, fa, fpa, b, fb, c, fc, one):
    """optax's ``_cubicmin``: a critical point of the cubic through (a, fa)
    with slope fpa at a, (b, fb) and (c, fc); NaN when there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * (dc * dc)) * v0 + db * (db * db) * v1) / denom
    radical = B * B - one * 3 * A * C
    return a + (-B + np.sqrt(radical)) / (one * 3 * A)


def _quadmin(a, fa, fpa, b, fb, one):
    """optax's ``_quadmin``: the critical point of the quadratic through
    (a, fa) with slope fpa at a and (b, fb)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (one * 2 * B)


def zoom_linesearch(evaluate: Callable, value_init, slope_init, grad_init: torch.Tensor,
                    dtype: np.dtype, max_steps: int = MAX_LINESEARCH_STEPS) -> LineSearchResult:
    """``optax.zoom_linesearch`` from step size 1 (``initial_guess_strategy
    ='one'``), its state machine on the host.

    ``evaluate(stepsize) -> (value, grad, slope)`` gives the objective, its
    gradient (a device tensor, kept as it is) and the slope along the
    direction at ``params + stepsize * direction``, value and slope as
    numpy scalars of ``dtype``.  ``value_init`` and ``slope_init`` are those
    at step 0, with the (masked) gradient ``grad_init``."""
    f = np.dtype(dtype).type
    one, zero, inf = f(1), f(0), f(np.inf)
    tol = zero
    slope_rtol, curv_rtol, approx_rtol = f(SLOPE_RTOL), f(CURV_RTOL), f(APPROX_DEC_RTOL)
    approx_slope_rtol = f(2 * SLOPE_RTOL - 1.0)
    increase, threshold = f(INCREASE_FACTOR), f(INTERVAL_THRESHOLD)

    def decrease_error(stepsize, value, slope):
        err = value - value_init - slope_rtol * stepsize * slope_init
        approx = slope - approx_slope_rtol * slope_init
        delta_values = value - value_init - approx_rtol * np.abs(value_init)
        err = np.minimum(np.maximum(approx, delta_values), err)
        err = np.maximum(err, zero)
        return inf if np.isnan(err) else err

    def curvature_error(slope):
        err = np.maximum(np.abs(slope) - curv_rtol * np.abs(slope_init), zero)
        return inf if np.isnan(err) else err

    s = dict(count=0, stepsize=zero, value=f(value_init), grad=grad_init, slope=slope_init,
             decrease_error=inf, curvature_error=inf, interval_found=False, done=False,
             failed=False, low=zero, value_low=value_init, slope_low=slope_init, high=zero,
             value_high=value_init, slope_high=slope_init, cubic_ref=zero,
             value_cubic_ref=value_init, safe_stepsize=zero, safe_value=value_init,
             safe_grad=grad_init)

    def search_interval():
        it = s["count"]
        new = one if it == 0 else increase * s["stepsize"]
        value, grad, slope = evaluate(new)
        dec, curv = decrease_error(new, value, slope), curvature_error(slope)
        error = np.maximum(dec, curv)
        if dec <= tol:
            s.update(safe_stepsize=new, safe_value=value, safe_grad=grad)
        high_to_new = bool(dec > 0) or bool(value >= s["value"] and it > 0)
        low_to_new = bool(slope >= 0) and not high_to_new
        prev = (s["stepsize"], s["value"], s["slope"])
        low, high = ((new, value, slope), prev) if low_to_new else (prev, (new, value, slope))
        done = bool(error <= tol)
        s.update(low=low[0], value_low=low[1], slope_low=low[2], high=high[0],
                 value_high=high[1], slope_high=high[2], cubic_ref=low[0],
                 value_cubic_ref=low[1],
                 interval_found=high_to_new or low_to_new or done, done=done,
                 failed=(it + 1 >= max_steps) and not done)
        return new, value, grad, slope, dec, curv

    def zoom():
        it = s["count"]
        low, high = s["low"], s["high"]
        value_low, slope_low = s["value_low"], s["slope_low"]
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        cubic_chk, quad_chk = f(0.2) * delta, f(0.1) * delta
        too_small = bool(delta <= threshold)
        cubic = _cubicmin(low, value_low, slope_low, high, s["value_high"], s["cubic_ref"],
                          s["value_cubic_ref"], one)
        use_cubic = bool(cubic > left + cubic_chk) and bool(cubic < right - cubic_chk)
        quad = _quadmin(low, value_low, slope_low, high, s["value_high"], one)
        use_quad = not use_cubic and bool(quad > left + quad_chk) and bool(quad < right - quad_chk)
        middle = cubic if use_cubic else quad if use_quad else (low + high) / f(2)
        value, grad, slope = evaluate(middle)
        dec, curv = decrease_error(middle, value, slope), curvature_error(slope)
        error = np.maximum(dec, curv)
        if dec <= tol and value < s["safe_value"]:
            s.update(safe_stepsize=middle, safe_value=value, safe_grad=grad)
        done = bool(error <= tol)
        high_to_middle = bool(dec > 0) or bool(value >= value_low)
        high_to_low = bool(slope * (high - low) >= 0) and not high_to_middle
        mid = (middle, value, slope)
        new_high = (low, value_low, slope_low) if high_to_low else (
            mid if high_to_middle else (high, s["value_high"], s["slope_high"]))
        new_low = (low, value_low, slope_low) if high_to_middle else mid
        cubic_ref = (high, s["value_high"]) if high_to_middle or high_to_low else (
            low, value_low)
        failed = (it + 1 >= max_steps) or (too_small and bool(s["safe_stepsize"] > 0))
        s.update(low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
                 high=new_high[0], value_high=new_high[1], slope_high=new_high[2],
                 cubic_ref=cubic_ref[0], value_cubic_ref=cubic_ref[1], done=done,
                 failed=failed and not done)
        return middle, value, grad, slope, dec, curv

    with np.errstate(all="ignore"):
        while not (s["done"] or s["failed"]):
            new, value, grad, slope, dec, curv = zoom() if s["interval_found"] else (
                search_interval())
            s.update(count=s["count"] + 1, stepsize=new, value=value, grad=grad, slope=slope,
                     decrease_error=dec, curvature_error=curv)
            if s["failed"] and (s["safe_stepsize"] > 0 or np.isinf(dec)):
                # the safe step: the best of sufficient decrease seen (0 when
                # none, or when every candidate left the domain)
                s.update(stepsize=s["safe_stepsize"], value=s["safe_value"],
                         grad=s["safe_grad"])
    return LineSearchResult(f(s["stepsize"]), f(s["value"]), s["grad"], s["count"],
                            f(s["decrease_error"]), f(s["curvature_error"]))
