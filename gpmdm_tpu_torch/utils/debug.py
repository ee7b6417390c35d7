"""Numerical debugging: find the operation that first made a NaN or an Inf.

Counterpart of ``gpmdm_tpu/utils/debug.py``, which wraps a function in
``jax.experimental.checkify``.  Here a ``TorchFunctionMode`` checks the
output of every torch operation the function runs, and raises
``FloatingPointError`` naming the first one that returned a non-finite
value from finite inputs: the debugging-time counterpart of the training
loop's always-on NaN freeze (train/trainer.py).  Each check reads the
device, so this is for debugging only.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.overrides import TorchFunctionMode


def _finite(obj) -> bool:
    """Whether every floating tensor and float in ``obj`` is finite (a
    NaN passed in on purpose, as ``linalg.cholesky`` fills a failed
    factor, is an input, not a fault)."""
    if isinstance(obj, float):
        return math.isfinite(obj)
    if isinstance(obj, (list, tuple)):
        return all(_finite(o) for o in obj)
    if isinstance(obj, dict):
        return all(_finite(o) for o in obj.values())
    if torch.is_tensor(obj) and (obj.is_floating_point() or obj.is_complex()):
        return bool(torch.isfinite(obj).all())
    return True


class _FiniteMode(TorchFunctionMode):
    """Raises at the first operation whose output is not finite while its
    inputs are."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _finite(out) and _finite((args, kwargs)):
            name = getattr(func, "__qualname__", None) or getattr(func, "__name__", str(func))
            raise FloatingPointError(f"non-finite value produced by {name}")
        return out


def checked(fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)``, raising ``FloatingPointError`` at the
    first operation that produces a NaN or an Inf from finite inputs, or
    when the result is not finite; else return the result:

        loss = checked(core.nll, params, Y, cfg, layout)
    """
    with torch.no_grad(), _FiniteMode():
        out = fn(*args, **kwargs)
    if not _finite(out):
        raise FloatingPointError("non-finite result")
    return out


def check_loss(model, balance: float = 1.0) -> float:
    """The model's MAP loss under :func:`checked`: its family's loss
    (``sparse.sparse_nll`` for ``SparseParams``, else ``core.nll``) at its
    parameters, which names the operation that first went non-finite."""
    from ..models import core, sparse

    Y = torch.as_tensor(model.get_Y(), device=model.device).to(model.dtype)
    loss_fn = sparse.sparse_nll if isinstance(model.params, sparse.SparseParams) else core.nll
    return float(checked(loss_fn, model.params, Y, model.config, model.layout.to(model.device),
                         balance))
