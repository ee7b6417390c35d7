"""The port's collectives: thin, counted wrappers over ``torch.distributed``.

Every collective of the distribution layer goes through this module.  Each
wrapper adds one to ``COUNTS`` under the name of the JAX collective it
stands for (``psum``, ``all_gather``, ``pbroadcast``), so that
``parallel.inspect.count_collectives`` can return the counts of a real run.
No wrapper is differentiable: gradients never pass through a collective
(see ``parallel.sharded``), except inside ``dist_chol.y_nll_dist``'s own
``torch.autograd.Function``.  Every rank of the group must make the same
calls in the same order.  A group of one rank still makes its calls, so
the counts depend on the design alone, not on the mesh's size.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

#: Calls made by this process, by JAX collective name.
COUNTS: Counter = Counter()

# ``all_gather_single`` replaces the deprecated ``all_gather_into_tensor``
# in newer torch; older torch has only the latter.
_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _require_contiguous(t: torch.Tensor) -> None:
    # a collective moves raw memory: a transposed layout would be read as
    # another matrix on the other ranks
    if not t.is_contiguous():
        raise ValueError("an in-place collective needs a contiguous tensor")


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place and return it: JAX's ``psum``."""
    _require_contiguous(t)
    COUNTS["psum"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order: JAX's
    tiled ``all_gather``."""
    COUNTS["all_gather"] += 1
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    _gather_single(out, x, group=group)
    return out.movedim(0, dim)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Rank ``src``'s ``t`` (``src`` counted within ``group``) written into
    every rank's ``t`` in place, and returned.  JAX's package writes it as
    a masked ``psum``; it is counted as ``pbroadcast``."""
    _require_contiguous(t)
    COUNTS["pbroadcast"] += 1
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t
