"""Collective counts of the distribution layer's programs.

Counterpart of ``gpmdm_tpu/parallel/inspect.py``.  The JAX package counts
collective primitives STATICALLY in a traced jaxpr; torch has no jaxpr, so
``count_collectives_jaxpr`` has no counterpart here.  Instead
:func:`count_collectives` RUNS the function and returns the calls that the
port's wrappers (``parallel.collectives``) counted, under the JAX
package's names.  The count is dynamic: a collective inside a loop counts
once per trip, so a pinned table holds for the shapes it was taken at
(one training step, one scan).  Call it on every rank: the function runs
its collectives.
"""

from __future__ import annotations

from typing import Callable

from . import collectives

#: Cross-device communication primitives by their JAX names (the JAX
#: package's set).  The port's wrappers count under ``psum``,
#: ``all_gather`` and ``pbroadcast``.
COLLECTIVE_PRIMS = frozenset(
    {
        "psum",
        "psum_scatter",
        "all_gather",
        "all_gather_invariant",
        "all_to_all",
        "ppermute",
        "pmax",
        "pmin",
        "pgather",
        "pbroadcast",
        "reduce_scatter",
        "psum_invariant",
    }
)


def count_collectives(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` and return {collective: calls made}, the
    collectives that were not called left out.  The function's result is
    dropped."""
    before = collectives.COUNTS.copy()
    fn(*args, **kwargs)
    return dict(collectives.COUNTS - before)
