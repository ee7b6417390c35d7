"""Distributed blocked Cholesky and triangular solve over a process group.

Counterpart of ``gpmdm_tpu/parallel/dist_chol.py``.  The (N, N) matrix is
sharded by row panels: rank i of the group holds rows [i nb, (i + 1) nb),
nb = N / group size.  The factorization is right-looking: at block step k
the updated column panel is all-gathered, every still-active rank factors
the (nb, nb) diagonal block itself (cheap, redundant) and forms the panel,
and each rank below block k takes its rank-nb update of its own trailing
rows, one GEMM.  Communication is one panel all-gather a block step; the
O(N^3) work is spread over the ranks.  Where the JAX package is
branch-free SPMD with masks, a rank here skips the work that the masks
would discard; every rank still makes every collective.

:func:`y_nll_dist` wraps the observation NLL core in a
``torch.autograd.Function`` whose backward is the closed-form adjoint

    d/dK [ D/2 logdet K + 1/2 tr(K^-1 Y W Y^T) ]
        = D/2 K^-1 - 1/2 K^-1 Y W Y^T K^-1,

evaluated with the same distributed kernels (one distributed triangular
solve against I, three all-gathers), instead of differentiating through
the factorization loop.

Products stay in full fp32 for float32 inputs (no TF32), as
``ops/linalg.py`` requires: the JAX package pins "highest" here for the
same reason.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import linalg as LA
from . import collectives as C


def _blocks(A_i: torch.Tensor, group) -> tuple[int, int, int]:
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    nb, N = A_i.shape[0], A_i.shape[1]
    if N != nb * n:
        raise ValueError(f"a row panel of shape {tuple(A_i.shape)} over {n} ranks")
    return n, idx, nb


def chol_rowblock(A_i: torch.Tensor, group) -> torch.Tensor:
    """Distributed lower Cholesky of a row-panel-sharded SPD matrix.

    ``A_i``: this rank's (nb, N) row panel of A.  Returns this rank's
    (nb, N) row panel of L.  A block that is not positive definite factors
    to NaN (``linalg.cholesky``), which spreads to every later panel."""
    n, idx, nb = _blocks(A_i, group)
    A_i = A_i.clone()
    L_i = torch.zeros_like(A_i)
    for k in range(n):
        cols = slice(k * nb, (k + 1) * nb)
        col = C.all_gather(A_i[:, cols], group)  # (N, nb), updated
        if idx < k:
            continue  # this rank's rows are final
        L_kk = LA.cholesky(col[cols])
        if idx == k:
            L_i[:, cols] = L_kk
            continue
        # the panel below block k: P = col L_kk^-T, rows after block k
        P_rest = torch.linalg.solve_triangular(L_kk.mT, col[(k + 1) * nb:], upper=True,
                                               left=False)
        P_own = P_rest[(idx - k - 1) * nb:(idx - k) * nb]
        L_i[:, cols] = P_own
        A_i[:, (k + 1) * nb:] -= P_own @ P_rest.mT
    return L_i


def tri_solve_lower_rowblock(L_i: torch.Tensor, B_i: torch.Tensor, group) -> torch.Tensor:
    """Distributed forward substitution, L X = B.

    ``L_i``: (nb, N) local row panel of lower-triangular L; ``B_i``: (nb,
    D) local row block of the right-hand side.  Returns X_i (nb, D).  One
    (nb, D) broadcast a block step, from the rank that solved it."""
    n, idx, nb = _blocks(L_i, group)
    acc = B_i.clone()
    X_i = torch.zeros_like(B_i)
    for k in range(n):
        L_ik = L_i[:, k * nb:(k + 1) * nb]  # the diagonal block on rank k
        if idx == k:
            X_i = LA.tri_solve(L_ik, acc)
            Xk = X_i.clone(memory_format=torch.contiguous_format)
        else:
            Xk = B_i.new_empty(B_i.shape)
        C.broadcast(Xk, k, group)
        if idx > k:
            acc = acc - L_ik @ Xk
    return X_i


class _YNllDist(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K_i, Y_i, w2, group):
        D = Y_i.shape[1]
        L_i = chol_rowblock(K_i, group)
        _, idx, nb = _blocks(L_i, group)
        logdet_local = 2.0 * torch.sum(torch.log(torch.diagonal(L_i[:, idx * nb:(idx + 1) * nb])))
        V_i = tri_solve_lower_rowblock(L_i, Y_i, group)  # L^-1 Y, this rank's rows
        quad_local = torch.sum(V_i * V_i, dim=0)  # (D,) this rank's share
        ctx.group = group
        ctx.save_for_backward(L_i, Y_i, w2, quad_local)
        return 0.5 * D * logdet_local + 0.5 * torch.sum(w2 * quad_local)

    @staticmethod
    def backward(ctx, g):
        # g, the cotangent of this rank's share, must be the same on every
        # rank of the group (true for a sum of shares); the adjoint below
        # is the gradient of the SUMMED value, so the sharded inputs get
        # their own panels and the replicated w2 this rank's share of it.
        L_i, Y_i, w2, quad_local = ctx.saved_tensors
        group = ctx.group
        _, idx, nb = _blocks(L_i, group)
        D = Y_i.shape[1]
        own = slice(idx * nb, (idx + 1) * nb)
        eye_i = torch.zeros_like(L_i)
        eye_i[:, own] = torch.eye(nb, dtype=L_i.dtype, device=L_i.device)
        Z = C.all_gather(tri_solve_lower_rowblock(L_i, eye_i, group), group)  # L^-1, (N, N)
        Kinv_i = Z[:, own].mT @ Z  # this rank's row panel of K^-1 = Z^T Z
        alpha_i = Kinv_i @ C.all_gather(Y_i, group)  # K^-1 Y, own rows
        alpha = C.all_gather(alpha_i, group)
        dK_i = g * (0.5 * D * Kinv_i - 0.5 * (alpha_i * w2) @ alpha.mT)
        dY_i = g * alpha_i * w2
        dw2 = g * 0.5 * quad_local
        return dK_i, dY_i, dw2, None


def y_nll_dist(K_i: torch.Tensor, Y_i: torch.Tensor, w2: torch.Tensor, group) -> torch.Tensor:
    """This rank's LOCAL SHARE of the distributed observation NLL core; the
    shares summed over the group give

        D/2 logdet(K) + 1/2 sum_j w2_j y_j^T K^-1 y_j

    with K row-panel sharded ((nb, N) a rank) and Y row-sharded ((nb, D) a
    rank); w2 = exp(y_log_lambdas)^2 is replicated.  The -N log|W| term
    stays with the caller.  Differentiable in K_i, Y_i and w2 through the
    closed-form adjoint; the backward needs the same cotangent on every
    rank (any sum of shares gives it) and runs collectives, so every rank
    calls it."""
    return _YNllDist.apply(K_i, Y_i, w2, group)
