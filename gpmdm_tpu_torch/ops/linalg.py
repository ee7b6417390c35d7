"""Cholesky-based linear algebra for the MAP loss.

Counterpart of ``gpmdm_tpu/ops/linalg.py``: the loss factors its Gram
matrices with ``torch.linalg.cholesky_ex`` and evaluates ``trace(K^-1 S)``
terms with triangular solves, never with explicit inverses.  Every function
takes a leading batch of matrices as well as one matrix.

Two rules from the JAX package hold on the card too:

- A matrix that is not positive definite factors to NaN, as JAX's Cholesky
  does, so the trainer's finite-step freeze sees what JAX's sees.
  ``cholesky_ex`` reports the failure on the device (``info > 0``) and
  ``torch.where`` turns it into NaN there: no step waits on the host.
- float32 products stay in full fp32: nothing here lowers
  ``torch.set_float32_matmul_precision`` or enables TF32.
"""

from __future__ import annotations

import torch

#: Relative diagonal floor per dtype (the JAX package's ``_REL_JITTER``):
#: reduced-precision factorizations of ill-conditioned Grams need jitter
#: proportional to the diagonal scale.  float64 gets none.
_REL_JITTER = {
    torch.float32: 1e-5,
    torch.bfloat16: 1e-2,
}


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of K.  Where K is not positive definite the
    factor is NaN on and below the diagonal and zero above it, as JAX's."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info > 0)[..., None, None], torch.full_like(L, float("nan")).tril(), L)


def chol_lower(K: torch.Tensor, jitter: float = 0.0,
               floor_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Lower Cholesky factor of K (+ jitter * I + dtype-relative floor).

    The relative floor (f32: 1e-5 x the mean diagonal) is what keeps f32
    factorizations of near-singular trained dynamics Grams finite.  It is
    that of K's dtype, or of ``floor_dtype`` when given (a float64
    evaluation of a float32 objective).
    """
    eps_rel = _REL_JITTER.get(floor_dtype or K.dtype, 0.0)
    if jitter or eps_rel:
        total = jitter
        if eps_rel:
            total = total + eps_rel * torch.diagonal(K, dim1=-2, dim2=-1).mean(-1)
        if torch.is_tensor(total):
            total = total[..., None, None]
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
        K = K + total * eye
    return cholesky(K)


def chol_logdet(L: torch.Tensor) -> torch.Tensor:
    """log|K| from the lower Cholesky factor L of K."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve K x = B given the lower Cholesky factor L of K."""
    return torch.cholesky_solve(B, L)


def chol_inverse(L: torch.Tensor) -> torch.Tensor:
    """Explicit K^-1 from the lower Cholesky factor L."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.cholesky_solve(eye.expand_as(L), L)


def tri_solve(L: torch.Tensor, B: torch.Tensor, lower: bool = True) -> torch.Tensor:
    """Triangular solve L x = B."""
    return torch.linalg.solve_triangular(L, B, upper=not lower)


def quad_trace(L: torch.Tensor, Y: torch.Tensor, col_weights: torch.Tensor) -> torch.Tensor:
    """``trace(K^-1 Y diag(col_weights) Y^T)`` via a triangular solve:
    ``sum_j col_weights[j] * y_j^T K^-1 y_j`` without forming K^-1."""
    A = tri_solve(L, Y)
    return torch.sum(torch.sum(A * A, dim=-2) * col_weights, dim=-1)
