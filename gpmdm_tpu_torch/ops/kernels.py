"""GP kernel primitives for GPMDM, as PyTorch functions on tensors.

Counterpart of ``gpmdm_tpu/ops/kernels.py``:

- RBF kernel with unit signal variance: ``exp(-(x1-x2)^T L^-2 (x1-x2))``
  with L = diag(exp(log_lengthscales)).
- Linear kernel in homogeneous coordinates:
  ``[X1,1] diag(exp(log_coeff)^2) [X2,1]^T``.
- Observation kernel K_y = RBF + (sigma_n^2 + sigma_num^2) I.
- Dynamics kernel K_x = RBF + linear (+ noise on the diagonal).

Each function also takes a leading batch of point sets (one per class).
float32 matmuls run in full fp32: the package never enables TF32.
"""

from __future__ import annotations

import torch


def weighted_sqdist(X1: torch.Tensor, X2: torch.Tensor,
                    log_lengthscales: torch.Tensor) -> torch.Tensor:
    """``dist[i,j] = sum_k ((X1[i,k]-X2[j,k]) / exp(log_lengthscales[k]))^2``

    By the expansion |a|^2 + |b|^2 - 2 a.b, as the JAX package computes it.
    """
    inv_ls = torch.exp(-log_lengthscales)
    A = X1 * inv_ls
    B = X2 * inv_ls
    a2 = torch.sum(A * A, dim=-1, keepdim=True)
    b2 = torch.sum(B * B, dim=-1, keepdim=True)
    return a2 + b2.mT - 2.0 * (A @ B.mT)


def rbf_kernel(X1, X2, log_lengthscales, log_sigma_n=None, sigma_n_num: float = 0.0,
               with_noise: bool = False) -> torch.Tensor:
    """Unit-signal-variance RBF kernel; optional diagonal noise (square use only)."""
    K = torch.exp(-weighted_sqdist(X1, X2, log_lengthscales))
    if with_noise:
        noise = torch.exp(log_sigma_n) ** 2 + sigma_n_num**2
        K = K + noise * torch.eye(X1.shape[-2], dtype=K.dtype, device=K.device)
    return K


def linear_kernel(X1, X2, log_lin_coeff) -> torch.Tensor:
    """Homogeneous linear kernel ``[X1,1] diag(exp(c)^2) [X2,1]^T``; the last
    coefficient weighs the constant feature."""
    w = torch.exp(log_lin_coeff) ** 2
    return (X1 * w[:-1]) @ X2.mT + w[-1]


def y_kernel(X1, X2, log_lengthscales, log_sigma_n, sigma_n_num: float = 0.0,
             with_noise: bool = True) -> torch.Tensor:
    """Observation (latent -> observation map) kernel K_y."""
    return rbf_kernel(X1, X2, log_lengthscales, log_sigma_n, sigma_n_num, with_noise)


def x_kernel(X1, X2, log_lengthscales, log_sigma_n, log_lin_coeff,
             sigma_n_num: float = 0.0, with_noise: bool = True) -> torch.Tensor:
    """Dynamics kernel K_x = RBF + linear."""
    K = rbf_kernel(X1, X2, log_lengthscales, log_sigma_n, sigma_n_num, with_noise)
    return K + linear_kernel(X1, X2, log_lin_coeff)


def y_diag_kernel(X, log_sigma_n, sigma_n_num: float = 0.0,
                  with_noise: bool = False) -> torch.Tensor:
    """Diagonal of K_y(X, X): the RBF diagonal is exactly 1."""
    diag = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    if with_noise:
        diag = diag + torch.exp(log_sigma_n) ** 2 + sigma_n_num**2
    return diag


def x_diag_kernel(X, log_lin_coeff, log_sigma_n, sigma_n_num: float = 0.0,
                  with_noise: bool = False) -> torch.Tensor:
    """Diagonal of K_x(X, X): 1 + [x,1] diag(exp(c)^2) [x,1]^T (+ noise)."""
    w = torch.exp(log_lin_coeff) ** 2
    diag = 1.0 + (torch.sum(X * X * w[:-1], dim=-1) + w[-1])
    if with_noise:
        diag = diag + torch.exp(log_sigma_n) ** 2 + sigma_n_num**2
    return diag
