"""Host-side (numpy, float64) versions of the GP kernels in ops/kernels.py.

``models.core.precompute_host`` and ``models.sparse.precompute_host``
factor the trained Gram matrices once in f64 on the host with these and
deploy the results in the model dtype.
A numpy copy of ``gpmdm_tpu/ops/kernels_host.py``: the same formulas, so
both packages build bit-identical posteriors from one checkpoint.
"""

from __future__ import annotations

import numpy as np


def f64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64)


def rbf(A: np.ndarray, B: np.ndarray, lengthscales: np.ndarray) -> np.ndarray:
    """Unit-signal-variance RBF (ops/kernels.rbf_kernel; reference
    gpmdm.py:436-517)."""
    d = (A[:, None, :] - B[None, :, :]) / lengthscales
    return np.exp(-np.sum(d * d, axis=2))


def linear(A: np.ndarray, B: np.ndarray, lin_w2: np.ndarray) -> np.ndarray:
    """Homogeneous linear kernel with squared weights lin_w2 = exp(coeff)^2
    (ops/kernels.linear_kernel; reference gpmdm.py:520-548)."""
    return (A * lin_w2[:-1]) @ B.T + lin_w2[-1]


def x_kernel(A: np.ndarray, B: np.ndarray, lengthscales: np.ndarray,
             lin_w2: np.ndarray) -> np.ndarray:
    """Dynamics kernel RBF + linear, no noise (ops/kernels.x_kernel)."""
    return rbf(A, B, lengthscales) + linear(A, B, lin_w2)



def class_xin_xout(X: np.ndarray, layout, cfg, pads: dict):
    """Padded per-class (Xin_c, Xout_c, mask) from the latent matrix, with
    ``pads`` from ``ops.layout.padded_class_indices``: the dynamics inputs
    and targets of each class, zero past its count (``models.sparse``
    builds its inducing inputs and per-class factors from them)."""
    mask = pads["mask"]
    x_t = X[pads["idx_in"]] * mask[:, :, None]
    if cfg.dyn_back_step == 1:
        Xin_c = x_t
    else:
        Xin_c = np.concatenate([x_t, X[pads["idx_prev"]] * mask[:, :, None]], axis=2)
    Xout_c = X[pads["idx_out"]] * mask[:, :, None]
    if cfg.dyn_target == "delta":
        Xout_c = Xout_c - x_t
    return Xin_c, Xout_c, mask
