"""Fused exact-GP posterior: star kernel -> mean + variance quad, in one pass.

Counterpart of ``gpmdm_tpu/ops/pallas/gp_posterior.py``.  The particle
filter's per-frame cost is the GP posterior over all particles:

    Kstar = k(Xtrain, Xstar)              # (N, P)
    mean  = Kstar^T @ A                   # (P, Dout)
    quad  = sum(Kstar * (Kinv @ Kstar), 0)  # (P,)
    var   = kdiag - quad                  # by the caller

Each public function has two versions:

- the CUDA kernel (``csrc/gp_posterior.cu``, built by ``_build``), which
  keeps Kstar in shared memory and writes only the outputs; the wrapper
  takes it for tensors on the card and launches it or raises;
- a plain PyTorch version (``*_plain``) with the same arithmetic, taken
  for tensors on the CPU and used as the kernel's reference on the card.

The kernels take and compute IEEE fp32; the plain versions run in their
inputs' dtype.  Both sum squared distances by per-dimension differences,
never by the norm expansion, and mask padded training rows to exactly 0.  ``LAUNCHES`` counts kernel launches per
function, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import torch

#: Kernel launches per public function since the last ``reset_launches``.
LAUNCHES = {"fused_x_posterior": 0, "fused_rbf_posterior": 0, "fused_obs_loglik": 0}

#: What a launcher returns when one block's star tile does not fit in the
#: card's shared memory (``SMEM_TOO_LARGE`` in csrc/gp_posterior.cu).
SMEM_TOO_LARGE = -1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------- plain versions


def _star_plain(xt, xs, n_valid: int, lt=None, ls=None, bias=None):
    """(N, P) star kernel from pre-scaled inputs; rows >= n_valid are 0."""
    sq = torch.zeros(xt.shape[0], xs.shape[0], dtype=xt.dtype, device=xt.device)
    for k in range(xt.shape[1]):
        diff = xt[:, k, None] - xs[None, :, k]
        sq = sq + diff * diff
    ks = torch.exp(-sq)
    if lt is not None:
        ks = ks + lt @ ls.T + bias
    rows = torch.arange(xt.shape[0], device=xt.device) < n_valid
    return torch.where(rows[:, None], ks, torch.zeros((), dtype=ks.dtype, device=ks.device))


def _mean_quad(ks, A, Kinv):
    return ks.T @ A, torch.sum(ks * (Kinv @ ks), dim=0)


def fused_rbf_posterior_plain(Xtrain, Xstar, Ay, Kinv, inv_lengthscales):
    ks = _star_plain(Xtrain * inv_lengthscales, Xstar * inv_lengthscales,
                     Xtrain.shape[0])
    return _mean_quad(ks, Ay, Kinv)


def fused_x_posterior_plain(Xin_c, Xstar, Axc, Kxc_inv, inv_lengthscales,
                            lin_w, n_valid: int):
    w = lin_w[:-1]
    ks = _star_plain(Xin_c * inv_lengthscales, Xstar * inv_lengthscales,
                     n_valid, Xin_c * w, Xstar * w, lin_w[-1] ** 2)
    return _mean_quad(ks, Axc, Kxc_inv)


def fused_obs_loglik_plain(Xtrain, Xstar, Ay, Kinv, inv_lengthscales, z, lam2):
    mean, quad = fused_rbf_posterior_plain(Xtrain, Xstar, Ay, Kinv, inv_lengthscales)
    zb = z.reshape(-1, z.shape[-1])  # (B, D): one row per bank
    diff = mean.reshape(zb.shape[0], -1, zb.shape[1]) - zb[:, None, :]
    qres = torch.sum(lam2 * diff * diff, dim=2).reshape(-1)
    return quad, qres


# ------------------------------------------------------------ CUDA wrappers


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(name: str, device, **shapes) -> None:
    """Every input: on ``device``, float32, contiguous, of the given shape."""
    for arg, (t, shape) in shapes.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _raise_on_error(name: str, rc: int, smem_bytes) -> None:
    """Raise for a launcher's non-zero return; ``smem_bytes()`` gives the
    shared memory one block of the call's shape needs."""
    if rc == SMEM_TOO_LARGE:
        raise ValueError(
            f"{name}: the fused posterior does not fit in shared memory: one block "
            f"needs {smem_bytes()} bytes, more than this card lets a block use. The "
            "kernel keeps the star kernel of its particle tile over all training "
            "rows on chip; use a sparse or compressed posterior at this size"
        )
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {rc}")


def _posterior_cuda(name, Xtrain, Xstar, A, Kinv, inv_ls, lin_w, n_valid,
                    has_linear):
    from ._build import library

    N, d = Xtrain.shape
    P, Dout = Xstar.shape[0], A.shape[1]
    dev = Xstar.device
    shapes = dict(Xtrain=(Xtrain, (N, d)), Xstar=(Xstar, (P, d)), A=(A, (N, Dout)),
                  Kinv=(Kinv, (N, N)), inv_lengthscales=(inv_ls, (d,)))
    if has_linear:
        shapes["lin_w"] = (lin_w, (d + 1,))
    _check(name, dev, **shapes)
    if not 0 <= n_valid <= N or N < 1:
        raise ValueError(f"{name}: need 1 <= N and 0 <= n_valid <= N, got N={N}, n_valid={n_valid}")
    mean = torch.empty(P, Dout, dtype=torch.float32, device=dev)
    quad = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return mean, quad
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gp_posterior_launch(
            Xtrain.data_ptr(), Xstar.data_ptr(), inv_ls.data_ptr(),
            lin_w.data_ptr() if has_linear else None, A.data_ptr(), Kinv.data_ptr(),
            mean.data_ptr(), quad.data_ptr(), N, P, d, Dout, n_valid,
            int(has_linear), stream)
    _raise_on_error(name, rc, lambda: lib.gp_smem_bytes(N, d, Dout, int(has_linear), 0))
    LAUNCHES[name] += 1
    return mean, quad


def fused_rbf_posterior(Xtrain, Xstar, Ay, Kinv, inv_lengthscales):
    """Observation-GP posterior: (mean (P, D), quad (P,)).

    mean = Kstar^T Ay, quad = sum(Kstar * (Kinv Kstar), 0), with
    Kstar = exp(-sum_k ((xt-xs)/l)^2); the caller forms var = kdiag - quad.
    """
    if _on_cpu(Xtrain, Xstar, Ay, Kinv, inv_lengthscales):
        return fused_rbf_posterior_plain(Xtrain, Xstar, Ay, Kinv, inv_lengthscales)
    return _posterior_cuda("fused_rbf_posterior", Xtrain, Xstar, Ay, Kinv,
                           inv_lengthscales, None, Xtrain.shape[0], False)


def fused_x_posterior(Xin_c, Xstar, Axc, Kxc_inv, inv_lengthscales, lin_w,
                      n_valid: int):
    """Dynamics-GP posterior for ONE class block: (mean (P, d), quad (P,)).

    Star kernel = RBF + homogeneous linear, ``lin_w = exp(x_log_lin_coeff)``
    with the last entry the bias weight.  Rows >= ``n_valid`` are masked to
    exactly 0.  The particle filter passes ``n_valid = Xin_c.shape[0]`` and
    relies instead on the precompute's zero padding of ``Axc``/``Kxc_inv``
    past the class's true pair count.
    """
    if _on_cpu(Xin_c, Xstar, Axc, Kxc_inv, inv_lengthscales, lin_w):
        return fused_x_posterior_plain(Xin_c, Xstar, Axc, Kxc_inv,
                                       inv_lengthscales, lin_w, n_valid)
    return _posterior_cuda("fused_x_posterior", Xin_c, Xstar, Axc, Kxc_inv,
                           inv_lengthscales, lin_w, n_valid, True)


def fused_obs_loglik(Xtrain, Xstar, Ay, Kinv, inv_lengthscales, z, lam2):
    """Fused observation weighting: (quad (P,), qres (P,)).

    quad = sum(Kstar * (Kinv Kstar), 0) and
    qres = sum_j lam2_j (mean_j - z_j)^2 with mean = Kstar^T Ay kept on
    chip.  ``z`` is one observation (D,), or one per bank (B, D) for
    P = B * Pb particles laid out bank after bank: particle p is weighed
    against ``z[p // Pb]``.  The caller forms the diagonal-Gaussian
    log-likelihood from them.
    """
    if _on_cpu(Xtrain, Xstar, Ay, Kinv, inv_lengthscales, z, lam2):
        return fused_obs_loglik_plain(Xtrain, Xstar, Ay, Kinv, inv_lengthscales, z, lam2)
    from ._build import library

    name = "fused_obs_loglik"
    N, d = Xtrain.shape
    P, D = Xstar.shape[0], Ay.shape[1]
    B = z.shape[0] if z.dim() == 2 else 1
    if B < 1 or P % B:
        raise ValueError(f"{name}: {P} particles do not split into {B} banks")
    dev = Xstar.device
    _check(name, dev, Xtrain=(Xtrain, (N, d)), Xstar=(Xstar, (P, d)),
           Ay=(Ay, (N, D)), Kinv=(Kinv, (N, N)),
           inv_lengthscales=(inv_lengthscales, (d,)),
           z=(z, (B, D) if z.dim() == 2 else (D,)), lam2=(lam2, (D,)))
    if N < 1:
        raise ValueError(f"{name}: need at least one training row")
    quad = torch.empty(P, dtype=torch.float32, device=dev)
    qres = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return quad, qres
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.obs_loglik_launch(
            Xtrain.data_ptr(), Xstar.data_ptr(), inv_lengthscales.data_ptr(),
            Ay.data_ptr(), Kinv.data_ptr(), z.data_ptr(), lam2.data_ptr(),
            quad.data_ptr(), qres.data_ptr(), N, P, d, D, P // B, stream)
    _raise_on_error(name, rc, lambda: lib.gp_smem_bytes(N, d, D, 0, 1))
    LAUNCHES[name] += 1
    return quad, qres
