"""The SGPR prediction on the per-frame solve path, as one kernel (K4).

For M inducing inputs ``Z`` of one GP (M, din), or of C class GPs
(C, M, din), and points ``Xstar`` (P, din):

    Kstar = k(Z, Xstar)                    # (..., M, P): RBF [+ linear]
    kss   = diag k(Xstar, Xstar) [+ noise] # (P,)
    mean  = Kstar^T beta                   # (..., P, Dout)
    v1 = Lm^-1 Kstar,  v2 = LB^-1 v1       # forward substitution
    var   = clamp(kss - |v1|^2 + |v2|^2, min=1e-12)   # (..., P)

with the observation GP's kernel (``log_lin_coeff`` None) or the dynamics
GP's RBF + homogeneous linear kernel (``models/sparse.py`` has the
derivation).  Two versions:

- the CUDA kernel (``csrc/sgpr_predict.cu``, built by ``_build``), which
  keeps the star column, v1 and v2 on the chip and writes only the mean
  and the variance, every class in one launch, for any M (past what
  shared memory holds, in a global scratch buffer that the wrapper keeps);
  the wrapper takes it for tensors on the card (float32) and launches it
  or raises;
- the plain PyTorch version (``sgpr_predict_plain``): the star block and
  two ``torch.linalg.solve_triangular`` calls, taken for tensors on the
  CPU and used as the kernel's reference on the card.

Each launch on the card runs in the span ``ops.k4`` and adds one to the
counter ``ops.k4.launches`` (``utils.profiling``).
"""

from __future__ import annotations

import ctypes
import struct

import torch

from ..utils.profiling import counter, span
from . import kernels as K
from .gp_posterior import _check, _on_cpu, _raise_on_error, _sm_count


def star_block(Z, Xstar, log_lengthscales, log_sigma_n, sigma_n_num: float = 0.0,
               with_noise: bool = False, log_lin_coeff=None):
    """The star kernel against the inducing inputs (..., M, P) and the
    star prior diagonal (P,): the observation GP's RBF and ``y_diag_kernel``
    when ``log_lin_coeff`` is None, else the dynamics GP's RBF + linear and
    ``x_diag_kernel``."""
    if log_lin_coeff is None:
        Kstar = K.rbf_kernel(Z, Xstar, log_lengthscales)
        return Kstar, K.y_diag_kernel(Xstar, log_sigma_n, sigma_n_num, with_noise)
    kss = K.x_diag_kernel(Xstar, log_lin_coeff, log_sigma_n, sigma_n_num, with_noise)
    Kstar = K.x_kernel(Z, Xstar, log_lengthscales, log_sigma_n, log_lin_coeff,
                       with_noise=False)
    return Kstar, kss


def sgpr_predict_plain(Z, Xstar, Lm, LB, beta, log_lengthscales, log_sigma_n,
                       sigma_n_num: float = 0.0, with_noise: bool = False,
                       log_lin_coeff=None):
    """The predictive mean (..., P, Dout) and common variance (..., P) by
    the star block and two triangular solves, in the inputs' dtype."""
    Kstar_m, kss_diag = star_block(Z, Xstar, log_lengthscales, log_sigma_n, sigma_n_num,
                                   with_noise, log_lin_coeff)
    mean = Kstar_m.mT @ beta
    v1 = torch.linalg.solve_triangular(Lm, Kstar_m, upper=False)  # (..., M, N*)
    v2 = torch.linalg.solve_triangular(LB, v1, upper=False)
    s1, s2 = torch.sum(v1.square_(), dim=-2), torch.sum(v2.square_(), dim=-2)
    return mean, torch.clamp(kss_diag - s1 + s2, min=1e-12)


def sgpr_predict(Z, Xstar, Lm, LB, beta, log_lengthscales, log_sigma_n,
                 sigma_n_num: float = 0.0, with_noise: bool = False, log_lin_coeff=None):
    """What :func:`sgpr_predict_plain` computes: K4 on the card, the plain
    version for tensors on the CPU."""
    args = (Z, Xstar, Lm, LB, beta, log_lengthscales, log_sigma_n)
    if _on_cpu(*args) and (log_lin_coeff is None or _on_cpu(log_lin_coeff)):
        return sgpr_predict_plain(*args, sigma_n_num, with_noise, log_lin_coeff)
    return _sgpr_cuda(*args, sigma_n_num, with_noise, log_lin_coeff)


# The global scratch of K4's launches past shared memory, by (device,
# stream), grown when a call needs more: no allocation on the calls that
# fit in shared memory, which take none.
_SCRATCH: dict = {}


def _scratch(dev, stream, n: int):
    buf = _SCRATCH.get((dev.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.float32, device=dev)
        _SCRATCH[(dev.index, stream)] = buf
    return buf


def plan(lib, M, P, din, C, dev):
    """(particles a block, blocks a class, floats of global scratch) of
    K4's launch at these shapes on ``dev``: no scratch while a block's
    star block fits in shared memory."""
    out = (ctypes.c_int * 3)()
    _raise_on_error("sgpr_predict", lib.sgpr_plan(M, P, din, C, _sm_count(dev.index), out))
    return tuple(out)


def _sgpr_cuda(Z, Xstar, Lm, LB, beta, log_ls, log_sn, sigma_n_num, with_noise, log_lin,
               lib=None):
    """K4 on the card over one GP (``Z`` (M, din)) or C stacked class GPs
    (``Z`` (C, M, din)); ``lib`` (a build variant's library) is for
    measurement."""
    from ._build import library

    with span("ops.k4"):
        name = "sgpr_predict"
        batched = Z.dim() == 3
        C = Z.shape[0] if batched else 1
        M, din = Z.shape[-2:]
        P, Dout = Xstar.shape[0], beta.shape[-1]
        lead = (C,) if batched else ()
        dev = Xstar.device
        shapes = dict(Z=(Z, lead + (M, din)), Xstar=(Xstar, (P, din)),
                      Lm=(Lm, lead + (M, M)), LB=(LB, lead + (M, M)),
                      beta=(beta, lead + (M, Dout)), log_lengthscales=(log_ls, (din,)),
                      log_sigma_n=(log_sn, ()))
        if log_lin is not None:
            shapes["log_lin_coeff"] = (log_lin, (din + 1,))
        _check(name, dev, **shapes)
        if M < 1 or Dout < 1 or din < 1:
            raise ValueError(f"{name}: need M, Dout and din >= 1, got {M}, {Dout}, {din}")
        mean = torch.empty(lead + (P, Dout), dtype=torch.float32, device=dev)
        var = torch.empty(lead + (P,), dtype=torch.float32, device=dev)
        if P == 0:
            return mean, var
        lib = library() if lib is None else lib
        (num2_bits,) = struct.unpack("<i", struct.pack("<f", sigma_n_num**2))
        n_scratch = plan(lib, M, P, din, C, dev)[2]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            scratch = _scratch(dev, stream, n_scratch).data_ptr() if n_scratch else None
            rc = lib.sgpr_predict_launch(
                Z.data_ptr(), Xstar.data_ptr(), Lm.data_ptr(), LB.data_ptr(), beta.data_ptr(),
                log_ls.data_ptr(), None if log_lin is None else log_lin.data_ptr(),
                log_sn.data_ptr() if with_noise else None, mean.data_ptr(), var.data_ptr(),
                num2_bits, M, P, din, Dout, C, _sm_count(dev.index), scratch, stream)
        _raise_on_error(name, rc)
        counter("ops.k4.launches")
        return mean, var
