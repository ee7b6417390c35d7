"""Fused exact-GP posterior: star kernel -> mean + variance quad, in one pass.

Counterpart of ``gpmdm_tpu/ops/pallas/gp_posterior.py``.  The particle
filter's per-frame cost is the GP posterior over all particles:

    Kstar = k(Xtrain, Xstar)              # (N, P)
    mean  = Kstar^T @ A                   # (P, Dout)
    quad  = sum(Kstar * (Kinv @ Kstar), 0)  # (P,)
    var   = kdiag - quad                  # by the caller

Each public function has two versions:

- the CUDA kernel (``csrc/gp_posterior.cu``, built by ``_build``), which
  streams Kinv and the weights through shared memory against Kstar, for
  any number of training rows, and writes only the outputs; the wrapper
  takes it for tensors on the card and launches it or raises.  The
  dynamics posterior (K1) runs every class in one launch
  (``fused_x_posterior_classes``), in one pass over a star tile generated
  once while N + Dout <= 256;
- a plain PyTorch version (``*_plain``) with the same arithmetic, taken
  for tensors on the CPU and used as the kernel's reference on the card.

The kernels take and compute IEEE fp32; the plain versions run in their
inputs' dtype.  Both sum squared distances by per-dimension differences,
never by the norm expansion, and mask padded training rows to exactly 0.
``LAUNCHES`` counts kernel launches per kernel (K1's under
``fused_x_posterior``, from either of its functions), so a run can show
that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: Kernel launches per kernel since the last ``reset_launches``.
LAUNCHES = {"fused_x_posterior": 0, "fused_rbf_posterior": 0, "fused_obs_loglik": 0}

#: Particles per block that the launchers take; 0 lets them choose from P.
TILES = (0, 64, 128)


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


def fused_x_posterior_classes_plain(Xin_c, Xstar, Axc, Kxc_inv, inv_lengthscales,
                                    lin_w, n_valid: int):
    """The per-class plain versions, stacked: (mean (C, P, d), quad (C, P))."""
    outs = [fused_x_posterior_plain(Xin_c[ci], Xstar, Axc[ci], Kxc_inv[ci],
                                    inv_lengthscales, lin_w, n_valid)
            for ci in range(Xin_c.shape[0])]
    return torch.stack([m for m, _ in outs]), torch.stack([q for _, q in outs])


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


def _raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {rc}")


def _check_tile(name: str, tile: int) -> None:
    if tile not in TILES:
        raise ValueError(f"{name}: tile must be one of {TILES}, got {tile}")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# The partial sums and tickets of split passes, by (device, stream).  The
# kernel sets each ticket back to 0 when it is done with it, so tickets are
# zeroed once, when they are allocated, and every call reuses both buffers
# (grown when a call needs more): no allocation and no memset a call.
_SCRATCH: dict = {}


def _scratch(dev, stream, n_partial: int, n_ticket: int):
    partial, ticket = _SCRATCH.get((dev.index, stream), (None, None))
    if partial is None or partial.numel() < n_partial:
        partial = torch.empty(n_partial, dtype=torch.float32, device=dev)
    if ticket is None or ticket.numel() < n_ticket:
        ticket = torch.zeros(n_ticket, dtype=torch.int32, device=dev)
    _SCRATCH[(dev.index, stream)] = partial, ticket
    return partial, ticket


def _plan(lib, name, N, Dout, P, tile, dev, stream, C=1, one_pass=False):
    """The launcher's tile, splits and design (one pass or the streamed
    core) for this call, and the partial sums and tickets that split
    passes need (None when unsplit)."""
    plan = (ctypes.c_int * 4)()
    _raise_on_error(name, lib.gp_plan(N, Dout, P, C, tile, int(one_pass),
                                      _sm_count(dev.index), plan))
    tp, splits, tiles, one = plan
    if splits == 1:
        return tp, 1, one, None, None
    return (tp, splits, one, *_scratch(dev, stream, 2 * splits * P * C, tiles * C))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _posterior_cuda(name, Xtrain, Xstar, A, Kinv, inv_ls, lin_w, n_valid,
                    has_linear, tile=0, one_pass=True, lib=None):
    """K1 or K1' on the card over C stacked class blocks, Xtrain (C, N, d),
    A (C, N, Dout), Kinv (C, N, N): (mean (C, P, Dout), quad (C, P)) in one
    launch.  K1 takes the one-pass design while N + Dout <= 256 (the CUDA
    source's ``ONEPASS_COLS``, applied by ``gp_plan``); ``one_pass=False``
    forces the streamed core, and it, ``tile`` (see ``TILES``) and ``lib``
    (a build variant's library) are for measurement."""
    from ._build import library

    C, N, d = Xtrain.shape
    P, Dout = Xstar.shape[0], A.shape[2]
    dev = Xstar.device
    shapes = dict(Xtrain=(Xtrain, (C, N, d)), Xstar=(Xstar, (P, d)), A=(A, (C, N, Dout)),
                  Kinv=(Kinv, (C, N, N)), inv_lengthscales=(inv_ls, (d,)))
    if has_linear:
        shapes["lin_w"] = (lin_w, (d + 1,))
    _check(name, dev, **shapes)
    _check_tile(name, tile)
    if not 0 <= n_valid <= N or N < 1 or C < 1:
        raise ValueError(f"{name}: need 1 <= C, 1 <= N and 0 <= n_valid <= N, got C={C}, "
                         f"N={N}, n_valid={n_valid}")
    mean = torch.empty(C, P, Dout, dtype=torch.float32, device=dev)
    quad = torch.empty(C, P, dtype=torch.float32, device=dev)
    if P == 0:
        return mean, quad
    lib = library() if lib is None else lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tp, splits, one, partial, ticket = _plan(lib, name, N, Dout, P, tile, dev, stream,
                                                 C, one_pass and has_linear)
        rc = lib.gp_posterior_launch(
            Xtrain.data_ptr(), Xstar.data_ptr(), inv_ls.data_ptr(),
            lin_w.data_ptr() if has_linear else None, A.data_ptr(), Kinv.data_ptr(),
            mean.data_ptr(), quad.data_ptr(), N, P, d, Dout, n_valid, C,
            int(has_linear), tp, one, splits, _ptr(partial), _ptr(ticket), stream)
    _raise_on_error(name, rc)
    LAUNCHES[name] += 1
    return mean, quad


def fused_rbf_posterior(Xtrain, Xstar, Ay, Kinv, inv_lengthscales):
    """Observation-GP posterior: (mean (P, D), quad (P,)).

    mean = Kstar^T Ay, quad = sum(Kstar * (Kinv Kstar), 0), with
    Kstar = exp(-sum_k ((xt-xs)/l)^2); the caller forms var = kdiag - quad.
    """
    if _on_cpu(Xtrain, Xstar, Ay, Kinv, inv_lengthscales):
        return fused_rbf_posterior_plain(Xtrain, Xstar, Ay, Kinv, inv_lengthscales)
    mean, quad = _posterior_cuda("fused_rbf_posterior", Xtrain[None], Xstar, Ay[None],
                                 Kinv[None], inv_lengthscales, None, Xtrain.shape[0], False)
    return mean[0], quad[0]


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
    mean, quad = _posterior_cuda("fused_x_posterior", Xin_c[None], Xstar, Axc[None],
                                 Kxc_inv[None], inv_lengthscales, lin_w, n_valid, True)
    return mean[0], quad[0]


def fused_x_posterior_classes(Xin_c, Xstar, Axc, Kxc_inv, inv_lengthscales, lin_w,
                              n_valid: int):
    """Dynamics-GP posterior for EVERY class block at once, as the filter
    step calls it: ``Xin_c`` (C, N, din), ``Axc`` (C, N, d), ``Kxc_inv``
    (C, N, N) -> (mean (C, P, d), quad (C, P)), what ``fused_x_posterior``
    gives class by class, in one kernel launch on the card."""
    if _on_cpu(Xin_c, Xstar, Axc, Kxc_inv, inv_lengthscales, lin_w):
        return fused_x_posterior_classes_plain(Xin_c, Xstar, Axc, Kxc_inv,
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
    return _obs_loglik_cuda(Xtrain, Xstar, Ay, Kinv, inv_lengthscales, z, lam2)


def _obs_loglik_cuda(Xtrain, Xstar, Ay, Kinv, inv_lengthscales, z, lam2, tile=0, lib=None):
    """K2 on the card; ``tile`` (see ``TILES``) and ``lib`` (a build
    variant's library) are for measurement."""
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
    _check_tile(name, tile)
    if N < 1:
        raise ValueError(f"{name}: need at least one training row")
    quad = torch.empty(P, dtype=torch.float32, device=dev)
    qres = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return quad, qres
    lib = library() if lib is None else lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tp, splits, _, partial, ticket = _plan(lib, name, N, D, P, tile, dev, stream)
        rc = lib.obs_loglik_launch(
            Xtrain.data_ptr(), Xstar.data_ptr(), inv_lengthscales.data_ptr(),
            Ay.data_ptr(), Kinv.data_ptr(), z.data_ptr(), lam2.data_ptr(),
            quad.data_ptr(), qres.data_ptr(), N, P, d, D, P // B, tp, splits,
            _ptr(partial), _ptr(ticket), stream)
    _raise_on_error(name, rc)
    LAUNCHES[name] += 1
    return quad, qres
