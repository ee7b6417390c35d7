"""Resampling rank: ``idx[b, i] = min(#{j : s[b, j] <= i}, Pb - 1)``.

Counterpart of ``rank_pallas`` in ``tools/exp_resample_rank_pallas.py``
(the fused form of the 0/1 matmul with which the JAX package's
``systematic_resample_indices`` ranks on the TPU), with a bank axis:
``s`` is (B, Pb) int32, one row per independent filter.

- ``resample_rank``: the CUDA kernel (``csrc/resample_rank.cu``) for
  tensors on the card, which it launches or raises; the plain version for
  tensors on the CPU.
- ``resample_rank_plain``: the same function in PyTorch, a histogram of
  each bank's values and a cumulative sum.

Both count exactly, so they agree bit for bit.  Each launch on the card
runs in the span ``ops.k3`` and adds one to the counter
``ops.k3.launches`` (``utils.profiling``), so a run can show that it went
through the kernel.
"""

from __future__ import annotations

import torch

from ..utils.profiling import counter, span


def resample_rank_plain(s: torch.Tensor) -> torch.Tensor:
    """(B, Pb) int64 ranks of (B, Pb) integer ``s``, in PyTorch."""
    B, Pb = s.shape
    v = torch.clamp(s.to(torch.int64), 0, Pb)
    v = v + (Pb + 1) * torch.arange(B, device=s.device, dtype=torch.int64)[:, None]
    # scatter_add_, not bincount: bincount on the card reads the largest
    # value back to the host to size its output
    counts = torch.zeros(B * (Pb + 1), dtype=torch.int64, device=s.device)
    counts.scatter_add_(0, v.reshape(-1), torch.ones_like(counts[:1]).expand(B * Pb))
    counts = counts.reshape(B, Pb + 1)
    return torch.clamp(torch.cumsum(counts[:, :Pb], dim=1), max=max(Pb - 1, 0))


def resample_rank(s: torch.Tensor) -> torch.Tensor:
    """(B, Pb) int64 ranks of (B, Pb) int32 ``s``: the kernel on the card,
    the plain version on the CPU."""
    if s.device.type == "cpu":
        return resample_rank_plain(s)
    return _rank_cuda(s)


def _rank_cuda(s: torch.Tensor, lib=None) -> torch.Tensor:
    """The kernel on the card; ``lib`` (a build variant's library) is for
    measurement."""
    from ._build import library

    with span("ops.k3"):
        name = "resample_rank"
        if s.dtype != torch.int32:
            raise TypeError(f"{name}: s must be int32, got {s.dtype}")
        if s.dim() != 2:
            raise ValueError(f"{name}: s must be (B, Pb), got shape {tuple(s.shape)}")
        if not s.is_contiguous():
            raise ValueError(f"{name}: s must be contiguous")
        B, Pb = s.shape
        idx = torch.empty(B, Pb, dtype=torch.int64, device=s.device)
        if B == 0 or Pb == 0:
            return idx
        lib = library() if lib is None else lib
        with torch.cuda.device(s.device):
            stream = torch.cuda.current_stream(s.device).cuda_stream
            rc = lib.resample_rank_launch(s.data_ptr(), idx.data_ptr(), B, Pb, stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {rc}")
        counter("ops.k3.launches")
        return idx
