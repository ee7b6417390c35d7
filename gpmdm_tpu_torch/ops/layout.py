"""Static segment bookkeeping for multi-sequence, multi-class data.

A copy of ``gpmdm_tpu/ops/layout.py``: observation rows are ordered
class-major then sequence-major, so each class occupies one contiguous
block of rows in the observation/latent matrices (Ny rows) and in the
dynamics pair matrices Xin/Xout (Nx rows).  Precomputed integer index
arrays replace the reference's per-sequence loops, and the class-block
Gram is factored one dense class block at a time.  Block sizes always
match the true number of dynamics pairs, ``len(seq) - back_step``.
The layout is built in numpy on the host; ``DataLayout.to(device)`` gives
the copy whose gather indices live on the model's device, which the loss
uses on every training step.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class DataLayout:
    """Precomputed index arrays describing the flattened dataset.

    All arrays are host numpy.  ``eq=False`` keeps identity-based hashing
    (the arrays are unhashable; one layout is built per model).
    """

    n_classes: int
    back_step: int
    seq_lengths: tuple  # length per sequence, in flattened order
    seq_classes: tuple  # class per sequence, in flattened order (non-decreasing)
    Ny: int  # total observation rows
    Nx: int  # total dynamics pairs
    seq_starts: np.ndarray  # (S,) start row of each sequence in Y/X
    # Dynamics pair gathers (into the Ny axis):
    xin_idx: np.ndarray  # (Nx,) index of x(t)
    xin_prev_idx: np.ndarray  # (Nx,) index of x(t-1); == xin_idx when back_step == 1
    xout_idx: np.ndarray  # (Nx,) index of x(t+1)
    pair_class: np.ndarray  # (Nx,) class of each dynamics pair
    # Contiguous class blocks:
    y_class_offsets: np.ndarray  # (C+1,) row offsets of class blocks in Y/X
    x_class_offsets: np.ndarray  # (C+1,) row offsets of class blocks in Xin/Xout
    # Padded per-class views of the dynamics-pair axis:
    n_max: int  # max dynamics pairs in any class
    class_pair_idx: np.ndarray  # (C, n_max) indices into the Nx axis (0-padded)
    class_pair_mask: np.ndarray  # (C, n_max) 1.0 where valid, 0.0 where padded

    @property
    def class_x_counts(self) -> np.ndarray:
        return np.diff(self.x_class_offsets)

    @property
    def class_y_counts(self) -> np.ndarray:
        return np.diff(self.y_class_offsets)

    def to(self, device) -> "DataLayout":
        """A copy whose dynamics-pair gathers (``xin_idx``, ``xin_prev_idx``,
        ``xout_idx``) are int64 tensors on ``device``: a gather by a numpy
        index would copy the index to the device on every call.  The other
        fields stay host numpy."""
        return dataclasses.replace(self, **{
            f: torch.as_tensor(getattr(self, f), dtype=torch.int64, device=device)
            for f in ("xin_idx", "xin_prev_idx", "xout_idx")
        })


def build_layout(
    seq_lengths: Sequence[int], seq_classes: Sequence[int], n_classes: int, back_step: int = 1
) -> DataLayout:
    """Build the static index layout from per-sequence lengths and classes.

    ``seq_lengths[i]`` / ``seq_classes[i]`` describe the i-th sequence in
    flattened order; classes must be non-decreasing (class-major layout).
    """
    seq_lengths = tuple(int(s) for s in seq_lengths)
    seq_classes = tuple(int(c) for c in seq_classes)
    if len(seq_lengths) != len(seq_classes):
        raise ValueError("seq_lengths and seq_classes must have equal length")
    if any(c < 0 or c >= n_classes for c in seq_classes):
        raise ValueError("sequence class out of range")
    if list(seq_classes) != sorted(seq_classes):
        raise ValueError("sequences must be ordered class-major (non-decreasing class)")
    if any(l <= back_step for l in seq_lengths):
        raise ValueError(f"every sequence must be longer than back_step={back_step}")

    starts = np.concatenate([[0], np.cumsum(seq_lengths)[:-1]]).astype(np.int32)
    Ny = int(sum(seq_lengths))

    xin, xin_prev, xout, pcls = [], [], [], []
    for start, length, cls in zip(starts, seq_lengths, seq_classes):
        if back_step == 1:
            t = np.arange(length - 1)
            xin.append(start + t)
            xin_prev.append(start + t)
            xout.append(start + t + 1)
        else:  # back_step == 2: in = [x(t), x(t-1)], out = x(t+1), t = 1..len-2
            t = np.arange(1, length - 1)
            xin.append(start + t)
            xin_prev.append(start + t - 1)
            xout.append(start + t + 1)
        pcls.append(np.full(len(xin[-1]), cls, dtype=np.int32))

    xin_idx = np.concatenate(xin).astype(np.int32)
    xin_prev_idx = np.concatenate(xin_prev).astype(np.int32)
    xout_idx = np.concatenate(xout).astype(np.int32)
    pair_class = np.concatenate(pcls).astype(np.int32)
    Nx = int(xin_idx.shape[0])

    y_counts = np.zeros(n_classes, dtype=np.int64)
    x_counts = np.zeros(n_classes, dtype=np.int64)
    for length, cls in zip(seq_lengths, seq_classes):
        y_counts[cls] += length
        x_counts[cls] += length - back_step
    y_class_offsets = np.concatenate([[0], np.cumsum(y_counts)]).astype(np.int32)
    x_class_offsets = np.concatenate([[0], np.cumsum(x_counts)]).astype(np.int32)

    n_max = int(x_counts.max()) if n_classes > 0 else 0
    class_pair_idx = np.zeros((n_classes, n_max), dtype=np.int32)
    class_pair_mask = np.zeros((n_classes, n_max), dtype=np.float32)
    for c in range(n_classes):
        n_c = int(x_counts[c])
        class_pair_idx[c, :n_c] = np.arange(x_class_offsets[c], x_class_offsets[c] + n_c)
        class_pair_mask[c, :n_c] = 1.0

    return DataLayout(
        n_classes=n_classes,
        back_step=back_step,
        seq_lengths=seq_lengths,
        seq_classes=seq_classes,
        Ny=Ny,
        Nx=Nx,
        seq_starts=starts,
        xin_idx=xin_idx,
        xin_prev_idx=xin_prev_idx,
        xout_idx=xout_idx,
        pair_class=pair_class,
        y_class_offsets=y_class_offsets,
        x_class_offsets=x_class_offsets,
        n_max=n_max,
        class_pair_idx=class_pair_idx,
        class_pair_mask=class_pair_mask,
    )


def xin_xout(X, layout: DataLayout, target: str):
    """Gather (Xin, Xout) dynamics regression matrices from the latent matrix X.

    Static-index gather version of the reference's per-sequence loop.
    Covers all four (target, back_step) modes.  X is a numpy array or a
    tensor; on a tensor the gathers are differentiable.

    Returns Xin of shape (Nx, d*back_step) and Xout of shape (Nx, d).
    """
    x_t = X[layout.xin_idx]
    if layout.back_step == 1:
        Xin = x_t
    else:
        cat = torch.cat if torch.is_tensor(X) else np.concatenate
        Xin = cat([x_t, X[layout.xin_prev_idx]], axis=1)
    Xout = X[layout.xout_idx]
    if target == "delta":
        Xout = Xout - x_t
    return Xin, Xout


def padded_class_indices(
    layout: DataLayout, n_class_pad: int | None = None, n_max_pad: int | None = None
) -> dict:
    """Zero-padded per-class gather arrays into the Ny axis.

    Returns ``{"idx_in", "idx_prev", "idx_out": (C', n_max'), "mask":
    (C', n_max')}`` where row c lists class c's dynamics pairs (x(t),
    x(t-1), x(t+1) indices), padded with 0 and masked.  ``n_class_pad`` /
    ``n_max_pad`` optionally pad the class / pair axes further (to make them
    divisible by a mesh axis); padded classes are entirely masked.
    """
    C = n_class_pad or layout.n_classes
    M = n_max_pad or layout.n_max
    if C < layout.n_classes or M < layout.n_max:
        raise ValueError("padding must not shrink the class/pair axes")
    idx_in = np.zeros((C, M), dtype=np.int32)
    idx_prev = np.zeros((C, M), dtype=np.int32)
    idx_out = np.zeros((C, M), dtype=np.int32)
    mask = np.zeros((C, M), dtype=np.float64)
    for c in range(layout.n_classes):
        n_c = int(layout.class_x_counts[c])
        pair = layout.class_pair_idx[c, :n_c]
        idx_in[c, :n_c] = layout.xin_idx[pair]
        idx_prev[c, :n_c] = layout.xin_prev_idx[pair]
        idx_out[c, :n_c] = layout.xout_idx[pair]
        mask[c, :n_c] = 1.0
    return {"idx_in": idx_in, "idx_prev": idx_prev, "idx_out": idx_out, "mask": mask}


def class_block_mask(layout: DataLayout, dtype=np.float32) -> np.ndarray:
    """Dense Nx x Nx class-block mask M (reference get_M), for inspection
    and tests only: the compute path never materializes it."""
    return (layout.pair_class[:, None] == layout.pair_class[None, :]).astype(dtype)
