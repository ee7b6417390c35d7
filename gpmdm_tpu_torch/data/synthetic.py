"""Synthetic multi-class limit-cycle dataset.

The reference is only exercised on CMU mocap walk/run data, which is not
shipped with either repo (reference README.md:24 requires a manual download).
This module provides a self-contained stand-in with the same structure — a
few classes of noisy periodic motions observed through a smooth nonlinear
lift into D dimensions — so that tests and benchmarks run anywhere.

Class c is a 2-D limit cycle with class-specific frequency and radius shape,
lifted to D dims by a fixed random linear map plus a sinusoidal warp.
"""

from __future__ import annotations

import numpy as np


def make_cycle(
    n_frames: int,
    class_index: int,
    D: int,
    noise: float = 0.02,
    phase: float = 0.0,
    rng: np.random.Generator | None = None,
    center_spread: float = 0.0,
    class_signature: float = 0.0,
) -> np.ndarray:
    """One sequence of a noisy class-specific limit cycle, shape (n_frames, D)."""
    if rng is None:
        rng = np.random.default_rng(0)
    if class_signature > 0.0:
        # signature task: classes are told apart primarily by posture
        # (center + observation signature), with mild speed differences.
        # The classic task's aggressive frequency scaling (below) makes
        # high classes alias at the fixed frame rate (class 7: ~9
        # frames/cycle), which tests sampling density, not the model.
        freq = 1.0 + 0.25 * class_index
        wobble = 0.15 * class_index
    else:
        freq = 1.0 + 0.7 * class_index  # class-specific angular frequency
        wobble = 0.3 * class_index  # class-specific radius modulation
    # optional class-specific cycle center (golden-angle ring placement) so
    # many-class configs are separable in space as well as dynamics — like
    # distinct gait poses.  Default 0 keeps the classic overlapping-cycles
    # task (classes differ only in speed/wobble).
    center = center_spread * np.array(
        [np.cos(2.39996 * class_index), np.sin(2.39996 * class_index)]
    ) * (class_index > 0)
    t = np.arange(n_frames) * 0.12
    theta = freq * t + phase
    r = 1.0 + wobble * np.sin(3.0 * theta)
    z = center + np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)  # (n, 2)

    # Fixed per-(class-agnostic) lift: shared observation map across classes,
    # like the shared latent->observation GP in the model.
    lift_rng = np.random.default_rng(1234)
    W1 = lift_rng.normal(size=(2, D)) / np.sqrt(2)
    W2 = lift_rng.normal(size=(2, D)) / np.sqrt(2)
    Y = z @ W1 + np.sin(z @ W2)
    if class_signature > 0.0:
        # per-class observation signature: a fixed class-specific offset
        # direction in observation space (a distinguishing "posture"), the
        # analogue of distinct mean poses across activities.  Combined with
        # center_spread this gave the best-separated many-class task of the
        # designs swept (single-direction ladders drown in the ~sqrt(D)
        # cycle amplitude; capping the per-class wobble removes a shape cue
        # the filter demonstrably uses).
        sig_rng = np.random.default_rng(9000 + class_index)
        Y = Y + class_signature * sig_rng.normal(size=(D,))
    Y = Y + noise * rng.normal(size=Y.shape)
    return Y.astype(np.float32)


def make_dataset(
    n_classes: int = 2,
    n_train_seqs: int = 4,
    n_test_seqs: int = 4,
    seq_len: int = 60,
    D: int = 12,
    noise: float = 0.02,
    seed: int = 0,
    center_spread: float = 0.0,
    class_signature: float = 0.0,
):
    """Build (train_seqs, train_labels, test_seqs, test_labels).

    Sequences are returned class-major for training (matching the GPMDM
    flattening invariant) and shuffled for test.
    """
    rng = np.random.default_rng(seed)
    train_seqs, train_labels = [], []
    for c in range(n_classes):
        for i in range(n_train_seqs):
            phase = rng.uniform(0, 2 * np.pi)
            train_seqs.append(
                make_cycle(seq_len, c, D, noise, phase, rng, center_spread,
                           class_signature)
            )
            train_labels.append(c)
    test_seqs, test_labels = [], []
    for c in range(n_classes):
        for i in range(n_test_seqs):
            phase = rng.uniform(0, 2 * np.pi)
            test_seqs.append(
                make_cycle(seq_len, c, D, noise, phase, rng, center_spread,
                           class_signature)
            )
            test_labels.append(c)
    order = rng.permutation(len(test_seqs))
    test_seqs = [test_seqs[i] for i in order]
    test_labels = [test_labels[i] for i in order]
    return train_seqs, train_labels, test_seqs, test_labels
