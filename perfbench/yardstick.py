"""The yardstick: published peaks, least-time bounds, and the operation and
byte counts of the work each cell asks for.

Counts are taken from shapes alone.  They count the model's mathematics,
not what an implementation launches, so a change that fuses or removes a
kernel leaves them as they are.  ``bound``, ``posterior_work``,
``obs_work``, ``rank_work`` and ``KERNEL_KINDS`` are frozen copies of
``chip_smoke.py``'s (the smoke script may change; these may not).
"""

from __future__ import annotations

import re

#: NVIDIA H100 SXM, dense rates from NVIDIA's data sheet: float32 outside
#: the tensor cores (FLOP/s) and HBM3 bandwidth (bytes/s), at 700 W.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
PEAKS = (PEAK_FP32_FLOPS, PEAK_HBM_BYTES)

#: Kernel-name fragments by kind, the first match taken: cuSOLVER's QR
#: (geqrf and the Householder updates, larf*, orgqr / ormqr); its potrf
#: runs getrf-without-pivot and syrk kernels; cuBLAS's trsm; the products.
KERNEL_KINDS = (("qr (geqrf)", ("geqr", "larf", "orgqr", "ormqr", "orm2r", "org2r")),
                ("cholesky (potrf)", ("potrf", "getrf", "syrk")),
                ("triangular solve", ("trsm", "trsv")),
                ("matmul", ("gemm", "gemv", "xmma", "dot_kernel")))

#: The port's hand-written kernels by their names in the device trace:
#: K1 in either design (one pass, or the streamed core with KIND 1), K2
#: (the streamed core with KIND 2) and K3.
KERNEL_NAMES = {"k1": re.compile(r"x_onepass|posterior_core<\d+, ?1>"),
                "k2": re.compile(r"posterior_core<\d+, ?2>"),
                "k3": re.compile(r"resample_rank_kernel")}


def kind_of(kernel_name: str) -> str:
    low = kernel_name.lower()
    return next((k for k, frags in KERNEL_KINDS if any(f in low for f in frags)), "other")


def bound(flops: float, nbytes: float, peaks=PEAKS) -> tuple[float, str]:
    """Least time (ms) at the card's fp32 peak and memory rate."""
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def posterior_work(N, P, d, Dout, has_linear, classes=1):
    """(flops, bytes) of one fused posterior over ``classes`` class blocks
    of N rows, which share the particles and hyperparameters: star kernel,
    mean, quad."""
    per_pair = 3 * d + 1 + (2 * d + 2 if has_linear else 0)
    flops = classes * (N * P * per_pair + 2 * N * Dout * P + 2 * N * N * P + 2 * N * P)
    nbytes = 4 * (classes * (N * d + N * Dout + N * N + P * Dout + P) + P * d + d
                  + (d + 1 if has_linear else 0))
    return flops, nbytes


def obs_work(N, P, d, D, n_z=1):
    """(flops, bytes) of one observation weighting against n_z observations."""
    flops = N * P * (3 * d + 1) + 2 * N * D * P + 2 * N * N * P + 2 * N * P + 4 * D * P
    nbytes = 4 * (N * d + P * d + d + N * D + N * N + (n_z + 1) * D + 2 * P)
    return flops, nbytes


def rank_work(B, Pb):
    """(operations, bytes) of the rank: an increment and an add per
    particle; 4 bytes of s in and 8 of idx out."""
    return 2 * B * Pb, 12 * B * Pb


def glue_flops(P, d, C, D):
    """FLOPs of one bank step's O(P) work outside the GP posteriors, per
    particle: the class transition (C compares), selecting the class's
    mean and variance (2 C d), the draw (3 d), the log-pdf's elementwise
    tail (8 + D for the per-dimension scaling), normalisation and readouts
    (12 + C + 2 d) and the systematic resampling (6)."""
    return P * (C + 2 * C * d + 3 * d + 8 + D + 12 + C + 2 * d + 6)


def exact_filter_flops(B, Pb, d, D, C, n_max, Ny, back_step=1):
    """Model FLOPs of one bank step of B filters of Pb particles through
    the exact posterior: every class's dynamics posterior (K1's work),
    the observation weighting (K2's) and the glue."""
    P = B * Pb
    din = d * back_step
    return (posterior_work(n_max, P, din, d, True, C)[0] + obs_work(Ny, P, d, D, B)[0]
            + glue_flops(P, d, C, D))


def sgpr_predict_flops(M, P, din, Dout, has_linear):
    """FLOPs of one SGPR prediction at P points against M inducing inputs:
    the star kernel row (3 din + 1 a pair, + 2 din + 2 with the linear
    term), the mean (2 M Dout a point), two triangular solves of the (M,
    P) star block (M^2 each a point) and the two squared column sums
    (4 M), and the variance's three-term sum (2)."""
    per_pair = 3 * din + 1 + (2 * din + 2 if has_linear else 0)
    return P * (M * per_pair + 2 * M * Dout + 2 * M * M + 4 * M + 2)


def sparse_filter_flops(B, Pb, d, D, C, My, Mx, back_step=1):
    """Model FLOPs of one bank step through the SGPR posterior: the
    observation GP's prediction at every particle, every class's dynamics
    GP's, and the glue."""
    P = B * Pb
    din = d * back_step
    return (sgpr_predict_flops(My, P, d, D, False) + C * sgpr_predict_flops(Mx, P, din, d, True)
            + glue_flops(P, d, C, D))


def compressed_predict_flops(N, P, din, Dout, q, has_linear):
    """FLOPs of one compressed-posterior prediction at P points against N
    training rows and q kept eigenpairs: the star kernel row, the exact
    mean (2 N Dout a point), the projection onto the eigenbasis and the
    residual vector (2 N q each), its squares and sum (2 N), the weighted
    squares of the projection (3 q), and the variance's difference (1)."""
    per_pair = 3 * din + 1 + (2 * din + 2 if has_linear else 0)
    return P * (N * per_pair + 2 * N * Dout + 4 * N * q + 2 * N + 3 * q + 1)


def compressed_filter_flops(B, Pb, d, D, C, n_max, Ny, rank_y, rank_x, back_step=1):
    """Model FLOPs of one bank step through the compressed posterior: the
    observation GP's prediction at every particle, every class's dynamics
    GP's (each at the stated rank_x, the largest class's), and the glue."""
    P = B * Pb
    din = d * back_step
    return (compressed_predict_flops(Ny, P, d, D, rank_y, False)
            + C * compressed_predict_flops(n_max, P, din, d, rank_x, True)
            + glue_flops(P, d, C, D))
