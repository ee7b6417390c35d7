#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gpmdm_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # what a check runs: needs one CUDA card
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown

Phases, each printing one JSON line on stdout:

1. device  - the card's name and count, nvidia-smi's name and power limit;
             exits non-zero at once when CUDA is not available.
2. build   - builds the CUDA kernels from ops/csrc with nvcc (its
             ``-Xptxas -v`` report goes to stderr).
3. kernels - each posterior kernel (K1 fused_x_posterior over all C
             classes in one launch, as the filter calls it; K1'
             fused_rbf_posterior; K2 fused_obs_loglik) at the main path's
             shapes from bench_assets/bench_model.npz with 10,000
             particles, K1 and K2 again on banks of 12 x 10,000 and
             64 x 1,000 particles (K2 with one observation per bank), and K1
             at the d4 and c8 assets' widths (their own classes and initial
             clouds at 10,000 particles), against its plain PyTorch version
             run in float64 on the card, twice:
             - on the path's own inputs, where each output's max error
               must be <= 4 x the plain fp32 version's error against the
               same float64 result + 1e-6.  The fp32-deployed dynamics
               posterior is so ill-conditioned that this limit exceeds
               K1's largest quad, so these inputs cannot hold that output;
             - on the path's training rows, particles and lengthscales with
               a seeded, well-conditioned SPD Kinv (I + B B^T) and seeded
               weights A in place of the asset's, where every output's max
               error must be <= 1e-4 x its median magnitude in float64.
             Times: device time of one call on the path's inputs, median of
             20, from CUDA events; K1 and K2 also at each forced particle
             tile (tiles_ms), K1 also on the streamed core (streamed_ms),
             and K2 beside its gemm yardstick (gemm_ms: torch.matmul of
             the stacked [Kinv; Ay^T] by a precomputed Kstar, TF32 off,
             which the port never calls).  Each K1 entry names the design
             its launch took: "one_pass" (x_onepass, the star tile
             generated once, while N + Dout <= 256: every asset's path) or
             "streamed" (the streamed core, past it).
             K3 resample_rank at (banks, particles) = (1, 10,000),
             (12, 10,000), (64, 1,000) and (1, 100,000), on s from the
             weights of a real frame of the filter and from seeded
             Dirichlet weights (sorted, and shuffled): bit-identical to its
             plain version.  Its library_ms is torch.searchsorted on the
             real frame's s, sorted first (the card's fp32 cumsum can
             leave s a step out of order; the count does not care).
   large_n - K2 at Ny = 2,048 (bench_model_n2048.npz) and 5,120
             (bench_model_n5120.npz), and K1 at n5120's 2,528 dynamics rows
             (the streamed core), each at P = 10,000 on that asset's
             initial cloud and on conditioned inputs, to the same two
             limits; the assets' exact posteriors, asked for explicitly.
4. path    - pf_init + pf_scan, P = 10,000, over the 1000-frame stream of
             bench.py (seed 0); the kernel launch counters must rise by
             exactly 1000 (K1, all classes in one launch), 1000 (K2) and
             1000 (K3); frames/s is the best of 4 runs.
5. guard   - evaluate_pf on the 12 held-out trials of bench.py (6 per
             class, seed 0, burn-in 5, P = 10,000), GPMDM_PF with
             posterior='exact'; fails below 0.90 frame accuracy.
6. banked_guard - evaluate_pf_banked on the same 12 trials, one bank of
             10,000 particles per trial, padded to 64 frames; fails below
             0.90 frame accuracy; the launch counters must rise by exactly
             64 for each of K1, K2 and K3.
             Aggregate frames/s counts the trials' own frames (720), not
             the padding (padded_agg_fps counts 12 x 64).
7. fleet   - pf_scan_bank over 64 banks x 1,000 particles x 64 frames,
             each bank streaming the path's first 64 frames (bench.py's
             fleet); aggregate frames/s = banks x frames / wall, best of 4
             runs, each of which must launch each kernel exactly 64 times.
8. d4, c8  - bench.py's extra assets, deployed exact: bench_model_d4.npz
             (d = 4) on the path's stream and the guard's trials, and
             bench_model_c8.npz (C = 8, D = 10, d = 3, Ny = 960) on its
             8-class task (bench.py:328-366).  Each runs a 200-frame path at
             P = 10,000 (launches exactly 200 of each kernel) and its
             banked guard (exactly T of each for T padded frames), whose
             frame accuracy and F1 are reported, not gated, beside the
             same guard on the plain PyTorch versions (pallas='off'; the
             fp32 sums in another order).  Their exact posteriors, asked
             for explicitly (c8 recommends a sparsified one).
   compressed - bench.py:264-283 on the headline asset: the compressed
             posterior (m.compressed_posterior(), tol 1e-6) through the
             1000-frame path at P = 10,000 (best of 4) and the banked
             guard (gated at 0.90), beside the exact path's and guard's
             numbers from this run.  These phases run the compressed
             posterior's cuBLAS products and K3: the launch counters must
             read K1 = K2 = 0 and K3 = frames (padded frames on a guard),
             TF32 must be off and float32 matmuls at "highest".  Peak
             device memory per phase.
   compressed_n2048, compressed_n5120 - the large-N assets as loaded:
             'auto' must resolve to their persisted compressed posteriors
             (ranks 148/113 and 188/136) without building the exact one;
             GPMDM_PF's 200-frame path at P = 10,000 and the banked guard
             of utils.asset_guard (the SHAPES entry of the asset, P =
             10,000), gated at 0.90, beside the committed receipt (a CPU
             reading at P = 500).  Then, in the same call, the exact
             posterior (built on the host, timed): its path frames/s, and
             at n5120 its banked guard, gated at 0.90 (the full-fp32 K1 /
             K2 at Ny = 5,120, past the size where the JAX package's
             reduced-precision quad failed on the TPU).
   compressed_c8n5120 - the 8-class Ny = 5,120 asset, its sparsified
             recommendation set aside: 'auto' warns that the rank
             (1149 / 5120) is in the flat-spectrum band; posterior=
             'compressed' serves a 200-frame path and the guard (16 banks
             a call), reported, not gated.
   sparse phases - the SGPR posteriors, cuBLAS fp32 products and
             triangular solves (no Pallas kernel in the JAX package), and
             K3: K1 = K2 = 0 and K3 = frames (padded frames, times the
             calls, on a guard) on each, TF32 off, peak device memory.
             Each guard is evaluate_pf_banked at P = 10,000 unless named.
             - sparse_hourlong: the SparseGPMDM of
               bench_model_hourlong.npz (Ny = 108,000, M = 128), load
               timed; 'auto' must serve its own posterior; 200-frame path
               (best of 2) and bench.py:530-539's banked guard (12 trials
               x 600 frames), gated at 0.90.
             - sparse_hourlongh, sparse10240: 'auto' and the guard of
               utils.asset_guard's SHAPES, reported.
             - sparsified_c8: 'auto' must serve the persisted kmeans-128
               distillation with no exact build; path and the c8 guard
               (bench.py:327-366), reported.
             - sparsified_c8n5120: 'auto' must serve the persisted
               kmeans-384 distillation; path and the guard in 3 calls of
               16 banks, gated at 0.90.
             - sparsified_fleet: bench_model.npz's persisted M = 128
               distillation, 64 banks x 1,000 x 64 frames at
               quad_precision='high', best of 3, and its guard at P =
               1,000, gated at 0.90 (bench.py:566-590).
             With --profile, hourlong's (1 and 12 banks of 10,000) and the
             distilled fleet's breakdowns.
9. train   - trains the bench_model.npz recipe on the card
             (bench_assets/README.md: D = 35, d = 2, 2 classes, 4 x 60
             frames each, sigma_n inits 0.1, f32, 300 Adam steps at lr
             0.01) through GPMDM.train_adam, in memory only: no file is
             written.  Fails unless all 300 losses are finite, the first
             is within 1e-3 relative of the port's float64 loss at the
             same PCA initialisation (computed on the host) and the last
             within 5% of the committed asset's loss as the port computes
             it on the card.  Reports the first step's seconds and steps/s
             over the other 299 (each ends in a host read of the losses);
             with --profile, device ms per step by kernel and the card's
             busy share over 20 steps.
10. train_guard - the model just trained, deployed exact, through
             evaluate_pf_banked on the banked guard's 12 trials (P =
             10,000, padded to 64 frames): the launch counters must rise
             by exactly 64 for each of K1, K2 and K3.  Frame accuracy and
             F1 are reported beside the committed asset's, not gated.
11. train_n2048 - the n2048 recipe of tools/train_bench_assets.py (16
             sequences of 64 frames a class, Ny = 2,048, f32): 20 Adam
             steps; steps/s and the non-finite count.
12. train_sparse - BASELINE.md's hour-long configuration at full scale:
             the 4 sequences of bench_model_hourlong.npz (2 classes x 2 x
             27,000 frames, D = 35, Ny = 108,000) in a fresh SparseGPMDM
             with the asset's config (f32, sigma_n frozen, M = 128 + 128),
             init_X on the card, 30 Adam steps at lr 0.01, in memory only.
             Fails unless all 30 losses are finite, the last is below the
             first, and the first is within max(1e-3, 4 x the host's own
             fp32-against-float64 gap) relative of the port's float64
             sparse_nll at the same initialisation on the host CPU, both
             as it is and with the fp32 objective's jitters (Kuu's 1e-4,
             not float64's 1e-6, which alone moves the loss by ~5%).
             Reports the first step's seconds, steps/s over the other 29,
             peak GiB and load s; with --profile, launches and device ms
             per step by kind and the busy share.
13. train_sparse_resume - bench_model_hourlong.npz with its Adam state, 20
             more steps: the count must read the stored count + 20, the
             losses be finite and the last within 5% of the asset's loss at
             its stored parameters (on the card).  The model then serves
             bench.py:530-539's banked guard (12 trials x 600 frames, P =
             10,000; K1 = K2 = 0, K3 = padded frames), reported beside
             sparse_hourlong's guard, not gated.
14. train_bc - the bench_model.npz recipe as a BCGPMDM (median
             lengthscale), 300 Adam steps at lr 0.01: every loss finite,
             the first within 1e-3 relative of the port's float64 bc_nll
             on the host, map_y_to_x(get_Y()) equal to params.X within
             1e-4 x its median magnitude; steps/s.  It then serves the
             banked guard's 12 trials (P = 10,000, padded to 64 frames)
             with exactly 64 launches of each of K1, K2 and K3; accuracy
             reported, not gated.
15. train_lbfgs - the bench_model.npz recipe from its PCA init, 30
             L-BFGS steps (optax.lbfgs, memory 10; GPMDM.train_lbfgs):
             every loss finite, the last below the first, the first within
             1e-3 relative of the port's float64 loss on the host.  Reports
             steps/s, loss evaluations and host reads a step, and over 3
             profiled steps more the kernel launches a step and an
             evaluation; then the banked guard (12 x 10,000, exactly 64
             launches of each of K1, K2 and K3), reported, not gated.
16. lbfgs_resume - bench_model_hourlongh.npz on the card: its 57 L-BFGS
             leaves must equal the file's bit for bit; 3 steps from that
             state: the count + 3, finite losses, the first within 1e-3 of
             the host's float64 evaluation of the fp32 objective at the
             asset's parameters, the last not above the first; then a save
             and a load: optimizer 'lbfgs', memory 10, 57 leaves equal to
             the saved state.  Seconds, peak GiB, evaluations a step.
17. cli     - ``python -m gpmdm_tpu_torch`` in subprocesses with the
             platform pin unset (the card), each started as soon as the
             file it reads exists: train (Adam, 60 steps) and train
             --optimizer lbfgs (10 steps) on the synthetic fallback and
             eval of bench_model.npz at P = 500; eval --banked --trace of
             the trained model and deploy --sparsify 64 of it; rollout of
             the deployed one.  Each must exit 0;
             the asset's frame accuracy must reach 0.90, and the trace
             must name K1 (x_onepass or posterior_core<TP, 1>), K2
             (posterior_core<TP, 2>) and K3 (resample_rank_kernel).
18. sharded_bank - the distribution layer (gpmdm_tpu_torch.parallel) over
             NCCL: one process group of world 1 on cuda:0 (started here,
             torn down after sharded_predict), a ``dp`` mesh of one rank.
             evaluate_pf_banked(mesh=...) on the banked guard's 12 trials
             (P = 10,000, padded to 64 frames): frame accuracy >= 0.90,
             exactly 64 launches of each of K1, K2 and K3, one all-gather
             (after the scan) and the predictions of the unsharded guard
             with the same seed; aggregate frames/s beside banked_guard's
             and the unsharded call's.  pf_scan_bank_sharded over the fleet
             (64 x 1,000 x 64 frames) on injected noise: no collective in
             the scan, 64 launches of each kernel, and the readouts of
             pf_scan_bank on the same noise within the unsharded path's own
             run-to-run difference (0 when the kernels are deterministic);
             aggregate frames/s, best of 4, beside the fleet phase's and
             pf_scan_bank's (best of 4, the two alternating).  A group's
             NCCL communicator starts at its first collective, timed apart
             (first_collectives_s) before any rate.
19. sharded_train - bench_model_c8n5120.npz (C = 8, D = 10, d = 3, Ny =
             5,120, f32, with its Adam state) on make_train_mesh: (ep, tp) =
             (1, 1).  Both loss forms (replicated Cholesky; shard_chol, the
             distributed Cholesky): in float64 the loss within 1e-9 relative
             of core.nll and every gradient leaf within 1e-7 of its max
             magnitude (autograd of core.nll); in fp32 the loss within 1e-4
             of the unsharded fp32 loss; 5 train_adam_sharded steps from the
             asset's Adam state, each loss finite and within 1e-4 of the
             unsharded train_adam's at the same step; the collectives of a
             step equal the table pinned in tests/test_torch_parallel.py.
             Steps/s of all three.
20. sharded_predict - n5120's exact posterior (built in large_n):
             predict_y_rowsharded and predict_x_all_classes_rowsharded at P =
             10,000 (its initial cloud), cast to float64 on the card, within
             1e-9 x each output's median magnitude of core.predict_y /
             predict_x_all_classes in float64; the fp32 gaps reported, not
             gated (the quad's cancellation, ROADMAP C3).
             Each of these phases prints the backend, the world, NCCL's
             version and its seconds; at world 1 a collective is a copy on
             the card, so no collective's cost is measured.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
a global deadline turns a hang into an exit with the phase it was in.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import warnings

DEADLINE_S = 600
N_PARTICLES = 10_000
N_FRAMES = 1000
TIMED_RUNS = 4
FLEET_BANKS, FLEET_PARTICLES, FLEET_FRAMES = 64, 1000, 64
# timed runs of the sparsified fleet (bench.py:566-590)
SPARSE_FLEET_RUNS = 3
GUARD_MIN_FRAME_ACC = 0.90
# particle tiles of the posterior kernels, each timed beside the launcher's
# own choice
TILES = (64, 128)
# frames of the d4 and c8 assets' paths
EXTRA_FRAMES = 200
# the large-N assets' exact posteriors: K2 at their Ny, K1 at n5120's
# dynamics rows
LARGE_N = (("n2048", "bench_model_n2048.npz", False), ("n5120", "bench_model_n5120.npz", True))
# the large-N assets served as loaded: asset-guard shape, file, the ranks
# of the compressed posterior each persists, and whether the exact
# posterior's guard runs too
COMPRESSED_LARGE = (("n2048", "bench_model_n2048.npz", (148, 113), False),
                    ("n5120", "bench_model_n5120.npz", (188, 136), True))
# a kernel's max error on the well-conditioned inputs, relative to the
# output's median magnitude in float64
CONDITIONED_RTOL = 1e-4
TRANSITIONS = [[0.9, 0.1], [0.1, 0.9]]
# the bench_model.npz recipe (bench_assets/README.md) and the n2048 recipe
# (tools/train_bench_assets.py): sequences a class, frames a sequence, steps
TRAIN_RECIPE = {"n_seqs": 4, "seq_len": 60, "steps": 300}
N2048_RECIPE = {"n_seqs": 16, "seq_len": 64, "steps": 20}
TRAIN_LR = 0.01
TRAIN_FIRST_RTOL = 1e-3  # first f32 loss against the float64 loss
TRAIN_FINAL_RTOL = 0.05  # final loss against the committed asset's
# the sparse family at BASELINE.md's hour-long scale: Adam steps from the
# PCA init, and more steps resumed from the asset's stored Adam state
SPARSE_TRAIN_STEPS, SPARSE_RESUME_STEPS = 30, 20
# L-BFGS (optax.lbfgs, memory 10): steps from the recipe's PCA init, steps
# profiled after them, and steps resumed from hourlongh's stored state
LBFGS_STEPS, LBFGS_PROFILE_STEPS, LBFGS_RESUME_STEPS = 30, 3, 3
# the port's command line, run in subprocesses on the card: each one's
# time limit, and the kernels its eval --banked --trace must show (K1 in
# either design, K2, K3), by their names in the Chrome trace
CLI_TIMEOUT_S = 240
TRACE_KERNELS = {"fused_x_posterior": r"x_onepass|posterior_core<\d+, ?1>",
                 "fused_obs_loglik": r"posterior_core<\d+, ?2>",
                 "resample_rank": r"resample_rank_kernel"}
# the fp32 loss's tolerance against float64 is at least this, or 4 x the
# host's own fp32 gap where the cancellation in the trace term is larger
SPARSE_FIRST_RTOL = 1e-3
# Published fp32 (non-tensor-core) peak and memory rate by part, from
# NVIDIA's data sheets; the SXM part is the H100 "80GB HBM3".
PEAKS = {"PCIe": (51e12, 2.0e12), "NVL": (60e12, 3.9e12), "": (67e12, 3.35e12)}
ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "gpmdm_tpu_torch/ops/csrc/gp_posterior.cu"
RANK_CSRC = "gpmdm_tpu_torch/ops/csrc/resample_rank.cu"
REPLACES = {
    "fused_x_posterior": "gpmdm_tpu/ops/pallas/gp_posterior.py:216",
    "fused_rbf_posterior": "gpmdm_tpu/ops/pallas/gp_posterior.py:216",
    "fused_obs_loglik": "gpmdm_tpu/ops/pallas/gp_posterior.py:347",
    "resample_rank": "tools/exp_resample_rank_pallas.py:77",
}

_phase = ["start"]
# the processes this script starts, ended at the deadline
_children: list = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _on_deadline(signum, frame):
    emit({"phase": _phase[0], "error": f"deadline of {DEADLINE_S} s passed"})
    for proc in _children:
        if proc.poll() is None:
            proc.kill()
    os._exit(3)


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60)


def bound(flops: float, nbytes: float, peaks) -> tuple[float, str]:
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


def check_rank(rs, real_s, dirichlet, peaks):
    """K3 at one (banks, particles) shape: bit-identical to its plain
    version on the real frame's s and on Dirichlet s (sorted and
    shuffled), then timed on the real frame's s beside its plain version
    and torch.searchsorted."""
    import torch

    from gpmdm_tpu_torch.bench_kernels import time_ms

    cases = {"frame": real_s, "dirichlet": dirichlet[0], "dirichlet_shuffled": dirichlet[1]}
    errors = {}
    for label, s in cases.items():
        got, want = rs.resample_rank(s), rs.resample_rank_plain(s)
        torch.cuda.synchronize()
        errors[label] = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"resample_rank {tuple(s.shape)} {label}: differs from its "
                                 f"plain version by up to {errors[label]}")
    B, Pb = real_s.shape
    # searchsorted needs sorted input, and the real frame's s may not be:
    # the card's parallel fp32 cumsum can step down by an ulp.  The count
    # does not depend on the order, so the yardstick searches the sorted s.
    descents = int((real_s[:, 1:] < real_s[:, :-1]).sum())
    sorted_s = torch.sort(real_s, dim=1).values
    ranks = torch.arange(Pb, device=real_s.device, dtype=torch.int32).expand(B, Pb).contiguous()
    library = lambda: torch.searchsorted(sorted_s, ranks, right=True)
    if not torch.equal(torch.clamp(library(), max=Pb - 1), rs.resample_rank(real_s)):
        raise AssertionError(f"torch.searchsorted disagrees with K3 at {(B, Pb)}")
    bound_ms, bound_by = bound(*rank_work(B, Pb), peaks)
    return {"shape": [B, Pb], "max_abs_err": max(errors.values()), "errors": errors,
            "frame_s_descents": descents, "ms": time_ms(lambda: rs.resample_rank(real_s)),
            "plain_ms": time_ms(lambda: rs.resample_rank_plain(real_s)),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": time_ms(library)}


def compare(name, kernel, plain, args):
    """Per output: the kernel's and the plain fp32 version's max error
    against the plain version in float64 on the same inputs, and the
    largest and median magnitudes in float64."""
    import torch

    got = kernel(*args)
    ref32 = plain(*args)
    ref64 = plain(*[a.double() if torch.is_tensor(a) else a for a in args])
    torch.cuda.synchronize()
    outputs = {}
    for label, g, r32, r64 in zip(OUTPUT_NAMES[name], got, ref32, ref64):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite {label}")
        outputs[label] = {"max_abs_err": (g.double() - r64).abs().max().item(),
                          "plain_fp32_err": (r32.double() - r64).abs().max().item(),
                          "max_abs_ref": r64.abs().max().item(),
                          "median_abs_ref": r64.abs().median().item()}
    return outputs


def check_kernel(name, kernel, plain, args, conditioned_args, peaks, work, tiled=None,
                 gemm=None):
    """The kernel against its plain version on the path's inputs and on
    well-conditioned ones (see the module docstring), then timed; with
    ``tiled(tile)``, a call at a forced particle tile, also timed at each
    tile, and with ``gemm``, a yardstick call timed beside it."""
    from gpmdm_tpu_torch.bench_kernels import time_ms

    path = compare(name, kernel, plain, args)
    for label, o in path.items():
        o["tol"] = 4 * o["plain_fp32_err"] + 1e-6
        if not o["max_abs_err"] <= o["tol"]:
            raise AssertionError(f"{name}: {label} error {o['max_abs_err']:.3e} on the "
                                 f"path's inputs > tolerance {o['tol']:.3e}")
    conditioned = compare(name, kernel, plain, conditioned_args)
    for label, o in conditioned.items():
        o["tol"] = CONDITIONED_RTOL * o["median_abs_ref"]
        if not o["max_abs_err"] <= o["tol"]:
            raise AssertionError(f"{name}: {label} error {o['max_abs_err']:.3e} on the "
                                 f"conditioned inputs > tolerance {o['tol']:.3e}")
    ms = time_ms(lambda: kernel(*args))
    plain_ms = time_ms(lambda: plain(*args))
    bound_ms, bound_by = bound(*work, peaks)
    entry = {
        "name": name, "route": "cuda", "source": CSRC, "replaces": REPLACES[name],
        "launches": 0,
        "max_abs_err": max(o["max_abs_err"] for o in path.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "path_inputs": path, "conditioned_inputs": conditioned,
    }
    if tiled is not None:
        entry["tiles_ms"] = {str(tp): time_ms(lambda: tiled(tp)) for tp in TILES}
    if gemm is not None:
        entry["gemm_ms"] = time_ms(gemm)
    return entry


OUTPUT_NAMES = {
    "fused_x_posterior": ("mean", "quad"),
    "fused_rbf_posterior": ("mean", "quad"),
    "fused_obs_loglik": ("quad", "qres"),
}


def main(argv) -> int:
    signal.signal(signal.SIGALRM, _on_deadline)
    signal.alarm(DEADLINE_S)
    # a hang inside native code never returns to the interpreter's signal
    # handler: the watchdog thread ends the process shortly after
    faulthandler.dump_traceback_later(DEADLINE_S + 20, exit=True)
    t_start = time.perf_counter()

    _phase[0] = "device"
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from gpmdm_tpu_torch import BCGPMDM, GPMDM, GPMDM_PF, PFConfig, SparseGPMDM, TrainConfig
    from gpmdm_tpu_torch.bench_kernels import (RANK_SHAPES, conditioned, conditioned_classes,
                                               dirichlet_counts, gemm_yardstick, time_ms)
    from gpmdm_tpu_torch.data import synthetic
    from gpmdm_tpu_torch.filter import particle_filter as pf
    from gpmdm_tpu_torch.models import sparse as tsp
    from gpmdm_tpu_torch.models.compressed import CompressedPosterior
    from gpmdm_tpu_torch.ops import _build
    from gpmdm_tpu_torch.ops import gp_posterior as gpk
    from gpmdm_tpu_torch.ops import resample as rs
    from gpmdm_tpu_torch.train import trainer
    from gpmdm_tpu_torch.utils import asset_guard as ag
    from gpmdm_tpu_torch.utils.logging import MetricLogger
    from gpmdm_tpu_torch.utils.metrics import evaluate_pf, evaluate_pf_banked

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).stdout.strip().splitlines()[0]
    peaks = next(v for k, v in PEAKS.items() if k in kind)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "peak_fp32_flops": peaks[0], "peak_bytes_per_s": peaks[1]})

    _phase[0] = "build"
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    nvcc_version = _run([_build.nvcc_path(), "--version"]).stdout.strip().splitlines()[-1]
    emit({"phase": "build", "seconds": build_s, "nvcc": nvcc_version,
          "library": os.path.relpath(str(_build.build()), ROOT),
          "ninja": shutil.which("ninja")})

    _phase[0] = "kernels"
    model = GPMDM.load(os.path.join(ROOT, "bench_assets", "bench_model.npz"), device=dev)
    post, params, cfg = model.posterior, model.params, model.config
    C, n_max = post.Xin_c.shape[0], post.Xin_c.shape[1]
    _, _, test_seqs, _ = synthetic.make_dataset(
        n_classes=2, n_train_seqs=4, n_test_seqs=1, seq_len=60, D=cfg.D, seed=0)
    Z = torch.as_tensor(np.concatenate(test_seqs * 10, axis=0)[:N_FRAMES], device=dev)
    pfc = PFConfig(num_particles=N_PARTICLES, pallas="on")
    log_T = torch.log(torch.tensor(TRANSITIONS, device=dev, dtype=model.dtype))
    # particles where the filter puts them: its initial cloud
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = pf.pf_init(post, model.layout.y_class_offsets, gen, pfc).x.contiguous()
    P, d, D, Ny = xs.shape[0], cfg.d, cfg.D, post.X.shape[0]
    inv_ls_x = torch.exp(-params.x_log_lengthscales)
    lin_w = torch.exp(params.x_log_lin_coeff)
    inv_ls_y = torch.exp(-params.y_log_lengthscales)
    lam2 = torch.exp(2.0 * params.y_log_lambdas)
    Ax_cond, Kx_cond = conditioned_classes(C, n_max, d, dev, seed=1)
    Ay_cond, Ky_cond = conditioned(Ny, D, dev, seed=2)

    def check_k1(post_, xs_, inv_ls_, lin_w_, A_cond, K_cond):
        """K1 over all of post_'s classes in one launch, as the filter calls
        it, timed at every tile and, where it takes the one-pass design,
        on the streamed core too; with the design, tile and splits that
        the launcher chose."""
        Cx, n, Dout = post_.Axc.shape
        P_, din = xs_.shape
        args = (post_.Xin_c, xs_, post_.Axc, post_.Kxc_inv, inv_ls_, lin_w_, n)
        entry = check_kernel(
            "fused_x_posterior", gpk.fused_x_posterior_classes,
            gpk.fused_x_posterior_classes_plain, args,
            (post_.Xin_c, xs_, A_cond, K_cond, inv_ls_, lin_w_, n), peaks,
            posterior_work(n, P_, din, Dout, True, Cx),
            tiled=lambda tp: gpk._posterior_cuda("fused_x_posterior", *args, True, tile=tp))
        tp, splits, one, _, _ = gpk._plan(_build.library(), "fused_x_posterior", n, Dout, P_,
                                          0, dev, torch.cuda.current_stream(dev).cuda_stream,
                                          Cx, True)
        entry.update(design="one_pass" if one else "streamed", tile=tp, splits=splits,
                     classes=Cx, rows=n)
        if one:
            entry["streamed_ms"] = time_ms(lambda: gpk._posterior_cuda(
                "fused_x_posterior", *args, True, one_pass=False))
        return entry

    def check_k2(post_, xs_, inv_ls_, lam2_, z, A_cond, K_cond):
        """K2 on post_'s rows against z (one row per bank), timed at every
        tile and beside the gemm yardstick."""
        args = (post_.X, xs_, post_.Ay, post_.Ky_inv, inv_ls_, z, lam2_)
        n_z = z.shape[0] if z.dim() == 2 else 1
        return check_kernel(
            "fused_obs_loglik", gpk.fused_obs_loglik, gpk.fused_obs_loglik_plain, args,
            (post_.X, xs_, A_cond, K_cond, inv_ls_, z, lam2_), peaks,
            obs_work(post_.X.shape[0], xs_.shape[0], xs_.shape[1], post_.Ay.shape[1], n_z),
            tiled=lambda tp: gpk._obs_loglik_cuda(*args, tile=tp),
            gemm=gemm_yardstick(*args[:5]))

    kernels = [
        check_k1(post, xs, inv_ls_x, lin_w, Ax_cond, Kx_cond),
        check_kernel("fused_rbf_posterior", gpk.fused_rbf_posterior,
                     gpk.fused_rbf_posterior_plain,
                     (post.X, xs, post.Ay, post.Ky_inv, inv_ls_y),
                     (post.X, xs, Ay_cond, Ky_cond, inv_ls_y),
                     peaks, posterior_work(Ny, P, d, D, False)),
        check_k2(post, xs, inv_ls_y, lam2, Z[0], Ay_cond, Ky_cond),
    ]
    offsets = model.layout.y_class_offsets

    def bank_cloud(nb, pb):
        """The initial cloud of nb banks of pb particles, flat, and a bank step
        on the stream's first nb frames: its weights give K3 a real s."""
        cfg_b = PFConfig(num_particles=pb, pallas="on")
        g = torch.Generator(device=dev).manual_seed(nb * pb)
        st = pf.pf_init_bank(post, offsets, g, cfg_b, nb)
        new, _ = pf.pf_step_bank(st, Z[:nb], post, params, log_T, cfg, cfg_b, generator=g)
        log_w = new.log_lik - torch.logsumexp(new.log_lik, 1, keepdim=True)
        u = torch.rand(nb, generator=g, device=dev)
        return st.x.reshape(nb * pb, d).contiguous(), pf.systematic_counts(u, log_w)

    # K1 on the flat bank cloud, and K2 with one observation per bank (a
    # block's particle tile straddles two banks: 10,000 and 1,000 are not
    # multiples of 32 or 64), at the banked guard's and the fleet's shapes
    frame_s = {}
    kernels[0]["banked"], kernels[2]["banked"] = [], []
    for nb, pb in RANK_SHAPES:
        xb, frame_s[(nb, pb)] = bank_cloud(nb, pb)
        if nb == 1:
            continue
        zb = Z[:nb].contiguous()
        banked = ((0, check_k1(post, xb, inv_ls_x, lin_w, Ax_cond, Kx_cond)),
                  (2, check_k2(post, xb, inv_ls_y, lam2, zb, Ay_cond, Ky_cond)))
        for i, entry in banked:
            entry["shape"] = [nb, pb]
            kernels[i]["banked"].append(entry)
    # K1 at the d4 and c8 assets' widths and classes, on their initial clouds
    kernels[0]["assets"] = []
    for label, fname in (("d4", "bench_model_d4.npz"), ("c8", "bench_model_c8.npz")):
        m = GPMDM.load(os.path.join(ROOT, "bench_assets", fname), device=dev)
        pst, prm = m.posterior, m.params
        g = torch.Generator(device=dev).manual_seed(0)
        xa = pf.pf_init(pst, m.layout.y_class_offsets, g, pfc).x.contiguous()
        entry = check_k1(pst, xa, torch.exp(-prm.x_log_lengthscales),
                         torch.exp(prm.x_log_lin_coeff),
                         *conditioned_classes(*pst.Axc.shape, dev, seed=5))
        entry.update(asset=label, shape=[1, xa.shape[0]])
        kernels[0]["assets"].append(entry)
        del m, pst, prm, xa
    rank_shapes = [check_rank(rs, frame_s[(nb, pb)], dirichlet_counts(nb, pb, nb + pb, dev),
                              peaks) for nb, pb in RANK_SHAPES]
    kernels.append({"name": "resample_rank", "route": "cuda", "source": RANK_CSRC,
                    "replaces": REPLACES["resample_rank"], "launches": 0,
                    **{k: v for k, v in rank_shapes[0].items() if k not in ("shape", "errors")},
                    "shapes": rank_shapes})
    emit({"phase": "kernels", "shapes": {"P": P, "d": d, "D": D, "Ny": Ny, "n_max": n_max,
                                         "C": C},
          "kernels": kernels})

    _phase[0] = "large_n"
    kernels[0]["large_n"], kernels[2]["large_n"] = [], []
    for label, fname, with_k1 in LARGE_N:
        m = GPMDM.load(os.path.join(ROOT, "bench_assets", fname), device=dev)
        pst, prm = m.posterior, m.params
        g = torch.Generator(device=dev).manual_seed(0)
        xl = pf.pf_init(pst, m.layout.y_class_offsets, g, pfc).x.contiguous()
        checks = [(2, pst.X.shape[0],
                   check_k2(pst, xl, torch.exp(-prm.y_log_lengthscales),
                            torch.exp(2.0 * prm.y_log_lambdas), Z[0],
                            *conditioned(pst.X.shape[0], m.D, dev, seed=3)))]
        if with_k1:
            checks.append((0, pst.Xin_c.shape[1],
                           check_k1(pst, xl, torch.exp(-prm.x_log_lengthscales),
                                    torch.exp(prm.x_log_lin_coeff),
                                    *conditioned_classes(*pst.Axc.shape, dev, seed=4))))
        for i, rows, entry in checks:
            entry.update(asset=label, rows=rows, shape=[1, xl.shape[0]])
            kernels[i]["large_n"].append(entry)
        if label == "n5120":  # its exact posterior serves sharded_predict too
            n5120 = (m, xl)
        del m, pst, prm, xl, checks
        torch.cuda.empty_cache()
    emit({"phase": "large_n", "kernels": [
        {k: v for k, v in e.items() if k not in ("conditioned_inputs",)}
        for i in (2, 0) for e in kernels[i]["large_n"]]})

    def reset_launches():
        gpk.reset_launches()
        rs.reset_launches()

    def check_launches(label, frames, exact=True):
        """The counters against ``frames`` frames of one launch each of K1
        (every class at once), K2 and K3, whatever the number of banks and
        classes; on a compressed or sparse posterior (``exact=False``) of K3
        alone."""
        got = {**gpk.LAUNCHES, **rs.LAUNCHES}
        k = frames if exact else 0
        want = {"fused_x_posterior": k, "fused_rbf_posterior": 0,
                "fused_obs_loglik": k, "resample_rank": frames}
        if got != want:
            raise AssertionError(f"{label}: launch counts {got}, expected {want}")
        return got

    _phase[0] = "path"

    def run_path(config, post_=post):
        """pf_init + pf_scan over the stream on post_, timed: (seconds,
        outputs)."""
        g = torch.Generator(device=dev).manual_seed(0)
        s0 = pf.pf_init(post_, model.layout.y_class_offsets, g, config)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, o = pf.pf_scan(s0, Z, post_, params, log_T, cfg, config, generator=g)
        torch.cuda.synchronize()
        return time.perf_counter() - t, o

    def check_outputs(label, o, frames, classes):
        probs = o.class_probs
        if probs.shape != (frames, classes) or not torch.isfinite(probs).all():
            raise AssertionError(f"{label}: class_probs not finite or of the wrong shape")
        if not torch.allclose(probs.sum(1), torch.ones_like(probs[:, 0]), atol=1e-4):
            raise AssertionError(f"{label}: class_probs rows do not sum to 1")
        if not torch.isfinite(o.state_mean).all():
            raise AssertionError(f"{label}: state_mean not finite")

    reset_launches()
    wall, outs = run_path(pfc)
    launches = check_launches("path", N_FRAMES)
    check_outputs("path", outs, N_FRAMES, C)
    walls = [wall] + [run_path(pfc)[0] for _ in range(TIMED_RUNS - 1)]
    plain_wall = run_path(PFConfig(num_particles=N_PARTICLES, pallas="off"))[0]
    best = min(walls)
    path_fps = N_FRAMES / best
    for k in kernels:
        k["launches"] = launches[k["name"]]
    emit({"phase": "path", "particles": N_PARTICLES, "frames": N_FRAMES,
          "launches": launches, "fps": N_FRAMES / best, "ms_per_frame": 1e3 * best / N_FRAMES,
          "walls_s": walls, "plain_path_fps": N_FRAMES / plain_wall,
          "kernel_ms_per_frame": kernels[0]["ms"] + kernels[2]["ms"] + kernels[3]["ms"],
          "device": kind, "nvidia_smi": smi})

    if "--profile" in argv:
        _phase[0] = "profile"

        def window(nb, pb, frames):
            """A steady window of ``frames`` frames of nb banks of pb particles."""
            cfg_b = PFConfig(num_particles=pb, pallas="on")
            g = torch.Generator(device=dev).manual_seed(0)
            st = pf.pf_init_bank(post, offsets, g, cfg_b, nb)
            Zb = Z[None, :5 + frames].expand(nb, 5 + frames, D)
            st, _ = pf.pf_scan_bank(st, Zb[:, :5], post, params, log_T, cfg, cfg_b, generator=g)
            return lambda: pf.pf_scan_bank(st, Zb[:, 5:], post, params, log_T, cfg, cfg_b,
                                           generator=g)

        for label, nb, pb, frames in (("path", 1, N_PARTICLES, 50),
                                      ("banked_guard", 12, N_PARTICLES, 20),
                                      ("fleet", FLEET_BANKS, FLEET_PARTICLES, 20)):
            emit({"phase": "profile", "path": label, "banks": nb, "particles": pb,
                  **profile(window(nb, pb, frames), frames)})

    _phase[0] = "guard"
    _, _, q_seqs, q_labels = synthetic.make_dataset(
        n_classes=2, n_train_seqs=4, n_test_seqs=6, seq_len=60, D=cfg.D, seed=0)
    flt = GPMDM_PF(model, TRANSITIONS, N_PARTICLES, config=pfc, seed=0, posterior="exact")
    rep = evaluate_pf(flt, q_seqs, q_labels, C, burn_in=5)
    acc = rep.frame_metrics["accuracy"]
    emit({"phase": "guard", "frame_acc": acc, "frame_f1": rep.frame_metrics["f1"],
          "trial_acc": rep.trial_metrics["accuracy"], "frames": rep.total_frames,
          "particles": N_PARTICLES, "min_frame_acc": GUARD_MIN_FRAME_ACC})
    if not acc >= GUARD_MIN_FRAME_ACC:
        raise AssertionError(f"guard frame accuracy {acc} < {GUARD_MIN_FRAME_ACC}")

    _phase[0] = "banked_guard"
    T_pad = pf.bucket_length(max(len(q) for q in q_seqs))
    reset_launches()
    rep = evaluate_pf_banked(model, TRANSITIONS, q_seqs, q_labels, num_particles=N_PARTICLES,
                             burn_in=5, seed=0, config=pfc)
    banked_launches = check_launches("banked_guard", T_pad)
    acc = rep.frame_metrics["accuracy"]
    emit({"phase": "banked_guard", "frame_acc": acc, "frame_f1": rep.frame_metrics["f1"],
          "trial_acc": rep.trial_metrics["accuracy"], "frames": rep.total_frames,
          "banks": len(q_seqs), "particles_per_bank": N_PARTICLES, "padded_frames": T_pad,
          "wall_s": rep.total_wall_s, "agg_fps": rep.fps,
          "padded_agg_fps": len(q_seqs) * T_pad / rep.total_wall_s,
          "launches": banked_launches, "min_frame_acc": GUARD_MIN_FRAME_ACC})
    if not acc >= GUARD_MIN_FRAME_ACC:
        raise AssertionError(f"banked guard frame accuracy {acc} < {GUARD_MIN_FRAME_ACC}")
    asset_guard = {"frame_acc": acc, "frame_f1": rep.frame_metrics["f1"],
                   "agg_fps": rep.fps}

    _phase[0] = "fleet"
    Zf = Z[None, :FLEET_FRAMES].expand(FLEET_BANKS, FLEET_FRAMES, D)

    def run_fleet(config, post_=post):
        g = torch.Generator(device=dev).manual_seed(1)
        s0 = pf.pf_init_bank(post_, offsets, g, config, FLEET_BANKS)
        reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, o = pf.pf_scan_bank(s0, Zf, post_, params, log_T, cfg, config, generator=g)
        torch.cuda.synchronize()
        return time.perf_counter() - t, o

    fleet_cfg = PFConfig(num_particles=FLEET_PARTICLES, pallas="on")
    fleet_walls = []
    for _ in range(TIMED_RUNS):
        wall, outs = run_fleet(fleet_cfg)
        fleet_launches = check_launches("fleet", FLEET_FRAMES)
        fleet_walls.append(wall)
    probs = outs.class_probs
    if probs.shape != (FLEET_BANKS, FLEET_FRAMES, C) or not torch.isfinite(probs).all():
        raise AssertionError("fleet class_probs not finite or of the wrong shape")
    fleet_plain_wall = run_fleet(dataclasses.replace(fleet_cfg, pallas="off"))[0]
    emit({"phase": "fleet", "banks": FLEET_BANKS, "particles_per_bank": FLEET_PARTICLES,
          "frames": FLEET_FRAMES, "launches": fleet_launches,
          "agg_fps": FLEET_BANKS * FLEET_FRAMES / min(fleet_walls), "walls_s": fleet_walls,
          "plain_agg_fps": FLEET_BANKS * FLEET_FRAMES / fleet_plain_wall,
          "device": kind, "nvidia_smi": smi})

    def extra_asset(label, fname, Zx, trials, trial_labels, T):
        """The asset's 200-frame path at P = 10,000 and its banked guard on
        bench.py's trials, each with exact launch counts; the guard's
        accuracy is reported, not gated, beside the same guard on the plain
        versions."""
        m = GPMDM.load(os.path.join(ROOT, "bench_assets", fname), device=dev)
        pst, prm, cfg_x = m.posterior, m.params, m.config
        Cx = pst.Xin_c.shape[0]
        log_Tx = torch.log(torch.as_tensor(np.asarray(T), device=dev, dtype=m.dtype))

        def run():
            g = torch.Generator(device=dev).manual_seed(0)
            s0 = pf.pf_init(pst, m.layout.y_class_offsets, g, pfc)
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, o = pf.pf_scan(s0, Zx, pst, prm, log_Tx, cfg_x, pfc, generator=g)
            torch.cuda.synchronize()
            return time.perf_counter() - t, o

        reset_launches()
        wall, o = run()
        path_launches = check_launches(f"{label} path", EXTRA_FRAMES)
        check_outputs(f"{label} path", o, EXTRA_FRAMES, Cx)
        walls = [wall, run()[0]]
        T_pad = pf.bucket_length(max(len(q) for q in trials))
        reset_launches()
        rep = evaluate_pf_banked(m, T, trials, trial_labels, num_particles=N_PARTICLES,
                                 burn_in=5, seed=0, config=pfc)
        guard_launches = check_launches(f"{label} banked guard", T_pad)
        plain = evaluate_pf_banked(m, T, trials, trial_labels, num_particles=N_PARTICLES,
                                   burn_in=5, seed=0,
                                   config=dataclasses.replace(pfc, pallas="off"))
        emit({"phase": label, "classes": Cx, "d": m.d, "D": m.D, "Ny": pst.X.shape[0],
              "n_max": pst.Xin_c.shape[1], "particles": N_PARTICLES, "frames": EXTRA_FRAMES,
              "path_launches": path_launches, "fps": EXTRA_FRAMES / min(walls),
              "walls_s": walls, "banked_guard": {
                  "frame_acc": rep.frame_metrics["accuracy"], "frame_f1": rep.frame_metrics["f1"],
                  "trial_acc": rep.trial_metrics["accuracy"], "frames": rep.total_frames,
                  "banks": len(trials), "padded_frames": T_pad, "wall_s": rep.total_wall_s,
                  "agg_fps": rep.fps, "launches": guard_launches},
              "plain_banked_guard": {"frame_acc": plain.frame_metrics["accuracy"],
                                     "frame_f1": plain.frame_metrics["f1"]},
              "device": kind, "nvidia_smi": smi})
        return path_launches, guard_launches, {"frame_acc": rep.frame_metrics["accuracy"],
                                               "frame_f1": rep.frame_metrics["f1"]}

    # bench.py's extras: d4 on the headline's stream and trials; c8 on its
    # 8-class task (bench.py:328-366), deployed exact
    _phase[0] = "d4"
    d4 = extra_asset("d4", "bench_model_d4.npz", Z[:EXTRA_FRAMES].contiguous(), q_seqs,
                     q_labels, TRANSITIONS)
    _phase[0] = "c8"
    _, _, te8, tel8 = synthetic.make_dataset(
        n_classes=8, n_train_seqs=2, n_test_seqs=2, seq_len=60, D=10, seed=21,
        center_spread=3.0, class_signature=1.0)
    T8 = np.full((8, 8), 0.1 / 7)
    np.fill_diagonal(T8, 0.9)
    Z8 = torch.as_tensor(np.concatenate(te8 * 10, axis=0)[:EXTRA_FRAMES], device=dev,
                         dtype=torch.float32)
    c8 = extra_asset("c8", "bench_model_c8.npz", Z8, te8, tel8, T8)

    # The compressed posterior: cuBLAS products and K3, in full fp32.
    def check_precision(label):
        if torch.backends.cuda.matmul.allow_tf32 is not False or \
                torch.get_float32_matmul_precision() != "highest":
            raise AssertionError(f"{label}: fp32 matmuls must not use TF32")

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30

    def timed_filter(flt, Zx):
        """GPMDM_PF.run over Zx from its seed, timed: (seconds, outputs)."""
        flt.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        o = flt.run(Zx)
        torch.cuda.synchronize()
        return time.perf_counter() - t, o

    _phase[0] = "compressed"
    check_precision("compressed")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cp = model.compressed_posterior()
    build_cp_s = time.perf_counter() - t0
    reset_launches()
    wall, outs = run_path(pfc, cp)
    comp_path_launches = check_launches("compressed path", N_FRAMES, exact=False)
    check_outputs("compressed path", outs, N_FRAMES, C)
    walls = [wall] + [run_path(pfc, cp)[0] for _ in range(TIMED_RUNS - 1)]
    path_peak = peak_gib()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rep = evaluate_pf_banked(model, TRANSITIONS, q_seqs, q_labels, num_particles=N_PARTICLES,
                             burn_in=5, seed=0, config=pfc, posterior=cp)
    comp_guard_launches = check_launches("compressed banked guard", T_pad, exact=False)
    check_precision("compressed")
    acc = rep.frame_metrics["accuracy"]
    emit({"phase": "compressed", "rank_y": cp.rank_y, "rank_x": cp.rank_x,
          "compress_host_s": build_cp_s, "particles": N_PARTICLES, "frames": N_FRAMES,
          "path_launches": comp_path_launches, "fps": N_FRAMES / min(walls), "walls_s": walls,
          "exact_path_fps": path_fps, "path_peak_gib": path_peak,
          "banked_guard": {"frame_acc": acc, "frame_f1": rep.frame_metrics["f1"],
                           "trial_acc": rep.trial_metrics["accuracy"],
                           "frames": rep.total_frames, "banks": len(q_seqs),
                           "padded_frames": T_pad, "wall_s": rep.total_wall_s,
                           "agg_fps": rep.fps, "launches": comp_guard_launches,
                           "peak_gib": peak_gib()},
          "exact_banked_guard": asset_guard, "min_frame_acc": GUARD_MIN_FRAME_ACC,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision(),
          "device": kind, "nvidia_smi": smi})
    if not acc >= GUARD_MIN_FRAME_ACC:
        raise AssertionError(f"compressed banked guard frame accuracy {acc} < "
                             f"{GUARD_MIN_FRAME_ACC}")
    if "--profile" in argv:
        cfg_p = PFConfig(num_particles=N_PARTICLES, pallas="on")
        g = torch.Generator(device=dev).manual_seed(0)
        st = pf.pf_init(cp, offsets, g, cfg_p)
        st, _ = pf.pf_scan(st, Z[:5], cp, params, log_T, cfg, cfg_p, generator=g)
        emit({"phase": "profile", "path": "compressed_path", "banks": 1,
              "particles": N_PARTICLES,
              **profile(lambda: pf.pf_scan(st, Z[5:55], cp, params, log_T, cfg, cfg_p,
                                           generator=g), 50)})
    del cp

    compressed_launches = {}
    for name, fname, ranks, exact_guard in COMPRESSED_LARGE:
        label = f"compressed_{name}"
        _phase[0] = label
        check_precision(label)
        torch.cuda.reset_peak_memory_stats()
        m = GPMDM.load(os.path.join(ROOT, "bench_assets", fname), device=dev)
        cpx = pf.resolve_posterior(m, "auto")
        if not isinstance(cpx, CompressedPosterior) or (cpx.rank_y, cpx.rank_x) != ranks:
            raise AssertionError(f"{label}: 'auto' resolved to {type(cpx).__name__} "
                                 f"{getattr(cpx, 'rank_y', None)}/{getattr(cpx, 'rank_x', None)}, "
                                 f"expected the persisted CompressedPosterior {ranks}")
        Zx = Z[:EXTRA_FRAMES].contiguous()
        flt = GPMDM_PF(m, TRANSITIONS, N_PARTICLES, config=pfc, seed=0)
        reset_launches()
        wall, o = timed_filter(flt, Zx)
        lp = check_launches(f"{label} path", EXTRA_FRAMES, exact=False)
        check_outputs(f"{label} path", o, EXTRA_FRAMES, 2)
        walls = [wall, timed_filter(flt, Zx)[0]]
        path_peak = peak_gib()
        torch.cuda.reset_peak_memory_stats()
        trials = ag.guard_trials(name)[0]
        T_pad_x = pf.bucket_length(max(len(q) for q in trials))
        reset_launches()
        rep = ag.guard_report(m, name, particles=N_PARTICLES, posterior=cpx)
        lg = check_launches(f"{label} banked guard", T_pad_x, exact=False)
        check_precision(label)
        if m._posterior is not None:
            raise AssertionError(f"{label}: the exact posterior was built")
        acc = rep.frame_metrics["accuracy"]
        entry = {"phase": label, "Ny": m.layout.Ny, "n_max": m.layout.n_max,
                 "rank_y": cpx.rank_y, "rank_x": cpx.rank_x, "particles": N_PARTICLES,
                 "frames": EXTRA_FRAMES, "path_launches": lp,
                 "fps": EXTRA_FRAMES / min(walls), "walls_s": walls, "path_peak_gib": path_peak,
                 "banked_guard": {"frame_acc": acc, "frame_f1": rep.frame_metrics["f1"],
                                  "trial_acc": rep.trial_metrics["accuracy"],
                                  "frames": rep.total_frames, "banks": len(trials),
                                  "padded_frames": T_pad_x, "wall_s": rep.total_wall_s,
                                  "agg_fps": rep.fps, "launches": lg, "peak_gib": peak_gib()},
                 "exact_posterior_built": False, "receipt": m._guard_receipt,
                 "min_frame_acc": GUARD_MIN_FRAME_ACC}
        compressed_launches[f"{label}_path"] = lp
        compressed_launches[f"{label}_banked_guard"] = lg
        if "--profile" in argv:
            for nb, frames in ((1, 50), (len(trials), 10)):
                g = torch.Generator(device=dev).manual_seed(0)
                st = pf.pf_init_bank(cpx, m.layout.y_class_offsets, g, pfc, nb)
                Zb = Zx[None, :frames].expand(nb, frames, m.D)
                emit({"phase": "profile", "path": f"{label}_{nb}x{N_PARTICLES}", "banks": nb,
                      "particles": N_PARTICLES,
                      **profile(lambda: pf.pf_scan_bank(st, Zb, cpx, m.params, log_T, m.config,
                                                        pfc, generator=g), frames)})
        if not acc >= GUARD_MIN_FRAME_ACC:
            emit(entry)
            raise AssertionError(f"{label}: banked guard frame accuracy {acc} < "
                                 f"{GUARD_MIN_FRAME_ACC}")
        # the exact posterior on the same asset, for the ratio
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fe = GPMDM_PF(m, TRANSITIONS, N_PARTICLES, config=pfc, seed=0, posterior="exact")
        entry["exact_build_s"] = time.perf_counter() - t0
        entry["exact_warnings"] = [str(w.message)[:120] for w in caught]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        wall, o = timed_filter(fe, Zx)
        le = check_launches(f"exact_{name} path", EXTRA_FRAMES)
        check_outputs(f"exact_{name} path", o, EXTRA_FRAMES, 2)
        ewalls = [wall, timed_filter(fe, Zx)[0]]
        entry.update(exact_fps=EXTRA_FRAMES / min(ewalls), exact_walls_s=ewalls,
                     exact_path_peak_gib=peak_gib(),
                     fps_ratio=(EXTRA_FRAMES / min(walls)) / (EXTRA_FRAMES / min(ewalls)))
        compressed_launches[f"exact_{name}_path"] = le
        if exact_guard:
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            rep = ag.guard_report(m, name, particles=N_PARTICLES, posterior=m.posterior)
            compressed_launches[f"exact_{name}_banked_guard"] = check_launches(
                f"exact_{name} banked guard", T_pad_x)
            eacc = rep.frame_metrics["accuracy"]
            entry["exact_banked_guard"] = {
                "frame_acc": eacc, "frame_f1": rep.frame_metrics["f1"],
                "trial_acc": rep.trial_metrics["accuracy"], "wall_s": rep.total_wall_s,
                "agg_fps": rep.fps, "peak_gib": peak_gib()}
            if not eacc >= GUARD_MIN_FRAME_ACC:
                emit(entry)
                raise AssertionError(f"exact_{name}: banked guard frame accuracy {eacc} < "
                                     f"{GUARD_MIN_FRAME_ACC}")
        emit({**entry, "device": kind, "nvidia_smi": smi})
        del m, cpx, flt, fe
        torch.cuda.empty_cache()

    _phase[0] = "compressed_c8n5120"
    check_precision("compressed_c8n5120")
    m = GPMDM.load(os.path.join(ROOT, "bench_assets", "bench_model_c8n5120.npz"), device=dev)
    rec, m._deploy_recommendation = m._deploy_recommendation, None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cpx = pf.resolve_posterior(m, "auto")
    m._deploy_recommendation = rec
    flat = [str(w.message) for w in caught if "flat-spectrum band" in str(w.message)]
    if not flat or cpx is not pf.resolve_posterior(m, "compressed"):
        raise AssertionError("compressed_c8n5120: 'auto' without its recommendation did "
                             "not warn of the flat spectrum and serve the cached posterior")
    torch.cuda.reset_peak_memory_stats()
    flt = GPMDM_PF(m, T8, N_PARTICLES, config=pfc, seed=0, posterior="compressed")
    reset_launches()
    wall, o = timed_filter(flt, Z8)
    lp = check_launches("compressed_c8n5120 path", EXTRA_FRAMES, exact=False)
    check_outputs("compressed_c8n5120 path", o, EXTRA_FRAMES, 8)
    walls = [wall, timed_filter(flt, Z8)[0]]
    path_peak = peak_gib()
    trials = ag.guard_trials("c8n5120")[0]
    T_pad_x = pf.bucket_length(max(len(q) for q in trials))
    n_calls = -(-len(trials) // ag.SHAPES["c8n5120"]["guard_banks"])
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rep = ag.guard_report(m, "c8n5120", particles=N_PARTICLES, posterior=cpx)
    lg = check_launches("compressed_c8n5120 banked guard", n_calls * T_pad_x, exact=False)
    check_precision("compressed_c8n5120")
    if m._posterior is not None:
        raise AssertionError("compressed_c8n5120: the exact posterior was built")
    compressed_launches["compressed_c8n5120_path"] = lp
    compressed_launches["compressed_c8n5120_banked_guard"] = lg
    emit({"phase": "compressed_c8n5120", "Ny": m.layout.Ny, "classes": m.n_classes,
          "rank_y": cpx.rank_y, "rank_x": cpx.rank_x,
          "flat_band_warning": flat[0][:120], "particles": N_PARTICLES, "frames": EXTRA_FRAMES,
          "path_launches": lp, "fps": EXTRA_FRAMES / min(walls), "walls_s": walls,
          "path_peak_gib": path_peak,
          "banked_guard": {"frame_acc": rep.frame_metrics["accuracy"],
                           "frame_f1": rep.frame_metrics["f1"],
                           "trial_acc": rep.trial_metrics["accuracy"],
                           "frames": rep.total_frames, "banks": len(trials),
                           "banks_per_call": ag.SHAPES["c8n5120"]["guard_banks"],
                           "padded_frames": T_pad_x, "wall_s": rep.total_wall_s,
                           "agg_fps": rep.fps, "launches": lg, "peak_gib": peak_gib(),
                           "gated": False},
          "receipt": m._guard_receipt, "device": kind, "nvidia_smi": smi})
    del m, cpx, flt
    torch.cuda.empty_cache()

    # The sparse family: SGPR posteriors (cuBLAS products and triangular
    # solves) and K3, K1 = K2 = 0 on every phase.
    sparse_launches = {}

    def sparse_guard(label, m, post, trials, trial_labels, T, config, gated, max_banks=None):
        """evaluate_pf_banked on post with exact launch counts (K3 once a
        padded frame of every call): its report as a dict, gated at
        GUARD_MIN_FRAME_ACC when ``gated``."""
        check_precision(label)
        T_pad_x = pf.bucket_length(max(len(q) for q in trials))
        n_calls = 1 if max_banks is None else -(-len(trials) // max_banks)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        rep = evaluate_pf_banked(m, T, trials, trial_labels, burn_in=5, seed=0, config=config,
                                 posterior=post, max_banks=max_banks)
        lg = check_launches(f"{label} banked guard", n_calls * T_pad_x, exact=False)
        check_precision(label)
        sparse_launches[f"{label}_banked_guard"] = lg
        acc = rep.frame_metrics["accuracy"]
        out = {"frame_acc": acc, "frame_f1": rep.frame_metrics["f1"],
               "trial_acc": rep.trial_metrics["accuracy"], "frames": rep.total_frames,
               "banks": len(trials), "banks_per_call": max_banks or len(trials),
               "particles_per_bank": config.num_particles, "padded_frames": T_pad_x,
               "wall_s": rep.total_wall_s, "agg_fps": rep.fps, "launches": lg,
               "peak_gib": peak_gib(), "gated": gated}
        if gated and not acc >= GUARD_MIN_FRAME_ACC:
            emit({"phase": label, "banked_guard": out})
            raise AssertionError(f"{label}: banked guard frame accuracy {acc} < "
                                 f"{GUARD_MIN_FRAME_ACC}")
        return out

    def sparse_path(label, m, post, Zx, T, runs=2):
        """GPMDM_PF's path over Zx at P = 10,000 on post, best of ``runs``,
        with exact launch counts and finite outputs."""
        check_precision(label)
        torch.cuda.reset_peak_memory_stats()
        flt = GPMDM_PF(m, T, N_PARTICLES, config=pfc, seed=0, posterior=post)
        reset_launches()
        wall, o = timed_filter(flt, Zx)
        lp = check_launches(f"{label} path", len(Zx), exact=False)
        check_outputs(f"{label} path", o, len(Zx), m.n_classes)
        walls = [wall] + [timed_filter(flt, Zx)[0] for _ in range(runs - 1)]
        sparse_launches[f"{label}_path"] = lp
        return {"particles": N_PARTICLES, "frames": len(Zx), "path_launches": lp,
                "fps": len(Zx) / min(walls), "walls_s": walls, "path_peak_gib": peak_gib()}

    def describe(post):
        return {"My": post.Zy.shape[0], "Mx": post.Zx.shape[1], "classes": post.Zx.shape[0],
                "Ny": post.X.shape[0], "distilled": post.distilled,
                "variance_path": ("hoisted" if pf._effective_quad_precision(pfc, post)
                                  else "trisolve")}

    def load_sparse(fname):
        """A SparseGPMDM asset as loaded, the load timed, and the posterior
        'auto' serves: its own."""
        t0 = time.perf_counter()
        m = GPMDM.load(os.path.join(ROOT, "bench_assets", fname), device=dev)
        load_s = time.perf_counter() - t0
        post = pf.resolve_posterior(m, "auto")
        if type(m).__name__ != "SparseGPMDM" or post is not m.posterior or post.distilled:
            raise AssertionError(f"{fname}: 'auto' did not serve the sparse model's own "
                                 "posterior")
        return m, post, load_s

    _phase[0] = "sparse_hourlong"
    m, post_s, load_s = load_sparse("bench_model_hourlong.npz")
    entry = {"phase": "sparse_hourlong", "load_s": load_s, **describe(post_s),
             **sparse_path("sparse_hourlong", m, post_s, Z[:EXTRA_FRAMES].contiguous(),
                           TRANSITIONS)}
    if "--profile" in argv:
        for nb, frames in ((1, 50), (len(ag.guard_trials("hourlong")[0]), 10)):
            g = torch.Generator(device=dev).manual_seed(0)
            st = pf.pf_init_bank(post_s, m.layout.y_class_offsets, g, pfc, nb)
            Zb = Z[None, :frames].expand(nb, frames, m.D)
            emit({"phase": "profile", "path": f"sparse_hourlong_{nb}x{N_PARTICLES}",
                  "banks": nb, "particles": N_PARTICLES,
                  **profile(lambda: pf.pf_scan_bank(st, Zb, post_s, m.params, log_T, m.config,
                                                    pfc, generator=g), frames)})
    entry["banked_guard"] = sparse_guard("sparse_hourlong", m, post_s,
                                         *ag.guard_trials("hourlong"), pfc, gated=True)
    emit({**entry, "receipt": m._guard_receipt, "min_frame_acc": GUARD_MIN_FRAME_ACC,
          "device": kind, "nvidia_smi": smi})
    hourlong_guard = entry["banked_guard"]
    del m, post_s

    for name, fname, shape in (("sparse_hourlongh", "bench_model_hourlongh.npz", "hourlong"),
                               ("sparse10240", "bench_model_sparse10240.npz", "sparse10240")):
        _phase[0] = name
        m, post_s, load_s = load_sparse(fname)
        guard = sparse_guard(name, m, post_s, *ag.guard_trials(shape), pfc, gated=False)
        emit({"phase": name, "load_s": load_s, **describe(post_s), "banked_guard": guard,
              "receipt": m._guard_receipt, "device": kind, "nvidia_smi": smi})
        del m, post_s
        torch.cuda.empty_cache()

    def load_sparsified(fname, key):
        """An exact asset as loaded and the posterior 'auto' serves: the
        persisted distillation under ``key``, with no exact build and no
        distillation."""
        m = GPMDM.load(os.path.join(ROOT, "bench_assets", fname), device=dev)
        post = pf.resolve_posterior(m, "auto")
        if post is not m._sparsified_cache.get(key) or not post.distilled \
                or m._posterior is not None:
            raise AssertionError(f"{fname}: 'auto' did not serve the persisted {key}")
        return m, post

    _phase[0] = "sparsified_c8"
    m, post_s = load_sparsified("bench_model_c8.npz", (128, None, "kmeans"))
    entry = {"phase": "sparsified_c8", **describe(post_s),
             **sparse_path("sparsified_c8", m, post_s, Z8, T8),
             "banked_guard": sparse_guard("sparsified_c8", m, post_s, te8, tel8, T8, pfc,
                                          gated=False)}
    if m._posterior is not None:
        raise AssertionError("sparsified_c8: the exact posterior was built")
    emit({**entry, "exact_c8_banked_guard": c8[2], "device": kind, "nvidia_smi": smi})
    del m, post_s

    _phase[0] = "sparsified_c8n5120"
    m, post_s = load_sparsified("bench_model_c8n5120.npz", (384, None, "kmeans"))
    trials, trial_labels, T85 = ag.guard_trials("c8n5120")
    Z85 = torch.as_tensor(np.concatenate(trials * 10, axis=0)[:EXTRA_FRAMES], device=dev,
                          dtype=torch.float32)
    entry = {"phase": "sparsified_c8n5120", **describe(post_s),
             **sparse_path("sparsified_c8n5120", m, post_s, Z85, T85),
             "banked_guard": sparse_guard("sparsified_c8n5120", m, post_s, trials, trial_labels,
                                          T85, pfc, gated=True,
                                          max_banks=ag.SHAPES["c8n5120"]["guard_banks"])}
    if m._posterior is not None:
        raise AssertionError("sparsified_c8n5120: the exact posterior was built")
    emit({**entry, "receipt": m._guard_receipt, "recommendation": m._deploy_recommendation,
          "min_frame_acc": GUARD_MIN_FRAME_ACC, "device": kind, "nvidia_smi": smi})
    del m, post_s
    torch.cuda.empty_cache()

    _phase[0] = "sparsified_fleet"
    check_precision("sparsified_fleet")
    sp_head = model.sparsified_posterior(128)
    if sp_head is not model._sparsified_cache.get((128, None)) or not sp_head.distilled:
        raise AssertionError("sparsified_fleet: not the persisted M = 128 distillation")
    fleet_q = PFConfig(num_particles=FLEET_PARTICLES, quad_precision="high")
    torch.cuda.reset_peak_memory_stats()
    sp_fleet_walls = []
    for _ in range(SPARSE_FLEET_RUNS):
        wall, outs = run_fleet(fleet_q, sp_head)
        sp_fleet_launches = check_launches("sparsified_fleet", FLEET_FRAMES, exact=False)
        sp_fleet_walls.append(wall)
    probs = outs.class_probs
    if probs.shape != (FLEET_BANKS, FLEET_FRAMES, C) or not torch.isfinite(probs).all():
        raise AssertionError("sparsified_fleet class_probs not finite or of the wrong shape")
    sparse_launches["sparsified_fleet"] = sp_fleet_launches
    entry = {"phase": "sparsified_fleet", **describe(sp_head), "banks": FLEET_BANKS,
             "particles_per_bank": FLEET_PARTICLES, "frames": FLEET_FRAMES,
             "launches": sp_fleet_launches,
             "agg_fps": FLEET_BANKS * FLEET_FRAMES / min(sp_fleet_walls),
             "walls_s": sp_fleet_walls, "peak_gib": peak_gib(),
             "exact_fleet_agg_fps": FLEET_BANKS * FLEET_FRAMES / min(fleet_walls)}
    if "--profile" in argv:
        g = torch.Generator(device=dev).manual_seed(0)
        st = pf.pf_init_bank(sp_head, offsets, g, fleet_q, FLEET_BANKS)
        st, _ = pf.pf_scan_bank(st, Zf[:, :5], sp_head, params, log_T, cfg, fleet_q,
                                generator=g)
        emit({"phase": "profile", "path": "sparsified_fleet", "banks": FLEET_BANKS,
              "particles": FLEET_PARTICLES,
              **profile(lambda: pf.pf_scan_bank(st, Zf[:, 5:25], sp_head, params, log_T, cfg,
                                                fleet_q, generator=g), 20)})
    entry["banked_guard"] = sparse_guard(
        "sparsified_fleet", model, sp_head, q_seqs, q_labels, TRANSITIONS, fleet_q, gated=True)
    emit({**entry, "min_frame_acc": GUARD_MIN_FRAME_ACC, "device": kind, "nvidia_smi": smi})

    def recipe_model(recipe, dtype="float32", device=dev, family=GPMDM):
        """A PCA-initialized model of the recipe (seed 0, the D of the bench
        asset, d = 2, 2 classes, sigma_n inits 0.1) in ``family``, as the
        JAX package's asset scripts build it."""
        tr, tl, _, _ = synthetic.make_dataset(
            n_classes=2, n_train_seqs=recipe["n_seqs"], n_test_seqs=1,
            seq_len=recipe["seq_len"], D=cfg.D, seed=0)
        m = family(D=cfg.D, d=2, n_classes=2, dtype=dtype, y_sigma_n_init=0.1,
                   x_sigma_n_init=0.1, device=device)
        for Y, c in zip(tr, tl):
            m.add_data(Y, c)
        m.init_X()
        return m

    def train(m, steps):
        """``steps`` Adam steps through GPMDM.train_adam, the first alone:
        (losses, seconds of the first step, steps/s over the rest), each
        call timed by the trainer up to its host read of the losses."""
        lg = MetricLogger(stream=None)
        losses = m.train_adam(1, lr=TRAIN_LR, logger=lg)
        first_s = 1.0 / lg.last("steps_per_sec")
        losses += m.train_adam(steps - 1, lr=TRAIN_LR, logger=lg)
        return np.asarray(losses), first_s, lg.last("steps_per_sec")

    def profile_steps(m, steps):
        """Device time by kernel over ``steps`` trainer steps from m's state
        (the model itself is left as it is)."""
        Yd = torch.as_tensor(m.get_Y(), device=dev)
        tc = TrainConfig(num_steps=steps, lr=TRAIN_LR)
        return profile(lambda: trainer.train_adam(m._params_for_save(), Yd, m.config, m.layout,
                                                  tc, opt_state=m._opt_state,
                                                  objective=m._objective), steps, "step")

    _phase[0] = "train"
    loss64 = recipe_model(TRAIN_RECIPE, "float64", "cpu").gpdm_loss()
    tm = recipe_model(TRAIN_RECIPE)
    losses, first_s, steps_per_s = train(tm, TRAIN_RECIPE["steps"])
    asset_loss = model.gpdm_loss()
    nonfinite = int(np.sum(~np.isfinite(losses)))
    first_rel = abs(losses[0] - loss64) / abs(loss64)
    final_rel = abs(losses[-1] - asset_loss) / abs(asset_loss)
    emit({"phase": "train", "Ny": tm.layout.Ny, "D": tm.D, "d": tm.d, "classes": tm.n_classes,
          "steps": len(losses), "lr": TRAIN_LR, "first_step_s": first_s,
          "steps_per_s": steps_per_s, "first_loss": float(losses[0]),
          "first_loss_f64_host": loss64, "first_rel": first_rel,
          "final_loss": float(losses[-1]), "asset_loss": asset_loss, "final_rel": final_rel,
          "nonfinite": nonfinite, "device": kind, "nvidia_smi": smi})
    if len(losses) != TRAIN_RECIPE["steps"] or nonfinite:
        raise AssertionError(f"train: {nonfinite} non-finite of {len(losses)} losses")
    if not first_rel <= TRAIN_FIRST_RTOL:
        raise AssertionError(f"train: first loss {losses[0]} vs float64 {loss64}: "
                             f"{first_rel:.2e} > {TRAIN_FIRST_RTOL}")
    if not final_rel <= TRAIN_FINAL_RTOL:
        raise AssertionError(f"train: final loss {losses[-1]} vs the asset's {asset_loss}: "
                             f"{final_rel:.3f} > {TRAIN_FINAL_RTOL}")
    if "--profile" in argv:
        emit({"phase": "profile", "path": "train", "Ny": tm.layout.Ny,
              **profile_steps(tm, 20)})

    _phase[0] = "train_guard"
    reset_launches()
    rep = evaluate_pf_banked(tm, TRANSITIONS, q_seqs, q_labels, num_particles=N_PARTICLES,
                             burn_in=5, seed=0, config=pfc)
    train_launches = check_launches("train_guard", T_pad)
    emit({"phase": "train_guard", "frame_acc": rep.frame_metrics["accuracy"],
          "frame_f1": rep.frame_metrics["f1"], "trial_acc": rep.trial_metrics["accuracy"],
          "frames": rep.total_frames, "banks": len(q_seqs), "particles_per_bank": N_PARTICLES,
          "padded_frames": T_pad, "agg_fps": rep.fps, "launches": train_launches,
          "asset_frame_acc": asset_guard["frame_acc"],
          "asset_frame_f1": asset_guard["frame_f1"], "gated": False})
    del tm

    _phase[0] = "train_n2048"
    big = recipe_model(N2048_RECIPE)
    losses, first_s, steps_per_s = train(big, N2048_RECIPE["steps"])
    emit({"phase": "train_n2048", "Ny": big.layout.Ny, "n_max": big.layout.n_max,
          "steps": len(losses), "first_step_s": first_s, "steps_per_s": steps_per_s,
          "first_loss": float(losses[0]), "final_loss": float(losses[-1]),
          "nonfinite": int(np.sum(~np.isfinite(losses))), "device": kind, "nvidia_smi": smi})
    if "--profile" in argv:
        emit({"phase": "profile", "path": "train_n2048", "Ny": big.layout.Ny,
              **profile_steps(big, 5)})
    del big
    torch.cuda.empty_cache()

    _phase[0] = "train_sparse"
    check_precision("train_sparse")
    t_phase = time.perf_counter()
    hourlong_path = os.path.join(ROOT, "bench_assets", "bench_model_hourlong.npz")
    t0 = time.perf_counter()
    src = GPMDM.load(hourlong_path, device=dev)
    load_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    sm = SparseGPMDM.from_config(src.config, device=dev, init_hypers=src._init_hypers)
    sm.n_inducing_y, sm.n_inducing_x = src.n_inducing_y, src.n_inducing_x
    for c, seqs in enumerate(src.class_aware_observations_list):
        for Y in seqs:
            sm.add_data(Y, c)
    del src
    t0 = time.perf_counter()
    sm.init_X()
    init_s = time.perf_counter() - t0
    # the same initialisation on the host CPU: the port's sparse_nll in
    # float64, in float64 with the fp32 config (the fp32 objective's
    # jitters: Kuu's 1e-4 against 1e-6), and in fp32
    host = {}
    cfg64 = sm.config.replace(dtype="float64")
    for label, tdt, hcfg in (("f64", torch.float64, cfg64),
                             ("f64_of_f32_objective", torch.float64, sm.config),
                             ("f32", torch.float32, sm.config)):
        hp = tsp.SparseParams(**{f: getattr(sm.params, f).detach().cpu().to(tdt)
                                 for f in tsp.SPARSE_PARAM_FIELDS})
        with torch.no_grad():
            host[label] = float(tsp.sparse_nll(
                hp, torch.as_tensor(sm.get_Y()).to(tdt), hcfg, sm.layout))
    losses, first_s, steps_per_s = train(sm, SPARSE_TRAIN_STEPS)
    check_precision("train_sparse")
    nonfinite = int(np.sum(~np.isfinite(losses)))
    # the card's first loss against each float64 reading, within 1e-3 or 4x
    # the host's own fp32 gap to it, whichever is larger
    first = {}
    for ref in ("f64", "f64_of_f32_objective"):
        host_rel = abs(host["f32"] - host[ref]) / abs(host[ref])
        first[ref] = {"host": host[ref], "host_f32_rel": host_rel,
                      "rel": abs(losses[0] - host[ref]) / abs(host[ref]),
                      "tol": max(SPARSE_FIRST_RTOL, 4 * host_rel)}
    emit({"phase": "train_sparse", "Ny": sm.layout.Ny, "D": sm.D, "d": sm.d,
          "classes": sm.n_classes, "My": sm.n_inducing_y, "Mx": sm.n_inducing_x,
          "dtype": sm.config.dtype, "steps": len(losses), "lr": TRAIN_LR, "load_s": load_s,
          "init_s": init_s, "first_step_s": first_s, "steps_per_s": steps_per_s,
          "peak_gib": peak_gib(), "first_loss": float(losses[0]),
          "first_loss_f32_host": host["f32"], "first_vs": first,
          "final_loss": float(losses[-1]), "nonfinite": nonfinite,
          "seconds": time.perf_counter() - t_phase, "device": kind, "nvidia_smi": smi})
    if len(losses) != SPARSE_TRAIN_STEPS or nonfinite:
        raise AssertionError(f"train_sparse: {nonfinite} non-finite of {len(losses)} losses")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_sparse: last loss {losses[-1]} not below the first "
                             f"{losses[0]}")
    for ref, o in first.items():
        if not o["rel"] <= o["tol"]:
            raise AssertionError(f"train_sparse: first loss {losses[0]} vs host {ref} "
                                 f"{o['host']}: {o['rel']:.2e} > {o['tol']:.2e}")
    if "--profile" in argv:
        emit({"phase": "profile", "path": "train_sparse", "Ny": sm.layout.Ny,
              **profile_steps(sm, 5)})
    del sm
    torch.cuda.empty_cache()

    _phase[0] = "train_sparse_resume"
    check_precision("train_sparse_resume")
    t_phase = time.perf_counter()
    rm = GPMDM.load(hourlong_path, device=dev)
    stored_count = int(rm._opt_state.count)
    asset_sparse_loss = rm.gpdm_loss()
    torch.cuda.reset_peak_memory_stats()
    lg = MetricLogger(stream=None)
    losses = np.asarray(rm.train_adam(SPARSE_RESUME_STEPS, lr=TRAIN_LR, logger=lg))
    count = int(rm._opt_state.count)
    nonfinite = int(np.sum(~np.isfinite(losses)))
    final_rel = abs(losses[-1] - asset_sparse_loss) / abs(asset_sparse_loss)
    entry = {"phase": "train_sparse_resume", "Ny": rm.layout.Ny, "steps": len(losses),
             "stored_count": stored_count, "count": count, "steps_per_s": lg.last("steps_per_sec"),
             "peak_gib": peak_gib(), "first_loss": float(losses[0]),
             "final_loss": float(losses[-1]), "asset_loss": asset_sparse_loss,
             "final_rel": final_rel, "nonfinite": nonfinite}
    if count != stored_count + SPARSE_RESUME_STEPS or nonfinite:
        emit(entry)
        raise AssertionError(f"train_sparse_resume: Adam count {count} (stored "
                             f"{stored_count}), {nonfinite} non-finite losses")
    if not final_rel <= TRAIN_FINAL_RTOL:
        emit(entry)
        raise AssertionError(f"train_sparse_resume: final loss {losses[-1]} vs the asset's "
                             f"{asset_sparse_loss}: {final_rel:.3f} > {TRAIN_FINAL_RTOL}")
    entry["banked_guard"] = sparse_guard("train_sparse_resume", rm, rm.posterior,
                                         *ag.guard_trials("hourlong"), pfc, gated=False)
    emit({**entry, "sparse_hourlong_frame_acc": hourlong_guard["frame_acc"],
          "sparse_hourlong_frame_f1": hourlong_guard["frame_f1"],
          "seconds": time.perf_counter() - t_phase, "device": kind, "nvidia_smi": smi})
    del rm
    torch.cuda.empty_cache()

    _phase[0] = "train_bc"
    check_precision("train_bc")
    t_phase = time.perf_counter()
    bc64 = recipe_model(TRAIN_RECIPE, "float64", "cpu", BCGPMDM)
    loss64 = bc64.gpdm_loss()
    bm = recipe_model(TRAIN_RECIPE, family=BCGPMDM)
    losses, first_s, steps_per_s = train(bm, TRAIN_RECIPE["steps"])
    nonfinite = int(np.sum(~np.isfinite(losses)))
    first_rel = abs(losses[0] - loss64) / abs(loss64)
    X = bm.params.X
    proj_err = (bm.map_y_to_x(bm.get_Y()) - X).abs().max().item()
    proj_tol = CONDITIONED_RTOL * X.abs().median().item()
    entry = {"phase": "train_bc", "Ny": bm.layout.Ny, "back_lengthscale":
             bm.config.back_constraint_ls, "host_f64_lengthscale": bc64.config.back_constraint_ls,
             "steps": len(losses), "lr": TRAIN_LR, "first_step_s": first_s,
             "steps_per_s": steps_per_s, "first_loss": float(losses[0]),
             "first_loss_f64_host": loss64, "first_rel": first_rel,
             "final_loss": float(losses[-1]), "nonfinite": nonfinite,
             "map_y_to_x_err": proj_err, "map_y_to_x_tol": proj_tol}
    del bc64
    if len(losses) != TRAIN_RECIPE["steps"] or nonfinite:
        emit(entry)
        raise AssertionError(f"train_bc: {nonfinite} non-finite of {len(losses)} losses")
    if not first_rel <= TRAIN_FIRST_RTOL:
        emit(entry)
        raise AssertionError(f"train_bc: first loss {losses[0]} vs float64 {loss64}: "
                             f"{first_rel:.2e} > {TRAIN_FIRST_RTOL}")
    if not proj_err <= proj_tol:
        emit(entry)
        raise AssertionError(f"train_bc: map_y_to_x(Y) off params.X by {proj_err:.3e} > "
                             f"{proj_tol:.3e}")
    reset_launches()
    rep = evaluate_pf_banked(bm, TRANSITIONS, q_seqs, q_labels, num_particles=N_PARTICLES,
                             burn_in=5, seed=0, config=pfc)
    bc_launches = check_launches("train_bc banked guard", T_pad)
    emit({**entry, "banked_guard": {
        "frame_acc": rep.frame_metrics["accuracy"], "frame_f1": rep.frame_metrics["f1"],
        "trial_acc": rep.trial_metrics["accuracy"], "frames": rep.total_frames,
        "banks": len(q_seqs), "particles_per_bank": N_PARTICLES, "padded_frames": T_pad,
        "agg_fps": rep.fps, "launches": bc_launches, "gated": False},
        "asset_frame_acc": asset_guard["frame_acc"], "seconds": time.perf_counter() - t_phase,
        "device": kind, "nvidia_smi": smi})
    if "--profile" in argv:
        emit({"phase": "profile", "path": "train_bc", "Ny": bm.layout.Ny,
              **profile_steps(bm, 20)})
    del bm

    _phase[0] = "train_lbfgs"
    check_precision("train_lbfgs")
    t_phase = time.perf_counter()
    loss64 = recipe_model(TRAIN_RECIPE, "float64", "cpu").gpdm_loss()
    lm = recipe_model(TRAIN_RECIPE)
    lg = MetricLogger(stream=None)
    losses = np.asarray(lm.train_lbfgs(LBFGS_STEPS, logger=lg))
    check_precision("train_lbfgs")
    nonfinite = int(np.sum(~np.isfinite(losses)))
    first_rel = abs(losses[0] - loss64) / abs(loss64)
    # kernels a step over a few more steps from the trained state (the
    # model itself is left as it is), and the evaluations those steps took
    Yd = torch.as_tensor(lm.get_Y(), device=dev)
    runs = []
    prof = profile(lambda: runs.append(trainer.train_adam(
        lm._params_for_save(), Yd, lm.config, lm.layout,
        TrainConfig(num_steps=LBFGS_PROFILE_STEPS, optimizer="lbfgs"),
        opt_state=lm._opt_state, objective=lm._objective)), LBFGS_PROFILE_STEPS, "step")
    entry = {"phase": "train_lbfgs", "Ny": lm.layout.Ny, "D": lm.D, "d": lm.d,
             "steps": len(losses), "memory": lm._lbfgs_memory,
             "steps_per_s": lg.last("steps_per_sec"),
             "evals_per_step": lg.last("evals_per_step"),
             "host_reads_per_step": lg.last("host_reads_per_step"),
             "first_loss": float(losses[0]), "first_loss_f64_host": loss64,
             "first_rel": first_rel, "final_loss": float(losses[-1]), "nonfinite": nonfinite,
             "linesearch_steps_last": int(lm._opt_state.num_linesearch_steps),
             "profiled": {"steps": LBFGS_PROFILE_STEPS,
                          "evals_per_step": runs[-1].loss_evals / LBFGS_PROFILE_STEPS,
                          "host_reads_per_step": runs[-1].host_reads / LBFGS_PROFILE_STEPS,
                          "launches_per_step": prof["kernels_per_step"],
                          "launches_per_eval": prof["kernels_per_step"] * LBFGS_PROFILE_STEPS
                          / runs[-1].loss_evals,
                          "wall_ms_per_step": prof["wall_ms_per_step"],
                          "device_busy_share": prof["device_busy_share"]}}
    if len(losses) != LBFGS_STEPS or nonfinite:
        emit(entry)
        raise AssertionError(f"train_lbfgs: {nonfinite} non-finite of {len(losses)} losses")
    if not losses[-1] < losses[0]:
        emit(entry)
        raise AssertionError(f"train_lbfgs: last loss {losses[-1]} not below the first "
                             f"{losses[0]}")
    if not first_rel <= TRAIN_FIRST_RTOL:
        emit(entry)
        raise AssertionError(f"train_lbfgs: first loss {losses[0]} vs float64 {loss64}: "
                             f"{first_rel:.2e} > {TRAIN_FIRST_RTOL}")
    reset_launches()
    rep = evaluate_pf_banked(lm, TRANSITIONS, q_seqs, q_labels, num_particles=N_PARTICLES,
                             burn_in=5, seed=0, config=pfc)
    lbfgs_launches = check_launches("train_lbfgs banked guard", T_pad)
    emit({**entry, "banked_guard": {
        "frame_acc": rep.frame_metrics["accuracy"], "frame_f1": rep.frame_metrics["f1"],
        "trial_acc": rep.trial_metrics["accuracy"], "frames": rep.total_frames,
        "banks": len(q_seqs), "particles_per_bank": N_PARTICLES, "padded_frames": T_pad,
        "agg_fps": rep.fps, "launches": lbfgs_launches, "gated": False},
        "asset_frame_acc": asset_guard["frame_acc"], "seconds": time.perf_counter() - t_phase,
        "device": kind, "nvidia_smi": smi})
    del lm, Yd, runs

    _phase[0] = "lbfgs_resume"
    check_precision("lbfgs_resume")
    t_phase = time.perf_counter()
    hourlongh_path = os.path.join(ROOT, "bench_assets", "bench_model_hourlongh.npz")
    with np.load(hourlongh_path) as z:
        file_meta = json.loads(bytes(z["meta_json"]).decode())
        file_leaves = [z[f"opt_{i}"] for i in range(file_meta["n_opt_leaves"])]
    t0 = time.perf_counter()
    rm = GPMDM.load(hourlongh_path, device=dev)
    load_s = time.perf_counter() - t0

    def same_leaves(got, want):
        return len(got) == len(want) and all(
            a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
            for a, b in zip(got, want))

    loaded_equal = same_leaves(rm._opt_state.to_numpy(), file_leaves)
    stored_count = int(rm._opt_state.count)
    # the float64 evaluation of the fp32 objective at the asset's parameters
    hp = tsp.SparseParams(**{f: getattr(rm.params, f).detach().cpu().double()
                             for f in tsp.SPARSE_PARAM_FIELDS})
    with torch.no_grad():
        host64 = float(tsp.sparse_nll(hp, torch.as_tensor(rm.get_Y()).double(), rm.config,
                                      rm.layout))
    torch.cuda.reset_peak_memory_stats()
    lg = MetricLogger(stream=None)
    t0 = time.perf_counter()
    losses = np.asarray(rm.train_lbfgs(LBFGS_RESUME_STEPS, logger=lg))
    train_s = time.perf_counter() - t0
    count = int(rm._opt_state.count)
    nonfinite = int(np.sum(~np.isfinite(losses)))
    first_rel = abs(losses[0] - host64) / abs(host64)
    with tempfile.TemporaryDirectory() as tmp:
        saved = os.path.join(tmp, "hourlongh_resumed.npz")
        rm.save(saved)
        with np.load(saved) as z:
            saved_meta = json.loads(bytes(z["meta_json"]).decode())
        again = GPMDM.load(saved, device=dev)
        round_trip_equal = same_leaves(again._opt_state.to_numpy(), rm._opt_state.to_numpy())
        del again
    entry = {"phase": "lbfgs_resume", "Ny": rm.layout.Ny, "n_opt_leaves": len(file_leaves),
             "loaded_leaves_equal": loaded_equal, "stored_count": stored_count,
             "count": count, "steps": len(losses), "load_s": load_s, "train_s": train_s,
             "steps_per_s": lg.last("steps_per_sec"),
             "evals_per_step": lg.last("evals_per_step"),
             "host_reads_per_step": lg.last("host_reads_per_step"),
             "linesearch_steps_last": int(rm._opt_state.num_linesearch_steps),
             "learning_rate_last": float(rm._opt_state.learning_rate),
             "peak_gib": peak_gib(), "first_loss": float(losses[0]),
             "first_loss_f64_of_f32_objective_host": host64, "first_rel": first_rel,
             "final_loss": float(losses[-1]), "nonfinite": nonfinite,
             "saved_optimizer": [saved_meta.get("optimizer_name"),
                                 saved_meta.get("lbfgs_memory"),
                                 saved_meta.get("n_opt_leaves")],
             "round_trip_equal": round_trip_equal,
             "seconds": time.perf_counter() - t_phase, "device": kind, "nvidia_smi": smi}
    emit(entry)
    if len(file_leaves) != 57 or not loaded_equal:
        raise AssertionError("lbfgs_resume: the loaded L-BFGS state differs from the file's "
                             f"{len(file_leaves)} leaves")
    if count != stored_count + LBFGS_RESUME_STEPS or nonfinite:
        raise AssertionError(f"lbfgs_resume: count {count} (stored {stored_count}), "
                             f"{nonfinite} non-finite losses")
    if not first_rel <= TRAIN_FIRST_RTOL:
        raise AssertionError(f"lbfgs_resume: first loss {losses[0]} vs the host's {host64}: "
                             f"{first_rel:.2e} > {TRAIN_FIRST_RTOL}")
    if not losses[-1] <= losses[0]:
        raise AssertionError(f"lbfgs_resume: last loss {losses[-1]} above the first "
                             f"{losses[0]}")
    if entry["saved_optimizer"] != ["lbfgs", 10, 57] or not round_trip_equal:
        raise AssertionError(f"lbfgs_resume: the saved state ({entry['saved_optimizer']}) "
                             "did not load back leaf for leaf")
    del rm
    torch.cuda.empty_cache()

    _phase[0] = "cli"
    t_phase = time.perf_counter()
    cli_tmp = tempfile.mkdtemp(prefix="gpmdm_cli_")
    env = {k: v for k, v in os.environ.items() if k != "GPMDM_TPU_PLATFORM"}
    trained, lbfgs_out = os.path.join(cli_tmp, "m.npz"), os.path.join(cli_tmp, "lbfgs.npz")
    deployed, trace_dir = os.path.join(cli_tmp, "deployed.npz"), os.path.join(cli_tmp, "trace")
    asset = os.path.join(ROOT, "bench_assets", "bench_model.npz")
    cli_runs = {}

    def cli_start(name, *args):
        """``python -m gpmdm_tpu_torch *args`` with the platform pin unset:
        on the card."""
        proc = subprocess.Popen([sys.executable, "-m", "gpmdm_tpu_torch", *args], cwd=ROOT,
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        _children.append(proc)
        cli_runs[name] = {"argv": list(args), "proc": proc}

    def cli_finish(name):
        """Wait for run ``name`` and record it; a non-zero exit fails.  The
        runs share the card, so only the phase's total seconds are kept."""
        run = cli_runs[name]
        proc = run.pop("proc")
        out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
        run.update(rc=proc.returncode, stdout=out, stdout_tail=out[-600:],
                   stderr_tail=err[-600:])
        if run["rc"] != 0:
            emit({"phase": "cli", "failed": name,
                  **{k: v for k, v in run.items() if k != "stdout"}})
            raise AssertionError(f"cli {name}: exit {run['rc']}")

    try:
        # each command starts as soon as the file it reads is written
        cli_start("train", "train", "--out", trained, "--latent-dim", "2", "--steps", "60")
        cli_start("train_lbfgs", "train", "--out", lbfgs_out, "--latent-dim", "2",
                  "--optimizer", "lbfgs", "--steps", "10")
        cli_start("eval_asset", "eval", asset, "--particles", "500", "--burn-in", "5")
        cli_finish("train")
        cli_start("eval_banked_trace", "eval", trained, "--banked", "--particles", "1000",
                  "--trace", trace_dir)
        cli_start("deploy", "deploy", trained, "--sparsify", "64", "--out", deployed)
        cli_finish("deploy")
        cli_start("rollout", "rollout", deployed, "--steps", "5")
        for name in ("train_lbfgs", "eval_asset", "eval_banked_trace", "rollout"):
            cli_finish(name)
    finally:
        for proc in _children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    summary = cli_runs["eval_asset"]["stdout"]
    frame_acc = float(re.search(r"frames: acc=([0-9.]+)", summary).group(1))
    trial_acc = float(re.search(r"trials: acc=([0-9.]+)", summary).group(1))
    kernel_events = {}
    for path in glob.glob(os.path.join(trace_dir, "*.json")):
        with open(path) as f:
            for e in json.load(f).get("traceEvents", []):
                if e.get("cat") == "kernel":
                    kernel_events[e["name"]] = kernel_events.get(e["name"], 0) + 1
    traced = {k: sum(n for name, n in kernel_events.items() if re.search(pat, name))
              for k, pat in TRACE_KERNELS.items()}
    rollout_rows = len(cli_runs["rollout"]["stdout"].strip().splitlines())
    entry = {"phase": "cli", "runs": {k: {kk: vv for kk, vv in v.items() if kk != "stdout"}
                                      for k, v in cli_runs.items()},
             "eval_asset_frame_acc": frame_acc, "eval_asset_trial_acc": trial_acc,
             "min_frame_acc": GUARD_MIN_FRAME_ACC, "traced_kernel_events": traced,
             "rollout_rows": rollout_rows, "seconds": time.perf_counter() - t_phase,
             "device": kind, "nvidia_smi": smi}
    shutil.rmtree(cli_tmp, ignore_errors=True)
    emit(entry)
    if not frame_acc >= GUARD_MIN_FRAME_ACC:
        raise AssertionError(f"cli: eval of bench_model.npz at frame accuracy {frame_acc} < "
                             f"{GUARD_MIN_FRAME_ACC}")
    if not all(traced.values()):
        raise AssertionError(f"cli: the --trace of eval --banked lacks a kernel: {traced}")

    sharded_launches = sharded_phases(dev, kind, smi, model, pfc, q_seqs, q_labels, Z,
                                      reset_launches, check_launches,
                                      {"banked_guard": asset_guard["agg_fps"],
                                       "fleet": FLEET_BANKS * FLEET_FRAMES / min(fleet_walls)},
                                      n5120)
    del n5120

    for k in kernels:
        n = k["name"]
        k["launches_by_phase"] = {"path": launches[n], "banked_guard": banked_launches[n],
                                  "fleet": fleet_launches[n], "d4_path": d4[0][n],
                                  "d4_banked_guard": d4[1][n], "c8_path": c8[0][n],
                                  "c8_banked_guard": c8[1][n], "train_guard": train_launches[n],
                                  "train_bc_guard": bc_launches[n],
                                  "train_lbfgs_guard": lbfgs_launches[n],
                                  "compressed_path": comp_path_launches[n],
                                  "compressed_banked_guard": comp_guard_launches[n],
                                  **{k: v[n] for k, v in compressed_launches.items()},
                                  **{k: v[n] for k, v in sparse_launches.items()},
                                  **{k: v[n] for k, v in sharded_launches.items()}}

    _phase[0] = "report"
    heavy = ("path_inputs", "conditioned_inputs")
    emit({"kernels": [{k: ([{kk: vv for kk, vv in e.items() if kk not in heavy} for e in v]
                           if k in ("banked", "large_n", "assets") else v)
                       for k, v in kern.items() if k not in heavy}
                      for kern in kernels]})
    print(f"{smi} (total {time.perf_counter() - t_start:.1f} s)", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def sharded_phases(dev, kind, smi, model, pfc, q_seqs, q_labels, Z, reset_launches,
                   check_launches, rates, n5120):
    """The distribution layer (gpmdm_tpu_torch.parallel) over NCCL: one
    process group of world 1 on cuda:0, started here and torn down at the
    end.  Returns the launch counts of the sharded_bank phase by path."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gpmdm_tpu_torch import GPMDM, PFConfig, TrainConfig
    from gpmdm_tpu_torch import parallel as par
    from gpmdm_tpu_torch.filter import particle_filter as pf
    from gpmdm_tpu_torch.models import core
    from gpmdm_tpu_torch.parallel import collectives
    from gpmdm_tpu_torch.parallel import sharded as SH
    from gpmdm_tpu_torch.train import trainer
    from gpmdm_tpu_torch.utils.metrics import evaluate_pf_banked

    def sync_time(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    _phase[0] = "sharded_bank"
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    par.init_distributed()  # NCCL on cuda:LOCAL_RANK, LOCAL_RANK unset: cuda:0
    nccl = torch.cuda.nccl.version()
    group = {"backend": dist.get_backend(), "world": dist.get_world_size(),
             "nccl": ".".join(map(str, nccl)) if isinstance(nccl, tuple) else str(nccl),
             "init_s": time.perf_counter() - t0}
    if group["backend"] != "nccl" or group["world"] != 1:
        raise AssertionError(f"sharded phases: process group {group}")
    dp = par.make_mesh({"dp": 1})
    # a group's NCCL communicator starts at its first collective: start the
    # dp group's here, timed, so that no rate below includes it
    t0 = time.perf_counter()
    collectives.all_reduce(torch.zeros(1, device=dev), dist.group.WORLD)
    collectives.all_reduce(torch.zeros(1, device=dev), dp.get_group("dp"))
    torch.cuda.synchronize()
    group["first_collectives_s"] = time.perf_counter() - t0
    offsets = model.layout.y_class_offsets
    post, params, cfg = model.posterior, model.params, model.config
    log_T = torch.log(torch.tensor(TRANSITIONS, device=dev, dtype=model.dtype))
    launches = {}

    # the guard's 12 trials through evaluate_pf_banked(mesh=...), beside the
    # unsharded call with the same seed
    T_pad = pf.bucket_length(max(len(q) for q in q_seqs))
    kw = dict(num_particles=N_PARTICLES, burn_in=5, seed=0, config=pfc)
    reset_launches()
    before = collectives.COUNTS.copy()
    rep = evaluate_pf_banked(model, TRANSITIONS, q_seqs, q_labels, mesh=dp, **kw)
    guard_collectives = dict(collectives.COUNTS - before)
    launches["sharded_bank_guard"] = check_launches("sharded_bank guard", T_pad)
    plain = evaluate_pf_banked(model, TRANSITIONS, q_seqs, q_labels, **kw)
    same_preds = all(np.array_equal(a, b) for a, b in
                     zip(rep.frame_predictions, plain.frame_predictions))
    acc = rep.frame_metrics["accuracy"]
    guard = {"frame_acc": acc, "frame_f1": rep.frame_metrics["f1"], "banks": len(q_seqs),
             "particles_per_bank": N_PARTICLES, "padded_frames": T_pad,
             "agg_fps": rep.fps, "banked_guard_agg_fps": rates["banked_guard"],
             "unsharded_agg_fps": plain.fps, "launches": launches["sharded_bank_guard"],
             "collectives": guard_collectives, "predictions_equal_unsharded": same_preds}

    # the fleet: equal to pf_scan_bank on the same injected noise, then timed
    cfg_f = PFConfig(num_particles=FLEET_PARTICLES, pallas="on")
    Zf = Z[None, :FLEET_FRAMES].expand(FLEET_BANKS, FLEET_FRAMES, model.D)
    g = torch.Generator(device=dev).manual_seed(1)
    st = pf.pf_init_bank(post, offsets, g, cfg_f, FLEET_BANKS)
    frames = [pf.draw_noise(FLEET_BANKS, FLEET_PARTICLES, cfg.d, g, model.dtype, dev)
              for _ in range(FLEET_FRAMES)]
    noise = pf.PFNoise(**{f: torch.stack([getattr(n, f) for n in frames])
                          for f in ("u_trans", "eps_dyn", "u_res")})
    scan_collectives = par.count_collectives(
        par.pf_scan_bank_sharded, st, Zf, post, params, log_T, cfg, cfg_f, dp, noise=noise)
    reset_launches()
    _, sharded = par.pf_scan_bank_sharded(st, Zf, post, params, log_T, cfg, cfg_f, dp,
                                          noise=noise, gather=True)
    launches["sharded_fleet"] = check_launches("sharded_bank fleet", FLEET_FRAMES)
    _, ref = pf.pf_scan_bank(st, Zf, post, params, log_T, cfg, cfg_f, noise=noise)
    _, ref2 = pf.pf_scan_bank(st, Zf, post, params, log_T, cfg, cfg_f, noise=noise)
    diff = {f: float((getattr(sharded, f).double() - getattr(ref, f).double()).abs().max())
            for f in ("class_probs", "log_likelihood", "state_mean")}
    run_to_run = {f: float((getattr(ref2, f).double() - getattr(ref, f).double()).abs().max())
                  for f in diff}
    same_mlc = bool(torch.equal(sharded.most_likely_class, ref.most_likely_class))

    def run_fleet(sharded):
        """One timed fleet run from seed 1 (the fleet phase's), sharded or
        through pf_scan_bank; 64 launches of each kernel either way."""
        gg = torch.Generator(device=dev).manual_seed(1)
        s0 = pf.pf_init_bank(post, offsets, gg, cfg_f, FLEET_BANKS)
        reset_launches()
        wall, _ = sync_time(lambda: par.pf_scan_bank_sharded(
            s0, Zf, post, params, log_T, cfg, cfg_f, dp, generator=gg, gather=True)
            if sharded else pf.pf_scan_bank(s0, Zf, post, params, log_T, cfg, cfg_f,
                                            generator=gg))
        check_launches("sharded_bank fleet", FLEET_FRAMES)
        return wall

    # sharded and unsharded alternate, so that both see the same card
    walls, plain_walls = [], []
    for sharded in (True, False, False, True) * (TIMED_RUNS // 2):
        (walls if sharded else plain_walls).append(run_fleet(sharded))
    fleet = {"banks": FLEET_BANKS, "particles_per_bank": FLEET_PARTICLES,
             "frames": FLEET_FRAMES, "agg_fps": FLEET_BANKS * FLEET_FRAMES / min(walls),
             "walls_s": walls, "fleet_agg_fps": rates["fleet"],
             "unsharded_agg_fps": FLEET_BANKS * FLEET_FRAMES / min(plain_walls),
             "unsharded_walls_s": plain_walls,
             "launches": launches["sharded_fleet"], "scan_collectives": scan_collectives,
             "max_abs_diff": diff, "unsharded_run_to_run": run_to_run,
             "most_likely_class_equal": same_mlc}
    emit({"phase": "sharded_bank", **group, "guard": guard, "fleet": fleet,
          "seconds": time.perf_counter() - t_phase, "device": kind, "nvidia_smi": smi})
    if not acc >= GUARD_MIN_FRAME_ACC:
        raise AssertionError(f"sharded_bank: guard frame accuracy {acc} < {GUARD_MIN_FRAME_ACC}")
    if not same_preds or guard_collectives != {"all_gather": 1}:
        raise AssertionError("sharded_bank: the guard's predictions differ from the unsharded "
                             f"guard's, or its collectives {guard_collectives} are not one gather")
    if scan_collectives != {} or not same_mlc or any(diff[f] > run_to_run[f] for f in diff):
        raise AssertionError(f"sharded_bank: the fleet scan made collectives {scan_collectives} "
                             f"or differs from pf_scan_bank by {diff} (run to run {run_to_run})")

    _phase[0] = "sharded_train"
    t_phase = time.perf_counter()
    m8 = GPMDM.load(os.path.join(ROOT, "bench_assets", "bench_model_c8n5120.npz"), device=dev)
    mesh = par.make_train_mesh(n_classes=m8.n_classes)
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    Y8 = torch.as_tensor(m8.get_Y(), device=dev)
    lay = m8.layout.to(dev)

    def value_and_grad(p, cfg_, Y_):
        leaves = [getattr(p, f).detach().requires_grad_(True) for f in core.PARAM_FIELDS]
        with torch.enable_grad():
            loss = core.nll(core.GPMDMParams(*leaves), Y_, cfg_, lay)
            grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), grads

    # float64: both forms against core.nll with autograd
    cfg64 = m8.config.replace(dtype="float64")
    p64 = core.GPMDMParams(**{f: getattr(m8.params, f).double() for f in core.PARAM_FIELDS})
    ref64, gref64 = value_and_grad(p64, cfg64, Y8.double())
    forms = {}
    for sc in (False, True):
        ctx = SH.make_context(cfg64, m8.layout, mesh, shard_chol=sc)
        loss, grads = SH.nll_sharded_value_and_grad(p64, SH.pad_Y(Y8.double(), ctx), ctx)
        forms["shard_chol" if sc else "replicated"] = {
            "f64_loss": float(loss), "f64_rel": abs(float(loss) - ref64) / abs(ref64),
            "f64_grad_rel": {f: float((a - b).abs().max() / b.abs().max())
                             for f, a, b in zip(core.PARAM_FIELDS, grads, gref64)}}
    # fp32: both forms against the unsharded fp32 loss
    ref32 = value_and_grad(m8.params, m8.config, Y8)[0]
    tc = TrainConfig(num_steps=5, lr=TRAIN_LR)
    wall, res = sync_time(lambda: trainer.train_adam(m8.params, Y8, m8.config, m8.layout, tc,
                                                     opt_state=m8._opt_state))
    unsharded = res.losses.cpu().numpy()
    train = {"unsharded": {"losses": unsharded.tolist(), "steps_per_s": tc.num_steps / wall}}
    for sc in (False, True):
        name = "shard_chol" if sc else "replicated"
        ctx = SH.make_context(m8.config, m8.layout, mesh, shard_chol=sc)
        loss = float(SH.nll_sharded(m8.params, SH.pad_Y(Y8, ctx), ctx))
        forms[name].update(f32_loss=loss, f32_rel=abs(loss - ref32) / abs(ref32),
                           f32_rel_to_f64=abs(loss - ref64) / abs(ref64))
        step = SH.make_sharded_update_step(ctx, TRAIN_LR, 1.0, trainer.trainable_mask(m8.config))
        counts = par.count_collectives(step, m8.params, m8._opt_state, SH.pad_Y(Y8, ctx))
        wall, (_, st8, losses) = sync_time(lambda: par.train_adam_sharded(
            m8.params, Y8, m8.config, m8.layout, mesh, tc, opt_state=m8._opt_state,
            shard_chol=sc))
        losses = losses.cpu().numpy()
        train[name] = {"losses": losses.tolist(), "steps_per_s": tc.num_steps / wall,
                       "count": int(st8.count), "collectives_a_step": counts,
                       "max_rel_to_unsharded": float(np.max(np.abs(losses - unsharded)
                                                            / np.abs(unsharded)))}
    pinned = {"replicated": {"psum": 1},
              "shard_chol": {"all_gather": shape["tp"] + 3, "pbroadcast": 2 * shape["tp"],
                             "psum": 1}}
    emit({"phase": "sharded_train", **group, "asset": "bench_model_c8n5120.npz",
          "Ny": m8.layout.Ny, "classes": m8.n_classes, "mesh": shape, "f64_loss": ref64,
          "f32_loss": ref32, "forms": forms, "train": train,
          "unsharded_f32_rel_to_f64": abs(ref32 - ref64) / abs(ref64),
          "seconds": time.perf_counter() - t_phase, "device": kind, "nvidia_smi": smi})
    for name, f in forms.items():
        if not (f["f64_rel"] <= 1e-9 and max(f["f64_grad_rel"].values()) <= 1e-7):
            raise AssertionError(f"sharded_train {name}: float64 loss {f['f64_rel']:.2e} or "
                                 f"gradient {f['f64_grad_rel']} off core.nll")
        if not f["f32_rel"] <= 1e-4:
            raise AssertionError(f"sharded_train {name}: fp32 loss {f['f32_rel']:.2e} off")
        t = train[name]
        if not (np.all(np.isfinite(t["losses"])) and t["max_rel_to_unsharded"] <= 1e-4):
            raise AssertionError(f"sharded_train {name}: losses {t['losses']} against the "
                                 f"unsharded {unsharded.tolist()}")
        if t["collectives_a_step"] != pinned[name]:
            raise AssertionError(f"sharded_train {name}: collectives {t['collectives_a_step']}, "
                                 f"pinned {pinned[name]}")
    del m8, Y8, lay, p64, gref64, res
    torch.cuda.empty_cache()

    _phase[0] = "sharded_predict"
    t_phase = time.perf_counter()
    m5, xs = n5120
    sp = par.make_mesh({"sp": 1})
    cast = lambda obj: type(obj)(**{f.name: getattr(obj, f.name).double()  # noqa: E731
                                    for f in dataclasses.fields(obj)})
    post64, prm64, xs64 = cast(m5.posterior), cast(m5.params), xs.double()
    pred = {}
    for name, sharded_fn, plain_fn in (
            ("predict_y", par.predict_y_rowsharded, core.predict_y),
            ("predict_x_all_classes", par.predict_x_all_classes_rowsharded,
             core.predict_x_all_classes)):
        want = plain_fn(post64, prm64, xs64, m5.config)
        got64 = sharded_fn(post64, prm64, xs64, m5.config, sp)
        got32 = sharded_fn(m5.posterior, m5.params, xs, m5.config, sp)
        med = [float(w.abs().median()) for w in want]
        pred[name] = {
            "f64_err_over_median": [float((a - w).abs().max()) / mm
                                    for a, w, mm in zip(got64, want, med)],
            "f32_gap_over_median": [float((a.double() - w).abs().max()) / mm
                                    for a, w, mm in zip(got32, want, med)],
            "outputs": ["mean", "var"], "shape": list(want[0].shape),
            "collectives": par.count_collectives(sharded_fn, m5.posterior, m5.params, xs,
                                                 m5.config, sp)}
    emit({"phase": "sharded_predict", **group, "asset": "bench_model_n5120.npz",
          "Ny": m5.layout.Ny, "n_max": m5.layout.n_max, "particles": xs.shape[0],
          "predictions": pred, "seconds": time.perf_counter() - t_phase, "device": kind,
          "nvidia_smi": smi})
    for name, e in pred.items():
        if not max(e["f64_err_over_median"]) <= 1e-9:
            raise AssertionError(f"sharded_predict {name}: float64 error "
                                 f"{e['f64_err_over_median']} x the median")
    del post64, prm64, xs64
    par.shutdown()
    torch.cuda.empty_cache()
    return launches


# kernel-name fragments by kind, the first match taken: cuSOLVER's QR
# (geqrf and the Householder updates, larf*, and orgqr / ormqr); its potrf
# runs getrf-without-pivot and syrk kernels; cuBLAS's trsm; the products
# (gemm, gemv, xmma)
KERNEL_KINDS = (("qr (geqrf)", ("geqr", "larf", "orgqr", "ormqr", "orm2r", "org2r")),
                ("cholesky (potrf)", ("potrf", "getrf", "syrk")),
                ("triangular solve", ("trsm", "trsv")),
                ("matmul", ("gemm", "gemv", "xmma", "dot_kernel")))


def profile(run, n: int, unit: str = "frame"):
    """Device time by kernel over ``run()``, a steady window of ``n`` frames
    (or training steps), run once before to warm up; the kernels are also
    summed by kind (``KERNEL_KINDS``, the rest "other").  Only device
    events count: an operator's own device time is that of the kernels it
    launched, which are listed already."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    run()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    kinds = {}
    for us, key, _ in rows:
        kind = next((k for k, frags in KERNEL_KINDS if any(f in key.lower() for f in frags)),
                    "other")
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3 / n
    return {f"{unit}s": n, f"wall_ms_per_{unit}": 1e3 * wall / n,
            f"device_busy_ms_per_{unit}": busy_us / 1e3 / n,
            "device_busy_share": (busy_us / 1e6) / wall if wall > 0 else None,
            f"kernels_per_{unit}": sum(r[2] for r in rows) / n,
            f"device_ms_per_{unit}_by_kind": kinds,
            "top": [{"name": k[:80], f"device_ms_per_{unit}": us / 1e3 / n,
                     f"calls_per_{unit}": c / n} for us, k, c in rows[:15]]}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
