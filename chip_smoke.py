#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gpmdm_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # what a check runs: needs one CUDA card
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown

Phases, each printing one JSON line on stdout:

1. device  - the card's name and count, nvidia-smi's name and power limit;
             exits non-zero at once when CUDA is not available.
2. build   - builds the CUDA kernels from ops/csrc with nvcc (its
             ``-Xptxas -v`` report goes to stderr).
3. kernels - each kernel (K1 fused_x_posterior, K1' fused_rbf_posterior,
             K2 fused_obs_loglik) at the main path's shapes from
             bench_assets/bench_model.npz with 10,000 particles, against its
             plain PyTorch version run in float64 on the card, twice:
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
             20, from CUDA events.
4. path    - pf_init + pf_scan, P = 10,000, over the 1000-frame stream of
             bench.py (seed 0); the kernel launch counters must rise by
             exactly 1000 x (C + 1); frames/s is the best of 4 runs.
5. guard   - evaluate_pf on the 12 held-out trials of bench.py (6 per
             class, seed 0, burn-in 5, P = 10,000); fails below 0.90 frame
             accuracy.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
a global deadline turns a hang into an exit with the phase it was in.
"""

from __future__ import annotations

import faulthandler
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time

DEADLINE_S = 600
N_PARTICLES = 10_000
N_FRAMES = 1000
TIMED_RUNS = 4
GUARD_MIN_FRAME_ACC = 0.90
# a kernel's max error on the well-conditioned inputs, relative to the
# output's median magnitude in float64
CONDITIONED_RTOL = 1e-4
TRANSITIONS = [[0.9, 0.1], [0.1, 0.9]]
# Published fp32 (non-tensor-core) peak and memory rate by part, from
# NVIDIA's data sheets; the SXM part is the H100 "80GB HBM3".
PEAKS = {"PCIe": (51e12, 2.0e12), "NVL": (60e12, 3.9e12), "": (67e12, 3.35e12)}
ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "gpmdm_tpu_torch/ops/csrc/gp_posterior.cu"
REPLACES = {
    "fused_x_posterior": "gpmdm_tpu/ops/pallas/gp_posterior.py:216",
    "fused_rbf_posterior": "gpmdm_tpu/ops/pallas/gp_posterior.py:216",
    "fused_obs_loglik": "gpmdm_tpu/ops/pallas/gp_posterior.py:347",
}

_phase = ["start"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _on_deadline(signum, frame):
    emit({"phase": _phase[0], "error": f"deadline of {DEADLINE_S} s passed"})
    os._exit(3)


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, in ms, from CUDA events around each
    call.  A spin kernel first keeps the card busy while the host enqueues
    all the calls, so the events bracket device work, not host overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def bound(flops: float, nbytes: float, peaks) -> tuple[float, str]:
    """Least time (ms) at the card's fp32 peak and memory rate."""
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def posterior_work(N, P, d, Dout, has_linear):
    """(flops, bytes) of one fused posterior: star kernel, mean, quad."""
    per_pair = 3 * d + 1 + (2 * d + 2 if has_linear else 0)
    flops = N * P * per_pair + 2 * N * Dout * P + 2 * N * N * P + 2 * N * P
    nbytes = 4 * (N * d + P * d + d + (d + 1 if has_linear else 0) + N * Dout
                  + N * N + P * Dout + P)
    return flops, nbytes


def obs_work(N, P, d, D):
    flops = N * P * (3 * d + 1) + 2 * N * D * P + 2 * N * N * P + 2 * N * P + 4 * D * P
    nbytes = 4 * (N * d + P * d + d + N * D + N * N + 2 * D + 2 * P)
    return flops, nbytes


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


def check_kernel(name, kernel, plain, args, conditioned_args, peaks, work):
    """The kernel against its plain version on the path's inputs and on
    well-conditioned ones (see the module docstring), then timed."""
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
    return {
        "name": name, "route": "cuda", "source": CSRC, "replaces": REPLACES[name],
        "launches": 0,
        "max_abs_err": max(o["max_abs_err"] for o in path.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "path_inputs": path, "conditioned_inputs": conditioned,
    }


def conditioned(N, Dout, dev, seed):
    """Seeded weights A (N, Dout) and an SPD Kinv = I + B B^T (N, N), with
    B ~ N(0, 1/N): eigenvalues in [1, about 5], so fp32 keeps its digits."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    B = torch.randn(N, N, generator=g, device=dev, dtype=torch.float64) / N ** 0.5
    kinv = torch.eye(N, device=dev, dtype=torch.float64) + B @ B.T
    A = torch.randn(N, Dout, generator=g, device=dev)
    return A, kinv.float().contiguous()


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
    from gpmdm_tpu_torch import GPMDM, GPMDM_PF, PFConfig
    from gpmdm_tpu_torch.data import synthetic
    from gpmdm_tpu_torch.filter import particle_filter as pf
    from gpmdm_tpu_torch.ops import _build
    from gpmdm_tpu_torch.ops import gp_posterior as gpk
    from gpmdm_tpu_torch.utils.metrics import evaluate_pf

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
    Ax_cond, Kx_cond = conditioned(n_max, d, dev, seed=1)
    Ay_cond, Ky_cond = conditioned(Ny, D, dev, seed=2)
    kernels = [
        check_kernel("fused_x_posterior", gpk.fused_x_posterior, gpk.fused_x_posterior_plain,
                     (post.Xin_c[0], xs, post.Axc[0], post.Kxc_inv[0], inv_ls_x, lin_w, n_max),
                     (post.Xin_c[0], xs, Ax_cond, Kx_cond, inv_ls_x, lin_w, n_max),
                     peaks, posterior_work(n_max, P, d, d, True)),
        check_kernel("fused_rbf_posterior", gpk.fused_rbf_posterior,
                     gpk.fused_rbf_posterior_plain,
                     (post.X, xs, post.Ay, post.Ky_inv, inv_ls_y),
                     (post.X, xs, Ay_cond, Ky_cond, inv_ls_y),
                     peaks, posterior_work(Ny, P, d, D, False)),
        check_kernel("fused_obs_loglik", gpk.fused_obs_loglik, gpk.fused_obs_loglik_plain,
                     (post.X, xs, post.Ay, post.Ky_inv, inv_ls_y, Z[0], lam2),
                     (post.X, xs, Ay_cond, Ky_cond, inv_ls_y, Z[0], lam2),
                     peaks, obs_work(Ny, P, d, D)),
    ]
    emit({"phase": "kernels", "shapes": {"P": P, "d": d, "D": D, "Ny": Ny, "n_max": n_max,
                                         "C": C},
          "kernels": kernels})

    _phase[0] = "path"

    def run_path(config):
        g = torch.Generator(device=dev).manual_seed(0)
        s0 = pf.pf_init(post, model.layout.y_class_offsets, g, config)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, o = pf.pf_scan(s0, Z, post, params, log_T, cfg, config, generator=g)
        torch.cuda.synchronize()
        return time.perf_counter() - t, o

    gpk.reset_launches()
    wall, outs = run_path(pfc)
    launches = dict(gpk.LAUNCHES)
    expected = {"fused_x_posterior": N_FRAMES * C, "fused_obs_loglik": N_FRAMES,
                "fused_rbf_posterior": 0}
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    probs = outs.class_probs
    if probs.shape != (N_FRAMES, C) or not torch.isfinite(probs).all():
        raise AssertionError("class_probs not finite or of the wrong shape")
    if not torch.allclose(probs.sum(1), torch.ones_like(probs[:, 0]), atol=1e-4):
        raise AssertionError("class_probs rows do not sum to 1")
    if not torch.isfinite(outs.state_mean).all():
        raise AssertionError("state_mean not finite")
    walls = [wall] + [run_path(pfc)[0] for _ in range(TIMED_RUNS - 1)]
    plain_wall = run_path(PFConfig(num_particles=N_PARTICLES, pallas="off"))[0]
    best = min(walls)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    emit({"phase": "path", "particles": N_PARTICLES, "frames": N_FRAMES,
          "launches": launches, "fps": N_FRAMES / best, "ms_per_frame": 1e3 * best / N_FRAMES,
          "walls_s": walls, "plain_path_fps": N_FRAMES / plain_wall,
          "kernel_ms_per_frame": C * kernels[0]["ms"] + kernels[2]["ms"],
          "device": kind, "nvidia_smi": smi})

    if "--profile" in argv:
        _phase[0] = "profile"
        emit(profile(pf, post, params, log_T, cfg, pfc, model, Z, dev))

    _phase[0] = "guard"
    _, _, q_seqs, q_labels = synthetic.make_dataset(
        n_classes=2, n_train_seqs=4, n_test_seqs=6, seq_len=60, D=cfg.D, seed=0)
    flt = GPMDM_PF(model, TRANSITIONS, N_PARTICLES, config=pfc, seed=0)
    rep = evaluate_pf(flt, q_seqs, q_labels, C, burn_in=5)
    acc = rep.frame_metrics["accuracy"]
    emit({"phase": "guard", "frame_acc": acc, "frame_f1": rep.frame_metrics["f1"],
          "trial_acc": rep.trial_metrics["accuracy"], "frames": rep.total_frames,
          "particles": N_PARTICLES, "min_frame_acc": GUARD_MIN_FRAME_ACC})
    if not acc >= GUARD_MIN_FRAME_ACC:
        raise AssertionError(f"guard frame accuracy {acc} < {GUARD_MIN_FRAME_ACC}")

    _phase[0] = "report"
    emit({"kernels": [{k: v for k, v in kern.items()
                       if k not in ("path_inputs", "conditioned_inputs")}
                      for kern in kernels]})
    print(f"{smi} (total {time.perf_counter() - t_start:.1f} s)", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def profile(pf, post, params, log_T, cfg, pfc, model, Z, dev, frames: int = 50):
    """Device time by kernel name over a short steady window of the path."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    g = torch.Generator(device=dev).manual_seed(0)
    s = pf.pf_init(post, model.layout.y_class_offsets, g, pfc)
    s, _ = pf.pf_scan(s, Z[:5], post, params, log_T, cfg, pfc, generator=g)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pf.pf_scan(s, Z[:frames], post, params, log_T, cfg, pfc, generator=g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    return {"phase": "profile", "frames": frames, "wall_ms_per_frame": 1e3 * wall / frames,
            "device_busy_ms_per_frame": busy_us / 1e3 / frames,
            "device_busy_share": (busy_us / 1e6) / wall if wall > 0 else None,
            "top": [{"name": k[:80], "device_ms_per_frame": us / 1e3 / frames,
                     "calls_per_frame": n / frames} for us, k, n in rows[:15]]}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
