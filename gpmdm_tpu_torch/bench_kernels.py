"""Device times of the port's CUDA kernels and of their build variants.

    python -m gpmdm_tpu_torch.bench_kernels
    python -m gpmdm_tpu_torch.bench_kernels --only K1 --variants "" GP_SKIP_GEN \
        GP_SKIP_FMA GP_SKIP_STAGE --rank-variants

Needs one CUDA card.  Each variant is a set of comma-separated ``NAME`` or
``NAME=VALUE`` macros (``""`` is the shipped build), compiled from the same
sources by ``ops/_build.py`` and handed to the wrappers' private launchers
as their library.  For each posterior variant the script times K2
(``fused_obs_loglik``) and K1 (every class in one launch, as the filter
calls it) at the filter's shapes on seeded inputs, at the launcher's own
particle tile and at each forced one, K1 on both designs (``one_pass``
and the ``streamed`` core), and K2's ``gemm`` yardstick; for each rank
variant, K3 (``resample_rank``) beside ``torch.searchsorted`` on the same
sorted s, checked bit for bit against its plain version.  ``--only``
keeps the posterior shapes of one kernel.  Variants that skip work
(GP_SKIP_GEN, GP_SKIP_FMA, GP_SKIP_STAGE) give wrong outputs by design and
are timed only.  One JSON line per variant, each with the card's name and
power limit.

The timing helpers, the yardstick and the seeded inputs are also what
``chip_smoke.py`` times and checks with.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gpmdm_tpu_torch.ops import _build
from gpmdm_tpu_torch.ops import gp_posterior as gpk
from gpmdm_tpu_torch.ops import resample as rs

# (kernel, training rows, particles, d, outputs, classes): the headline
# asset's K2 and K1 at one filter, the fleet and the banked guard, n2048's
# K2, and K1 at the c8 and d4 assets' widths
POSTERIOR_SHAPES = [("K2", 480, 10_000, 2, 35, 1), ("K2", 480, 64_000, 2, 35, 1),
                    ("K2", 480, 120_000, 2, 35, 1), ("K2", 2048, 10_000, 2, 35, 1),
                    ("K1", 236, 10_000, 2, 2, 2), ("K1", 236, 64_000, 2, 2, 2),
                    ("K1", 236, 120_000, 2, 2, 2), ("K1", 118, 10_000, 3, 3, 8),
                    ("K1", 236, 10_000, 4, 4, 2)]
# (banks, particles per bank) of K3: the single filter, the banked guard,
# the fleet, and the TPU kernel's design point
RANK_SHAPES = [(1, 10_000), (12, 10_000), (64, 1000), (1, 100_000)]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, in ms, from CUDA events around each
    call.  A spin kernel first keeps the card busy while the host enqueues
    all the calls, so the events bracket device work, not host overhead."""
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


def gemm_yardstick(Xtrain, Xstar, Ay, Kinv, inv_ls):
    """K2's yardstick: torch.matmul of the stacked [Kinv; Ay^T] by a
    precomputed Kstar, what cuBLAS's fp32 product reaches at K2's shape
    (with TF32 off, as the callers set it).  Timed only; the port never
    calls it."""
    ks = gpk._star_plain(Xtrain * inv_ls, Xstar * inv_ls, Xtrain.shape[0]).contiguous()
    M = torch.cat([Kinv, Ay.T]).contiguous()
    return lambda: torch.matmul(M, ks)


def conditioned(N, Dout, dev, seed):
    """Seeded weights A (N, Dout) and an SPD Kinv = I + B B^T (N, N), with
    B ~ N(0, 1/N): eigenvalues in [1, about 5], so fp32 keeps its digits."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = torch.randn(N, N, generator=g, device=dev, dtype=torch.float64) / N ** 0.5
    kinv = torch.eye(N, device=dev, dtype=torch.float64) + B @ B.T
    A = torch.randn(N, Dout, generator=g, device=dev)
    return A, kinv.float().contiguous()


def dirichlet_counts(B, Pb, seed, dev):
    """s of systematic resampling from seeded Dirichlet(0.3) weights, in
    its own order and shuffled within each bank."""
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.full(Pb, 0.3), size=B).astype(np.float32)
    cum = np.cumsum(w, axis=1, dtype=np.float32)
    u = rng.random((B, 1)).astype(np.float32)
    s = np.clip(np.floor(Pb * cum - u).astype(np.int64) + 1, 0, Pb).astype(np.int32)
    return torch.as_tensor(s, device=dev), torch.as_tensor(rng.permuted(s, axis=1), device=dev)


def _variant(text: str) -> tuple[str, ...]:
    return tuple(m for m in text.split(",") if m)


def conditioned_classes(C, N, Dout, dev, seed):
    """``conditioned`` for C class blocks, stacked: A (C, N, Dout), Kinv (C, N, N)."""
    blocks = [conditioned(N, Dout, dev, seed=seed + c) for c in range(C)]
    return (torch.stack([a for a, _ in blocks]).contiguous(),
            torch.stack([k for _, k in blocks]).contiguous())


def bench_posterior(lib, dev, only=None):
    out = {}
    for i, (kern, N, P, d, D, C) in enumerate(POSTERIOR_SHAPES):
        if only not in (None, kern):
            continue
        g = torch.Generator(device=dev).manual_seed(i)
        xs = torch.randn(P, d, generator=g, device=dev)
        inv_ls = torch.ones(d, device=dev)
        if kern == "K2":
            xt = torch.randn(N, d, generator=g, device=dev)
            A, K = conditioned(N, D, dev, seed=i)
            args = (xt, xs, A, K, inv_ls, torch.randn(D, generator=g, device=dev),
                    torch.ones(D, device=dev))
            for tile in gpk.TILES:
                fn = lambda: gpk._obs_loglik_cuda(*args, tile=tile, lib=lib)  # noqa: E731
                out[f"{kern} N={N} P={P} tile={tile}"] = time_ms(fn)
            out[f"gemm N={N} P={P}"] = time_ms(gemm_yardstick(xt, xs, A, K, inv_ls))
            continue
        xt = torch.randn(C, N, d, generator=g, device=dev)
        A, K = conditioned_classes(C, N, D, dev, seed=i)
        args = (xt, xs, A, K, inv_ls, torch.full((d + 1,), 0.5, device=dev), N)
        for design, one_pass in (("one_pass", True), ("streamed", False)):
            for tile in gpk.TILES:
                fn = lambda: gpk._posterior_cuda(  # noqa: E731
                    "fused_x_posterior", *args, True, tile=tile, one_pass=one_pass, lib=lib)
                out[f"{kern} {design} N={N} P={P} d={d} C={C} tile={tile}"] = time_ms(fn)
    return out


def bench_rank(lib, dev):
    out = {}
    for B, Pb in RANK_SHAPES:
        s = dirichlet_counts(B, Pb, B * Pb, dev)[0]
        if not torch.equal(rs._rank_cuda(s, lib=lib), rs.resample_rank_plain(s)):
            raise AssertionError(f"resample_rank differs from its plain version at {(B, Pb)}")
        srt = torch.sort(s, dim=1).values
        ranks = torch.arange(Pb, device=dev, dtype=torch.int32).expand(B, Pb).contiguous()
        out[f"K3 {B}x{Pb}"] = time_ms(lambda: rs._rank_cuda(s, lib=lib))
        out[f"searchsorted {B}x{Pb}"] = time_ms(
            lambda: torch.searchsorted(srt, ranks, right=True))
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=[""])
    ap.add_argument("--rank-variants", nargs="*", default=[""])
    ap.add_argument("--only", choices=("K1", "K2"), default=None,
                    help="time the posterior shapes of one kernel only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    # every variant's nvcc at once, then the timings one variant at a time
    with ThreadPoolExecutor() as pool:
        list(pool.map(_build.build, {_variant(t) for t in args.variants + args.rank_variants}))
    posterior = lambda lib, dev: bench_posterior(lib, dev, args.only)  # noqa: E731
    for kernels, variants, bench in (("posterior", args.variants, posterior),
                                     ("rank", args.rank_variants, bench_rank)):
        for text in variants:
            ms = bench(_build.library(_variant(text)), dev)
            print(json.dumps({"kernels": kernels, "variant": text, "ms": ms,
                              "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
