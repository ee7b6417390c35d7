"""The port's CUDA kernel sources, run on the CPU under an emulation of the
few CUDA features they use, against float64 and numpy references.

``gpmdm_tpu_torch/ops/csrc/gp_posterior.cu`` and ``resample_rank.cu`` are
compiled with g++ against stand-ins for the CUDA runtime: one
``std::thread`` per CUDA thread, a barrier for ``__syncthreads``, static
buffers for the dynamic shared memory and ``__atomic_fetch_add`` for
``atomicAdd``.  That checks the kernels' indexing, masking, tiling and staging
where there is no card.  It says nothing about speed or about what nvcc
accepts: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` check the
kernels on the card.  Skips when no C++20 compiler is present.

Tolerance: 1e-4 relative to (1 + |reference|); the kernels sum in fp32.
The resampling rank counts integers, so it must equal numpy's exactly.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

CSRC = Path(__file__).resolve().parents[1] / "gpmdm_tpu_torch" / "ops" / "csrc"
SOURCES = {"kernels.cpp": CSRC / "gp_posterior.cu", "rank.cpp": CSRC / "resample_rank.cu"}

STUB = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
struct uint3_ { unsigned x, y, z; };
extern thread_local uint3_ threadIdx;
extern uint3_ blockIdx;
struct alignas(16) float4 { float x, y, z, w; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 232448; return cudaSuccess; }  // H100
extern std::barrier<>* g_barrier;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
template <typename T> cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_RELAXED); }
using std::min;
"""

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <random>
#include <string>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
thread_local uint3_ threadIdx;
uint3_ blockIdx;
std::barrier<>* g_barrier;
alignas(16) float smem[232448 / 4];
alignas(16) int rank_smem[232448 / 4];
#include "kernels.cpp"
#include "rank.cpp"

template <typename F> void run_blocks(int nblocks, F body, int nthreads = NT) {
  for (int b = 0; b < nblocks; ++b) {
    blockIdx.x = b;
    std::barrier<> bar(nthreads);
    g_barrier = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; ++t) ts.emplace_back([&, t] { threadIdx.x = t; body(); });
    for (auto& th : ts) th.join();
  }
}

template <typename T> std::vector<T> read_file(const char* path, size_t n) {
  std::vector<T> v(n);
  FILE* f = fopen(path, "rb");
  if (!f || fread(v.data(), sizeof(T), n, f) != n) { fprintf(stderr, "short read\n"); exit(2); }
  fclose(f);
  return v;
}

template <typename T> void write_file(const char* path, const std::vector<T>& v) {
  FILE* f = fopen(path, "wb");
  fwrite(v.data(), sizeof(T), v.size(), f);
  fclose(f);
}

// rank in.bin out.bin B Pb: int32 s (B, Pb) in, int64 idx (B, Pb) out
int run_rank(char** argv) {
  const int B = atoi(argv[4]), Pb = atoi(argv[5]);
  auto s = read_file<int>(argv[2], (size_t)B * Pb);
  std::vector<long long> idx((size_t)B * Pb, -7);
  const int on_chip = Pb <= resample_rank_setup();
  std::vector<int> scratch(on_chip ? 0 : (size_t)B * (Pb + 1), -7);
  int* counters = on_chip ? nullptr : scratch.data();
  run_blocks(B, [&] { resample_rank_kernel(s.data(), idx.data(), counters, Pb); }, RANK_NT);
  write_file(argv[3], idx);
  printf("on_chip %d\n", on_chip);
  return 0;
}

// obs in.bin out.bin N P d D B: xt, xs, inv_ls, A, Kinv, z (B, D), lam2 in
// (float32, in that order), quad and qres out
int run_obs_file(char** argv) {
  const int N = atoi(argv[4]), P = atoi(argv[5]), d = atoi(argv[6]), D = atoi(argv[7]),
            B = atoi(argv[8]);
  const size_t sizes[] = {(size_t)N * d, (size_t)P * d, (size_t)d, (size_t)N * D,
                          (size_t)N * N, (size_t)B * D, (size_t)D};
  size_t total = 0;
  for (size_t n : sizes) total += n;
  auto in = read_file<float>(argv[2], total);
  const float* ptr[7];
  size_t off = 0;
  for (int k = 0; k < 7; ++k) { ptr[k] = in.data() + off; off += sizes[k]; }
  std::vector<float> quad(P, -7.f), qres(P, -7.f);
  const int nb = (P + tile_p(N) - 1) / tile_p(N);
  if (rows_per_pass(N) == 256)
    run_blocks(nb, [&] { obs_loglik_kernel<256>(ptr[0], ptr[1], ptr[2], ptr[3], ptr[4], ptr[5], ptr[6], quad.data(), qres.data(), N, P, d, D, P / B); });
  else
    run_blocks(nb, [&] { obs_loglik_kernel<512>(ptr[0], ptr[1], ptr[2], ptr[3], ptr[4], ptr[5], ptr[6], quad.data(), qres.data(), N, P, d, D, P / B); });
  quad.insert(quad.end(), qres.begin(), qres.end());
  write_file(argv[3], quad);
  return 0;
}

template <int RC> void launch(bool lin, bool obs, const float* xt, const float* xs,
    const float* ils, const float* lw, const float* A, const float* K, const float* z,
    const float* l2, float* o1, float* o2, int N, int P, int d, int D, int nv) {
  const int nb = (P + Tile<RC>::TP - 1) / Tile<RC>::TP;
  if (obs) run_blocks(nb, [&] { obs_loglik_kernel<RC>(xt, xs, ils, A, K, z, l2, o1, o2, N, P, d, D, P); });
  else if (lin) run_blocks(nb, [&] { gp_posterior_kernel<RC, true>(xt, xs, ils, lw, A, K, o1, o2, N, P, d, D, nv); });
  else run_blocks(nb, [&] { gp_posterior_kernel<RC, false>(xt, xs, ils, lw, A, K, o1, o2, N, P, d, D, nv); });
}

int main(int argc, char** argv) {
  if (std::string(argv[1]) == "rank") return run_rank(argv);
  if (std::string(argv[1]) == "obs") return run_obs_file(argv);
  if (std::string(argv[1]) == "fits") {  // fits N d Dout has_linear obs
    const int N = atoi(argv[2]), d = atoi(argv[3]), Dout = atoi(argv[4]);
    printf("%d\n", check_smem(gp_smem_bytes(N, d, Dout, atoi(argv[5]), atoi(argv[6]))));
    return 0;
  }
  const int N = atoi(argv[1]), P = atoi(argv[2]), d = atoi(argv[3]), D = atoi(argv[4]),
            nv = atoi(argv[5]), lin = atoi(argv[6]), obs = atoi(argv[7]);
  std::mt19937 rng(N * 131 + P);
  std::normal_distribution<float> nd;
  std::vector<float> xt(N * d), xs(P * d), A(N * D), K(N * N), ils(d), lw(d + 1), z(D), l2(D);
  for (auto& v : xt) v = nd(rng);
  for (auto& v : xs) v = nd(rng);
  for (auto& v : A) v = nd(rng);
  for (auto& v : K) v = nd(rng) / N;  // not symmetric: the quad reads Kinv^T
  for (auto& v : ils) v = std::exp(0.3f * nd(rng));
  for (auto& v : lw) v = std::exp(0.3f * nd(rng));
  for (auto& v : z) v = nd(rng);
  for (auto& v : l2) v = std::exp(nd(rng));
  std::vector<double> ks(N * P), mean(P * D, 0), quad(P, 0), qres(P, 0);
  for (int i = 0; i < N; ++i)
    for (int p = 0; p < P; ++p) {
      double sq = 0, l = 0;
      for (int k = 0; k < d; ++k) {
        const double df = (double)(xt[i * d + k] * ils[k]) - (double)(xs[p * d + k] * ils[k]);
        sq += df * df;
        l += (double)(xt[i * d + k] * lw[k]) * (double)(xs[p * d + k] * lw[k]);
      }
      ks[i * P + p] = i < nv ? std::exp(-sq) + (lin ? l + (double)lw[d] * lw[d] : 0.0) : 0.0;
    }
  for (int p = 0; p < P; ++p) {
    for (int j = 0; j < D; ++j)
      for (int i = 0; i < N; ++i) mean[p * D + j] += ks[i * P + p] * A[i * D + j];
    for (int i = 0; i < N; ++i) {
      double g = 0;
      for (int m = 0; m < N; ++m) g += K[i * N + m] * ks[m * P + p];
      quad[p] += ks[i * P + p] * g;
    }
    for (int j = 0; j < D; ++j) {
      const double df = mean[p * D + j] - z[j];
      qres[p] += l2[j] * df * df;
    }
  }
  std::vector<float> o1(obs ? P : P * D, -7.f), o2(P, -7.f);
  if (rows_per_pass(N) == 256)
    launch<256>(lin, obs, xt.data(), xs.data(), ils.data(), lw.data(), A.data(), K.data(), z.data(), l2.data(), o1.data(), o2.data(), N, P, d, D, nv);
  else
    launch<512>(lin, obs, xt.data(), xs.data(), ils.data(), lw.data(), A.data(), K.data(), z.data(), l2.data(), o1.data(), o2.data(), N, P, d, D, nv);
  double err = 0;
  auto upd = [&](float got, double want) { err = std::max(err, std::abs(got - want) / (1 + std::abs(want))); };
  if (obs) {
    for (int p = 0; p < P; ++p) { upd(o1[p], quad[p]); upd(o2[p], qres[p]); }
  } else {
    for (int i = 0; i < P * D; ++i) upd(o1[i], mean[i]);
    for (int p = 0; p < P; ++p) upd(o2[p], quad[p]);
  }
  printf("max relative error %.3e\n", err);
  return err < 1e-4 ? 0 : 1;
}
"""


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to compile the CPU emulation")
    work = tmp_path_factory.mktemp("cuda_emulation")
    for name, path in SOURCES.items():
        src = re.sub(r"<<<[^>]*>>>", "", path.read_text())  # launches become plain calls
        src = re.sub(r"extern __shared__ __align__\(16\) \w+ \w+\[\];", "", src)
        (work / name).write_text(src)
    (work / "cuda_runtime.h").write_text(STUB)
    (work / "main.cpp").write_text(HARNESS)
    proc = subprocess.run([cxx, "-std=c++20", "-O1", "-w", "-I", str(work), "main.cpp",
                           "-o", "emu", "-lpthread"], cwd=work, capture_output=True,
                          text=True, timeout=120)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("g++ lacks C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr
    return work / "emu"


@pytest.mark.parametrize("N,P,d,D,n_valid,linear,obs", [
    (37, 50, 2, 5, 30, 1, 0),      # K1, masked rows, ragged particle tile
    (236, 130, 2, 2, 236, 1, 0),   # K1 at the bench asset's n_max
    (300, 70, 2, 2, 290, 1, 0),    # K1 in 512-row passes, masked rows
    (256, 64, 2, 5, 256, 0, 1),    # K2 at the last N of 256-row passes
    (300, 70, 3, 5, 300, 0, 0),    # K1', one 512-row pass
    (530, 40, 2, 7, 530, 0, 0),    # K1', two passes
    (300, 40, 2, 45, 300, 0, 0),   # K1' with more outputs than one mean pass takes
    (300, 70, 3, 5, 300, 0, 1),    # K2
    (530, 40, 2, 35, 530, 0, 1),   # K2, two passes, the bench asset's D
    (200, 65, 2, 6, 200, 0, 1),    # K2 with 64-particle blocks
    (300, 40, 2, 45, 300, 0, 1),   # K2 with more outputs than one mean pass takes
])
def test_cuda_source_under_cpu_emulation(emulator, N, P, d, D, n_valid, linear, obs):
    proc = subprocess.run([str(emulator), *map(str, (N, P, d, D, n_valid, linear, obs))],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("N,d,Dout,has_linear,obs,fits", [
    (236, 2, 2, 1, 0, True),     # K1 at the bench asset's n_max
    (480, 2, 35, 0, 0, True),    # K1' at its Ny
    (480, 2, 35, 0, 1, True),    # K2
    (1100, 2, 35, 0, 1, True),
    (2048, 2, 35, 0, 1, False),  # the star tile needs more than an H100 block has
])
def test_launchers_refuse_only_star_tiles_that_do_not_fit(emulator, N, d, Dout, has_linear,
                                                          obs, fits):
    proc = subprocess.run([str(emulator), "fits", *map(str, (N, d, Dout, has_linear, obs))],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) == (0 if fits else -1)


def _run_files(emulator, tmp_path, mode, inputs, out_dtype, args):
    inp, out = tmp_path / "in.bin", tmp_path / "out.bin"
    np.concatenate([np.ravel(a) for a in inputs]).tofile(inp)
    proc = subprocess.run([str(emulator), mode, str(inp), str(out), *map(str, args)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return np.fromfile(out, dtype=out_dtype), proc.stdout


def _rank_numpy(s):
    """min(#{j : s[b, j] <= i}, Pb - 1) for each bank, by sorting."""
    B, Pb = s.shape
    return np.stack([np.minimum(np.searchsorted(np.sort(r), np.arange(Pb), side="right"), Pb - 1)
                     for r in s])


def _systematic_s(rng, B, Pb, alpha):
    """s of systematic resampling from seeded Dirichlet weights."""
    w = rng.dirichlet(np.full(Pb, alpha), size=B).astype(np.float32)
    u = rng.random((B, 1)).astype(np.float32)
    cum = np.cumsum(w, axis=1, dtype=np.float32)
    return np.clip(np.floor(Pb * cum - u).astype(np.int64) + 1, 0, Pb).astype(np.int32)


@pytest.mark.parametrize("B,Pb,kind", [
    (3, 50, "sorted"),        # fewer particles than threads
    (2, 3000, "sorted"),      # several particles per thread
    (2, 3000, "unsorted"),
    (3, 50, "extremes"),      # only 0 and Pb, and one long run
    (1, 60000, "sorted"),     # counters in global scratch, not shared memory
])
def test_resample_rank_under_cpu_emulation(emulator, tmp_path, B, Pb, kind):
    rng = np.random.default_rng(B * 1000 + Pb)
    s = _systematic_s(rng, B, Pb, alpha=0.3)
    if kind == "unsorted":
        s = rng.permuted(s, axis=1)
    elif kind == "extremes":
        s = np.where(rng.random((B, Pb)) < 0.5, 0, Pb).astype(np.int32)
        s[0] = Pb // 2
    idx, out = _run_files(emulator, tmp_path, "rank", [s], np.int64, (B, Pb))
    assert ("on_chip 0" in out) == (Pb > 50000)
    np.testing.assert_array_equal(idx.reshape(B, Pb), _rank_numpy(s))


@pytest.mark.parametrize("N,B,Pb,d,D", [
    (300, 3, 50, 2, 5),    # 32-particle tiles: tiles straddle banks
    (200, 3, 50, 2, 6),    # 64-particle tiles
    (37, 4, 25, 2, 5),     # one tile spans several whole banks
])
def test_banked_obs_loglik_under_cpu_emulation(emulator, tmp_path, N, B, Pb, d, D):
    rng = np.random.default_rng(N + B + Pb)
    f32 = np.float32
    P = B * Pb
    xt, xs = rng.normal(size=(N, d)).astype(f32), rng.normal(size=(P, d)).astype(f32)
    inv_ls = np.exp(0.3 * rng.normal(size=d)).astype(f32)
    A = rng.normal(size=(N, D)).astype(f32)
    Kinv = (rng.normal(size=(N, N)) / N).astype(f32)
    z = rng.normal(size=(B, D)).astype(f32)
    lam2 = np.exp(rng.normal(size=D)).astype(f32)
    got, _ = _run_files(emulator, tmp_path, "obs", [xt, xs, inv_ls, A, Kinv, z, lam2],
                        np.float32, (N, P, d, D, B))
    a, b = (xt * inv_ls).astype(np.float64), (xs * inv_ls).astype(np.float64)
    ks = np.exp(-np.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=2))
    mean = ks.T @ A.astype(np.float64)
    quad = np.sum(ks * (Kinv.astype(np.float64) @ ks), axis=0)
    qres = np.sum(lam2 * (mean - np.repeat(z, Pb, axis=0)) ** 2, axis=1)
    want = np.concatenate([quad, qres])
    assert np.max(np.abs(got - want) / (1 + np.abs(want))) < 1e-4
