"""The port's CUDA kernel sources, run on the CPU under an emulation of the
few CUDA features they use, against float64 and numpy references.

``gpmdm_tpu_torch/ops/csrc/gp_posterior.cu`` and ``resample_rank.cu`` are
compiled with g++ against stand-ins for the CUDA runtime: one fiber
(``ucontext``) per CUDA thread, all on one OS thread, blocks of a grid in
turn (the class axis included); a barrier for ``__syncthreads`` whose
waiters yield to the next fiber; static buffers for the shared memory;
and warp shuffles and ballots through a per-warp barrier and an exchange
buffer.  A block's threads interleave only where one waits, so a run
takes the same CPU time however loaded the machine is (with one OS
thread per CUDA thread, every barrier would wait for hundreds of threads
to be scheduled).  The sources' asynchronous copies are plain copies off
the card (their own ``copy_async``/``copy_wait_all`` wrappers).  That
checks the kernels' indexing, masking, tiling and staging where there is
no card.  It says nothing about speed or about what nvcc accepts:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` check the kernels on
the card.  Skips when no g++ is present.

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
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
struct uint3_ { unsigned x, y, z; };
extern uint3_ threadIdx;
extern uint3_ blockIdx;
extern uint3_ gridDim;
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
// The CUDA threads of a block are fibers on one OS thread, switched only
// where a thread waits: fiber_yield hands over to the next live fiber.
void fiber_yield();
// An n-thread barrier: the last to arrive opens it, the others yield until
// it opens.
struct EmuBarrier {
  int n = 0, arrived = 0;
  unsigned gen = 0;
  void arrive_and_wait() {
    const unsigned g = gen;
    if (++arrived == n) { arrived = 0; ++gen; return; }
    while (gen == g) fiber_yield();
  }
};
extern EmuBarrier g_barrier;
extern EmuBarrier g_warp_barrier[32];
extern int g_exchange[32][32];
inline void __syncthreads() { g_barrier.arrive_and_wait(); }
inline void __syncwarp() { g_warp_barrier[threadIdx.x / 32].arrive_and_wait(); }
// bar.sync id, n: the first thread to arrive sizes the n-thread barrier
extern EmuBarrier g_named_barrier[16];
inline void __named_barrier_sync(int id, int n) {
  if (!g_named_barrier[id].n) g_named_barrier[id].n = n;
  g_named_barrier[id].arrive_and_wait();
}
template <typename T> cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline int atomicAdd(int* p, int v) { const int old = *p; *p += v; return old; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline void __threadfence() {}
template <typename T> T __ldcg(const T* p) { return *p; }
template <typename T> T __ldg(const T* p) { return *p; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
// every lane of the warp posts a value, then reads lane src's
inline int warp_exchange(int v, int src) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_exchange[w][l] = v;
  g_warp_barrier[w].arrive_and_wait();
  const int r = g_exchange[w][src & 31];
  g_warp_barrier[w].arrive_and_wait();
  return r;
}
inline int __shfl_sync(unsigned, int v, int src) { return warp_exchange(v, src); }
inline int __shfl_up_sync(unsigned, int v, unsigned delta) {
  const int l = threadIdx.x % 32;
  return warp_exchange(v, l >= (int)delta ? l - (int)delta : l);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_exchange[w][l] = pred != 0;
  g_warp_barrier[w].arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (unsigned)g_exchange[w][i] << i;
  g_warp_barrier[w].arrive_and_wait();
  return m;
}
using std::min;
"""

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <random>
#include <string>
#include <vector>
#include <ucontext.h>
#include "cuda_runtime.h"
uint3_ threadIdx;
uint3_ blockIdx;
uint3_ gridDim;
EmuBarrier g_barrier;
EmuBarrier g_warp_barrier[32];
EmuBarrier g_named_barrier[16];
int g_exchange[32][32];
alignas(16) float smem[232448 / 4];
#include "kernels.cpp"
#include "rank.cpp"

// The fibers of the running block: one per CUDA thread, each with its own
// stack; g_cur runs, the others wait where they last yielded.
struct Fiber { ucontext_t ctx; bool done; };
constexpr size_t FIBER_STACK = 256 * 1024;
std::vector<Fiber> g_fibers;
std::vector<std::unique_ptr<char[]>> g_stacks;
int g_cur;
ucontext_t g_main;
const std::function<void()>* g_body;

void fiber_yield() {
  const int n = (int)g_fibers.size();
  int next = g_cur;
  do next = (next + 1) % n; while (g_fibers[next].done);
  if (next == g_cur) return;
  const int prev = g_cur;
  g_cur = next;
  threadIdx.x = next;
  swapcontext(&g_fibers[prev].ctx, &g_fibers[next].ctx);
}

// A fiber runs the body, then hands over to the next live fiber, or back
// to run_grid when it was the last.
void fiber_main() {
  (*g_body)();
  g_fibers[g_cur].done = true;
  const int n = (int)g_fibers.size();
  for (int k = 1; k < n; ++k) {
    const int next = (g_cur + k) % n;
    if (!g_fibers[next].done) {
      g_cur = next;
      threadIdx.x = next;
      setcontext(&g_fibers[next].ctx);
    }
  }
  setcontext(&g_main);
}

// Runs the grid's blocks in order, each as nthreads fibers on this OS
// thread: a block's threads interleave only at barriers, whatever else
// the machine runs.
template <typename F> void run_grid(int gx, int gy, int gz, F body, int nthreads) {
  const std::function<void()> fn = body;
  g_body = &fn;
  while ((int)g_stacks.size() < nthreads) g_stacks.emplace_back(new char[FIBER_STACK]);
  gridDim = {(unsigned)gx, (unsigned)gy, (unsigned)gz};
  for (int bz = 0; bz < gz; ++bz)
    for (int by = 0; by < gy; ++by)
      for (int bx = 0; bx < gx; ++bx) {
        blockIdx = {(unsigned)bx, (unsigned)by, (unsigned)bz};
        g_barrier = EmuBarrier{nthreads};
        for (auto& b : g_warp_barrier) b = EmuBarrier{32};
        for (auto& b : g_named_barrier) b = EmuBarrier{};
        g_fibers.assign(nthreads, Fiber{});
        for (int t = 0; t < nthreads; ++t) {
          getcontext(&g_fibers[t].ctx);
          g_fibers[t].ctx.uc_stack.ss_sp = g_stacks[t].get();
          g_fibers[t].ctx.uc_stack.ss_size = FIBER_STACK;
          g_fibers[t].ctx.uc_link = nullptr;
          makecontext(&g_fibers[t].ctx, fiber_main, 0);
        }
        g_cur = 0;
        threadIdx = {0, 0, 0};
        swapcontext(&g_main, &g_fibers[0].ctx);
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
  const int blocks = (Pb + RANK_RANGE - 1) / RANK_RANGE;
  run_grid(blocks, B, 1, [&] { resample_rank_kernel(s.data(), idx.data(), Pb); }, RANK_NT);
  write_file(argv[3], idx);
  printf("blocks_per_bank %d\n", blocks);
  return 0;
}

// Fills the harness's shared memory past the launcher's request with a
// canary; canary_ok checks that it survived.
void set_canary(size_t bytes) {
  for (size_t i = bytes / sizeof(float); i < sizeof(smem) / sizeof(float); ++i) smem[i] = -12345.f;
}
bool canary_ok(size_t bytes) {
  for (size_t i = bytes / sizeof(float); i < sizeof(smem) / sizeof(float); ++i)
    if (smem[i] != -12345.f) return false;
  return true;
}

// The kernel of kind K over C class blocks of P particles as gp_plan lays
// it out for a card of sms SMs (0: one block per particle tile), with the
// harness's dynamic shared memory cut to what the launcher asks for: a
// canary past that must survive.  Returns the bytes asked for, or -1 if
// the canary died or a ticket was left wrong.
template <int TP, int K>
long run_core(int splits, int tiles, int C, const float* xt, const float* xs, const float* ils,
              const float* lw, const float* A, const float* Kv, const float* z,
              const float* l2, float* o1, float* o2, int N, int P, int d, int D, int nv, int Pb) {
  const size_t bytes = core_smem_bytes<TP>(d, K == KIND_X, K == KIND_OBS);
  set_canary(bytes);
  std::vector<float> partial((size_t)2 * splits * P * C, -7.f);
  std::vector<int> ticket((size_t)tiles * C, 0);
  run_grid(tiles, splits, C, [&] { posterior_core<TP, K>(xt, xs, ils, lw, A, Kv, z, l2, o1, o2, N, P, d, D, nv, Pb, splits, partial.data(), ticket.data()); }, NT);
  if (!canary_ok(bytes)) return -1;
  for (int c : ticket)  // the last block of each tile sets its ticket back to 0
    if (c != 0) return -1;
  return (long)bytes;
}

// x_onepass over C class blocks, one block per particle tile and class.
template <int TP, int NTH>
long run_onepass(int tiles, int C, const float* xt, const float* xs, const float* ils,
                 const float* lw, const float* A, const float* Kv, float* o1, float* o2, int N,
                 int P, int d, int D, int nv) {
  const size_t bytes = onepass_smem_bytes<TP, NTH>(N, d);
  if (bytes > sizeof(smem)) return -1;
  set_canary(bytes);
  run_grid(tiles, C, 1, [&] { x_onepass<TP, NTH>(xt, xs, ils, lw, A, Kv, o1, o2, N, P, d, D, nv); }, NTH);
  return canary_ok(bytes) ? (long)bytes : -1;
}

long run_any(bool lin, bool obs, int tile, int sms, int C, int one_pass, const float* xt,
             const float* xs, const float* ils, const float* lw, const float* A, const float* Kv,
             const float* z, const float* l2, float* o1, float* o2, int N, int P, int d, int D,
             int nv, int Pb) {
  int plan[4];
  if (gp_plan(N, D, P, C, tile, one_pass, sms, plan) != 0) return -1;
  printf("tile %d splits %d one_pass %d\n", plan[0], plan[1], plan[3]);
  if (plan[3]) {
    if (!lin || obs) return -1;
#define ONE(TP, NTH) run_onepass<TP, NTH>(plan[2], C, xt, xs, ils, lw, A, Kv, o1, o2, N, P, d, D, nv)
    const bool narrow = onepass_cols(N + D) == 128;
    if (plan[0] == 64) return narrow ? ONE(64, 128) : ONE(64, 256);
    return narrow ? ONE(128, 256) : ONE(128, 512);
#undef ONE
  }
#define GO(TP, K) run_core<TP, K>(plan[1], plan[2], C, xt, xs, ils, lw, A, Kv, z, l2, o1, o2, N, P, d, D, nv, Pb)
  if (plan[0] == 64) return obs ? GO(64, KIND_OBS) : lin ? GO(64, KIND_X) : GO(64, KIND_RBF);
  return obs ? GO(128, KIND_OBS) : lin ? GO(128, KIND_X) : GO(128, KIND_RBF);
#undef GO
}

// obs in.bin out.bin N P d D B tile sms: xt, xs, inv_ls, A, Kinv, z (B, D), lam2 in
// (float32, in that order), quad and qres out
int run_obs_file(char** argv) {
  const int N = atoi(argv[4]), P = atoi(argv[5]), d = atoi(argv[6]), D = atoi(argv[7]),
            B = atoi(argv[8]), tile = atoi(argv[9]), sms = atoi(argv[10]);
  const size_t sizes[] = {(size_t)N * d, (size_t)P * d, (size_t)d, (size_t)N * D,
                          (size_t)N * N, (size_t)B * D, (size_t)D};
  size_t total = 0;
  for (size_t n : sizes) total += n;
  auto in = read_file<float>(argv[2], total);
  const float* ptr[7];
  size_t off = 0;
  for (int k = 0; k < 7; ++k) { ptr[k] = in.data() + off; off += sizes[k]; }
  std::vector<float> quad(P, -7.f), qres(P, -7.f);
  if (run_any(false, true, tile, sms, 1, 0, ptr[0], ptr[1], ptr[2], nullptr, ptr[3], ptr[4], ptr[5],
              ptr[6], quad.data(), qres.data(), N, P, d, D, N, P / B) < 0) return 3;
  quad.insert(quad.end(), qres.begin(), qres.end());
  write_file(argv[3], quad);
  return 0;
}

// N P d D n_valid linear obs tile sms C one_pass: seeded inputs for C class
// blocks (K1; C = 1 otherwise), float64 reference
int main(int argc, char** argv) {
  if (std::string(argv[1]) == "rank") return run_rank(argv);
  if (std::string(argv[1]) == "obs") return run_obs_file(argv);
  const int N = atoi(argv[1]), P = atoi(argv[2]), d = atoi(argv[3]), D = atoi(argv[4]),
            nv = atoi(argv[5]), lin = atoi(argv[6]), obs = atoi(argv[7]), tile = atoi(argv[8]),
            sms = atoi(argv[9]), C = atoi(argv[10]), one_pass = atoi(argv[11]);
  std::mt19937 rng(N * 131 + P);
  std::normal_distribution<float> nd;
  std::vector<float> xt((size_t)C * N * d), xs((size_t)P * d), A((size_t)C * N * D),
      K((size_t)C * N * N), ils(d), lw(d + 1), z(D), l2(D);
  for (auto& v : xt) v = nd(rng);
  for (auto& v : xs) v = nd(rng);
  for (auto& v : A) v = nd(rng);
  for (auto& v : K) v = nd(rng) / N;  // not symmetric: the quad reads Kinv^T
  for (auto& v : ils) v = std::exp(0.3f * nd(rng));
  for (auto& v : lw) v = std::exp(0.3f * nd(rng));
  for (auto& v : z) v = nd(rng);
  for (auto& v : l2) v = std::exp(nd(rng));
  std::vector<double> mean((size_t)C * P * D, 0), quad((size_t)C * P, 0), qres(P, 0);
  for (int c = 0; c < C; ++c) {
    const float *xc = xt.data() + (size_t)c * N * d, *Ac = A.data() + (size_t)c * N * D,
                *Kc = K.data() + (size_t)c * N * N;
    std::vector<double> ks((size_t)N * P);
    for (int i = 0; i < N; ++i)
      for (int p = 0; p < P; ++p) {
        double sq = 0, l = 0;
        for (int k = 0; k < d; ++k) {
          const double df = (double)(xc[i * d + k] * ils[k]) - (double)(xs[p * d + k] * ils[k]);
          sq += df * df;
          l += (double)(xc[i * d + k] * lw[k]) * (double)(xs[p * d + k] * lw[k]);
        }
        ks[(size_t)i * P + p] = i < nv ? std::exp(-sq) + (lin ? l + (double)lw[d] * lw[d] : 0.0) : 0.0;
      }
    for (int p = 0; p < P; ++p) {
      double* mp = mean.data() + ((size_t)c * P + p) * D;
      for (int j = 0; j < D; ++j)
        for (int i = 0; i < N; ++i) mp[j] += ks[(size_t)i * P + p] * Ac[(size_t)i * D + j];
      for (int i = 0; i < N; ++i) {
        double g = 0;
        for (int m = 0; m < N; ++m) g += Kc[(size_t)i * N + m] * ks[(size_t)m * P + p];
        quad[(size_t)c * P + p] += ks[(size_t)i * P + p] * g;
      }
      for (int j = 0; j < D; ++j) {
        const double df = mp[j] - z[j];
        qres[p] += l2[j] * df * df;
      }
    }
  }
  std::vector<float> o1(obs ? P : (size_t)C * P * D, -7.f), o2((size_t)C * P, -7.f);
  const long bytes = run_any(lin, obs, tile, sms, C, one_pass, xt.data(), xs.data(), ils.data(),
                             lw.data(), A.data(), K.data(), z.data(), l2.data(), o1.data(),
                             o2.data(), N, P, d, D, nv, P);
  if (bytes < 0) { printf("shared memory written past the launcher's request, or a ticket left wrong\n"); return 3; }
  double err = 0;
  auto upd = [&](float got, double want) { err = std::max(err, std::abs(got - want) / (1 + std::abs(want))); };
  if (obs) {
    for (int p = 0; p < P; ++p) { upd(o1[p], quad[p]); upd(o2[p], qres[p]); }
  } else {
    for (size_t i = 0; i < (size_t)C * P * D; ++i) upd(o1[i], mean[i]);
    for (size_t i = 0; i < (size_t)C * P; ++i) upd(o2[i], quad[i]);
  }
  printf("smem_bytes %ld\nmax relative error %.3e\n", bytes, err);
  return err < 1e-4 ? 0 : 1;
}
"""


@pytest.fixture(scope="module")
def emulation_dir(tmp_path_factory):
    """The sources, the stand-ins and the harness, ready for g++."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the CPU emulation")
    work = tmp_path_factory.mktemp("cuda_emulation")
    for name, path in SOURCES.items():
        src = re.sub(r"<<<[^>]*>>>", "", path.read_text())  # launches become plain calls
        src = re.sub(r"extern __shared__ __align__\(16\) \w+ \w+\[\];", "", src)
        (work / name).write_text(src)
    (work / "cuda_runtime.h").write_text(STUB)
    (work / "main.cpp").write_text(HARNESS)
    return work


def _compile(work, out, *defines):
    proc = subprocess.run(["g++", "-std=c++20", "-O1", "-w", *(f"-D{m}" for m in defines),
                           "-I", str(work), "main.cpp", "-o", out, "-lpthread"], cwd=work,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return work / out


@pytest.fixture(scope="module")
def emulator(emulation_dir):
    return _compile(emulation_dir, "emu")


@pytest.mark.parametrize("N,P,d,D,n_valid,linear,obs", [
    (37, 50, 2, 5, 30, 1, 0),      # K1, masked rows, ragged particle tile
    (236, 130, 2, 2, 236, 1, 0),   # K1 at the bench asset's n_max
    (300, 70, 2, 2, 290, 1, 0),    # K1, masked rows, a partial last ring stage
    (256, 64, 2, 5, 256, 0, 1),    # K2, N a multiple of the ring's rows
    (300, 70, 3, 5, 300, 0, 0),    # K1', one 512-column pass
    (530, 40, 2, 7, 530, 0, 0),    # K1', two passes
    (300, 40, 2, 45, 300, 0, 0),   # K1' with outputs in two warps' columns
    (300, 70, 3, 5, 300, 0, 1),    # K2
    (530, 40, 2, 35, 530, 0, 1),   # K2, two passes, the bench asset's D
    (200, 65, 2, 6, 200, 0, 1),    # K2, three particle tiles
    (300, 40, 2, 45, 300, 0, 1),   # K2 with outputs in two warps' columns
    (1500, 40, 2, 35, 1500, 0, 1),  # K2 past the old shared-memory row cap
    (1501, 20, 3, 3, 1490, 1, 0),   # K1 past it: unaligned Kinv rows, masked rows
    (90, 40, 5, 3, 85, 1, 0),       # K1 with d past the register path
    (70, 30, 6, 4, 70, 0, 1),       # K2 with d past the register path
])
def test_cuda_source_under_cpu_emulation(emulator, N, P, d, D, n_valid, linear, obs):
    _emulate(emulator, N, P, d, D, n_valid, linear, obs)


def _emulate(emulator, N, P, d, D, n_valid, linear, obs, tile=0, sms=0, C=1, one_pass=None):
    """One launch under the emulation, held against float64 (the run fails
    past 1e-4); its plan, ``(tile, splits, one_pass)``, and the shared
    memory it asked for.  ``one_pass`` defaults to K1's launcher choice."""
    one_pass = linear if one_pass is None else one_pass
    proc = subprocess.run([str(emulator), *map(str, (N, P, d, D, n_valid, linear, obs, tile,
                                                     sms, C, int(one_pass)))],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    plan = re.search(r"tile (\d+) splits (\d+) one_pass (\d+)", proc.stdout)
    return tuple(map(int, plan.groups())), int(re.search(r"smem_bytes (\d+)", proc.stdout)[1])


@pytest.mark.parametrize("tile,sms", [(64, 0), (128, 0), (64, 132), (128, 132)])
@pytest.mark.parametrize("N,P,d,D,n_valid,linear,obs", [
    (300, 150, 2, 2, 290, 1, 0),   # K1, masked rows, ragged particle tile
    (530, 140, 2, 35, 530, 0, 1),  # K2, the bench asset's D
    (300, 70, 3, 45, 300, 0, 0),   # K1'
])
def test_cuda_source_tiles_under_cpu_emulation(emulator, N, P, d, D, n_valid, linear, obs,
                                               tile, sms):
    """Both particle tiles of the streamed core, each with one block per
    particle tile and with its passes split over blocks as on a 132-SM card
    (the last block of a tile adds the splits' sums and sets the tile's
    ticket back to 0)."""
    (_, splits, one), _ = _emulate(emulator, N, P, d, D, n_valid, linear, obs, tile, sms)
    assert (splits > 1) == (sms > 0) and not one


# x_onepass's star tile, rings and scaled training rows, in floats: N
# rounded up to 16 rows x TP particles, two tiles of 16 rows x RC columns,
# and two N x d
def _onepass_bytes(N, d, tp, rc):
    return 4 * (-(-N // 16) * 16 * tp + 2 * 16 * rc + 2 * N * d)


@pytest.mark.parametrize("N,P,d,D,n_valid,C,tile,sms,rc", [
    (236, 130, 2, 2, 236, 2, 0, 0, 256),     # the headline's classes, ragged last tile
    (236, 130, 2, 2, 230, 3, 128, 132, 256),  # 128 x 256 (512 threads, warp pairs), masked rows
    (118, 70, 3, 3, 118, 4, 0, 0, 128),      # c8's widths: 128 x 128 (256 threads, warp pairs)
    (118, 200, 3, 3, 110, 2, 64, 0, 128),     # and 64 x 128 (128 threads)
    (236, 40, 4, 4, 236, 1, 64, 0, 256),     # d4's widths, one class
    (254, 65, 2, 2, 254, 2, 0, 0, 256),      # N + Dout exactly at the one-pass limit
    (126, 40, 2, 2, 120, 2, 64, 0, 128),     # 128 columns exactly on the narrow block
    (127, 40, 2, 2, 127, 2, 0, 0, 256),      # 129 columns: the wide block
    (33, 20, 5, 5, 30, 2, 0, 0, 128),        # d past the register path, N one row past a tile
])
def test_onepass_k1_under_cpu_emulation(emulator, N, P, d, D, n_valid, C, tile, sms, rc):
    """K1's one-pass design over C classes in one launch: no split at any
    card size, and its star tile and rings stay inside the shared memory
    it asks for (the canary past it survives)."""
    (tp, splits, one), smem = _emulate(emulator, N, P, d, D, n_valid, 1, 0, tile, sms, C)
    assert one == 1 and splits == 1 and tp == (tile or (128 if N + D <= 128 else 64))
    assert smem == _onepass_bytes(N, d, tp, rc) <= 232448


@pytest.mark.parametrize("N,P,d,D,n_valid,C,sms,one_pass", [
    (255, 50, 2, 2, 253, 2, 0, 1),    # one column past the one-pass limit
    (255, 50, 2, 2, 253, 2, 132, 1),  # and split over blocks, per class
    (300, 40, 5, 5, 290, 1, 0, 1),    # past it with d past the register path
    (300, 40, 5, 5, 290, 3, 132, 1),  # and split over blocks, three classes
    (40, 50, 2, 2, 38, 3, 0, 0),      # forced on blocks that fit one pass:
    (37, 50, 2, 5, 30, 1, 0, 0),      # masked rows, ragged particle tile
    (236, 130, 2, 2, 236, 1, 0, 0),   # the bench asset's n_max
    (90, 40, 5, 3, 85, 1, 0, 0),      # d past the register path
])
def test_k1_past_onepass_limit_takes_streamed_core(emulator, N, P, d, D, n_valid, C, sms,
                                                   one_pass):
    """Past N + Dout = 256 (or when forced) K1 runs on the streamed core,
    every class in one launch along the grid's third axis, its generic-width
    path with the linear term included."""
    (_, splits, one), _ = _emulate(emulator, N, P, d, D, n_valid, 1, 0, 0, sms, C,
                                   one_pass=one_pass)
    assert one == 0 and (splits > 1) == (sms > 0)


def _smem_bytes(emulator, N, d, Dout, has_linear, obs):
    """Run one kernel on the streamed core at N training rows and 8
    particles; the shared memory that its launcher asks for (the run fails
    if the kernel writes past it or misses the float64 reference)."""
    return _emulate(emulator, N, 8, d, Dout, N, has_linear, obs, one_pass=0)[1]


@pytest.mark.parametrize("N,d,Dout,has_linear,obs", [
    (236, 2, 2, 1, 0),     # K1 at the bench asset's n_max
    (480, 2, 35, 0, 0),    # K1' at its Ny
    (480, 2, 35, 0, 1),    # K2
    (2048, 2, 35, 0, 1),   # K2 at the n2048 asset's Ny, past the old cap
    (5120, 2, 35, 0, 1),   # K2 at the n5120 asset's Ny
])
def test_launchers_refuse_only_star_tiles_that_do_not_fit(emulator, N, d, Dout, has_linear,
                                                          obs):
    """The streamed core holds no star tile, so no N is refused: a block's
    shared memory is the same at N as at 8 training rows, and the kernel
    stays inside it and matches float64.  (K1's one-pass design holds its
    star tile only while N + Dout <= 256: test_onepass_k1_under_cpu_emulation.)"""
    assert _smem_bytes(emulator, N, d, Dout, has_linear, obs) == _smem_bytes(
        emulator, 8, d, Dout, has_linear, obs)


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
    (2, 3000, "sorted"),      # several particles per thread, two blocks a bank
    (2, 3000, "unsorted"),
    (3, 50, "extremes"),      # only 0 and Pb, and one long run
    (1, 60000, "sorted"),     # one bank over several blocks
    (1, 30000, "low"),        # every value below the later blocks' ranges
])
def test_resample_rank_under_cpu_emulation(emulator, tmp_path, B, Pb, kind):
    rng = np.random.default_rng(B * 1000 + Pb)
    s = _systematic_s(rng, B, Pb, alpha=0.3)
    if kind == "unsorted":
        s = rng.permuted(s, axis=1)
    elif kind == "extremes":
        s = np.where(rng.random((B, Pb)) < 0.5, 0, Pb).astype(np.int32)
        s[0] = Pb // 2
    elif kind == "low":
        s = np.sort(rng.integers(0, Pb // 8, size=(B, Pb)), axis=1).astype(np.int32)
    idx, out = _run_files(emulator, tmp_path, "rank", [s], np.int64, (B, Pb))
    blocks = int(re.search(r"blocks_per_bank (\d+)", out)[1])
    assert (blocks > 1) == (Pb >= 3000)
    np.testing.assert_array_equal(idx.reshape(B, Pb), _rank_numpy(s))


# (particles per block, SMs of the card laid out for), by case
BANKED_TILES = {300: (64, 132), 200: (64, 0), 37: (128, 0)}


@pytest.mark.parametrize("N,B,Pb,d,D", [
    (300, 3, 50, 2, 5),    # tiles straddle banks, passes split over two blocks
    (200, 3, 50, 2, 6),    # 64-particle tiles
    (37, 4, 25, 2, 5),     # one 128-particle tile spans several whole banks
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
                        np.float32, (N, P, d, D, B, *BANKED_TILES[N]))
    a, b = (xt * inv_ls).astype(np.float64), (xs * inv_ls).astype(np.float64)
    ks = np.exp(-np.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=2))
    mean = ks.T @ A.astype(np.float64)
    quad = np.sum(ks * (Kinv.astype(np.float64) @ ks), axis=0)
    qres = np.sum(lam2 * (mean - np.repeat(z, Pb, axis=0)) ** 2, axis=1)
    want = np.concatenate([quad, qres])
    assert np.max(np.abs(got - want) / (1 + np.abs(want))) < 1e-4
