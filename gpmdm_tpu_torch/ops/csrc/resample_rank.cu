// Resampling rank kernel for Hopper (sm_90a): the heart of systematic
// resampling, for a bank of B independent filters.
//
// Replaces the Pallas TPU kernel rank_pallas / _rank_kernel of
// tools/exp_resample_rank_pallas.py (and the XLA 0/1 matmul that the JAX
// package's systematic_resample_indices lowers to on the main path):
//
//   idx[b, i] = min(#{j : s[b, j] <= i}, Pb - 1),   i in [0, Pb)
//
// for int32 s of shape (B, Pb), sorted or not, with int64 idx out.  The
// TPU kernel builds 0/1 comparison tiles in VMEM and sums them on the
// MXU; here the count is a histogram and a prefix sum, which is what the
// matmul computes.  Values are clamped into [0, Pb] first: a value below
// 0 counts for every i and one above Pb - 1 for none, exactly as the
// comparison does, so the result is the definition's for any int32 s.
//
// What bounds it on the H100: 4 bytes in and 8 bytes out per particle and
// a few integer operations, so bytes: 12 x 120,000 B at 3.35 TB/s is about
// 0.43 us at 12 x 10,000.  That is far below a launch's latency (several
// us), so in practice the launch and the block's serial steps bound it.
//
// Design.  Block (g, b) owns the outputs i in [g R, g R + R) of bank b
// (R = 2,048), so a bank of Pb particles takes ceil(Pb / R) blocks side by
// side and no block waits on another; the R counters live in shared
// memory, never in device memory.
//  1. Zero the R counters.
//  2. Histogram.  The block reads its bank's whole s, four values a thread
//     at a time with coalesced 16-byte loads, four sweeps in flight (the
//     blocks after the first read it from L2).  A value below the range
//     adds to a per-thread count; a warp with no value inside the range
//     does nothing else.  A value inside it adds to its counter with one
//     atomicAdd per run of equal values inside the warp's 128 consecutive
//     values: systematic resampling's s is nondecreasing with long runs
//     (a particle of negligible weight repeats its predecessor's value),
//     which would otherwise pile thousands of atomics on one counter.  A
//     run's head finds its end from a ballot of the lanes holding heads.
//  3. Scan.  Each thread sums its R / NT contiguous counters; warp shuffles
//     scan the sums inside each warp and, after one barrier, the warp
//     totals; the count below the range is reduced the same way.  Each
//     thread then rewrites its counters as running sums.
//  4. Coalesced store: idx[b, i] = min(count[i], Pb - 1) as int64.
//
// Measured (PERF.md): level with torch.searchsorted at the filter's
// shapes; at Pb = 100,000 each of the 49 blocks still reads the whole
// bank, about twice searchsorted's time.
//
// Counts are exact integers.  The launcher returns the CUDA error of the
// launch (0 on success).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int RANK_NT = 1024;               // threads per block
// RANK_R and RANK_UNROLL may be set at build time for measurement variants.
#ifndef RANK_R
#define RANK_R 2048
#endif
constexpr int RANK_RANGE = RANK_R;          // outputs (counters) per block
constexpr int RANK_CHUNK = RANK_RANGE / RANK_NT;
#ifndef RANK_UNROLL
#define RANK_UNROLL 4
#endif
constexpr int UNROLL = RANK_UNROLL;         // sweeps of 4 values a thread loads at once
constexpr unsigned FULL = 0xffffffffu;
static_assert(RANK_RANGE % RANK_NT == 0, "each thread scans whole counters");
static_assert(RANK_RANGE * 4 + 64 * 4 <= 48 * 1024, "static shared memory");

// Inclusive sum over the warp's lanes 0 .. lane.
__device__ inline int warp_inclusive_sum(int v, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

__device__ inline int warp_total(int v, int lane) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_sync(FULL, v, lane ^ off);
  return v;
}

__global__ void __launch_bounds__(RANK_NT)
resample_rank_kernel(const int* __restrict__ s, long long* __restrict__ idx, int Pb) {
  __shared__ __align__(16) int count[RANK_RANGE];
  __shared__ int warp_sum[32], warp_below[32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.y;
  const int lo = blockIdx.x * RANK_RANGE;
  const int hi = min(lo + RANK_RANGE, Pb);
  const int* sb = s + (size_t)b * Pb;
  const bool vec = Pb % 4 == 0 && ((uintptr_t)s & 15) == 0;  // each bank's row 16-byte aligned

  for (int i = tid; i < RANK_RANGE; i += RANK_NT) count[i] = 0;
  __syncthreads();

  // 2. histogram: thread t of each sweep holds values 4 t .. 4 t + 3; a
  // thread loads UNROLL sweeps' values before it counts them, so their
  // latencies overlap
  int below = 0;
  for (int base = 0; base < Pb; base += 4 * RANK_NT * UNROLL) {
    int v[UNROLL][4];
#pragma unroll
    for (int w = 0; w < UNROLL; ++w) {
      const int j = base + 4 * (tid + w * RANK_NT);
      if (vec && j < Pb) {
        const int4 q = *reinterpret_cast<const int4*>(sb + j);
        v[w][0] = q.x; v[w][1] = q.y; v[w][2] = q.z; v[w][3] = q.w;
      } else {
        for (int u = 0; u < 4; ++u) v[w][u] = j + u < Pb ? sb[j + u] : 0;
      }
    }
#pragma unroll
    for (int w = 0; w < UNROLL; ++w) {
      if (base + 4 * w * RANK_NT >= Pb) break;  // the same for the whole block
      const int j = base + 4 * (tid + w * RANK_NT);
      bool mine = false;  // a value inside this block's range
      for (int u = 0; u < 4; ++u) {
        // past the end: a value above every range, so it is never counted
        v[w][u] = j + u < Pb ? (v[w][u] < 0 ? 0 : (v[w][u] > Pb ? Pb : v[w][u])) : 0x7fffffff;
        below += v[w][u] < lo;
        mine |= v[w][u] >= lo && v[w][u] < hi;
      }
      // most warps of a bank spread over several blocks hold no value of
      // this block's range: they only count
      if (__ballot_sync(FULL, mine) == 0) continue;
      unsigned heads = 0;  // bit u: value u starts a run
      const int prev = __shfl_up_sync(FULL, v[w][3], 1);
      if (lane == 0 || v[w][0] != prev) heads |= 1u;
      for (int u = 1; u < 4; ++u)
        if (v[w][u] != v[w][u - 1]) heads |= 1u << u;
      // where the next run after this lane's values starts, within the warp
      const unsigned with_heads = __ballot_sync(FULL, heads != 0);
      const unsigned later = lane == 31 ? 0u : with_heads & (FULL << (lane + 1));
      const int next_lane = later ? __ffs(later) - 1 : 0;
      const int first = heads ? __ffs(heads) - 1 : 0;
      const int next_first = __shfl_sync(FULL, first, next_lane);
      const int end = later ? 4 * next_lane + next_first : 128;
      for (int u = 0; u < 4; ++u) {
        if (!(heads >> u & 1u) || v[w][u] < lo || v[w][u] >= hi) continue;
        int stop = u + 1;
        while (stop < 4 && !(heads >> stop & 1u)) ++stop;
        const int len = stop < 4 ? stop - u : end - 4 * lane - u;
        atomicAdd(count + (v[w][u] - lo), len);
      }
    }
  }
  __syncthreads();

  // 3. scan count[0 .. hi - lo), offset by the values below the range
  int* mine = count + tid * RANK_CHUNK;
  int sum = 0;
  for (int k = 0; k < RANK_CHUNK; ++k) sum += mine[k];
  const int incl = warp_inclusive_sum(sum, lane);
  const int wbelow = warp_total(below, lane);
  if (lane == 31) warp_sum[warp] = incl;
  if (lane == 0) warp_below[warp] = wbelow;
  __syncthreads();
  const int wsum = warp_sum[lane];
  const int wincl = warp_inclusive_sum(wsum, lane);
  const int all_below = warp_total(warp_below[lane], lane);
  int run = all_below + __shfl_sync(FULL, wincl - wsum, warp) + incl - sum;
  for (int k = 0; k < RANK_CHUNK; ++k) {
    run += mine[k];
    mine[k] = run;
  }
  __syncthreads();

  // 4. clip and store, neighbouring threads on neighbouring addresses
  long long* out = idx + (size_t)b * Pb;
  for (int i = lo + tid; i < hi; i += RANK_NT) {
    const int v = count[i - lo];
    out[i] = (long long)(v < Pb - 1 ? v : Pb - 1);
  }
}

}  // namespace

extern "C" {

// idx (B, Pb) int64 from s (B, Pb) int32.
int resample_rank_launch(const void* s, void* idx, int B, int Pb, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((Pb + RANK_RANGE - 1) / RANK_RANGE, B);
  resample_rank_kernel<<<grid, RANK_NT, 0, stream>>>((const int*)s, (long long*)idx, Pb);
  return (int)cudaGetLastError();
}

}  // extern "C"
