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
// Design.  One block of NT threads per bank; no block waits on another.
//  1. Zero Pb + 1 counters: in dynamic shared memory when they fit beside
//     the scan's 2 NT partial sums, else in a global scratch buffer of
//     B (Pb + 1) ints that the wrapper allocates (Pb = 100,000 needs
//     400 KB, more than a block's 227 KB).  The wrapper decides which from
//     resample_rank_setup, queried once per device; a launch queries
//     nothing.
//  2. Histogram.  Each thread walks a contiguous chunk of s and adds each
//     run of equal values with one atomicAdd: systematic resampling's s is
//     nondecreasing with long runs (a particle of negligible weight repeats
//     its predecessor's value), which would otherwise pile thousands of
//     atomics onto one counter.
//  3. In-block inclusive scan of the first Pb counters: each thread sums
//     its contiguous chunk, a Hillis-Steele scan over the NT chunk sums
//     (shared memory and __syncthreads only, no warp shuffles), then each
//     thread rewrites its chunk as running sums from its offset.
//  4. Coalesced store: idx[b, i] = min(count[i], Pb - 1) as int64.
//
// Counts are exact integers.  The launcher returns the CUDA error of the
// launch (0 on success).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int RANK_NT = 1024;  // threads per block (one block per bank)

// Dynamic shared-memory bytes of one block: the scan's 2 NT partial sums,
// plus the Pb + 1 counters when they live on chip.
__host__ __device__ inline size_t rank_smem_bytes(int Pb, bool on_chip) {
  return sizeof(int) * ((size_t)2 * RANK_NT + (on_chip ? (size_t)Pb + 1 : 0));
}

__global__ void __launch_bounds__(RANK_NT)
resample_rank_kernel(const int* __restrict__ s, long long* __restrict__ idx,
                     int* __restrict__ scratch, int Pb) {
  extern __shared__ __align__(16) int rank_smem[];
  const int tid = threadIdx.x, b = blockIdx.x;
  int* part = rank_smem;                   // 2 NT partial sums
  int* count = scratch == nullptr ? rank_smem + 2 * RANK_NT
                                  : scratch + (size_t)b * (Pb + 1);
  const int* sb = s + (size_t)b * Pb;
  long long* out = idx + (size_t)b * Pb;
  const int chunk = (Pb + RANK_NT - 1) / RANK_NT;
  const int lo = tid * chunk < Pb ? tid * chunk : Pb;
  const int hi = lo + chunk < Pb ? lo + chunk : Pb;

  for (int i = tid; i <= Pb; i += RANK_NT) count[i] = 0;
  __syncthreads();

  // 2. histogram, one atomic per run of equal values in this thread's chunk
  int run_v = -1, run_n = 0;
  for (int j = lo; j < hi; ++j) {
    int v = sb[j];
    v = v < 0 ? 0 : (v > Pb ? Pb : v);
    if (v != run_v) {
      if (run_n > 0) atomicAdd(count + run_v, run_n);
      run_v = v;
      run_n = 0;
    }
    ++run_n;
  }
  if (run_n > 0) atomicAdd(count + run_v, run_n);
  __syncthreads();

  // 3. inclusive scan of count[0 .. Pb)
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += count[i];
  part[tid] = sum;
  __syncthreads();
  int* a = part;
  int* c = part + RANK_NT;
  for (int off = 1; off < RANK_NT; off <<= 1) {
    int v = a[tid];
    if (tid >= off) v += a[tid - off];
    c[tid] = v;
    __syncthreads();
    int* t = a;
    a = c;
    c = t;
  }
  int run = tid > 0 ? a[tid - 1] : 0;
  for (int i = lo; i < hi; ++i) {
    run += count[i];
    count[i] = run;
  }
  __syncthreads();

  // 4. clip and store, neighbouring threads on neighbouring addresses
  for (int i = tid; i < Pb; i += RANK_NT) {
    const int v = count[i];
    out[i] = (long long)(v < Pb - 1 ? v : Pb - 1);
  }
}

}  // namespace

extern "C" {

// Largest Pb whose Pb + 1 counters fit in one block's shared memory on the
// current device, after raising the kernel's dynamic shared-memory limit
// to that device's opt-in maximum; a negative value is the negated CUDA
// error.  Call once per device before resample_rank_launch.
int resample_rank_setup(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(resample_rank_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return -(int)err;
  return (int)(optin / sizeof(int)) - 2 * RANK_NT - 1;
}

// idx (B, Pb) int64 from s (B, Pb) int32.  scratch is null when
// Pb <= resample_rank_setup() (the counters live on chip), else it holds
// B (Pb + 1) ints of global memory.
int resample_rank_launch(const void* s, void* idx, void* scratch, int B, int Pb,
                         void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const size_t smem = rank_smem_bytes(Pb, scratch == nullptr);
  resample_rank_kernel<<<B, RANK_NT, smem, stream>>>(
      (const int*)s, (long long*)idx, (int*)scratch, Pb);
  return (int)cudaGetLastError();
}

}  // extern "C"
