// Fused exact-GP posterior kernels for Hopper (sm_90a), in plain fp32.
//
// Replaces the Pallas TPU kernels of gpmdm_tpu/ops/pallas/gp_posterior.py:
//
//   gp_posterior_kernel<HAS_LINEAR=true>   replaces _fused_posterior/_kernel
//       (has_linear=True) behind fused_x_posterior: the per-class dynamics
//       posterior of the particle filter (RBF + homogeneous linear star
//       kernel, rows >= n_valid masked to exactly 0).
//   gp_posterior_kernel<HAS_LINEAR=false>  replaces the same body with
//       has_linear=False behind fused_rbf_posterior (RBF star kernel).
//   obs_loglik_kernel                      replaces _obs_loglik_kernel behind
//       fused_obs_loglik: RBF star kernel -> mean (never leaves the chip)
//       -> qres = sum_j lam2_j (mean_j - z_j)^2 and the variance quad.
//       Bank-aware: with B banks of Pb = P / B particles, particle p is
//       weighed against its own bank's row z[p / Pb] (what the JAX
//       package's jax.vmap of fused_obs_loglik computes); a block's
//       particle tile may straddle two banks, so the row is chosen per
//       particle, never per block.
//
// Each block owns TP particles and computes, with N training rows,
//   Kstar[i, p] = exp(-sum_k (xt_ik - xs_pk)^2) [+ sum_k lt_ik ls_pk + bias]
//   mean[p, :]  = sum_i Kstar[i, p] A[i, :]
//   quad[p]     = sum_i Kstar[i, p] * (sum_m Kinv[i, m] Kstar[m, p])
// where xt/xs are the inputs scaled by the inverse lengthscales and lt/ls
// by the linear-kernel weights (both scalings done here, one fp32 multiply
// each, as the JAX wrapper does before its kernel).
//
// What bounds it on the H100: the quad is 2 N^2 P flops against N^2 + small
// bytes of input, so the work is compute-bound (N=480, P=10k: 4.6 GFLOP,
// 1.2 MB) at the fp32 rate outside the tensor cores.  No tensor cores: fp32
// inputs there run TF32, whose 10-bit mantissa wrecks the catastrophic
// cancellation in var = kdiag - quad.  Squared distances are summed per
// dimension, never by the |a|^2 + |b|^2 - 2ab expansion, for the same reason.
//
// Design.  The TPU grid walks Kinv row tiles in order and carries quad in
// scratch; here blocks run in no order, so each block keeps its whole
// (N, TP) Kstar tile in dynamic shared memory (the opt-in above 48 KB) and
// loops over Kinv inside itself.  The quad is a GEMM, G = Kinv^T Kstar,
// reduced on the fly against Kstar: k^T Kinv k = k^T Kinv^T k exactly, so
// the block streams Kinv by rows into shared memory in (MB x RC) tiles
// (contiguous in device memory, eight loads in flight per thread) and each
// thread accumulates an 8 x 8 register tile of G (8 particles x 8 rows):
// 64 fp32 FMAs per four float4 shared-memory loads, which balances the
// SM's shared-memory bandwidth (128 B/cycle) against its FMA rate.  A
// block covers 256 rows of G per pass and 64 particles when N <= 256, or
// 512 rows and 32 particles otherwise, so a pass wastes little on padding
// and two blocks fit per SM at the bench shapes (K1 N=236, K2 N=480), one
// block's tile loads overlapping the other's FMAs.  The ragged last
// particle tile computes on zero inputs and stores nothing.
//
// Each launcher returns cudaGetLastError() so the caller can raise, or
// SMEM_TOO_LARGE (-1) for a shape whose star tile does not fit on chip.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;         // threads per block
constexpr int PP = 8;           // particles per thread in the quad
constexpr int CC = 8;           // G rows per thread in the quad
constexpr int MB = 16;          // Kinv rows per staged tile
constexpr int LB = 8;           // staging loads in flight per thread

// The quad's block tile: RC rows of G per pass over Kinv, TP particles.
// PP x CC per thread over NT threads fixes TP * RC = NT * PP * CC.
template <int RC>
struct Tile {
  static constexpr int CG = RC / CC;      // row groups
  static constexpr int PG = NT / CG;      // particle groups
  static constexpr int TP = PG * PP;      // particles per block
  static constexpr int KST = RC + 4;      // staged tile row stride (float4-aligned)
  static_assert(CG * PG == NT, "the quad's thread tiling must cover the block");
  static_assert((MB * RC) % (NT * LB) == 0, "staging batches must tile the tile");
};

// One pass covers N <= 256 with little padding; larger N take 512-row passes.
__host__ __device__ inline int rows_per_pass(int N) { return N <= 256 ? 256 : 512; }

__host__ __device__ inline int tile_p(int N) {
  return rows_per_pass(N) == 256 ? Tile<256>::TP : Tile<512>::TP;
}

// Dynamic shared-memory floats of one block.
__host__ __device__ inline size_t smem_floats(int N, int d, int Dout,
                                              bool has_linear, bool obs) {
  const int RC = rows_per_pass(N), TP = tile_p(N);
  size_t f = (size_t)N * TP          // Kstar tile
           + (size_t)MB * (RC + 4)   // staged Kinv tile
           + (size_t)(RC / CC) * TP  // quad partial sums
           + (size_t)N * d           // scaled training inputs
           + (size_t)TP * d;         // scaled particles
  if (has_linear) f += (size_t)N * d + (size_t)TP * d;
  if (obs) f += (size_t)TP * Dout;   // posterior mean tile
  return f;
}

// Stages the scaled inputs and builds the (N, TP) star-kernel tile.
template <int TP, bool HAS_LINEAR>
__device__ void build_kstar(float* ks, float* xt_s, float* xs_s, float* lt_s,
                            float* ls_s, const float* __restrict__ xt,
                            const float* __restrict__ xs,
                            const float* __restrict__ inv_ls,
                            const float* __restrict__ lin_w, int N, int P,
                            int d, int n_valid, int p0) {
  const int tid = threadIdx.x;
  for (int e = tid; e < N * d; e += NT) {
    const int k = e % d;
    const float x = xt[e];
    xt_s[e] = x * inv_ls[k];
    if (HAS_LINEAR) lt_s[e] = x * lin_w[k];
  }
  for (int e = tid; e < TP * d; e += NT) {
    const int p = e / d, k = e % d;
    const float x = (p0 + p < P) ? xs[(size_t)(p0 + p) * d + k] : 0.f;
    xs_s[e] = x * inv_ls[k];
    if (HAS_LINEAR) ls_s[e] = x * lin_w[k];
  }
  __syncthreads();
  float bias = 0.f;
  if (HAS_LINEAR) bias = lin_w[d] * lin_w[d];
  for (int e = tid; e < N * TP; e += NT) {
    const int i = e / TP, p = e % TP;
    float v = 0.f;
    if (i < n_valid) {
      float sq = 0.f;
      for (int k = 0; k < d; ++k) {
        const float diff = xt_s[i * d + k] - xs_s[p * d + k];
        sq += diff * diff;
      }
      v = expf(-sq);
      if (HAS_LINEAR) {
        float lin = 0.f;
        for (int k = 0; k < d; ++k) lin += lt_s[i * d + k] * ls_s[p * d + k];
        v = v + lin + bias;
      }
    }
    ks[e] = v;
  }
  __syncthreads();
}

// mean[p, j] = sum_i Kstar[i, p] A[i, j] into out[p * Dout + j].  Thread
// (p, jg) owns one particle and mj <= MJ consecutive outputs, so each
// Kstar load feeds mj independent FMA chains (one output per thread left
// the loop bound by its single chain); mj shrinks for small Dout so that
// the outputs spread over all NT / TP thread groups.  Rows with
// p0 + p >= P are skipped unless P < 0 (the on-chip mean tile, which
// takes every row).
template <int TP>
__device__ void block_mean(const float* ks, const float* __restrict__ A,
                           float* out, int N, int Dout, int P, int p0) {
  constexpr int MJ = 5, NG = NT / TP;
  const int mj = min(MJ, (Dout + NG - 1) / NG);
  const int p = threadIdx.x % TP, jg = threadIdx.x / TP;
  for (int jb = 0; jb < Dout; jb += mj * NG) {
    const int j0 = jb + jg * mj;
    float acc[MJ];
#pragma unroll
    for (int q = 0; q < MJ; ++q) acc[q] = 0.f;
#pragma unroll 4
    for (int i = 0; i < N; ++i) {
      const float kv = ks[i * TP + p];
#pragma unroll
      for (int q = 0; q < MJ; ++q)
        if (q < mj && j0 + q < Dout) acc[q] = fmaf(kv, A[(size_t)i * Dout + j0 + q], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < MJ; ++q)
      if (q < mj && j0 + q < Dout && (P < 0 || p0 + p < P))
        out[(size_t)p * Dout + j0 + q] = acc[q];
  }
}

// quad[p] for this block's particles; the full sum lands in thread p < TP.
template <int RC>
__device__ float block_quad(const float* ks, float* kit, float* red,
                            const float* __restrict__ kinv, int N) {
  using T = Tile<RC>;
  constexpr int TP = T::TP, KST = T::KST;
  const int tid = threadIdx.x;
  const int pg = tid % T::PG, cg = tid / T::PG;
  float acc[PP];
#pragma unroll
  for (int a = 0; a < PP; ++a) acc[a] = 0.f;
  for (int c0 = 0; c0 < N; c0 += RC) {
    float s[PP][CC];
#pragma unroll
    for (int a = 0; a < PP; ++a)
#pragma unroll
      for (int b = 0; b < CC; ++b) s[a][b] = 0.f;
    for (int m0 = 0; m0 < N; m0 += MB) {
      __syncthreads();
      // kit[mm][r] = Kinv[m0 + mm][c0 + r]: G[c0 + r] = sum_m Kinv[m][c0 + r] k_m
      for (int e0 = tid; e0 < MB * RC; e0 += NT * LB) {
        float v[LB];
#pragma unroll
        for (int b = 0; b < LB; ++b) {
          const int e = e0 + b * NT, mm = e / RC, r = e % RC;
          v[b] = (m0 + mm < N && c0 + r < N) ? kinv[(size_t)(m0 + mm) * N + c0 + r] : 0.f;
        }
#pragma unroll
        for (int b = 0; b < LB; ++b) {
          const int e = e0 + b * NT;
          kit[(e / RC) * KST + e % RC] = v[b];
        }
      }
      __syncthreads();
      const int mb = min(MB, N - m0);
#pragma unroll 2
      for (int mm = 0; mm < mb; ++mm) {
        const float4* kp = reinterpret_cast<const float4*>(ks + (m0 + mm) * TP + pg * PP);
        const float4* cp = reinterpret_cast<const float4*>(kit + mm * KST + cg * CC);
        const float4 k0 = kp[0], k1 = kp[1], c0v = cp[0], c1v = cp[1];
        const float kv[PP] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
        const float cv[CC] = {c0v.x, c0v.y, c0v.z, c0v.w, c1v.x, c1v.y, c1v.z, c1v.w};
#pragma unroll
        for (int a = 0; a < PP; ++a)
#pragma unroll
          for (int b = 0; b < CC; ++b) s[a][b] = fmaf(kv[a], cv[b], s[a][b]);
      }
    }
#pragma unroll
    for (int b = 0; b < CC; ++b) {
      const int i = c0 + cg * CC + b;
      if (i < N) {
        const float4* kp = reinterpret_cast<const float4*>(ks + i * TP + pg * PP);
        const float4 k0 = kp[0], k1 = kp[1];
        const float kv[PP] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
        for (int a = 0; a < PP; ++a) acc[a] = fmaf(kv[a], s[a][b], acc[a]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < PP; ++a) red[cg * TP + pg * PP + a] = acc[a];
  __syncthreads();
  float total = 0.f;
  if (tid < TP) {
    for (int g = 0; g < T::CG; ++g) total += red[g * TP + tid];
  }
  return total;
}

template <int RC, bool HAS_LINEAR>
__global__ void __launch_bounds__(NT, 2)
gp_posterior_kernel(const float* __restrict__ xt, const float* __restrict__ xs,
                    const float* __restrict__ inv_ls,
                    const float* __restrict__ lin_w,
                    const float* __restrict__ A, const float* __restrict__ kinv,
                    float* __restrict__ mean, float* __restrict__ quad, int N,
                    int P, int d, int Dout, int n_valid) {
  using T = Tile<RC>;
  constexpr int TP = T::TP;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* kit = ks + (size_t)N * TP;
  float* red = kit + (size_t)MB * T::KST;
  float* xt_s = red + (size_t)T::CG * TP;
  float* xs_s = xt_s + (size_t)N * d;
  float* lt_s = xs_s + (size_t)TP * d;
  float* ls_s = lt_s + (size_t)N * d;
  const int p0 = blockIdx.x * TP;
  build_kstar<TP, HAS_LINEAR>(ks, xt_s, xs_s, lt_s, ls_s, xt, xs, inv_ls, lin_w,
                              N, P, d, n_valid, p0);
  block_mean<TP>(ks, A, mean + (size_t)p0 * Dout, N, Dout, P, p0);
  const float q = block_quad<RC>(ks, kit, red, kinv, N);
  if (threadIdx.x < TP && p0 + threadIdx.x < P) quad[p0 + threadIdx.x] = q;
}

template <int RC>
__global__ void __launch_bounds__(NT, 2)
obs_loglik_kernel(const float* __restrict__ xt, const float* __restrict__ xs,
                  const float* __restrict__ inv_ls, const float* __restrict__ A,
                  const float* __restrict__ kinv, const float* __restrict__ z,
                  const float* __restrict__ lam2, float* __restrict__ quad,
                  float* __restrict__ qres, int N, int P, int d, int D, int Pb) {
  using T = Tile<RC>;
  constexpr int TP = T::TP;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* kit = ks + (size_t)N * TP;
  float* red = kit + (size_t)MB * T::KST;
  float* xt_s = red + (size_t)T::CG * TP;
  float* xs_s = xt_s + (size_t)N * d;
  float* mean_s = xs_s + (size_t)TP * d;
  const int p0 = blockIdx.x * TP;
  build_kstar<TP, false>(ks, xt_s, xs_s, nullptr, nullptr, xt, xs, inv_ls,
                         nullptr, N, P, d, N, p0);
  block_mean<TP>(ks, A, mean_s, N, D, -1, p0);
  const float q = block_quad<RC>(ks, kit, red, kinv, N);  // syncs after the mean
  const int p = threadIdx.x;
  if (p < TP && p0 + p < P) {
    const float* zb = z + (size_t)((p0 + p) / Pb) * D;  // this particle's bank
    float r = 0.f;
    for (int j = 0; j < D; ++j) {
      const float diff = mean_s[p * D + j] - zb[j];
      r += lam2[j] * diff * diff;
    }
    quad[p0 + p] = q;
    qres[p0 + p] = r;
  }
}

// What a launcher returns when one block's star tile and staging need more
// shared memory than the card lets a block opt into; the Python wrapper
// turns it into a ValueError that names the bytes needed.
constexpr int SMEM_TOO_LARGE = -1;

// 0 when a block of the current device may take smem bytes of dynamic
// shared memory, else SMEM_TOO_LARGE or the CUDA error of the query.
int check_smem(size_t smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  return smem > (size_t)optin ? SMEM_TOO_LARGE : 0;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  const int fits = check_smem(smem);
  if (fits != 0) return fits;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int RC>
int launch_posterior(const float* xt, const float* xs, const float* inv_ls,
                     const float* lin_w, const float* A, const float* kinv,
                     float* mean, float* quad, int N, int P, int d, int Dout,
                     int n_valid, bool has_linear, size_t smem, cudaStream_t stream) {
  const dim3 grid((P + Tile<RC>::TP - 1) / Tile<RC>::TP);
  auto kernel = has_linear ? gp_posterior_kernel<RC, true> : gp_posterior_kernel<RC, false>;
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, NT, smem, stream>>>(xt, xs, inv_ls, lin_w, A, kinv, mean, quad,
                                     N, P, d, Dout, n_valid);
  return (int)cudaGetLastError();
}

template <int RC>
int launch_obs(const float* xt, const float* xs, const float* inv_ls,
               const float* A, const float* kinv, const float* z,
               const float* lam2, float* quad, float* qres, int N, int P, int d,
               int D, int Pb, size_t smem, cudaStream_t stream) {
  const dim3 grid((P + Tile<RC>::TP - 1) / Tile<RC>::TP);
  const int err = allow_smem(obs_loglik_kernel<RC>, smem);
  if (err != 0) return err;
  obs_loglik_kernel<RC><<<grid, NT, smem, stream>>>(xt, xs, inv_ls, A, kinv, z,
                                                    lam2, quad, qres, N, P, d, D, Pb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the given shape needs.
size_t gp_smem_bytes(int N, int d, int Dout, int has_linear, int obs) {
  return smem_floats(N, d, Dout, has_linear != 0, obs != 0) * sizeof(float);
}

int gp_posterior_launch(const void* xt, const void* xs, const void* inv_ls,
                        const void* lin_w, const void* A, const void* kinv,
                        void* mean, void* quad, int N, int P, int d, int Dout,
                        int n_valid, int has_linear, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const size_t smem = gp_smem_bytes(N, d, Dout, has_linear, 0);
  auto go = rows_per_pass(N) == 256 ? launch_posterior<256> : launch_posterior<512>;
  return go((const float*)xt, (const float*)xs, (const float*)inv_ls,
            (const float*)lin_w, (const float*)A, (const float*)kinv, (float*)mean,
            (float*)quad, N, P, d, Dout, n_valid, has_linear != 0, smem, stream);
}

int obs_loglik_launch(const void* xt, const void* xs, const void* inv_ls,
                      const void* A, const void* kinv, const void* z,
                      const void* lam2, void* quad, void* qres, int N, int P,
                      int d, int D, int Pb, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const size_t smem = gp_smem_bytes(N, d, D, 0, 1);
  auto go = rows_per_pass(N) == 256 ? launch_obs<256> : launch_obs<512>;
  return go((const float*)xt, (const float*)xs, (const float*)inv_ls,
            (const float*)A, (const float*)kinv, (const float*)z, (const float*)lam2,
            (float*)quad, (float*)qres, N, P, d, D, Pb, smem, stream);
}

}  // extern "C"
