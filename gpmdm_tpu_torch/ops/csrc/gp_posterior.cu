// Fused exact-GP posterior kernels for Hopper (sm_90a), in plain fp32.
//
// Replaces the Pallas TPU kernels of gpmdm_tpu/ops/pallas/gp_posterior.py
// on two designs:
//
//   KIND_X   replaces _fused_posterior/_kernel (has_linear=True) behind
//            fused_x_posterior: the per-class dynamics posterior of the
//            particle filter (RBF + homogeneous linear star kernel, rows
//            >= n_valid masked to exactly 0), every class in one launch
//            (a grid axis over the C stacked class blocks).  While
//            N + Dout <= 256 it runs x_onepass<NTH>; past that the
//            streamed core.
//   KIND_RBF replaces the same body with has_linear=False behind
//            fused_rbf_posterior (RBF star kernel), on the streamed core.
//   KIND_OBS replaces _obs_loglik_kernel behind fused_obs_loglik: the
//            variance quad and qres = sum_j lam2_j (mean_j - z_j)^2, with
//            the mean never leaving the chip, on the streamed core.
//            Bank-aware: with B banks of Pb = P / B particles, particle p
//            is weighed against its own bank's row z[p / Pb], chosen per
//            particle (a block's particle tile may straddle two banks).
//
// With N training rows, Dout outputs and the inputs scaled by the inverse
// lengthscales (lt/ls by the linear weights), each block owns TP particles:
//   Kstar[m, p] = exp(-sum_k (xt_mk - xs_pk)^2) [+ sum_k lt_mk ls_pk + bias]
//   G = M^T Kstar,  M = [Kinv | A]  (N x (N + Dout), rows m contiguous)
//   quad[p]    = sum_{c < N} Kstar[c, p] G[c, p]    (k^T Kinv^T k = k^T Kinv k)
//   mean[p, j] = G[N + j, p]
// so the mean is Dout more columns of the same product, not a second loop.
//
// What bounds it on the H100: 2 N (N + Dout) P flops against N^2 + small
// bytes, so the fp32 rate outside the tensor cores (N = 480, P = 120,000:
// 60 GFLOP, 0.89 ms at 67 TFLOP/s).  No tensor cores: fp32 there runs as
// TF32, whose 10-bit mantissa wrecks the cancellation in var = kdiag - quad.
// Squared distances are summed per dimension, never by the norm expansion,
// for the same reason.
//
// Both designs give each thread an 8 x 8 register tile of G (8 particles x
// 8 columns, in two halves so that a quarter warp reads neighbouring
// float4: no bank conflicts), 64 FMAs per four float4 shared-memory loads,
// and stream M by MB-row tiles through a ring in shared memory filled with
// cp.async.  Per-particle sums meet in shared memory and are added in a
// fixed order, so results do not depend on timing.
//
// x_onepass (K1 while N + Dout <= 256: every shipped asset's dynamics
// block, 238 columns at the headline).  A block owns TP = 64 or 128
// particles and ALL N + Dout columns (256, or 128 when they fit), so it
// makes one pass: it generates its whole (N x TP) star tile once into
// shared memory while the first tiles of M are already in flight; then
// each group of warps (one warp per 64 particles) streams its own 32
// columns of M through its own two-stage ring of MB-row tiles and waits
// only for itself; the quad is folded from the same resident star tile.
// 64-particle blocks run two an SM; 128-particle blocks read M from L2
// half as often per particle and run one an SM (the large grids).  A grid
// axis over the classes.
//
// posterior_core (K1 past 256 columns, K1', K2).  Kstar is never stored
// whole, so a block's shared memory does not depend on N.  A block walks
// the columns of G in passes of RC; in each pass it streams M through a
// two-stage ring and generates the matching (MB x TP) Kstar tile from the
// raw training rows, staged two tiles ahead, and the d scaled inputs of
// each particle, kept in registers for d <= DMAX.  A warp whose columns all
// lie past N + Dout skips its FMAs.  The epilogue regenerates Kstar[c, p]
// for the thread's own columns (N x TP exps a pass, against 2 N RC TP
// FMAs) and folds G into quad, the mean or qres.  TP is 64 (RC 256) or 128
// (RC 128): 128 halves the M tiles re-read from L2 per particle, 64 halves
// the regenerations.  When the particle tiles alone cannot fill the card
// (P = 10,000), the passes are dealt over several blocks a tile and the
// last block of a tile to finish adds their sums in a fixed order
// (gp_plan); it also sets the tile's ticket back to 0, so one zeroed
// ticket array serves every launch.  The ragged last particle tile
// computes on zero inputs and stores nothing.
//
// Measured (PERF.md): the streamed core reaches about a third of the fp32
// bound on the banks; the Kstar regeneration and the staging the FMAs do
// not hide cost about as much as the FMA loop.
//
// Each launcher returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// Compile-time flags for measurement variants (ops/_build.py defines=):
//   GP_SKIP_GEN    Kstar tiles are not generated (timing only: wrong results);
//   GP_SKIP_FMA    the FMA loop does not run (timing only: wrong results);
//   GP_SKIP_STAGE  the tiles of M are not loaded (timing only: wrong results).
constexpr int NT = 256;  // threads per block of the streamed core
constexpr int PP = 8;    // particles per thread
constexpr int CC = 8;    // columns of G per thread, a multiple of 4
constexpr int MB = 16;   // rows of M (and of Kstar) per ring stage
constexpr int RING = 2;  // stages of an x_onepass group's ring of M (3 or 4: no
                         // faster on the banks, slower where fewer blocks fit an SM)
constexpr int DMAX = 4;  // latent widths whose star kernel runs from registers
constexpr int ONEPASS_COLS = 256;  // the most columns N + Dout of x_onepass

constexpr int KIND_RBF = 0, KIND_X = 1, KIND_OBS = 2;

// The block tile: TP particles x RC columns of G, as a TX x TY grid of
// threads, each holding PP x CC outputs in two halves: particles
// tx*4 .. tx*4+3 and TP/2 + tx*4 .., columns ty*4 .. ty*4+3 and RC/2 + ty*4
// ..  So the eight lanes of a quarter warp read eight neighbouring float4 of
// the Kstar tile and one (broadcast) float4 of the M tile: no bank
// conflicts.  A warp is LX x LY threads.
template <int TP, int NTH = NT>
struct Tile {
  static constexpr int TX = TP / PP;         // threads along the particles
  static constexpr int TY = NTH / TX;        // threads along the columns
  static constexpr int RC = TY * CC;         // columns per pass
  static constexpr int LX = TX < 8 ? TX : 8;  // a warp's lanes along the particles
  static constexpr int LY = 32 / LX;
  static constexpr int WX = TX / LX;         // warps along the particles
  static constexpr int STAGE = MB * RC;      // floats of one staged M tile
  static constexpr int KT = MB * TP;         // floats of one Kstar tile
  static_assert(TX * TY == NTH && LX * LY == 32, "the thread grid covers the block");
  static_assert((MB * RC / 4) % NTH == 0, "staging covers the tile evenly");
  static_assert(NTH % TP == 0 && MB % (NTH / TP) == 0, "a thread generates one particle");
};

// Asynchronous global -> shared copies: cp.async on the card, a plain copy
// elsewhere.  copy_async4 writes 0 when !valid (src is then not read).
__device__ inline void copy_async4(float* dst, const float* src, bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa), "l"(src),
               "r"(valid ? 4 : 0));
#else
  *dst = valid ? *src : 0.f;
#endif
}

// 16 bytes; dst and src 16-byte aligned.
__device__ inline void copy_async16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(src));
#else
  for (int u = 0; u < 4; ++u) dst[u] = src[u];
#endif
}

// Closes this thread's batch of copies, then waits for all of them.
__device__ inline void copy_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
#endif
}

// Closes this thread's batch of copies as one group.
__device__ inline void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most n of this thread's groups are still in flight.
template <int n>
__device__ inline void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
#endif
}

// Barrier of group g's WX warps: the warp itself, or named barrier 1 + g
// (0 is __syncthreads'); off the card the emulation's stand-in.
template <int WX>
__device__ inline void group_sync(int g) {
  if (WX == 1) {
    __syncwarp();
  } else {
#if defined(__CUDA_ARCH__)
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(32 * WX) : "memory");
#else
    __named_barrier_sync(1 + g, 32 * WX);
#endif
  }
}

template <int TP, int KIND>
__global__ void __launch_bounds__(NT, 2)
posterior_core(const float* __restrict__ xt, const float* __restrict__ xs,
               const float* __restrict__ inv_ls, const float* __restrict__ lin_w,
               const float* __restrict__ A, const float* __restrict__ kinv,
               const float* __restrict__ z, const float* __restrict__ lam2,
               float* __restrict__ out0, float* __restrict__ out1, int N, int P, int d,
               int Dout, int n_valid, int Pb, int splits, float* __restrict__ partial,
               int* __restrict__ ticket) {
  using T = Tile<TP>;
  constexpr bool LIN = KIND == KIND_X, OBS = KIND == KIND_OBS;
  // the class block of this launch's class axis (K1; 0 for K1' and K2)
  const int cls = blockIdx.z;
  xt += (size_t)cls * N * d;
  A += (size_t)cls * N * Dout;
  kinv += (size_t)cls * N * N;
  out0 += (size_t)cls * P * Dout;
  out1 += (size_t)cls * P;
  extern __shared__ __align__(16) float smem[];
  float* mt = smem;                 // ring of two M tiles, MB x RC each
  float* kt = mt + 2 * T::STAGE;    // ring of two Kstar tiles, MB x TP each
  float* red = kt + 2 * T::KT;      // per-particle sums by thread row, (1 | 2) x TY x TP
  float* xr = red + (OBS ? 2 : 1) * T::TY * TP;  // ring of three raw row tiles, MB x d
  float* il_s = xr + 3 * MB * d;    // inverse lengthscales, d
  float* lw_s = il_s + d;           // linear weights, d
  float* xs_s = lw_s + d;           // scaled particles, d x TP
  float* ls_s = xs_s + d * TP;      // linear-scaled particles, d x TP (K1 only)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = (warp % T::WX) * T::LX + lane % T::LX;
  const int ty = (warp / T::WX) * T::LY + lane / T::LX;
  const int col0 = (warp / T::WX) * T::LY * 4;  // the warp's first column in a pass
  const int p0 = blockIdx.x * TP;
  const int Ncol = N + Dout;
  const bool vec = N % 4 == 0 && ((uintptr_t)kinv & 15) == 0;  // Kinv rows 16-byte aligned
  const float bias = LIN ? lin_w[d] * lin_w[d] : 0.f;

  for (int e = tid; e < d * TP; e += NT) {
    const int k = e / TP, p = e % TP;
    const float x = p0 + p < P ? xs[(size_t)(p0 + p) * d + k] : 0.f;
    xs_s[e] = x * inv_ls[k];
    if (LIN) ls_s[e] = x * lin_w[k];
  }
  for (int k = tid; k < d; k += NT) {
    il_s[k] = inv_ls[k];
    if (LIN) lw_s[k] = lin_w[k];
  }
  for (int e = tid; e < (OBS ? 2 : 1) * T::TY * TP; e += NT) red[e] = 0.f;
  __syncthreads();

  // Kstar[m, p] of this block's particle p from training row x (d floats);
  // 0 for masked rows.
  auto finish = [&](float sq, float lin) {
    const float v = expf(-sq);
    return LIN ? v + lin + bias : v;
  };
  auto star = [&](int m, const float* x, int p) {
    if (m >= n_valid) return 0.f;
    float sq = 0.f, lin = 0.f;
    for (int k = 0; k < d; ++k) {
      const float diff = x[k] * il_s[k] - xs_s[k * TP + p];
      sq += diff * diff;
      if (LIN) lin += (x[k] * lw_s[k]) * ls_s[k * TP + p];
    }
    return finish(sq, lin);
  };
  // The Kstar tiles are generated by thread tid for particle tid % TP
  // only, so for d <= DMAX that particle's inputs and the weights stay in
  // registers and each element costs one shared-memory load per dimension.
  const int gp = tid % TP;
  float gx[DMAX], gl[DMAX], gi[DMAX], gw[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    const bool in = k < d;
    gx[k] = in ? xs_s[k * TP + gp] : 0.f;
    gl[k] = in && LIN ? ls_s[k * TP + gp] : 0.f;
    gi[k] = in ? il_s[k] : 0.f;
    gw[k] = in && LIN ? lw_s[k] : 0.f;
  }
  // the output index of the thread's a-th particle / b-th column
  auto part = [&](int a) { return (a < 4 ? 0 : TP / 2 - 4) + tx * 4 + a; };
  auto column = [&](int b) { return (b / 4) * 4 * T::TY + ty * 4 + b % 4; };

  const int steps = (N + MB - 1) / MB;
  // this block's passes: blockIdx.y, + splits, ..
  for (int c0 = blockIdx.y * T::RC; c0 < Ncol; c0 += splits * T::RC) {
    const bool active = c0 + col0 < Ncol;

    // rows m0 .. m0+MB of M's columns c0 .. c0+RC into a ring stage
    auto stage_m = [&](int m0, float* dst) {
      constexpr int Q = T::RC / 4;
      for (int e = tid; e < MB * Q; e += NT) {
        const int mm = e / Q, r = 4 * (e % Q);
        const int m = m0 + mm, c = c0 + r;
        float* to = dst + mm * T::RC + r;
        if (vec && m < N && c < N) {
          copy_async16(to, kinv + (size_t)m * N + c);
        } else if (c < Ncol) {
          for (int u = 0; u < 4; ++u) {
            const int cu = c + u;
            const bool ok = m < N && cu < Ncol;
            const float* src = !ok ? kinv
                               : cu < N ? kinv + (size_t)m * N + cu
                                        : A + (size_t)m * Dout + (cu - N);
            copy_async4(to + u, src, ok);
          }
        }
      }
    };
    // the raw training rows m0 .. m0+MB
    auto stage_x = [&](int m0, float* dst) {
      for (int e = tid; e < MB * d; e += NT) {
        const bool ok = m0 * d + e < N * d;
        copy_async4(dst + e, ok ? xt + (size_t)m0 * d + e : xt, ok);
      }
    };
    // the Kstar tile of rows m0 .. m0+MB from their staged raw rows
    // this thread's share of the Kstar tile of rows m0 .. m0+MB, from
    // their staged raw rows x: rows tid / TP, + NT / TP, ..
    auto gen = [&](int m0, const float* x, float* dst) {
      for (int mm = tid / TP; mm < MB; mm += NT / TP) {
        const float* xm = x + mm * d;
        float v = 0.f;
        if (d > DMAX) {
          v = star(m0 + mm, xm, gp);
        } else if (m0 + mm < n_valid) {
          float sq = 0.f, lin = 0.f;
#pragma unroll
          for (int k = 0; k < DMAX; ++k) {
            if (k < d) {
              const float diff = xm[k] * gi[k] - gx[k];
              sq += diff * diff;
              if (LIN) lin += (xm[k] * gw[k]) * gl[k];
            }
          }
          v = finish(sq, lin);
        }
        dst[mm * TP + gp] = v;
      }
    };

    float s[PP][CC];
#pragma unroll
    for (int a = 0; a < PP; ++a)
#pragma unroll
      for (int b = 0; b < CC; ++b) s[a][b] = 0.f;

    // the rings run ahead: M and Kstar one tile, the raw rows two tiles
    stage_x(0, xr);
    if (steps > 1) stage_x(MB, xr + MB * d);
    stage_m(0, mt);
    copy_wait_all();
    __syncthreads();
    gen(0, xr, kt);
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const int cur = t & 1;
      if (t + 1 < steps) {
#ifndef GP_SKIP_STAGE
        stage_m((t + 1) * MB, mt + (cur ^ 1) * T::STAGE);
#endif
#ifndef GP_SKIP_GEN
        gen((t + 1) * MB, xr + ((t + 1) % 3) * MB * d, kt + (cur ^ 1) * T::KT);
#endif
      }
      if (t + 2 < steps) stage_x((t + 2) * MB, xr + ((t + 2) % 3) * MB * d);
#ifdef GP_SKIP_FMA
      if (false) {
#else
      if (active) {
#endif
        const float* mb = mt + cur * T::STAGE + ty * 4;
        const float* kb = kt + cur * T::KT + tx * 4;
#pragma unroll 4
        for (int mm = 0; mm < MB; ++mm) {
          const float4 k0 = *reinterpret_cast<const float4*>(kb + mm * TP);
          const float4 k1 = *reinterpret_cast<const float4*>(kb + mm * TP + TP / 2);
          const float kv[PP] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
          float cv[CC];
#pragma unroll
          for (int q = 0; q < CC / 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(mb + mm * T::RC + q * 4 * T::TY);
            cv[4 * q] = v.x;
            cv[4 * q + 1] = v.y;
            cv[4 * q + 2] = v.z;
            cv[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int a = 0; a < PP; ++a)
#pragma unroll
            for (int b = 0; b < CC; ++b) s[a][b] = fmaf(kv[a], cv[b], s[a][b]);
        }
      }
      copy_wait_all();
      __syncthreads();
    }

    // epilogue: fold this pass's columns of G into quad, the mean or qres;
    // each thread adds into its own entries of red
    if (active) {
      float qacc[PP], racc[PP];
#pragma unroll
      for (int a = 0; a < PP; ++a) qacc[a] = racc[a] = 0.f;
#pragma unroll
      for (int b = 0; b < CC; ++b) {
        const int c = c0 + column(b);
        if (c < N) {
#pragma unroll
          for (int a = 0; a < PP; ++a)
            qacc[a] = fmaf(star(c, xt + (size_t)c * d, part(a)), s[a][b], qacc[a]);
        } else if (c < Ncol) {
          const int j = c - N;
#pragma unroll
          for (int a = 0; a < PP; ++a) {
            const int p = p0 + part(a);
            if (OBS) {
              const float diff = s[a][b] - z[(size_t)(min(p, P - 1) / Pb) * Dout + j];
              racc[a] += lam2[j] * diff * diff;
            } else if (p < P) {
              out0[(size_t)p * Dout + j] = s[a][b];
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < PP; ++a) {
        red[ty * TP + part(a)] += qacc[a];
        if (OBS) red[(T::TY + ty) * TP + part(a)] += racc[a];
      }
    }
  }

  // per-particle sums over the TY thread rows
  __syncthreads();
  float q = 0.f, r = 0.f;
  if (tid < TP) {
    for (int g = 0; g < T::TY; ++g) {
      q += red[g * TP + tid];
      if (OBS) r += red[(T::TY + g) * TP + tid];
    }
  }
  const int p = p0 + tid;
  if (splits > 1) {
    // The passes are split over blocks: each writes its sums, and the last
    // block of the particle tile to finish adds them in split order.
    __shared__ int last;
    partial += (size_t)cls * 2 * splits * P;
    ticket += (size_t)cls * gridDim.x;
    if (tid < TP && p < P) {
      partial[(size_t)(2 * blockIdx.y) * P + p] = q;
      partial[(size_t)(2 * blockIdx.y + 1) * P + p] = r;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(ticket + blockIdx.x, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (tid == 0) ticket[blockIdx.x] = 0;  // ready for the next launch
    q = r = 0.f;
    if (tid < TP && p < P) {
      for (int y = 0; y < splits; ++y) {
        q += __ldcg(partial + (size_t)(2 * y) * P + p);
        r += __ldcg(partial + (size_t)(2 * y + 1) * P + p);
      }
    }
  }
  if (tid < TP && p < P) {
    if (OBS) {
      out0[p] = q;
      out1[p] = r;
    } else {
      out1[p] = q;
    }
  }
}

// K1 in one pass, while N + Dout <= RC columns (RC = 64 NTH / TP): a block
// owns TP particles of class blockIdx.y and every column of G.  It scales
// the class's training rows once and generates its whole star tile
// (Npad = N rounded up to MB rows, x TP; rows past N and rows >= n_valid
// exactly 0) into shared memory once, before the FMA loop.  The warps form
// groups of WX = TP / 64 (one warp per 64 particles); a group owns two
// blocks of 16 columns, J0 = group and the mirrored J1 = RC / 16 - 1 -
// group, and streams its own 32 columns of M through its own ring of RING
// MB-row tiles: the loop synchronises only the group (the warp, or a pair
// of warps by a named barrier), so the groups of a block never wait for
// each other.  The epilogue folds the quad from the resident star tile;
// the rings then hold the per-particle sums by thread row (TY x TP).
template <int TP, int NTH>
__global__ void __launch_bounds__(NTH, 512 / NTH)
x_onepass(const float* __restrict__ xt, const float* __restrict__ xs,
          const float* __restrict__ inv_ls, const float* __restrict__ lin_w,
          const float* __restrict__ A, const float* __restrict__ kinv,
          float* __restrict__ mean, float* __restrict__ quad, int N, int P, int d, int Dout,
          int n_valid) {
  using T = Tile<TP, NTH>;
  static_assert(T::LX == 8 && T::LY == 4, "a warp holds 32 particles x 16 columns");
  constexpr int WX = T::WX, GS = 32 * WX;  // warps and threads of a group
  constexpr int W = 32, WSTAGE = MB * W;   // a group's columns; floats of its staged tile
  static_assert(T::TY * TP <= RING * MB * T::RC, "the rings hold the per-particle sums");
  const int cls = blockIdx.y;
  xt += (size_t)cls * N * d;
  A += (size_t)cls * N * Dout;
  kinv += (size_t)cls * N * N;
  mean += (size_t)cls * P * Dout;
  quad += (size_t)cls * P;
  extern __shared__ __align__(16) float smem[];
  const int steps = (N + MB - 1) / MB;
  float* ks = smem;                      // the star tile, steps * MB x TP
  float* ring = ks + steps * MB * TP;    // per group: RING tiles of its 32 columns of M
  float* xi = ring + RING * MB * T::RC;  // the training rows / lengthscales, N x d
  float* xl = xi + N * d;                // and times the linear weights, N x d
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = warp / WX, gt = (warp % WX) * 32 + lane;  // thread gt of its group
  const int tx = (warp % WX) * 8 + lane % 8, ty = group * 4 + lane / 8;
  const int J0 = group, J1 = T::RC / 16 - 1 - group;
  const int c0 = 16 * J0 + (lane / 8) * 4, c1 = 16 * J1 + (lane / 8) * 4;
  const int p0 = blockIdx.x * TP;
  const int Ncol = N + Dout;
  const bool vec = N % 4 == 0 && ((uintptr_t)kinv & 15) == 0;  // Kinv rows 16-byte aligned
  float* gring = ring + group * RING * WSTAGE;

  // Thread gt stages float4 q = e % 8 of row e / 8 for e = gt, gt + GS, ..:
  // q < 4 in block J0, else in J1 (0 past the ends).
  auto stage_m = [&](int t) {
    float* dst = gring + (t % RING) * WSTAGE;
#pragma unroll
    for (int i = 0; i < WSTAGE / 4 / GS; ++i) {
      const int e = gt + GS * i, mm = e / 8, q = e % 8;
      const int m = t * MB + mm, c = 16 * (q < 4 ? J0 : J1) + 4 * (q % 4);
      float* to = dst + mm * W + 4 * q;
      if (vec && m < N && c < N) {
        copy_async16(to, kinv + (size_t)m * N + c);
      } else {
        for (int u = 0; u < 4; ++u) {
          const int cu = c + u;
          const bool ok = m < N && cu < Ncol;
          const float* src = !ok ? kinv
                             : cu < N ? kinv + (size_t)m * N + cu
                                      : A + (size_t)m * Dout + (cu - N);
          copy_async4(to + u, src, ok);
        }
      }
    }
  };

  // the first RING - 1 tiles of M load while the star tile is generated
#pragma unroll
  for (int t = 0; t < RING - 1; ++t) {
#ifndef GP_SKIP_STAGE
    if (t < steps) stage_m(t);
#endif
    copy_commit();
  }
  // the training rows scaled once: xi = x / ls, xl = x * lin_w (exactly the
  // products the generation would form per element)
  for (int e = tid; e < N * d; e += NTH) {
    xi[e] = xt[e] * inv_ls[e % d];
    xl[e] = xt[e] * lin_w[e % d];
  }
  __syncthreads();

  {
    // Thread tid generates particle gp = tid % TP of rows tid / TP,
    // + NTH / TP, .., from the particle's scaled inputs in registers.
    const int gp = tid % TP;
    const float bias = lin_w[d] * lin_w[d];
    float gx[DMAX], gl[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      const float x = k < d && p0 + gp < P ? xs[(size_t)(p0 + gp) * d + k] : 0.f;
      gx[k] = k < d ? x * inv_ls[k] : 0.f;
      gl[k] = k < d ? x * lin_w[k] : 0.f;
    }
    for (int m = tid / TP; m < steps * MB; m += NTH / TP) {
      float v = 0.f;
#ifndef GP_SKIP_GEN
      if (m < n_valid) {
        const float *ri = xi + m * d, *rl = xl + m * d;
        float sq = 0.f, lin = 0.f;
        if (d <= DMAX) {
#pragma unroll
          for (int k = 0; k < DMAX; ++k) {
            if (k < d) {
              const float diff = ri[k] - gx[k];
              sq += diff * diff;
              lin += rl[k] * gl[k];
            }
          }
        } else {
          const int p = p0 + gp;
          for (int k = 0; k < d; ++k) {
            const float x = p < P ? xs[(size_t)p * d + k] : 0.f;
            const float diff = ri[k] - x * inv_ls[k];
            sq += diff * diff;
            lin += rl[k] * (x * lin_w[k]);
          }
        }
        v = expf(-sq) + lin + bias;
      }
#endif
      ks[m * TP + gp] = v;
    }
  }
  __syncthreads();  // the star tile is whole

  float s[PP][CC];
#pragma unroll
  for (int a = 0; a < PP; ++a)
#pragma unroll
    for (int b = 0; b < CC; ++b) s[a][b] = 0.f;

  for (int t = 0; t < steps; ++t) {
    copy_wait<RING - 2>();  // this thread's copies of tile t have landed
    group_sync<WX>(group);  // and the group's; its stage (t - 1) % RING is free
#ifndef GP_SKIP_STAGE
    if (t + RING - 1 < steps) stage_m(t + RING - 1);
#endif
    copy_commit();
#ifndef GP_SKIP_FMA
    // MB rows of the star tile against the thread's columns c0 .. c0+3 and
    // c1 .. c1+3
    const float* mb = gring + (t % RING) * WSTAGE + (lane / 8) * 4;
    const float* kb = ks + t * MB * TP + tx * 4;
#pragma unroll
    for (int mm = 0; mm < MB; ++mm) {
      const float4 k0 = *reinterpret_cast<const float4*>(kb + mm * TP);
      const float4 k1 = *reinterpret_cast<const float4*>(kb + mm * TP + TP / 2);
      const float4 v0 = *reinterpret_cast<const float4*>(mb + mm * W);
      const float4 v1 = *reinterpret_cast<const float4*>(mb + mm * W + 16);
      const float kv[PP] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
      const float cv[CC] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int a = 0; a < PP; ++a)
#pragma unroll
        for (int b = 0; b < CC; ++b) s[a][b] = fmaf(kv[a], cv[b], s[a][b]);
    }
#endif
  }
  copy_wait<0>();
  __syncthreads();  // every group is done with its ring; the rings take the sums

  // epilogue: quad from the resident star tile, the mean straight out
  float qacc[PP];
#pragma unroll
  for (int a = 0; a < PP; ++a) qacc[a] = 0.f;
#pragma unroll
  for (int b = 0; b < CC; ++b) {
    const int c = (b < 4 ? c0 : c1) + b % 4;
    if (c < N) {
      const float4 k0 = *reinterpret_cast<const float4*>(ks + c * TP + tx * 4);
      const float4 k1 = *reinterpret_cast<const float4*>(ks + c * TP + TP / 2 + tx * 4);
      const float kv[PP] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int a = 0; a < PP; ++a) qacc[a] = fmaf(kv[a], s[a][b], qacc[a]);
    } else if (c < Ncol) {
#pragma unroll
      for (int a = 0; a < PP; ++a) {
        const int p = p0 + (a < 4 ? 0 : TP / 2 - 4) + tx * 4 + a;
        if (p < P) mean[(size_t)p * Dout + (c - N)] = s[a][b];
      }
    }
  }
  // every (thread row, particle) entry is written once
  float* red = ring;
#pragma unroll
  for (int a = 0; a < PP; ++a)
    red[ty * TP + (a < 4 ? 0 : TP / 2 - 4) + tx * 4 + a] = qacc[a];
  __syncthreads();
  for (int e = tid; e < TP; e += NTH) {
    float q = 0.f;
    for (int g = 0; g < T::TY; ++g) q += red[g * TP + e];
    if (p0 + e < P) quad[p0 + e] = q;
  }
}

// Dynamic shared-memory bytes of one block: it does not depend on N.
template <int TP>
size_t core_smem_bytes(int d, bool has_linear, bool obs) {
  using T = Tile<TP>;
  return sizeof(float) * (2 * (size_t)T::STAGE + 2 * (size_t)T::KT +
                          (obs ? 2 : 1) * (size_t)T::TY * TP + 3 * (size_t)MB * d +
                          2 * (size_t)d + (has_linear ? 2 : 1) * (size_t)d * TP);
}

template <int TP, int KIND>
int launch_core(const float* xt, const float* xs, const float* inv_ls, const float* lin_w,
                const float* A, const float* kinv, const float* z, const float* lam2,
                float* out0, float* out1, int N, int P, int d, int Dout, int n_valid,
                int Pb, int C, int splits, float* partial, int* ticket, cudaStream_t stream) {
  const size_t smem = core_smem_bytes<TP>(d, KIND == KIND_X, KIND == KIND_OBS);
  auto kernel = posterior_core<TP, KIND>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + TP - 1) / TP, splits, C);
  kernel<<<grid, NT, smem, stream>>>(xt, xs, inv_ls, lin_w, A, kinv, z, lam2, out0, out1, N,
                                     P, d, Dout, n_valid, Pb, splits, partial, ticket);
  return (int)cudaGetLastError();
}

// Dynamic shared-memory bytes of an x_onepass block: the star tile, the
// rings and the raw rows (96 KB at the headline's 236 rows and 64
// particles, two blocks an SM; 157 KB at 128 particles, one).
template <int TP, int NTH>
size_t onepass_smem_bytes(int N, int d) {
  return sizeof(float) * ((size_t)(N + MB - 1) / MB * MB * TP +
                          (size_t)RING * MB * Tile<TP, NTH>::RC + 2 * (size_t)N * d);
}

// x_onepass's columns a block: 128 when N + Dout fits them, else 256.
inline int onepass_cols(int Ncol) { return Ncol <= 128 ? 128 : 256; }

template <int TP, int NTH>
int launch_onepass(const float* xt, const float* xs, const float* inv_ls, const float* lin_w,
                   const float* A, const float* kinv, float* mean, float* quad, int N, int P,
                   int d, int Dout, int n_valid, int C, cudaStream_t stream) {
  const size_t smem = onepass_smem_bytes<TP, NTH>(N, d);
  auto kernel = x_onepass<TP, NTH>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + TP - 1) / TP, C);
  kernel<<<grid, NTH, smem, stream>>>(xt, xs, inv_ls, lin_w, A, kinv, mean, quad, N, P, d,
                                      Dout, n_valid);
  return (int)cudaGetLastError();
}

// Particles per block of the streamed core when the caller leaves it to
// the launcher (tile 0): large grids take 128, which halves the M tiles
// re-read from L2 per particle against 64; small ones take 64, whose
// RC = 256 columns a pass regenerate Kstar half as often.
inline int pick_tile(int P, int tile) {
  if (tile != 0) return tile;
  return P >= 32768 ? 128 : 64;
}

// Particles per x_onepass block (tile 0): 128 (half the tiles of M read
// from L2 per particle) on large grids and for narrow blocks; 64 (two
// blocks an SM) at P < 32,768.
inline int pick_onepass_tile(int P, int Ncol, int tile) {
  if (tile != 0) return tile;
  return Ncol <= 128 || P >= 32768 ? 128 : 64;
}

inline int passes(int tp, int Ncol) {
  const int rc = tp == 64 ? Tile<64>::RC : Tile<128>::RC;
  return (Ncol + rc - 1) / rc;
}

template <int KIND>
int dispatch(int tile, const float* xt, const float* xs, const float* inv_ls,
             const float* lin_w, const float* A, const float* kinv, const float* z,
             const float* lam2, float* out0, float* out1, int N, int P, int d, int Dout,
             int n_valid, int Pb, int C, int splits, void* partial, void* ticket,
             cudaStream_t stream) {
  if (C < 1 || splits < 1 || splits > passes(tile, N + Dout) ||
      (splits > 1 && !(partial && ticket)))
    return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 64:
      return launch_core<64, KIND>(xt, xs, inv_ls, lin_w, A, kinv, z, lam2, out0, out1, N,
                                   P, d, Dout, n_valid, Pb, C, splits, (float*)partial,
                                   (int*)ticket, stream);
    case 128:
      return launch_core<128, KIND>(xt, xs, inv_ls, lin_w, A, kinv, z, lam2, out0, out1, N,
                                    P, d, Dout, n_valid, Pb, C, splits, (float*)partial,
                                    (int*)ticket, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// How a launch of C class blocks of N training rows and Dout outputs over
// P particles runs on a card of sms SMs: plan = {particles per block,
// splits, particle tiles, one pass}.  tile 0 lets the launcher choose the
// particles per block (64 or 128).  With one_pass (K1) and N + Dout <= 256
// the launch takes x_onepass (plan[3] = 1, never split).  Otherwise the
// streamed core: with splits > 1 its passes over the columns of G are
// dealt over splits blocks per particle tile, so that a small P still
// fills the card; the caller then provides 2 x splits x P x C floats of
// partial sums and one int per particle tile and class, zeroed before the
// first launch; each launch leaves them zeroed again.  Returns 0, or
// cudaErrorInvalidValue for a tile the launcher does not take.
int gp_plan(int N, int Dout, int P, int C, int tile, int one_pass, int sms, int* plan) {
  const int Ncol = N + Dout;
  const bool one = one_pass && Ncol <= ONEPASS_COLS;
  const int tp = one ? pick_onepass_tile(P, Ncol, tile) : pick_tile(P, tile);
  if ((tp != 64 && tp != 128) || C < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (P + tp - 1) / tp;
  const int want = (3 * sms + tiles * C - 1) / (tiles * C);  // about three blocks per SM
  const int np = passes(tp, Ncol);
  plan[0] = tp;
  plan[1] = one || want < 1 ? 1 : (want < np ? want : np);
  plan[2] = tiles;
  plan[3] = one;
  return 0;
}

// mean (C, P, Dout) and quad (C, P) of C class blocks (xt (C, N, d),
// A (C, N, Dout), kinv (C, N, N)) of the dynamics (has_linear) or RBF
// posterior, with the tile, splits and design of gp_plan.
int gp_posterior_launch(const void* xt, const void* xs, const void* inv_ls,
                        const void* lin_w, const void* A, const void* kinv,
                        void* mean, void* quad, int N, int P, int d, int Dout,
                        int n_valid, int C, int has_linear, int tile, int one_pass,
                        int splits, void* partial, void* ticket, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const float *fxt = (const float*)xt, *fxs = (const float*)xs, *fil = (const float*)inv_ls,
              *flw = (const float*)lin_w, *fA = (const float*)A, *fk = (const float*)kinv;
  if (one_pass) {
    if (!has_linear || N + Dout > ONEPASS_COLS || splits != 1 || C < 1)
      return (int)cudaErrorInvalidValue;
    const bool narrow = onepass_cols(N + Dout) == 128;
    auto go = tile == 64    ? (narrow ? launch_onepass<64, 128> : launch_onepass<64, 256>)
              : tile == 128 ? (narrow ? launch_onepass<128, 256> : launch_onepass<128, 512>)
                            : nullptr;
    if (go == nullptr) return (int)cudaErrorInvalidValue;
    return go(fxt, fxs, fil, flw, fA, fk, (float*)mean, (float*)quad, N, P, d, Dout, n_valid, C,
              stream);
  }
  auto go = has_linear ? dispatch<KIND_X> : dispatch<KIND_RBF>;
  return go(tile, fxt, fxs, fil, flw, fA, fk, nullptr, nullptr, (float*)mean, (float*)quad, N,
            P, d, Dout, n_valid, P, C, splits, partial, ticket, stream);
}

// quad (P,) and qres (P,) of the observation weighting, P = B * Pb
// particles bank after bank, z (B, D), with the tile and splits of gp_plan.
int obs_loglik_launch(const void* xt, const void* xs, const void* inv_ls,
                      const void* A, const void* kinv, const void* z,
                      const void* lam2, void* quad, void* qres, int N, int P,
                      int d, int D, int Pb, int tile, int splits, void* partial,
                      void* ticket, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  return dispatch<KIND_OBS>(tile, (const float*)xt, (const float*)xs, (const float*)inv_ls,
                            nullptr, (const float*)A, (const float*)kinv, (const float*)z,
                            (const float*)lam2, (float*)quad, (float*)qres, N, P, d, D, N,
                            Pb, 1, splits, partial, ticket, stream);
}

}  // extern "C"
