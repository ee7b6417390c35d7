// K4: the sparse (SGPR) posterior's prediction for Hopper (sm_90a), in
// plain IEEE fp32.
//
// Replaces no Pallas kernel: the JAX package leaves this prediction to XLA
// (gpmdm_tpu/models/sparse.py), so there is no TPU kernel to port.  It
// replaces the port's own per-frame solve path (ops/sgpr.py
// sgpr_predict_plain: the star block, two cuBLAS trsm calls, squares, two
// column sums and the mean product, each a round trip through device
// memory).  For each point x (a particle) against the M inducing inputs
// z_i of one GP, or of each of C class GPs on the grid's second axis:
//
//   k_i  = exp(-sum_k ((z_ik - x_k) / l_k)^2) [+ sum_k z_ik w_k^2 x_k + w_b^2]
//   kss  = 1 [+ sum_k x_k^2 w_k^2 + w_b^2] [+ sigma_n^2 + sigma_num^2]
//   mean = k^T beta                          (Dout outputs)
//   v1   = Lm^-1 k,   v2 = LB^-1 v1          (forward substitution)
//   var  = max(kss - |v1|^2 + |v2|^2, 1e-12) (a NaN stays NaN, as torch.clamp)
//
// with l = exp(log_lengthscales), w = exp(log_lin_coeff) (the linear term
// of the dynamics GP only; its last entry weighs the constant) and the
// noise term only when asked for.  Only mean (C, P, Dout) and var (C, P)
// are written: the star column, v1 and v2 never leave the chip.  The
// hyperparameters are read in log space and exponentiated here, so a call
// launches nothing else.
//
// What bounds it on the H100: the two substitutions are 2 M^2 FLOPs a
// point (the mean 2 M Dout, the star column ~12 M), against factors of
// M^2 floats that each block reads once, so the fp32 rate outside the
// tensor cores: at the live cell's 320,000 particles and M = 128, 36.5
// GFLOP for the observation GP and both classes' dynamics GPs, 0.545 ms at
// 67 TFLOP/s.  No tensor cores (TF32 would wreck the cancellation in
// kss - |v1|^2 + |v2|^2), no explicit inverse (the hoisted path's products
// by inverses lose accuracy on the hour-long asset), no atomics: every
// sum is taken in a fixed order, so results repeat from run to run.
//
// Design.  A block of TP threads owns a tile of TP particles and keeps
// their (MP x TP) star block, MP = M rounded up to 32, with z / l and z w^2
// of the M inducing inputs: in shared memory while they fit (TP = 128, or
// 64 or 32 for larger M: up to M = 1,408 at din <= 4), else in a slice of
// a global scratch buffer that the block owns (TP = 128), each 32-row panel
// of it staged through shared memory where the substitutions' inner loop
// reads it.  Only then do the blocks persist, each looping
// over particle tiles, so that the scratch stays under SCRATCH_MAX floats
// whatever P is: any M runs.  A padded row has a zero star entry and an
// identity factor row, so it adds nothing.  Each thread first writes its
// own particle's star column, then the mean is a product of the star block
// by beta (4 particles x 4 outputs a thread, beta staged through shared
// memory).  Each substitution is left-looking, blocked by 32
// rows: the row block less its product with the rows already solved,
// each thread updating an 8 x 4 register tile (8 rows x 4 particles) from
// the factor's panel staged 32 columns at a time (transposed, so one
// float4 broadcast feeds the tile's rows: 32 FMAs for three shared-memory
// loads); then each thread solves its own particle's column of the 32 x 32
// diagonal block in registers, column-oriented (v_j *= 1 / L_jj, then
// v_i -= L_ij v_j for the rows below, the column read as float4
// broadcasts).  The squares of a diagonal block are summed pairwise and
// the blocks' sums in turn, so the rounding of |v|^2, which lands in the
// cancelling kss - |v1|^2 + |v2|^2, grows with log2(32) + M / 32 and not
// with M.  At M = 128 a block holds ~73 KB, three blocks an SM.
// A design with each particle's whole column in registers, fully unrolled,
// made nvcc exceed the build's 300 s limit on its own.
//
// sgpr_plan says how a launch runs and the scratch it needs; the launcher
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// shapes it does not take or a missing scratch buffer.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <string.h>

#include <algorithm>

namespace k4 {

constexpr int BS = 32;  // rows of a row block and of a diagonal block (the sums below assume 32)
constexpr int LS = 36;  // row stride of a staged tile of a factor or of beta (a multiple of 4)
constexpr int SMEM_MAX = 232448;
// The global-scratch plan: resident blocks an SM it asks for, and the most
// floats of scratch (256 MiB) it takes before its blocks loop over more
// particle tiles.
constexpr int BLOCKS_PER_SM = 4;
constexpr size_t SCRATCH_MAX = (size_t)1 << 26;

// Everything a launch reads and writes; class c's blocks are offset by c
// inside the kernel.
struct Args {
  const float* Z;        // (C, M, din) inducing inputs
  const float* xs;       // (P, din) points
  const float* Lm;       // (C, M, M) chol(Kmm), lower
  const float* LB;       // (C, M, M) chol(B), lower
  const float* beta;     // (C, M, Dout)
  const float* log_ls;   // (din,)
  const float* log_lin;  // (din + 1,), or null: no linear term
  const float* log_sn;   // (), or null: no noise in kss
  float num2;            // sigma_num^2, with log_sn
  float* mean;           // (C, P, Dout)
  float* var;            // (C, P)
  int M, P, din, Dout;
  float* scratch;        // (C, gridDim.x, big_floats) on the global plan, else null
  int tiles;             // particle tiles of TP
};

// The width of a row of z / l and z w^2: 4 (zero-padded) while din <= 4,
// so a row is one float4.
__host__ __device__ inline int row_width(int din) { return din <= 4 ? 4 : din; }

// Floats of a block's small region, always in shared memory: one factor
// tile, its reciprocals and the hyperparameters, rounded up to a float4.
__host__ __device__ inline int small_floats(int din) {
  return (BS * LS + BS + 2 * row_width(din) + 4 + 3) / 4 * 4;
}

// Floats of a block's large region, in shared memory or in its slice of
// the scratch: the star block, z / l and z w^2, and (din > 4) the tile's
// points, scaled and as they are.  A multiple of 32.
__host__ __device__ inline size_t big_floats(int tp, int mp, int din) {
  const size_t ds = row_width(din);
  return (size_t)mp * tp + 2 * (size_t)mp * ds + (din > 4 ? 2 * (size_t)tp * ds : 0);
}

// inv_ls[k] = exp(-log_ls[k]) and w2[k] = exp(log_lin[k])^2 for k < din,
// 0 up to width (w2 0 without the linear term); wbn = {exp(log_lin[din])^2
// or 0, exp(log_sn)^2 + num2 or 0}.
__device__ inline void stage_hyper(float* inv_ls, float* w2, float* wbn, int width,
                                   const Args& a, int tid, int nt) {
  for (int k = tid; k < width; k += nt) {
    inv_ls[k] = k < a.din ? expf(-a.log_ls[k]) : 0.f;
    float w = 0.f;
    if (a.log_lin != nullptr && k < a.din) {
      const float e = expf(a.log_lin[k]);
      w = e * e;
    }
    w2[k] = w;
  }
  if (tid == 0) {
    float wb = 0.f, noise = 0.f;
    if (a.log_lin != nullptr) {
      const float e = expf(a.log_lin[a.din]);
      wb = e * e;
    }
    if (a.log_sn != nullptr) {
      const float e = expf(*a.log_sn);
      noise = e * e + a.num2;
    }
    wbn[0] = wb;
    wbn[1] = noise;
  }
}

// V (MP x TP) <- L^-1 V for the block's particles, blocked by BS rows;
// returns |L^-1 v|^2 of particle tid, a pairwise sum per row block.  Thread tid updates rows
// 8 (tid / (TP / 4)) .. + 7 of each row block at particles 4 (tid % (TP / 4))
// .. + 3, and solves its own particle's column of each diagonal block.
// GLOBAL: V is in global scratch, and each 32-row panel of solved rows is
// staged into vt (BS x TP, shared) beside the factor's, so that the inner
// loop reads shared memory only.
template <int TP, bool GLOBAL>
__device__ inline float blocked_sub(float* V, float* lt, float* vt, float* rd, const float* L,
                                    int M, int MP, int tid) {
  constexpr int PG = TP / 4;
  const int ry = tid / PG, tx = tid % PG;
  float s = 0.f;
  for (int r0 = 0; r0 < MP; r0 += BS) {
    float acc[8][4];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float4 q = *reinterpret_cast<const float4*>(V + (r0 + 8 * ry + u) * TP + 4 * tx);
      acc[u][0] = q.x;
      acc[u][1] = q.y;
      acc[u][2] = q.z;
      acc[u][3] = q.w;
    }
    // the row block less its product with the rows already solved; the
    // panel lt[c][r] = L[r0 + r][c0 + c]
    for (int c0 = 0; c0 < r0; c0 += BS) {
      __syncthreads();  // lt is free
      for (int e = tid; e < BS * BS; e += TP) {
        const int r = e / BS, c = e - r * BS;
        lt[c * LS + r] = r0 + r < M && c0 + c < M ? L[(size_t)(r0 + r) * M + c0 + c] : 0.f;
      }
      if (GLOBAL)
        for (int e = tid; e < BS * TP / 4; e += TP)
          reinterpret_cast<float4*>(vt)[e] = reinterpret_cast<const float4*>(V + c0 * TP)[e];
      __syncthreads();
      const float* vs = GLOBAL ? vt : V + c0 * TP;
#pragma unroll 4
      for (int c = 0; c < BS; ++c) {
        const float4 q = *reinterpret_cast<const float4*>(vs + c * TP + 4 * tx);
        const float4 la = *reinterpret_cast<const float4*>(lt + c * LS + 8 * ry);
        const float4 lb = *reinterpret_cast<const float4*>(lt + c * LS + 8 * ry + 4);
        const float l[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          acc[u][0] = fmaf(-l[u], q.x, acc[u][0]);
          acc[u][1] = fmaf(-l[u], q.y, acc[u][1]);
          acc[u][2] = fmaf(-l[u], q.z, acc[u][2]);
          acc[u][3] = fmaf(-l[u], q.w, acc[u][3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      *reinterpret_cast<float4*>(V + (r0 + 8 * ry + u) * TP + 4 * tx) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    __syncthreads();  // the row block is written; lt is free
    // the diagonal block by columns, lt[j][i] = L[r0 + i][r0 + j] for i > j
    // (0 elsewhere), and the reciprocals of its diagonal (1 on padded rows)
    for (int e = tid; e < BS * BS; e += TP) {
      const int i = e / BS, j = e - i * BS;
      lt[j * LS + i] = r0 + i < M && j < i ? L[(size_t)(r0 + i) * M + r0 + j] : 0.f;
    }
    for (int r = tid; r < BS; r += TP)
      rd[r] = r0 + r < M ? 1.f / L[(size_t)(r0 + r) * M + r0 + r] : 1.f;
    __syncthreads();
    float v[BS];
#pragma unroll
    for (int r = 0; r < BS; ++r) v[r] = V[(r0 + r) * TP + tid];
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      v[j] *= rd[j];
#pragma unroll
      for (int i = j & ~3; i < BS; i += 4) {
        const float4 l = *reinterpret_cast<const float4*>(lt + j * LS + i);
        if (i > j) v[i] = fmaf(-l.x, v[j], v[i]);
        if (i + 1 > j) v[i + 1] = fmaf(-l.y, v[j], v[i + 1]);
        if (i + 2 > j) v[i + 2] = fmaf(-l.z, v[j], v[i + 2]);
        if (i + 3 > j) v[i + 3] = fmaf(-l.w, v[j], v[i + 3]);
      }
    }
#pragma unroll
    for (int r = 0; r < BS; ++r) V[(r0 + r) * TP + tid] = v[r];
    // the next row block reads these rows after its first barrier
    // the block's squares, summed pairwise (constant strides, so that q
    // stays in registers)
    float q[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) q[r] = fmaf(v[r], v[r], v[r + 16] * v[r + 16]);
#pragma unroll
    for (int r = 0; r < 8; ++r) q[r] += q[r + 8];
#pragma unroll
    for (int r = 0; r < 4; ++r) q[r] += q[r + 4];
    s += (q[0] + q[2]) + (q[1] + q[3]);
  }
  __syncthreads();
  return s;
}

// GLOBAL: the large region in the block's slice of a.scratch, and the
// block looping over particle tiles; else in shared memory, one tile a block.
template <int TP, bool GLOBAL>
__global__ void __launch_bounds__(TP) sgpr_trsm_predict(Args a, int MP) {
  constexpr int PG = TP / 4;
  const int cls = blockIdx.y, tid = threadIdx.x;
  const int M = a.M, din = a.din, Dout = a.Dout, P = a.P, ds = row_width(din);
  const float* Z = a.Z + (size_t)cls * M * din;
  const float* Lm = a.Lm + (size_t)cls * M * M;
  const float* LB = a.LB + (size_t)cls * M * M;
  const float* beta = a.beta + (size_t)cls * M * Dout;
  float* mean = a.mean + (size_t)cls * P * Dout;
  float* var = a.var + (size_t)cls * P;
  extern __shared__ __align__(16) float smem[];
  float* lt = smem;              // (BS, LS) a factor tile
  float* rd = lt + BS * LS;      // (BS,) reciprocals of a diagonal block
  float* hy = rd + BS;           // inv_ls[ds], w2[ds], wb, noise
  float* vt = smem + small_floats(din);  // (BS, TP) a panel of V, GLOBAL only
  float* V = GLOBAL ? a.scratch + ((size_t)cls * gridDim.x + blockIdx.x) * big_floats(TP, MP, din)
                    : vt;        // (MP, TP) the star block, then v1, then v2
  float* zs = V + MP * TP;       // (MP, ds) z / l
  float* zl = zs + MP * ds;      // (MP, ds) z w^2
  float* xc = zl + MP * ds;      // (TP, ds) the points / l, din > 4
  float* xr = xc + TP * ds;      // (TP, ds) the points, din > 4
  for (int e = tid; e < 2 * MP * ds; e += TP) zs[e] = 0.f;
  stage_hyper(hy, hy + ds, hy + 2 * ds, ds, a, tid, TP);
  __syncthreads();
  for (int e = tid; e < M * din; e += TP) {
    const int i = e / din, k = e - i * din;
    zs[i * ds + k] = Z[e] * hy[k];
    zl[i * ds + k] = Z[e] * hy[ds + k];
  }
  const float wb = hy[2 * ds], noise = hy[2 * ds + 1];
  __syncthreads();
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    // the last tile's reads of other threads' columns ended at blocked_sub's
    // last barrier: from there each thread reads and writes its own column
    const int p0 = tile * TP, p = p0 + tid;
    float lin_self = 0.f;  // sum_k x_k^2 w_k^2
    if (din <= 4) {
      float x[4], xl[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        xl[k] = p < P && k < din ? a.xs[(size_t)p * din + k] : 0.f;
        x[k] = xl[k] * hy[k];
        lin_self += xl[k] * xl[k] * hy[ds + k];
      }
      // this thread's star column
      for (int i = 0; i < MP; ++i) {
        const float4 z = *reinterpret_cast<const float4*>(zs + 4 * i);
        const float4 w = *reinterpret_cast<const float4*>(zl + 4 * i);
        const float d0 = z.x - x[0], d1 = z.y - x[1], d2 = z.z - x[2], d3 = z.w - x[3];
        const float sq = fmaf(d3, d3, fmaf(d2, d2, fmaf(d1, d1, d0 * d0)));
        const float lin = fmaf(w.w, xl[3], fmaf(w.z, xl[2], fmaf(w.y, xl[1], w.x * xl[0])));
        V[i * TP + tid] = i < M ? expf(-sq) + (lin + wb) : 0.f;
      }
    } else {
      for (int k = 0; k < din; ++k) {
        const float xk = p < P ? a.xs[(size_t)p * din + k] : 0.f;
        xr[tid * ds + k] = xk;
        xc[tid * ds + k] = xk * hy[k];
        lin_self += xk * xk * hy[ds + k];
      }
      for (int i = 0; i < MP; ++i) {
        float sq = 0.f, lin = 0.f;
        for (int k = 0; k < din; ++k) {
          const float d = zs[i * ds + k] - xc[tid * ds + k];
          sq = fmaf(d, d, sq);
          lin = fmaf(zl[i * ds + k], xr[tid * ds + k], lin);
        }
        V[i * TP + tid] = i < M ? expf(-sq) + (lin + wb) : 0.f;
      }
    }
    const float kss = (1.f + (lin_self + wb)) + noise;
    __syncthreads();

    // mean = k^T beta: 4 particles x 4 outputs a thread, over chunks of LS
    // outputs (9 groups of 4, up to 3 a row group); each chunk's beta staged
    // 32 rows at a time in lt, so a float4 broadcast feeds 16 FMAs
    {
      const int ry = tid / PG, tx = tid % PG;
      for (int oc = 0; oc < Dout; oc += LS) {
        const int ng = (min(LS, Dout - oc) + 3) / 4;
        float acc[3][4][4] = {};  // [group ry + 4 g][particle][output]
        for (int i0 = 0; i0 < M; i0 += BS) {
          __syncthreads();  // lt is free
          for (int e = tid; e < BS * LS; e += TP) {
            const int r = e / LS, o = e - r * LS;
            lt[e] = i0 + r < M && oc + o < Dout ? beta[(size_t)(i0 + r) * Dout + oc + o] : 0.f;
          }
          __syncthreads();
          const int nr = min(BS, M - i0);
          for (int r = 0; r < nr; ++r) {
            const float4 q = *reinterpret_cast<const float4*>(V + (i0 + r) * TP + 4 * tx);
            const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              if (ry + 4 * g < ng) {
                const float4 b = *reinterpret_cast<const float4*>(lt + r * LS + 4 * (ry + 4 * g));
#pragma unroll
                for (int w = 0; w < 4; ++w) {
                  acc[g][w][0] = fmaf(qv[w], b.x, acc[g][w][0]);
                  acc[g][w][1] = fmaf(qv[w], b.y, acc[g][w][1]);
                  acc[g][w][2] = fmaf(qv[w], b.z, acc[g][w][2]);
                  acc[g][w][3] = fmaf(qv[w], b.w, acc[g][w][3]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const int o0 = oc + 4 * (ry + 4 * g);
          if (ry + 4 * g >= ng) continue;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int pw = p0 + 4 * tx + w;
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (pw < P && o0 + u < Dout) mean[(size_t)pw * Dout + o0 + u] = acc[g][w][u];
          }
        }
      }
    }
    __syncthreads();  // the mean's reads of V come before the substitutions' writes

    const float s1 = blocked_sub<TP, GLOBAL>(V, lt, vt, rd, Lm, M, MP, tid);
    const float s2 = blocked_sub<TP, GLOBAL>(V, lt, vt, rd, LB, M, MP, tid);
    if (p < P) {
      const float r = (kss - s1) + s2;
      var[p] = r < 1e-12f ? 1e-12f : r;  // false for a NaN, which stays
    }
  }
}

// How a launch runs: particles a block, MP, blocks a class, shared-memory
// bytes and floats of global scratch (0 on the shared-memory plan).
struct Plan {
  int tp, mp, gx;
  size_t smem, scratch;
};

inline int tiles_of(int P, int tp) { return (P + tp - 1) / tp; }

inline Plan plan(int M, int P, int din, int C, int sms) {
  const int mp = (M + BS - 1) / BS * BS;
  for (int tp = 128; tp >= 32; tp /= 2) {
    const size_t bytes = sizeof(float) * (small_floats(din) + big_floats(tp, mp, din));
    if (bytes <= SMEM_MAX) return Plan{tp, mp, tiles_of(P, tp), bytes, 0};
  }
  const size_t per = big_floats(128, mp, din);
  const size_t blocks = std::min((size_t)BLOCKS_PER_SM * (sms > 0 ? sms : 1), SCRATCH_MAX / per);
  const int gx = (int)std::max((size_t)1, std::min((size_t)tiles_of(P, 128), blocks / C));
  return Plan{128, mp, gx, sizeof(float) * (small_floats(din) + BS * 128), (size_t)gx * C * per};
}

template <int TP, bool GLOBAL>
int launch(const Args& a, const Plan& pl, int C, cudaStream_t stream) {
  auto kernel = sgpr_trsm_predict<TP, GLOBAL>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(pl.gx, C), TP, pl.smem, stream>>>(a, pl.mp);
  return (int)cudaGetLastError();
}

}  // namespace k4

extern "C" {

// plan = {particles a block, blocks a class, floats of global scratch}
// of a launch at these shapes on a card of ``sms`` SMs.
int sgpr_plan(int M, int P, int din, int C, int sms, int* plan) {
  if (M < 1 || P < 1 || din < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const k4::Plan pl = k4::plan(M, P, din, C, sms);
  if (pl.scratch > (size_t)INT_MAX) return (int)cudaErrorInvalidValue;
  plan[0] = pl.tp;
  plan[1] = pl.gx;
  plan[2] = (int)pl.scratch;
  return 0;
}

// mean (C, P, Dout) and var (C, P) of C SGPR predictions at P points:
// Z (C, M, din), xs (P, din), Lm and LB (C, M, M), beta (C, M, Dout),
// log_ls (din,), log_lin (din + 1,) or null, log_sn () or null with
// num2_bits the float32 bits of sigma_num^2 (the launcher takes only
// pointers and ints), and scratch of sgpr_plan's floats (null when 0).
int sgpr_predict_launch(const void* Z, const void* xs, const void* Lm, const void* LB,
                        const void* beta, const void* log_ls, const void* log_lin,
                        const void* log_sn, void* mean, void* var, int num2_bits, int M,
                        int P, int din, int Dout, int C, int sms, void* scratch,
                        void* stream_ptr) {
  if (M < 1 || P < 1 || din < 1 || Dout < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const k4::Plan pl = k4::plan(M, P, din, C, sms);
  if (pl.scratch > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  k4::Args a{(const float*)Z,      (const float*)xs,      (const float*)Lm,
             (const float*)LB,     (const float*)beta,    (const float*)log_ls,
             (const float*)log_lin, (const float*)log_sn, 0.f,
             (float*)mean,         (float*)var,           M,
             P,                    din,                   Dout,
             (float*)scratch,      k4::tiles_of(P, pl.tp)};
  memcpy(&a.num2, &num2_bits, sizeof(float));
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (pl.scratch > 0) return k4::launch<128, true>(a, pl, C, stream);
  switch (pl.tp) {
    case 128:
      return k4::launch<128, false>(a, pl, C, stream);
    case 64:
      return k4::launch<64, false>(a, pl, C, stream);
    default:
      return k4::launch<32, false>(a, pl, C, stream);
  }
}

}  // extern "C"
