// PRDC distance reductions: k-NN radii and the four pairwise statistics.
//
// Replaces the TPU kernels of audio_metrics_tpu/ops/distance.py:
//   - _knn_call (pallas_call at :131; _knn_kernel :93, _k_smallest :72,
//     _sq_dist_tile :56): per row, the k-th smallest squared distance
//     max(|a|^2 + |b|^2 - 2 a.b, 0) over all rows (self included), sqrt;
//   - _stats_calls (pallas_calls at :236 and :257; _ref_stats_kernel :162,
//     _cand_stats_kernel :185): with d = sqrt of the above between the
//     reference and candidate sets, per candidate any(d < ref_r) and
//     count(d < ref_r), per reference any(d < cand_r) and min d.
//
// What bounds them here: 2*N*M*d f32 operations (4.3 GFLOP at N=M=2048,
// d=512) on the CUDA cores, 67 TFLOP/s at most; the inputs are a few MB and
// the outputs a few KB, so bytes do not bind.  The products stay in full
// f32, not TF32: TF32's ~1e-3 relative error on a.b is magnified by the
// cancellation in |a|^2 + |b|^2 - 2 a.b and would move radii and flip the
// d < r comparisons.  The distance tile lives only in registers and shared
// memory; device memory sees the embeddings and the reductions.
//
// Design:
//   - both kernels compute a tile of dot products with a shared-memory
//     tiled SIMT product (BK = 16 columns of d per step, each thread a
//     small register tile of outputs, conflict-free shared reads);
//   - knn: a block owns BM_KNN query rows and loops over every column tile
//     itself (the loop replaces the TPU's sequential grid axis).  Each row
//     keeps a sorted list of its k smallest values in shared memory; one
//     warp per row merges every tile into it: lanes whose value beats the
//     list's last entry vote, and the winners are inserted one at a time.
//     Ties count with multiplicity, so the k-th entry is the k-th order
//     statistic whatever the tie order;
//   - stats: ONE sweep over (reference tile x candidate tile) blocks gives
//     all four reductions (the TPU needed two one-sided sweeps because its
//     grid accumulates only along its fastest axis).  Each block reduces its
//     tile in shared memory, then makes one global atomic per row or
//     column: atomicOr for the two anys, atomicAdd for the int32 count,
//     atomicMin on the bits of the non-negative float min.  All four are
//     order independent, so the result is deterministic;
//   - the ragged edge is masked by index (no +inf padding rows); a radius
//     below 0 matches nothing; d < r is compared after the sqrt, strictly,
//     as the TPU kernel does (comparing d^2 < r^2 flips near-ties).
//   - offsets are 64-bit: N*d may pass 2^31.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;          // depth step of the dot-product tile
constexpr int THREADS = 256;

// knn: 32 query rows x 64 columns per tile; thread (ty, tx) of a 16 x 16
// grid owns rows ty + 16*i (i < 2) and columns tx + 16*j (j < 4).
constexpr int BM_KNN = 32, BN_KNN = 64;
constexpr int KMAX = 128;       // widest k-smallest list (the TPU scratch's width)

// stats: 64 reference rows x 64 candidate columns per block; thread
// (ty, tx) owns rows ty + 16*i and columns tx + 16*j (i, j < 4).
constexpr int BM_ST = 64, BN_ST = 64;

// Load a (rows x BK) slab of row-major x (n rows of d) starting at
// (row0, k0) into s[k][r] (transposed, pitch rows + 1), zero outside.
template <int ROWS>
__device__ __forceinline__ void load_slab(const float* __restrict__ x, int n, int d, int row0,
                                          int k0, float (*s)[ROWS + 1]) {
  for (int i = threadIdx.x; i < ROWS * BK; i += THREADS) {
    const int r = i / BK, k = i - r * BK;
    const int row = row0 + r, col = k0 + k;
    s[k][r] = (row < n && col < d) ? x[(size_t)row * d + col] : 0.f;
  }
}

// f32 squared distance exactly as the TPU kernel's formula orders it:
// (|a|^2 + |b|^2) - 2 a.b, clamped at 0, no fused multiply-add.
__device__ __forceinline__ float sq_dist(float sa, float sb, float dot) {
  return fmaxf(__fsub_rn(__fadd_rn(sa, sb), __fmul_rn(2.f, dot)), 0.f);
}

__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ x, const float* __restrict__ sq, int n, int d, int k,
           float* __restrict__ out) {
  extern __shared__ float list[];  // (BM_KNN, k) sorted ascending per row
  __shared__ float As[BK][BM_KNN + 1];
  __shared__ float Bs[BK][BN_KNN + 1];
  __shared__ float Ds[BM_KNN][BN_KNN + 1];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM_KNN;
  for (int i = tid; i < BM_KNN * k; i += THREADS) list[i] = CUDART_INF_F;
  float sa[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + ty + 16 * i;
    sa[i] = r < n ? sq[r] : 0.f;
  }

  for (int col0 = 0; col0 < n; col0 += BN_KNN) {
    float acc[2][4] = {};
    for (int k0 = 0; k0 < d; k0 += BK) {
      load_slab<BM_KNN>(x, n, d, row0, k0, As);
      load_slab<BN_KNN>(x, n, d, col0, k0, Bs);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[2], b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      const float sb = c < n ? sq[c] : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        Ds[ty + 16 * i][tx + 16 * j] = c < n ? sq_dist(sa[i], sb, acc[i][j]) : CUDART_INF_F;
    }
    __syncthreads();

    // merge: warp w owns rows w, w + 8, w + 16, w + 24 of the tile
    for (int rr = warp; rr < BM_KNN; rr += THREADS / 32) {
      float* L = list + rr * k;
#pragma unroll
      for (int h = 0; h < BN_KNN / 32; ++h) {
        const float v = Ds[rr][lane + 32 * h];
        unsigned want = __ballot_sync(0xffffffffu, v < L[k - 1]);
        while (want) {
          const int src = __ffs(want) - 1;
          want &= want - 1;
          const float w = __shfl_sync(0xffffffffu, v, src);
          if (!(w < L[k - 1])) continue;  // the list's last entry fell meanwhile
          // insertion point: entries <= w stay, the rest move one place up
          int pos = 0;
          for (int q = 0; q < k; q += 32)
            pos += __popc(__ballot_sync(0xffffffffu, q + lane < k && L[q + lane] <= w));
          float moved[KMAX / 32];
#pragma unroll
          for (int q = 0; q < KMAX / 32; ++q) {
            const int j = lane + 32 * q;
            moved[q] = (j < k && j > pos) ? L[j - 1] : 0.f;
          }
          __syncwarp();
#pragma unroll
          for (int q = 0; q < KMAX / 32; ++q) {
            const int j = lane + 32 * q;
            if (j == pos) L[j] = w;
            else if (j < k && j > pos) L[j] = moved[q];
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
  }
  for (int rr = tid; rr < BM_KNN; rr += THREADS) {
    const int r = row0 + rr;
    if (r < n) out[r] = sqrtf(fmaxf(list[rr * k + k - 1], 0.f));
  }
}

__global__ void __launch_bounds__(THREADS)
stats_kernel(const float* __restrict__ ref, const float* __restrict__ sq_r,
             const float* __restrict__ rr, int n_ref, const float* __restrict__ cand,
             const float* __restrict__ sq_c, const float* __restrict__ cr, int n_cand, int d,
             int* __restrict__ cand_any, int* __restrict__ cand_count,
             int* __restrict__ ref_any, float* __restrict__ ref_min) {
  __shared__ float As[BK][BM_ST + 1];
  __shared__ float Bs[BK][BN_ST + 1];
  __shared__ int s_cany[BN_ST], s_ccount[BN_ST], s_rany[BM_ST], s_rmin[BM_ST];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * BM_ST, col0 = blockIdx.x * BN_ST;
  if (tid < BN_ST) { s_cany[tid] = 0; s_ccount[tid] = 0; }
  if (tid < BM_ST) { s_rany[tid] = 0; s_rmin[tid] = __float_as_int(CUDART_INF_F); }

  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += BK) {
    load_slab<BM_ST>(ref, n_ref, d, row0, k0, As);
    load_slab<BN_ST>(cand, n_cand, d, col0, k0, Bs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float r_rad[4], r_sq[4], c_rad[4], c_sq[4];
  bool r_ok[4], c_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    r_ok[i] = r < n_ref;
    r_sq[i] = r_ok[i] ? sq_r[r] : 0.f;
    r_rad[i] = r_ok[i] ? rr[r] : -1.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col0 + tx + 16 * j;
    c_ok[j] = c < n_cand;
    c_sq[j] = c_ok[j] ? sq_c[c] : 0.f;
    c_rad[j] = c_ok[j] ? cr[c] : -1.f;
  }
  int c_any[4] = {}, c_cnt[4] = {}, r_any[4] = {};
  float r_mn[4] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!(r_ok[i] && c_ok[j])) continue;
      const float dist = sqrtf(sq_dist(r_sq[i], c_sq[j], acc[i][j]));
      const int in_ref = dist < r_rad[i];   // candidate j inside reference i's ball
      c_any[j] |= in_ref;
      c_cnt[j] += in_ref;
      r_any[i] |= dist < c_rad[j];          // reference i inside candidate j's ball
      r_mn[i] = fminf(r_mn[i], dist);
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c_any[j]) atomicOr(&s_cany[tx + 16 * j], 1);
    if (c_cnt[j]) atomicAdd(&s_ccount[tx + 16 * j], c_cnt[j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r_any[i]) atomicOr(&s_rany[ty + 16 * i], 1);
    if (r_ok[i]) atomicMin(&s_rmin[ty + 16 * i], __float_as_int(r_mn[i]));
  }
  __syncthreads();
  if (tid < BN_ST) {
    const int c = col0 + tid;
    if (c < n_cand) {
      if (s_cany[tid]) atomicOr(cand_any + c, 1);
      if (s_ccount[tid]) atomicAdd(cand_count + c, s_ccount[tid]);
    }
  } else if (tid < BN_ST + BM_ST) {
    const int t = tid - BN_ST, r = row0 + t;
    if (r < n_ref) {
      if (s_rany[t]) atomicOr(ref_any + r, 1);
      // non-negative floats order as their int bits
      atomicMin(reinterpret_cast<int*>(ref_min) + r, s_rmin[t]);
    }
  }
}

}  // namespace

// x: (n, d) f32, sq: (n,) f32 squared row norms; out: (n,) f32 radii =
// sqrt of the k-th smallest squared distance of each row (self included).
extern "C" int am_knn_radii(const float* x, const float* sq, int n, int d, int k, float* out,
                            cudaStream_t stream) {
  if (k < 1 || k > KMAX || k > n) return (int)cudaErrorInvalidValue;
  const int smem = BM_KNN * k * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  knn_kernel<<<(n + BM_KNN - 1) / BM_KNN, THREADS, smem, stream>>>(x, sq, n, d, k, out);
  return (int)cudaGetLastError();
}

// ref: (n_ref, d), cand: (n_cand, d) f32 with squared norms and radii.
// Outputs, initialised by the caller: cand_any, cand_count, ref_any to 0,
// ref_min to +inf.
extern "C" int am_prdc_stats(const float* ref, const float* sq_r, const float* rr, int n_ref,
                             const float* cand, const float* sq_c, const float* cr, int n_cand,
                             int d, int* cand_any, int* cand_count, int* ref_any, float* ref_min,
                             cudaStream_t stream) {
  dim3 grid((n_cand + BN_ST - 1) / BN_ST, (n_ref + BM_ST - 1) / BM_ST);
  stats_kernel<<<grid, THREADS, 0, stream>>>(ref, sq_r, rr, n_ref, cand, sq_c, cr, n_cand, d,
                                             cand_any, cand_count, ref_any, ref_min);
  return (int)cudaGetLastError();
}
