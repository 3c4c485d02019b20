// f32 product core on the CUDA cores: the PRDC distance kernels (#4, #5,
// distance.cu) and the f32 Swin block (#1) and patch merge (#2)
// (swin_block.cu, patch_merge.cu).
//
// Hopper has no full-f32 tensor-core product: TF32 keeps 10 mantissa bits
// (~5e-4 relative), ten times the JAX suite's f32 kernel bound (5e-5), so
// every f32 product here is SIMT f32 FMAs, at most 67 TFLOP/s on an H100.
//
// The loop (tile_products): a 128 x 128 tile of A . B^T, both operands
// K-major (rows of K contiguous floats, K % 4 == 0), 32-deep stages brought
// to shared memory by cp.async, double-buffered; thread (ty, tx) of a
// 16 x 16 grid holds an 8 x 8 register tile, rows ty + 16 i and columns
// tx + 16 j, each an f32 FMA chain in depth order from 0; ragged edges are
// zero-filled by cp.async.  Where A's rows come from is a loader policy
// (RowsF32: rows of a matrix; patch_merge.cu's MergeRowsF32: the 2x2
// quadrant concat gathered from the unmerged tokens).  #4 and #5 read plain
// rows through tile_products(a, na, ...), the loop they were written on.
//
// gemm_f32_kernel<EPI, ALoad>: one block per 128 x 128 output tile of
// out = epilogue(A @ B^T), B held (N x K); the epilogue applies the
// arithmetic of gemm_sm90.cuh's epilogue8 to each accumulator straight from
// its register, in f32 out: EPI_QKV (LN1 fold), EPI_PROJ (bias, window
// un-partition / un-roll, residual), EPI_GELU (exact erf), EPI_RESID,
// EPI_MERGE (merge LN fold).  Two blocks per SM (128 registers a thread,
// 72 KB of shared memory each).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"

namespace {

constexpr int THREADS = 256;

// 128 query rows x 128 columns per tile, depth steps of 32 floats; thread
// (ty, tx) of a 16 x 16 grid computes rows ty + 16 i and columns tx + 16 j
// (i, j < TM = 8).  Shared memory: two stages of the A and B tiles (rows
// padded to 36 floats), which a caller may reuse once tile_products returns.
constexpr int KNN_BM = 128, KNN_BN = 128, KNN_BK = 32, PITCH = KNN_BK + 4, TM = 8;
constexpr int STAGE_FLOATS = (KNN_BM + KNN_BN) * PITCH;
constexpr int TILE_FLOATS = 2 * STAGE_FLOATS;

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// A as rows of a (na, d) matrix: depths k..k+3 of row `row`, or null
// outside it.
struct RowsF32 {
  const float* a;
  int na, d;
  __device__ __forceinline__ const float* operator()(int row, int k) const {
    return row < na && k < d ? a + (size_t)row * d + k : nullptr;
  }
};

// One stage: rows row0.. of A (through `la`; the tile's A) and col0.. of b
// (nb rows; its B), depth k0..k0+31 (d % 4 == 0), zero outside.
template <class ALoad>
__device__ __forceinline__ void load_stage(float* st, const ALoad& la,
                                           const float* __restrict__ b, int nb, int d, int row0,
                                           int col0, int k0) {
  for (int i = threadIdx.x; i < (KNN_BM + KNN_BN) * (KNN_BK / 4); i += THREADS) {
    const int r = i / (KNN_BK / 4), kc = (i % (KNN_BK / 4)) * 4, k = k0 + kc;
    const int row = col0 + r - KNN_BM;
    const float* src = r < KNN_BM ? la(row0 + r, k)
                                  : (row < nb && k < d ? b + (size_t)row * d + k : nullptr);
    cp_async16(st + r * PITCH + kc, src ? src : b, src != nullptr);
  }
}

// The dot products of a 128 x 128 tile: rows row0.. of A (through `la`)
// against rows col0.. of b, each an f32 FMA chain in depth order from 0 (the
// order of the plain version's f32 product); acc[i][j] is row ty + 16 i,
// column tx + 16 j of the tile (ty = tid / 16, tx = tid % 16).  `tiles`
// holds two cp.async stages; free again when this returns.
template <class ALoad>
__device__ __forceinline__ void tile_products(const ALoad& la, const float* __restrict__ b,
                                              int nb, int d, int row0, int col0, float* tiles,
                                              float (&acc)[TM][TM]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ksteps = (d + KNN_BK - 1) / KNN_BK;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
  load_stage(tiles, la, b, nb, d, row0, col0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int ks = 0; ks < ksteps; ++ks) {
    if (ks + 1 < ksteps) {
      load_stage(tiles + ((ks + 1) & 1) * STAGE_FLOATS, la, b, nb, d, row0, col0,
                 (ks + 1) * KNN_BK);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* sA = tiles + (ks & 1) * STAGE_FLOATS + ty * PITCH;
    const float* sB = tiles + (ks & 1) * STAGE_FLOATS + (KNN_BM + tx) * PITCH;
#pragma unroll
    for (int kk = 0; kk < KNN_BK; kk += 4) {
      // four depths of each row and column, 16-byte reads (a warp's 16
      // columns 36 floats apart cover the 32 banks twice: no conflict
      // beyond the two wavefronts 256 bytes need), the columns in two
      // halves so that 64 sums, 4 + 1 float4 and the addresses fit in
      // the 128 registers two blocks per SM leave; each product is
      // summed in depth order, as the plain version's f32 product sums it
#pragma unroll
      for (int jh = 0; jh < TM; jh += TM / 2) {
        float4 bv[TM / 2];
#pragma unroll
        for (int j = 0; j < TM / 2; ++j)
          bv[j] = *reinterpret_cast<const float4*>(sB + 16 * (jh + j) * PITCH + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 av = *reinterpret_cast<const float4*>(sA + 16 * i * PITCH + kk);
#pragma unroll
          for (int j = 0; j < TM / 2; ++j) {
            float& c = acc[i][jh + j];
            c = fmaf(av.x, bv[j].x, c);
            c = fmaf(av.y, bv[j].y, c);
            c = fmaf(av.z, bv[j].z, c);
            c = fmaf(av.w, bv[j].w, c);
          }
        }
      }
    }
    __syncthreads();
  }
}

// Rows row0.. of a (na rows) against rows col0.. of b (nb rows), both (., d).
__device__ __forceinline__ void tile_products(const float* __restrict__ a, int na,
                                              const float* __restrict__ b, int nb, int d,
                                              int row0, int col0, float* tiles,
                                              float (&acc)[TM][TM]) {
  tile_products(RowsF32{a, na, d}, b, nb, d, row0, col0, tiles, acc);
}

// What the f32 epilogues read and write (gemm_sm90.cuh's EpiParams, f32).
struct EpiF32 {
  int M, N;
  float* out;
  int ldo;
  int R, win, shift;   // EPI_PROJ's window map
  const float* v0;     // bias
  const float* csum;   // EPI_QKV: column sums of W (1 @ W); EPI_MERGE: g @ W
  const float* mu;     // EPI_QKV, EPI_MERGE: LN mean and 1/sigma of each A row
  const float* rs;
  const float* res;    // residual
};

template <int EPI, class ALoad>
__global__ void __launch_bounds__(THREADS, 2)
    gemm_f32_kernel(const ALoad la, const float* __restrict__ b, int K, const EpiF32 p) {
  extern __shared__ float tiles[];
  const int row0 = blockIdx.x * KNN_BM, col0 = blockIdx.y * KNN_BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[TM][TM];
  tile_products(la, b, p.N, K, row0, col0, tiles, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r < p.M) {
      float rs = 0.f, mu = 0.f;
      if (EPI == EPI_QKV || EPI == EPI_MERGE) {
        rs = p.rs[r];
        mu = p.mu[r];
      }
      long long o = (long long)r * p.ldo;
      if (EPI == EPI_PROJ) {  // the row's place in the un-partitioned, un-rolled image
        const int rr2 = p.R * p.R, img = r / rr2;
        o = ((long long)img * rr2 + window_src(r - img * rr2, p.R, p.win, p.shift)) * p.ldo;
      }
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int n = col0 + tx + 16 * j;
        if (n < p.N) {
          const float a = acc[i][j], bias = p.v0[n];
          float v;
          if (EPI == EPI_QKV) {
            v = a * rs - rs * mu * p.csum[n] + bias;
          } else if (EPI == EPI_MERGE) {  // the plain version's order: acc*rs + (t - mu*rs*s)
            v = a * rs + (bias - mu * rs * p.csum[n]);
          } else if (EPI == EPI_GELU) {
            const float t = a + bias;
            v = 0.5f * t * (1.f + erff(t * 0.7071067811865476f));
          } else {  // EPI_PROJ, EPI_RESID: + bias + the f32 residual
            v = a + bias + p.res[o + n];
          }
          p.out[o + n] = v;
        }
      }
    }
  }
}

// out = epilogue(A @ B^T): A through `la` (p.M rows of depth K), B (p.N, K)
// f32, K % 4 == 0 (16-byte cp.async chunks).
template <int EPI, class ALoad>
cudaError_t gemm_f32(const ALoad& la, const float* b, int K, const EpiF32& p,
                     cudaStream_t stream) {
  if (K % 4) return cudaErrorInvalidValue;
  constexpr int smem = TILE_FLOATS * (int)sizeof(float);
  const auto kernel = gemm_f32_kernel<EPI, ALoad>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((p.M + KNN_BM - 1) / KNN_BM, (p.N + KNN_BN - 1) / KNN_BN), THREADS, smem,
           stream>>>(la, b, K, p);
  return cudaGetLastError();
}

}  // namespace
