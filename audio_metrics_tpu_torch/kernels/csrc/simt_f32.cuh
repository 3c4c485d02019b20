// f32 product loop on the CUDA cores of the PRDC distance kernels (#4, #5,
// distance.cu).
//
// Why the CUDA cores: #4 and #5 hold the plain version's own f32 rounding
// of a distance that cancels (|a|^2 + |b|^2 - 2 a.b on the clustered CLAP
// embeddings, where the plain f32 version is itself up to 3.3e-5 from
// float64), so their products sum in the plain version's depth order, one
// f32 FMA at a time, and their radii come out bitwise equal to it.  A
// tensor-core product (3xTF32 on mma.sync) rounds otherwise and left 32 of
// 2048 main-path radii outside rtol 1e-4.  The f32 Swin block and patch
// merge, which have no bitwise contract, run on the 3xTF32 tensor-core core
// instead (gemm_tf32x3_sm90.cuh).
//
// The loop (tile_products): a 128 x 128 tile of A . B^T, both operands
// K-major (rows of K contiguous floats, K % 4 == 0), 32-deep stages brought
// to shared memory by cp.async, double-buffered; thread (ty, tx) of a
// 16 x 16 grid holds an 8 x 8 register tile, rows ty + 16 i and columns
// tx + 16 j, each an f32 FMA chain in depth order from 0; ragged edges are
// zero-filled by cp.async.  Where A's rows come from is a loader policy
// (RowsF32: rows of a matrix); #4 and #5 read plain rows through
// tile_products(a, na, ...).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace
