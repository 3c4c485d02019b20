// Swin 2x2 patch merge with the LayerNorm folded into the reduction.
//
// Replaces the TPU kernel audio_metrics_tpu/ops/merge.py::patch_merge_pallas
// (pallas_call at :138, kernel _kernel :51): quadrant order
// [x00, x10, x01, x11] (x_yx: y row offset, x column offset), centered LN
// statistics of the virtual 4C concat row, out = rs * (concat @ Wg) +
// (tvec - mu*rs*svec).
//
// What bounds it here: one (B*(R/2)^2, 4C) x (4C, 2C) bf16 product per
// merge, ~1 KFLOP per byte of activation at C >= 128, so the tensor cores;
// the bytes (x once, out once, Wg) bind only against the card's full bf16
// rate.  The first design (gemm.cuh's WMMA core) ran at ~25x its bound: 64 x 64
// single-buffered WMMA tiles, and every one of a row tile's 2C/64 column
// blocks recomputed that tile's LN statistics.  This one:
//   1. merge_stats_kernel, one warp per output row: the four quadrants of
//      the row (4C values, read straight from the (B, R, R, C) layout), the
//      centered two-pass f32 statistics, mean and 1/sigma written once;
//   2. the product on the wgmma core (gemm_sm90.cuh, EPI_MERGE) with A read
//      through a 4-D TMA map of the unmerged tokens, so the concat never
//      exists in memory.  Seen as rows of 2C (a horizontal pixel pair, the
//      JAX wrapper's free (B, R, R/2, 2C) bitcast), quadrant (dy, dx) of
//      output row (b, i2, j2) is row (b*R/2 + i2, dy, j2), columns
//      dx*C .. dx*C + C-1.  Map dims, innermost first: 2C channels; j2, R/2
//      of them, stride 2C; dy, stride R*C; b*R/2 + i2, stride 2RC.  A box
//      (64, R/2, 1, 128/(R/2)) is a 128-row x 64-channel K-major tile of
//      whole output grid rows (R/2 divides 128), the layout and swizzle
//      every other product of the core reads; rows past M come zero-filled
//      and the epilogue drops them.  A K step reads one quadrant, or, where
//      C % 64 == 32 (HTSAT-tiny's C = 96: a step of 64 would straddle two
//      quadrants), the steps run over the quadrants dy-major, [x00, x01,
//      x10, x11], so that each lies in one 2C pixel-pair row; the weight's
//      K order is the same (ops/merge.py merge_k_order).  The map's geometry and the box
//      coordinates of every K step come from one table of the Python
//      wrapper (ops/merge.py merge_a_map), which the CPU tests materialise
//      with torch.as_strided; the core's producer loads through MergeA,
//      which only reads that table;
//   3. the epilogue: acc*rs + (tvec - mu*rs*svec), the plain version's
//      order, bf16 out.
//
// am_patch_merge_f32, the f32 counterpart (the JAX kernel takes the
// activation dtype): the same statistics pass in f32, then the product on
// the tensor cores as three TF32 products (gemm_tf32x3_sm90.cuh, f32-level
// accuracy) with A read through the same 4-D map in f32 elements: a K step
// of 32 f32 is 128 bytes, as 64 bf16, and lies in one quadrant (C % 32 ==
// 0); the weight is read as its TF32 hi and lo parts, split at load; the
// EPI_MERGE epilogue in f32.
#include "gemm_tf32x3_sm90.cuh"

namespace {

constexpr int STATS_WARPS = 8;
constexpr int MERGE_STEPS_MAX = 64;  // K steps: C <= 1024 in bf16, <= 512 in f32 (check_merge_*)

// The core's loader of A's tile: K step k of row tile mt reads the box at
// the coordinates origin[k] of the 4-D map, the outermost moved by mt whole
// boxes (tile_rows grid rows).
struct MergeA {
  int tile_rows;
  int origin[MERGE_STEPS_MAX][4];
  __device__ __forceinline__ void operator()(void* dst, const CUtensorMap* map, int k, int mt,
                                             int, uint64_t* bar) const {
    sm90::tma_load_4d(dst, map, origin[k][0], origin[k][1], origin[k][2],
                      origin[k][3] + mt * tile_rows, bar);
  }
};

// Output row r = (b, i2, j2) of the (R/2)^2 grid: mean and 1/sigma of its 4C
// concat values of T (bf16 or f32; centered two-pass, f32; the second pass
// re-reads the row from L1).  16-byte loads; C % 8 == 0.
template <typename T>
__global__ void __launch_bounds__(STATS_WARPS * 32)
    merge_stats_kernel(const T* __restrict__ x, int M, int R, int C, float eps,
                       float* __restrict__ mu, float* __restrict__ rs) {
  constexpr int VEC = 16 / sizeof(T);
  const int r = blockIdx.x * STATS_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= M) return;
  const int h2 = R / 2, img = r / (h2 * h2), q = r - img * h2 * h2;
  const int i2 = q / h2, j2 = q - i2 * h2;
  // x00 of the row; quadrant (dy, dx = 0..1) starts dy*R*C further, its two
  // pixels side by side (2C contiguous values)
  const T* x00 = x + ((long long)(img * R + 2 * i2) * R + 2 * j2) * C;
  float s = 0.f;
  for (int dy = 0; dy < 2; ++dy)
    for (int k = lane * VEC; k < 2 * C; k += 32 * VEC)
      add16<T>(*reinterpret_cast<const uint4*>(x00 + (long long)dy * R * C + k), s);
  const float m = warp_sum(s) / (4 * C);
  float v = 0.f;
  for (int dy = 0; dy < 2; ++dy)
    for (int k = lane * VEC; k < 2 * C; k += 32 * VEC)
      sq16<T>(*reinterpret_cast<const uint4*>(x00 + (long long)dy * R * C + k), m, v);
  const float inv = rsqrtf(warp_sum(v) / (4 * C) + eps);  // every lane shuffles
  if (lane == 0) {
    mu[r] = m;
    rs[r] = inv;
  }
}

}  // namespace

// x: (B, R*R, C) bf16; wg_t: (2C, 4C) bf16, the (4, C, 2C) blocks transposed
// (K-major); svec, tvec: (2C) f32; stats: (2, M) f32 scratch; out: (B,
// (R/2)^2, 2C) bf16.  The A map: dims d0..d3 and box b0..b3 innermost first,
// strides s1..s3 in elements; origin: host int32 (4C / 64, 4), each K step's
// box coordinates in row tile 0.  Shapes checked by ops/merge.py
// (check_merge_gemm): R/2 divides 128, C % 32 == 0, C <= 1024.
extern "C" int am_patch_merge(const bf16* x, const bf16* wg_t, const float* svec,
                              const float* tvec, int B, int R, int C, float eps, float* stats,
                              bf16* out, int d0, int d1, int d2, int d3, int s1, int s2, int s3,
                              int b0, int b1, int b2, int b3, const int* origin,
                              cudaStream_t stream) {
  using namespace sm90;
  const int M = B * (R / 2) * (R / 2);
  merge_stats_kernel<bf16><<<(M + STATS_WARPS - 1) / STATS_WARPS, STATS_WARPS * 32, 0, stream>>>(
      x, M, R, C, eps, stats, stats + M);
  int e;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  CUtensorMap ta;
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2, (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2, (cuuint64_t)s3 * 2};
  const cuuint32_t box[4] = {(cuuint32_t)b0, (cuuint32_t)b1, (cuuint32_t)b2, (cuuint32_t)b3};
  if ((e = encode_map(&ta, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, dims, strides, box)))
    return e;
  const int ksteps = 4 * C / sm90::BK;
  if (ksteps > MERGE_STEPS_MAX) return (int)cudaErrorInvalidValue;
  MergeA load_a = {b3};
  for (int k = 0; k < ksteps; ++k)
    for (int i = 0; i < 4; ++i) load_a.origin[k][i] = origin[4 * k + i];
  EpiParams p = {};
  p.M = M; p.N = 2 * C; p.out = out; p.ldo = 2 * C;
  p.v0 = tvec; p.csum = svec; p.mu = stats; p.rs = stats + M;
  return gemm_mapped<EPI_MERGE>(ta, load_a, rows_of(wg_t, 2 * C, 4 * C, 4 * C), p, 4 * C, 1,
                                stream);
}

// x: (B, R*R, C) f32; wg_s: (2, 2C, 4C) f32, the K-major weight's TF32 hi
// over lo parts; svec, tvec: (2C) f32; stats: (2, M) f32 scratch; out: (B,
// (R/2)^2, 2C) f32.  The A map and origin as am_patch_merge's, in f32
// elements and K steps of 32.  Shapes checked by ops/merge.py
// (check_merge_f32): R/2 divides 128, C % 32 == 0, C <= 512.
extern "C" int am_patch_merge_f32(const float* x, const float* wg_s, const float* svec,
                                  const float* tvec, int B, int R, int C, float eps,
                                  float* stats, float* out, int d0, int d1, int d2, int d3,
                                  int s1, int s2, int s3, int b0, int b1, int b2, int b3,
                                  const int* origin, cudaStream_t stream) {
  using namespace tf32x3;
  const int M = B * (R / 2) * (R / 2);
  merge_stats_kernel<float><<<(M + STATS_WARPS - 1) / STATS_WARPS, STATS_WARPS * 32, 0,
                              stream>>>(x, M, R, C, eps, stats, stats + M);
  int e;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  CUtensorMap ta;
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2, (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)s1 * 4, (cuuint64_t)s2 * 4, (cuuint64_t)s3 * 4};
  const cuuint32_t box[4] = {(cuuint32_t)b0, (cuuint32_t)b1, (cuuint32_t)b2, (cuuint32_t)b3};
  if ((e = sm90::encode_map(&ta, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dims, strides, box)))
    return e;
  const int ksteps = 4 * C / tf32x3::BK;
  if (ksteps > MERGE_STEPS_MAX) return (int)cudaErrorInvalidValue;
  MergeA load_a = {b3};
  for (int k = 0; k < ksteps; ++k)
    for (int i = 0; i < 4; ++i) load_a.origin[k][i] = origin[4 * k + i];
  EpiF32 p = {};
  p.M = M; p.N = 2 * C; p.out = out; p.ldo = 2 * C;
  p.v0 = tvec; p.csum = svec; p.mu = stats; p.rs = stats + M;
  return gemm_mapped<EPI_MERGE>(ta, load_a, split_of(wg_s, 2 * C, 4 * C), p, 4 * C, stream);
}
