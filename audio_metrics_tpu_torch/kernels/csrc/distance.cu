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
// d < r comparisons.
//
// knn (redesigned for Hopper; the first design, one block of 32 rows
// sweeping every column with a 2 x 4 register tile over 16-deep scalar
// slabs, filled 64 of 132 SMs at N = 2048 and ran slower than cuBLAS +
// topk):
//   - the columns are split across blocks: block (row tile, split) takes 128
//     query rows against the 128-column tiles of its split (ops/distance.py
//     column_splits: about four blocks per SM), so N = 2048 gives 256 blocks;
//   - the dot products are f32 FMAs on the CUDA cores, each summed in depth
//     order from 0, as the plain version's f32 product (cuBLAS) sums it, on
//     the squared norms it uses: on unit embeddings in a tight cluster
//     (the main path's, radii ~0.05) |a|^2 + |b|^2 - 2 a.b cancels so far
//     that 3xTF32 mma.sync products (~2^-21 relative per product) left 32
//     of 2048 radii outside rtol 1e-4 / atol 1e-5 of the plain version's on
//     the card (max 2.6e-5), and rows centered on their mean 21.  An 8 x 8
//     register tile per
//     thread over 16-byte shared reads; tiles reach shared memory by
//     cp.async, double-buffered;
//   - each tile's distances go through shared memory to one warp per row.
//     A row keeps a list of its k smallest so far and their maximum t; a
//     tile with no value below t leaves it (one vote); otherwise the warp
//     finds the k-th smallest t' of list and tile by bisection on the float
//     bits over [min, t] (a compare per value and one warp sum a step, four
//     rows side by side so that their warp sums overlap; no serial
//     insertion) and keeps the values below t' and copies of t' up to k.
//     Ties count with multiplicity, so t' is the k-th order statistic
//     whatever the tie order.  Each block writes its rows' lists;
//     knn_merge_kernel takes the k-th smallest of a row's lists of all
//     splits the same way, and its sqrt.
// stats (redesigned for Hopper on knn's product loop; the first design, 64 x
// 64 SIMT tiles over 16-deep scalar slabs without cp.async, read 0.2551 ms
// at N = M = 2048, d = 512 on an H100, and at 20480 no faster than its
// plain version):
// ONE sweep gives all four reductions (the TPU needed two one-sided sweeps
// because its grid accumulates only along its fastest axis).  Blocks
// (reference row tile, candidate column split), sized as knn's
// (ops/distance.py column_splits: N = M = 2048 gives 256 blocks, one
// 128 x 128 tile each); each tile's products are knn's tile_products, so
// every distance rounds as the kNN radii's and the plain version's do.  The
// distances go through shared memory; a thread per column and a thread per
// row reduce them, and each block makes one global atomic per row or per
// column of a tile: atomicOr for the two anys, atomicAdd for the int32
// count, atomicMin on the bits of the non-negative float min.  All four are
// order independent, so the result is deterministic.
// Both: the ragged edge is masked by index (no +inf padding rows); a
// radius below 0 matches nothing; d < r is compared after the sqrt,
// strictly, as the TPU kernel does (comparing d^2 < r^2 flips near-ties);
// offsets are 64-bit: N*d may pass 2^31.
#include <math_constants.h>

#include "simt_f32.cuh"

namespace {

constexpr int KMAX = 128;       // widest k-smallest list (the TPU scratch's width)

// The product loop's tiles (simt_f32.cuh, 128 x 128, 32-deep stages) are
// reused for the 128 x 129 distance tile; then knn's (128, k) lists, or
// stats' radii of the tile's rows and columns.
constexpr int DPITCH = KNN_BN + 1;
static_assert(KNN_BM * DPITCH <= TILE_FLOATS, "the distance tile reuses the stages");
constexpr int MERGE_WARPS = 8;

// f32 squared distance exactly as the TPU kernel's formula orders it:
// (|a|^2 + |b|^2) - 2 a.b, clamped at 0, no fused multiply-add.
__device__ __forceinline__ float sq_dist(float sa, float sb, float dot) {
  return fmaxf(__fsub_rn(__fadd_rn(sa, sb), __fmul_rn(2.f, dot)), 0.f);
}

// Bisection on the float bits for the k-th smallest, with multiplicity, of
// each of ROWS value sets (non-negative or +inf floats, whose bits order as
// the floats): for set q the least t in [lo[q], hi[q]] with count(q, t) =
// #{v <= t} >= k, where count sums over the warp.  The ROWS bisections run
// side by side (independent warp sums in flight); every lane gets each t.
template <int ROWS, typename Count>
__device__ __forceinline__ void bisect_kth(uint32_t (&lo)[ROWS], uint32_t (&hi)[ROWS], int k,
                                           Count count) {
  int steps = 0;  // bit length of the widest interval: enough halvings for all
#pragma unroll
  for (int q = 0; q < ROWS; ++q) steps = max(steps, 32 - __clz(hi[q] - lo[q]));
  for (int s = 0; s < steps; ++s)
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const uint32_t mid = lo[q] + (hi[q] - lo[q]) / 2;
      if (__reduce_add_sync(0xffffffffu, count(q, mid)) >= (unsigned)k) hi[q] = mid;
      else lo[q] = mid + 1;
    }
}

constexpr int SEL_ROWS = 4;  // rows a warp selects together

// Block (row tile, split): the k smallest squared distances of each of its
// rows to the columns [split * split_cols, +split_cols) of x, in no order,
// into lists (n, splits, k) (+inf where the split has fewer than k columns).
// A row's list and its k-th smallest t live in shared memory; a tile with a
// value below t makes the row's warp take the k-th smallest t' of list and
// tile together, and keep every value below t' and copies of t' up to k.
// VL = ceil(k / 32): the list's values per lane.
template <int VL>
__global__ void __launch_bounds__(THREADS, 2)
knn_split_kernel(const float* __restrict__ x, const float* __restrict__ sq, int n, int d, int k,
                 int split_cols, float* __restrict__ lists) {
  extern __shared__ float smem[];
  float* tiles = smem;                    // two stages; then the distance tile
  float* kth = smem + TILE_FLOATS;        // (KNN_BM,) each list's k-th smallest
  float* list = kth + KNN_BM;             // (KNN_BM, k)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;  // rows ty + 16 i, columns tx + 16 j
  const int row0 = blockIdx.x * KNN_BM, split = blockIdx.y;
  const int c_begin = split * split_cols, c_end = min(n, c_begin + split_cols);
  for (int i = tid; i < KNN_BM * (k + 1); i += THREADS) kth[i] = CUDART_INF_F;

  for (int col0 = c_begin; col0 < c_end; col0 += KNN_BN) {
    float acc[TM][TM];
    tile_products(x, n, x, n, d, row0, col0, tiles, acc);

    // distances -> the tile; columns past the split are +inf
    float* D = tiles;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int col = tx + 16 * j, c = col0 + col;
      const float sb = c < c_end ? sq[c] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = row0 + ty + 16 * i;
        D[(ty + 16 * i) * DPITCH + col] =
            c < c_end ? sq_dist(r < n ? sq[r] : 0.f, sb, acc[i][j]) : CUDART_INF_F;
      }
    }
    __syncthreads();
    for (int r0 = warp * SEL_ROWS; r0 < KNN_BM; r0 += THREADS / 32 * SEL_ROWS) {
      constexpr int V = VL + KNN_BN / 32;
      float v[SEL_ROWS][V];
      bool below = false;
#pragma unroll
      for (int q = 0; q < SEL_ROWS; ++q)
#pragma unroll
        for (int h = 0; h < KNN_BN / 32; ++h) {
          v[q][VL + h] = D[(r0 + q) * DPITCH + lane + 32 * h];
          below |= v[q][VL + h] < kth[r0 + q];
        }
      if (!__any_sync(0xffffffffu, below)) continue;  // the lists stay
      // the union of list and tile; its k-th lies in [min, t], and below the
      // largest finite value when at least k are finite
      uint32_t lo[SEL_ROWS], hi[SEL_ROWS];
#pragma unroll
      for (int q = 0; q < SEL_ROWS; ++q) {
        const float* L = list + (r0 + q) * k;
        uint32_t mn = 0xffffffffu, mx = 0, finite = 0;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (j < VL) v[q][j] = lane + 32 * j < k ? L[lane + 32 * j] : CUDART_INF_F;
          const uint32_t b = __float_as_uint(v[q][j]);
          mn = min(mn, b);
          if (b < 0x7f800000u) {
            mx = max(mx, b);
            ++finite;
          }
        }
        lo[q] = __reduce_min_sync(0xffffffffu, mn);
        hi[q] = __float_as_uint(kth[r0 + q]);
        if (__reduce_add_sync(0xffffffffu, finite) >= (unsigned)k)
          hi[q] = min(hi[q], __reduce_max_sync(0xffffffffu, mx));
      }
      bisect_kth<SEL_ROWS>(lo, hi, k, [&](int q, uint32_t t) {
        unsigned c = 0;
#pragma unroll
        for (int j = 0; j < V; ++j) c += __float_as_uint(v[q][j]) <= t;
        return c;
      });
      __syncwarp();  // every lane has read the lists
#pragma unroll
      for (int q = 0; q < SEL_ROWS; ++q) {  // keep the values below t, then copies of t
        const float t = __uint_as_float(lo[q]);
        float* L = list + (r0 + q) * k;
        int kept = 0;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const unsigned m = __ballot_sync(0xffffffffu, v[q][j] < t);
          if (v[q][j] < t) L[kept + __popc(m & ((1u << lane) - 1))] = v[q][j];
          kept += __popc(m);
        }
        for (int i = kept + lane; i < k; i += 32) L[i] = t;
        if (lane == 0) kth[r0 + q] = t;
      }
      __syncwarp();
    }
    __syncthreads();  // the tile is the next tile's stage 0
  }
  const int splits = gridDim.y;
  for (int i = tid; i < KNN_BM * k; i += THREADS) {
    const int rr = i / k, j = i - rr * k, r = row0 + rr;
    if (r < n) lists[((size_t)r * splits + split) * k + j] = list[i];
  }
}

// One warp per row: the k-th smallest, with multiplicity, of the row's
// `splits` lists (bisect_kth, reading the lists from L1 at each step); out =
// its sqrt.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
knn_merge_kernel(const float* __restrict__ lists, int n, int splits, int k,
                 float* __restrict__ out) {
  const int r = blockIdx.x * MERGE_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= n) return;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(lists) + (size_t)r * splits * k;
  uint32_t lo[1] = {0}, hi[1] = {0x7f800000u};  // [0, +inf]
  bisect_kth<1>(lo, hi, k, [&](int, uint32_t t) {
    unsigned c = 0;
    for (int i = lane; i < splits * k; i += 32) c += src[i] <= t;
    return c;
  });
  if (lane == 0) out[r] = sqrtf(__uint_as_float(lo[0]));
}

// Block (row tile, split): the four reductions over reference rows row0..
// +127 against the candidate columns [split * split_cols, +split_cols).
// Each 128 x 128 tile's products come from tile_products; its distances
// d = sqrt(max((|a|^2 + |b|^2) - 2 a.b, 0)) go through shared memory (+inf
// outside the reference rows and the split's columns, which matches
// nothing and is no minimum).  Then threads 0-127 each take a column of
// the tile: any and count of d < ref_r over its 128 rows, one atomicOr and
// one atomicAdd on the column; threads 128-255 each a row: any of d <
// cand_r and min d over the tile's columns, carried across the split's
// tiles in registers, one atomicOr and one atomicMin (on the bits of the
// non-negative float) on the row at the end.
__global__ void __launch_bounds__(THREADS, 2)
stats_split_kernel(const float* __restrict__ ref, const float* __restrict__ sq_r,
                   const float* __restrict__ rr, int n_ref, const float* __restrict__ cand,
                   const float* __restrict__ sq_c, const float* __restrict__ cr, int n_cand,
                   int d, int split_cols, int* __restrict__ cand_any,
                   int* __restrict__ cand_count, int* __restrict__ ref_any,
                   float* __restrict__ ref_min) {
  extern __shared__ float smem[];
  float* tiles = smem;                  // two stages; then the distance tile
  float* r_rad = smem + TILE_FLOATS;    // (KNN_BM,) the tile's reference radii
  float* c_rad = r_rad + KNN_BM;        // (KNN_BN,) its candidate radii
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * KNN_BM, split = blockIdx.y;
  const int c_begin = split * split_cols, c_end = min(n_cand, c_begin + split_cols);
  if (tid < KNN_BM) r_rad[tid] = row0 + tid < n_ref ? rr[row0 + tid] : -1.f;
  int any_r = 0;                        // threads 128-255: row tid - 128
  float min_r = CUDART_INF_F;

  for (int col0 = c_begin; col0 < c_end; col0 += KNN_BN) {
    if (tid < KNN_BN) c_rad[tid] = col0 + tid < c_end ? cr[col0 + tid] : -1.f;
    float acc[TM][TM];
    tile_products(ref, n_ref, cand, n_cand, d, row0, col0, tiles, acc);

    float* D = tiles;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int col = tx + 16 * j, c = col0 + col;
      const float sb = c < c_end ? sq_c[c] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = row0 + ty + 16 * i;
        D[(ty + 16 * i) * DPITCH + col] =
            c < c_end && r < n_ref ? sqrtf(sq_dist(sq_r[r], sb, acc[i][j])) : CUDART_INF_F;
      }
    }
    __syncthreads();
    if (tid < KNN_BN) {  // column tid: candidate inside reference balls
      int count = 0;
      for (int i = 0; i < KNN_BM; ++i) count += D[i * DPITCH + tid] < r_rad[i];
      const int c = col0 + tid;
      if (c < c_end && count) {
        atomicOr(cand_any + c, 1);
        atomicAdd(cand_count + c, count);
      }
    } else {  // row tid - 128: reference inside candidate balls, nearest candidate
      const float* row = D + (tid - KNN_BN) * DPITCH;
      for (int j = 0; j < KNN_BN; ++j) {
        any_r |= row[j] < c_rad[j];
        min_r = fminf(min_r, row[j]);
      }
    }
    __syncthreads();  // the tile is the next tile's stage 0, c_rad its radii
  }
  const int r = row0 + tid - KNN_BN;
  if (tid >= KNN_BN && r < n_ref) {
    if (any_r) atomicOr(ref_any + r, 1);
    // non-negative floats order as their int bits
    atomicMin(reinterpret_cast<int*>(ref_min) + r, __float_as_int(min_r));
  }
}

}  // namespace

// x: (n, d) f32, d % 4 == 0; sq: (n,) f32 squared row norms; lists:
// (n, splits, k) f32 scratch; out: (n,) f32 radii = sqrt of the k-th
// smallest squared distance of each row (self included).  split_cols: a
// multiple of 128, splits * split_cols >= n (ops/distance.py column_splits).
extern "C" int am_knn_radii(const float* x, const float* sq, int n, int d, int k, int splits,
                            int split_cols, float* lists, float* out, cudaStream_t stream) {
  if (k < 1 || k > KMAX || k > n || d % 4 || split_cols % KNN_BN ||
      (long long)splits * split_cols < n)
    return (int)cudaErrorInvalidValue;
  const int vl = (k + 31) / 32;
  const auto kernel = vl == 1 ? knn_split_kernel<1> : vl == 2 ? knn_split_kernel<2>
                    : vl == 3 ? knn_split_kernel<3> : knn_split_kernel<4>;
  const int smem = (TILE_FLOATS + KNN_BM * (k + 1)) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((n + KNN_BM - 1) / KNN_BM, splits), THREADS, smem, stream>>>(x, sq, n, d, k,
                                                                          split_cols, lists);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  knn_merge_kernel<<<(n + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0, stream>>>(
      lists, n, splits, k, out);
  return (int)cudaGetLastError();
}

// ref: (n_ref, d), cand: (n_cand, d) f32 (d % 4 == 0) with squared norms and
// radii.  split_cols: a multiple of 128, splits * split_cols >= n_cand
// (ops/distance.py column_splits).  Outputs, initialised by the caller:
// cand_any, cand_count, ref_any to 0, ref_min to +inf.
extern "C" int am_prdc_stats(const float* ref, const float* sq_r, const float* rr, int n_ref,
                             const float* cand, const float* sq_c, const float* cr, int n_cand,
                             int d, int splits, int split_cols, int* cand_any, int* cand_count,
                             int* ref_any, float* ref_min, cudaStream_t stream) {
  if (d % 4 || split_cols % KNN_BN || (long long)splits * split_cols < n_cand)
    return (int)cudaErrorInvalidValue;
  const int smem = (TILE_FLOATS + KNN_BM + KNN_BN) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(stats_split_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  stats_split_kernel<<<dim3((n_ref + KNN_BM - 1) / KNN_BM, splits), THREADS, smem, stream>>>(
      ref, sq_r, rr, n_ref, cand, sq_c, cr, n_cand, d, split_cols, cand_any, cand_count,
      ref_any, ref_min);
  return (int)cudaGetLastError();
}
