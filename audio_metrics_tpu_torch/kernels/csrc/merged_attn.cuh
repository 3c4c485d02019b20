// The merged one-window form of the v1 and v2 attention halves (#10, #11):
// attention over one 256-token window a head (window = resolution = 16,
// HTSAT's stage 2 under AM_TPU_MERGED_ATTN) with an additive f32 table of
// (1, heads, 256, 256), D-wide heads, D = 32 (HTSAT-base) or 24 (HTSAT-tiny).
// It is the window attention of the TPU kernel audio_metrics_tpu/ops/
// attention.py::_attn_block_kernel (:111, pallas_call at :400) at window =
// resolution, where the JAX package scatters each window's bias and shift
// mask onto one dense table with -1e9 on the pairs of two windows
// (models/htsat.py::_merged_bias_mask).  The public ops take any such table.
//
// Rounding points as the TPU kernel's (:180-202): scores + table in f32,
// the row max subtracted in f32, the probabilities normalised in f32 and
// only then rounded to the activation dtype (no online softmax: it would
// round unnormalised probabilities), the context rounded to the activation
// dtype.
//
// What bounds it: at stage 2 of HTSAT-base (B = 64, 16 heads of 32) the
// attention reads 50 MB of qkv and writes 17 MB of context in bf16 (twice
// that in f32) for 2.1 GFLOP over the keys the model's table leaves live:
// bytes bind in both dtypes (0.020 ms bf16, 0.040 f32, against 0.002 of
// bf16 products and 0.013 of three TF32 products).  The dense design (every
// key, kernels/csrc/dense/merged_attn_dense.cu) did 4x that work and read
// the 4 MB table once per (image, head, 64 queries): 268 MB through L2 a
// launch.  This design:
//
// 1. A live-tile map made from the table's values (ops/attention.py
//    merged_live_tiles, once per table, held with the operands at load): a
//    key tile (8 keys) is dead for a block's 64 query rows when every table
//    entry there is <= -1e9 and no row of the block is <= -1e9 everywhere.
//    A dead entry's probability is then exp(-1e9 + s - max) = 0 in f32
//    (max comes from a live entry), so dropping its score, its exp, its
//    sum term and its P.V product leaves the result as it was.  A block
//    with a row masked everywhere lists all 32 tiles: its softmax spreads
//    over all 256 keys, as the dense form's does.  Per (head, block) the
//    map lists the live tiles in ascending order, padded with -1 to the
//    longest list, T (an entry outside [0, 32) ends a list).
// 2. Query rows grouped so that their live keys coincide: block (head,
//    patch) holds the 64 rows of one 8x8 patch of the (rolled) 16x16 image,
//    warp w its image rows 2w and 2w + 1 (one m16 tile).  At the model's
//    tables a patch is a window: its 64 rows share the window's 8 live
//    tiles, 25% of the keys (in raster order a warp's 16 rows, one image
//    row, span two windows: 16 of 32 tiles).  Rows are written back to
//    their raster positions.
// 3. Images innermost: a block serves one (head, patch) over ~4 images.
//    It reads its live table tiles once into shared memory (16 KB at 8
//    tiles, 64 KB at 32), then gathers each image's 64 q rows and its live
//    tiles' k and v rows one after another with cp.async, two stages deep
//    where the lists hold <= 8 tiles (one at 32, for want of room).
// 4. Scores of live tiles only, in registers: 8 tiles (32 accumulators a
//    thread) where T <= 8, else all 32 (128: the dense form's budget, which
//    it held without spills), so no second pass is needed.
// 5. P.V over the live keys at the mma's depth, grouped as the dense form
//    grouped them: f32 one m16n8k8 step a live tile; bf16 one m16n8k16 step
//    an aligned 16-key unit holding a live tile, its other half (if dead)
//    zero probabilities against a zero V tile (V read from row-major tiles
//    with ldmatrix.trans); each K step of the dense form (32 keys f32, 64
//    bf16) into a fresh accumulator, added in f32.  The sums thus group the
//    live keys' terms as the dense form does and leave out only its exact
//    zeros: the outputs are the dense form's bitwise.
//   bf16: products on mma.sync m16n8k16 (bf16 in, f32 accumulate); a head
//   of 24 is held as 32 columns whose last 8 are zero in q and k.
//   f32: three TF32 products on mma.sync m16n8k8, both operands split in
//   registers with the depth permutation of window_attn.cuh.
// No atomics: a run repeats bitwise.
#pragma once

#include "window_attn.cuh"

namespace {

constexpr int MERGED_N = 256;                       // tokens of the one window (16 x 16)
constexpr int MERGED_TILES = MERGED_N / 8;          // key tiles of 8 keys
constexpr int MERGED_QT = 64;                       // query rows a block: one 8x8 patch
constexpr int MERGED_PATCHES = MERGED_N / MERGED_QT;
constexpr int MERGED_BLOCKS = 1024;                 // blocks a launch aims at

// The raster index (in the rolled 16x16 image) of row b (0..63) of patch p:
// patch (p / 2, p % 2) of 8x8 tokens, its rows in raster order.
__device__ __forceinline__ int merged_token(int p, int b) {
  return ((p >> 1) * 8 + (b >> 3)) * 16 + (p & 1) * 8 + (b & 7);
}

// d += a.b, one m16n8k16 bf16 product accumulated in f32
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two f32 values rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously
__device__ __forceinline__ void merged_cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void merged_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void merged_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Four (x4) or two (x2) 8x8 bf16 matrices, transposed, from the rows each
// lane addresses (lanes 8m..8m+7 the rows of matrix m)
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// Shared memory of a merged kernel on elements E (bf16 or f32) and lists of
// T live tiles: the table tiles (f32, tab[(j*64 + b)*8 + k] = table row of
// patch row b, key 8*tile_j + k), then `stages` buffers each of q (64 rows)
// and of k and v (8T rows, tile j's keys at rows 8j..8j+7), then for bf16
// one zero tile of 8 v rows, then the list (32 ints).  Row pitches in
// elements, for conflict-free fragment reads: bf16 rows of 40 (80 bytes;
// ldmatrix's 8 rows fall in distinct banks), f32 window_attn.cuh's.
template <typename E, int D>
struct MergedSmem {
  static constexpr bool BF16 = sizeof(E) == 2;
  static constexpr int LQ = BF16 ? 40 : (D == 32 ? D + 8 : D);  // q and k
  static constexpr int LV = BF16 ? 40 : D + 4;
  static __host__ __device__ int table_floats(int T) { return T * MERGED_QT * 8; }
  static __host__ __device__ int stage_elems(int T) { return MERGED_QT * LQ + 8 * T * (LQ + LV); }
  static __host__ __device__ int bytes(int T, int stages) {
    return 4 * table_floats(T) + (int)sizeof(E) * (stages * stage_elems(T) + (BF16 ? 8 * LV : 0)) +
           4 * MERGED_TILES;
  }
};

// The block's list into `tiles` (its length returned: the entries before
// the first outside [0, 32)), and its table tiles on their way into `tab`
// by cp.async (committed with the first image's rows); head h's (256, 256)
// table at bm_h.
__device__ __forceinline__ int merged_prologue(const float* __restrict__ bm_h,
                                               const int* __restrict__ list, int T, int p,
                                               int* tiles, float* tab) {
  const int tid = threadIdx.x;
  if (tid < MERGED_TILES) tiles[tid] = tid < T ? list[tid] : -1;
  __syncthreads();
  int n = 0;
  while (n < MERGED_TILES && tiles[n] >= 0 && tiles[n] < MERGED_TILES) ++n;
  for (int idx = tid; idx < n * MERGED_QT * 2; idx += blockDim.x) {
    const int j = idx >> 7, b = (idx >> 1) & (MERGED_QT - 1), half = idx & 1;
    merged_cp16(tab + (j * MERGED_QT + b) * 8 + 4 * half,
                bm_h + (long long)merged_token(p, b) * MERGED_N + 8 * tiles[j] + 4 * half);
  }
  return n;
}

// One image's rows into a stage: the patch's 64 q rows, then the n live
// tiles' k and v rows one after another.  src: the image's qkv rows at head
// h's columns (q at +0, k at +C, v at +2C).
template <typename E, int D>
__device__ __forceinline__ void merged_load(const E* __restrict__ src, int C, int p,
                                            const int* tiles, int n, E* q, E* k, E* v) {
  using S = MergedSmem<E, D>;
  constexpr int VEC = 16 / sizeof(E), CH = D / VEC;  // 16-byte chunks of a head row
  const long long ld = 3LL * C;
  for (int idx = threadIdx.x; idx < MERGED_QT * CH; idx += blockDim.x) {
    const int b = idx / CH, c = idx % CH;
    merged_cp16(q + b * S::LQ + VEC * c, src + merged_token(p, b) * ld + VEC * c);
  }
  for (int idx = threadIdx.x; idx < 8 * n * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx % CH;
    const E* row = src + (8 * tiles[r >> 3] + (r & 7)) * ld + VEC * c;
    merged_cp16(k + r * S::LQ + VEC * c, row + C);
    merged_cp16(v + r * S::LV + VEC * c, row + 2 * C);
  }
}

// Scores s[j] (rows gr, gr + 8 of the warp's m16 tile, keys 2tq, 2tq + 1 of
// live tile j) + their table entries (tab: the warp's row gr of tile 0, at
// column 2tq), then the softmax over the n live tiles in f32, in place.
// The dense form's dead entries add exact zeros to its sums; their max
// never wins.
template <int LMAX>
__device__ __forceinline__ void merged_softmax(float (&s)[LMAX][4], int n, const float* tab) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < LMAX; ++j) {
    if (j < n) {
      const float2 b0 = *reinterpret_cast<const float2*>(tab + j * MERGED_QT * 8);
      const float2 b1 = *reinterpret_cast<const float2*>(tab + j * MERGED_QT * 8 + 64);
      s[j][0] += b0.x;
      s[j][1] += b0.y;
      s[j][2] += b1.x;
      s[j][3] += b1.y;
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < LMAX; ++j) {
    if (j < n) {
      s[j][0] = expf(s[j][0] - m0);
      s[j][1] = expf(s[j][1] - m0);
      s[j][2] = expf(s[j][2] - m1);
      s[j][3] = expf(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
  }
  l0 = 1.f / quad_sum(l0);
  l1 = 1.f / quad_sum(l1);
#pragma unroll
  for (int j = 0; j < LMAX; ++j) {
    if (j < n) {
      s[j][0] *= l0;
      s[j][1] *= l0;
      s[j][2] *= l1;
      s[j][3] *= l1;
    }
  }
}

// o = t at the first K step, o + t after (the dense form's o = step ? o + t
// : t), and a fresh t
template <int NT>
__device__ __forceinline__ void merged_flush(float (&o)[NT][4], float (&t)[NT][4], bool& first) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[n][e] = first ? t[n][e] : o[n][e] + t[n][e];
      t[n][e] = 0.f;
    }
  first = false;
}

// One image through a bf16 stage: q (64 rows), k and v (8n rows), the
// zero tile `zv`; context rows to ctx_g (the image's rows, head h's
// columns).  Lane = 4 gr + tq, as in window_attn.cuh.
template <int D, int LMAX>
__device__ __forceinline__ void merged_image_bf16(const bf16* q, const bf16* k, const bf16* v,
                                                  const bf16* zv, const float* tab,
                                                  const int* tiles, int n, int p, int C,
                                                  bf16* __restrict__ ctx_g) {
  using S = MergedSmem<bf16, D>;
  constexpr int LQ = S::LQ, LV = S::LV, DP = 32, NT = D / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3, r0 = 16 * warp;

  float s[LMAX][4];
  {
    uint32_t a[DP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const bf16* qa = q + (r0 + gr) * LQ + 16 * kk + 2 * tq;
      a[kk][0] = ld32(qa);
      a[kk][1] = ld32(qa + 8 * LQ);
      a[kk][2] = ld32(qa + 8);
      a[kk][3] = ld32(qa + 8 * LQ + 8);
    }
#pragma unroll
    for (int j = 0; j < LMAX; ++j) {
      if (j < n) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const bf16* kb = k + (8 * j + gr) * LQ + 16 * kk + 2 * tq;
          const uint32_t b[2] = {ld32(kb), ld32(kb + 8)};
          mma_bf16(s[j], a[kk], b);
        }
      }
    }
  }
  merged_softmax<LMAX>(s, n, tab + (r0 + gr) * 8 + 2 * tq);

  // P.V: one k16 step an aligned unit of two tiles (keys 16u..16u+15) that
  // holds a live tile, the A fragment from the two tiles' probabilities
  // (zeros for a dead half, which reads the zero tile), B by ldmatrix.trans
  // from the row-major v tiles; the dense form's K steps of 64 keys (4
  // units, tile >> 3) each into a fresh accumulator
  float o[NT][4] = {}, t[NT][4] = {};
  bool first = true, paired = false;
  int step = -1;
  const int mrow = lane & 7, mat = lane >> 3;  // this lane's ldmatrix row and matrix
#pragma unroll
  for (int j = 0; j < LMAX; ++j) {
    if (j < n && !paired) {
      const int jn = j + 1 < LMAX ? j + 1 : j;  // a constant once unrolled
      const int tile = tiles[j];
      const bool even = (tile & 1) == 0;
      paired = even && j + 1 < n && tiles[j + 1] == tile + 1;
      if ((tile >> 3) != step) {
        if (step >= 0) merged_flush(o, t, first);
        step = tile >> 3;
      }
      float lo[4], hi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo[e] = even ? s[j][e] : 0.f;
        hi[e] = even ? (paired ? s[jn][e] : 0.f) : s[j][e];
      }
      const uint32_t a[4] = {pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
                             pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3])};
      const bf16* vlo = even ? v + 8 * j * LV : zv;
      const bf16* vhi = even ? (paired ? v + 8 * (j + 1) * LV : zv) : v + 8 * j * LV;
      // matrices 0, 1: the low and high halves at n tile nn; 2, 3: at nn + 1
      const bf16* row = ((mat & 1) ? vhi : vlo) + mrow * LV + 8 * (mat >> 1);
#pragma unroll
      for (int nn = 0; nn < NT; nn += 2) {
        if (nn + 1 < NT) {
          uint32_t b[4];
          ldsm_x4_t(b, row + 8 * nn);
          mma_bf16(t[nn], a, b);
          mma_bf16(t[nn + 1], a, b + 2);
        } else {
          uint32_t b[2];
          ldsm_x2_t(b, ((mat & 1) ? vhi : vlo) + mrow * LV + 8 * nn);
          mma_bf16(t[nn], a, b);
        }
      }
    } else {
      paired = false;
    }
  }
  if (step >= 0) merged_flush(o, t, first);

  const int tok = merged_token(p, r0 + gr);  // row gr + 8 is the next image row: + 16
  bf16* out = ctx_g + (long long)tok * C + 2 * tq;
#pragma unroll
  for (int nn = 0; nn < NT; ++nn) {
    *reinterpret_cast<uint32_t*>(out + 8 * nn) = pack_bf16(o[nn][0], o[nn][1]);
    *reinterpret_cast<uint32_t*>(out + 16 * C + 8 * nn) = pack_bf16(o[nn][2], o[nn][3]);
  }
}

// One image through an f32 stage, as merged_image_bf16 (no zero tile).
template <int D, int LMAX>
__device__ __forceinline__ void merged_image_f32(const float* q, const float* k, const float* v,
                                                 const float* tab, const int* tiles, int n,
                                                 int p, int C, float* __restrict__ ctx_g) {
  using S = MergedSmem<float, D>;
  constexpr int LK = S::LQ, LV = S::LV, NT = D / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3, r0 = 16 * warp;

  // scores as window_attn.cuh's f32 kernel: one K step (D <= 32) into a
  // fresh accumulator a key tile; depth position tq is column 8kk + 2tq of
  // q and k, tq + 4 column 8kk + 2tq + 1
  float s[LMAX][4];
  {
    uint32_t qh[NT][4], ql[NT][4];
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const float2 a0 = *reinterpret_cast<const float2*>(&q[(r0 + gr) * LK + 8 * kk + 2 * tq]);
      const float2 a1 =
          *reinterpret_cast<const float2*>(&q[(r0 + gr + 8) * LK + 8 * kk + 2 * tq]);
      split_tf32(a0.x, qh[kk][0], ql[kk][0]);
      split_tf32(a1.x, qh[kk][1], ql[kk][1]);
      split_tf32(a0.y, qh[kk][2], ql[kk][2]);
      split_tf32(a1.y, qh[kk][3], ql[kk][3]);
    }
#pragma unroll
    for (int j = 0; j < LMAX; ++j) {
      if (j < n) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          const float2 b =
              *reinterpret_cast<const float2*>(&k[(8 * j + gr) * LK + 8 * kk + 2 * tq]);
          uint32_t kh[2], kl[2];
          split_tf32(b.x, kh[0], kl[0]);
          split_tf32(b.y, kh[1], kl[1]);
          mma_tf32x3(s[j], qh[kk], ql[kk], kh, kl);
        }
      }
    }
  }
  merged_softmax<LMAX>(s, n, tab + (r0 + gr) * 8 + 2 * tq);

  // P.V: one k8 step a live tile; P's A operand of tile j is {s[j][0],
  // s[j][2], s[j][1], s[j][3]} and V's rows are read in that order
  // (window_attn.cuh); the dense form's K steps of 32 keys (tile >> 2) each
  // into a fresh accumulator
  float o[NT][4] = {}, t[NT][4] = {};
  bool first = true;
  int step = -1;
#pragma unroll
  for (int j = 0; j < LMAX; ++j) {
    if (j < n) {
      const int tile = tiles[j];
      if ((tile >> 2) != step) {
        if (step >= 0) merged_flush(o, t, first);
        step = tile >> 2;
      }
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
#pragma unroll
      for (int nn = 0; nn < NT; ++nn) {
        const float* vr = &v[(8 * j + 2 * tq) * LV + 8 * nn + gr];
        uint32_t vh[2], vl[2];
        split_tf32(vr[0], vh[0], vl[0]);
        split_tf32(vr[LV], vh[1], vl[1]);
        mma_tf32x3(t[nn], ph, pl, vh, vl);
      }
    }
  }
  if (step >= 0) merged_flush(o, t, first);

  const int tok = merged_token(p, r0 + gr);
  float* out = ctx_g + (long long)tok * C + 2 * tq;
#pragma unroll
  for (int nn = 0; nn < NT; ++nn) {
    *reinterpret_cast<float2*>(out + 8 * nn) = make_float2(o[nn][0], o[nn][1]);
    *reinterpret_cast<float2*>(out + 16 * C + 8 * nn) = make_float2(o[nn][2], o[nn][3]);
  }
}

// The body of both kernels: block (chunk, h, patch) = blockIdx.x / (4
// heads), / 4 % heads, % 4 serves images [chunk * ipb, + ipb) of `windows`.
// qkv: (windows*256, 3C) in window order (the rolled image in raster
// order), q pre-scaled by 1/sqrt(D), head h at columns h*D of each third.
// bm: (1, heads, 256, 256) f32; live: (1, heads, 4, T) int32 lists; ctx:
// (windows*256, C).  Dynamic shared memory: MergedSmem<E, D>::bytes(T,
// STAGES).
template <typename E, int D, int LMAX, int STAGES>
__device__ __forceinline__ void merged_attn_body(const E* __restrict__ qkv,
                                                 const float* __restrict__ bm,
                                                 const int* __restrict__ live, int T, int windows,
                                                 int ipb, int heads, int C, E* __restrict__ ctx) {
  using S = MergedSmem<E, D>;
  extern __shared__ __align__(16) unsigned char merged_smem[];
  const int p = blockIdx.x % MERGED_PATCHES, h = blockIdx.x / MERGED_PATCHES % heads;
  const int g0 = blockIdx.x / (MERGED_PATCHES * heads) * ipb;
  const int count = min(ipb, windows - g0);
  float* tab = reinterpret_cast<float*>(merged_smem);
  E* stage0 = reinterpret_cast<E*>(tab + S::table_floats(T));
  E* zv = stage0 + STAGES * S::stage_elems(T);
  int* tiles = reinterpret_cast<int*>(zv + (S::BF16 ? 8 * S::LV : 0));
  auto q_of = [&](int st) { return stage0 + st * S::stage_elems(T); };
  auto k_of = [&](int st) { return q_of(st) + MERGED_QT * S::LQ; };
  auto v_of = [&](int st) { return k_of(st) + 8 * T * S::LQ; };

  const int n = merged_prologue(bm + (long long)h * MERGED_N * MERGED_N,
                                live + ((long long)h * MERGED_PATCHES + p) * T, T, p, tiles, tab);
  if constexpr (S::BF16) {
    // the zero v tile, and (D = 24) q and k's columns 24..31, which the
    // copies never write: zero in every stage
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < 8 * S::LV / 8; i += blockDim.x)
      reinterpret_cast<uint4*>(zv)[i] = zero;
    if constexpr (D < 32) {
      for (int i = threadIdx.x; i < STAGES * (MERGED_QT + 8 * n); i += blockDim.x) {
        const int st = i / (MERGED_QT + 8 * n), r = i % (MERGED_QT + 8 * n);
        E* row = r < MERGED_QT ? q_of(st) + r * S::LQ : k_of(st) + (r - MERGED_QT) * S::LQ;
        *reinterpret_cast<uint4*>(row + D) = zero;
      }
    }
  }
  auto load = [&](int i, int st) {
    merged_load<E, D>(qkv + (long long)(g0 + i) * MERGED_N * 3 * C + h * D, C, p, tiles, n,
                      q_of(st), k_of(st), v_of(st));
  };

  if constexpr (STAGES == 2) {
    if (count > 0) load(0, 0);
    merged_commit();
  }
  for (int i = 0; i < count; ++i) {
    const int st = STAGES == 2 ? i & 1 : 0;
    if constexpr (STAGES == 2) {
      if (i + 1 < count) load(i + 1, st ^ 1);  // the stage image i - 1 left
      merged_commit();
      merged_wait<1>();
    } else {
      load(i, 0);
      merged_commit();
      merged_wait<0>();
    }
    __syncthreads();
    E* ctx_g = ctx + (long long)(g0 + i) * MERGED_N * C + h * D;
    if constexpr (S::BF16)
      merged_image_bf16<D, LMAX>(q_of(st), k_of(st), v_of(st), zv, tab, tiles, n, p, C, ctx_g);
    else
      merged_image_f32<D, LMAX>(q_of(st), k_of(st), v_of(st), tab, tiles, n, p, C, ctx_g);
    __syncthreads();
  }
}

template <int D, int LMAX, int STAGES>
__global__ void __launch_bounds__(128) merged_attn_bf16(const bf16* __restrict__ qkv,
                                                        const float* __restrict__ bm,
                                                        const int* __restrict__ live, int T,
                                                        int windows, int ipb, int heads, int C,
                                                        bf16* __restrict__ ctx) {
  merged_attn_body<bf16, D, LMAX, STAGES>(qkv, bm, live, T, windows, ipb, heads, C, ctx);
}

template <int D, int LMAX, int STAGES>
__global__ void __launch_bounds__(128) merged_attn_f32(const float* __restrict__ qkv,
                                                       const float* __restrict__ bm,
                                                       const int* __restrict__ live, int T,
                                                       int windows, int ipb, int heads, int C,
                                                       float* __restrict__ ctx) {
  merged_attn_body<float, D, LMAX, STAGES>(qkv, bm, live, T, windows, ipb, heads, C, ctx);
}

template <int D, int LMAX, int STAGES, typename E>
cudaError_t launch_merged_attn_v(const E* qkv, const float* bm, const int* live, int T,
                                 int windows, int ipb, int heads, int C, E* ctx,
                                 cudaStream_t stream) {
  const int bytes = MergedSmem<E, D>::bytes(T, STAGES);
  const int blocks = (windows + ipb - 1) / ipb * heads * MERGED_PATCHES;
  cudaError_t e;
  if constexpr (sizeof(E) == 2) {
    e = cudaFuncSetAttribute(merged_attn_bf16<D, LMAX, STAGES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    merged_attn_bf16<D, LMAX, STAGES><<<blocks, 128, bytes, stream>>>(qkv, bm, live, T, windows,
                                                                      ipb, heads, C, ctx);
  } else {
    e = cudaFuncSetAttribute(merged_attn_f32<D, LMAX, STAGES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    merged_attn_f32<D, LMAX, STAGES><<<blocks, 128, bytes, stream>>>(qkv, bm, live, T, windows,
                                                                     ipb, heads, C, ctx);
  }
  return cudaGetLastError();
}

// Lists of <= 8 tiles (the model's tables): scores of 8 tiles in
// registers, two stages; longer ones: all 32, one stage.
template <int D, typename E>
cudaError_t launch_merged_attn_d(const E* qkv, const float* bm, const int* live, int T,
                                 int windows, int ipb, int heads, int C, E* ctx,
                                 cudaStream_t stream) {
  if (T <= 8)
    return launch_merged_attn_v<D, 8, 2>(qkv, bm, live, T, windows, ipb, heads, C, ctx, stream);
  return launch_merged_attn_v<D, MERGED_TILES, 1>(qkv, bm, live, T, windows, ipb, heads, C, ctx,
                                                  stream);
}

// The merged kernel of the head width C / heads (32 or 24; any other is
// refused before a launch, ops/attention.py _check_geometry) on one table
// (nbm = 1) and its live lists of T (1..32) entries, each block over as
// many images as make about MERGED_BLOCKS blocks (4 at stage 2's 16 heads
// and B = 64).
template <typename E>
cudaError_t launch_merged_attn(const E* qkv, const float* bm, int nbm, const int* live, int T,
                               int windows, int heads, int C, E* ctx, cudaStream_t stream) {
  if (nbm != 1 || live == nullptr || T < 1 || T > MERGED_TILES || windows < 1 || heads < 1)
    return cudaErrorInvalidValue;
  const int chunks = max(1, min(windows, MERGED_BLOCKS / (heads * MERGED_PATCHES)));
  const int ipb = (windows + chunks - 1) / chunks;
  if (C == 32 * heads)
    return launch_merged_attn_d<32>(qkv, bm, live, T, windows, ipb, heads, C, ctx, stream);
  if (C == 24 * heads)
    return launch_merged_attn_d<24>(qkv, bm, live, T, windows, ipb, heads, C, ctx, stream);
  return cudaErrorInvalidValue;
}

// Launch 3 of an attention half on its window-order qkv rows (rows = B*R*R):
// 8x8 windows take window_attn.cuh's kernel, the one 256-token window of
// the merged form this file's (with its live lists); any other window is
// refused.
template <typename T>
cudaError_t launch_attention(const T* qkv, const float* bm, int nbm, const int* live, int nlive,
                             int rows, int win, int heads, int C, T* ctx, cudaStream_t stream) {
  if (win * win == WIN_N)
    return launch_window_attn(qkv, bm, nbm, rows / WIN_N, heads, C, ctx, stream);
  if (win * win == MERGED_N)
    return launch_merged_attn(qkv, bm, nbm, live, nlive, rows / MERGED_N, heads, C, ctx, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
