// The merged one-window form of the v1 and v2 attention halves (#10, #11):
// attention over one 256-token window a head (window = resolution = 16,
// HTSAT's stage 2 under AM_TPU_MERGED_ATTN) with an additive f32 table of
// (nbm, heads, 256, 256), D-wide heads, D = 32 (HTSAT-base) or 24
// (HTSAT-tiny).  It is the window attention of the TPU kernel audio_
// metrics_tpu/ops/attention.py::_attn_block_kernel (:111, pallas_call at
// :400) at window = resolution, where the JAX package scatters each
// window's bias and shift mask onto one dense table with -1e9 on the pairs
// of two windows (models/htsat.py::_merged_bias_mask).  The kernel reads
// the table as it is: every query row against all 256 keys, no block
// structure assumed, as the public ops take any such table.
//
// Rounding points as the TPU kernel's (:180-202): scores + table in f32,
// the row max subtracted in f32, the probabilities normalised in f32 and
// only then rounded to the activation dtype (no online softmax: it would
// round unnormalised probabilities), the context rounded to the activation
// dtype.  A -1e9 entry gives exp(-1e9 - max) = 0 exactly in f32, so a
// block-diagonal table reproduces per-window attention.
//
// One block per (image, head, 64-query tile), 4 warps, tiles fastest then
// heads: the four tiles of a head read its K and V (256 x D) from L2 after
// the first.  Warp w owns query rows 16w..16w+15 of its tile; its 16 x 256
// f32 scores stay in the mma accumulator registers (32 n8 tiles, 128 a
// thread), where the table add and the softmax run, and feed P.V from
// there.  What bounds it here: at stage 2 of HTSAT-base (B = 64, 16 heads of
// 32) a block's attention is 4 * 256^2 * 32 FLOP a head and image, 8.6 GFLOP
// (4x the per-window form's), against 67 MB of qkv in and context out in
// bf16: bytes bind in bf16 (0.020 ms against 0.0087 of bf16 products), the
// operations in f32 (three TF32 products each, 0.052 ms against 0.040).
//   bf16: q, k and V transposed in shared memory (42 KB), products on
//   mma.sync m16n8k16 (bf16 in, f32 accumulate); a head of 24 is held as 32
//   columns whose last 8 are zero in q and k (they add exact zeros to every
//   score) and never read in V.  P's A fragment of a k16 step is two score
//   tiles as the accumulators hold them, rounded to bf16 pairwise.
//   f32: the 64-token kernel's design (window_attn.cuh) over 256 keys: three
//   TF32 products on mma.sync m16n8k8 with both operands split in
//   registers, the same depth permutation, q, k and v in 86 KB (D = 32) of
//   dynamic shared memory.
// Both sum P.V over K steps of 64 (bf16) or 32 (f32) keys into a fresh
// accumulator each, added in f32.  No atomics: a run repeats bitwise.
#pragma once

#include "window_attn.cuh"

namespace {

constexpr int MERGED_N = 256;  // tokens of the one window (16 x 16)
constexpr int MERGED_QT = 64;  // query rows a block: 4 warps of 16

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

// Scores of the thread's two query rows, row and row + 8 (s[j][0..1] row,
// keys 8j + 2tq, +1; s[j][2..3] row + 8), + the head's (256, 256) table
// ``tab``, every key's entry, then the softmax over all 256 keys in f32, in
// place.
__device__ __forceinline__ void merged_softmax(float (&s)[MERGED_N / 8][4], const float* tab,
                                               int row, int tq) {
  constexpr int N = MERGED_N;
  const float* t0 = tab + (long long)row * N;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b0 = *reinterpret_cast<const float2*>(t0 + 8 * j + 2 * tq);
    const float2 b1 = *reinterpret_cast<const float2*>(t0 + 8 * N + 8 * j + 2 * tq);
    s[j][0] += b0.x;
    s[j][1] += b0.y;
    s[j][2] += b1.x;
    s[j][3] += b1.y;
  }
  float m0 = s[0][0], m1 = s[0][2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    s[j][0] = expf(s[j][0] - m0);
    s[j][1] = expf(s[j][1] - m0);
    s[j][2] = expf(s[j][2] - m1);
    s[j][3] = expf(s[j][3] - m1);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
  l0 = 1.f / quad_sum(l0);
  l1 = 1.f / quad_sum(l1);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    s[j][0] *= l0;
    s[j][1] *= l0;
    s[j][2] *= l1;
    s[j][3] *= l1;
  }
}

// bf16, block (g, h, qt) = blockIdx.x / (4 heads), / 4 % heads, % 4.  qkv:
// (windows*256, 3C) bf16 in window order (the rolled image in raster
// order), q pre-scaled by 1/sqrt(D), head h at columns h*D of each third.
// bm: (nbm, heads, 256, 256) f32, window g reads table g % nbm.  ctx:
// (windows*256, C) bf16.  Lane = 4 gr + tq, as in window_attn.cuh.
template <int D>
__global__ void __launch_bounds__(128) merged_attn_bf16(const bf16* __restrict__ qkv,
                                                        const float* __restrict__ bm, int nbm,
                                                        int heads, int C,
                                                        bf16* __restrict__ ctx) {
  constexpr int N = MERGED_N, QT = MERGED_QT, DP = 32, LQ = DP + 8, LV = N + 8;
  constexpr int CH = DP / 8;  // 16-byte chunks of a padded row
  // q and k rows LQ = 20 words apart, V^T rows LV = 132 (4 mod 32): the
  // 4-byte fragment reads at (gr, tq) fall in 32 distinct banks
  __shared__ __align__(16) bf16 q[QT * LQ];
  __shared__ __align__(16) bf16 k[N * LQ];
  __shared__ __align__(16) bf16 vt[DP * LV];

  const int qt = blockIdx.x % (N / QT), gh = blockIdx.x / (N / QT);
  const int h = gh % heads, g = gh / heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const bf16* src = qkv + (long long)g * N * 3 * C + h * D;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int idx = tid; idx < QT * CH; idx += 128) {
    const int i = idx / CH, j = (idx % CH) * 8;
    *reinterpret_cast<uint4*>(&q[i * LQ + j]) =
        j < D ? *reinterpret_cast<const uint4*>(src + (long long)(QT * qt + i) * 3 * C + j)
              : zero;
  }
  for (int idx = tid; idx < N * CH; idx += 128) {
    const int i = idx / CH, j = (idx % CH) * 8;
    uint4 b = zero, c = zero;
    if (j < D) {
      const bf16* row = src + (long long)i * 3 * C + j;
      b = *reinterpret_cast<const uint4*>(row + C);
      c = *reinterpret_cast<const uint4*>(row + 2 * C);
    }
    *reinterpret_cast<uint4*>(&k[i * LQ + j]) = b;
    const bf16* cv = reinterpret_cast<const bf16*>(&c);
#pragma unroll
    for (int e = 0; e < 8; ++e) vt[(j + e) * LV + i] = cv[e];
  }
  __syncthreads();

  // scores: one fresh accumulator a key tile over the head's DP columns
  const int r0 = 16 * warp;
  float s[N / 8][4];
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
    for (int j = 0; j < N / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const bf16* kb = k + (8 * j + gr) * LQ + 16 * kk + 2 * tq;
        const uint32_t b[2] = {ld32(kb), ld32(kb + 8)};
        mma_bf16(s[j], a[kk], b);
      }
    }
  }

  const int row = QT * qt + r0 + gr;  // the thread's first query row in the window
  merged_softmax(s, bm + ((long long)(g % nbm) * heads + h) * N * N, row, tq);

  // context = P.V: k16 step kk covers keys 16kk..16kk+15, score tiles 2kk
  // and 2kk + 1; four steps (64 keys) into a fresh accumulator t, added in
  // f32
  float o[D / 8][4];
#pragma unroll
  for (int step = 0; step < N / 64; ++step) {
    float t[D / 8][4] = {};
#pragma unroll
    for (int kk = 4 * step; kk < 4 * step + 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* vb = vt + (8 * n + gr) * LV + 16 * kk + 2 * tq;
        const uint32_t b[2] = {ld32(vb), ld32(vb + 8)};
        mma_bf16(t[n], a, b);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = step ? o[n][e] + t[n][e] : t[n][e];
  }

  bf16* out = ctx + ((long long)g * N + row) * C + h * D + 2 * tq;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(out + 8 * n) = pack_bf16(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(out + 8 * C + 8 * n) = pack_bf16(o[n][2], o[n][3]);
  }
}

// The f32 kernel's shared memory: q (64 rows), k and v (256 rows) at the
// row pitches of window_attn.cuh's f32 kernel (conflict-free fragment
// reads), in floats.
template <int D>
struct MergedF32Smem {
  static constexpr int LK = D == 32 ? D + 8 : D, LV = D + 4;
  static constexpr int floats = MERGED_QT * LK + MERGED_N * LK + MERGED_N * LV;
};

// f32, blocks as the bf16 kernel's; qkv, bm, ctx as its in f32.  Dynamic
// shared memory: MergedF32Smem<D>::floats * 4 bytes.
template <int D>
__global__ void __launch_bounds__(128, 2) merged_attn_f32(const float* __restrict__ qkv,
                                                          const float* __restrict__ bm, int nbm,
                                                          int heads, int C,
                                                          float* __restrict__ ctx) {
  constexpr int N = MERGED_N, QT = MERGED_QT;
  constexpr int LK = MergedF32Smem<D>::LK, LV = MergedF32Smem<D>::LV, CH = D / 4;
  extern __shared__ __align__(16) float merged_smem[];
  float* q = merged_smem;
  float* k = q + QT * LK;
  float* v = k + N * LK;

  const int qt = blockIdx.x % (N / QT), gh = blockIdx.x / (N / QT);
  const int h = gh % heads, g = gh / heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const float* src = qkv + (long long)g * N * 3 * C + h * D;
  for (int idx = tid; idx < QT * CH; idx += 128) {
    const int i = idx / CH, j = (idx % CH) * 4;
    *reinterpret_cast<float4*>(&q[i * LK + j]) =
        *reinterpret_cast<const float4*>(src + (long long)(QT * qt + i) * 3 * C + j);
  }
  for (int idx = tid; idx < N * CH; idx += 128) {
    const int i = idx / CH, j = (idx % CH) * 4;
    const float* row = src + (long long)i * 3 * C + j;
    *reinterpret_cast<float4*>(&k[i * LK + j]) = *reinterpret_cast<const float4*>(row + C);
    *reinterpret_cast<float4*>(&v[i * LV + j]) = *reinterpret_cast<const float4*>(row + 2 * C);
  }
  __syncthreads();

  // scores as window_attn.cuh's f32 kernel: one K step (D <= 32) into a
  // fresh accumulator a key tile; depth position tq is column 8kk + 2tq of
  // q and k, tq + 4 column 8kk + 2tq + 1
  const int r0 = 16 * warp;
  float s[N / 8][4];
  {
    uint32_t qh[D / 8][4], ql[D / 8][4];
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float2 a0 = *reinterpret_cast<const float2*>(&q[(r0 + gr) * LK + 8 * kk + 2 * tq]);
      const float2 a1 =
          *reinterpret_cast<const float2*>(&q[(r0 + gr + 8) * LK + 8 * kk + 2 * tq]);
      split_tf32(a0.x, qh[kk][0], ql[kk][0]);
      split_tf32(a1.x, qh[kk][1], ql[kk][1]);
      split_tf32(a0.y, qh[kk][2], ql[kk][2]);
      split_tf32(a1.y, qh[kk][3], ql[kk][3]);
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const float2 b = *reinterpret_cast<const float2*>(&k[(8 * j + gr) * LK + 8 * kk + 2 * tq]);
        uint32_t kh[2], kl[2];
        split_tf32(b.x, kh[0], kl[0]);
        split_tf32(b.y, kh[1], kl[1]);
        mma_tf32x3(s[j], qh[kk], ql[kk], kh, kl);
      }
    }
  }

  const int row = QT * qt + r0 + gr;
  merged_softmax(s, bm + ((long long)(g % nbm) * heads + h) * N * N, row, tq);

  // context = P.V in K steps of 32 keys (four score tiles), each into a
  // fresh accumulator t, added in f32; P's A operand of tile j is
  // {s[j][0], s[j][2], s[j][1], s[j][3]} and V's rows are read in that
  // order (window_attn.cuh)
  float o[D / 8][4];
#pragma unroll
  for (int step = 0; step < N / 32; ++step) {
    float t[D / 8][4] = {};
#pragma unroll
    for (int j = 4 * step; j < 4 * step + 4; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float* vr = &v[(8 * j + 2 * tq) * LV + 8 * n + gr];
        uint32_t vh[2], vl[2];
        split_tf32(vr[0], vh[0], vl[0]);
        split_tf32(vr[LV], vh[1], vl[1]);
        mma_tf32x3(t[n], ph, pl, vh, vl);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = step ? o[n][e] + t[n][e] : t[n][e];
  }

  float* out = ctx + ((long long)g * N + row) * C + h * D + 2 * tq;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(out + 8 * n) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(out + 8 * C + 8 * n) = make_float2(o[n][2], o[n][3]);
  }
}

template <int D, typename T>
cudaError_t launch_merged_attn_d(const T* qkv, const float* bm, int nbm, int windows, int heads,
                                 int C, T* ctx, cudaStream_t stream) {
  const int blocks = windows * heads * (MERGED_N / MERGED_QT);
  if constexpr (sizeof(T) == 4) {
    constexpr int bytes = MergedF32Smem<D>::floats * 4;
    const cudaError_t e = cudaFuncSetAttribute(
        merged_attn_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    merged_attn_f32<D><<<blocks, 128, bytes, stream>>>(qkv, bm, nbm, heads, C, ctx);
  } else {
    merged_attn_bf16<D><<<blocks, 128, 0, stream>>>(qkv, bm, nbm, heads, C, ctx);
  }
  return cudaGetLastError();
}

// The merged kernel of the head width C / heads: 32 or 24; any other is
// refused before a launch (ops/attention.py _check_geometry).
template <typename T>
cudaError_t launch_merged_attn(const T* qkv, const float* bm, int nbm, int windows, int heads,
                               int C, T* ctx, cudaStream_t stream) {
  if (heads > 0 && C == 32 * heads)
    return launch_merged_attn_d<32>(qkv, bm, nbm, windows, heads, C, ctx, stream);
  if (heads > 0 && C == 24 * heads)
    return launch_merged_attn_d<24>(qkv, bm, nbm, windows, heads, C, ctx, stream);
  return cudaErrorInvalidValue;
}

// Launch 3 of an attention half on its window-order qkv rows (rows = B*R*R):
// 8x8 windows take window_attn.cuh's kernel, the one 256-token window of
// the merged form this file's; any other window is refused.
template <typename T>
cudaError_t launch_attention(const T* qkv, const float* bm, int nbm, int rows, int win,
                             int heads, int C, T* ctx, cudaStream_t stream) {
  if (win * win == WIN_N)
    return launch_window_attn(qkv, bm, nbm, rows / WIN_N, heads, C, ctx, stream);
  if (win * win == MERGED_N)
    return launch_merged_attn(qkv, bm, nbm, rows / MERGED_N, heads, C, ctx, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
