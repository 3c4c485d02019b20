// Window attention over 8x8 windows of D-wide heads, D = 32 (HTSAT-base, every
// stage) or 24 (HTSAT-tiny, every stage), shared by the whole Swin block and
// its attention halves (swin_block.cu): scores q.k^T, + the
// relative-position bias and the shift mask (one f32 table, -100 on masked
// pairs, HTSAT's convention) in f32, softmax in f32, context P.V.  It is
// the window attention of the TPU kernels, audio_metrics_tpu/ops/
// attention.py::_attn_windows_to_ctx (:534-686), inside
// _swin_block_call_v4 (:1099) and the attention halves.
// One block per (window, head); one kernel template for each element type of
// qkv and the context, each on the head width D.
//
// bf16: q, k, v, the 64x64 f32 scores and the bf16 probabilities live in
// shared memory, products on WMMA; probabilities and context rounded to
// bf16.  WMMA's bf16 products step 16 deep, so a head of 24 is held as 32
// columns of which the last 8 are zero in q, k and v: they add exact zeros
// to every score, and the context's last 8 columns (zeros) are not written.
//
// f32 (the f32 Swin block's and its halves'): bytes bound it.  A (window,
// head) reads 64 rows of q, k and v (24 KB) and writes 64 of context (8 KB)
// for 0.52 MFLOP: 16 FLOP a byte, 48 as three TF32 products, against the
// card's 148 TF32 FLOP per byte of memory (D = 32; D = 24 alike).  Over one
// forward at B = 64
// (HTSAT-base, 18 blocks) that is 3.36 GB, 1.00 ms at 3.35 TB/s, against
// 0.33 ms for its 53.7 GFLOP as three TF32 products at 495 TFLOP/s (0.80 as
// f32 FMAs at 67; the f32 FMA kernel this replaces took 6.76 ms on an
// H100).  So the loads are 16 bytes a thread into padded rows, and the two
// products run on the tensor cores (mma.sync m16n8k8, TF32 in, f32
// accumulate) as three TF32 products, A_lo.B_hi + A_hi.B_lo + A_hi.B_hi,
// each operand split in registers with cvt.rna as gemm_tf32x3_sm90.cuh
// splits A: one TF32 product is ~5e-4 relative, the f32 bounds ~1e-6.  The tensor cores'
// adds truncate, so each K step of 32 sums into a fresh accumulator and the
// steps add in f32 on the CUDA cores: one step for q.k^T (D/8 k8 products),
// two for P.V (each D/8 n8 tiles).
// Warp w owns rows 16w..16w+15 (one m16 tile).  Its scores stay in the
// accumulator registers, where the bias/mask add and the softmax run in
// f32, and feed P.V from there: the m16n8 accumulator holds keys 2t, 2t+1
// of an 8-key tile where m16n8k8's A operand wants depth positions t, t+4,
// so each k8 step's depth is permuted (position t <-> key 2t, t+4 <-> 2t+1)
// in P and in V's rows alike, which leaves the sum as it was.  The same
// permutation of the head dimension in q and k gives each thread its two
// values of a row in one 8-byte load.  Blocks run in head-fastest order, so
// the blocks in flight together read whole qkv rows (window-fastest order,
// or 5-6 blocks an SM, read no faster: profile_window_attn.py).  No
// atomics: a run repeats bitwise.
#pragma once

#include <mma.h>

#include "gemm.cuh"

namespace {

using namespace nvcuda;  // the bf16 products' WMMA fragments

constexpr int WIN_N = 64;  // tokens per window (8 x 8)

// bf16, block (g, h) = (blockIdx.x, blockIdx.y).  qkv: (windows*64, 3C) bf16
// in window order, q pre-scaled by 1/sqrt(D), head h at columns h*D of each
// third.  bm: (nbm, heads, 64, 64) f32, window g reads table g % nbm.  ctx:
// (windows*64, C) bf16.  D % 8 == 0, D <= 32.
template <int D>
__global__ void __launch_bounds__(128) window_attn_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ bm, int nbm, int heads, int C,
    bf16* __restrict__ ctx) {
  // DP: the head width held, D rounded up to WMMA's 16-deep steps
  constexpr int N = WIN_N, DP = (D + 15) / 16 * 16, LQ = DP + 8, LS = N + 4, LP = N + 8;
  __shared__ __align__(32) bf16 q[N * LQ];
  __shared__ __align__(32) bf16 k[N * LQ];
  __shared__ __align__(32) bf16 v[N * LQ];
  __shared__ __align__(32) float s[N * LS];
  __shared__ __align__(32) bf16 pm[N * LP];

  const int g = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = (long long)g * N * 3 * C;
  for (int idx = tid; idx < N * (DP / 8); idx += 128) {
    const int i = idx / (DP / 8), j = (idx % (DP / 8)) * 8;
    uint4 a = make_uint4(0, 0, 0, 0), b = a, c = a;  // the columns past D stay zero
    if (D == DP || j < D) {
      const bf16* row = qkv + base + (long long)i * 3 * C + h * D + j;
      a = *reinterpret_cast<const uint4*>(row);
      b = *reinterpret_cast<const uint4*>(row + C);
      c = *reinterpret_cast<const uint4*>(row + 2 * C);
    }
    *reinterpret_cast<uint4*>(&q[i * LQ + j]) = a;
    *reinterpret_cast<uint4*>(&k[i * LQ + j]) = b;
    *reinterpret_cast<uint4*>(&v[i * LQ + j]) = c;
  }
  __syncthreads();

  // scores (q pre-scaled by 1/sqrt(d)): warp w owns rows 16w..16w+15
  const int r0 = 16 * warp;
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc[N / 16];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) wmma::fill_fragment(sc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, q + r0 * LQ + kk, LQ);
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, k + 16 * j * LQ + kk, LQ);
        wmma::mma_sync(sc[j], fa, fb, sc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < N / 16; ++j)
      wmma::store_matrix_sync(s + r0 * LS + 16 * j, sc[j], LS, wmma::mem_row_major);
  }
  __syncwarp();

  // + bias/mask (f32), softmax in f32, probabilities -> bf16
  const float* bmh = bm + ((long long)(g % nbm) * heads + h) * N * N;
  for (int rr = 0; rr < 16; ++rr) {
    const int i = r0 + rr;
    const float a0 = s[i * LS + lane] + bmh[i * N + lane];
    const float a1 = s[i * LS + lane + 32] + bmh[i * N + lane + 32];
    const float m = warp_max(fmaxf(a0, a1));
    const float e0 = expf(a0 - m), e1 = expf(a1 - m);
    const float inv = 1.f / warp_sum(e0 + e1);
    pm[i * LP + lane] = __float2bfloat16(e0 * inv);
    pm[i * LP + lane + 32] = __float2bfloat16(e1 * inv);
  }
  __syncwarp();

  // context = P @ V for the warp's rows, staged in s (the warp's own rows)
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cx[DP / 16];
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(cx[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < N; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, pm + r0 * LP + kk, LP);
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, v + kk * LQ + 16 * j, LQ);
        wmma::mma_sync(cx[j], fa, fb, cx[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < DP / 16; ++j)
      wmma::store_matrix_sync(s + r0 * LS + 16 * j, cx[j], LS, wmma::mem_row_major);
  }
  __syncwarp();
  if (lane < D) {
    for (int rr = 0; rr < 16; ++rr) {
      const int i = r0 + rr;
      ctx[((long long)g * N + i) * C + h * D + lane] = __float2bfloat16(s[i * LS + lane]);
    }
  }
}

// x split into TF32 hi and lo parts (x_hi + x_lo holds x to ~2^-22), as
// the bit patterns that mma reads
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const float h = rna_tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(rna_tf32(x - h));
}

// d += a.b, one m16n8k8 TF32 product accumulated in f32
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A.B as three TF32 products, small terms first (A_lo.B_lo left out)
__device__ __forceinline__ void mma_tf32x3(float* d, const uint32_t* a_hi, const uint32_t* a_lo,
                                           const uint32_t* b_hi, const uint32_t* b_lo) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// f32, block (g, h) = blockIdx.x / heads, % heads; qkv, bm, ctx as the bf16
// kernel's in f32, D % 8 == 0, D <= 32.  Lane = 4 gr + tq: in the m16n8k8
// fragments it holds rows gr and gr + 8 of A, column gr of B, and of the
// accumulator rows gr, gr + 8 at columns 2tq, 2tq + 1.
template <int D>
__global__ void __launch_bounds__(128, 4) window_attn_kernel(
    const float* __restrict__ qkv, const float* __restrict__ bm, int nbm, int heads, int C,
    float* __restrict__ ctx) {
  // row pitches (floats) for conflict-free fragment reads: q and k rows LK
  // apart, LK = 8 or 24 mod 32 (8-byte reads at (gr, 2tq): in each half-warp
  // 8-bank groups that differ for each gr, 2tq + 0..1 within), v rows D + 4
  // apart (4-byte reads at (2tq, gr): D + 4 = 4 or 28 mod 32, banks 8tq + gr
  // or 24tq + gr)
  constexpr int N = WIN_N, LK = D == 32 ? D + 8 : D, LV = D + 4;
  constexpr int CH = D / 4;  // 16-byte chunks of a head's row
  __shared__ __align__(16) float q[N * LK];
  __shared__ __align__(16) float k[N * LK];
  __shared__ __align__(16) float v[N * LV];

  const int g = blockIdx.x / heads, h = blockIdx.x % heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  {
    // 64 rows x CH 16-byte chunks of each of q, k, v, chunk tid + 128 i of
    // each: all the loads of a thread (12 at D = 32, 9 at 24) in flight
    // before its stores
    constexpr int LOADS = N * CH / 128;
    const float* src = qkv + (long long)g * N * 3 * C + h * D;
    // chunk tid + 128 i: row (tid + 128 i) / CH, column 4 ((tid + 128 i) % CH);
    // at D = 32 (CH = 8) as shifts and masks, which the signed division and
    // remainder would not compile to
    const auto row_of = [&](int i) {
      return CH == 8 ? (tid >> 3) + 16 * i : (tid + 128 * i) / CH;
    };
    const auto col_of = [&](int i) { return CH == 8 ? (tid & 7) * 4 : (tid + 128 * i) % CH * 4; };
    float4 r[LOADS][3];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const float* row = src + (long long)row_of(i) * 3 * C + col_of(i);
      r[i][0] = *reinterpret_cast<const float4*>(row);
      r[i][1] = *reinterpret_cast<const float4*>(row + C);
      r[i][2] = *reinterpret_cast<const float4*>(row + 2 * C);
    }
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int row = row_of(i), col = col_of(i);
      *reinterpret_cast<float4*>(&q[row * LK + col]) = r[i][0];
      *reinterpret_cast<float4*>(&k[row * LK + col]) = r[i][1];
      *reinterpret_cast<float4*>(&v[row * LV + col]) = r[i][2];
    }
  }
  __syncthreads();

  // scores of rows r0 + gr (s[j][0..1]) and r0 + gr + 8 (s[j][2..3]) at
  // keys 8j + 2tq, 8j + 2tq + 1: one K step (the head's D <= 32) into a
  // fresh accumulator; in k8 step kk, depth position tq is column 8kk + 2tq
  // of q and k, tq + 4 column 8kk + 2tq + 1
  const int r0 = 16 * warp;
  float s[8][4];
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
    for (int j = 0; j < 8; ++j) {
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

  // + bias/mask, softmax over each row's 64 keys (16 a lane, the quad's 4
  // lanes), in f32
  const float* tab = bm + ((long long)(g % nbm) * heads + h) * N * N;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b0 = *reinterpret_cast<const float2*>(tab + (r0 + gr) * N + 8 * j + 2 * tq);
    const float2 b1 = *reinterpret_cast<const float2*>(tab + (r0 + gr + 8) * N + 8 * j + 2 * tq);
    s[j][0] += b0.x;
    s[j][1] += b0.y;
    s[j][2] += b1.x;
    s[j][3] += b1.y;
  }
  float m0 = s[0][0], m1 = s[0][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
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
  for (int j = 0; j < 8; ++j) {
    s[j][0] *= l0;
    s[j][1] *= l0;
    s[j][2] *= l1;
    s[j][3] *= l1;
  }

  // context = P.V in two K steps of 32 keys, each into a fresh accumulator
  // t, added in f32.  P's A operand of k8 step j is score tile j as the
  // accumulator holds it, {s[j][0], s[j][2], s[j][1], s[j][3]}: depth
  // position tq is key 8j + 2tq, tq + 4 key 8j + 2tq + 1, and V's rows are
  // read in that order
  float o[D / 8][4];
#pragma unroll
  for (int step = 0; step < 2; ++step) {
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

  float* out = ctx + ((long long)g * N + r0 + gr) * C + h * D + 2 * tq;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(out + 8 * n) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(out + 8 * C + 8 * n) = make_float2(o[n][2], o[n][3]);
  }
}

template <int D, typename T>
cudaError_t launch_window_attn_d(const T* qkv, const float* bm, int nbm, int windows, int heads,
                                 int C, T* ctx, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4)  // f32: one dimension, heads fastest
    window_attn_kernel<D><<<windows * heads, 128, 0, stream>>>(qkv, bm, nbm, heads, C, ctx);
  else
    window_attn_kernel<D><<<dim3(windows, heads), 128, 0, stream>>>(qkv, bm, nbm, heads, C, ctx);
  return cudaGetLastError();
}

// The kernel of the head width C / heads: 32 or 24 (ops/attention.py
// _check_geometry); any other is refused before a launch.
template <typename T>
cudaError_t launch_window_attn(const T* qkv, const float* bm, int nbm, int windows, int heads,
                               int C, T* ctx, cudaStream_t stream) {
  if (heads > 0 && C == 32 * heads)
    return launch_window_attn_d<32>(qkv, bm, nbm, windows, heads, C, ctx, stream);
  if (heads > 0 && C == 24 * heads)
    return launch_window_attn_d<24>(qkv, bm, nbm, windows, heads, C, ctx, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
