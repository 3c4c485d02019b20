// Window attention over 8x8 windows of 32-wide heads, shared by the whole
// Swin block and its halves (swin_block.cu) and the bf16 v1/v2 attention
// halves (swin_halves.cu).
//
// One block per (window, head), templated on the element type of qkv and
// the context.  bf16: q, k, v, the 64x64 f32 scores and the bf16
// probabilities live in shared memory, products on WMMA; probabilities and
// context rounded to bf16.  f32 (the f32 Swin block's): q, k and v in shared
// memory, every product an f32 FMA chain on the CUDA cores (no TF32), and
// scores, probabilities and context stay f32 in registers, as the JAX f32
// kernel keeps them.  Both: the relative-position bias and the shift mask
// (one f32 table, -100 on masked pairs, HTSAT's convention) are added in
// f32; softmax in f32.
#pragma once

#include "gemm.cuh"

namespace {

constexpr int WIN_N = 64;  // tokens per window (8 x 8)
constexpr int HEAD_D = 32; // head width at every HTSAT stage

// qkv: (windows*64, 3C) T in window order, q pre-scaled by 1/sqrt(d),
// head h at columns h*32 of each third.  bm: (nbm, heads, 64, 64) f32,
// window g reads table g % nbm.  ctx: (windows*64, C) T.
template <typename T>
__global__ void __launch_bounds__(128) window_attn_kernel(
    const T* __restrict__ qkv, const float* __restrict__ bm, int nbm, int heads, int C,
    T* __restrict__ ctx) {
  constexpr int N = WIN_N, D = HEAD_D, LQ = D + 8, LS = N + 4, LP = N + 8;
  __shared__ __align__(32) bf16 q[N * LQ];
  __shared__ __align__(32) bf16 k[N * LQ];
  __shared__ __align__(32) bf16 v[N * LQ];
  __shared__ __align__(32) float s[N * LS];
  __shared__ __align__(32) bf16 pm[N * LP];

  const int g = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = (long long)g * N * 3 * C;
  for (int idx = tid; idx < N * (D / 8); idx += 128) {
    const int i = idx / (D / 8), j = (idx % (D / 8)) * 8;
    const bf16* row = qkv + base + (long long)i * 3 * C + h * D + j;
    *reinterpret_cast<uint4*>(&q[i * LQ + j]) = *reinterpret_cast<const uint4*>(row);
    *reinterpret_cast<uint4*>(&k[i * LQ + j]) = *reinterpret_cast<const uint4*>(row + C);
    *reinterpret_cast<uint4*>(&v[i * LQ + j]) = *reinterpret_cast<const uint4*>(row + 2 * C);
  }
  __syncthreads();

  // scores (q pre-scaled by 1/sqrt(d)): warp w owns rows 16w..16w+15
  const int r0 = 16 * warp;
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc[N / 16];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) wmma::fill_fragment(sc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
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
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cx[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(cx[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < N; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, pm + r0 * LP + kk, LP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, v + kk * LQ + 16 * j, LQ);
        wmma::mma_sync(cx[j], fa, fb, cx[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::store_matrix_sync(s + r0 * LS + 16 * j, cx[j], LS, wmma::mem_row_major);
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int i = r0 + rr;
    ctx[((long long)g * N + i) * C + h * D + lane] = __float2bfloat16(s[i * LS + lane]);
  }
}

// f32: warp w owns rows 16w..16w+15; for row i lane l computes the scores
// of columns l and l + 32 (depth order, k rows 33 floats apart: no bank
// conflict), the warp's softmax, then context column l from the
// probabilities passed along by shuffles.
template <>
__global__ void __launch_bounds__(128) window_attn_kernel<float>(
    const float* __restrict__ qkv, const float* __restrict__ bm, int nbm, int heads, int C,
    float* __restrict__ ctx) {
  constexpr int N = WIN_N, D = HEAD_D, LF = D + 1;
  __shared__ float q[N * LF];
  __shared__ float k[N * LF];
  __shared__ float v[N * LF];

  const int g = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = (long long)g * N * 3 * C;
  for (int idx = tid; idx < N * D; idx += 128) {
    const int i = idx / D, j = idx % D;
    const float* row = qkv + base + (long long)i * 3 * C + h * D + j;
    q[i * LF + j] = row[0];
    k[i * LF + j] = row[C];
    v[i * LF + j] = row[2 * C];
  }
  __syncthreads();

  const float* tab = bm + ((long long)(g % nbm) * heads + h) * N * N;
  for (int rr = 0; rr < 16; ++rr) {
    const int i = 16 * warp + rr;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      a0 = fmaf(q[i * LF + d], k[lane * LF + d], a0);
      a1 = fmaf(q[i * LF + d], k[(lane + 32) * LF + d], a1);
    }
    a0 += tab[i * N + lane];
    a1 += tab[i * N + lane + 32];
    const float m = warp_max(fmaxf(a0, a1));
    const float e0 = expf(a0 - m), e1 = expf(a1 - m);
    const float inv = 1.f / warp_sum(e0 + e1);
    const float p0 = e0 * inv, p1 = e1 * inv;
    float c = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) c = fmaf(__shfl_sync(0xffffffffu, p0, j), v[j * LF + lane], c);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      c = fmaf(__shfl_sync(0xffffffffu, p1, j), v[(j + 32) * LF + lane], c);
    ctx[((long long)g * N + i) * C + h * D + lane] = c;
  }
}

template <typename T>
cudaError_t launch_window_attn(const T* qkv, const float* bm, int nbm, int windows, int heads,
                               int C, T* ctx, cudaStream_t stream) {
  window_attn_kernel<T><<<dim3(windows, heads), 128, 0, stream>>>(qkv, bm, nbm, heads, C, ctx);
  return cudaGetLastError();
}

}  // namespace
