// Whole Swin block (HTSAT), bf16 activations, f32 statistics and softmax.
//
// Replaces the TPU kernel audio_metrics_tpu/ops/attention.py::
// _swin_block_call_v4 (pallas_call at :1109, kernel _swin_block_kernel_v4
// :951): LN1 folded through the qkv product, cyclic roll by -shift, 8x8
// window partition, scores + relative-position bias + shift mask, f32
// softmax, context, output projection, un-partition, roll by +shift,
// residual; then LN2, fc1, exact-erf GELU, fc2, residual.
//
// What bounds it here: the four products (qkv, proj, fc1, fc2) carry ~90%
// of the block's FLOPs and are tensor-core work; the block as a whole moves
// little data per FLOP at every stage (K = C..4C >= 128).  On the TPU one
// grid step held a whole image block (64 x 1024 rows of f32 residual at
// stage 0 alone) in ~100 MB of VMEM; a Hopper block has 227 KB of shared
// memory, so one launch cannot hold the whole block.  The design splits it
// into launches that each keep their own working set on chip:
//   1. qkv GEMM: A rows gathered through the window/roll map by index
//      arithmetic (no rolled or partitioned copy), LN1 statistics computed
//      in-block, epilogue rs*(x@W) - rs*mu*(1@W) + bq3 (the column sums of
//      W come from the same shared B tiles);
//   2. window attention: one block per (window, head) holds q, k, v, the
//      64x64 f32 scores and bf16 probabilities in shared memory; bias and
//      mask are added in f32 (mask -100, HTSAT's convention);
//   3. proj GEMM: epilogue + bp, scatter back through the same map
//      (un-partition + un-roll) and add the bf16 input as the residual,
//      into an f32 residual buffer (the TPU kernel also keeps it f32);
//   4. LN2 (one warp per row) -> bf16;
//   5. fc1 GEMM with + b1 and exact-erf GELU epilogue -> bf16;
//   6. fc2 GEMM with + b2 + f32 residual epilogue -> bf16 block output.
// Products are WMMA bf16 with f32 accumulation; wgmma/TMA pipelining and
// fusing 4-6 are later work.
#include "gemm.cuh"

namespace {

constexpr int WIN_N = 64;  // tokens per window (8 x 8)
constexpr int HEAD_D = 32; // head width at every HTSAT stage

__global__ void __launch_bounds__(128) window_attn_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ bm, int nbm, int heads, int C,
    bf16* __restrict__ ctx) {
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

}  // namespace

// x, out: (B, R, R, C) bf16.  wqkv (C, 3C), wp (C, C), w1 (C, 4C), w2 (4C, C)
// bf16 input-major; bq3 (3C), bp (C), ln2 (C), b1 (4C), b2 (C) f32; bm
// (nbm, heads, 64, 64) f32 with nbm = windows per image or 1.  Scratch:
// qkv (B*R*R, 3C) bf16, ctx/hbuf (B*R*R, C) bf16, res (B*R*R, C) f32,
// h1 (B*R*R, 4C) bf16.
extern "C" int am_swin_block(const bf16* x, const bf16* wqkv, const float* bq3, const bf16* wp,
                             const float* bp, const float* bm, int nbm, const float* ln2w,
                             const float* ln2b, const bf16* w1, const float* b1, const bf16* w2,
                             const float* b2, int B, int R, int C, int heads, int win, int shift,
                             float eps, bf16* qkv, bf16* ctx, float* res, bf16* hbuf, bf16* h1,
                             bf16* out, cudaStream_t stream) {
  const int M = B * R * R;
  cudaError_t e;

  GemmParams p = gemm_params(M, 3 * C, C, x, C, wqkv, 3 * C, qkv, 3 * C);
  p.R = R; p.win = win; p.shift = shift; p.eps = eps; p.v0 = bq3;
  if ((e = launch_gemm<A_WINDOW, EPI_QKV>(p, 1, stream)) != cudaSuccess) return e;

  dim3 agrid(M / WIN_N, heads);
  window_attn_kernel<<<agrid, 128, 0, stream>>>(qkv, bm, nbm, heads, C, ctx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  p = gemm_params(M, C, C, ctx, C, wp, C, res, C);
  p.R = R; p.win = win; p.shift = shift; p.v0 = bp; p.res = x;
  if ((e = launch_gemm<A_ROWS, EPI_PROJ>(p, 1, stream)) != cudaSuccess) return e;

  if ((e = launch_ln_rows(res, M, 1, C, ln2w, ln2b, eps, hbuf, 0, 0, stream)) != cudaSuccess)
    return e;

  p = gemm_params(M, 4 * C, C, hbuf, C, w1, 4 * C, h1, 4 * C);
  p.v0 = b1;
  if ((e = launch_gemm<A_ROWS, EPI_GELU>(p, 1, stream)) != cudaSuccess) return e;

  p = gemm_params(M, C, 4 * C, h1, 4 * C, w2, C, out, C);
  p.v0 = b2; p.res = res;
  return launch_gemm<A_ROWS, EPI_RESID>(p, 1, stream);
}
