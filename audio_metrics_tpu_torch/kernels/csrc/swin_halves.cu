// The bf16 attention half with the LN1 affine in the kernel, as a kernel of
// its own (HTSAT), bf16 activations, f32 statistics and softmax: what the
// JAX package runs for a block under AM_TPU_ATTN_V1 at >= 16 windows, and
// the v2 form, which it exports as a public op and wires into no model path.
// (The v3 attention half #8 and the fused MLP #9 are the whole block's own
// launches, swin_block.cu; the f32 forms of all four are there too.)
//
// Replaces two TPU kernels:
//   am_swin_attn_v1  audio_metrics_tpu/ops/attention.py::_attn_block_call
//                    (pallas_call at :400, kernel _attn_block_kernel :111):
//                    x + WindowAttention(LN(x)) with the LN1 affine applied
//                    in the kernel and per-head (heads, C, d) weights, here
//                    laid out by the wrapper as one (C, heads*d) operand
//                    (pure reshapes), so the sum over heads of ctx_h @ wp_h
//                    runs inside one K = C product;
//   am_swin_attn_v2  ops/attention.py::_attn_block_call_v2 (pallas_call at
//                    :363, kernel _attn_block_kernel_v2 :226): the same
//                    function under v2's contract, one (C, 3C) qkv and one
//                    (C, C) projection operand; its per-head contractions
//                    over lane-masked k and v equal v1's d-wide ones (the
//                    zero lanes add nothing), so it runs v1's launches.
//
// What bounds them here: the products (qkv and proj: 8 T C^2 operations)
// are tensor-core work at every HTSAT stage (K = C >= 128), so the
// operations bound them; each half reads its bf16 input and writes its bf16
// output once (2 T C * 2 bytes).  The TPU kernels held a block of whole
// images in VMEM; a Hopper block has 227 KB of shared memory, so each half
// is a few launches of the WMMA GEMM (gemm.cuh) and the window-attention
// kernel that the whole block also runs, each keeping its own tiles on chip:
//   1. LN1 with its affine in f32 over the un-rolled rows, rounded to bf16
//      (the TPU kernel rolls before the cast: the same values);
//   2. qkv GEMM through the window/roll map over those rows with a plain
//      bias (EPI_BIAS_BF16: bq on the q columns, zero on k and v);
//   3. window attention;
//   4. proj GEMM whose epilogue adds bp and the bf16 input and writes the
//      bf16 half's output through the un-partition/un-roll map
//      (EPI_PROJ_BF16).
#include "window_attn.cuh"

// The attention half with the LN1 affine in the kernel (v1 and v2).  x,
// out: (B, R, R, C) bf16.  ln_w, ln_b (C) f32; wqkv (C, 3C) bf16 = [Wq^T
// scaled by 1/sqrt(d), Wk^T, Wv^T] (v1: the per-head wq, wk, wv side by
// side, head h at columns h*d of each third); bqkv (3C) f32, the scaled q
// bias and zeros on k and v; wp (C, C) bf16 (v1: the per-head (heads, d, C)
// rows stacked); bp (C) f32 with the value bias folded in; bm (nbm, heads,
// 64, 64) f32 with nbm = windows per image or 1.
// Scratch: xn (B*R*R, C), qkv (B*R*R, 3C), ctx (B*R*R, C) bf16.
static int attn_ln_affine(const bf16* x, const float* ln_w, const float* ln_b,
                          const bf16* wqkv, const float* bqkv, const bf16* wp, const float* bp,
                          const float* bm, int nbm, int B, int R, int C, int heads, int win,
                          int shift, float eps, bf16* xn, bf16* qkv, bf16* ctx, bf16* out,
                          cudaStream_t stream) {
  const int M = B * R * R;
  cudaError_t e;
  if ((e = launch_ln_rows(x, M, 1, C, ln_w, ln_b, eps, xn, 0, 0, stream)) != cudaSuccess)
    return e;

  GemmParams p = gemm_params(M, 3 * C, C, xn, C, wqkv, 3 * C, qkv, 3 * C);
  p.R = R; p.win = win; p.shift = shift; p.v0 = bqkv;
  if ((e = launch_gemm<A_WINDOW, EPI_BIAS_BF16>(p, 1, stream)) != cudaSuccess) return e;

  if ((e = launch_window_attn(qkv, bm, nbm, M / WIN_N, heads, C, ctx, stream)) != cudaSuccess)
    return e;

  p = gemm_params(M, C, C, ctx, C, wp, C, out, C);
  p.R = R; p.win = win; p.shift = shift; p.v0 = bp; p.res = x;
  return launch_gemm<A_ROWS, EPI_PROJ_BF16>(p, 1, stream);
}

extern "C" int am_swin_attn_v1(const bf16* x, const float* ln_w, const float* ln_b,
                               const bf16* wqkv, const float* bqkv, const bf16* wp,
                               const float* bp, const float* bm, int nbm, int B, int R, int C,
                               int heads, int win, int shift, float eps, bf16* xn, bf16* qkv,
                               bf16* ctx, bf16* out, cudaStream_t stream) {
  return attn_ln_affine(x, ln_w, ln_b, wqkv, bqkv, wp, bp, bm, nbm, B, R, C, heads, win, shift,
                        eps, xn, qkv, ctx, out, stream);
}

extern "C" int am_swin_attn_v2(const bf16* x, const float* ln_w, const float* ln_b,
                               const bf16* wqkv, const float* bq3, const bf16* wp,
                               const float* bp, const float* bm, int nbm, int B, int R, int C,
                               int heads, int win, int shift, float eps, bf16* xn, bf16* qkv,
                               bf16* ctx, bf16* out, cudaStream_t stream) {
  return attn_ln_affine(x, ln_w, ln_b, wqkv, bq3, wp, bp, bm, nbm, B, R, C, heads, win, shift,
                        eps, xn, qkv, ctx, out, stream);
}
