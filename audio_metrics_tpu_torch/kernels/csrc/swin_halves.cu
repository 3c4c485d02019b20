// The Swin block's two halves as separate kernels (HTSAT), bf16 activations,
// f32 statistics and softmax: what the JAX package runs for a block that the
// whole-block table (AM_TPU_V4_STAGES) leaves out, or under AM_TPU_ATTN_V1;
// and the v2 attention half, which it exports as a public op and wires into
// no model path.
//
// Replaces four TPU kernels:
//   am_swin_attn_v3  audio_metrics_tpu/ops/attention.py::_attn_block_call_v3
//                    (pallas_call at :869, kernel _attn_block_kernel_v3 :793):
//                    x + WindowAttention(LN(x)), the LN1 affine folded into
//                    wqkv/bq3 by the caller, all heads in one qkv product;
//   am_swin_attn_v1  ops/attention.py::_attn_block_call (pallas_call at :400,
//                    kernel _attn_block_kernel :111): the same function with
//                    the LN1 affine applied in the kernel and per-head
//                    (heads, C, d) weights, here laid out by the wrapper as
//                    one (C, heads*d) operand (pure reshapes), so the sum
//                    over heads of ctx_h @ wp_h runs inside one K = C product;
//   am_swin_attn_v2  ops/attention.py::_attn_block_call_v2 (pallas_call at
//                    :363, kernel _attn_block_kernel_v2 :226): the same
//                    function under v2's contract, one (C, 3C) qkv and one
//                    (C, C) projection operand; its per-head contractions
//                    over lane-masked k and v equal v1's d-wide ones (the
//                    zero lanes add nothing), so it runs v1's launches;
//   am_swin_mlp      ops/mlp.py::_mlp_call (pallas_call at :147, kernel
//                    _mlp_kernel :119): x + fc2(GELU(fc1(LN(x)))), LN affine
//                    in the kernel, exact-erf GELU, the residual read from the
//                    bf16 input.
//
// What bounds them here: the products (qkv and proj: 8 T C^2 operations;
// fc1 and fc2: 16 T C^2) are tensor-core work at every HTSAT stage (K = C
// or 4C >= 128), so the operations bound them; each half reads its bf16
// input and writes its bf16 output once (2 T C * 2 bytes).  The TPU kernels
// held a block of whole images (or a row tile with its (rows, 4C) hidden
// tensor) in VMEM; a Hopper block has 227 KB of shared memory, so each half
// is a few launches of the WMMA GEMM and the window-attention kernel that
// the whole block (swin_block.cu) already runs, each keeping its own tiles
// on chip:
//   attention v3: 1. qkv GEMM through the window/roll map with in-block LN1
//                    statistics (EPI_QKV); 2. window attention; 3. proj GEMM
//                    whose epilogue adds bp and the bf16 input and writes the
//                    bf16 block output through the un-partition/un-roll map
//                    (EPI_PROJ_BF16: no f32 residual buffer; the whole block
//                    keeps that residual in f32, the split path rounds it).
//   attention v1, v2: 1. LN1 with its affine in f32 over the un-rolled rows,
//                    rounded to bf16 (the TPU kernel rolls before the cast:
//                    the same values); 2. qkv GEMM through the window/roll
//                    map over those rows with a plain bias (EPI_BIAS_BF16:
//                    bq on the q columns, zero on k and v); 3. window
//                    attention; 4. v3's proj GEMM.
//   MLP:          1. LN2 with its affine over bf16 rows -> bf16; 2. fc1 GEMM
//                    + b1, exact-erf GELU -> bf16; 3. fc2 GEMM + b2 + the
//                    bf16 input -> bf16.  The (rows, 4C) hidden tensor
//                    round-trips device memory (the TPU kernel kept it in
//                    VMEM): the first thing a speed PR removes, by fusing fc1
//                    and fc2 per row tile.
#include "window_attn.cuh"

// x, out: (B, R, R, C) bf16.  wqkv (C, 3C), wp (C, C) bf16 input-major;
// bq3 (3C), bp (C) f32; bm (nbm, heads, 64, 64) f32.  Scratch: qkv
// (B*R*R, 3C) bf16, ctx (B*R*R, C) bf16.
extern "C" int am_swin_attn_v3(const bf16* x, const bf16* wqkv, const float* bq3, const bf16* wp,
                               const float* bp, const float* bm, int nbm, int B, int R, int C,
                               int heads, int win, int shift, float eps, bf16* qkv, bf16* ctx,
                               bf16* out, cudaStream_t stream) {
  const int M = B * R * R;
  cudaError_t e;
  GemmParams p = gemm_params(M, 3 * C, C, x, C, wqkv, 3 * C, qkv, 3 * C);
  p.R = R; p.win = win; p.shift = shift; p.eps = eps; p.v0 = bq3;
  if ((e = launch_gemm<A_WINDOW, EPI_QKV>(p, 1, stream)) != cudaSuccess) return e;

  if ((e = launch_window_attn(qkv, bm, nbm, M / WIN_N, heads, C, ctx, stream)) != cudaSuccess)
    return e;

  p = gemm_params(M, C, C, ctx, C, wp, C, out, C);
  p.R = R; p.win = win; p.shift = shift; p.v0 = bp; p.res = x;
  return launch_gemm<A_ROWS, EPI_PROJ_BF16>(p, 1, stream);
}

// The attention half with the LN1 affine in the kernel (v1 and v2).  x,
// out: (B, R, R, C) bf16.  ln_w, ln_b (C) f32; wqkv (C, 3C) bf16 = [Wq^T
// scaled by 1/sqrt(d), Wk^T, Wv^T] (v1: the per-head wq, wk, wv side by
// side, head h at columns h*d of each third); bqkv (3C) f32, the scaled q
// bias and zeros on k and v; wp (C, C) bf16 (v1: the per-head (heads, d, C)
// rows stacked); bp (C) f32 with the value bias folded in; bm as v3.
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

// x, out: (M, C) bf16.  ln_w, ln_b (C), b1 (4C), b2 (C) f32; w1 (C, 4C), w2
// (4C, C) bf16 input-major.  Scratch: hbuf (M, C), h1 (M, 4C) bf16.
extern "C" int am_swin_mlp(const bf16* x, const float* ln_w, const float* ln_b, const bf16* w1,
                           const float* b1, const bf16* w2, const float* b2, int M, int C,
                           float eps, bf16* hbuf, bf16* h1, bf16* out, cudaStream_t stream) {
  cudaError_t e;
  if ((e = launch_ln_rows(x, M, 1, C, ln_w, ln_b, eps, hbuf, 0, 0, stream)) != cudaSuccess)
    return e;

  GemmParams p = gemm_params(M, 4 * C, C, hbuf, C, w1, 4 * C, h1, 4 * C);
  p.v0 = b1;
  if ((e = launch_gemm<A_ROWS, EPI_GELU>(p, 1, stream)) != cudaSuccess) return e;

  p = gemm_params(M, C, 4 * C, h1, 4 * C, w2, C, out, C);
  p.v0 = b2; p.res = x;
  return launch_gemm<A_ROWS, EPI_RESID_BF16>(p, 1, stream);
}
