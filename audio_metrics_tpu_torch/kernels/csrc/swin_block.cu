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
//   2. window attention (window_attn.cuh, shared with swin_halves.cu): one
//      block per (window, head) holds q, k, v, the
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
#include "window_attn.cuh"

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

  if ((e = launch_window_attn(qkv, bm, nbm, M / WIN_N, heads, C, ctx, stream)) != cudaSuccess)
    return e;

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
