// Fused CLAP frontend: repeat-pad clip -> Swin patch tokens.
//
// Replaces the TPU kernel audio_metrics_tpu/ops/frontend_fused.py::
// clap_tokens_fused (pallas_call at :401, inner kernel :290): windowed-DFT
// product over the p+2 head and 2 tail frames only, power, mel, dB,
// folded BatchNorm, tiled mid-frame row copies, bicubic time interpolation
// as phase products, patch-embed product, per-frequency-block LayerNorm,
// tokens written in encoder order (chunk*fbk + fblk)*gw + g.
//
// What bounds it here: the DFT (per clip ~0.8 GFLOP: 512 frame rows x 1024
// samples x 768 basis columns) and the patch embed (~0.27 GFLOP) are
// tensor-core work; the mel product (n_keep x 64 per frame) is small and
// runs in f32 on the CUDA cores, as the TPU kernel keeps it f32.  The TPU
// kernel held a clip's hops, mel frames and tokens in VMEM in one grid
// step; here five short launches keep each product's tiles on chip and
// pass small intermediates through device memory (per clip: power 1.5 MB
// f32, mel 128 KB, interp 128 KB, patch 2 MB f32):
//   1. DFT GEMM: A rows are frames read in place from the bf16 hop-row
//      signal (row stride = hop < frame, overlapping rows: the frame matrix
//      is never materialised); the basis holds cos/sin columns interleaved,
//      so the epilogue forms re^2 + im^2 inside one tile;
//   2. mel/dB/BN (mel_log_kernel, shared with log_mel.cu in gemm.cuh):
//      one warp per assembled frame row: the tiled mid rows
//      re-read their source head frame (mid_src = 2 + (o-2) % p), rows past
//      the last frame are written as ZERO (a NaN there would poison the
//      interp product even against zero weights);
//   3. interp GEMM: the phase-regrouped (ps*rg, mel_pad) bicubic matrix
//      times each clip's mel; the epilogue scatters phase dh to lanes
//      dh*n_mels + f;
//   4. patch GEMM against the zero-padded block operand qcat, + bias, f32;
//   5. LayerNorm per (row, frequency block), written in token order.
// Products are WMMA bf16 with f32 accumulation.
#include "gemm.cuh"

// hops: (B, clip_stride) bf16, each clip's head hop rows then its tail hop
// rows from row tail_row0, hop samples per row; frame r = samples
// [r*hop, r*hop + frame).  basis: (frame, 2*n_keep) bf16, cos/sin
// interleaved.  fb: (n_keep, n_mels) f32.  wi: (ps*rg, mel_pad) bf16.
// qcat: (ps*n_mels, fbk*C) bf16.  Scratch: power (B, frame_rows, n_keep)
// f32, mel (B, mel_pad, n_mels) bf16, xi (B, rg, ps*n_mels) bf16, tok
// (B*rg, fbk*C) f32.  out: (B, rg*fbk, C) bf16.
extern "C" int am_clap_frontend(const bf16* hops, int clip_stride, int hop, int frame,
                                int frame_rows, const bf16* basis, int n_keep, float* power,
                                const float* fb, const float* sc, const float* of, int n_mels,
                                int p, int head_frames, int t_tail0, int tail_row0, int n_frames,
                                int mel_pad, bf16* mel, const bf16* wi, int ps, int rg, bf16* xi,
                                const bf16* qcat, const float* pbias, int fbk, int C, float* tok,
                                const float* lnw, const float* lnb, float eps, int gw, bf16* out,
                                int B, cudaStream_t stream) {
  cudaError_t e;
  GemmParams g = gemm_params(frame_rows, 2 * n_keep, frame, hops, hop, basis, 2 * n_keep, power,
                             n_keep);
  g.a_batch = clip_stride;
  g.o_batch = (long long)frame_rows * n_keep;
  if ((e = launch_gemm<A_ROWS, EPI_POWER>(g, B, stream)) != cudaSuccess) return e;

  const MelRows rows = {p, head_frames, t_tail0, tail_row0, n_frames, mel_pad};
  if ((e = launch_mel_log(power, frame_rows, n_keep, fb, sc, of, n_mels, rows, LOG_DB, 0.f, mel,
                          B, stream)) != cudaSuccess)
    return e;

  g = gemm_params(ps * rg, n_mels, mel_pad, wi, mel_pad, mel, n_mels, xi, ps * n_mels);
  g.b_batch = (long long)mel_pad * n_mels;
  g.o_batch = (long long)rg * ps * n_mels;
  g.rg = rg;
  if ((e = launch_gemm<A_ROWS, EPI_INTERP>(g, B, stream)) != cudaSuccess) return e;

  g = gemm_params(B * rg, fbk * C, ps * n_mels, xi, ps * n_mels, qcat, fbk * C, tok, fbk * C);
  g.v0 = pbias;
  if ((e = launch_gemm<A_ROWS, EPI_BIAS_F32>(g, 1, stream)) != cudaSuccess) return e;

  return launch_ln_rows(tok, B * rg, fbk, C, lnw, lnb, eps, out, gw, rg, stream);
}
