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
// samples x 768 basis columns), the interp product (~0.13 GFLOP) and the
// patch embed (~0.27 GFLOP) are tensor-core work; the mel product (n_keep x
// 64 per frame) is small and runs in f32 on the CUDA cores, as the TPU
// kernel keeps it f32.  The TPU kernel held a clip's hops, mel frames and
// tokens in VMEM in one grid step; here five short launches keep each
// product's tiles on chip and pass small intermediates through device
// memory (per clip: power 1.5 MB f32, mel 128 KB, interp 128 KB, patch 2 MB
// f32).  The first design ran the three products on gemm.cuh's WMMA core at
// ~5% of the bf16 peak; they now run on the wgmma core of gemm_sm90.cuh
// (TMA ring, K-major operands):
//   0. hop rows: one pass builds each clip's bf16 hop-row signal from its
//      f32 samples (head: left reflect pad, the clip, one period of
//      lookahead; tail: the last period's end, right reflect pad; zero
//      between), where the wrapper took six PyTorch ops (~27% of the
//      frontend's time at B = 64);
//   1. DFT product: A rows are frames read in place from the bf16 hop-row
//      signal by a 3-D tensor map (k, frame, clip) whose frame stride is the
//      hop (960 bytes) below the frame's 2048: overlapping rows, the frame
//      matrix is never materialised; B is the basis transposed at load
//      (2*n_keep, frame) with cos/sin rows interleaved, so the epilogue
//      forms re^2 + im^2 inside one tile;
//   2. mel/dB/BN (mel_log_kernel in gemm.cuh): one warp per assembled
//      frame row, written transposed (clip, mel, frame),
//      the K-major B of step 3: the tiled mid rows re-read their source head
//      frame (mid_src = 2 + (o-2) % p), rows past the last frame are written
//      as ZERO (a NaN there would poison the interp product even against
//      zero weights);
//   3. interp product: the phase-regrouped (ps*rg, mel_pad) bicubic matrix
//      times each clip's mel; the epilogue scatters phase dh to lanes
//      dh*n_mels + f;
//   4. patch product against the zero-padded block operand, transposed at
//      load (fbk*C, ps*n_mels), + bias, f32;
//   5. LayerNorm per (row, frequency block), written in token order.
#include "gemm_sm90.cuh"

namespace {

// hops[b][j], j < clip_stride, from the n samples of clip b: the head
// [x[half..1], x[0..n), x[0..extra)] cut at head_len, then from t0 the
// tail [x[n-extra..n), x[n-2..n-2-half)], zero elsewhere (the TPU
// wrapper's assembly, audio_metrics_tpu/ops/frontend_fused.py:227-232).
__global__ void hop_rows_kernel(const float* __restrict__ audio, int n, int half, int extra,
                                int head_len, int t0, int clip_stride, bf16* __restrict__ hops) {
  const float* x = audio + (long long)blockIdx.y * n;
  bf16* h = hops + (long long)blockIdx.y * clip_stride;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < clip_stride;
       j += gridDim.x * blockDim.x) {
    float v = 0.f;
    if (j < head_len) {
      v = j < half ? x[half - j] : j < half + n ? x[j - half] : x[j - half - n];
    } else if (j >= t0 && j < t0 + extra + half) {
      const int u = j - t0;
      v = u < extra ? x[n - extra + u] : x[n - 2 - (u - extra)];
    }
    h[j] = __float2bfloat16(v);
  }
}

}  // namespace

// audio: (B, n) f32 clips.  hops: scratch (B, clip_stride) bf16, each
// clip's head hop rows then its tail hop rows from row tail_row0, hop
// samples per row; frame r = samples [r*hop, r*hop + frame).  basis_t:
// (2*n_keep, frame) bf16, cos/sin rows interleaved.  fb: (n_keep, n_mels)
// f32.  wi: (ps*rg, mel_pad) bf16.  qcat_t: (fbk*C, ps*n_mels) bf16.
// Scratch: power (B, frame_rows, n_keep) f32, mel_t (B, n_mels, mel_pad)
// bf16, xi (B, rg, ps*n_mels) bf16, tok (B*rg, fbk*C) f32.  out: (B,
// rg*fbk, C) bf16.
extern "C" int am_clap_frontend(const float* audio, int n, int half, int extra, int head_len,
                                bf16* hops, int clip_stride, int hop, int frame,
                                int frame_rows, const bf16* basis_t, int n_keep, float* power,
                                const float* fb, const float* sc, const float* of, int n_mels,
                                int p, int head_frames, int t_tail0, int tail_row0, int n_frames,
                                int mel_pad, bf16* mel_t, const bf16* wi, int ps, int rg,
                                bf16* xi, const bf16* qcat_t, const float* pbias, int fbk, int C,
                                float* tok, const float* lnw, const float* lnb, float eps, int gw,
                                bf16* out, int B, cudaStream_t stream) {
  using namespace sm90;
  int e;
  hop_rows_kernel<<<dim3(256, B), 256, 0, stream>>>(audio, n, half, extra, head_len,
                                                    tail_row0 * hop, clip_stride, hops);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const Operand frames = {hops, frame_rows, frame, hop, B, clip_stride};
  EpiParams g = {};
  g.M = frame_rows; g.N = 2 * n_keep; g.out = power; g.ldo = n_keep;
  g.o_batch = (long long)frame_rows * n_keep;
  if ((e = gemm<EPI_POWER>(frames, rows_of(basis_t, 2 * n_keep, frame, frame), g, B, stream)))
    return e;

  const MelRows rows = {p, head_frames, t_tail0, tail_row0, n_frames, mel_pad};
  if ((e = launch_mel_log<bf16, true>(power, frame_rows, n_keep, fb, sc, of, n_mels, rows, LOG_DB,
                                      0.f, mel_t, B, stream)) != cudaSuccess)
    return e;

  const Operand mels = {mel_t, n_mels, mel_pad, mel_pad, B, (long long)n_mels * mel_pad};
  g = EpiParams{};
  g.M = ps * rg; g.N = n_mels; g.out = xi; g.ldo = ps * n_mels;
  g.o_batch = (long long)rg * ps * n_mels; g.rg = rg;
  if ((e = gemm<EPI_INTERP>(rows_of(wi, ps * rg, mel_pad, mel_pad), mels, g, B, stream)))
    return e;

  g = EpiParams{};
  g.M = B * rg; g.N = fbk * C; g.out = tok; g.ldo = fbk * C; g.v0 = pbias;
  if ((e = gemm<EPI_BIAS_F32>(rows_of(xi, B * rg, ps * n_mels, ps * n_mels),
                              rows_of(qcat_t, fbk * C, ps * n_mels, ps * n_mels), g, 1, stream)))
    return e;

  return launch_ln_rows(tok, B * rg, fbk, C, lnw, lnb, eps, out, gw, rg, stream);
}
