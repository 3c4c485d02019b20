// Log-mel spectrogram with the frames read in place from hop rows.
//
// Replaces the TPU kernel audio_metrics_tpu/ops/mel.py::log_mel_pallas_halo
// (pallas_call at :554): bf16 frames x bf16 windowed-DFT basis cut to the
// filterbank's support, f32 accumulation, power, f32 mel product, dB or
// natural log, optional per-bin affine, f32 or bf16 out.  The wrapper does
// what the JAX wrapper does outside its kernel (reflect pad, bf16 cast, hop
// rows; mel.py:417-443).
//
// What bounds it here: the DFT product, 2 * frames * K * 2*n_keep bf16
// operations (CLAP 10 s: 1001 x 1024 x 768 per clip, ~1.6 GFLOP) against
// 989 TFLOP/s on the tensor cores, and the mel product (n_keep x n_mels
// per frame, ~49 MFLOP per 10 s clip) in f32 on the CUDA cores; the clip is
// read once (~1 MB bf16).  The TPU kernel DMA'd each frame tile with its
// halo of hop rows into VMEM; here the DFT GEMM (gemm.cuh, WMMA bf16) reads
// its A rows in place from the bf16 hop-row signal with row stride = hop <
// frame, so the overlapping frame matrix never exists in device memory,
// the same A map as the fused CLAP frontend's DFT (frontend.cu).  The basis
// has cos/sin columns interleaved so the epilogue forms re^2 + im^2 inside
// one tile, and zero rows from the frame length up to K (a multiple of 32:
// the VGGish frame of 400 reads 16 samples of the next hop against zeros).
// The power rows pass through device memory (f32) to the mel/log/affine
// kernel shared with the frontend (gemm.cuh::mel_log_kernel), which writes
// exactly n_frames rows.
#include "gemm.cuh"

// hops: (B, clip_stride) bf16, frame r of clip b = samples [r*hop, r*hop +
// k_pad) of row b (zero past the signal).  basis: (k_pad, 2*n_keep) bf16,
// cos/sin interleaved, zero rows past the frame length.  fb: (n_keep,
// n_mels) f32.  sc/of: (n_mels) f32 or null.  Scratch: power (B, n_frames,
// n_keep) f32.  out: (B, n_frames, n_mels), bf16 when out_bf16 else f32.
extern "C" int am_log_mel(const bf16* hops, int clip_stride, int hop, int k_pad, int n_frames,
                          const bf16* basis, int n_keep, float* power, const float* fb,
                          const float* sc, const float* of, int n_mels, int log_mode,
                          float log_offset, int out_bf16, void* out, int B,
                          cudaStream_t stream) {
  cudaError_t e;
  GemmParams g = gemm_params(n_frames, 2 * n_keep, k_pad, hops, hop, basis, 2 * n_keep, power,
                             n_keep);
  g.a_batch = clip_stride;
  g.o_batch = (long long)n_frames * n_keep;
  if ((e = launch_gemm<A_ROWS, EPI_POWER>(g, B, stream)) != cudaSuccess) return e;
  const MelRows rows = {1, n_frames, n_frames, 0, n_frames, n_frames};
  if (out_bf16)
    return launch_mel_log(power, n_frames, n_keep, fb, sc, of, n_mels, rows, log_mode, log_offset,
                          static_cast<bf16*>(out), B, stream);
  return launch_mel_log(power, n_frames, n_keep, fb, sc, of, n_mels, rows, log_mode, log_offset,
                        static_cast<float*>(out), B, stream);
}
