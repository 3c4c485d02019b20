// Swin 2x2 patch merge with the LayerNorm folded into the reduction.
//
// Replaces the TPU kernel audio_metrics_tpu/ops/merge.py::patch_merge_pallas
// (pallas_call at :138, kernel _kernel :51): quadrant order
// [x00, x10, x01, x11], centered LN statistics of the virtual 4C concat
// row, out = rs * sum_j q_j @ wg_j + (tvec - mu*rs*svec).
//
// What bounds it here: one (B*(R/2)^2, 4C) x (4C, 2C) product (2C/4C =
// half a FLOP per byte of weight per row, ~1 KFLOP per byte of activation
// at C >= 128: tensor-core work at every merge).  The TPU kernel exposed
// the stride-2 structure with a free (B, H, W/2, 2C) bitcast and lane
// slices; here each block gathers its 64 output rows' quadrants straight
// from the (B, R, R, C) layout by index arithmetic while loading A tiles
// (the concat never exists in memory), computes the two-pass f32 statistics
// of those rows in-block, and applies the folded-LN epilogue to the f32
// accumulators.  Statistics are recomputed by each column block of a row
// tile: 2C/64 blocks re-read 64 rows from L2, cheaper than a second launch
// and a round trip through device memory.
#include "gemm.cuh"

// x: (B, R*R, C) bf16; wg: (4C, 2C) bf16 (the (4, C, 2C) blocks, row
// j*C + c); svec, tvec: (2C) f32; out: (B, (R/2)^2, 2C) bf16.
extern "C" int am_patch_merge(const bf16* x, const bf16* wg, const float* svec, const float* tvec,
                              int B, int R, int C, float eps, bf16* out, cudaStream_t stream) {
  const int M = B * (R / 2) * (R / 2);
  GemmParams p = gemm_params(M, 2 * C, 4 * C, x, C, wg, 2 * C, out, 2 * C);
  p.R = R; p.C = C; p.eps = eps; p.v0 = svec; p.v1 = tvec;
  return launch_gemm<A_MERGE, EPI_MERGE>(p, 1, stream);
}
