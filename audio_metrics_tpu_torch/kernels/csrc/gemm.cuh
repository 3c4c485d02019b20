// Shared building blocks of the hand-written Hopper kernels: the epilogue
// codes of the wgmma cores (gemm_sm90.cuh, gemm_tf32x3_sm90.cuh), warp
// reductions, the TF32 split, the Swin window map, the row LayerNorm
// (ln_rows_kernel) and #3's mel projection (mel_log_kernel).  No GEMM is
// defined here: the products run on the wgmma cores, the window
// attention's in window_attn.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// The epilogues of the wgmma cores (gemm_sm90.cuh epilogue8, bf16, and
// s8_epilogue8, int8 codes; gemm_tf32x3_sm90.cuh epi_f32, f32 in and out).
enum Epi {
  EPI_QKV = 0,    // bf16 out = acc*rs - rs*mu*colsum(B) + v0      (LN1 fold)
  EPI_PROJ,       // f32 out[map(r)] = acc + v0 + res_bf16[map(r)] (un-partition, un-roll, residual)
  EPI_GELU,       // bf16 out = gelu_erf(acc + v0)
  EPI_RESID,      // bf16 out = acc + v0 + res_f32
  EPI_MERGE,      // bf16 out = acc*rs + (v0 - mu*rs*csum)         (merge LN fold)
  EPI_POWER,      // f32 out[n/2] = acc[n]^2 + acc[n+1]^2          (interleaved re/im)
  EPI_INTERP,     // bf16 out[r % rg][(r / rg)*N + n] = acc        (phase rows -> lanes)
  EPI_BIAS_F32,   // f32 out = acc + v0
  EPI_PROJ_BF16,  // bf16 out[map(r)] = acc + v0 + res_bf16[map(r)] (EPI_PROJ, bf16 out)
  EPI_BIAS_BF16,  // bf16 out = acc + v0
  EPI_RESID_IN,   // bf16 out = acc + v0 + res_bf16                (the MLP half's input)
  // the int8 MLP (mlp_int8.cu): acc the int32 sum as f32, rs the row's
  // scale (sx; fc2: sy from amax[r]), cs the column's
  EPI_S8_GELU,     // f32 out = g = gelu_erf(acc*(rs*cs) + v0); amax[r] = max |g| (fc1)
  EPI_S8_OUT,      // bf16 out = acc*(sy*cs) + v0 + res_bf16                  (fc2)
  EPI_S8_OUT_F32,  // f32 out = acc*(sy*cs) + v0 + res_f32                    (fc2, f32 rows)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// x rounded to TF32, to nearest with ties away from zero (low 13 bits zero):
// the split of the 3xTF32 products (gemm_tf32x3_sm90.cuh, window_attn.cuh)
__device__ __forceinline__ float rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Window-ordered row rr of one R x R image (window wi, position i inside
// it) -> the row of the UN-rolled image it reads: the block rolls by
// -shift (x4[y][x] = x[(y+shift)%R][(x+shift)%R]) before partitioning, and
// writes its output back through the same map after rolling by +shift.
__device__ __forceinline__ int window_src(int rr, int R, int win, int shift) {
  const int n = win * win;
  const int wi = rr / n, i = rr - wi * n;
  const int nwc = R / win;
  const int y = (wi / nwc) * win + i / win;
  const int x = (wi % nwc) * win + i % win;
  return ((y + shift) % R) * R + (x + shift) % R;
}

__device__ __forceinline__ void add8(const uint4& v, float& s) {
  const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int t = 0; t < 8; ++t) s += __bfloat162float(h[t]);
}

__device__ __forceinline__ void sq8(const uint4& v, float mu, float& s) {
  const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float d = __bfloat162float(h[t]) - mu;
    s += d * d;
  }
}

// add8 / sq8 over the 16 bytes of a vector load of T: 8 bf16 or 4 f32 values,
// summed in order
template <typename T>
__device__ __forceinline__ void add16(const uint4& v, float& s) {
  if constexpr (sizeof(T) == 2) {
    add8(v, s);
  } else {
    const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
    for (int t = 0; t < 4; ++t) s += f[t];
  }
}

template <typename T>
__device__ __forceinline__ void sq16(const uint4& v, float mu, float& s) {
  if constexpr (sizeof(T) == 2) {
    sq8(v, mu, s);
  } else {
    const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float d = f[t] - mu;
      s += d * d;
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_out(float v, float* o) { *o = v; }
__device__ __forceinline__ void store_out(float v, bf16* o) { *o = __float2bfloat16(v); }

// LayerNorm over segments of Cs f32 or bf16 values (one warp per segment,
// centered two-pass f32 statistics), affine, bf16 (or, for the f32 Swin
// block, f32) out.  Segment s of input
// row r is written to output row r (nseg == 1), or, with tok_gw > 0, to the
// Swin token row of the fused frontend: input rows are (clip, chunk*gw + g),
// segments are frequency blocks fblk, and the token is
// (chunk*nseg + fblk)*gw + g of its clip.
template <typename InT, typename OutT>
__global__ void ln_rows_kernel(const InT* in, int rows, int nseg, int Cs,
                               const float* w, const float* b, float eps,
                               OutT* out, int tok_gw, int tok_rg) {
  const int seg_id = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg_id >= rows * nseg) return;
  const int r = seg_id / nseg, s = seg_id - r * nseg;
  const InT* x = in + (long long)r * nseg * Cs + (long long)s * Cs;
  float sum = 0.f;
  for (int c = lane; c < Cs; c += 32) sum += to_f32(x[c]);
  const float mu = warp_sum(sum) / Cs;
  float var = 0.f;
  for (int c = lane; c < Cs; c += 32) {
    const float d = to_f32(x[c]) - mu;
    var += d * d;
  }
  const float rs = rsqrtf(warp_sum(var) / Cs + eps);
  long long orow = r;
  if (tok_gw > 0) {
    const int img = r / tok_rg, q = r - img * tok_rg;
    const int chunk = q / tok_gw, g = q - chunk * tok_gw;
    orow = (long long)img * tok_rg * nseg + (long long)(chunk * nseg + s) * tok_gw + g;
  }
  OutT* o = out + orow * Cs;
  for (int c = lane; c < Cs; c += 32) store_out((to_f32(x[c]) - mu) * rs * w[c] + b[c], o + c);
}

template <typename InT, typename OutT>
cudaError_t launch_ln_rows(const InT* in, int rows, int nseg, int Cs, const float* w,
                           const float* b, float eps, OutT* out, int tok_gw, int tok_rg,
                           cudaStream_t stream) {
  const int warps = 8, segs = rows * nseg;
  ln_rows_kernel<InT, OutT><<<(segs + warps - 1) / warps, warps * 32, 0, stream>>>(
      in, rows, nseg, Cs, w, b, eps, out, tok_gw, tok_rg);
  return cudaGetLastError();
}

// Where the mel rows come from: output row o reads power row o below
// head_frames; the repeat-pad frontend's tiled mid rows below t_tail0 read
// head row 2 + (o - 2) % p; the rest read tail_row0 + (o - t_tail0).  Rows
// from n_frames to out_rows are written as ZERO (a NaN there would poison a
// later product even against zero weights).  A plain log-mel has
// head_frames = t_tail0 = n_frames = out_rows.
struct MelRows {
  int p, head_frames, t_tail0, tail_row0, n_frames, out_rows;
};

enum LogMode { LOG_DB = 0, LOG_NATURAL = 1 };

// Mel projection (f32 on the CUDA cores), log and optional per-bin affine
// of (B, frame_rows, n_keep) f32 power rows, one warp per output row:
// LOG_DB 10*log10(max(m, 1e-10)), LOG_NATURAL log(m + log_offset); then
// lm * sc + of when sc is not null; out (B, out_rows, n_mels), or with TRANS
// (B, n_mels, out_rows) (the K-major operand of the frontend's interp
// product, gemm_sm90.cuh).
template <typename OutT, bool TRANS = false>
__global__ void mel_log_kernel(const float* __restrict__ power, int frame_rows, int n_keep,
                               const float* __restrict__ fb, const float* __restrict__ sc,
                               const float* __restrict__ of, int n_mels, MelRows g,
                               int log_mode, float log_offset, OutT* __restrict__ out) {
  const int b = blockIdx.y;
  const int o = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (o >= g.out_rows) return;
  OutT* dst = TRANS ? out + (long long)b * n_mels * g.out_rows + o
                    : out + ((long long)b * g.out_rows + o) * n_mels;
  const long long step = TRANS ? g.out_rows : 1;
  if (o >= g.n_frames) {
    for (int m = lane; m < n_mels; m += 32) store_out(0.f, dst + m * step);
    return;
  }
  int src;
  if (o < g.head_frames) src = o;
  else if (o < g.t_tail0) src = 2 + (o - 2) % g.p;
  else src = g.tail_row0 + (o - g.t_tail0);
  const float* pw = power + ((long long)b * frame_rows + src) * n_keep;
  for (int m = lane; m < n_mels; m += 32) {
    float acc = 0.f;
    for (int f = 0; f < n_keep; ++f) acc += pw[f] * fb[f * n_mels + m];
    float lm = log_mode == LOG_DB ? 10.f * (logf(fmaxf(acc, 1e-10f)) * 0.43429448190325176f)
                                  : logf(acc + log_offset);
    if (sc != nullptr) lm = lm * sc[m] + of[m];
    store_out(lm, dst + m * step);
  }
}

template <typename OutT, bool TRANS = false>
cudaError_t launch_mel_log(const float* power, int frame_rows, int n_keep, const float* fb,
                           const float* sc, const float* of, int n_mels, MelRows g, int log_mode,
                           float log_offset, OutT* out, int B, cudaStream_t stream) {
  const int warps = 8;
  dim3 grid((g.out_rows + warps - 1) / warps, B);
  mel_log_kernel<OutT, TRANS><<<grid, warps * 32, 0, stream>>>(power, frame_rows, n_keep, fb, sc, of,
                                                        n_mels, g, log_mode, log_offset, out);
  return cudaGetLastError();
}

}  // namespace
