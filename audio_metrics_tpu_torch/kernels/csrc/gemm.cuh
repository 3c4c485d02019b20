// Shared building blocks of the hand-written Hopper kernels.
//
// gemm_kernel<AMODE, EPI>: a bf16 x bf16 -> f32-accumulate tensor-core GEMM
// (WMMA 16x16x16 fragments, 64x64 block tile, BK=32, 4 warps of 32x32),
// C = A (M x K, bf16) @ B (K x N, bf16 row-major), with
//   - an A-row map (AMODE) that gathers rows by index arithmetic instead of
//     materialising a gathered copy: plain rows, Swin window partition under
//     the cyclic roll, or the 2x2 patch-merge quadrant concat;
//   - an optional in-block LayerNorm-statistics prologue (centered two-pass,
//     f32) over each A row, for epilogues that fold the LN through the
//     product (rs * (x @ W) - rs * mu * (1 @ W) + b);
//   - an epilogue (EPI) that applies biases, residuals, activation and the
//     output row map, staged through shared memory so global stores are
//     coalesced along N.
// blockIdx.z indexes independent batch slices (strides a_batch / b_batch /
// o_batch, 0 for a shared operand).
//
// Simple and right first: single-buffered shared tiles loaded with 16-byte
// vector loads, no cp.async/TMA/wgmma.  Requirements checked by the Python
// wrappers: K % 32 == 0, N % 64 == 0, 16-byte aligned rows (lda, ldb
// multiples of 8 elements).  M may be ragged.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32, GEMM_THREADS = 128;
constexpr int LDA_S = BK + 8;  // shared row pitches: multiples of 8 bf16 /
constexpr int LDB_S = BN + 8;  // 4 f32 as WMMA requires, padded against
constexpr int LDC_S = BN + 4;  // bank conflicts

enum AMode { A_ROWS = 0, A_WINDOW = 1, A_MERGE = 2 };
enum Epi {
  EPI_QKV = 0,    // bf16 out = acc*rs - rs*mu*colsum(B) + v0      (LN1 fold)
  EPI_PROJ,       // f32 out[map(r)] = acc + v0 + res_bf16[map(r)] (un-partition, un-roll, residual)
  EPI_GELU,       // bf16 out = gelu_erf(acc + v0)
  EPI_RESID,      // bf16 out = acc + v0 + res_f32
  EPI_MERGE,      // bf16 out = acc*rs + (v1 - mu*rs*v0)           (merge LN fold)
  EPI_POWER,      // f32 out[n/2] = acc[n]^2 + acc[n+1]^2          (interleaved re/im)
  EPI_INTERP,     // bf16 out[r % rg][(r / rg)*N + n] = acc        (phase rows -> lanes)
  EPI_BIAS_F32,   // f32 out = acc + v0
};

struct GemmParams {
  int M, N, K;
  const bf16* A; long long lda; long long a_batch;
  const bf16* B; long long ldb; long long b_batch;
  void* out; long long ldo; long long o_batch;
  int R, win, shift, C;  // image geometry for the A_WINDOW / A_MERGE maps
  float eps;
  const float* v0; const float* v1;
  const void* res;
  int rg;
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

template <int AM>
__device__ __forceinline__ const bf16* a_ptr(const GemmParams& p, int z, int r, int k) {
  if (AM == A_ROWS) return p.A + z * p.a_batch + (long long)r * p.lda + k;
  const int rr2 = p.R * p.R;
  if (AM == A_WINDOW) {
    const int img = r / rr2;
    const int src = window_src(r - img * rr2, p.R, p.win, p.shift);
    return p.A + ((long long)img * rr2 + src) * p.lda + k;
  }
  // A_MERGE: output pixel r = (img, i2, j2) of the (R/2)^2 grid; A column
  // k = j*C + c of the virtual concat [x00, x10, x01, x11]: quadrant j reads
  // row offset j & 1, column offset j >> 1.
  const int h2 = p.R / 2;
  const int img = r / (h2 * h2);
  const int q = r - img * h2 * h2;
  const int i2 = q / h2, j2 = q - (q / h2) * h2;
  const int j = k / p.C, c = k - j * p.C;
  const int src = (2 * i2 + (j & 1)) * p.R + 2 * j2 + (j >> 1);
  return p.A + ((long long)img * rr2 + src) * p.lda + c;
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

template <int AM, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(const GemmParams p) {
  constexpr int AB_BYTES = (BM * LDA_S + BK * LDB_S) * 2;
  constexpr int C_BYTES = BM * LDC_S * 4;
  __shared__ __align__(128) unsigned char smem[AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES];
  __shared__ float s_mu[BM], s_rs[BM], s_csum[BN];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDA_S;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int z = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr bool STATS = (EPI == EPI_QKV || EPI == EPI_MERGE);

  if (STATS) {
    for (int rr = warp; rr < BM; rr += GEMM_THREADS / 32) {
      const int r = m0 + rr;
      float mu = 0.f, rs = 0.f;
      if (r < p.M) {
        float s = 0.f;
        for (int k = lane * 8; k < p.K; k += 256)
          add8(*reinterpret_cast<const uint4*>(a_ptr<AM>(p, z, r, k)), s);
        mu = warp_sum(s) / p.K;
        float v = 0.f;
        for (int k = lane * 8; k < p.K; k += 256)
          sq8(*reinterpret_cast<const uint4*>(a_ptr<AM>(p, z, r, k)), mu, v);
        rs = rsqrtf(warp_sum(v) / p.K + p.eps);
      }
      if (lane == 0) { s_mu[rr] = mu; s_rs[rr] = rs; }
    }
  }
  float csum = 0.f;  // EPI_QKV: column sum of B (== 1 @ W) for column tid

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const bf16* Bz = p.B + z * p.b_batch;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    for (int i = tid; i < BM * BK / 8; i += GEMM_THREADS) {
      const int row = i / (BK / 8), col = (i % (BK / 8)) * 8;
      const int r = m0 + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < p.M) v = *reinterpret_cast<const uint4*>(a_ptr<AM>(p, z, r, k0 + col));
      *reinterpret_cast<uint4*>(&As[row * LDA_S + col]) = v;
    }
    for (int i = tid; i < BK * BN / 8; i += GEMM_THREADS) {
      const int row = i / (BN / 8), col = (i % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[row * LDB_S + col]) =
          *reinterpret_cast<const uint4*>(Bz + (long long)(k0 + row) * p.ldb + n0 + col);
    }
    __syncthreads();
    if (EPI == EPI_QKV && tid < BN) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) csum += __bfloat162float(Bs[kk * LDB_S + tid]);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * LDA_S + kk, LDA_S);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + kk * LDB_S + wn + 16 * j, LDB_S);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (EPI == EPI_QKV && tid < BN) s_csum[tid] = csum;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC_S + wn + 16 * j, acc[i][j], LDC_S,
                              wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < BM * BN; i += GEMM_THREADS) {
    const int row = i / BN, col = i % BN;
    const int r = m0 + row, n = n0 + col;
    if (r >= p.M) continue;
    const float a = Cs[row * LDC_S + col];
    if (EPI == EPI_QKV) {
      const float rs = s_rs[row];
      const float v = a * rs - rs * s_mu[row] * s_csum[col] + p.v0[n];
      static_cast<bf16*>(p.out)[(long long)r * p.ldo + n] = __float2bfloat16(v);
    } else if (EPI == EPI_PROJ) {
      const int rr2 = p.R * p.R;
      const int img = r / rr2;
      const long long o = (long long)img * rr2 + window_src(r - img * rr2, p.R, p.win, p.shift);
      const float x = __bfloat162float(static_cast<const bf16*>(p.res)[o * p.ldo + n]);
      static_cast<float*>(p.out)[o * p.ldo + n] = a + p.v0[n] + x;
    } else if (EPI == EPI_GELU) {
      const float v = a + p.v0[n];
      const float g = 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
      static_cast<bf16*>(p.out)[(long long)r * p.ldo + n] = __float2bfloat16(g);
    } else if (EPI == EPI_RESID) {
      const long long o = (long long)r * p.ldo + n;
      const float v = a + p.v0[n] + static_cast<const float*>(p.res)[o];
      static_cast<bf16*>(p.out)[o] = __float2bfloat16(v);
    } else if (EPI == EPI_MERGE) {
      const float rs = s_rs[row];
      const float v = a * rs + (p.v1[n] - s_mu[row] * rs * p.v0[n]);
      static_cast<bf16*>(p.out)[(long long)r * p.ldo + n] = __float2bfloat16(v);
    } else if (EPI == EPI_POWER) {
      if (col & 1) continue;
      const float b = Cs[row * LDC_S + col + 1];
      static_cast<float*>(p.out)[z * p.o_batch + (long long)r * p.ldo + n / 2] = a * a + b * b;
    } else if (EPI == EPI_INTERP) {
      const long long o = z * p.o_batch + (long long)(r % p.rg) * p.ldo + (r / p.rg) * p.N + n;
      static_cast<bf16*>(p.out)[o] = __float2bfloat16(a);
    } else {  // EPI_BIAS_F32
      static_cast<float*>(p.out)[z * p.o_batch + (long long)r * p.ldo + n] = a + p.v0[n];
    }
  }
}

template <int AM, int EPI>
cudaError_t launch_gemm(const GemmParams& p, int batch, cudaStream_t stream) {
  dim3 grid(p.N / BN, (p.M + BM - 1) / BM, batch);
  gemm_kernel<AM, EPI><<<grid, GEMM_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

inline GemmParams gemm_params(int M, int N, int K, const bf16* A, long long lda,
                              const bf16* B, long long ldb, void* out, long long ldo) {
  GemmParams p = {};
  p.M = M; p.N = N; p.K = K;
  p.A = A; p.lda = lda; p.B = B; p.ldb = ldb; p.out = out; p.ldo = ldo;
  return p;
}

// LayerNorm over segments of Cs f32 values (one warp per segment, centered
// two-pass statistics), affine, bf16 out.  Segment s of input row r is
// written to output row r (nseg == 1), or, with tok_gw > 0, to the Swin
// token row of the fused frontend: input rows are (clip, chunk*gw + g),
// segments are frequency blocks fblk, and the token is
// (chunk*nseg + fblk)*gw + g of its clip.
__global__ void ln_rows_kernel(const float* in, int rows, int nseg, int Cs,
                               const float* w, const float* b, float eps,
                               bf16* out, int tok_gw, int tok_rg) {
  const int seg_id = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg_id >= rows * nseg) return;
  const int r = seg_id / nseg, s = seg_id - r * nseg;
  const float* x = in + (long long)r * nseg * Cs + (long long)s * Cs;
  float sum = 0.f;
  for (int c = lane; c < Cs; c += 32) sum += x[c];
  const float mu = warp_sum(sum) / Cs;
  float var = 0.f;
  for (int c = lane; c < Cs; c += 32) {
    const float d = x[c] - mu;
    var += d * d;
  }
  const float rs = rsqrtf(warp_sum(var) / Cs + eps);
  long long orow = r;
  if (tok_gw > 0) {
    const int img = r / tok_rg, q = r - img * tok_rg;
    const int chunk = q / tok_gw, g = q - chunk * tok_gw;
    orow = (long long)img * tok_rg * nseg + (long long)(chunk * nseg + s) * tok_gw + g;
  }
  bf16* o = out + orow * Cs;
  for (int c = lane; c < Cs; c += 32) o[c] = __float2bfloat16((x[c] - mu) * rs * w[c] + b[c]);
}

inline cudaError_t launch_ln_rows(const float* in, int rows, int nseg, int Cs, const float* w,
                                  const float* b, float eps, bf16* out, int tok_gw, int tok_rg,
                                  cudaStream_t stream) {
  const int warps = 8, segs = rows * nseg;
  ln_rows_kernel<<<(segs + warps - 1) / warps, warps * 32, 0, stream>>>(
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

__device__ __forceinline__ void store_out(float v, float* o) { *o = v; }
__device__ __forceinline__ void store_out(float v, bf16* o) { *o = __float2bfloat16(v); }

// Mel projection (f32 on the CUDA cores), log and optional per-bin affine
// of (B, frame_rows, n_keep) f32 power rows, one warp per output row:
// LOG_DB 10*log10(max(m, 1e-10)), LOG_NATURAL log(m + log_offset); then
// lm * sc + of when sc is not null; out (B, out_rows, n_mels).
template <typename OutT>
__global__ void mel_log_kernel(const float* __restrict__ power, int frame_rows, int n_keep,
                               const float* __restrict__ fb, const float* __restrict__ sc,
                               const float* __restrict__ of, int n_mels, MelRows g,
                               int log_mode, float log_offset, OutT* __restrict__ out) {
  const int b = blockIdx.y;
  const int o = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (o >= g.out_rows) return;
  OutT* dst = out + ((long long)b * g.out_rows + o) * n_mels;
  if (o >= g.n_frames) {
    for (int m = lane; m < n_mels; m += 32) store_out(0.f, dst + m);
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
    store_out(lm, dst + m);
  }
}

template <typename OutT>
cudaError_t launch_mel_log(const float* power, int frame_rows, int n_keep, const float* fb,
                           const float* sc, const float* of, int n_mels, MelRows g, int log_mode,
                           float log_offset, OutT* out, int B, cudaStream_t stream) {
  const int warps = 8;
  dim3 grid((g.out_rows + warps - 1) / warps, B);
  mel_log_kernel<OutT><<<grid, warps * 32, 0, stream>>>(power, frame_rows, n_keep, fb, sc, of,
                                                        n_mels, g, log_mode, log_offset, out);
  return cudaGetLastError();
}

}  // namespace
