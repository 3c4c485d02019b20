// Whole Swin block (HTSAT), bf16 activations, f32 statistics and softmax.
//
// Replaces the TPU kernel audio_metrics_tpu/ops/attention.py::
// _swin_block_call_v4 (pallas_call at :1109, kernel _swin_block_kernel_v4
// :951): LN1 folded through the qkv product, cyclic roll by -shift, 8x8
// window partition, scores + relative-position bias + shift mask, f32
// softmax, context, output projection, un-partition, roll by +shift,
// residual; then LN2, fc1, exact-erf GELU, fc2, residual.
//
// What bounds it here: the four products (qkv, proj, fc1, fc2: 24 T C^2 of
// the block's ~(24 T C^2 + 256 T C) operations) are tensor-core work at
// every stage (K = C..4C >= 128), so the operations bound the block.  The
// TPU kernel held a whole image block in ~100 MB of VMEM; a Hopper block has
// 227 KB of shared memory, so the block is a chain of launches, each keeping
// its own working set on chip.  The first design (the WMMA core of gemm.cuh)
// lost its time in the products: 64x64 single-buffered WMMA tiles at ~5% of
// the bf16 peak, and a qkv GEMM that recomputed each row's LN1 statistics
// through the window map in every one of its 3C/64 column blocks.  This one:
//   1. LN1 statistics once per row (ln1_window_kernel, one warp per row):
//      reads each row of x once through the roll/partition map, writes its
//      mean and 1/sigma (f32) and the row itself in window order (bf16), so
//      the product reads plain rows that TMA can load;
//   2. qkv product on the wgmma core (gemm_sm90.cuh), epilogue
//      rs*(x@W) - rs*mu*(1@W) + bq3 with the column sums 1@W computed once
//      at weight load (the f32 sum of the bf16 W), not per tile;
//   3. window attention (window_attn.cuh, shared with swin_halves.cu): one
//      block per (window, head) holds q, k, v, the 64x64 f32 scores and bf16
//      probabilities in shared memory; bias and mask added in f32 (mask
//      -100, HTSAT's convention);
//   4. proj product: + bp, scattered back through the same map
//      (un-partition + un-roll), + the bf16 input, into an f32 residual
//      buffer (the TPU kernel also keeps it f32);
//   5. LN2 (one warp per row) -> bf16;
//   6. fc1 product + b1, exact-erf GELU -> bf16;
//   7. fc2 product + b2 + the f32 residual -> bf16 block output.
// The rounding points are the first design's (and the plain version's):
// qkv, probabilities, context, LN2 output and GELU output in bf16.
//
// am_swin_block_f32, the f32 counterpart (the JAX kernel takes the
// activation dtype; the default CLAP embedder runs in f32): the same seven
// steps with every intermediate f32, as swin_block_plain keeps them at f32
// (no rounding point).  The four products run on the tensor cores as three
// TF32 products each (gemm_tf32x3_sm90.cuh: f32-level accuracy, ~165
// TFLOP/s of f32-accurate products against the CUDA cores' 67), with the
// same epilogue arithmetic in f32 out, reading the weights split into TF32
// hi and lo parts at load; the window attention's products stay f32 FMAs
// (window_attn.cuh's f32 instantiation).  The operations bound it.
#include "gemm_tf32x3_sm90.cuh"
#include "window_attn.cuh"

namespace {

constexpr int LN1_WARPS = 8;

// Window-ordered row rr <- row window_src(rr) of its image in x (B*R*R, C)
// of T (bf16 or f32): its LN1 mean and 1/sigma (centered two-pass, f32,
// summed in the order of gemm.cuh's in-block prologue) and a copy in T.
// 16-byte loads (8 bf16 or 4 f32 values a lane); C % 8 == 0, C <= 1024.
template <typename T>
__global__ void __launch_bounds__(LN1_WARPS * 32)
    ln1_window_kernel(const T* __restrict__ x, int M, int R, int win, int shift, int C,
                      float eps, T* __restrict__ xw, float* __restrict__ mu,
                      float* __restrict__ rs) {
  constexpr int VEC = 16 / sizeof(T), LOADS = 1024 / (32 * VEC);
  const int rr = blockIdx.x * LN1_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (rr >= M) return;
  const int rr2 = R * R, img = rr / rr2;
  const T* src = x + ((long long)img * rr2 + window_src(rr - img * rr2, R, win, shift)) * C;
  T* dst = xw + (long long)rr * C;
  uint4 v[LOADS];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int k = lane * VEC + i * 32 * VEC;
    if (k < C) {
      v[i] = *reinterpret_cast<const uint4*>(src + k);
      add16<T>(v[i], s);
    }
  }
  const float m = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int k = lane * VEC + i * 32 * VEC;
    if (k < C) {
      sq16<T>(v[i], m, q);
      *reinterpret_cast<uint4*>(dst + k) = v[i];
    }
  }
  const float r = rsqrtf(warp_sum(q) / C + eps);
  if (lane == 0) {
    mu[rr] = m;
    rs[rr] = r;
  }
}

}  // namespace

// x, out: (B, R, R, C) bf16.  Weights transposed to (N, K), K-major: wqkv_t
// (3C, C), wp_t (C, C), w1_t (4C, C), w2_t (C, 4C) bf16; csum (3C) the f32
// column sums of wqkv; bq3 (3C), bp (C), ln2 (C), b1 (4C), b2 (C) f32; bm
// (nbm, heads, 64, 64) f32 with nbm = windows per image or 1.  Scratch:
// stats (2, B*R*R) f32, qkv (B*R*R, 3C) bf16, ctx/hbuf (B*R*R, C) bf16 (hbuf
// first holds the window-ordered rows), res (B*R*R, C) f32, h1 (B*R*R, 4C)
// bf16.
extern "C" int am_swin_block(const bf16* x, const bf16* wqkv_t, const float* csum,
                             const float* bq3, const bf16* wp_t, const float* bp, const float* bm,
                             int nbm, const float* ln2w, const float* ln2b, const bf16* w1_t,
                             const float* b1, const bf16* w2_t, const float* b2, int B, int R,
                             int C, int heads, int win, int shift, float eps, float* stats,
                             bf16* qkv, bf16* ctx, float* res, bf16* hbuf, bf16* h1, bf16* out,
                             cudaStream_t stream) {
  using namespace sm90;
  const int M = B * R * R;
  int e;

  ln1_window_kernel<bf16><<<(M + LN1_WARPS - 1) / LN1_WARPS, LN1_WARPS * 32, 0, stream>>>(
      x, M, R, win, shift, C, eps, hbuf, stats, stats + M);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  EpiParams p = {};
  p.M = M; p.N = 3 * C; p.out = qkv; p.ldo = 3 * C;
  p.v0 = bq3; p.csum = csum; p.mu = stats; p.rs = stats + M;
  if ((e = gemm<EPI_QKV>(rows_of(hbuf, M, C, C), rows_of(wqkv_t, 3 * C, C, C), p, 1, stream)))
    return e;

  if ((e = launch_window_attn(qkv, bm, nbm, M / WIN_N, heads, C, ctx, stream)) != cudaSuccess)
    return e;

  p = EpiParams{};
  p.M = M; p.N = C; p.out = res; p.ldo = C;
  p.R = R; p.win = win; p.shift = shift; p.v0 = bp; p.res = x;
  if ((e = gemm<EPI_PROJ>(rows_of(ctx, M, C, C), rows_of(wp_t, C, C, C), p, 1, stream)))
    return e;

  if ((e = launch_ln_rows(res, M, 1, C, ln2w, ln2b, eps, hbuf, 0, 0, stream)) != cudaSuccess)
    return e;

  p = EpiParams{};
  p.M = M; p.N = 4 * C; p.out = h1; p.ldo = 4 * C; p.v0 = b1;
  if ((e = gemm<EPI_GELU>(rows_of(hbuf, M, C, C), rows_of(w1_t, 4 * C, C, C), p, 1, stream)))
    return e;

  p = EpiParams{};
  p.M = M; p.N = C; p.out = out; p.ldo = C; p.v0 = b2; p.res = res;
  return gemm<EPI_RESID>(rows_of(h1, M, 4 * C, 4 * C), rows_of(w2_t, C, 4 * C, 4 * C), p, 1,
                         stream);
}

// The f32 block: x, out (B, R, R, C) f32; weights as am_swin_block's, each
// matrix its (2, N, K) f32 stack of TF32 hi over lo parts (ops/tf32.py
// tf32_split of the (N, K) matrix).  Scratch, all f32: stats (2, B*R*R),
// qkv (B*R*R, 3C), ctx/hbuf (B*R*R, C) (hbuf first holds the window-ordered
// rows, then the LN2 output), res (B*R*R, C), h1 (B*R*R, 4C).  C % 64 ==
// 0, C <= 1024 (ops/attention.py check_block_f32).
extern "C" int am_swin_block_f32(const float* x, const float* wqkv_s, const float* csum,
                                 const float* bq3, const float* wp_s, const float* bp,
                                 const float* bm, int nbm, const float* ln2w, const float* ln2b,
                                 const float* w1_s, const float* b1, const float* w2_s,
                                 const float* b2, int B, int R, int C, int heads, int win,
                                 int shift, float eps, float* stats, float* qkv, float* ctx,
                                 float* res, float* hbuf, float* h1, float* out,
                                 cudaStream_t stream) {
  using namespace tf32x3;
  const int M = B * R * R;
  int e;

  ln1_window_kernel<float><<<(M + LN1_WARPS - 1) / LN1_WARPS, LN1_WARPS * 32, 0, stream>>>(
      x, M, R, win, shift, C, eps, hbuf, stats, stats + M);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  EpiF32 p = {};
  p.M = M; p.N = 3 * C; p.out = qkv; p.ldo = 3 * C;
  p.v0 = bq3; p.csum = csum; p.mu = stats; p.rs = stats + M;
  if ((e = gemm<EPI_QKV>(rows_of(hbuf, M, C, C), wqkv_s, p, stream))) return e;

  if ((e = launch_window_attn(qkv, bm, nbm, M / WIN_N, heads, C, ctx, stream)) != cudaSuccess)
    return e;

  p = EpiF32{};
  p.M = M; p.N = C; p.out = res; p.ldo = C;
  p.R = R; p.win = win; p.shift = shift; p.v0 = bp; p.res = x;
  if ((e = gemm<EPI_PROJ>(rows_of(ctx, M, C, C), wp_s, p, stream))) return e;

  if ((e = launch_ln_rows(res, M, 1, C, ln2w, ln2b, eps, hbuf, 0, 0, stream)) != cudaSuccess)
    return e;

  p = EpiF32{};
  p.M = M; p.N = 4 * C; p.out = h1; p.ldo = 4 * C; p.v0 = b1;
  if ((e = gemm<EPI_GELU>(rows_of(hbuf, M, C, C), w1_s, p, stream))) return e;

  p = EpiF32{};
  p.M = M; p.N = C; p.out = out; p.ldo = C; p.v0 = b2; p.res = res;
  return gemm<EPI_RESID>(rows_of(h1, M, 4 * C, 4 * C), w2_s, p, stream);
}
