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
// every stage (K = C..4C >= 96), so the operations bound the block.  Heads
// are 32 wide (HTSAT-base) or 24 (HTSAT-tiny, whose stage 0 at C = 96 runs
// its qkv and proj/fc2 products on 96-column tiles and K = 96 in two steps
// of 64, the second half zero-filled by the tensor maps).  The
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
//   3. window attention (window_attn.cuh, shared with the halves): one
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
// hi and lo parts at load; the window attention's two products run as
// three TF32 products too, on mma.sync (window_attn.cuh's f32
// instantiation).  The operations bound it.
//
// Its two halves are entries of their own in both dtypes, for the blocks
// that the JAX package splits (AM_TPU_V4_STAGES, AM_TPU_ATTN_V1) and its
// public ops:
//   am_swin_attn_v3, am_swin_attn_v3_f32
//                        #8, ops/attention.py::_attn_block_call_v3
//                        (pallas_call at :869): launches 1-4 into the
//                        half's output, which the JAX kernel rounds to the
//                        activation dtype (bf16: the proj epilogue writes
//                        bf16, EPI_PROJ_BF16; f32: no rounding);
//   am_swin_mlp, am_swin_mlp_f32
//                        #9, ops/mlp.py::_mlp_call (:147): launches 5-7,
//                        the residual read from the input (bf16:
//                        EPI_RESID_IN);
//   am_swin_attn_v1, am_swin_attn_v1_f32
//                        #10, ops/attention.py::_attn_block_call (pallas_call
//                        at :400, kernel _attn_block_kernel :111):
//                        x + WindowAttention(LN(x)) with the LN1 affine
//                        applied in the kernel and per-head (heads, C, d)
//                        weights, here laid out at load as one (C, heads*d)
//                        operand (pure reshapes), so the sum over heads of
//                        ctx_h @ wp_h runs inside one K = C product; at
//                        window = resolution = 16 (the merged one-window
//                        form, AM_TPU_MERGED_ATTN) launch 3 is
//                        merged_attn.cuh's 256-token attention on a dense
//                        (1, heads, 256, 256) table over the key tiles its
//                        live-tile lists name, and the window pass
//                        and the proj scatter take the one window's map
//                        (window_src at win = R: the roll alone);
//   am_swin_attn_v2, am_swin_attn_v2_f32
//                        #11, ops/attention.py::_attn_block_call_v2
//                        (pallas_call at :363, kernel _attn_block_kernel_v2
//                        :226): the same function under v2's contract, one
//                        (C, 3C) qkv and one (C, C) projection operand; its
//                        per-head contractions over lane-masked k and v
//                        equal v1's d-wide ones (the zero lanes add
//                        nothing), so it runs v1's launches.
//                        #10 and #11 keep the LN1 affine in the kernel: the
//                        window pass writes the LN1 output itself (in f32,
//                        rounded once to the activation dtype, as the TPU
//                        kernel rolls before the cast) and the qkv epilogue
//                        adds the bias alone (bq on the q columns, zeros on
//                        k and v: EPI_BIAS_BF16, EPI_BIAS_F32), since the
//                        wgmma cores read A through TMA from plain rows and
//                        cannot normalise through the map.
// The split path's arithmetic is the whole block's, so in f32 #8 then #9
// equals am_swin_block_f32 bitwise; in bf16 they differ from am_swin_block
// by the bf16 rounding of the mid-block residual (the whole block keeps it
// f32).
#include "gemm_tf32x3_sm90.cuh"
#include "merged_attn.cuh"

namespace {

constexpr int LN1_WARPS = 8;

// Window-ordered row rr <- row window_src(rr) of its image in x (B*R*R, C)
// of T (bf16 or f32): its LN1 mean and 1/sigma (centered two-pass, f32)
// and a copy in T; or, with ln_w (the v1 and v2 halves, which keep the LN1
// affine in the kernel), the LN1 output itself, (x - mu) / sigma * ln_w +
// ln_b in f32 rounded once to T, and no statistics.  16-byte loads (8 bf16
// or 4 f32 values a lane); C % 8 == 0, C <= 1024.
template <typename T>
__global__ void __launch_bounds__(LN1_WARPS * 32)
    ln1_window_kernel(const T* __restrict__ x, int M, int R, int win, int shift, int C,
                      float eps, const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                      T* __restrict__ xw, float* __restrict__ mu, float* __restrict__ rs) {
  constexpr int VEC = 16 / sizeof(T), LOADS = 1024 / (32 * VEC);
  const int rr = blockIdx.x * LN1_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (rr >= M) return;
  const bool affine = ln_w != nullptr;
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
      if (!affine) *reinterpret_cast<uint4*>(dst + k) = v[i];
    }
  }
  const float r = rsqrtf(warp_sum(q) / C + eps);
  if (affine) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int k = lane * VEC + i * 32 * VEC;
      if (k < C) {
        if constexpr (sizeof(T) == 4) {
          const float4 w = *reinterpret_cast<const float4*>(ln_w + k);
          const float4 b = *reinterpret_cast<const float4*>(ln_b + k);
          float4& f = reinterpret_cast<float4&>(v[i]);
          f = make_float4((f.x - m) * r * w.x + b.x, (f.y - m) * r * w.y + b.y,
                          (f.z - m) * r * w.z + b.z, (f.w - m) * r * w.w + b.w);
        } else {
          float w[8], b[8];
          sm90::load8(ln_w + k, w);
          sm90::load8(ln_b + k, b);
          bf16* h = reinterpret_cast<bf16*>(&v[i]);
#pragma unroll
          for (int t = 0; t < 8; ++t)
            h[t] = __float2bfloat16((__bfloat162float(h[t]) - m) * r * w[t] + b[t]);
        }
        *reinterpret_cast<uint4*>(dst + k) = v[i];
      }
    }
  } else if (lane == 0) {
    mu[rr] = m;
    rs[rr] = r;
  }
}

// The bf16 attention half, launches 1-4 of am_swin_block: the window pass
// over x's rows into xw, the qkv product, the window attention, and the
// proj product scattered back through the un-partition/un-roll map with +
// bp + x, into out (never x itself: the epilogue reads x while it writes
// out).  Without ln_w (#1, #8, the LN1 affine folded into wqkv and bq3 by
// the caller) the pass writes each row's LN1 mean and 1/sigma into stats
// and the qkv epilogue folds LN1 in (EPI_QKV, csum the column sums of
// wqkv); with ln_w (#10, #11) it writes the LN1 output itself and the qkv
// epilogue adds the bias alone (EPI_BIAS_BF16).  PROJ: EPI_PROJ writes an
// f32 residual (#1 keeps the mid-block residual in f32), EPI_PROJ_BF16 the
// half's bf16 output (#8, #10, #11).
template <int PROJ>
int attn_half_bf16(const bf16* x, const float* ln_w, const float* ln_b, const bf16* wqkv_t,
                   const float* csum, const float* bq3, const bf16* wp_t, const float* bp,
                   const float* bm, int nbm, const int* live, int nlive, int B, int R, int C,
                   int heads, int win, int shift, float eps, float* stats, bf16* xw, bf16* qkv,
                   bf16* ctx, void* out,
                   cudaStream_t stream) {
  using namespace sm90;
  const int M = B * R * R;
  int e;

  ln1_window_kernel<bf16><<<(M + LN1_WARPS - 1) / LN1_WARPS, LN1_WARPS * 32, 0, stream>>>(
      x, M, R, win, shift, C, eps, ln_w, ln_b, xw, stats, stats == nullptr ? nullptr : stats + M);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  EpiParams p = {};
  p.M = M; p.N = 3 * C; p.out = qkv; p.ldo = 3 * C; p.v0 = bq3;
  const Operand a = rows_of(xw, M, C, C), w = rows_of(wqkv_t, 3 * C, C, C);
  if (ln_w == nullptr) {
    p.csum = csum; p.mu = stats; p.rs = stats + M;
    e = gemm<EPI_QKV>(a, w, p, 1, stream);
  } else {
    e = gemm<EPI_BIAS_BF16>(a, w, p, 1, stream);
  }
  if (e) return e;

  e = launch_attention(qkv, bm, nbm, live, nlive, M, win, heads, C, ctx, stream);
  if (e != cudaSuccess) return e;

  p = EpiParams{};
  p.M = M; p.N = C; p.out = out; p.ldo = C;
  p.R = R; p.win = win; p.shift = shift; p.v0 = bp; p.res = x;
  return gemm<PROJ>(rows_of(ctx, M, C, C), rows_of(wp_t, C, C, C), p, 1, stream);
}

// The bf16 MLP half, launches 5-7 of am_swin_block, on (M, C) rows x of
// ResT, its residual: LN2 into hbuf, fc1 + b1 and exact-erf GELU into h1,
// fc2 + b2 + x into out (bf16).  ResT f32: #1's mid-block residual
// (EPI_RESID); bf16: the MLP's input (#9, EPI_RESID_IN).
template <typename ResT>
int mlp_half_bf16(const ResT* x, int M, int C, const float* ln2w, const float* ln2b,
                  const bf16* w1_t, const float* b1, const bf16* w2_t, const float* b2,
                  float eps, bf16* hbuf, bf16* h1, bf16* out, cudaStream_t stream) {
  using namespace sm90;
  constexpr int FC2 = sizeof(ResT) == 4 ? EPI_RESID : EPI_RESID_IN;
  int e;
  if ((e = launch_ln_rows(x, M, 1, C, ln2w, ln2b, eps, hbuf, 0, 0, stream)) != cudaSuccess)
    return e;

  EpiParams p = {};
  p.M = M; p.N = 4 * C; p.out = h1; p.ldo = 4 * C; p.v0 = b1;
  if ((e = gemm<EPI_GELU>(rows_of(hbuf, M, C, C), rows_of(w1_t, 4 * C, C, C), p, 1, stream)))
    return e;

  p = EpiParams{};
  p.M = M; p.N = C; p.out = out; p.ldo = C; p.v0 = b2; p.res = x;
  return gemm<FC2>(rows_of(h1, M, 4 * C, 4 * C), rows_of(w2_t, C, 4 * C, 4 * C), p, 1, stream);
}

// The f32 attention half, launches 1-4 of am_swin_block_f32: the window
// pass over x's rows into xw, the qkv product, the f32 window attention,
// and the proj product scattered back through the un-partition/un-roll map
// with + bp + x, into out (f32; never x itself: EPI_PROJ reads x while it
// writes out).  Without ln_w (#1, #8, the LN1 affine folded into wqkv and
// bq by the caller) the pass writes each row's LN1 mean and 1/sigma into
// stats and the qkv epilogue folds LN1 in (EPI_QKV, csum the column sums
// of wqkv); with ln_w (#10, #11) it writes the LN1 output itself and the
// qkv epilogue adds the bias alone (EPI_BIAS_F32).
int attn_half_f32(const float* x, const float* ln_w, const float* ln_b, const float* wqkv_s,
                  const float* csum, const float* bq, const float* wp_s, const float* bp,
                  const float* bm, int nbm, const int* live, int nlive, int B, int R, int C,
                  int heads, int win, int shift, float eps, float* stats, float* xw, float* qkv,
                  float* ctx, float* out,
                  cudaStream_t stream) {
  using namespace tf32x3;
  const int M = B * R * R;
  int e;

  ln1_window_kernel<float><<<(M + LN1_WARPS - 1) / LN1_WARPS, LN1_WARPS * 32, 0, stream>>>(
      x, M, R, win, shift, C, eps, ln_w, ln_b, xw, stats, stats == nullptr ? nullptr : stats + M);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  EpiF32 p = {};
  p.M = M; p.N = 3 * C; p.out = qkv; p.ldo = 3 * C; p.v0 = bq;
  if (ln_w == nullptr) {
    p.csum = csum; p.mu = stats; p.rs = stats + M;
    e = gemm<EPI_QKV>(rows_of(xw, M, C, C), wqkv_s, p, stream);
  } else {
    e = gemm<EPI_BIAS_F32>(rows_of(xw, M, C, C), wqkv_s, p, stream);
  }
  if (e) return e;

  e = launch_attention(qkv, bm, nbm, live, nlive, M, win, heads, C, ctx, stream);
  if (e != cudaSuccess) return e;

  p = EpiF32{};
  p.M = M; p.N = C; p.out = out; p.ldo = C;
  p.R = R; p.win = win; p.shift = shift; p.v0 = bp; p.res = x;
  return gemm<EPI_PROJ>(rows_of(ctx, M, C, C), wp_s, p, stream);
}

// The f32 MLP half, launches 5-7 of am_swin_block_f32, on (M, C) rows x:
// LN2 into hbuf, fc1 + b1 and exact-erf GELU into h1, fc2 + b2 + x into out.
int mlp_half_f32(const float* x, int M, int C, const float* ln2w, const float* ln2b,
                 const float* w1_s, const float* b1, const float* w2_s, const float* b2,
                 float eps, float* hbuf, float* h1, float* out, cudaStream_t stream) {
  using namespace tf32x3;
  int e;
  if ((e = launch_ln_rows(x, M, 1, C, ln2w, ln2b, eps, hbuf, 0, 0, stream)) != cudaSuccess)
    return e;

  EpiF32 p = {};
  p.M = M; p.N = 4 * C; p.out = h1; p.ldo = 4 * C; p.v0 = b1;
  if ((e = gemm<EPI_GELU>(rows_of(hbuf, M, C, C), w1_s, p, stream))) return e;

  p = EpiF32{};
  p.M = M; p.N = C; p.out = out; p.ldo = C; p.v0 = b2; p.res = x;
  return gemm<EPI_RESID>(rows_of(h1, M, 4 * C, 4 * C), w2_s, p, stream);
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
  int e;
  if ((e = attn_half_bf16<EPI_PROJ>(x, nullptr, nullptr, wqkv_t, csum, bq3, wp_t, bp, bm, nbm,
                                    nullptr, 0, B, R, C, heads, win, shift, eps, stats, hbuf, qkv,
                                    ctx, res, stream)))
    return e;
  return mlp_half_bf16(res, B * R * R, C, ln2w, ln2b, w1_t, b1, w2_t, b2, eps, hbuf, h1, out,
                       stream);
}

// #8, the v3 attention half: am_swin_block's launches 1-4, the output
// rounded to bf16 (the JAX kernel's res.astype(dt)).  x, out (B, R, R, C)
// bf16; wqkv_t (3C, C), wp_t (C, C) bf16 and csum, bq3, bp, bm as
// am_swin_block's.  Scratch: stats (2, B*R*R) f32, xw (B*R*R, C), qkv
// (B*R*R, 3C), ctx (B*R*R, C) bf16.
extern "C" int am_swin_attn_v3(const bf16* x, const bf16* wqkv_t, const float* csum,
                               const float* bq3, const bf16* wp_t, const float* bp,
                               const float* bm, int nbm, int B, int R, int C, int heads, int win,
                               int shift, float eps, float* stats, bf16* xw, bf16* qkv, bf16* ctx,
                               bf16* out, cudaStream_t stream) {
  return attn_half_bf16<EPI_PROJ_BF16>(x, nullptr, nullptr, wqkv_t, csum, bq3, wp_t, bp, bm, nbm,
                                       nullptr, 0, B, R, C, heads, win, shift, eps, stats, xw, qkv,
                                       ctx, out, stream);
}

// #10 and #11, the attention half with the LN1 affine in the kernel (v1,
// v2): am_swin_block's launches 1-4 with the LN1 output written by the
// window pass and a plain qkv bias.  x, out (B, R, R, C) bf16; ln_w, ln_b
// (C) f32; wqkv_t (3C, C), wp_t (C, C) bf16, the (C, 3C) qkv and (C, C)
// proj operands transposed (v1: the per-head weights side by side,
// ops/attention.py v1_operands); bq3 (3C) the scaled q bias with zeros on k
// and v; bp, bm as v3; at window = resolution = 16 (the merged form) live,
// nlive: the table's (1, heads, 4, nlive) int32 live-tile lists
// (merged_attn.cuh; ops/attention.py merged_live_tiles), else null, 0.
// Scratch, bf16: xn (B*R*R, C), qkv (B*R*R, 3C), ctx (B*R*R, C).
extern "C" int am_swin_attn_v1(const bf16* x, const float* ln_w, const float* ln_b,
                               const bf16* wqkv_t, const float* bq3, const bf16* wp_t,
                               const float* bp, const float* bm, int nbm, const int* live,
                               int nlive, int B, int R, int C, int heads, int win, int shift,
                               float eps, bf16* xn, bf16* qkv, bf16* ctx, bf16* out,
                               cudaStream_t stream) {
  return attn_half_bf16<EPI_PROJ_BF16>(x, ln_w, ln_b, wqkv_t, nullptr, bq3, wp_t, bp, bm, nbm,
                                       live, nlive, B, R, C, heads, win, shift, eps, nullptr, xn,
                                       qkv, ctx, out, stream);
}

extern "C" int am_swin_attn_v2(const bf16* x, const float* ln_w, const float* ln_b,
                               const bf16* wqkv_t, const float* bq3, const bf16* wp_t,
                               const float* bp, const float* bm, int nbm, const int* live,
                               int nlive, int B, int R, int C, int heads, int win, int shift,
                               float eps, bf16* xn, bf16* qkv, bf16* ctx, bf16* out,
                               cudaStream_t stream) {
  return attn_half_bf16<EPI_PROJ_BF16>(x, ln_w, ln_b, wqkv_t, nullptr, bq3, wp_t, bp, bm, nbm,
                                       live, nlive, B, R, C, heads, win, shift, eps, nullptr, xn,
                                       qkv, ctx, out, stream);
}

// #9, the fused MLP: am_swin_block's launches 5-7 on (M, C) bf16 rows x with
// x as the residual.  ln_w, ln_b (C), b1 (4C), b2 (C) f32; w1_t (4C, C), w2_t
// (C, 4C) bf16.  Scratch: hbuf (M, C), h1 (M, 4C) bf16.
extern "C" int am_swin_mlp(const bf16* x, const float* ln_w, const float* ln_b,
                           const bf16* w1_t, const float* b1, const bf16* w2_t, const float* b2,
                           int M, int C, float eps, bf16* hbuf, bf16* h1, bf16* out,
                           cudaStream_t stream) {
  return mlp_half_bf16(x, M, C, ln_w, ln_b, w1_t, b1, w2_t, b2, eps, hbuf, h1, out, stream);
}

// The f32 block: x, out (B, R, R, C) f32; weights as am_swin_block's, each
// matrix its (2, N, K) f32 stack of TF32 hi over lo parts (ops/tf32.py
// tf32_split of the (N, K) matrix).  Scratch, all f32: stats (2, B*R*R),
// qkv (B*R*R, 3C), ctx/hbuf (B*R*R, C) (hbuf first holds the window-ordered
// rows, then the LN2 output), res (B*R*R, C), h1 (B*R*R, 4C).  C a
// multiple of 64 or 96, C <= 1024, heads 24 or 32 wide (ops/attention.py
// check_block_gemms, _check_geometry).
extern "C" int am_swin_block_f32(const float* x, const float* wqkv_s, const float* csum,
                                 const float* bq3, const float* wp_s, const float* bp,
                                 const float* bm, int nbm, const float* ln2w, const float* ln2b,
                                 const float* w1_s, const float* b1, const float* w2_s,
                                 const float* b2, int B, int R, int C, int heads, int win,
                                 int shift, float eps, float* stats, float* qkv, float* ctx,
                                 float* res, float* hbuf, float* h1, float* out,
                                 cudaStream_t stream) {
  int e;
  if ((e = attn_half_f32(x, nullptr, nullptr, wqkv_s, csum, bq3, wp_s, bp, bm, nbm, nullptr, 0,
                         B, R, C, heads, win, shift, eps, stats, hbuf, qkv, ctx, res, stream)))
    return e;
  return mlp_half_f32(res, B * R * R, C, ln2w, ln2b, w1_s, b1, w2_s, b2, eps, hbuf, h1, out,
                      stream);
}

// #8 in f32, the v3 attention half: am_swin_block_f32's launches 1-4.  x,
// out (B, R, R, C) f32; wqkv_s, wp_s the (2, N, K) stacks of the (N, K)
// matrices; csum, bq3, bp, bm as am_swin_block_f32's.  Scratch, f32: stats
// (2, B*R*R), xw (B*R*R, C), qkv (B*R*R, 3C), ctx (B*R*R, C).
extern "C" int am_swin_attn_v3_f32(const float* x, const float* wqkv_s, const float* csum,
                                   const float* bq3, const float* wp_s, const float* bp,
                                   const float* bm, int nbm, int B, int R, int C, int heads,
                                   int win, int shift, float eps, float* stats, float* xw,
                                   float* qkv, float* ctx, float* out, cudaStream_t stream) {
  return attn_half_f32(x, nullptr, nullptr, wqkv_s, csum, bq3, wp_s, bp, bm, nbm, nullptr, 0, B,
                       R, C, heads, win, shift, eps, stats, xw, qkv, ctx, out, stream);
}

// #10 and #11 in f32, the attention half with the LN1 affine in the kernel
// (v1, v2): x, out (B, R, R, C) f32; ln_w, ln_b (C); wqkv_s, wp_s the
// (2, N, K) stacks of the (C, 3C) qkv and (C, C) proj operands transposed
// (v1: the per-head weights side by side, as am_swin_attn_v1's); bq3
// (3C) the scaled q bias with zeros on k and v; bp, bm, live, nlive as
// am_swin_attn_v1's.  Scratch, f32: xn (B*R*R, C), qkv (B*R*R, 3C), ctx
// (B*R*R, C).
extern "C" int am_swin_attn_v1_f32(const float* x, const float* ln_w, const float* ln_b,
                                   const float* wqkv_s, const float* bq3, const float* wp_s,
                                   const float* bp, const float* bm, int nbm, const int* live,
                                   int nlive, int B, int R, int C, int heads, int win, int shift,
                                   float eps, float* xn, float* qkv, float* ctx, float* out,
                                   cudaStream_t stream) {
  return attn_half_f32(x, ln_w, ln_b, wqkv_s, nullptr, bq3, wp_s, bp, bm, nbm, live, nlive, B, R,
                       C, heads, win, shift, eps, nullptr, xn, qkv, ctx, out, stream);
}

extern "C" int am_swin_attn_v2_f32(const float* x, const float* ln_w, const float* ln_b,
                                   const float* wqkv_s, const float* bq3, const float* wp_s,
                                   const float* bp, const float* bm, int nbm, const int* live,
                                   int nlive, int B, int R, int C, int heads, int win, int shift,
                                   float eps, float* xn, float* qkv, float* ctx, float* out,
                                   cudaStream_t stream) {
  return attn_half_f32(x, ln_w, ln_b, wqkv_s, nullptr, bq3, wp_s, bp, bm, nbm, live, nlive, B, R,
                       C, heads, win, shift, eps, nullptr, xn, qkv, ctx, out, stream);
}

// The window attention alone, launch 3 of am_swin_block(_f32) and of the
// attention halves, heads 24 or 32 wide: qkv (windows*64, 3C) in window
// order, q pre-scaled; bm (nbm, heads, 64, 64) f32; ctx (windows*64, C).
// No model path calls them: profile_window_attn.py times the f32 kernel
// through its entry, chip_smoke.py holds both against their plain version.
extern "C" int am_window_attn_f32(const float* qkv, const float* bm, int nbm, int windows,
                                  int heads, int C, float* ctx, cudaStream_t stream) {
  return launch_window_attn(qkv, bm, nbm, windows, heads, C, ctx, stream);
}

extern "C" int am_window_attn(const bf16* qkv, const float* bm, int nbm, int windows, int heads,
                              int C, bf16* ctx, cudaStream_t stream) {
  return launch_window_attn(qkv, bm, nbm, windows, heads, C, ctx, stream);
}

// The merged attention alone, launch 3 of the v1 and v2 halves at window =
// resolution = 16: qkv (windows*256, 3C) in window order, q pre-scaled; bm
// (1, heads, 256, 256) f32 and its live lists (1, heads, 4, nlive) int32;
// ctx (windows*256, C).  No model path calls them: chip_smoke.py phase 21
// holds them against the dense design (kernels/csrc/dense/
// merged_attn_dense.cu) on the same qkv.
extern "C" int am_merged_attn(const bf16* qkv, const float* bm, const int* live, int nlive,
                              int windows, int heads, int C, bf16* ctx, cudaStream_t stream) {
  return launch_merged_attn(qkv, bm, 1, live, nlive, windows, heads, C, ctx, stream);
}

extern "C" int am_merged_attn_f32(const float* qkv, const float* bm, const int* live, int nlive,
                                  int windows, int heads, int C, float* ctx,
                                  cudaStream_t stream) {
  return launch_merged_attn(qkv, bm, 1, live, nlive, windows, heads, C, ctx, stream);
}

// #9 in f32, the fused MLP: am_swin_block_f32's launches 5-7 on (M, C) rows
// x with x as the residual.  ln_w, ln_b (C), b1 (4C), b2 (C) f32; w1_s,
// w2_s the (2, 4C, C) and (2, C, 4C) stacks.  Scratch, f32: hbuf (M, C), h1
// (M, 4C).
extern "C" int am_swin_mlp_f32(const float* x, const float* ln_w, const float* ln_b,
                               const float* w1_s, const float* b1, const float* w2_s,
                               const float* b2, int M, int C, float eps, float* hbuf, float* h1,
                               float* out, cudaStream_t stream) {
  return mlp_half_f32(x, M, C, ln_w, ln_b, w1_s, b1, w2_s, b2, eps, hbuf, h1, out, stream);
}
