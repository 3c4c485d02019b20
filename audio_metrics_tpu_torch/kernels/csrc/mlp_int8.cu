// The Swin block's MLP half with W8A8 int8 products (HTSAT), bf16 or f32 in
// and out (the activation dtype: am_swin_mlp_int8, am_swin_mlp_int8_f32).
//
// Replaces audio_metrics_tpu/ops/mlp.py::_mlp_call_int8 (pallas_call at
// :228, kernel _mlp_kernel_int8 :166): x + fc2(GELU(fc1(LN(x)))) where both
// products take int8 operands and accumulate in int32.  The weights come
// quantised per output column and transposed to (N, K), made once at load
// (ops/mlp.py::mlp_int8_operands, the XLA prep of mlp.py:216-223); the
// activations are quantised per row here:
//   sx  = max(max|xn|, 1e-12) * f32(1/127),  qx = rint(xn / sx)
//   y   = GELU(f32(qx @ q1) * (sx * s1) + b1)   (exact erf)
//   sy  = max(max|y|, 1e-12) * f32(1/127),   qy = rint(y / sy)
//   out = f32(qy @ q2) * (sy * s2) + b2 + x, rounded to bf16 in bf16
// Rounding is half to even (rintf, as jnp.round and torch.round), the
// quotients are IEEE divisions, and every multiply and add is rounded on its
// own (__fmul_rn / __fadd_rn: nothing contracts into an fma), so a code
// differs from the plain version's only where an f32 statistic summed in
// another order moves a quotient across a half.
//
// What bounds it here: the two products, 16 T C^2 int8 operations (the
// tensor cores' int8 rate), against 2 T C activations in and out.  Both run
// on gemm_sm90.cuh's wgmma + TMA ring on int8 codes
// (wgmma.m64nBNk32.s32.s8.s8, 128 codes a stage row), their dequantising
// epilogues 8 columns a thread (s8_epilogue8).  The TPU kernel held a row
// tile with its (rows, 4C) hidden tensor in VMEM and quantised it there.  A
// Hopper block computes one column block of fc1, and the per-row scale sy
// needs all 4C columns of a row, so this is four launches:
//   1. LN + row quantisation, one warp per row -> qx int8 (M, C), sx (M);
//   2. fc1 (EPI_S8_GELU); epilogue: dequantise, bias, GELU -> y f32 (M, 4C),
//      and the row's max |y|: a max over the lanes of a tile row, then one
//      atomicMax per row and column tile on the float's bits;
//   3. quantise y -> qy int8 (M, 4C);
//   4. fc2 (EPI_S8_OUT, _F32); epilogue: dequantise, bias, the input -> out.
// The f32 hidden tensor round-trips device memory (~10 bytes an element of
// y with the codes).  Measured against running fc1 twice (its max alone,
// then the same sums and epilogue writing the codes on the complete max):
// that saves the f32 round trip but was 17% slower at B = 64 on an H100
// (PERF.md), the exact-erf epilogue costing more than the bytes it saves.
// In f32 the same launches run on f32 rows: only the LN pass's loads, the
// residual and the output change type (the JAX kernel reads x_ref and
// writes out_ref in the activation dtype, its arithmetic f32 throughout).
#include "gemm_sm90.cuh"

namespace {

using sm90::row_scale;

// One warp per row of x (M, C) bf16 or f32: LN statistics in f32 (the mean, then
// the mean of squared deviations), the affine, sx from the row's max |xn|,
// then qx = rint(xn / sx); xn is recomputed by the same expression in each
// pass, so every pass sees the same values.
template <typename T>
__global__ void ln_quant_kernel(const T* __restrict__ x, int M, int C,
                                const float* __restrict__ w, const float* __restrict__ b,
                                float eps, signed char* __restrict__ qx, float* __restrict__ sx) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= M) return;
  const T* xr = x + (long long)r * C;
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += to_f32(xr[c]);
  const float mu = warp_sum(sum) / C;
  float var = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f32(xr[c]) - mu;
    var += d * d;
  }
  const float rs = rsqrtf(warp_sum(var) / C + eps);
  auto xn = [&](int c) {
    const float d = __fsub_rn(to_f32(xr[c]), mu);
    return __fadd_rn(__fmul_rn(__fmul_rn(d, rs), w[c]), b[c]);
  };
  float m = 0.f;
  for (int c = lane; c < C; c += 32) m = fmaxf(m, fabsf(xn(c)));
  const float s = row_scale(warp_max(m));
  for (int c = lane; c < C; c += 32)
    qx[(long long)r * C + c] = static_cast<signed char>(__float2int_rn(__fdiv_rn(xn(c), s)));
  if (lane == 0) sx[r] = s;
}

// y (M, N) f32 -> qy = rint(y / sy) int8, sy from the row's max |y|; four
// values per thread (N % 4 == 0, so the four share a row).
__global__ void quant_rows_kernel(const float4* __restrict__ y, const int* __restrict__ amax,
                                  int N, long long n_quads, char4* __restrict__ qy) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_quads) return;
  const float s = row_scale(__int_as_float(amax[(i * 4) / N]));
  const float4 v = y[i];
  qy[i] = make_char4(static_cast<signed char>(__float2int_rn(__fdiv_rn(v.x, s))),
                     static_cast<signed char>(__float2int_rn(__fdiv_rn(v.y, s))),
                     static_cast<signed char>(__float2int_rn(__fdiv_rn(v.z, s))),
                     static_cast<signed char>(__float2int_rn(__fdiv_rn(v.w, s))));
}

// The launches on x (M, C) of T.  ln_w, ln_b (C), b1 (4C), b2 (C) f32;
// q1t (4C, C) and q2t (C, 4C) int8, the fc1 and fc2 weights' codes
// transposed (output-major); s1 (4C), s2 (C) f32 their column scales.
// Scratch: qx (M, C) int8, sx (M) f32, hid (M, 4C) f32, amax (M) int32, qy
// (M, 4C) int8.
template <typename T>
int mlp_int8(const T* x, const float* ln_w, const float* ln_b, const int8_t* q1t,
             const float* s1, const float* b1, const int8_t* q2t, const float* s2,
             const float* b2, int M, int C, float eps, int8_t* qx, float* sx, float* hid,
             int* amax, int8_t* qy, T* out, cudaStream_t stream) {
  using sm90::rows_of;
  int e;
  const int warps = 8;
  ln_quant_kernel<T><<<(M + warps - 1) / warps, warps * 32, 0, stream>>>(x, M, C, ln_w, ln_b,
                                                                          eps, qx, sx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = cudaMemsetAsync(amax, 0, sizeof(int) * M, stream)) != cudaSuccess) return e;

  sm90::EpiParams p = {};
  p.M = M; p.N = 4 * C; p.ldo = 4 * C; p.out = hid;
  p.v0 = b1; p.rscale = sx; p.cscale = s1; p.amax = amax;
  if ((e = sm90::gemm<EPI_S8_GELU, int8_t>(rows_of(qx, M, C, C), rows_of(q1t, 4 * C, C, C), p,
                                           1, stream)) != 0)
    return e;

  const long long n_quads = (long long)M * C;  // M * 4C / 4
  quant_rows_kernel<<<(unsigned)((n_quads + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(hid), amax, 4 * C, n_quads, reinterpret_cast<char4*>(qy));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  p = {};
  p.M = M; p.N = C; p.ldo = C;
  p.v0 = b2; p.cscale = s2; p.amax = amax; p.res = x; p.out = out;
  constexpr int FC2 = sizeof(T) == 4 ? EPI_S8_OUT_F32 : EPI_S8_OUT;
  return sm90::gemm<FC2, int8_t>(rows_of(qy, M, 4 * C, 4 * C), rows_of(q2t, C, 4 * C, 4 * C),
                                 p, 1, stream);
}

}  // namespace

// x, out: (M, C) bf16; the rest as mlp_int8's.
extern "C" int am_swin_mlp_int8(const bf16* x, const float* ln_w, const float* ln_b,
                                const int8_t* q1t, const float* s1, const float* b1,
                                const int8_t* q2t, const float* s2, const float* b2, int M,
                                int C, float eps, int8_t* qx, float* sx, float* hid, int* amax,
                                int8_t* qy, bf16* out, cudaStream_t stream) {
  return mlp_int8(x, ln_w, ln_b, q1t, s1, b1, q2t, s2, b2, M, C, eps, qx, sx, hid, amax, qy, out,
                  stream);
}

// #12 in f32: x, out (M, C) f32 (no rounding at the end); the rest as
// mlp_int8's.
extern "C" int am_swin_mlp_int8_f32(const float* x, const float* ln_w, const float* ln_b,
                                    const int8_t* q1t, const float* s1, const float* b1,
                                    const int8_t* q2t, const float* s2, const float* b2, int M,
                                    int C, float eps, int8_t* qx, float* sx, float* hid,
                                    int* amax, int8_t* qy, float* out, cudaStream_t stream) {
  return mlp_int8(x, ln_w, ln_b, q1t, s1, b1, q2t, s2, b2, M, C, eps, qx, sx, hid, amax, qy, out,
                  stream);
}
