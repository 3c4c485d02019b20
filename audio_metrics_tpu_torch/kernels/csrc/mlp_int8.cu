// The Swin block's MLP half with W8A8 int8 products (HTSAT), bf16 or f32 in
// and out (the activation dtype: am_swin_mlp_int8, am_swin_mlp_int8_f32).
//
// Replaces audio_metrics_tpu/ops/mlp.py::_mlp_call_int8 (pallas_call at
// :228, kernel _mlp_kernel_int8 :166): x + fc2(GELU(fc1(LN(x)))) where both
// products take int8 operands and accumulate in int32.  The weights come
// quantised per output column (ops/mlp.py::quantize_columns, the XLA prep of
// mlp.py:216-223); the activations are quantised per row here:
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
// tensor cores' int8 rate), against 2 T C activations in and out.  The TPU
// kernel held a row tile with its (rows, 4C) hidden tensor in VMEM and
// quantised it there.  A Hopper block computes one column block of fc1, and
// the per-row scale sy needs all 4C columns of a row, so this first kernel
// is four launches:
//   1. LN + row quantisation, one warp per row -> qx int8 (M, C), sx (M);
//   2. fc1 int8 GEMM; epilogue: dequantise, bias, GELU -> y f32 (M, 4C), and
//      the row's max |y|: a shared-memory max per block tile, then one
//      atomicMax per row on the float's bits (|y| >= 0, so integer order is
//      float order);
//   3. quantise y -> qy int8 (M, 4C);
//   4. fc2 int8 GEMM; epilogue: dequantise, bias, the input -> out.
// In f32 the same four launches run on f32 rows: only the LN pass's loads,
// the residual and the output change type (the JAX kernel reads x_ref and
// writes out_ref in the activation dtype, its arithmetic f32 throughout).
// The f32 hidden tensor round-trips device memory and the GEMM is
// single-buffered WMMA: later speed work.
#include "gemm.cuh"

namespace {

constexpr int QK = 16;        // K of one WMMA int8 fragment: 16 bytes
constexpr int QBK = 64;       // K of one shared tile: four fragments
constexpr int QLDC = BN + 4;  // int32 staging pitch
constexpr float INV127 = 0x1.020408p-7f;  // f32(1/127), jnp.float32(1.0 / 127.0)
constexpr float AMAX_FLOOR = 1e-12f;
constexpr float SQRT1_2 = 0.7071067811865476f;

enum QEpi { QEPI_FC1 = 0, QEPI_FC2 = 1 };

struct QGemmParams {
  int M, N, K;
  const signed char* A;   // (M, K) row-major codes
  const signed char* Bt;  // (N, K) row-major: the (K, N) weight's codes transposed
  const float* rscale;    // QEPI_FC1: sx (M)
  const int* ramax;       // QEPI_FC2: max |y| of each row, as float bits (M)
  const float* cscale;    // per-column weight scale (N)
  const float* bias;      // (N)
  float* hid;             // QEPI_FC1: y (M, N) f32
  int* amax;              // QEPI_FC1: max |y| of each row (M), zero before the launch
  const void* res;        // QEPI_FC2: x (M, N), bf16 or f32
  void* out;              // QEPI_FC2: (M, N), x's type
};

__device__ __forceinline__ float row_scale(float amax) {
  return __fmul_rn(fmaxf(amax, AMAX_FLOOR), INV127);
}

// The residual x[o] of the fc2 epilogue, in f32
__device__ __forceinline__ float residual(const bf16* x, long long o) {
  return __bfloat162float(x[o]);
}
__device__ __forceinline__ float residual(const float* x, long long o) { return x[o]; }

// C = A @ B with int8 codes on the tensor cores (WMMA s8 16x16x16, int32
// accumulate), 64x64 block tile, 4 warps of 32x32, K tiles of 64.  WMMA wants
// 32-byte aligned fragment pointers, so each shared tile is stored as four
// K-chunks of 16 bytes per row, [chunk][row][16]: every fragment then starts
// on a multiple of 256 bytes, A row-major and B column-major with ldm 16.
// Requirements (checked by the wrapper): K % 64 == 0, N % 64 == 0; M ragged.
// T: the activation type, of QEPI_FC2's residual and output.
template <int EPI, typename T>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_s8_kernel(const QGemmParams p) {
  constexpr int KC = QBK / QK;
  constexpr int AB_BYTES = (BM + BN) * QBK;
  constexpr int C_BYTES = BM * QLDC * 4;
  __shared__ __align__(128) unsigned char smem[AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES];
  __shared__ int s_amax[BM];
  signed char* As = reinterpret_cast<signed char*>(smem);
  signed char* Bs = As + BM * QBK;
  int* Cs = reinterpret_cast<int*>(smem);  // reused after the K loop

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5;
  if (EPI == QEPI_FC1 && tid < BM) s_amax[tid] = 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  for (int k0 = 0; k0 < p.K; k0 += QBK) {
    for (int i = tid; i < BM * KC; i += GEMM_THREADS) {
      const int row = i / KC, kc = i % KC, r = m0 + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < p.M) v = *reinterpret_cast<const uint4*>(p.A + (long long)r * p.K + k0 + kc * QK);
      *reinterpret_cast<uint4*>(As + (kc * BM + row) * QK) = v;
    }
    for (int i = tid; i < BN * KC; i += GEMM_THREADS) {
      const int col = i / KC, kc = i % KC;
      *reinterpret_cast<uint4*>(Bs + (kc * BN + col) * QK) =
          *reinterpret_cast<const uint4*>(p.Bt + (long long)(n0 + col) * p.K + k0 + kc * QK);
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (kc * BM + wm + 16 * i) * QK, QK);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + (kc * BN + wn + 16 * j) * QK, QK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * QLDC + wn + 16 * j, acc[i][j], QLDC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < BM * BN; i += GEMM_THREADS) {
    const int row = i / BN, col = i % BN;
    const int r = m0 + row, n = n0 + col;
    if (r >= p.M) continue;
    const float a = __int2float_rn(Cs[row * QLDC + col]);
    const long long o = (long long)r * p.N + n;
    if (EPI == QEPI_FC1) {
      const float y = __fadd_rn(__fmul_rn(a, __fmul_rn(p.rscale[r], p.cscale[n])), p.bias[n]);
      const float g = __fmul_rn(__fmul_rn(y, 0.5f), __fadd_rn(1.f, erff(__fmul_rn(y, SQRT1_2))));
      p.hid[o] = g;
      atomicMax(&s_amax[row], __float_as_int(fabsf(g)));
    } else {
      const float sy = row_scale(__int_as_float(p.ramax[r]));
      const float z = __fadd_rn(__fmul_rn(a, __fmul_rn(sy, p.cscale[n])), p.bias[n]);
      store_out(__fadd_rn(z, residual(static_cast<const T*>(p.res), o)),
                static_cast<T*>(p.out) + o);
    }
  }
  if (EPI == QEPI_FC1) {
    __syncthreads();
    if (tid < BM && m0 + tid < p.M) atomicMax(&p.amax[m0 + tid], s_amax[tid]);
  }
}

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

// The four launches on x (M, C) of T.  ln_w, ln_b (C), b1 (4C), b2 (C) f32;
// q1t (4C, C) and q2t (C, 4C) int8, the fc1 and fc2 weights' codes
// transposed (output-major); s1 (4C), s2 (C) f32 their column scales.
// Scratch: qx (M, C) int8, sx (M) f32, hid (M, 4C) f32, amax (M) int32, qy
// (M, 4C) int8.
template <typename T>
int mlp_int8(const T* x, const float* ln_w, const float* ln_b, const signed char* q1t,
             const float* s1, const float* b1, const signed char* q2t, const float* s2,
             const float* b2, int M, int C, float eps, signed char* qx, float* sx, float* hid,
             int* amax, signed char* qy, T* out, cudaStream_t stream) {
  cudaError_t e;
  const int warps = 8;
  ln_quant_kernel<T><<<(M + warps - 1) / warps, warps * 32, 0, stream>>>(x, M, C, ln_w, ln_b,
                                                                          eps, qx, sx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = cudaMemsetAsync(amax, 0, sizeof(int) * M, stream)) != cudaSuccess) return e;

  QGemmParams p = {};
  p.M = M; p.N = 4 * C; p.K = C;
  p.A = qx; p.Bt = q1t; p.rscale = sx; p.cscale = s1; p.bias = b1; p.hid = hid; p.amax = amax;
  gemm_s8_kernel<QEPI_FC1, T><<<dim3(p.N / BN, (M + BM - 1) / BM), GEMM_THREADS, 0, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const long long n_quads = (long long)M * C;  // M * 4C / 4
  quant_rows_kernel<<<(unsigned)((n_quads + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(hid), amax, 4 * C, n_quads, reinterpret_cast<char4*>(qy));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  p = {};
  p.M = M; p.N = C; p.K = 4 * C;
  p.A = qy; p.Bt = q2t; p.ramax = amax; p.cscale = s2; p.bias = b2; p.res = x; p.out = out;
  gemm_s8_kernel<QEPI_FC2, T><<<dim3(p.N / BN, (M + BM - 1) / BM), GEMM_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x, out: (M, C) bf16; the rest as mlp_int8's.
extern "C" int am_swin_mlp_int8(const bf16* x, const float* ln_w, const float* ln_b,
                                const signed char* q1t, const float* s1, const float* b1,
                                const signed char* q2t, const float* s2, const float* b2, int M,
                                int C, float eps, signed char* qx, float* sx, float* hid,
                                int* amax, signed char* qy, bf16* out, cudaStream_t stream) {
  return mlp_int8(x, ln_w, ln_b, q1t, s1, b1, q2t, s2, b2, M, C, eps, qx, sx, hid, amax, qy, out,
                  stream);
}

// #12 in f32: x, out (M, C) f32 (no rounding at the end); the rest as
// mlp_int8's.
extern "C" int am_swin_mlp_int8_f32(const float* x, const float* ln_w, const float* ln_b,
                                    const signed char* q1t, const float* s1, const float* b1,
                                    const signed char* q2t, const float* s2, const float* b2,
                                    int M, int C, float eps, signed char* qx, float* sx,
                                    float* hid, int* amax, signed char* qy, float* out,
                                    cudaStream_t stream) {
  return mlp_int8(x, ln_w, ln_b, q1t, s1, b1, q2t, s2, b2, M, C, eps, qx, sx, hid, amax, qy, out,
                  stream);
}
