// Log-mel spectrogram: the halo kernel (frames read in place from hop rows)
// and the v1 kernel (frames materialised in device memory), both on the
// wgmma core through one DFT + mel kernel, log_mel_sm90_kernel.
//
// Replaces the TPU kernel audio_metrics_tpu/ops/mel.py::log_mel_pallas_halo
// (pallas_call at :554): bf16 frames x bf16 windowed-DFT basis cut to the
// filterbank's support, f32 accumulation, power, f32 mel product, dB or
// natural log, optional per-bin affine, f32 or bf16 out, exactly n_frames
// rows.
//
// What bounds it here: the DFT product, 2 * frames * frame_length *
// 2*n_keep bf16 operations (CLAP 10 s: 1001 x 1024 x 768 per clip, ~1.6
// GFLOP) against 989 TFLOP/s on the tensor cores, then the mel product
// (n_keep x n_mels per frame, ~49 MFLOP per 10 s clip) in f32 on the CUDA
// cores; the clip is read once (1.9 MB f32) and the log-mel written once
// (128 KB bf16).  The first design ran the DFT on a WMMA core (~5% of an
// H100's bf16 peak), wrote the (B, n_frames, n_keep) f32 powers to device
// memory (98 MB at B = 64, 10 s) and read them back in gemm.cuh's
// mel_log_kernel, after three PyTorch passes of prologue.  Now two launches:
//   1. hop rows: one pass writes each clip's bf16 signal rows straight from
//      the f32 clip (reflect pad when centered, the clip, zeros up to
//      clip_stride), as frontend.cu's hop_rows_kernel does for #3;
//   2. the DFT on the wgmma core's TMA ring (gemm_sm90.cuh produce_tile /
//      consume_tile), A read in place through the 3-D (k, frame, clip)
//      tensor map of #3's DFT: frame stride = hop (960 bytes for CLAP, 320
//      for VGGish) below the frame, so the overlapping frames never exist in
//      memory; K is the frame padded to the 64-element swizzle box, against
//      zero basis columns (VGGish 400 -> 448).  B is the basis transposed
//      (2*n_keep, K) with cos/sin rows interleaved.  A block owns a tile of
//      128 frame rows and sweeps all 2*n_keep basis columns, 128 at a time:
//      each N tile's accumulators become 64 powers re^2 + im^2 per row in
//      registers (a thread holds both halves of its column pairs), staged
//      in shared memory beside that tile's 64 filterbank rows (cp.async),
//      and summed into a (rows x 64 mels) f32 accumulator held in registers
//      across the N tiles, bins in ascending order.  After the last N tile
//      the block writes log and affine in the output dtype.  Nothing but
//      the hop rows and the output touches device memory.
// gemm.cuh's mel_log_kernel stays for #3.
//
// The v1 kernel replaces audio_metrics_tpu/ops/mel.py::log_mel_pallas
// (pallas_call at :360): the same function, with the overlapping frames
// materialised in device memory as the TPU wrapper does (bf16, the one
// intermediate that TPU kernel writes to HBM).  Its bound is the halo
// kernel's (same input, output and operations); what it pays on top is the
// frame matrix, written once and read once (CLAP 10 s: 1001 x 1024 bf16 per
// clip, 2.1 MB, against the 1.9 MB f32 clip).  Two launches:
//   1. frame rows: one pass writes the (B*n_frames, k_pad) bf16 frame
//      matrix straight from the f32 clip, the reflect pad applied by index
//      as in the hop rows, zero past the signal and from frame_length to
//      k_pad (the TPU wrapper's frames are n_chunks*hop wide, but the basis
//      rows past frame_length are zero there, so the cut changes no value;
//      k_pad is the frame padded to the 64-element box, as the halo's K).
//      The pitch is k_pad, not the hop, so any hop is served;
//   2. log_mel_sm90_kernel over that matrix read as ONE run of B*n_frames
//      rows (a map of batch 1, the TPU kernel's flat row tiling): a 128-row
//      tile may span two clips, and only the last tile is ragged.  Each
//      row's sums depend on its row alone, so where both kernels run (hop %
//      8 == 0) the output equals the halo kernel's bitwise.
#include "gemm_sm90.cuh"

namespace {

// frames[(z*n_frames + r)*k_pad + j] = bf16(sample r*hop + j of clip z's
// padded signal) for j < frame_length, halo_rows_kernel's formula; zero for
// j from frame_length to k_pad (the buffer is uninitialised, and a NaN
// there times a zero basis column would be NaN).  Eight samples a thread,
// one 16-byte store, over a (row tiles, clip) grid.
__global__ void frame_rows_kernel(const float* __restrict__ audio, int n, int half, int hop,
                                  int frame_length, int k_pad, int n_frames,
                                  bf16* __restrict__ frames) {
  const float* x = audio + (long long)blockIdx.y * n;
  bf16* f = frames + (long long)blockIdx.y * n_frames * k_pad;
  const int vecs = k_pad / 8, total = n_frames * vecs;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int r = i / vecs, j = 8 * (i - r * vecs);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int s = r * hop + j + e - half;
      v[e] = j + e >= frame_length ? 0.f
             : s < 0               ? x[-s]
             : s < n               ? x[s]
             : s < n + half        ? x[2 * n - 2 - s]
                                   : 0.f;
    }
    sm90::store8(f + 8 * i, v);
  }
}

// hops[b][j] = bf16(the padded signal's sample j) for j < clip_stride: x[half
// - j] (left reflect pad), x[j - half], x[2n - 2 - (j - half)] (right
// reflect pad), then zero; half = 0 for an uncentered signal.  Eight samples
// a thread, one 16-byte store.
__global__ void halo_rows_kernel(const float* __restrict__ audio, int n, int half,
                                 int clip_stride, bf16* __restrict__ hops) {
  const float* x = audio + (long long)blockIdx.y * n;
  bf16* h = hops + (long long)blockIdx.y * clip_stride;
  for (int j = 8 * (blockIdx.x * blockDim.x + threadIdx.x); j < clip_stride;
       j += 8 * gridDim.x * blockDim.x) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int s = j + e - half;
      v[e] = s < 0 ? x[-s] : s < n ? x[s] : s < n + half ? x[2 * n - 2 - s] : 0.f;
    }
    sm90::store8(h + j, v);
  }
}

}  // namespace

namespace {
namespace sm90 {

constexpr int MEL_BN = 128;           // basis columns per N tile: 64 (re, im) pairs
constexpr int MEL_BINS = MEL_BN / 2;  // power bins per N tile
constexpr int MEL_N = 64;             // mel bins (CLAP and VGGish)
constexpr int LDP = MEL_BINS + 4;     // power staging pitch: conflict-free rows

// What the fused epilogue reads and writes.
struct MelEpi {
  int n_frames, n_tiles;    // output rows per map batch (a clip; v1: all); N tiles
  const float* fb;          // (n_keep, MEL_N) f32
  const float* sc;          // per-bin affine, or null
  const float* of;
  int log_mode;
  float log_offset;
  void* out;                // (B, n_frames, MEL_N)
};

struct MelSmem {
  using S = Smem<MEL_BN>;
  static constexpr int P_FLOATS = 64 * LDP;              // a warpgroup's powers
  static constexpr int F_FLOATS = MEL_BINS * MEL_N;      // a warpgroup's filterbank rows
  static constexpr int BYTES = 1024 + STAGES * (S::A_BYTES + S::B_BYTES) +
                               CONSUMERS * (P_FLOATS + F_FLOATS) * 4 + 2 * STAGES * 8;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// mel_log_kernel's log (gemm.cuh): LOG_DB 10*log10(max(m, 1e-10)), LOG_NATURAL
// log(m + offset)
__device__ __forceinline__ float log_of(float m, int mode, float offset) {
  return mode == LOG_DB ? 10.f * (logf(fmaxf(m, 1e-10f)) * 0.43429448190325176f)
                        : logf(m + offset);
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* dst, const float* v) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(dst) = u;
}

// One block per SM, persistent over (map batch, 128-row frame tile) tiles; the
// ring as gemm_sm90_kernel's (one TMA producer thread, two consumer
// warpgroups of 64 rows each), every tile sweeping the p.n_tiles N tiles
// of the basis.  Consumer thread tid owns mel rows rq + 16 i (i < 4) of its
// warpgroup's 64 and mels 4 mg + 32 h + e (h < 2, e < 4), rq = tid / 8,
// mg = tid % 8.
template <typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
    log_mel_sm90_kernel(const __grid_constant__ CUtensorMap tma_a,
                        const __grid_constant__ CUtensorMap tma_b, const MelEpi p, int K,
                        int batch) {
  using S = Smem<MEL_BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((s0 + 1023) & ~1023u) - s0);  // 1024-aligned for the swizzle
  uint8_t* sA = base;
  uint8_t* sB = sA + STAGES * S::A_BYTES;
  float* sP = reinterpret_cast<float*>(sB + STAGES * S::B_BYTES);
  float* sF = sP + CONSUMERS * MelSmem::P_FLOATS;
  uint64_t* full = reinterpret_cast<uint64_t*>(sF + CONSUMERS * MelSmem::F_FLOATS);
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m_tiles = (p.n_frames + BM - 1) / BM, tiles = batch * m_tiles, ksteps = K / BK;
  int stage = 0;
  uint32_t phase = 0;

  if (wg == CONSUMERS) {  // producer: one thread keeps the ring full
    if (tid != 0) return;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      for (int nt = 0; nt < p.n_tiles; ++nt)
        produce_tile<MEL_BN>(RowsA{1}, &tma_a, &tma_b, sA, sB, full, empty, ksteps,
                             t % m_tiles, nt, t / m_tiles, 0, stage, phase);
    return;
  }

  float acc[MEL_BN / 2];
#pragma unroll
  for (int i = 0; i < MEL_BN / 2; ++i) acc[i] = 0.f;
  float* P = sP + wg * MelSmem::P_FLOATS;
  float* F = sF + wg * MelSmem::F_FLOATS;
  const int warp = tid / 32, lane = tid % 32, rq = tid / 8, mg = tid % 8;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int mt = t % m_tiles, z = t / m_tiles;
    float mel[4][8];
    for (int nt = 0; nt < p.n_tiles; ++nt) {
      if (nt == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int m = 0; m < 8; ++m) mel[i][m] = 0.f;
      }
      named_sync(1 + wg, 128);  // the last mel step has read P and F
      // this N tile's 64 filterbank rows -> F, while the products run
      const float* fb = p.fb + (long long)nt * MelSmem::F_FLOATS;
      for (int i = tid; i < MelSmem::F_FLOATS / 4; i += 128) cp_async16(F + 4 * i, fb + 4 * i);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      consume_tile<MEL_BN>(acc, sA, sB, full, empty, wg, ksteps, stage, phase);
      // powers: acc[4j + 2i + e] is row 16*warp + lane/4 + 8i, column 8j +
      // 2*(lane%4) + e, the (re, im) pair of bin 4j + lane%4 of the tile
#pragma unroll
      for (int j = 0; j < MEL_BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float re = acc[4 * j + 2 * i], im = acc[4 * j + 2 * i + 1];
          P[(16 * warp + lane / 4 + 8 * i) * LDP + 4 * j + lane % 4] = re * re + im * im;
        }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      named_sync(1 + wg, 128);
      // mel += powers @ filterbank rows, bins in ascending order
#pragma unroll 4
      for (int f = 0; f < MEL_BINS; f += 4) {
        float4 pr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pr[i] = *reinterpret_cast<const float4*>(&P[(rq + 16 * i) * LDP + f]);
#pragma unroll
        for (int ff = 0; ff < 4; ++ff) {
          const float4 w0 = *reinterpret_cast<const float4*>(&F[(f + ff) * MEL_N + 4 * mg]);
          const float4 w1 = *reinterpret_cast<const float4*>(&F[(f + ff) * MEL_N + 32 + 4 * mg]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pw = reinterpret_cast<const float*>(&pr[i])[ff];
            mel[i][0] = fmaf(pw, w0.x, mel[i][0]);
            mel[i][1] = fmaf(pw, w0.y, mel[i][1]);
            mel[i][2] = fmaf(pw, w0.z, mel[i][2]);
            mel[i][3] = fmaf(pw, w0.w, mel[i][3]);
            mel[i][4] = fmaf(pw, w1.x, mel[i][4]);
            mel[i][5] = fmaf(pw, w1.y, mel[i][5]);
            mel[i][6] = fmaf(pw, w1.z, mel[i][6]);
            mel[i][7] = fmaf(pw, w1.w, mel[i][7]);
          }
        }
      }
    }
    // log, then the affine, in the output dtype: exactly n_frames rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = mt * BM + wg * 64 + rq + 16 * i;
      if (r >= p.n_frames) continue;
      OutT* o = static_cast<OutT*>(p.out) + ((long long)z * p.n_frames + r) * MEL_N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 32 * h + 4 * mg + e;
          v[e] = mel[i][4 * h + e];
          v[e] = log_of(v[e], p.log_mode, p.log_offset);
          if (p.sc != nullptr) v[e] = v[e] * p.sc[m] + p.of[m];
        }
        store4(o + 32 * h + 4 * mg, v);
      }
    }
  }
}

template <typename OutT>
int launch_log_mel(const CUtensorMap& ta, const CUtensorMap& tb, const MelEpi& p, int K,
                   int batch, cudaStream_t stream) {
  const int dev = current_card();
  if (dev >= MAX_CARDS) return cudaErrorInvalidDevice;
  static bool attr[MAX_CARDS] = {};  // per instantiation and card
  int e;
  if (!attr[dev]) {
    if ((e = cudaFuncSetAttribute(log_mel_sm90_kernel<OutT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  MelSmem::BYTES)) != cudaSuccess)
      return e;
    attr[dev] = true;
  }
  const int tiles = batch * ((p.n_frames + BM - 1) / BM), sms = sm_count(dev);
  log_mel_sm90_kernel<OutT><<<tiles < sms ? tiles : sms, THREADS, MelSmem::BYTES, stream>>>(
      ta, tb, p, K, batch);
  return cudaGetLastError();
}

// The DFT, power, mel and log of log_mel_sm90_kernel over bf16 frame rows
// at `a`, read through the 3-D map {k_pad, rows, batch} of row and batch
// strides `row_stride`, `batch_stride` (elements) and box {box_k, box_rows,
// box_b}; B: basis_t (2*n_keep, k_pad).  Output row z*rows + r.
int dft_log_mel(const bf16* a, int k_pad, int rows, int batch, int row_stride, int batch_stride,
                int box_k, int box_rows, int box_b, const bf16* basis_t, int n_keep,
                const float* fb, const float* sc, const float* of, int log_mode,
                float log_offset, int out_bf16, void* out, cudaStream_t stream) {
  CUtensorMap ta, tb;
  const cuuint64_t dims[3] = {(cuuint64_t)k_pad, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 2, (cuuint64_t)batch_stride * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_k, (cuuint32_t)box_rows, (cuuint32_t)box_b};
  int e;
  if ((e = encode_map(&ta, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, dims, strides, box)))
    return e;
  if ((e = encode(&tb, rows_of(basis_t, 2 * n_keep, k_pad, k_pad), MEL_BN)) != 0) return e;
  const MelEpi p = {rows, 2 * n_keep / MEL_BN, fb, sc, of, log_mode, log_offset, out};
  return out_bf16 ? launch_log_mel<bf16>(ta, tb, p, k_pad, batch, stream)
                  : launch_log_mel<float>(ta, tb, p, k_pad, batch, stream);
}

}  // namespace sm90
}  // namespace

// audio: (B, n) f32 clips.  Scratch: hops (B, clip_stride) bf16.  The A
// map: dims {k_pad, n_frames, B}, strides {hop, clip_stride} (elements),
// box {64, 128, 1}, the wrapper's table (ops/mel.py halo_dft_map).
// basis_t: (2*n_keep, k_pad) bf16, cos/sin rows interleaved, zero columns
// past the frame length.  fb: (n_keep, 64) f32.  sc/of: (64) f32 or null.
// out: (B, n_frames, 64), bf16 when out_bf16 else f32.
extern "C" int am_log_mel(const float* audio, int n, int half, bf16* hops, int k_pad,
                          int n_frames, int batch, int hop, int clip_stride, int box_k,
                          int box_rows, int box_b, const bf16* basis_t, int n_keep,
                          const float* fb, const float* sc, const float* of, int n_mels,
                          int log_mode, float log_offset, int out_bf16, void* out,
                          cudaStream_t stream) {
  using namespace sm90;
  if (box_k != sm90::BK || box_rows != sm90::BM || box_b != 1 || n_mels != MEL_N ||
      n_keep % MEL_BINS || k_pad % sm90::BK || clip_stride % 8)
    return (int)cudaErrorInvalidValue;
  const int per_clip = (clip_stride / 8 + 255) / 256;
  halo_rows_kernel<<<dim3(per_clip < 1024 ? per_clip : 1024, batch), 256, 0, stream>>>(
      audio, n, half, clip_stride, hops);
  const int e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return dft_log_mel(hops, k_pad, n_frames, batch, hop, clip_stride, box_k, box_rows, box_b,
                     basis_t, n_keep, fb, sc, of, log_mode, log_offset, out_bf16, out, stream);
}

// audio: (B, n) f32 clips, framed by frame_rows_kernel into the scratch
// frames (B*n_frames, k_pad) bf16: B clips of n_frames frames of
// frame_length samples at hop (any hop), reflect-padded by half.  The A
// map: dims {k_pad, B*n_frames, 1}, strides {k_pad, B*n_frames*k_pad}
// (elements), box {64, 128, 1}, the wrapper's table (ops/mel.py
// v1_dft_map).  basis_t, fb, sc, of, out as am_log_mel.
extern "C" int am_log_mel_v1(const float* audio, int n, int half, bf16* frames, int k_pad,
                             int rows, int one, int row_stride, int batch_stride, int box_k,
                             int box_rows, int box_b, const bf16* basis_t, int n_keep,
                             const float* fb, const float* sc, const float* of, int n_mels,
                             int log_mode, float log_offset, int out_bf16, void* out, int batch,
                             int n_frames, int hop, int frame_length, cudaStream_t stream) {
  using namespace sm90;
  if (box_k != sm90::BK || box_rows != sm90::BM || box_b != 1 || n_mels != MEL_N ||
      n_keep % MEL_BINS || k_pad % sm90::BK || one != 1 || row_stride != k_pad ||
      rows != batch * n_frames || frame_length > k_pad)
    return (int)cudaErrorInvalidValue;
  const int per_clip = (n_frames * (k_pad / 8) + 255) / 256;
  frame_rows_kernel<<<dim3(per_clip < 1024 ? per_clip : 1024, batch), 256, 0, stream>>>(
      audio, n, half, hop, frame_length, k_pad, n_frames, frames);
  const int e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return dft_log_mel(frames, k_pad, rows, one, row_stride, batch_stride, box_k, box_rows, box_b,
                     basis_t, n_keep, fb, sc, of, log_mode, log_offset, out_bf16, out, stream);
}
