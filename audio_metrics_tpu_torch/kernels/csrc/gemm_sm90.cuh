// Hopper GEMM core of the whole Swin block (#1, swin_block.cu) and its
// halves (#8 v3 attention, #9 fused MLP, #10 and #11 the v1 and v2
// attention halves: the block's own launches), the patch merge (#2,
// patch_merge.cu), the fused frontend (#3, frontend.cu) and the halo
// log-mel (#6, log_mel.cu, which runs the ring below, produce_tile and
// consume_tile, under an epilogue of its own): bf16 x bf16 -> f32
// accumulate with wgmma, fed by TMA through a ring of shared-memory stages.
//
//   out[z] = epilogue(A[z] (M x K) @ B[z]^T),  B[z] held (N x K)
//
// Layout: both operands K-major (rows of K contiguous bf16), so one TMA box
// shape, one 128-byte swizzle and one wgmma descriptor serve A and B.  The
// weights are stored transposed once at load for this (models/htsat.py
// SwinBlock, ops/frontend_fused.py frontend_tables); the plain versions keep
// reading the (K, N) layout.  A runtime B (the frontend's mel) is written
// transposed by the kernel that makes it.
//
// Shape of a block (one per SM, persistent over output tiles):
//   - warpgroups 0-1 consume: each owns 64 rows of the 128 x BN tile and
//     issues wgmma.m64nBNk16 (BN 128, or 64 where N is not a multiple of
//     128), one commit group per K step of 64, keeping one group in flight;
//   - warpgroup 2, one thread, produces: TMA loads of the A (128 x 64) and B
//     (BN x 64) boxes into a ring of STAGES stages with full / empty
//     mbarriers, running ahead across tiles, so one tile's epilogue overlaps
//     the next tile's loads (at K = 128 a tile has only two K steps);
//   - epilogue: each consumer warpgroup stages its 64 x BN f32 accumulators
//     in shared memory (padded rows) and applies its epilogue (epilogue8)
//     to 8 columns at a time, 16-byte loads and stores coalesced along N,
//     through the row maps (un-partition / un-roll, phase rows -> lanes).
// Tensor maps are 3-D (k, row, batch) and encoded on the host per launch
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: no -lcuda); a
// batch index z > 0 is read only from the operand that has a batch.  A
// caller whose A is laid out otherwise encodes A's map itself and passes the
// producer a loader of its own (gemm_mapped; patch_merge.cu's MergeA).  Rows
// past M are zero-filled by TMA and masked in the epilogue.  Requirements
// (checked by the Python wrappers through kernels.check_sm90_gemm): K % 64
// == 0, N % 64 == 0, row and batch strides multiples of 8 elements (16
// bytes), 16-byte aligned base pointers.  No atomics: a run repeats
// bitwise.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include "gemm.cuh"

namespace {
namespace sm90 {

constexpr int BM = 128, BK = 64, STAGES = 4, CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;

// One operand as TMA sees it: `rows` rows of K bf16 at row stride `ld`
// elements, `batch` copies `batch_stride` elements apart.
struct Operand {
  const bf16* ptr;
  int rows, K;
  long long ld;
  int batch;
  long long batch_stride;
};

inline Operand rows_of(const bf16* ptr, int rows, int K, long long ld) {
  return Operand{ptr, rows, K, ld, 1, (long long)rows * ld};
}

// What the epilogue reads and writes.
struct EpiParams {
  int M, N;
  void* out;
  long long ldo, o_batch;
  int R, win, shift;       // EPI_PROJ's window map
  const float* v0;         // bias
  const float* csum;       // EPI_QKV: f32 column sums of W (1 @ W); EPI_MERGE: g @ W
  const float* mu;         // EPI_QKV, EPI_MERGE: LN mean and 1/sigma of each A row
  const float* rs;
  const void* res;         // residual
  int rg;                  // EPI_INTERP: rows per phase
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.  A wait
// of more than 2^34 clocks (~10 s) can only be a broken ring (a wrong
// parity leaves producer and consumers waiting on each other): trap, so
// the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile stored as 128-byte rows
// under the 128-byte swizzle (what a TMA box {64 bf16, rows} with
// CU_TENSOR_MAP_SWIZZLE_128B writes): start address, leading offset unused
// for this layout (1), stride 1024 bytes between 8-row core groups, layout
// 1 = 128-byte swizzle.  A K step of 16 inside the row adds 32 bytes to the
// start address; the tile base must be 1024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads across the asynchronous
// wgmma (its registers change without the compiler's knowledge).
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(float* d, uint64_t da, uint64_t db, int acc) {
  if constexpr (BN == 128) wgmma_n128(d, da, db, acc);
  else wgmma_n64(d, da, db, acc);
}

template <int BN>
struct Smem {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int LDC = BN + 8;  // f32 staging pitch: conflict-free float2 writes
  static constexpr int C_BYTES = CONSUMERS * 64 * LDC * 4;
  static constexpr int BYTES = 1024 + STAGES * (A_BYTES + B_BYTES) + C_BYTES + 2 * STAGES * 8;
};

__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 x = reinterpret_cast<const float4*>(src)[0];
  const float4 y = reinterpret_cast<const float4*>(src)[1];
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

__device__ __forceinline__ void load8(const bf16* src, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* dst, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// The epilogue of each form (gemm.cuh's enum Epi) on the accumulators
// a[0..7] of row r, columns n..n+7 (n % 8 == 0) of batch z, with 16-byte
// loads and stores (every ldo and o_batch is a multiple of 8 elements).
template <int EPI>
__device__ __forceinline__ void epilogue8(const EpiParams& p, int z, int r, int n, const float* a) {
  float v[8], b[8];
  if (EPI == EPI_POWER) {  // interleaved re/im -> 4 powers
    float* o = static_cast<float*>(p.out) + z * p.o_batch + (long long)r * p.ldo + n / 2;
    *reinterpret_cast<float4*>(o) =
        make_float4(a[0] * a[0] + a[1] * a[1], a[2] * a[2] + a[3] * a[3],
                    a[4] * a[4] + a[5] * a[5], a[6] * a[6] + a[7] * a[7]);
    return;
  }
  if (EPI == EPI_INTERP) {
    store8(static_cast<bf16*>(p.out) + z * p.o_batch + (long long)(r % p.rg) * p.ldo +
               (r / p.rg) * p.N + n,
           a);
    return;
  }
  load8(p.v0 + n, b);
  if (EPI == EPI_QKV) {
    const float rs = p.rs[r], mu = p.mu[r];
    float cs[8];
    load8(p.csum + n, cs);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = a[i] * rs - rs * mu * cs[i] + b[i];
    store8(static_cast<bf16*>(p.out) + (long long)r * p.ldo + n, v);
  } else if (EPI == EPI_MERGE) {  // the plain version's order: acc*rs + (t - mu*rs*s)
    const float rs = p.rs[r], mu = p.mu[r];
    float sv[8];
    load8(p.csum + n, sv);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = a[i] * rs + (b[i] - mu * rs * sv[i]);
    store8(static_cast<bf16*>(p.out) + (long long)r * p.ldo + n, v);
  } else if (EPI == EPI_PROJ || EPI == EPI_PROJ_BF16) {
    const int rr2 = p.R * p.R;
    const int img = r / rr2;
    const long long o =
        ((long long)img * rr2 + window_src(r - img * rr2, p.R, p.win, p.shift)) * p.ldo + n;
    float x[8];
    load8(static_cast<const bf16*>(p.res) + o, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = a[i] + b[i] + x[i];
    if constexpr (EPI == EPI_PROJ) store8(static_cast<float*>(p.out) + o, v);
    else store8(static_cast<bf16*>(p.out) + o, v);  // the v3 half's output, rounded
  } else if (EPI == EPI_GELU) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float t = a[i] + b[i];
      v[i] = 0.5f * t * (1.f + erff(t * 0.7071067811865476f));
    }
    store8(static_cast<bf16*>(p.out) + (long long)r * p.ldo + n, v);
  } else if (EPI == EPI_RESID || EPI == EPI_RESID_IN) {
    const long long o = (long long)r * p.ldo + n;
    float x[8];
    if constexpr (EPI == EPI_RESID) load8(static_cast<const float*>(p.res) + o, x);
    else load8(static_cast<const bf16*>(p.res) + o, x);  // the MLP half's bf16 input
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = a[i] + b[i] + x[i];
    store8(static_cast<bf16*>(p.out) + o, v);
  } else {  // EPI_BIAS_F32, EPI_BIAS_BF16
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = a[i] + b[i];
    if constexpr (EPI == EPI_BIAS_F32)
      store8(static_cast<float*>(p.out) + z * p.o_batch + (long long)r * p.ldo + n, v);
    else store8(static_cast<bf16*>(p.out) + (long long)r * p.ldo + n, v);  // the v1/v2 qkv
  }
}

// The producer's K steps of one output tile (row tile mt, column tile nt,
// batch z of A, bz of B): wait for a free stage, expect its bytes, load A's
// box (through `load_a`) and B's box into it.  `stage` and `phase` run on
// across tiles.
template <int BN, class ALoad>
__device__ __forceinline__ void produce_tile(const ALoad& load_a, const CUtensorMap* ta,
                                             const CUtensorMap* tb, uint8_t* sA, uint8_t* sB,
                                             uint64_t* full, uint64_t* empty, int ksteps,
                                             int mt, int nt, int z, int bz, int& stage,
                                             uint32_t& phase) {
  using S = Smem<BN>;
  for (int k = 0; k < ksteps; ++k) {
    mbar_wait(&empty[stage], phase ^ 1);
    mbar_expect_tx(&full[stage], S::A_BYTES + S::B_BYTES);
    load_a(sA + stage * S::A_BYTES, ta, k, mt, z, &full[stage]);
    tma_load_3d(sB + stage * S::B_BYTES, tb, k * BK, nt * BN, bz, &full[stage]);
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
}

// A consumer warpgroup's K steps of one output tile: wgmma of its 64 rows
// (warpgroup wg of the stage's 128) against the BN columns into `acc`,
// overwritten, one commit group per K step with one kept in flight; each
// stage is released once its products are done.  On return every product
// has landed in `acc` and every stage is released.
template <int BN>
__device__ __forceinline__ void consume_tile(float* acc, uint8_t* sA, uint8_t* sB,
                                             uint64_t* full, uint64_t* empty, int wg,
                                             int ksteps, int& stage, uint32_t& phase) {
  using S = Smem<BN>;
  int prev = 0;
  for (int k = 0; k < ksteps; ++k) {
    mbar_wait(&full[stage], phase);
    const uint32_t a0 = smem_u32(sA + stage * S::A_BYTES + wg * 64 * 128);
    const uint32_t b0 = smem_u32(sB + stage * S::B_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_bn<BN>(acc, smem_desc(a0 + kk * 32), smem_desc(b0 + kk * 32), k > 0 || kk > 0);
    wgmma_commit();
    if (k > 0) {  // the previous step's products are done: release its stage
      wgmma_wait<1>();
      mbar_arrive(&empty[prev]);
    }
    prev = stage;
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs<BN / 2>(acc);
  mbar_arrive(&empty[prev]);
}

// The producer's load of A's tile for K step k of row tile mt, batch z: by
// default from a 3-D (k, row, batch) map.  Another loader has the same call.
struct RowsA {
  int batched;
  __device__ __forceinline__ void operator()(void* dst, const CUtensorMap* map, int k, int mt,
                                             int z, uint64_t* bar) const {
    tma_load_3d(dst, map, k * BK, mt * BM, batched ? z : 0, bar);
  }
};

template <int BN, int EPI, class ALoad>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap tma_a,
                     const __grid_constant__ CUtensorMap tma_b, const EpiParams p,
                     const ALoad load_a, int K, int batch, int b_batched) {
  using S = Smem<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((s0 + 1023) & ~1023u) - s0);  // 1024-aligned for the swizzle
  uint8_t* sA = base;
  uint8_t* sB = sA + STAGES * S::A_BYTES;
  float* sC = reinterpret_cast<float*>(sB + STAGES * S::B_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(sC) + S::C_BYTES);
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                    // the producer's expect_tx arrival
      mbar_init(&empty[s], CONSUMERS * 128);     // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m_tiles = (p.M + BM - 1) / BM, n_tiles = p.N / BN;
  const int tiles = batch * m_tiles * n_tiles, ksteps = K / BK;

  if (wg == CONSUMERS) {  // producer: one thread keeps the ring full
    if (tid != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int nt = t % n_tiles, mt = (t / n_tiles) % m_tiles, z = t / (n_tiles * m_tiles);
      produce_tile<BN>(load_a, &tma_a, &tma_b, sA, sB, full, empty, ksteps, mt, nt, z,
                       b_batched ? z : 0, stage, phase);
    }
    return;
  }

  // consumers
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  float* cs = sC + wg * 64 * S::LDC;
  const int warp = tid / 32, lane = tid % 32;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int nt = t % n_tiles, mt = (t / n_tiles) % m_tiles, z = t / (n_tiles * m_tiles);
    consume_tile<BN>(acc, sA, sB, full, empty, wg, ksteps, stage, phase);

    // accumulators -> this warpgroup's staging rows (fragment layout of
    // wgmma m64nNk16: d[4j + 2i + e] is row 16*warp + lane/4 + 8i, column
    // 8j + 2*(lane%4) + e)
    named_sync(1 + wg, 128);  // the previous tile's epilogue has read cs
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * warp + lane / 4 + 8 * i, col = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<float2*>(&cs[row * S::LDC + col]) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    named_sync(1 + wg, 128);
    const int r0 = mt * BM + wg * 64, n0 = nt * BN;
    constexpr int GROUPS = BN / 8;  // 8-column groups of a row
    for (int i = tid; i < 64 * GROUPS; i += 128) {
      const int row = i / GROUPS, c8 = (i % GROUPS) * 8;
      const int r = r0 + row;
      if (r >= p.M) continue;
      float a[8];
      load8(&cs[row * S::LDC + c8], a);
      epilogue8<EPI>(p, z, r, n0 + c8, a);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled's entry point: one per process, for every card.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// Error codes of the host side, beside cudaError_t's: no
// cuTensorMapEncodeTiled entry point, or it refused a tensor map (9000 +
// its CUresult).
constexpr int ERR_NO_ENCODE = 8999, ERR_ENCODE = 9000;

// A tensor map of elements of `type` and rank `rank` <= 5 under the
// 128-byte swizzle: dims and box innermost first, `strides` the byte
// strides of dims 1..rank-1.
inline int encode_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int rank,
                      const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

inline int encode(CUtensorMap* map, const Operand& o, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)o.K, (cuuint64_t)o.rows, (cuuint64_t)o.batch};
  const cuuint64_t strides[2] = {(cuuint64_t)o.ld * 2, (cuuint64_t)o.batch_stride * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1};
  return encode_map(map, o.ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, dims, strides, box);
}

// Per-card caches, keyed by the current card (the wrappers make the
// operands' card current): its SM count, and whether an instantiation's
// shared-memory attribute is set there (an attribute is per card).
constexpr int MAX_CARDS = 64;

inline int current_card() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

inline int sm_count(int dev) {
  static int n[MAX_CARDS] = {};
  if (n[dev] == 0) cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev);
  return n[dev];
}

template <int BN, int EPI, class ALoad>
int launch_bn(const CUtensorMap& ta, const ALoad& load_a, const Operand& b, const EpiParams& p,
              int K, int batch, cudaStream_t stream) {
  CUtensorMap tb;
  int e;
  if ((e = encode(&tb, b, BN)) != 0) return e;
  const int dev = current_card();
  if (dev >= MAX_CARDS) return cudaErrorInvalidDevice;
  static bool attr[MAX_CARDS] = {};  // per instantiation and card
  if (!attr[dev]) {
    if ((e = cudaFuncSetAttribute(gemm_sm90_kernel<BN, EPI, ALoad>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  Smem<BN>::BYTES)) != cudaSuccess)
      return e;
    attr[dev] = true;
  }
  const int tiles = batch * ((p.M + BM - 1) / BM) * (p.N / BN), sms = sm_count(dev);
  const int grid = tiles < sms ? tiles : sms;
  gemm_sm90_kernel<BN, EPI, ALoad><<<grid, THREADS, Smem<BN>::BYTES, stream>>>(
      ta, tb, p, load_a, K, batch, b.batch > 1);
  return cudaGetLastError();
}

// out = epilogue(A @ B^T), A's map and loader made by the caller: each load
// fills a BM x BK K-major tile under the 128-byte swizzle.
template <int EPI, class ALoad>
int gemm_mapped(const CUtensorMap& ta, const ALoad& load_a, const Operand& b,
                const EpiParams& p, int K, int batch, cudaStream_t stream) {
  return p.N % 128 == 0 ? launch_bn<128, EPI>(ta, load_a, b, p, K, batch, stream)
                        : launch_bn<64, EPI>(ta, load_a, b, p, K, batch, stream);
}

// out = epilogue(A @ B^T): A (M x K) of `batch` or one, B (N x K) likewise.
template <int EPI>
int gemm(const Operand& a, const Operand& b, const EpiParams& p, int batch,
         cudaStream_t stream) {
  CUtensorMap ta;
  const int e = encode(&ta, a, BM);
  return e != 0 ? e : gemm_mapped<EPI>(ta, RowsA{a.batch > 1}, b, p, a.K, batch, stream);
}

}  // namespace sm90
}  // namespace
