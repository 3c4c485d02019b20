// Hopper GEMM core of the whole Swin block (#1, swin_block.cu) and its
// halves (#8 v3 attention, #9 fused MLP, #10 and #11 the v1 and v2
// attention halves: the block's own launches), the patch merge (#2,
// patch_merge.cu), the fused frontend (#3, frontend.cu) and the halo
// log-mel (#6, log_mel.cu, which runs the ring below, produce_tile and
// consume_tile, under an epilogue of its own): bf16 x bf16 -> f32
// accumulate with wgmma, fed by TMA through a ring of shared-memory stages.
// And the W8A8 int8 MLP's two products (#12, mlp_int8.cu, bf16 and f32
// rows): the same ring on int8 codes, s8 x s8 -> s32 accumulate with
// wgmma.m64nBNk32.s32.s8.s8, under the EPI_S8_* epilogues (s8_epilogue8).
//
//   out[z] = epilogue(A[z] (M x K) @ B[z]^T),  B[z] held (N x K)
//
// Layout: both operands K-major (rows of K contiguous elements; int8
// wgmma takes no other layout), so one TMA box shape, one 128-byte swizzle
// and one wgmma descriptor serve A and B.  A stage row is 128 bytes of K
// in either element type (Elem below): 64 bf16 or 128 codes, and every
// wgmma instruction steps 32 bytes along it (k16 bf16, k32 int8), so the
// descriptors and the ring's byte arithmetic are the same.  The weights
// are stored transposed once at load for this (models/htsat.py SwinBlock,
// ops/frontend_fused.py frontend_tables, ops/mlp.py mlp_int8_operands); the
// plain versions keep reading the (K, N) layout.  A runtime B (the
// frontend's mel) is written transposed by the kernel that makes it.
//
// Shape of a block (one per SM, persistent over output tiles):
//   - warpgroups 0-1 consume: each owns 64 rows of the 128 x BN tile and
//     issues wgmma.m64nBNk16 (int8: k32; BN 128, or 64 where N is not a
//     multiple of 128, or for bf16 96 where N is a multiple of neither:
//     HTSAT-tiny's 3C = 288 and C = 96 at C = 96), one commit group per K
//     step of 128 bytes (64 bf16, 128 codes), keeping one group in flight;
//   - warpgroup 2, one thread, produces: TMA loads of the A (128 rows) and
//     B (BN rows) boxes of one K step into a ring of STAGES stages with full
//     / empty mbarriers, running ahead across tiles, so one tile's epilogue
//     overlaps the next tile's loads (at K = 128 a bf16 tile has only two K
//     steps, an int8 tile one);
//   - epilogue: each consumer warpgroup stages its 64 x BN f32 accumulators
//     in shared memory (padded rows) and applies its epilogue (epilogue8)
//     to 8 columns at a time, 16-byte loads and stores coalesced along N,
//     through the row maps (un-partition / un-roll, phase rows -> lanes);
//     an int8 product's int32 sums are staged as f32 (__int2float_rn).
// Tensor maps are 3-D (k, row, batch) and encoded on the host per launch
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: no -lcuda); a
// batch index z > 0 is read only from the operand that has a batch.  A
// caller whose A is laid out otherwise encodes A's map itself and passes the
// producer a loader of its own (gemm_mapped; patch_merge.cu's MergeA).  Rows
// past M are zero-filled by TMA and masked in the epilogue.  Requirements
// (checked by the Python wrappers through kernels.check_sm90_gemm): N % 64
// == 0 or N % 96 == 0, K % 32 == 0 (the K steps are ceil(K / 64), and TMA
// zero-fills the columns past K in both operands: a last half step adds
// exact zeros, whole k16 instructions of them), row and batch strides
// multiples of 8 elements (16 bytes), 16-byte aligned base pointers.  On
// int8 codes
// (kernels.check_s8_gemm): N % 64 == 0, strides multiples of 16 codes (16
// bytes), any such K: the K steps are ceil(K / 128), and TMA zero-fills the
// columns past K in both operands, which adds exact zeros to an integer
// sum.  No atomics but the int8 fc1 epilogue's integer max, which is the
// same in any order: a run repeats bitwise.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

#include "gemm.cuh"

namespace {
namespace sm90 {

constexpr int BM = 128, BK = 64, STAGES = 4, CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;

// The element types the ring takes: bf16 with f32 accumulators, int8 codes
// with int32 accumulators.  BK_OF<E>: the K of a 128-byte stage row.  TMA
// moves bytes, so int8 maps are encoded as UINT8 (its out-of-bounds fill,
// zero bytes, is the code 0).
template <typename E> struct Elem;
template <> struct Elem<bf16> {
  using Acc = float;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct Elem<int8_t> {
  using Acc = int;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};
template <typename E> constexpr int BK_OF = 128 / (int)sizeof(E);

// One operand as TMA sees it: `rows` rows of K elements at row stride `ld`
// elements, `batch` copies `batch_stride` elements apart.
struct Operand {
  const void* ptr;
  int rows, K;
  long long ld;
  int batch;
  long long batch_stride;
};

inline Operand rows_of(const bf16* ptr, int rows, int K, long long ld) {
  return Operand{ptr, rows, K, ld, 1, (long long)rows * ld};
}

inline Operand rows_of(const int8_t* ptr, int rows, int K, long long ld) {
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
  const float* rscale;     // EPI_S8_GELU: sx of each A row
  const float* cscale;     // EPI_S8_*: the weight's scale of each column
  int* amax;               // EPI_S8_*: max |g| of each row, as float bits
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
// under the 128-byte swizzle (what a TMA box {64 bf16 or 128 int8, rows}
// with CU_TENSOR_MAP_SWIZZLE_128B writes): start address, leading offset
// unused for this layout (1), stride 1024 bytes between 8-row core groups,
// layout 1 = 128-byte swizzle.  An instruction's K step inside the row (16
// bf16, 32 int8) adds 32 bytes to the start address; the tile base must be
// 1024-byte aligned.
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
template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// The int8 forms: int32 accumulators, both operands K-major (int8 wgmma
// has no transpose), no operand scaling.
__device__ __forceinline__ void wgmma_s8_n64(int* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n96(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(acc));
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(float* d, uint64_t da, uint64_t db, int acc) {
  if constexpr (BN == 128) wgmma_n128(d, da, db, acc);
  else if constexpr (BN == 96) wgmma_n96(d, da, db, acc);
  else wgmma_n64(d, da, db, acc);
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(int* d, uint64_t da, uint64_t db, int acc) {
  if constexpr (BN == 128) wgmma_s8_n128(d, da, db, acc);
  else wgmma_s8_n64(d, da, db, acc);
}

template <int BN>
struct Smem {  // a stage row holds 128 bytes of K: BK bf16, or 2 BK int8 codes
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

// The int8 MLP's row scale from a row's max |v|: max(amax, 1e-12) *
// f32(1/127) (jnp.float32(1.0 / 127.0)), one rounding.
constexpr float INV127 = 0x1.020408p-7f;
constexpr float AMAX_FLOOR = 1e-12f;

__device__ __forceinline__ float row_scale(float amax) {
  return __fmul_rn(fmaxf(amax, AMAX_FLOOR), INV127);
}

// The int8 MLP's epilogues (gemm.cuh's EPI_S8_*) on the f32 conversions
// a[0..7] of the int32 sums of row r, columns n..n+7 (n % 8 == 0), every
// multiply and add rounded on its own (__fmul_rn / __fadd_rn: nothing
// contracts into an fma), in mlp_int8.cu's order.  fc1 reduces |g| over the
// G lanes that share row r (G consecutive lanes, G-aligned), and the first
// adds it with one atomicMax on the float's bits (|g| >= 0, so integer
// order is float order, and a max is the same in any order).
template <int EPI, int G>
__device__ __forceinline__ void s8_epilogue8(const EpiParams& p, int r, int n, const float* a) {
  float s[8], b[8], v[8];
  load8(p.cscale + n, s);
  load8(p.v0 + n, b);
  const long long o = (long long)r * p.ldo + n;
  if constexpr (EPI == EPI_S8_GELU) {  // dequantise, bias, exact-erf GELU, the row's max
    const float rs = p.rscale[r];
    int m = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float y = __fadd_rn(__fmul_rn(a[i], __fmul_rn(rs, s[i])), b[i]);
      v[i] = __fmul_rn(__fmul_rn(y, 0.5f), __fadd_rn(1.f, erff(__fmul_rn(y, 0.7071067811865476f))));
      m = max(m, __float_as_int(fabsf(v[i])));
    }
    store8(static_cast<float*>(p.out) + o, v);
    const int lane = threadIdx.x & 31;
    const unsigned lanes = G == 32 ? 0xffffffffu : ((1u << G) - 1) << (lane & ~(G - 1));
#pragma unroll
    for (int d = G / 2; d > 0; d >>= 1) m = max(m, __shfl_xor_sync(lanes, m, d));
    if ((lane & (G - 1)) == 0) atomicMax(p.amax + r, m);
  } else {  // EPI_S8_OUT, _F32: dequantise with sy, bias, the residual
    using T = std::conditional_t<EPI == EPI_S8_OUT_F32, float, bf16>;  // the activation type
    const float sy = row_scale(__int_as_float(p.amax[r]));
    float x[8];
    load8(static_cast<const T*>(p.res) + o, x);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = __fadd_rn(__fadd_rn(__fmul_rn(a[i], __fmul_rn(sy, s[i])), b[i]), x[i]);
    store8(static_cast<T*>(p.out) + o, v);
  }
}

// The producer's K steps of one output tile (row tile mt, column tile nt,
// batch z of A, bz of B): wait for a free stage, expect its bytes, load A's
// box (through `load_a`) and B's box of elements E into it.  `stage` and
// `phase` run on across tiles.
template <int BN, class ALoad, typename E = bf16>
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
    tma_load_3d(sB + stage * S::B_BYTES, tb, k * BK_OF<E>, nt * BN, bz, &full[stage]);
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
}

// A consumer warpgroup's K steps of one output tile: wgmma of its 64 rows
// (warpgroup wg of the stage's 128) against the BN columns into `acc` (f32
// for bf16 stages, int32 for int8), overwritten, one commit group per K
// step with one kept in flight; each stage is released once its products
// are done.  On return every product has landed in `acc` and every stage is
// released.
template <int BN, typename Acc>
__device__ __forceinline__ void consume_tile(Acc* acc, uint8_t* sA, uint8_t* sB,
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
    for (int kk = 0; kk < 4; ++kk)  // the stage row's 128 bytes, 32 an instruction
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
// default from a 3-D (k, row, batch) map of elements E.  Another loader has
// the same call.
template <typename E>
struct RowsOf {
  int batched;
  __device__ __forceinline__ void operator()(void* dst, const CUtensorMap* map, int k, int mt,
                                             int z, uint64_t* bar) const {
    tma_load_3d(dst, map, k * BK_OF<E>, mt * BM, batched ? z : 0, bar);
  }
};
using RowsA = RowsOf<bf16>;

__device__ __forceinline__ float sum_f32(float v) { return v; }
__device__ __forceinline__ float sum_f32(int v) { return __int2float_rn(v); }

template <int BN, int EPI, class ALoad, typename E = bf16>
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
  const int tiles = batch * m_tiles * n_tiles, ksteps = (K + BK_OF<E> - 1) / BK_OF<E>;

  if (wg == CONSUMERS) {  // producer: one thread keeps the ring full
    if (tid != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int nt = t % n_tiles, mt = (t / n_tiles) % m_tiles, z = t / (n_tiles * m_tiles);
      produce_tile<BN, ALoad, E>(load_a, &tma_a, &tma_b, sA, sB, full, empty, ksteps, mt, nt,
                                 z, b_batched ? z : 0, stage, phase);
    }
    return;
  }

  // consumers
  typename Elem<E>::Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  float* cs = sC + wg * 64 * S::LDC;
  const int warp = tid / 32, lane = tid % 32;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int nt = t % n_tiles, mt = (t / n_tiles) % m_tiles, z = t / (n_tiles * m_tiles);
    consume_tile<BN>(acc, sA, sB, full, empty, wg, ksteps, stage, phase);

    // accumulators -> this warpgroup's staging rows, as f32 (fragment
    // layout of wgmma m64nNk16 and of the int32 m64nNk32 alike: d[4j + 2i +
    // e] is row 16*warp + lane/4 + 8i, column 8j + 2*(lane%4) + e)
    named_sync(1 + wg, 128);  // the previous tile's epilogue has read cs
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * warp + lane / 4 + 8 * i, col = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<float2*>(&cs[row * S::LDC + col]) =
            make_float2(sum_f32(acc[4 * j + 2 * i]), sum_f32(acc[4 * j + 2 * i + 1]));
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
      if constexpr (EPI >= EPI_S8_GELU) s8_epilogue8<EPI, GROUPS>(p, r, n0 + c8, a);
      else epilogue8<EPI>(p, z, r, n0 + c8, a);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled's entry point: one per process, for every card
// (a function-local static: initialised once, whichever host thread of a
// mesh's shards launches first).
inline EncodeTiled query_encode_tiled() {
  void* f = nullptr;
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
          cudaSuccess &&
      q == cudaDriverEntryPointSuccess)
    return reinterpret_cast<EncodeTiled>(f);
  return nullptr;
}

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = query_encode_tiled();
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

template <typename E = bf16>
inline int encode(CUtensorMap* map, const Operand& o, int box_rows) {
  constexpr cuuint64_t size = sizeof(E);
  const cuuint64_t dims[3] = {(cuuint64_t)o.K, (cuuint64_t)o.rows, (cuuint64_t)o.batch};
  const cuuint64_t strides[2] = {(cuuint64_t)o.ld * size, (cuuint64_t)o.batch_stride * size};
  const cuuint32_t box[3] = {(cuuint32_t)BK_OF<E>, (cuuint32_t)box_rows, 1};
  return encode_map(map, o.ptr, Elem<E>::MAP, 3, dims, strides, box);
}

// Per-card caches, keyed by the current card (the wrappers make the
// operands' card current): its SM count, and whether an instantiation's
// shared-memory attribute is set there (an attribute is per card).  Atomic:
// the shards of a mesh launch from several host threads; two threads may
// both set an attribute, which sets it to the same value.
constexpr int MAX_CARDS = 64;

inline int current_card() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

inline int sm_count(int dev) {
  static std::atomic<int> n[MAX_CARDS];
  int v = n[dev].load(std::memory_order_relaxed);
  if (v == 0) {
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    n[dev].store(v, std::memory_order_relaxed);
  }
  return v;
}

template <int BN, int EPI, class ALoad, typename E>
int launch_bn(const CUtensorMap& ta, const ALoad& load_a, const Operand& b, const EpiParams& p,
              int K, int batch, cudaStream_t stream) {
  CUtensorMap tb;
  int e;
  if ((e = encode<E>(&tb, b, BN)) != 0) return e;
  const int dev = current_card();
  if (dev >= MAX_CARDS) return cudaErrorInvalidDevice;
  static std::atomic<bool> attr[MAX_CARDS];  // per instantiation and card
  if (!attr[dev].load(std::memory_order_acquire)) {
    if ((e = cudaFuncSetAttribute(gemm_sm90_kernel<BN, EPI, ALoad, E>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  Smem<BN>::BYTES)) != cudaSuccess)
      return e;
    attr[dev].store(true, std::memory_order_release);
  }
  const int tiles = batch * ((p.M + BM - 1) / BM) * (p.N / BN), sms = sm_count(dev);
  const int grid = tiles < sms ? tiles : sms;
  gemm_sm90_kernel<BN, EPI, ALoad, E><<<grid, THREADS, Smem<BN>::BYTES, stream>>>(
      ta, tb, p, load_a, K, batch, b.batch > 1);
  return cudaGetLastError();
}

// out = epilogue(A @ B^T), A's map and loader made by the caller: each load
// fills a BM x 128-byte K-major tile of elements E under the 128-byte
// swizzle.  The column tile: 128 where it divides N, else 64, else (bf16:
// N % 96 == 0, checked by the caller) 96.
template <int EPI, class ALoad, typename E = bf16>
int gemm_mapped(const CUtensorMap& ta, const ALoad& load_a, const Operand& b,
                const EpiParams& p, int K, int batch, cudaStream_t stream) {
  if (p.N % 128 == 0) return launch_bn<128, EPI, ALoad, E>(ta, load_a, b, p, K, batch, stream);
  if constexpr (std::is_same_v<E, bf16>)
    if (p.N % 64 != 0) return launch_bn<96, EPI, ALoad, E>(ta, load_a, b, p, K, batch, stream);
  return launch_bn<64, EPI, ALoad, E>(ta, load_a, b, p, K, batch, stream);
}

// out = epilogue(A @ B^T): A (M x K) of `batch` or one, B (N x K) likewise,
// both of elements E (bf16, or int8 codes under an EPI_S8_* epilogue).
template <int EPI, typename E = bf16>
int gemm(const Operand& a, const Operand& b, const EpiParams& p, int batch,
         cudaStream_t stream) {
  CUtensorMap ta;
  const int e = encode<E>(&ta, a, BM);
  return e != 0 ? e
                : gemm_mapped<EPI, RowsOf<E>, E>(ta, RowsOf<E>{a.batch > 1}, b, p, a.K, batch,
                                                 stream);
}

}  // namespace sm90
}  // namespace
