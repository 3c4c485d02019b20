// Hopper f32 GEMM core of the f32 Swin block and its halves (#1 and #8-#11
// in f32, swin_block.cu) and of the f32 patch merge (#2 f32,
// patch_merge.cu): f32 x f32 -> f32 with f32-level accuracy on the tensor
// cores, as three TF32 products (3xTF32), wgmma fed by TMA through a ring
// of shared-memory stages.
//
//   out = epilogue(A (M x K) @ B^T),  B held as [B_hi; B_lo] (2 x N x K)
//
// Why 3xTF32: a TF32 operand keeps 10 mantissa bits, so one TF32 product is
// ~5e-4 relative, far above the f32 kernels' bounds.  With x = x_hi + x_lo,
// x_hi = rna_tf32(x) and x_lo = rna_tf32(x - x_hi) (rna: round to nearest,
// ties away from zero), x_hi + x_lo holds x to ~2^-22 relative, and
//   A . B ~= A_lo . B_hi + A_hi . B_lo + A_hi . B_hi
// drops only A_lo . B_lo, ~2^-22 of |A||B|.  Three TF32 products at 495
// TFLOP/s are ~165 TFLOP/s of f32-accurate products, 2.5x the 67 TFLOP/s of
// f32 FMAs on the CUDA cores.
//
// B is split once when the weights load (ops/tf32.py tf32_split, stacked
// hi over lo).  A is split in the kernel: TF32 wgmma reads a 32-bit operand
// and ignores its low 13 bits (truncation), so A must be rounded first.
// After a stage lands, each consumer warpgroup splits its own 64 rows in
// place with cvt.rna.tf32.f32: A_hi over A, A_lo into the stage's A_lo
// buffer.  The split is elementwise, so it runs on the 128-byte-swizzled
// tile as TMA wrote it, with no fragment layout to follow; generic stores
// then reach wgmma through fence.proxy.async and a warpgroup barrier.  Each
// warpgroup splits the next stage while the tensor cores run the current
// one.  (So the qkv, proj and merge products; the MLP's two products take A
// from registers instead, wgmma's RS form, split there: gemm_rs below.)
//
// Accumulation: the tensor cores add each wgmma's products into the
// accumulator with truncation at f32 precision.  Summed over the whole
// depth, that error grows with K and keeps its sign (a 3xTF32 k-NN kernel
// on mma.sync, one accumulator over d = 512, moved radii by 1.2e-4 on an
// H100).  So every K step of 32 runs its twelve wgmmas (4 x k8, three
// products each, A_lo.B_hi, A_hi.B_lo, A_hi.B_hi: small terms first) into
// a fresh accumulator, which the CUDA cores then add into the f32 register
// accumulator, rounded to nearest: a chain in the tensor cores is at most
// 32 deep.
//
// Shape of a block (one per SM, persistent over output tiles), as
// gemm_sm90.cuh's:
//   - warpgroups 0-1 consume: each owns 64 rows of the 128 x BN tile
//     (BN 128, or 64 where N is not a multiple of 128, or 96 where N is a
//     multiple of neither: HTSAT-tiny's 3C = 288 and C = 96 at C = 96);
//   - warpgroup 2, one thread, produces: TMA loads of the A (128 x 32 f32)
//     and B_hi, B_lo (BN x 32) boxes into a ring of stages with full /
//     empty mbarriers, running ahead across tiles;
//   - epilogue straight from the accumulator registers (f32 out, no
//     staging: shared memory holds the ring), the arithmetic of the f32
//     epilogues (epi_f32): EPI_QKV (LN1 fold), EPI_BIAS_F32 (bias: the qkv
//     of the attention halves that apply the LN1 affine before the product),
//     EPI_PROJ (bias, window un-partition and un-roll, residual), EPI_GELU
//     (exact erf), EPI_RESID, EPI_MERGE (merge LN fold).
// The MLP's two products (EPI_GELU, EPI_RESID) run another schedule on the
// same tiles and ring: A from registers, two fresh accumulators, setmaxnreg
// and the epilogue through a staging tile under the next tile's wgmmas
// (gemm_rs below); the other epilogues run the schedule described here.
// A K step of 32 f32 is 128 bytes, as 64 bf16: the 128-byte swizzle, the
// descriptor and the 32-byte stepping inside a stage are gemm_sm90.cuh's
// (one k8 TF32 wgmma consumes 32 bytes of each row, as one k16 bf16 does).
// Both operands K-major (TF32 wgmma takes no other layout).  Requirements
// (checked by the Python wrappers through kernels.check_tf32x3_gemm): K % 32
// == 0, N % 64 == 0 or N % 96 == 0, row strides multiples of 4 elements (16 bytes),
// 16-byte aligned base pointers.  Rows past M are zero-filled by TMA and
// masked in the epilogue.  No atomics: a run repeats bitwise.
#pragma once

#include "gemm_sm90.cuh"

namespace {
namespace tf32x3 {

using sm90::named_sync;
using sm90::smem_desc;
using sm90::smem_u32;

constexpr int BM = 128, BK = 32, CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;

// What the f32 epilogues read and write.
struct EpiF32 {
  int M, N;
  float* out;
  int ldo;
  int R, win, shift;   // EPI_PROJ's window map
  const float* v0;     // bias
  const float* csum;   // EPI_QKV: column sums of W (1 @ W); EPI_MERGE: g @ W
  const float* mu;     // EPI_QKV, EPI_MERGE: LN mean and 1/sigma of each A row
  const float* rs;
  const float* res;    // residual
};

// Per stage: A (hi after the split), A_lo, B_hi, B_lo, each 128-byte rows.
// Four stages of BN = 96 take 225 KB of the 227 a block may hold.
template <int BN>
struct Smem {
  static constexpr int STAGES = BN == 128 ? 3 : 4;
  static constexpr int A_BYTES = BM * BK * 4;
  static constexpr int B_BYTES = BN * BK * 4;
  static constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
  static constexpr int BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
};

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
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
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
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

__device__ __forceinline__ void wgmma_n96(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1;\n}\n"
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

// The split of warpgroup wg's 64 rows of stage `st`: A_hi over A, A_lo
// into the A_lo buffer at the same offset (the swizzle moves 16-byte chunks
// only, so one offset serves both).  Thread tid takes four 16-byte chunks,
// neighbours on neighbouring chunks.
template <int BN>
__device__ __forceinline__ void split_rows(uint8_t* st, int wg, int tid) {
  using S = Smem<BN>;
  float4* a = reinterpret_cast<float4*>(st + wg * 64 * 128);
  float4* lo = reinterpret_cast<float4*>(st + S::A_BYTES + wg * 64 * 128);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = a[tid + 128 * i];
    const float4 h = make_float4(rna_tf32(x.x), rna_tf32(x.y), rna_tf32(x.z), rna_tf32(x.w));
    a[tid + 128 * i] = h;
    lo[tid + 128 * i] = make_float4(rna_tf32(x.x - h.x), rna_tf32(x.y - h.y),
                                    rna_tf32(x.z - h.z), rna_tf32(x.w - h.w));
  }
}

// The producer's K steps of one output tile: wait for a free stage, expect
// its bytes, load A's box (through `load_a`), B_hi's and B_lo's (batches 0
// and 1 of B's map) into it.  `stage` and `phase` run on across tiles.
template <int BN, class ALoad>
__device__ __forceinline__ void produce_tile(const ALoad& load_a, const CUtensorMap* ta,
                                             const CUtensorMap* tb, uint8_t* ring,
                                             uint64_t* full, uint64_t* empty, int ksteps,
                                             int mt, int nt, int& stage, uint32_t& phase) {
  using S = Smem<BN>;
  for (int k = 0; k < ksteps; ++k) {
    uint8_t* st = ring + stage * S::STAGE_BYTES;
    sm90::mbar_wait(&empty[stage], phase ^ 1);
    sm90::mbar_expect_tx(&full[stage], S::A_BYTES + 2 * S::B_BYTES);
    load_a(st, ta, k, mt, 0, &full[stage]);
    sm90::tma_load_3d(st + 2 * S::A_BYTES, tb, k * BK, nt * BN, 0, &full[stage]);
    sm90::tma_load_3d(st + 2 * S::A_BYTES + S::B_BYTES, tb, k * BK, nt * BN, 1, &full[stage]);
    if (++stage == S::STAGES) { stage = 0; phase ^= 1; }
  }
}

// A consumer warpgroup's K steps of one output tile into `acc`
// (overwritten): per K step, split the stage's A rows, twelve wgmmas into
// `tmp` from zero, then acc += tmp on the CUDA cores; the next stage is
// split while the wgmmas run.  Each stage is released once its products
// are in `acc`.
template <int BN>
__device__ __forceinline__ void consume_tile(float* acc, float* tmp, uint8_t* ring,
                                             uint64_t* full, uint64_t* empty, int wg, int tid,
                                             int ksteps, int& stage, uint32_t& phase) {
  using S = Smem<BN>;
  sm90::mbar_wait(&full[stage], phase);
  split_rows<BN>(ring + stage * S::STAGE_BYTES, wg, tid);
  for (int k = 0; k < ksteps; ++k) {
    const int cur = stage;
    uint8_t* st = ring + cur * S::STAGE_BYTES;
    fence_proxy_async();       // the split's stores, visible to wgmma
    named_sync(1 + wg, 128);   // ... from every thread of the warpgroup
    const uint32_t a_hi = smem_u32(st + wg * 64 * 128);
    const uint32_t a_lo = a_hi + S::A_BYTES;
    const uint32_t b_hi = smem_u32(st + 2 * S::A_BYTES), b_lo = b_hi + S::B_BYTES;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      wgmma_bn<BN>(tmp, smem_desc(a_lo + kk * 32), smem_desc(b_hi + kk * 32), kk > 0);
      wgmma_bn<BN>(tmp, smem_desc(a_hi + kk * 32), smem_desc(b_lo + kk * 32), 1);
      wgmma_bn<BN>(tmp, smem_desc(a_hi + kk * 32), smem_desc(b_hi + kk * 32), 1);
    }
    sm90::wgmma_commit();
    if (++stage == S::STAGES) { stage = 0; phase ^= 1; }
    if (k + 1 < ksteps) {
      sm90::mbar_wait(&full[stage], phase);
      split_rows<BN>(ring + stage * S::STAGE_BYTES, wg, tid);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs<BN / 2>(tmp);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = k > 0 ? acc[i] + tmp[i] : tmp[i];
    sm90::mbar_arrive(&empty[cur]);
  }
}

// The f32 epilogue of one accumulator a at column n, gemm_sm90.cuh's
// epilogue8 arithmetic in f32: rs, mu of the row for EPI_QKV / EPI_MERGE,
// `res` the residual for EPI_PROJ / EPI_RESID.
template <int EPI>
__device__ __forceinline__ float epi_f32(const EpiF32& p, float a, int n, float rs, float mu,
                                         float res) {
  const float bias = p.v0[n];
  if (EPI == EPI_QKV) {
    return a * rs - rs * mu * p.csum[n] + bias;
  } else if (EPI == EPI_MERGE) {  // the plain version's order: acc*rs + (t - mu*rs*s)
    return a * rs + (bias - mu * rs * p.csum[n]);
  } else if (EPI == EPI_GELU) {
    const float t = a + bias;
    return 0.5f * t * (1.f + erff(t * 0.7071067811865476f));
  } else if (EPI == EPI_BIAS_F32) {
    return a + bias;
  }
  return a + bias + res;  // EPI_PROJ, EPI_RESID: + bias + the f32 residual
}

// The producer's load of A's tile for K step k of row tile mt: rows of a
// 2-D (k, row) map.  Another loader (patch_merge.cu's MergeA) has the same
// call.
struct RowsA {
  __device__ __forceinline__ void operator()(void* dst, const CUtensorMap* map, int k, int mt,
                                             int, uint64_t* bar) const {
    sm90::tma_load_3d(dst, map, k * BK, mt * BM, 0, bar);
  }
};

// ---------------------------------------------------------------------
// The MLP's two products, fc1 (EPI_GELU) and fc2 (EPI_RESID): A from
// registers, the epilogue on warps of its own.
//
// The tiles stay cooperative (each consumer warpgroup 64 rows of a 128 x BN
// tile, B read once for both); what changes (measured on an H100, PERF.md):
//   - A from registers (wgmma's RS form): each thread loads its fragment of
//     the stage's A rows once, through the 128-byte swizzle, and splits it
//     there, cvt.rna.tf32 as split_rows does.  The cooperative form above
//     re-reads A from shared memory in each of a K step's twelve wgmmas and
//     stores A_hi and A_lo there first: ~170 bytes a clock of shared-memory
//     traffic at the TF32 peak, where an SM serves ~128, bounds it; here
//     shared memory serves B and the TMA fills alone (~105), and no A_lo
//     buffer or split barrier is left;
//   - two fresh accumulators, one for each half of the tile's columns (d0
//     columns [0, BN/2), d1 the rest; two of a whole tile's width and two K
//     steps' fragments would not fit): each K step is two commit groups,
//     and a group is issued before the previous group's sum is added
//     (wgmma_wait<1>), so the tensor cores always hold queued work;
//   - the epilogue (fc1's exact-erf GELU over 4C-wide rows, fc2's residual)
//     runs under the next tile's wgmmas: a consumer warpgroup hands its
//     finished accumulator over through a staging tile in shared memory
//     (rows padded to BN + 8 floats: no bank conflicts) and goes on.  Warps
//     1-3 of the producer warpgroup store it; where the product is shallow
//     (RS_SHARE_K) they store rows [0, RS_EPI_ROWS) of each warpgroup's 64
//     and each consumer warpgroup the rest of its own rows, in pieces, one
//     after each K step's two groups are issued (three warps alone could not
//     keep up with fc1's GELU at K = 128; deeper products lose more to the
//     consumers' share than they gain).  By rows, 16 bytes a thread,
//     coalesced along N.  An ordered handoff on two
//     mbarriers: the epilogue warps read tile j once both consumers have
//     staged it (epi_full), the consumers stage tile j + 1 once the epilogue
//     warps have read tile j (epi_empty) and their own warpgroup has stored
//     its share (a named barrier);
//   - setmaxnreg: the producer warpgroup (the TMA thread and the epilogue
//     warps) keeps RS_PRODUCER_REGS registers a thread, the consumers take
//     RS_CONSUMER_REGS: the accumulator, two fresh ones and the A fragments
//     of two K steps.
// (Two schedules were built and measured first: ping-pong, each warpgroup
// its own 64-row tiles with its epilogue under the other's mainloop, where
// one warpgroup's wgmmas at a time kept the tensor cores below the
// cooperative rate; and the epilogue of tile j under the consumers' own
// first wgmmas of tile j + 1, too few to cover it.)
// The accumulation is the other instantiations', element for element: per
// K step of 32, the twelve wgmmas in k8 order, each k8 A_lo.B_hi,
// A_hi.B_lo, A_hi.B_hi, into a fresh accumulator; the K steps' sums added
// in K order in f32, rounded to nearest (a column's sums never meet another
// column's, so splitting the columns changes no rounding); the epilogue is
// epi_f32.
constexpr int RS_PRODUCER_REGS = 56, RS_CONSUMER_REGS = 224, RS_EPI_THREADS = 96;
// The epilogue warps store rows [0, RS_EPI_ROWS) of each warpgroup's 64
// where the product is shallow (K <= RS_SHARE_K: fc1's GELU at K <= 256,
// fc2's residual at K <= 512), the consumers the rest; all 64 otherwise.
constexpr int RS_EPI_ROWS = 24;
template <int EPI>
constexpr int RS_SHARE_K = EPI == EPI_GELU ? 256 : 512;

__host__ __device__ constexpr bool a_in_registers(int epi) {
  return epi == EPI_GELU || epi == EPI_RESID;
}

// Per stage: A (BM rows), B_hi, B_lo; then the staging tile; as many stages
// as 227 KB hold beside it (3 at BN = 128, 4 at 96, 5 at 64).
template <int BN>
struct SmemRS {
  static constexpr int A_BYTES = BM * BK * 4;
  static constexpr int B_BYTES = BN * BK * 4;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int LDC = BN + 8;  // staging row pitch, floats
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int STAGES = (232448 - 1024 - 256 - C_BYTES) / STAGE_BYTES;
  static constexpr int BYTES = 1024 + STAGES * STAGE_BYTES + C_BYTES + (2 * STAGES + 2) * 8;
};

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma.m64nNk8 TF32 with A from registers: a[0..3] the warp's 16 x 8
// fragment of A (row lane/4, +8 for a[1], a[3]; column lane%4, +4 for a[2],
// a[3]), B from shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n48(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db, int acc) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, acc);
  else if constexpr (N == 48) wgmma_rs_n48(d, a, db, acc);
  else wgmma_rs_n32(d, a, db, acc);
}

// What a consumer thread of the RS path works with: the ring and its
// warpgroup and lane.
struct RsCtx {
  uint8_t* ring;
  uint64_t *full, *empty;
  int wg, tid, warp, lane;
};

// Ring position s (the block's K step s, across its tiles): its stage.
template <int BN>
__device__ __forceinline__ uint8_t* rs_stage(const RsCtx& c, int s) {
  return c.ring + (s % SmemRS<BN>::STAGES) * SmemRS<BN>::STAGE_BYTES;
}

// Wait for position s's stage and load this thread's A fragments of its K
// step, split: f[8 kk + q] the hi part of k8 step kk's a[q], f[8 kk + 4 +
// q] its lo part.  The 128-byte swizzle moves 16-byte chunk j of row r to
// chunk j ^ (r % 8); both of a thread's rows have r % 8 = lane / 4.
template <int BN>
__device__ __forceinline__ void rs_fragments(uint32_t* f, const RsCtx& c, int s) {
  sm90::mbar_wait(&c.full[s % SmemRS<BN>::STAGES], (uint32_t)(s / SmemRS<BN>::STAGES) & 1);
  const int g = c.lane / 4;
  const uint8_t* row = rs_stage<BN>(c, s) + (64 * c.wg + 16 * c.warp + g) * 128 + (c.lane % 4) * 4;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x = *reinterpret_cast<const float*>(row + (q & 1) * 8 * 128 +
                                                      (((2 * kk + q / 2) ^ g) << 4));
      const float h = rna_tf32(x);
      f[8 * kk + q] = __float_as_uint(h);
      f[8 * kk + 4 + q] = __float_as_uint(rna_tf32(x - h));
    }
  }
}

// Half H of one K step: its twelve wgmmas, A_lo.B_hi, A_hi.B_lo, A_hi.B_hi
// for each k8, over columns [H BN/2, (H + 1) BN/2) into the fresh
// accumulator d; one commit group.
template <int BN, int H>
__device__ __forceinline__ void rs_issue(float* d, const uint32_t* f, const uint8_t* st) {
  using S = SmemRS<BN>;
  const uint32_t bh = smem_u32(st) + S::A_BYTES + H * (BN / 2) * 128, bl = bh + S::B_BYTES;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    wgmma_rs<BN / 2>(d, f + 8 * kk + 4, smem_desc(bh + 32 * kk), kk > 0);
    wgmma_rs<BN / 2>(d, f + 8 * kk, smem_desc(bl + 32 * kk), 1);
    wgmma_rs<BN / 2>(d, f + 8 * kk, smem_desc(bh + 32 * kk), 1);
  }
  sm90::wgmma_commit();
}

// A K step's fresh sum d of one column half into that half of acc (k = 0
// starts it), rounded to nearest.
template <int BN>
__device__ __forceinline__ void rs_add(float* acc, float* d, int k) {
  sm90::fence_regs<BN / 4>(d);
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) acc[i] = k > 0 ? acc[i] + d[i] : d[i];
}

// K step k of a tile whose first K step is at ring position pos, its A
// fragments in f (f_next receives step k + 1's): half 0 into d0; once step
// k - 1's half 1 is done, its stage released and its sum added; half 1 into
// d1; step k + 1's fragments; work(k) under the two groups; once half 0 is
// done, its sum added.  A stage is released once the wgmmas that read it
// are done: the wait, not the add (the compiler orders an accumulator's
// reads after its wgmma by itself), is what keeps the producer off it.
template <int BN, class Work>
__device__ __forceinline__ void rs_step(float* acc, float* d0, float* d1, uint32_t* f,
                                        uint32_t* f_next, const RsCtx& c, int ksteps, int pos,
                                        int k, const Work& work) {
  const uint8_t* st = rs_stage<BN>(c, pos + k);
  rs_issue<BN, 0>(d0, f, st);
  if (k > 0) {
    sm90::wgmma_wait<1>();
    sm90::mbar_arrive(&c.empty[(pos + k - 1) % SmemRS<BN>::STAGES]);
    rs_add<BN>(acc + BN / 4, d1, k - 1);
  }
  rs_issue<BN, 1>(d1, f, st);
  if (k + 1 < ksteps) rs_fragments<BN>(f_next, c, pos + k + 1);
  work(k);
  sm90::wgmma_wait<1>();
  rs_add<BN>(acc, d0, k);
}

// The epilogue of four columns (c4...) of row `row` of the staging tile,
// tile (mt, nt): 16-byte loads and stores, coalesced along N.
template <int BN, int EPI>
__device__ __forceinline__ void rs_epi_group(const EpiF32& p, const float* staging, int mt, int nt,
                                             int row, int c4) {
  const int r = mt * BM + row;
  if (r >= p.M) return;
  const float4 a = *reinterpret_cast<const float4*>(staging + row * SmemRS<BN>::LDC + c4);
  const int n = nt * BN + c4;
  const long long o = (long long)r * p.ldo + n;
  float4 res = make_float4(0.f, 0.f, 0.f, 0.f);
  if (EPI == EPI_RESID) res = *reinterpret_cast<const float4*>(p.res + o);
  *reinterpret_cast<float4*>(p.out + o) = make_float4(
      epi_f32<EPI>(p, a.x, n, 0.f, 0.f, res.x), epi_f32<EPI>(p, a.y, n + 1, 0.f, 0.f, res.y),
      epi_f32<EPI>(p, a.z, n + 2, 0.f, 0.f, res.z), epi_f32<EPI>(p, a.w, n + 3, 0.f, 0.f, res.w));
}

// A consumer warpgroup's share of the epilogue of a staged tile (mt, nt):
// rows [RS_EPI_ROWS, 64) of its own 64, as 4-column groups, this thread's
// groups i0 <= i < i1 (group tid + 128 i).
template <int BN, int EPI>
__device__ __forceinline__ void rs_share(const EpiF32& p, const float* staging, const RsCtx& c,
                                         int mt, int nt, int i0, int i1) {
  constexpr int GROUPS = (64 - RS_EPI_ROWS) * (BN / 4);
  for (int i = i0; i < i1; ++i) {
    const int g = c.tid + 128 * i;
    if (g >= GROUPS) return;
    rs_epi_group<BN, EPI>(p, staging, mt, nt, 64 * c.wg + RS_EPI_ROWS + g / (BN / 4),
                          g % (BN / 4) * 4);
  }
}

// A consumer thread's accumulator into its rows of the staging tile
// (fragment layout: acc[4j + 2i + e] is row 16*warp + lane/4 + 8i of the
// warpgroup's 64, column 8j + 2*(lane%4) + e).
template <int BN>
__device__ __forceinline__ void rs_stage_acc(const float* acc, const RsCtx& c, float* staging) {
  float* cs = staging + (64 * c.wg + 16 * c.warp + c.lane / 4) * SmemRS<BN>::LDC +
              2 * (c.lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(cs + 8 * i * SmemRS<BN>::LDC + 8 * j) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
}

template <int BN, int EPI>
__device__ __forceinline__ void gemm_rs(const CUtensorMap* tma_a, const CUtensorMap* tma_b,
                                        const EpiF32& p, int K) {
  using S = SmemRS<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((s0 + 1023) & ~1023u) - s0);  // 1024-aligned for the swizzle
  float* staging = reinterpret_cast<float*>(ring + S::STAGES * S::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::STAGES * S::STAGE_BYTES + S::C_BYTES);
  uint64_t* empty = full + S::STAGES;
  uint64_t* epi_full = empty + S::STAGES;
  uint64_t* epi_empty = epi_full + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);                 // the producer's expect_tx arrival
      sm90::mbar_init(&empty[s], CONSUMERS * 128);  // every consumer thread
    }
    sm90::mbar_init(epi_full, CONSUMERS * 128);  // every consumer thread staged the tile
    sm90::mbar_init(epi_empty, RS_EPI_THREADS);  // every epilogue thread read it
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n_tiles = p.N / BN, tiles = (p.M + BM - 1) / BM * n_tiles, ksteps = K / BK;
  const int count = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (wg == CONSUMERS) {
    setmaxnreg_dec<RS_PRODUCER_REGS>();
    if (tid == 0) {  // the producer: one thread keeps the ring full
      for (int s = 0; s < count * ksteps; ++s) {
        const int t = blockIdx.x + s / ksteps * gridDim.x, k = s % ksteps;
        uint8_t* st = ring + (s % S::STAGES) * S::STAGE_BYTES;
        uint64_t* bar = &full[s % S::STAGES];
        sm90::mbar_wait(&empty[s % S::STAGES], ((uint32_t)(s / S::STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(bar, S::A_BYTES + 2 * S::B_BYTES);
        sm90::tma_load_3d(st, tma_a, k * BK, t / n_tiles * BM, 0, bar);
        sm90::tma_load_3d(st + S::A_BYTES, tma_b, k * BK, t % n_tiles * BN, 0, bar);
        sm90::tma_load_3d(st + S::A_BYTES + S::B_BYTES, tma_b, k * BK, t % n_tiles * BN, 1,
                          bar);
      }
    } else if (tid >= 32) {  // the epilogue warps: their rows of each warpgroup's 64
      const int rows = K <= RS_SHARE_K<EPI> ? RS_EPI_ROWS : 64;
      for (int j = 0; j < count; ++j) {
        const int t = blockIdx.x + j * gridDim.x, mt = t / n_tiles, nt = t % n_tiles;
        sm90::mbar_wait(epi_full, j & 1);  // the consumers staged tile j
        for (int h = 0; h < CONSUMERS; ++h)
          for (int q = tid - 32; q < rows * (BN / 4); q += RS_EPI_THREADS)
            rs_epi_group<BN, EPI>(p, staging, mt, nt, 64 * h + q / (BN / 4), q % (BN / 4) * 4);
        sm90::mbar_arrive(epi_empty);
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<RS_CONSUMER_REGS>();
  const RsCtx c{ring, full, empty, wg, tid, tid / 32, tid % 32};
  // groups of a staged tile that a thread stores, over its next tile's K steps
  const int share_groups =
      K <= RS_SHARE_K<EPI> ? ((64 - RS_EPI_ROWS) * (BN / 4) + 127) / 128 : 0;
  const int per_step = (share_groups + ksteps - 1) / ksteps;
  float acc[BN / 2], d0[BN / 4], d1[BN / 4];
  uint32_t fa[32], fb[32];
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) d0[i] = d1[i] = 0.f;  // read (scaled by 0) by 1st wgmmas
  for (int j = 0; j < count; ++j) {
    const int pos = j * ksteps, prev = blockIdx.x + (j - 1) * gridDim.x;
    // this warpgroup's share of tile j - 1's epilogue, spread over tile j's K steps
    const auto share = [&](int k) {
      if (j > 0)
        rs_share<BN, EPI>(p, staging, c, prev / n_tiles, prev % n_tiles, k * per_step,
                          min(share_groups, (k + 1) * per_step));
    };
    rs_fragments<BN>(fa, c, pos);
    for (int k = 0; k < ksteps; k += 2) {
      rs_step<BN>(acc, d0, d1, fa, fb, c, ksteps, pos, k, share);
      if (k + 1 < ksteps) rs_step<BN>(acc, d0, d1, fb, fa, c, ksteps, pos, k + 1, share);
    }
    sm90::wgmma_wait<0>();  // the last K step's wgmmas: its stage, then its sum
    sm90::mbar_arrive(&empty[(pos + ksteps - 1) % S::STAGES]);
    rs_add<BN>(acc + BN / 4, d1, ksteps - 1);
    named_sync(1 + wg, 128);                  // this warpgroup stored its share of tile j - 1
    sm90::mbar_wait(epi_empty, (j & 1) ^ 1);  // the epilogue warps read tile j - 1
    rs_stage_acc<BN>(acc, c, staging);
    sm90::mbar_arrive(epi_full);
    named_sync(1 + wg, 128);  // tile j staged: this warpgroup may read its share
  }
  const int last = blockIdx.x + (count - 1) * gridDim.x;
  rs_share<BN, EPI>(p, staging, c, last / n_tiles, last % n_tiles, 0, share_groups);
}

template <int BN, int EPI, class ALoad>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap tma_a,
                       const __grid_constant__ CUtensorMap tma_b, const EpiF32 p,
                       const ALoad load_a, int K) {
  if constexpr (a_in_registers(EPI)) {
    gemm_rs<BN, EPI>(&tma_a, &tma_b, p, K);
  } else {
  using S = Smem<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((s0 + 1023) & ~1023u) - s0);  // 1024-aligned for the swizzle
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::STAGES * S::STAGE_BYTES);
  uint64_t* empty = full + S::STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);                 // the producer's expect_tx arrival
      sm90::mbar_init(&empty[s], CONSUMERS * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m_tiles = (p.M + BM - 1) / BM, n_tiles = p.N / BN;
  const int tiles = m_tiles * n_tiles, ksteps = K / BK;

  if (wg == CONSUMERS) {  // producer: one thread keeps the ring full
    if (tid != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      produce_tile<BN>(load_a, &tma_a, &tma_b, ring, full, empty, ksteps, t / n_tiles,
                       t % n_tiles, stage, phase);
    return;
  }

  // consumers; fragment layout of wgmma m64nNk8: acc[4j + 2i + e] is row
  // 16*warp + lane/4 + 8i, column 8j + 2*(lane%4) + e
  float acc[BN / 2], tmp[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) tmp[i] = 0.f;  // read (scaled by 0) by each tile's first wgmma
  const int warp = tid / 32, lane = tid % 32;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int nt = t % n_tiles, mt = t / n_tiles;
    consume_tile<BN>(acc, tmp, ring, full, empty, wg, tid, ksteps, stage, phase);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = mt * BM + wg * 64 + 16 * warp + lane / 4 + 8 * i;
      if (r >= p.M) continue;
      float rs = 0.f, mu = 0.f;
      if (EPI == EPI_QKV || EPI == EPI_MERGE) {
        rs = p.rs[r];
        mu = p.mu[r];
      }
      long long o = (long long)r * p.ldo;
      if (EPI == EPI_PROJ) {  // the row's place in the un-partitioned, un-rolled image
        const int rr2 = p.R * p.R, img = r / rr2;
        o = ((long long)img * rr2 + window_src(r - img * rr2, p.R, p.win, p.shift)) *
            p.ldo;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = nt * BN + 8 * j + 2 * (lane % 4);
        float2 res = make_float2(0.f, 0.f);
        if (EPI == EPI_PROJ) res = *reinterpret_cast<const float2*>(p.res + o + n);
        *reinterpret_cast<float2*>(p.out + o + n) =
            make_float2(epi_f32<EPI>(p, acc[4 * j + 2 * i], n, rs, mu, res.x),
                        epi_f32<EPI>(p, acc[4 * j + 2 * i + 1], n + 1, rs, mu, res.y));
      }
    }
  }
  }
}

// One f32 operand as TMA sees it: `rows` rows of K floats at row stride
// `ld` elements, `batch` copies `batch_stride` elements apart (B: 2, hi
// then lo).
struct Operand {
  const float* ptr;
  int rows, K;
  long long ld;
  int batch;
  long long batch_stride;
};

inline Operand rows_of(const float* ptr, int rows, int K, long long ld) {
  return Operand{ptr, rows, K, ld, 1, (long long)rows * ld};
}

// B's [hi; lo] stack: (2, N, K) contiguous
inline Operand split_of(const float* ptr, int N, int K) {
  return Operand{ptr, N, K, K, 2, (long long)N * K};
}

inline int encode(CUtensorMap* map, const Operand& o, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)o.K, (cuuint64_t)o.rows, (cuuint64_t)o.batch};
  const cuuint64_t strides[2] = {(cuuint64_t)o.ld * 4, (cuuint64_t)o.batch_stride * 4};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1};
  return sm90::encode_map(map, o.ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, dims, strides, box);
}

template <int BN, int EPI, class ALoad>
int launch_bn(const CUtensorMap& ta, const ALoad& load_a, const Operand& b, const EpiF32& p,
              int K, cudaStream_t stream) {
  CUtensorMap tb;
  int e;
  if ((e = encode(&tb, b, BN)) != 0) return e;
  const int dev = sm90::current_card();
  if (dev >= sm90::MAX_CARDS) return cudaErrorInvalidDevice;
  constexpr int SMEM = a_in_registers(EPI) ? SmemRS<BN>::BYTES : Smem<BN>::BYTES;
  static std::atomic<bool> attr[sm90::MAX_CARDS];  // per instantiation and card
  if (!attr[dev].load(std::memory_order_acquire)) {
    if ((e = cudaFuncSetAttribute(gemm_tf32x3_kernel<BN, EPI, ALoad>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM)) !=
        cudaSuccess)
      return e;
    attr[dev].store(true, std::memory_order_release);
  }
  const int tiles = ((p.M + BM - 1) / BM) * (p.N / BN), sms = sm90::sm_count(dev);
  const int grid = tiles < sms ? tiles : sms;
  gemm_tf32x3_kernel<BN, EPI, ALoad><<<grid, THREADS, SMEM, stream>>>(ta, tb, p, load_a, K);
  return cudaGetLastError();
}

// out = epilogue(A @ B^T), A's map and loader made by the caller: each load
// fills a BM x BK K-major f32 tile under the 128-byte swizzle.  b: the
// (2, N, K) [hi; lo] stack.  The column tile: 128 where it divides N, else
// 64, else (N % 96 == 0, checked by the caller) 96.
template <int EPI, class ALoad>
int gemm_mapped(const CUtensorMap& ta, const ALoad& load_a, const Operand& b, const EpiF32& p,
                int K, cudaStream_t stream) {
  if (p.N % 128 == 0) return launch_bn<128, EPI>(ta, load_a, b, p, K, stream);
  if (p.N % 64 == 0) return launch_bn<64, EPI>(ta, load_a, b, p, K, stream);
  return launch_bn<96, EPI>(ta, load_a, b, p, K, stream);
}

// out = epilogue(A @ B^T): A (M x K) rows, B the (2, N, K) [hi; lo] stack.
template <int EPI>
int gemm(const Operand& a, const float* b_split, const EpiF32& p, cudaStream_t stream) {
  CUtensorMap ta;
  const int e = encode(&ta, a, BM);
  return e != 0 ? e
                : gemm_mapped<EPI>(ta, RowsA{}, split_of(b_split, p.N, a.K), p, a.K, stream);
}

}  // namespace tf32x3
}  // namespace
