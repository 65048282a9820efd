// Causal / sliding-window attention with an online softmax (flash
// attention, forward) for bf16 at every head dim D <= 256, on Hopper's
// tensor cores.
//
// repro_flash_attention_sm90 and repro_flash_attention_sm90_narrow replace
// src/repro/kernels/flash_attention.py::flash_attention (_flash_kernel) for
// bf16 q, k, v, and serve ops.gqa_flash_attention too:
//   out[q] = sum_k softmax_k(scale * q.k | mask) v[k]
// with the mask "key < S, key <= query if causal, query - key < window if a
// window is given"; f32 runs flash_attention_tf32x3.cu
// (kernels/flash_attention.py::flash_route picks the kernel by dtype,
// flash_copy_width the loader by alignment). A row with no key left gives
// 0. Tensors are addressed by (batch, head,
// position) strides with unit stride along D, so the kernel reads the
// [B, H, S, D] layout and the model's [B, S, H, D] layout alike; query head
// h reads kv head h / group (grouped-query attention without a repeat).
//   Bound: 4*D flops per (query, key) pair the mask keeps (QK^T and PV)
//   over the 989 TFLOP/s dense bf16 tensor-core peak, or the bytes of q, k,
//   v and out over 3.35 TB/s, whichever is larger; for qwen2-7b's causal
//   S = 4,096, 28 heads, D = 128 that is 120 GFLOP, about 122 us, bound by
//   operations.
//   Design: one CTA of two warpgroups (256 threads) owns a 128-row query
//   tile of one (batch, head), 64 rows a warpgroup, and loops over key
//   tiles of 128 keys (64 at D = 256) itself, carrying the softmax state
//   and the output in registers. TMA copies Q once and K and V through a
//   two-stage ring in shared memory, each tile as 64-column boxes with the
//   128-byte swizzle; tensor maps are 4-D over (D, heads, positions,
//   batch) with the caller's strides, encoded on the host per call
//   (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, no -lcuda).
//   Thread 0 issues the loads one tile ahead: full barriers carry the
//   bytes, empty barriers one arrival per warp once its products are done
//   (the body, attend(), is shared with the narrow loader below).
//   S = Q K^T is wgmma m64nBKk16 with Q and K both K-major in shared
//   memory (the descriptor steps 32 bytes per k16 inside a swizzle atom,
//   then atom to atom). The online softmax runs on the f32 accumulator
//   fragments (thread t holds rows 16*warp + t%32/4 and +8): row max over
//   the quad of threads that share a row, exp2 with scale*log2(e) folded
//   in, m_safe and corr = 0 for an empty row as in the reference, l kept
//   per thread and summed over the quad at the end. P is rounded to bf16
//   in registers and repacked from the accumulator layout into wgmma's A
//   fragments (the one rounding the reference does not do, which keeps P
//   in f32); O += P V is wgmma m64nDk16 with A from registers and V
//   MN-major in shared memory (the transpose bit, LBO = the stride
//   between 64-column blocks, SBO = 8 key rows). Key tiles wholly above
//   the diagonal or left of the window are never loaded, tiles a
//   warpgroup cannot see are skipped by it, and only tiles that straddle
//   an edge (or hold keys >= S, which TMA zero-fills and a zero key would
//   score 0, not -inf) take element masks; query tiles run heavy first.
//   The epilogue divides by max(l, 1e-30), rounds to bf16 (nearest even)
//   and stores rows < S from the fragments. Shared memory is 161 KB at
//   D = 128 and 193 KB at D = 256, above the 48 KB default, so the entry
//   point raises the kernel's dynamic limit.
//   Head dims: the kernel is compiled at Dp in {64, 128, 256}, and a call
//   at D runs the smallest Dp >= D with D passed at run time (96 runs at
//   128, 136 at 256), in a second instantiation (PAD) so that a call at
//   Dp itself runs code without the checks below. The tensor maps take D
//   as the extent of dim 0, so the columns of a 64-column box past D are
//   zero-filled by TMA, as keys >= S are; a box wholly past D (D <= 192 at
//   Dp = 256) is not loaded, and its Q, K and V blocks are zeroed once in
//   shared memory before the first load (a cross-proxy fence makes the
//   zeros visible to wgmma). Zero columns of Q and K add exact zeros to
//   QK^T; zero columns of V fill output columns >= D, which the epilogue
//   never stores (it stores columns < D, as it stores rows < S). The scale
//   is the caller's, from the real D. The byte count of a stage: TMA
//   signals complete_tx with the whole box's bytes, zero-filled part
//   included (the keys >= S of a partial tile have relied on this since
//   the kernel's first version), so expect_tx counts (loaded boxes) x (box
//   bytes), the dead boxes left out.
//   Loaders: TMA needs 16-byte aligned bases and strides, and a row of D
//   whole 16 bytes (D % 8 == 0). Every other call (any D in 1..256, or an
//   aligned D in a view 2, 4 or 8 bytes off) runs flash_fwd_sm90_narrow:
//   the same body, fed through pointers and (batch, head, position)
//   strides. Its copies write each element of a tile at the address the
//   tensor map would have used (chunk index XOR row mod 8 inside each
//   64-column block), with the widest copy every base, stride and D * 2
//   allow: 8- or 4-byte cp.async, or, for 2-byte aligned rows (odd D), two
//   2-byte loads through registers and one 4-byte store; every tile starts
//   as zeros and only columns < d are copied (rows >= S as zeros). Each
//   copying thread keeps one column and steps down the rows, so a copy
//   costs a few integer operations. At D <= 128 a producer warpgroup
//   (threads 256-383) makes the copies and feeds the same full/empty
//   mbarrier ring as TMA: a stage is handed over once the producer's
//   copies have landed (cp.async.wait_group), after a cross-proxy fence
//   (generic-proxy writes that wgmma reads in the async proxy), by 128
//   arrivals on its full barrier. When the body's 256 threads made the
//   copies themselves before each tile's products, handing a stage over
//   by cp.async.wait_group, the fence and __syncthreads, the copies cost
//   more than the products (about twice TMA's time at phi-3-vision's shape
//   with D = 100, PERF.md). ptxas gives the 384 threads 168 registers
//   each (setmaxnreg did not raise that), which the body fits at D <= 128
//   and not at 256 (about 200), so at D = 256 the body's threads copy,
//   in that first design. The epilogue stores column pairs where the rows
//   are 4-byte aligned, single columns otherwise (an odd D ends in half a
//   pair). The narrow kernel is always the PAD instantiation. Bound as
//   above: at phi-3-vision's length and heads with D = 100 (the 128-wide
//   instantiation) the products, about 109 us.
#include <cuda.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 128;           // query rows of a CTA, 64 a warpgroup
constexpr int kSm90Threads = 256;  // two warpgroups
constexpr int kWarps = kSm90Threads / 32;
// the narrow kernel: at D <= 128 a producer warpgroup besides the body's
// two (ptxas gives 384 threads 168 registers each, which the body fits at
// D <= 128 and not at 256), at D = 256 the body's alone
constexpr int kProducers = 128;
__host__ __device__ constexpr int narrow_threads(int D) {
  return D <= 128 ? kSm90Threads + kProducers : kSm90Threads;
}
constexpr int kRowBytes = 128;     // one swizzled row of a 64-column box

template <int D>
struct Tile {
  static constexpr int BK = D <= 128 ? 128 : 64;  // keys of a tile
  static constexpr int NCB = D / 64;              // 64-column blocks
  static constexpr int Q_CB = kBQ * kRowBytes;    // bytes of a Q block
  static constexpr int KV_CB = BK * kRowBytes;    // bytes of a K / V block
  static constexpr int Q_BYTES = NCB * Q_CB;
  static constexpr int KV_BYTES = NCB * KV_CB;    // one of K or V
  // 1,024 B of slack to align the swizzle atoms, Q, two stages of K and V,
  // then five mbarriers (full[2], empty[2], q)
  static constexpr size_t SMEM = 1024 + Q_BYTES + 4 * KV_BYTES + 5 * 8;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of the given parity has completed. A wait that
// outlasts about ten seconds of SM clocks is a fault (a load that never
// lands): trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// ---- TMA -------------------------------------------------------------------

// One box of the 4-D map at (d, head, position, batch) into shared memory,
// its bytes counted on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int h, int p,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(d), "r"(h), "r"(p), "r"(b)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3fff) |
         (uint64_t)((lbo >> 4) & 0x3fff) << 16 |
         (uint64_t)((sbo >> 4) & 0x3fff) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin an accumulator register in program order around the asynchronous
// products, so the compiler neither reads it before the wait nor moves a
// write past an issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// m64nNk16, f32 += bf16 * bf16. WgmmaSS: A and B from shared memory, both
// K-major; WgmmaRS: A from registers, B from shared memory MN-major
// (transposed). scale_d = 0 overwrites d.
template <int N>
struct WgmmaSS;
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- what a CTA does -------------------------------------------------------

// The shared tiles and barriers, the CTA's (batch, head, query tile) and
// the key tiles some query of it may see; ncb: the 64-column blocks that
// hold columns < d.
struct Geometry {
  uint8_t* sQ;
  uint8_t* sKV;   // stage s: K at 2s, V at 2s + 1
  uint64_t* bars;   // full[2], empty[2], q_full
  int S, d, b, h, hk, q0, kt_lo, n_tiles, ncb;
};

template <int D, bool PAD>
__device__ __forceinline__ Geometry geometry(int BH, int H, int group, int S,
                                             int d, int causal, int window,
                                             int has_window) {
  using T = Tile<D>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern follows address bits 4-9: align the tiles to 1 KB
  uint8_t* const sQ =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const sKV = sQ + T::Q_BYTES;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);  // heavy tiles first
  const int b = bh / H, h = bh - b * H, hk = h / group;
  const int q0 = qt * kBQ;
  const int q_last = min(q0 + kBQ, S) - 1;
  const int lo = has_window ? q0 - window + 1 : 0;
  const int kt_lo = lo > 0 ? lo / BK : 0;
  const int kt_hi = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  return Geometry{sQ, sKV,
                  reinterpret_cast<uint64_t*>(sKV + 4 * T::KV_BYTES),
                  S, d, b, h, hk, q0, kt_lo, kt_hi - kt_lo,
                  PAD ? (d + 63) / 64 : T::NCB};
}

// full[s] and q_full take full_count arrivals, empty[s] one a body warp
__device__ __forceinline__ void init_barriers(const Geometry& g,
                                              uint32_t full_count) {
  mbar_init(&g.bars[0], full_count);
  mbar_init(&g.bars[1], full_count);
  mbar_init(&g.bars[2], kWarps);
  mbar_init(&g.bars[3], kWarps);
  mbar_init(&g.bars[4], full_count);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// ---- loaders ---------------------------------------------------------------
//
// Both fill one shared layout: Q, then two stages of K and V, each tile in
// 64-column blocks of 128-byte rows, the 16-byte chunk c of row r at chunk
// c ^ (r % 8) (the 128-byte swizzle the wgmma descriptors name), and hand
// a stage over through the full barrier; the body's warps release it
// through the empty barrier (one arrival a warp). The body calls start(),
// wait_q() before the first product, then for key tile n next(n) before
// its products and done(n) after them.

// TMA: thread 0 issues the boxes one tile ahead; full barriers count their
// bytes.
template <int D>
struct TmaLoader {
  using T = Tile<D>;
  const CUtensorMap* q_map;
  const CUtensorMap* k_map;
  const CUtensorMap* v_map;
  Geometry g;

  __device__ uint64_t* full() const { return g.bars; }
  __device__ uint64_t* empty() const { return g.bars + 2; }
  __device__ uint64_t* q_full() const { return g.bars + 4; }

  // key tile kt_lo + n into stage n & 1 (K, then V at +KV_BYTES), the ncb
  // 64-column blocks that hold columns < d, their bytes counted on
  // full[n & 1]
  __device__ __forceinline__ void load_kv(int n) const {
    uint8_t* const dst = g.sKV + (n & 1) * 2 * T::KV_BYTES;
    const int k0 = (g.kt_lo + n) * T::BK;
    mbar_expect_tx(&full()[n & 1], 2 * g.ncb * T::KV_CB);
#pragma unroll
    for (int cb = 0; cb < T::NCB; ++cb) {
      if (cb < g.ncb) {
        tma_load(dst + cb * T::KV_CB, k_map, &full()[n & 1], cb * 64, g.hk,
                 k0, g.b);
        tma_load(dst + T::KV_BYTES + cb * T::KV_CB, v_map, &full()[n & 1],
                 cb * 64, g.hk, k0, g.b);
      }
    }
  }
  __device__ __forceinline__ void start() const {
    // the 64-column blocks past d are zeroed here once (Q's and both
    // stages' K and V) and never loaded
    if (g.ncb < T::NCB) {
      for (int cb = g.ncb; cb < T::NCB; ++cb) {
        uint4* const zq = reinterpret_cast<uint4*>(g.sQ + cb * T::Q_CB);
        for (int i = threadIdx.x; i < T::Q_CB / 16; i += kSm90Threads)
          zq[i] = make_uint4(0, 0, 0, 0);
        for (int blk = 0; blk < 4; ++blk) {   // K, V of stage 0, stage 1
          uint4* const zkv = reinterpret_cast<uint4*>(
              g.sKV + blk * T::KV_BYTES + cb * T::KV_CB);
          for (int i = threadIdx.x; i < T::KV_CB / 16; i += kSm90Threads)
            zkv[i] = make_uint4(0, 0, 0, 0);
        }
      }
      // the zeros are read by wgmma, in the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    if (threadIdx.x == 0) init_barriers(g, 1);
    __syncthreads();
    if (threadIdx.x == 0 && g.n_tiles > 0) {
      mbar_expect_tx(q_full(), g.ncb * T::Q_CB);
#pragma unroll
      for (int cb = 0; cb < T::NCB; ++cb)
        if (cb < g.ncb)
          tma_load(g.sQ + cb * T::Q_CB, q_map, q_full(), cb * 64, g.h, g.q0,
                   g.b);
      load_kv(0);
    }
  }
  __device__ __forceinline__ void wait_q() const {
    if (g.n_tiles > 0) mbar_wait(q_full(), 0);
  }
  __device__ __forceinline__ void next(int n) const {
    if (threadIdx.x == 0 && n + 1 < g.n_tiles) {
      // stage (n + 1) & 1 last held tile n - 1: wait until it is released
      if (n >= 1) mbar_wait(&empty()[(n + 1) & 1], ((n - 1) >> 1) & 1);
      load_kv(n + 1);
    }
    __syncwarp();
    mbar_wait(&full()[n & 1], (n >> 1) & 1);
  }
  __device__ __forceinline__ void done(int n) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty()[n & 1]);
  }
};

// W bytes (8 or 4) global -> shared through L1; with in = false nothing is
// read and the destination is zero-filled.
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(smem_u32(dst)), "l"(src), "n"(W), "r"(in ? W : 0)
               : "memory");
}

// P copying threads (this one t) copy ROWS positions from p0 on of the
// rows at src (stride ss) into the tile at dst, whose 64-column blocks are
// cb_bytes apart, at the swizzled address of each (row, column); columns
// < d only (the rest of the tiles stays as zeroed at the start), rows at
// or past S as zeros. W bytes a copy: 8 or 4 by cp.async, or W = 2: two
// 2-byte loads through registers and one 4-byte st.shared (an odd d's last
// pair holds a zero; eight rows' loads are issued before their stores). A
// row takes per_row copies; the first P / per_row * per_row threads each
// keep one column and step down the rows P / per_row at a time (the rest
// idle), so a copy costs a few integer operations.
template <int ROWS, int W, int P>
__device__ __forceinline__ void copy_tile(uint8_t* dst, int cb_bytes,
                                          const __nv_bfloat16* src,
                                          int64_t ss, int p0, int S, int d,
                                          int t) {
  constexpr int E = W == 8 ? 4 : 2;   // columns a copy
  const int per_row = (d + E - 1) / E;   // <= P / 2
  const int rows_step = P / per_row;
  if (t >= rows_step * per_row) return;
  const int r0 = t / per_row, c = (t - r0 * per_row) * E;
  uint8_t* const dc = dst + (c >> 6) * cb_bytes + (c & 7) * 2;
  const int chunk = (c & 63) >> 3;
  const __nv_bfloat16* sp = src + (int64_t)(p0 + r0) * ss + c;
  const int64_t sp_step = (int64_t)rows_step * ss;
  auto dst_of = [&](int r) {
    return dc + r * kRowBytes + ((chunk ^ (r & 7)) << 4);
  };
  if constexpr (W == 2) {
    // eight rows' loads in flight, then their stores
    constexpr int kBatch = 8;
    for (int r = r0; r < ROWS; r += kBatch * rows_step) {
      uint32_t pair[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int rj = r + j * rows_step;
        const unsigned short* const hp =
            reinterpret_cast<const unsigned short*>(sp + j * sp_step);
        const bool in = rj < ROWS && p0 + rj < S;
        const uint32_t lo = in ? __ldg(hp) : 0u;
        const uint32_t hi = in && c + 1 < d ? __ldg(hp + 1) : 0u;
        pair[j] = lo | hi << 16;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int rj = r + j * rows_step;
        if (rj < ROWS) *reinterpret_cast<uint32_t*>(dst_of(rj)) = pair[j];
      }
      sp += kBatch * sp_step;
    }
  } else {
#pragma unroll 4
    for (int r = r0; r < ROWS; r += rows_step, sp += sp_step) {
      const bool in = p0 + r < S;
      cp_async<W>(dst_of(r), in ? sp : src, in);
    }
  }
}

// The sources of the narrow kernel's copies: q at (b, h), k and v at
// (b, hk), and their position strides.
struct Rows {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int64_t q_ss, kv_ss;
};

// The narrow kernel at D <= 128: a producer warpgroup (threads 256-383)
// fills the two stages and hands each over on its full barrier; the body's
// warps wait on it and release a stage on its empty barrier, as with TMA.
struct ProducedLoader {
  Geometry g;
  __device__ __forceinline__ void start() const {}
  __device__ __forceinline__ void wait_q() const {
    if (g.n_tiles > 0) mbar_wait(&g.bars[4], 0);
  }
  __device__ __forceinline__ void next(int n) const {
    mbar_wait(&g.bars[n & 1], (n >> 1) & 1);
  }
  __device__ __forceinline__ void done(int n) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(&g.bars[2 + (n & 1)]);
  }
};

// The producer warpgroup: Q and key tile 0, then each next key tile once
// the body's warps have released its stage; a stage is handed over when
// this thread's copies have landed (cp.async.wait_group), after a
// cross-proxy fence (generic-proxy writes that wgmma reads in the async
// proxy), by one arrival a thread on its full barrier.
template <int D, int W>
__device__ __forceinline__ void produce(const Geometry& g, const Rows& src) {
  using T = Tile<D>;
  const int t = threadIdx.x - kSm90Threads;
  auto hand_over = [](uint64_t* bar) {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(bar);
  };
  for (int n = 0; n < g.n_tiles; ++n) {
    const int st = n & 1;
    uint8_t* const dst = g.sKV + st * 2 * T::KV_BYTES;
    const int k0 = (g.kt_lo + n) * T::BK;
    if (n == 0) {
      copy_tile<kBQ, W, kProducers>(g.sQ, T::Q_CB, src.q, src.q_ss, g.q0,
                                    g.S, g.d, t);
      hand_over(&g.bars[4]);
    } else if (n >= 2) {   // stage n & 1 last held tile n - 2
      mbar_wait(&g.bars[2 + st], ((n - 2) >> 1) & 1);
    }
    copy_tile<T::BK, W, kProducers>(dst, T::KV_CB, src.k, src.kv_ss, k0,
                                    g.S, g.d, t);
    copy_tile<T::BK, W, kProducers>(dst + T::KV_BYTES, T::KV_CB, src.v,
                                    src.kv_ss, k0, g.S, g.d, t);
    hand_over(&g.bars[st]);
  }
}

// The narrow kernel at D = 256 (too many registers for a producer
// warpgroup besides the body): the body's 256 threads copy the next key
// tile into the other of two stages before each tile's products, and a
// stage is handed over by cp.async.wait_group, a cross-proxy fence and a
// barrier; a second barrier after the products frees it.
template <int D, int W>
struct CopyingLoader {
  using T = Tile<D>;
  Geometry g;
  Rows src;
  __device__ __forceinline__ void load_kv(int n) const {
    uint8_t* const dst = g.sKV + (n & 1) * 2 * T::KV_BYTES;
    const int k0 = (g.kt_lo + n) * T::BK;
    copy_tile<T::BK, W, kSm90Threads>(dst, T::KV_CB, src.k, src.kv_ss, k0,
                                      g.S, g.d, threadIdx.x);
    copy_tile<T::BK, W, kSm90Threads>(dst + T::KV_BYTES, T::KV_CB, src.v,
                                      src.kv_ss, k0, g.S, g.d, threadIdx.x);
  }
  __device__ __forceinline__ void start() const {
    if (g.n_tiles > 0) {
      copy_tile<kBQ, W, kSm90Threads>(g.sQ, T::Q_CB, src.q, src.q_ss, g.q0,
                                      g.S, g.d, threadIdx.x);
      load_kv(0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  __device__ __forceinline__ void wait_q() const {}   // lands with tile 0
  __device__ __forceinline__ void next(int n) const {
    if (n + 1 < g.n_tiles) load_kv(n + 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  __device__ __forceinline__ void done(int) const { __syncthreads(); }
};

// ---- the kernel body -------------------------------------------------------

// The body's eight warps (two warpgroups, threads 0-255). PAD: the head
// dim d < D is passed at run time; PAIRS: the output's rows take 4-byte
// stores of column pairs (else one column at a time, and d may be odd).
template <int D, bool PAD, bool PAIRS, class Loader>
__device__ __forceinline__ void attend(
    const Loader& ld, __nv_bfloat16* __restrict__ o, int S, int d,
    int64_t o_sb, int64_t o_sh, int64_t o_ss, float scale_log2, int causal,
    int window, int has_window) {
  using T = Tile<D>;
  constexpr int BK = T::BK;
  const Geometry& g = ld.g;
  uint8_t* const sQ = g.sQ;
  uint8_t* const sKV = g.sKV;
  const int b = g.b, h = g.h, q0 = g.q0, kt_lo = g.kt_lo;
  const int n_tiles = g.n_tiles;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  ld.start();

  // this thread's rows: r0 and r0 + 8; its columns of an 8-wide group:
  // 2 * (lane % 4) and + 1
  const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;
  const int r0 = wg_first + 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(sQ) + wg * 64 * kRowBytes;

  ld.wait_q();
  for (int n = 0; n < n_tiles; ++n) {
    const int st = n & 1, k0 = (kt_lo + n) * BK;
    ld.next(n);

    const bool unseen = (causal && k0 > wg_last) ||
                        (has_window && wg_first - (k0 + BK - 1) >= window);
    if (!unseen) {  // uniform over the warpgroup
      const uint32_t k_addr = smem_u32(sKV + st * 2 * T::KV_BYTES);
      const uint32_t v_addr = k_addr + T::KV_BYTES;

      // S = Q K^T: D / 16 steps of k16, 4 inside each 64-column block
      float s[BK / 2];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks & 3) * 32;
        WgmmaSS<BK>::run(
            s, make_desc(q_addr + (ks >> 2) * T::Q_CB + off, 16, 1024),
            make_desc(k_addr + (ks >> 2) * T::KV_CB + off, 16, 1024),
            ks > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(s);

      // scale into log2 units and mask; s[i] is row r0 + 8 * ((i >> 1) & 1),
      // key k0 + 8 * (i >> 2) + c0 + (i & 1)
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > wg_first) ||
                        (has_window && wg_last - k0 >= window);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = s[i] * scale_log2;
        if (edge) {
          const int kp = k0 + 8 * (i >> 2) + c0 + (i & 1);
          const int qp = r0 + 8 * ((i >> 1) & 1);
          const bool ok = kp < S && (!causal || kp <= qp) &&
                          (!has_window || qp - kp < window);
          x = ok ? x : neg_inf();
        }
        s[i] = x;
      }
      float corr[2], m_safe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = neg_inf();
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (((i >> 1) & 1) == r) mx = fmaxf(mx, s[i]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        m_safe[r] = m_new == neg_inf() ? 0.f : m_new;
        corr[r] = m[r] == neg_inf() ? 0.f : exp2f(m[r] - m_safe[r]);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = exp2f(s[i] - m_safe[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += s[i];
      }
      l[0] = l[0] * corr[0] + rs[0];
      l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      // P as bf16 A fragments: k16 step j takes accumulator columns
      // 16j .. 16j + 15, registers 8j .. 8j + 7 in the order wgmma's A wants
      uint32_t p[BK / 4];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        p[4 * j + 0] = pack_bf16(s[8 * j + 0], s[8 * j + 1]);
        p[4 * j + 1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
        p[4 * j + 2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
        p[4 * j + 3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
      }

      // O += P V: BK / 16 steps of 16 keys (2 KB of V rows each)
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        WgmmaRS<D>::run(acc, p[4 * j], p[4 * j + 1], p[4 * j + 2],
                        p[4 * j + 3],
                        make_desc(v_addr + j * 16 * kRowBytes, T::KV_CB, 1024));
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
    }
    ld.done(n);
  }

  // epilogue: O / l in bf16, rows < S and columns < d
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* const ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = (i >> 1) & 1, qp = r0 + 8 * r;
    const int col = 8 * (i >> 2) + c0;
    if (qp >= S) continue;
    __nv_bfloat16* const op = ob + (int64_t)qp * o_ss + col;
    if constexpr (PAIRS) {   // d even: a pair of columns is in or out
      if (!PAD || col < d)
        *reinterpret_cast<__nv_bfloat162*>(op) = __floats2bfloat162_rn(
            __fdiv_rn(acc[i], l[r]), __fdiv_rn(acc[i + 1], l[r]));
    } else {   // 2-byte aligned rows; an odd d ends in half a pair
      if (col < d) *op = __float2bfloat16_rn(__fdiv_rn(acc[i], l[r]));
      if (col + 1 < d)
        op[1] = __float2bfloat16_rn(__fdiv_rn(acc[i + 1], l[r]));
    }
  }
}

// TMA-fed: 16-byte aligned bases, strides of 16-byte multiples, D % 8 == 0
template <int D, bool PAD>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               __nv_bfloat16* __restrict__ o, int BH, int H, int group, int S,
               int d, int64_t o_sb, int64_t o_sh, int64_t o_ss,
               float scale_log2, int causal, int window, int has_window) {
  const TmaLoader<D> ld{&q_map, &k_map, &v_map,
                        geometry<D, PAD>(BH, H, group, S, d, causal, window,
                                         has_window)};
  attend<D, PAD, true>(ld, o, S, d, o_sb, o_sh, o_ss, scale_log2, causal,
                       window, has_window);
}

// Pointer-and-stride fed, W bytes a copy (8, 4 or 2), any d in 1..D: at
// D <= 128 the body's two warpgroups and a producer warpgroup (threads
// 256-383), at D = 256 the body's alone
template <int D, int W>
__global__ void __launch_bounds__(narrow_threads(D), 1)
flash_fwd_sm90_narrow(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int BH, int H, int group,
                      int S, int d, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                      int64_t kv_sb, int64_t kv_sh, int64_t kv_ss,
                      float scale_log2, int causal, int window,
                      int has_window) {
  using T = Tile<D>;
  const Geometry g = geometry<D, true>(BH, H, group, S, d, causal, window,
                                       has_window);
  const Rows src{q + g.b * q_sb + g.h * q_sh, k + g.b * kv_sb + g.hk * kv_sh,
                 v + g.b * kv_sb + g.hk * kv_sh, q_ss, kv_ss};
  // every tile starts as zeros: the copies write columns < d only
  uint4* const z = reinterpret_cast<uint4*>(g.sQ);
  for (int i = threadIdx.x; i < (T::Q_BYTES + 4 * T::KV_BYTES) / 16;
       i += narrow_threads(D))
    z[i] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if constexpr (D <= 128) {
    if (threadIdx.x == 0) init_barriers(g, kProducers);
    __syncthreads();
    if (threadIdx.x >= kSm90Threads) {
      produce<D, W>(g, src);
      return;
    }
    attend<D, true, W >= 4>(ProducedLoader{g}, o, S, d, q_sb, q_sh, q_ss,
                            scale_log2, causal, window, has_window);
  } else {
    __syncthreads();   // the zeros are in before the copies
    attend<D, true, W >= 4>(CopyingLoader<D, W>{g, src}, o, S, d, q_sb,
                            q_sh, q_ss, scale_log2, causal, window,
                            has_window);
  }
}

// ---- host ------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 [B, *, S, D] tensor as a 4-D map (D, heads, positions, batch) with
// boxes of 64 columns x rows positions, swizzled 128 B; positions past S
// and columns past D read as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int B, int heads, int S,
                int D, int64_t sb, int64_t sh, int64_t ss, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// head dim d on the kernel compiled at D >= d
template <int D, bool PAD>
int launch_sm90(const void* q, const void* k, const void* v, void* o, int B,
                int H, int group, int S, int d, int64_t q_sb, int64_t q_sh,
                int64_t q_ss, int64_t kv_sb, int64_t kv_sh, int64_t kv_ss,
                float scale, int causal, int window, int has_window,
                unsigned n_blocks, cudaStream_t st) {
  using T = Tile<D>;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, q, B, H, S, d, q_sb, q_sh, q_ss, kBQ) ||
      !encode_map(&k_map, k, B, H / group, S, d, kv_sb, kv_sh, kv_ss, T::BK) ||
      !encode_map(&v_map, v, B, H / group, S, d, kv_sb, kv_sh, kv_ss, T::BK))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      (const void*)flash_fwd_sm90<D, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_sm90<D, PAD><<<n_blocks, kSm90Threads, T::SMEM, st>>>(
      q_map, k_map, v_map, (__nv_bfloat16*)o, B * H, H, group, S, d, q_sb,
      q_sh, q_ss, scale * 1.4426950408889634f, causal, window, has_window);
  return (int)cudaGetLastError();
}

// head dim d on the narrow kernel compiled at D >= d, W bytes a copy
template <int D, int W>
int launch_sm90_narrow(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int group, int S, int d, int64_t q_sb,
                       int64_t q_sh, int64_t q_ss, int64_t kv_sb,
                       int64_t kv_sh, int64_t kv_ss, float scale, int causal,
                       int window, int has_window, unsigned n_blocks,
                       cudaStream_t st) {
  using T = Tile<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      (const void*)flash_fwd_sm90_narrow<D, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_sm90_narrow<D, W><<<n_blocks, narrow_threads(D), T::SMEM, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, B * H, H, group, S, d, q_sb,
      q_sh, q_ss, kv_sb, kv_sh, kv_ss, scale * 1.4426950408889634f, causal,
      window, has_window);
  return (int)cudaGetLastError();
}

// The CTA count of a call, or 0 where the shape is refused.
int64_t sm90_blocks(int B, int H, int group, int S) {
  if (B < 1 || H < 1 || S < 1 || group < 1 || H % group != 0) return 0;
  const int64_t n_blocks = (int64_t)B * H * ((S + kBQ - 1) / kBQ);
  if ((int64_t)B * H > 0x7fffffff || n_blocks > 0x7fffffff) return 0;
  return n_blocks;
}

}  // namespace
}  // namespace repro

using namespace repro;

// bf16 q, k, v and out; q and out share the strides (q_sb, q_sh, q_ss), k
// and v share (kv_sb, kv_sh, kv_ss); the head dimension is contiguous in
// all four. TMA needs 16-byte aligned bases and strides that are multiples
// of 16 bytes: anything else is refused, as is a D that is not a multiple of
// 8 in 8..256 (repro_flash_attention_sm90_narrow takes those). D runs on the
// kernel compiled at the next of 64, 128, 256.
extern "C" int repro_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int group, int S, int D, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t kv_sb, int64_t kv_sh, int64_t kv_ss, float scale, int causal,
    int window, int has_window, void* stream) {
  const int64_t n_blocks = sm90_blocks(B, H, group, S);
  if (n_blocks == 0 || D < 8 || D > 256 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t bases[4] = {(uintptr_t)q, (uintptr_t)k, (uintptr_t)v,
                              (uintptr_t)o};
  const int64_t strides[6] = {q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss};
  for (int i = 0; i < 4; ++i)
    if (bases[i] % 16 != 0) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 6; ++i)
    if (strides[i] <= 0 || strides[i] * 2 % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned nb = (unsigned)n_blocks;
  if (D == 64 || D == 128 || D == 256) {
    const auto launch = D == 64 ? launch_sm90<64, false>
                        : D == 128 ? launch_sm90<128, false>
                                   : launch_sm90<256, false>;
    return launch(q, k, v, o, B, H, group, S, D, q_sb, q_sh, q_ss, kv_sb,
                  kv_sh, kv_ss, scale, causal, window, has_window, nb, st);
  }
  const auto launch = D < 64    ? launch_sm90<64, true>
                      : D < 128 ? launch_sm90<128, true>
                                : launch_sm90<256, true>;
  return launch(q, k, v, o, B, H, group, S, D, q_sb, q_sh, q_ss, kv_sb,
                kv_sh, kv_ss, scale, causal, window, has_window, nb, st);
}

// The narrow loader: the same arguments and any D in 1..256, plus width,
// the bytes a copy (8, 4 or 2), which every base and stride and D * 2 must
// be multiples of; anything else is refused. D runs on the kernel compiled
// at the next of 64, 128, 256.
extern "C" int repro_flash_attention_sm90_narrow(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int group, int S, int D, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t kv_sb, int64_t kv_sh, int64_t kv_ss, float scale, int causal,
    int window, int has_window, int width, void* stream) {
  const int64_t n_blocks = sm90_blocks(B, H, group, S);
  if (n_blocks == 0 || D < 1 || D > 256 ||
      (width != 8 && width != 4 && width != 2) || D * 2 % width != 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t bases[4] = {(uintptr_t)q, (uintptr_t)k, (uintptr_t)v,
                              (uintptr_t)o};
  const int64_t strides[6] = {q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss};
  for (int i = 0; i < 4; ++i)
    if (bases[i] % width != 0) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 6; ++i)
    if (strides[i] <= 0 || strides[i] * 2 % width != 0)
      return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned nb = (unsigned)n_blocks;
  const auto launch =
      D <= 64 ? (width == 8   ? launch_sm90_narrow<64, 8>
                 : width == 4 ? launch_sm90_narrow<64, 4>
                              : launch_sm90_narrow<64, 2>)
      : D <= 128 ? (width == 8   ? launch_sm90_narrow<128, 8>
                    : width == 4 ? launch_sm90_narrow<128, 4>
                                 : launch_sm90_narrow<128, 2>)
                 : (width == 8   ? launch_sm90_narrow<256, 8>
                    : width == 4 ? launch_sm90_narrow<256, 4>
                                 : launch_sm90_narrow<256, 2>);
  return launch(q, k, v, o, B, H, group, S, D, q_sb, q_sh, q_ss, kv_sb,
                kv_sh, kv_ss, scale, causal, window, has_window, nb, st);
}
