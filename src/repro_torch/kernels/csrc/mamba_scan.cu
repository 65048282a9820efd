// Mamba-1 selective scan (the recurrence; the D*x skip and the gate are the
// caller's).
//
// repro_mamba_scan replaces src/repro/kernels/mamba_scan.py::mamba_scan
// (_scan_kernel):
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) B_t,   y_t = C_t . h_t
// per batch row and channel, over dt, x [B, S, di], B, C [B, S, ds] (each
// f32 or bf16) and A [di, ds] f32, with the state h [ds] in f32 from zero
// (or from h0 [B, di, ds] f32 where given); y [B, S, di] in x's dtype, and
// where asked for the final state h_S into hlast [B, di, ds] f32 (what a
// model's prefill leaves in its SSM cache for the decode that follows).
// Without h0 and hlast a call computes what it did before they existed,
// bit for bit: the state starts at zero and the loop is unchanged.
//   Bound: the bytes of dt, x and y (and the small B, C, A) over 3.35 TB/s:
//   403 MB for falcon-mamba-7b's di = 8,192, ds = 16 at S = 4,096 f32, about
//   120 us; and the exponentials, one per state and step: 5.37e8 there, at
//   16 a clock an SM (the special-function units) on 132 SMs about 128 us at
//   1.98 GHz. Each state step is one exp and five other flops. The second
//   assumes every exp goes through the special-function units (MUFU), as
//   expf does; a kernel that formed part of its exps as FMA polynomials
//   could go below it, so the byte bound is the harder floor.
//   Design: the TPU kernel ran its grid (B, di blocks, chunks) with the chunk
//   axis in order, carrying a [block_d, ds] state tile in VMEM. Here each
//   (batch row, channel) is a group of L neighbouring lanes of one warp (L
//   in {2, 4, 8, 16} by ds: lanes_for), each lane holding NS = ds / L states
//   (rounded up to a power of two, the states past ds zero) and its slice
//   of A in registers, and stepping through S in order, so nothing is
//   carried between blocks, and an SM holds L times the warps of one thread
//   a channel (at falcon-mamba-7b, L = 4: 256 blocks of four warps, about
//   eight warps an SM, two a scheduler). Each lane's h chain is rounded op
//   by op in the reference's order (__fmul_rn / __fadd_rn); its partial y
//   sums its states' h * c in state order, and the L partials are added by
//   __shfl_xor_sync at offsets 1, 2, 4, 8 (pairs in lane order,
//   (p0 + p1) + (p2 + p3), the same bits in every lane), an order fixed by
//   L alone. A block of 32 channels stages 32 steps at a time in shared
//   memory, double-buffered: the chunk after the one being computed is in
//   flight meanwhile. f32 inputs are copied by cp.async (16 bytes where the
//   rows are aligned, 4 otherwise; rows past S and channels past di
//   zero-filled); bf16 inputs are loaded and converted to f32 on the way in
//   (no overlap). dt and x are read coalesced along di, the chunk's B_t and
//   C_t rows are one contiguous block each. y goes through a shared [32
//   steps, 32 channels] tile and is written in whole rows along di. exp is
//   expf, no fast math: exp2f on A * log2(e) was measured and was not faster
//   at L = 4, and it rounds A * log2(e) and the product, which at
//   jamba-1.5-large's width put an element past the scan's 2e-4 (PERF.md).
//   Six instantiations: (L, NS) = (2, 1), (2, 2), (2, 4), (4, 4), (8, 4),
//   (16, 4), the pairs lanes_for and states_for pick.
//   Issue slots at falcon-mamba-7b, L = 4, NS = 4, expf: about 70 warp
//   instructions a lane-step (two shared loads of dt and x, one of B's and
//   one of C's four states, four times (the exp argument, expf's eight
//   instructions, three ops of h, two of y), two shuffles and adds, the y
//   tile store): 1,024 warps * 4,096 steps * 70 over 132 SMs * 4 schedulers
//   = 0.56 M clocks, about 280 us at 1.98 GHz, above both bounds. With two
//   warps a scheduler the chains of each step (shared loads, expf, the y
//   sum and its shuffles) are not hidden; PERF.md has the measured time.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kChannels = 32;  // channels of a block
constexpr int kChunk = 32;     // steps staged at a time

// how one input is staged (chosen on the host per tensor)
constexpr int kStageConvert = 0;  // element loads converted to f32 (bf16)
constexpr int kStage4 = 1;        // f32, cp.async of 4 bytes
constexpr int kStage16 = 2;       // f32, cp.async of 16 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes global -> shared; with in = false nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One chunk of dt or x: kChunk rows (steps t0..) of the block's kChannels
// channels into dst[kChunk][kChannels]; zeros past S and past di.
__device__ __forceinline__ void stage_tile(float* dst, const void* src,
                                           int code, int mode, int64_t row0,
                                           int64_t t0, int64_t S, int di,
                                           int ch0, int nthr) {
  const float* f = (const float*)src;
  if (mode == kStage16) {  // di % 4 == 0: a 16-byte piece is all in or out
    for (int i = threadIdx.x; i < kChunk * kChannels / 4; i += nthr) {
      const int r = i / (kChannels / 4), c = (i % (kChannels / 4)) * 4;
      const bool in = t0 + r < S && ch0 + c < di;
      cp_async16(dst + r * kChannels + c,
                 in ? f + (row0 + r) * di + ch0 + c : f, in);
    }
    return;
  }
  for (int i = threadIdx.x; i < kChunk * kChannels; i += nthr) {
    const int r = i / kChannels, c = i % kChannels;
    const bool in = t0 + r < S && ch0 + c < di;
    const int64_t at = (row0 + r) * di + ch0 + c;
    if (mode == kStage4)
      cp_async4(dst + i, in ? f + at : f, in);
    else
      dst[i] = in ? load_f32(src, code, at) : 0.f;
  }
}

// One chunk of B or C: the contiguous kChunk * ds values from row row0 into
// dst[kChunk * ds]; zeros past S.
__device__ __forceinline__ void stage_rows(float* dst, const void* src,
                                           int code, int mode, int64_t row0,
                                           int64_t t0, int64_t S, int ds,
                                           int nthr) {
  const float* f = (const float*)src + row0 * ds;
  const int64_t left = S - t0 < kChunk ? S - t0 : kChunk;
  const int n = kChunk * ds, valid = (int)left * ds;
  if (mode == kStage16) {  // ds % 4 == 0, so valid % 4 == 0
    for (int e = threadIdx.x * 4; e < n; e += nthr * 4)
      cp_async16(dst + e, e < valid ? f + e : f, e < valid);
    return;
  }
  for (int e = threadIdx.x; e < n; e += nthr) {
    if (mode == kStage4)
      cp_async4(dst + e, e < valid ? f + e : f, e < valid);
    else
      dst[e] = e < valid ? load_f32(src, code, row0 * ds + e) : 0.f;
  }
}

// NS neighbouring states of a staged B or C row: one vector access where
// the lane's NS states are all below ds (their offset a multiple of NS),
// else one masked load each.
template <int NS, bool FULL>
__device__ __forceinline__ void load_states(const float* row, int s0, int ds,
                                            float (&v)[NS]) {
  if constexpr (FULL && NS >= 2) {
#pragma unroll
    for (int k = 0; k < NS; k += NS < 4 ? NS : 4) {
      float u[NS < 4 ? NS : 4];
      load_cols<NS < 4 ? NS : 4>(row + s0 + k, u);
#pragma unroll
      for (int q = 0; q < (NS < 4 ? NS : 4); ++q) v[k + q] = u[q];
    }
  } else {
#pragma unroll
    for (int k = 0; k < NS; ++k) v[k] = s0 + k < ds ? row[s0 + k] : 0.f;
  }
}

// The kChunk steps of one staged chunk for one lane's NS states.
template <int L, int NS, bool FULL>
__device__ __forceinline__ void scan_chunk(const float* dts, const float* xs,
                                           const float* bs, const float* cs,
                                           float* ys, const float (&a)[NS],
                                           float (&h)[NS], int chl, int j,
                                           int ds) {
  const int s0 = j * NS;
#pragma unroll 4
  for (int tt = 0; tt < kChunk; ++tt) {
    const float d_t = dts[tt * kChannels + chl];
    const float dx = __fmul_rn(d_t, xs[tt * kChannels + chl]);
    float bv[NS], cv[NS];
    load_states<NS, FULL>(bs + tt * ds, s0, ds, bv);
    load_states<NS, FULL>(cs + tt * ds, s0, ds, cv);
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const float arg = __fmul_rn(d_t, a[k]);
      const float e = expf(arg);
      h[k] = __fadd_rn(__fmul_rn(e, h[k]), __fmul_rn(dx, bv[k]));
      part = __fadd_rn(part, __fmul_rn(h[k], cv[k]));
    }
    // every lane of the group gets the same sum (IEEE addition commutes)
#pragma unroll
    for (int off = 1; off < L; off <<= 1)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
    if (j == 0) ys[tt * kChannels + chl] = part;
  }
}

// shared floats of one block: two buffers of the dt, x, B and C chunks, and
// the y tile
__host__ __device__ constexpr int smem_floats(int ds) {
  return 2 * (2 * kChunk * kChannels + 2 * kChunk * ds) + kChunk * kChannels;
}

// L lanes a channel, NS states a lane (ds <= L * NS); codes: the dtype codes
// of dt, x, B, C in bits 0-3; modes: their staging modes, two bits each. At
// most 128 registers a thread: 16 / L blocks of 32 * L threads an SM.
template <int L, int NS>
__global__ void __launch_bounds__(kChannels * L, 16 / L)
selective_scan(const void* __restrict__ dt, const void* __restrict__ x,
               const void* __restrict__ Bm, const void* __restrict__ Cm,
               const float* __restrict__ A, void* __restrict__ y,
               const float* __restrict__ h0, float* __restrict__ hlast,
               int64_t S, int di, int ds, int codes, int modes) {
  extern __shared__ __align__(16) float smem[];
  constexpr int nthr = kChannels * L;
  const int tile = kChunk * kChannels, rows = kChunk * ds;
  float* dts = smem;                  // [2][kChunk][kChannels]
  float* xs = dts + 2 * tile;         // [2][kChunk][kChannels]
  float* bs = xs + 2 * tile;          // [2][kChunk * ds]
  float* cs = bs + 2 * rows;          // [2][kChunk * ds]
  float* ys = cs + 2 * rows;          // [kChunk][kChannels]

  const int chl = threadIdx.x / L, j = threadIdx.x % L;
  const int ch0 = blockIdx.x * kChannels, ch = ch0 + chl;
  const int64_t b = blockIdx.y;
  const int y_code = (codes >> 1) & 1;

  float h[NS], a[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int s = j * NS + k;
    const bool in = ch < di && s < ds;
    const float av = in ? A[(int64_t)ch * ds + s] : 0.f;
    h[k] = h0 != nullptr && in ? h0[(b * di + ch) * ds + s] : 0.f;
    a[k] = av;
  }

  auto stage = [&](int buf, int64_t t0) {
    const int64_t row0 = b * S + t0;
    stage_tile(dts + buf * tile, dt, codes & 1, modes & 3, row0, t0, S, di,
               ch0, nthr);
    stage_tile(xs + buf * tile, x, (codes >> 1) & 1, (modes >> 2) & 3, row0,
               t0, S, di, ch0, nthr);
    stage_rows(bs + buf * rows, Bm, (codes >> 2) & 1, (modes >> 4) & 3, row0,
               t0, S, ds, nthr);
    stage_rows(cs + buf * rows, Cm, (codes >> 3) & 1, (modes >> 6) & 3, row0,
               t0, S, ds, nthr);
    cp_commit();
  };

  const bool full = ds == L * NS;
  const int64_t chunks = (S + kChunk - 1) / kChunk;
  stage(0, 0);
  for (int64_t c = 0; c < chunks; ++c) {
    const int cur = (int)(c & 1);
    if (c + 1 < chunks) {
      stage(cur ^ 1, (c + 1) * kChunk);  // in flight while chunk c computes
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // chunk c staged by every thread
    // steps past S were staged as dt = 0, B = 0: h is unchanged and their
    // y is never stored
    if (full)
      scan_chunk<L, NS, true>(dts + cur * tile, xs + cur * tile,
                              bs + cur * rows, cs + cur * rows, ys, a, h, chl,
                              j, ds);
    else
      scan_chunk<L, NS, false>(dts + cur * tile, xs + cur * tile,
                               bs + cur * rows, cs + cur * rows, ys, a, h, chl,
                               j, ds);
    __syncthreads();  // the y tile is whole; buffer cur is free again
    for (int i = threadIdx.x; i < tile; i += nthr) {
      const int r = i / kChannels, cc = i % kChannels;
      const int64_t t = c * kChunk + r;
      if (t < S && ch0 + cc < di)
        store_f32(y, y_code, (b * S + t) * di + ch0 + cc, ys[i]);
    }
  }
  // the steps past S left h as it was: this is the state after step S - 1
  if (hlast != nullptr && ch < di) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int s = j * NS + k;
      if (s < ds) hlast[(b * di + ch) * ds + s] = h[k];
    }
  }
}

// lanes a channel at ds; states a lane are the rest, rounded up to a power
// of two (1, 2 or 4 at L = 2; 4 at every other L). Mirrored by
// kernels/mamba_scan.py::scan_lanes and scan_states.
int lanes_for(int ds) {
  return ds <= 8 ? 2 : ds <= 16 ? 4 : ds <= 32 ? 8 : 16;
}

int states_for(int ds) {
  const int per = (ds + lanes_for(ds) - 1) / lanes_for(ds);
  return per <= 1 ? 1 : per <= 2 ? 2 : 4;
}

template <int L, int NS>
int launch_scan(const void* dt, const void* x, const void* Bm, const void* Cm,
                const float* A, void* y, const float* h0, float* hlast,
                int B, int64_t S, int di, int ds, int codes, int modes,
                cudaStream_t st) {
  const size_t bytes = sizeof(float) * smem_floats(ds);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        selective_scan<L, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((di + kChannels - 1) / kChannels, B);
  selective_scan<L, NS><<<grid, kChannels * L, bytes, st>>>(
      dt, x, Bm, Cm, A, y, h0, hlast, S, di, ds, codes, modes);
  return (int)cudaGetLastError();
}

bool valid_code(int code) { return code == kF32 || code == kBF16; }

// cp.async of 16 bytes takes an f32 input whose base is 16-byte aligned and
// whose rows are whole 16 bytes; of 4 bytes any other f32 input
int stage_mode(const void* p, int code, int row) {
  if (code != kF32) return kStageConvert;
  return (uintptr_t)p % 16 == 0 && row % 4 == 0 ? kStage16 : kStage4;
}

}  // namespace
}  // namespace repro

using namespace repro;

extern "C" int repro_mamba_scan(const void* dt, int dt_code, const void* x,
                                int x_code, const void* Bm, int b_code,
                                const void* Cm, int c_code, const float* A,
                                void* y, const float* h0, float* hlast,
                                int B, int64_t S, int di, int ds,
                                void* stream) {
  if (B < 1 || B > 65535 || S < 1 || di < 1 || ds < 1 || ds > 64 ||
      !valid_code(dt_code) || !valid_code(x_code) || !valid_code(b_code) ||
      !valid_code(c_code))
    return (int)cudaErrorInvalidValue;
  const int codes = dt_code | x_code << 1 | b_code << 2 | c_code << 3;
  const int modes = stage_mode(dt, dt_code, di) |
                    stage_mode(x, x_code, di) << 2 |
                    stage_mode(Bm, b_code, ds) << 4 |
                    stage_mode(Cm, c_code, ds) << 6;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_SCAN(L, NS)                                                   \
  launch_scan<L, NS>(dt, x, Bm, Cm, A, y, h0, hlast, B, S, di, ds, codes, \
                     modes, st)
  switch (lanes_for(ds)) {
    case 2:
      switch (states_for(ds)) {
        case 1:
          return REPRO_SCAN(2, 1);
        case 2:
          return REPRO_SCAN(2, 2);
        default:
          return REPRO_SCAN(2, 4);
      }
    case 4:
      return REPRO_SCAN(4, 4);
    case 8:
      return REPRO_SCAN(8, 4);
    default:
      return REPRO_SCAN(16, 4);
  }
#undef REPRO_SCAN
}
