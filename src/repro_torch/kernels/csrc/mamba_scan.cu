// Mamba-1 selective scan (the recurrence; the D*x skip and the gate are the
// caller's).
//
// repro_mamba_scan replaces src/repro/kernels/mamba_scan.py::mamba_scan
// (_scan_kernel):
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) B_t,   y_t = C_t . h_t
// per batch row and channel, over dt, x [B, S, di], B, C [B, S, ds] (each
// f32 or bf16) and A [di, ds] f32, with the state h [ds] in f32 from zero;
// y [B, S, di] in x's dtype.
//   Bound: the bytes of dt, x and y (and the small B, C, A) over 3.35 TB/s;
//   403 MB for falcon-mamba-7b's di = 8,192, ds = 16 at S = 4,096 f32,
//   about 120 us. Each state step is one exp and five flops.
//   Design: the TPU kernel ran its grid (B, di blocks, chunks) with the chunk
//   axis in order, carrying a [block_d, ds] state tile in VMEM. Here one
//   thread owns one (batch row, channel), keeps its ds states and its row of
//   A in registers, and steps through S in order itself, so nothing is
//   carried between blocks. A block of 64 channels stages a chunk of 32
//   steps at a time in shared memory: dt and x read coalesced along di (the
//   contiguous axis; a chunk's loads are unrolled, so all are in flight at
//   once), and the chunk's B_t and C_t rows, which every channel of the
//   block reads (broadcast from shared memory). y is written
//   coalesced along di. exp is expf (no fast math: 4,096 steps accumulate
//   rounding), and each product and sum is rounded on its own in the
//   reference's order. Parallelism is B * di threads: at B = 1, di = 8,192
//   that is 128 blocks of two warps on 132 SMs, each a chain of S dependent
//   steps, so the kernel is bound by that chain's latency, not by memory; a
//   chunked parallel scan would lift it.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kScanThreads = 64;  // channels of a block
constexpr int kChunk = 32;        // steps staged at a time

// One chunk of one channel's dt or x into shared memory (zero past S), the
// loads unrolled so all of them are in flight at once.
template <typename T>
__device__ __forceinline__ void stage_column(float (*dst)[kScanThreads],
                                             const void* src, int64_t off,
                                             int di, int steps, bool live) {
  const T* p = (const T*)src + off;
#pragma unroll
  for (int tt = 0; tt < kChunk; ++tt)
    dst[tt][threadIdx.x] =
        live && tt < steps ? to_f32(p[(int64_t)tt * di]) : 0.f;
}

// DS: the register size of the state (ds <= DS)
template <int DS>
__global__ void __launch_bounds__(kScanThreads)
selective_scan(const void* __restrict__ dt, int dt_code,
               const void* __restrict__ x, int x_code,
               const void* __restrict__ Bm, int b_code,
               const void* __restrict__ Cm, int c_code,
               const float* __restrict__ A, void* __restrict__ y, int64_t S,
               int di, int ds) {
  __shared__ float dts[kChunk][kScanThreads];
  __shared__ float xs[kChunk][kScanThreads];
  __shared__ float bs[kChunk][DS];
  __shared__ float cs[kChunk][DS];

  const int tid = threadIdx.x;
  const int ch = blockIdx.x * kScanThreads + tid;
  const int64_t b = blockIdx.y;
  const bool live = ch < di;

  float h[DS], a_row[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    h[s] = 0.f;
    a_row[s] = live && s < ds ? A[(int64_t)ch * ds + s] : 0.f;
  }

  for (int64_t t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = (int)(S - t0 < kChunk ? S - t0 : kChunk);
    const int64_t off = (b * S + t0) * di + ch;
    __syncthreads();  // the last chunk is consumed
    if (dt_code == kBF16)
      stage_column<__nv_bfloat16>(dts, dt, off, di, steps, live);
    else
      stage_column<float>(dts, dt, off, di, steps, live);
    if (x_code == kBF16)
      stage_column<__nv_bfloat16>(xs, x, off, di, steps, live);
    else
      stage_column<float>(xs, x, off, di, steps, live);
    for (int idx = tid; idx < kChunk * ds; idx += kScanThreads) {
      const int tt = idx / ds, s = idx - tt * ds;
      const bool in = t0 + tt < S;
      const int64_t bc = (b * S + t0 + tt) * ds + s;
      bs[tt][s] = in ? load_f32(Bm, b_code, bc) : 0.f;
      cs[tt][s] = in ? load_f32(Cm, c_code, bc) : 0.f;
    }
    __syncthreads();

    for (int tt = 0; tt < steps; ++tt) {
      const float d_t = dts[tt][tid];
      const float dx = __fmul_rn(d_t, xs[tt][tid]);
      float yt = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        if (s < ds) {
          const float a = expf(__fmul_rn(d_t, a_row[s]));
          h[s] = __fadd_rn(__fmul_rn(a, h[s]), __fmul_rn(dx, bs[tt][s]));
          yt = __fadd_rn(yt, __fmul_rn(h[s], cs[tt][s]));
        }
      }
      if (live) store_f32(y, x_code, (b * S + t0 + tt) * di + ch, yt);
    }
  }
}

template <int DS>
int launch_scan(const void* dt, int dt_code, const void* x, int x_code,
                const void* Bm, int b_code, const void* Cm, int c_code,
                const float* A, void* y, int B, int64_t S, int di, int ds,
                cudaStream_t st) {
  const dim3 grid((di + kScanThreads - 1) / kScanThreads, B);
  selective_scan<DS><<<grid, kScanThreads, 0, st>>>(
      dt, dt_code, x, x_code, Bm, b_code, Cm, c_code, A, y, S, di, ds);
  return (int)cudaGetLastError();
}

bool valid_code(int code) { return code == kF32 || code == kBF16; }

}  // namespace
}  // namespace repro

using namespace repro;

extern "C" int repro_mamba_scan(const void* dt, int dt_code, const void* x,
                                int x_code, const void* Bm, int b_code,
                                const void* Cm, int c_code, const float* A,
                                void* y, int B, int64_t S, int di, int ds,
                                void* stream) {
  if (B < 1 || B > 65535 || S < 1 || di < 1 || ds < 1 || ds > 64 ||
      !valid_code(dt_code) || !valid_code(x_code) || !valid_code(b_code) ||
      !valid_code(c_code))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (ds <= 8)
    return launch_scan<8>(dt, dt_code, x, x_code, Bm, b_code, Cm, c_code, A,
                          y, B, S, di, ds, st);
  if (ds <= 16)
    return launch_scan<16>(dt, dt_code, x, x_code, Bm, b_code, Cm, c_code,
                           A, y, B, S, di, ds, st);
  if (ds <= 32)
    return launch_scan<32>(dt, dt_code, x, x_code, Bm, b_code, Cm, c_code,
                           A, y, B, S, di, ds, st);
  return launch_scan<64>(dt, dt_code, x, x_code, Bm, b_code, Cm, c_code, A,
                         y, B, S, di, ds, st);
}
