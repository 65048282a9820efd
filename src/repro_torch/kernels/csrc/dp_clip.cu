// DP-SGD per-example clip-and-accumulate (paper Eq. 7 inner loop).
//
// repro_sumsq replaces src/repro/kernels/dp_clip.py::sumsq (_sumsq_kernel):
//   sum of x*x over a 1-D f32 or bf16 vector, accumulated in f32.
//   Bound: the 4*D bytes (f32) it reads; at the main path's D = 199,210 that
//   is 0.8 MB, so a call is limited by launch cost, not by bandwidth.
//   Design: the TPU kernel ran its grid in order and summed the per-block
//   partials after it. Here the blocks run in parallel, so the sum takes two
//   passes: sumsq_partials writes one fixed-order tree sum per block, then a
//   single block adds the partials in index order. The launch shape depends
//   on D alone and no float atomics are used, so the result is the same on
//   every run: it feeds the DP clip scale.
//   The rows route (repro_sumsq_rows) runs the same two kernels on a 2-D
//   grid: blockIdx.y picks a row of a [B, D] matrix with row stride ld, so
//   each row keeps the 1-D call's partition and tree and its sum is
//   bit-equal to repro_sumsq on that row. At the main path's B = 250,
//   D = 199,210 that is 195 x 250 CTAs of 4 elements a thread, then 250
//   blocks of sum_partials; bound 199.2 MB read, 59.5 us at 3.35 TB/s.
//
// repro_scale_accumulate replaces src/repro/kernels/dp_clip.py::
// scale_accumulate (_scale_acc_kernel):
//   out = acc + g * scale, acc f32, g f32 or bf16, scale an f32 scalar.
//   Bound: 12*D bytes (acc and g read, out written; f32).
//   Design: one grid-stride elementwise pass. The scale is a device pointer
//   read in the kernel, because the caller computes it on the device from
//   the norm (no host sync per example). The multiply and the add are
//   rounded separately (no FMA contraction), as the plain torch version is.
//
// repro_clip_accumulate_rows is scale_accumulate's rows route: the scan of
// src/repro/core/dp.py:215-227 over a [B, D] matrix of per-example
// gradients in one launch, out[j] = (((0 + g0j*s0) + g1j*s1) + ...) in row
// order, each step rounded as scale_acc rounds it, so out is bit-equal to B
// chained repro_scale_accumulate calls from a zero accumulator.
//   Bound: B*D*4 bytes read (f32) + 4*D written: 59.7 us at B = 250,
//   D = 199,210. The matrix is four times the 50 MB L2, so it streams from
//   device memory.
//   Design: the sum runs down each column in row order, so the parallelism
//   is the D columns: one thread a column (a warp reads 128 contiguous
//   bytes of a row), 256 threads a CTA, 779 CTAs at the main shape. What
//   bounds such a stream is the bytes in flight, so each thread starts 32
//   rows' loads before it adds them in order; the rows past the last whole
//   group of 32 go one at a time (masking that group instead ran slower on
//   the card). The loads are streaming (evict first); the scales are read
//   through the read-only cache, one broadcast a row. The caller pads the
//   row stride to 128 bytes so that each warp's load of a row is one cache
//   line. A ring of 1-D bulk copies (cp.async.bulk into shared memory,
//   completing on mbarriers; 512 columns a CTA, 4 stages of 4 rows) was
//   this kernel's first design; it moved under half the bytes a second
//   that these loads move (PERF.md).
//   The client-grid route (repro_clip_accumulate_rows_clients) is the same
//   kernel on a 2-D grid: blockIdx.y picks client k of a [K, B, D] stack
//   (client stride ldk) and its [B] scales, and writes row k of a [K, D]
//   output, so each row is bit-equal to the flat call on that client's
//   matrix. It is the counterpart of jax.vmap over the reference's
//   pallas_call, which adds a grid axis: the stacked executor's one launch a
//   local step for the whole cohort. Bound: K*B*D*4 bytes read + 4*K*D
//   written; 478 us at the main round's K = 8, B = 250, D = 199,210.
#include "common.cuh"

namespace repro {
namespace {

// Row blockIdx.y of x (row stride ld) writes its gridDim.x partials to
// partials[row * gridDim.x ...]; the 1-D call is the grid (n_partials, 1).
template <typename T>
__global__ void sumsq_partials(const T* __restrict__ x, int64_t n, int64_t ld,
                               float* __restrict__ partials) {
  __shared__ float smem[kThreads];
  x += blockIdx.y * ld;
  partials += (int64_t)blockIdx.y * gridDim.x;
  float s = 0.f;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float v = to_f32(x[i]);
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
  const float total = block_sum(s, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// Block b adds partials[b * n ...] in index order into out[b].
__global__ void sum_partials(const float* __restrict__ partials, int n,
                             float* __restrict__ out) {
  __shared__ float smem[kThreads];
  partials += (int64_t)blockIdx.x * n;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) s = __fadd_rn(s, partials[i]);
  const float total = block_sum(s, smem);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

template <typename T>
__global__ void scale_acc(const float* __restrict__ acc,
                          const T* __restrict__ g,
                          const float* __restrict__ scale,
                          float* __restrict__ out, int64_t n) {
  const float s = *scale;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    out[i] = __fadd_rn(acc[i], __fmul_rn(to_f32(g[i]), s));
  }
}

constexpr int kRowThreads = 256;
constexpr int kRowsInFlight = 32;   // loads a thread keeps in flight

// One element of g, read once: a streaming load (evict first).
__device__ __forceinline__ float load_once(const float* p) {
  return __ldcs(p);
}
__device__ __forceinline__ float load_once(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}

// Thread j owns column j and walks the rows in order: whole groups of
// kRowsInFlight rows loaded before they are added in turn, then the rows
// left over one at a time. blockIdx.y is the client of a [K, B, D] stack
// (client stride ldk; 0 and a grid of one row for the flat call).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
clip_acc_rows(const T* __restrict__ g, int B, int64_t D, int64_t ld,
              int64_t ldk, const float* __restrict__ scales,
              float* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * kRowThreads + threadIdx.x;
  if (j >= D) return;
  g += (int64_t)blockIdx.y * ldk;
  scales += (int64_t)blockIdx.y * B;
  out += (int64_t)blockIdx.y * D;
  const T* col = g + j;
  float acc = 0.f;
  int i = 0;
  for (; i + kRowsInFlight <= B; i += kRowsInFlight) {
    float v[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u)
      v[u] = load_once(col + (int64_t)(i + u) * ld);
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u)
      acc = __fadd_rn(acc, __fmul_rn(v[u], __ldg(scales + i + u)));
  }
  for (; i < B; ++i)
    acc = __fadd_rn(acc, __fmul_rn(load_once(col + (int64_t)i * ld),
                                   __ldg(scales + i)));
  out[j] = acc;
}

}  // namespace
}  // namespace repro

using namespace repro;

// Row i of the [B, n] matrix x (row stride ld elements) into out[i]:
// n_partials blocks a row write partials[i * n_partials ...], then one block
// a row sums them. The caller sizes partials ([B, n_partials]) and out [B].
extern "C" int repro_sumsq_rows(const void* x, int dtype, int B, int64_t n,
                                int64_t ld, float* partials, int n_partials,
                                float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || B > 65535 || n < 1 || ld < n || n_partials < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_partials, B);
  if (dtype == kF32) {
    sumsq_partials<float><<<grid, kThreads, 0, st>>>(
        (const float*)x, n, ld, partials);
  } else if (dtype == kBF16) {
    sumsq_partials<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, n, ld, partials);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<B, kThreads, 0, st>>>(partials, n_partials, out);
  return (int)cudaGetLastError();
}

// The 1-D call: one row. n_partials blocks write partials[0..n_partials);
// the caller sizes both.
extern "C" int repro_sumsq(const void* x, int dtype, int64_t n,
                           float* partials, int n_partials, float* out,
                           void* stream) {
  return repro_sumsq_rows(x, dtype, 1, n, n, partials, n_partials, out,
                          stream);
}

extern "C" int repro_scale_accumulate(const float* acc, const void* g,
                                      int g_dtype, const float* scale,
                                      float* out, int64_t n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = grid_for(n);
  if (g_dtype == kF32) {
    scale_acc<float><<<blocks, kThreads, 0, st>>>(
        acc, (const float*)g, scale, out, n);
  } else if (g_dtype == kBF16) {
    scale_acc<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        acc, (const __nv_bfloat16*)g, scale, out, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Row k of out [K, n] = sum over rows i in order of g[k, i, :] * scales[k,
// i], from 0; g is [K, B, n] with row stride ld and client stride ldk
// elements, scales [K, B] contiguous.
extern "C" int repro_clip_accumulate_rows_clients(
    const void* g, int g_dtype, int K, int B, int64_t n, int64_t ld,
    int64_t ldk, const float* scales, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t blocks = (n + kRowThreads - 1) / kRowThreads;
  if (K < 1 || K > 65535 || B < 1 || n < 1 || ld < n ||
      blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, K);
  if (g_dtype == kF32) {
    clip_acc_rows<float><<<grid, kRowThreads, 0, st>>>(
        (const float*)g, B, n, ld, ldk, scales, out);
  } else if (g_dtype == kBF16) {
    clip_acc_rows<__nv_bfloat16><<<grid, kRowThreads, 0, st>>>(
        (const __nv_bfloat16*)g, B, n, ld, ldk, scales, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out[j] = sum over rows i in order of g[i, j] * scales[i], from 0; g is
// [B, n] with row stride ld elements: one client.
extern "C" int repro_clip_accumulate_rows(const void* g, int g_dtype, int B,
                                          int64_t n, int64_t ld,
                                          const float* scales, float* out,
                                          void* stream) {
  return repro_clip_accumulate_rows_clients(g, g_dtype, 1, B, n, ld, 0,
                                            scales, out, stream);
}
