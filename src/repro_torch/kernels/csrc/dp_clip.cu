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
//
// repro_scale_accumulate replaces src/repro/kernels/dp_clip.py::
// scale_accumulate (_scale_acc_kernel):
//   out = acc + g * scale, acc f32, g f32 or bf16, scale an f32 scalar.
//   Bound: 12*D bytes (acc and g read, out written; f32).
//   Design: one grid-stride elementwise pass. The scale is a device pointer
//   read in the kernel, because the caller computes it on the device from
//   the norm (no host sync per example). The multiply and the add are
//   rounded separately (no FMA contraction), as the plain torch version is.
#include "common.cuh"

namespace repro {
namespace {

template <typename T>
__global__ void sumsq_partials(const T* __restrict__ x, int64_t n,
                               float* __restrict__ partials) {
  __shared__ float smem[kThreads];
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

__global__ void sum_partials(const float* __restrict__ partials, int n,
                             float* __restrict__ out) {
  __shared__ float smem[kThreads];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) s = __fadd_rn(s, partials[i]);
  const float total = block_sum(s, smem);
  if (threadIdx.x == 0) out[0] = total;
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

}  // namespace
}  // namespace repro

using namespace repro;

// n_partials blocks write partials[0..n_partials); the caller sizes both.
extern "C" int repro_sumsq(const void* x, int dtype, int64_t n,
                           float* partials, int n_partials, float* out,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 1 || n_partials < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kF32) {
    sumsq_partials<float><<<n_partials, kThreads, 0, st>>>(
        (const float*)x, n, partials);
  } else if (dtype == kBF16) {
    sumsq_partials<__nv_bfloat16><<<n_partials, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, n, partials);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<1, kThreads, 0, st>>>(partials, n_partials, out);
  return (int)cudaGetLastError();
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
