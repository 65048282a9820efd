// Fused RMSNorm over the last axis.
//
// repro_rmsnorm replaces src/repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel):
//   out = x * rsqrt(mean(x*x) + eps) * g, computed in f32 and cast to x's
//   dtype at the end (the gain is applied before the cast), over rows of a
//   [rows, d] x (f32 or bf16) with g [d] (f32 or bf16).
//   Bound: the bytes, 2*rows*d*sizeof(x) + d*sizeof(g); 58.7 MB for
//   qwen2-7b's d = 3,584 over 4,096 bf16 rows, 17.5 us at 3.35 TB/s.
//   Design: the TPU kernel tiled 256 rows by the whole d in VMEM; here one
//   256-thread block takes one row, so a row's reduction stays inside one
//   block: each thread sums the squares of its strided elements, then a
//   fixed-order tree sum (no atomics, the same result on every run) gives
//   the mean; the second pass re-reads the row (from L1/L2: a row is at
//   most a few tens of KB) and writes it normalised. The mean, the rsqrt
//   and the two products are rounded on their own, in the reference's
//   order (x*r first, then *g).
#include "common.cuh"

namespace repro {
namespace {

template <typename T>
__global__ void rmsnorm_rows(const T* __restrict__ x,
                             const void* __restrict__ g, int g_code,
                             T* __restrict__ out, int d, float eps) {
  __shared__ float smem[kThreads];
  const T* xr = x + (int64_t)blockIdx.x * d;
  T* orow = out + (int64_t)blockIdx.x * d;
  float s = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float v = to_f32(xr[c]);
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
  const float var = __fdiv_rn(block_sum(s, smem), (float)d);
  const float r = __frsqrt_rn(__fadd_rn(var, eps));
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float y = __fmul_rn(to_f32(xr[c]), r);
    orow[c] = from_f32<T>(__fmul_rn(y, load_f32(g, g_code, c)));
  }
}

}  // namespace
}  // namespace repro

using namespace repro;

extern "C" int repro_rmsnorm(const void* x, int x_code, const void* g,
                             int g_code, void* out, int64_t rows, int d,
                             float eps, void* stream) {
  if (rows < 1 || rows > 0x7fffffff || d < 1 ||
      (g_code != kF32 && g_code != kBF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_code == kF32)
    rmsnorm_rows<float><<<(unsigned)rows, kThreads, 0, st>>>(
        (const float*)x, g, g_code, (float*)out, d, eps);
  else if (x_code == kBF16)
    rmsnorm_rows<__nv_bfloat16><<<(unsigned)rows, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, g, g_code, (__nv_bfloat16*)out, d, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
