// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Every C entry point of this directory takes raw device pointers and the
// caller's CUDA stream, allocates nothing, launches on that stream and
// returns cudaGetLastError() as an int, which the Python wrapper raises on.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with the Python wrappers (kernels/_build.py)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's cast
}

// Element i of a buffer whose dtype is given by a runtime code, as f32; and
// the store back. For staging loops, where the branch is uniform.
__device__ __forceinline__ float load_f32(const void* p, int code,
                                          int64_t i) {
  return code == kBF16 ? __bfloat162float(((const __nv_bfloat16*)p)[i])
                       : ((const float*)p)[i];
}
__device__ __forceinline__ void store_f32(void* p, int code, int64_t i,
                                          float v) {
  if (code == kBF16)
    ((__nv_bfloat16*)p)[i] = __float2bfloat16_rn(v);
  else
    ((float*)p)[i] = v;
}

// Blocks for a grid-stride loop over n elements: one thread per element up
// to a cap, so the launch shape depends on n alone (never on the device).
inline int grid_for(int64_t n, int cap = 4096) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < cap ? b : cap);
}

// Fixed-order tree sum of one value per thread into smem[0]: the same
// launch shape adds in the same order on every run (no atomics).
__device__ __forceinline__ float block_sum(float v, float* smem) {
  smem[threadIdx.x] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) smem[threadIdx.x] += smem[threadIdx.x + w];
    __syncthreads();
  }
  return smem[0];
}

}  // namespace repro
