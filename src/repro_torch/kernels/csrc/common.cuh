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

// C neighbouring values of a row as f32, and the store back, in one access
// of C elements (C = 1, 2 or 4: f32 4, 8 or 16 bytes, bf16 2, 4 or 8); the
// address must be aligned to C elements.
template <int C>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[C]) {
  if constexpr (C == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else if constexpr (C == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x;
    v[1] = u.y;
  } else {
    v[0] = *p;
  }
}
// four bf16 values as one 8-byte access
struct alignas(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

template <int C>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&v)[C]) {
  if constexpr (C == 4) {
    const Bf16x4 u = *reinterpret_cast<const Bf16x4*>(p);
    v[0] = __low2float(u.lo);
    v[1] = __high2float(u.lo);
    v[2] = __low2float(u.hi);
    v[3] = __high2float(u.hi);
  } else if constexpr (C == 2) {
    const __nv_bfloat162 u = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = __low2float(u);
    v[1] = __high2float(u);
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[C]) {
  if constexpr (C == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (C == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}
template <int C>
__device__ __forceinline__ void store_cols(__nv_bfloat16* p,
                                           const float (&v)[C]) {
  // round to nearest even, as torch's cast
  if constexpr (C == 4)
    *reinterpret_cast<Bf16x4*>(p) = {__floats2bfloat162_rn(v[0], v[1]),
                                     __floats2bfloat162_rn(v[2], v[3])};
  else if constexpr (C == 2)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  else
    *p = __float2bfloat16_rn(v[0]);
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
