// Synchronous PushSum exchange over the stacked [K, D] proxies (Algorithm 1
// lines 7-11).
//
// repro_pushsum_mix replaces src/repro/kernels/pushsum_mix.py::
// fused_pushsum_mix (_mix_kernel):
//   out[i, :] = sum_k P[i, k] * x[k, :]            (f32 accumulation)
//   out[i, :] /= w2[i]                              (when debias is set)
// with x f32 or bf16 and out in x's dtype. w2 = P.w is O(K) and is formed
// by the caller, as the reference forms it outside its kernel.
//   Bound: 2*K*4*D bytes (x read once, out written once, f32); 12.7 MB at
//   the main path's K = 8, D = 199,210. 2*K*K*D operations are far below
//   the card's rate, so bytes bound it.
//   Design: one thread per column j. The TPU kernel fed [K, b] tiles to the
//   matrix unit; here K is 4 to 8 on the main path, far below any tensor-core
//   tile, so each thread forms its K outputs by an FMA loop over P. For
//   K <= 32 the thread keeps its K inputs x[:, j] in registers and P sits in
//   shared memory, read back as a broadcast; each input and output element
//   then crosses device memory exactly once, and neighbouring threads touch
//   neighbouring addresses. Larger K (BENCH_9 ran up to 256) has no room for
//   the column in registers or for P in shared memory: that path re-reads
//   x[:, j] per output row through the cache and P through __ldg.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kRegK = 32;

template <typename T>
__global__ void mix_reg(const T* __restrict__ x, const float* __restrict__ P,
                        const float* __restrict__ w2, T* __restrict__ out,
                        int K, int64_t D, int debias) {
  __shared__ float sP[kRegK * kRegK];
  __shared__ float sW[kRegK];
  for (int e = threadIdx.x; e < K * K; e += blockDim.x) sP[e] = P[e];
  for (int e = threadIdx.x; e < K; e += blockDim.x) sW[e] = w2[e];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < D;
       j += stride) {
    float xs[kRegK];
#pragma unroll
    for (int k = 0; k < kRegK; ++k) xs[k] = k < K ? to_f32(x[k * D + j]) : 0.f;
    for (int i = 0; i < K; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kRegK; ++k) {
        if (k < K) acc = fmaf(sP[i * K + k], xs[k], acc);
      }
      if (debias) acc = __fdiv_rn(acc, sW[i]);
      out[i * D + j] = from_f32<T>(acc);
    }
  }
}

template <typename T>
__global__ void mix_stream(const T* __restrict__ x,
                           const float* __restrict__ P,
                           const float* __restrict__ w2, T* __restrict__ out,
                           int K, int64_t D, int debias) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < D;
       j += stride) {
    for (int i = 0; i < K; ++i) {
      float acc = 0.f;
      for (int k = 0; k < K; ++k)
        acc = fmaf(__ldg(P + (int64_t)i * K + k), to_f32(x[k * D + j]), acc);
      if (debias) acc = __fdiv_rn(acc, __ldg(w2 + i));
      out[i * D + j] = from_f32<T>(acc);
    }
  }
}

template <typename T>
cudaError_t launch_mix(const void* x, const float* P, const float* w2,
                       void* out, int K, int64_t D, int debias,
                       cudaStream_t st) {
  const int blocks = grid_for(D);
  if (K <= kRegK) {
    mix_reg<T><<<blocks, kThreads, 0, st>>>((const T*)x, P, w2, (T*)out, K,
                                            D, debias);
  } else {
    mix_stream<T><<<blocks, kThreads, 0, st>>>((const T*)x, P, w2, (T*)out,
                                               K, D, debias);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

using namespace repro;

extern "C" int repro_pushsum_mix(const void* x, int dtype, const float* P,
                                 const float* w2, void* out, int K,
                                 int64_t D, int debias, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return (int)launch_mix<float>(x, P, w2, out, K, D, debias, st);
  if (dtype == kBF16)
    return (int)launch_mix<__nv_bfloat16>(x, P, w2, out, K, D, debias, st);
  return (int)cudaErrorInvalidValue;
}
