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
//   Design: the TPU kernel fed [K, b] tiles to the matrix unit; here K is
//   8 on the main path, far below any tensor-core tile, so each thread owns
//   C neighbouring columns and forms their K outputs by an FMA loop over P.
//   For K <= 32 the register kernel is instantiated for a bucket KB in
//   {8, 16, 32} with K <= KB, picked on the host, so the thread's column
//   x[:KB][C] in registers and the unrolled loops cost what K needs (at
//   the main path's K = 8 a thread holds 8 x C floats, not 32). C is picked
//   on the host from D and the alignment of x and out, with KB x C <= 32
//   floats of column (bf16 pairs at KB = 32 spilled in ptxas): 4 (16-byte
//   f32 and 8-byte bf16 accesses) at KB = 8 when D % 4 == 0 and both are
//   aligned to 4 elements; else 2 at KB <= 16 when D is even and both are
//   aligned to 2; else 1 (KB = 32, a view one element off, odd D). The main
//   path's D = 199,210 is 2 mod 4: C = 2. P and w2 sit in shared memory,
//   read as a broadcast; x and out each cross device memory once,
//   neighbouring threads on neighbouring addresses. Each output is one
//   fmaf chain over k = 0..K-1 from 0, then __fdiv_rn by w2[i] when
//   de-biasing, in every bucket and at every C, so the bits do not depend
//   on the launch shape. Above K = 32 (BENCH_9 ran up to 256) the column
//   has no room in registers nor P in shared memory: the streaming kernel
//   re-reads x[:, j] per output row through the cache and P through __ldg.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kRegK = 32;  // the largest K bucket of the register kernel

// K <= KB; each thread owns columns j .. j + C - 1 of a grid-stride loop
template <typename T, int KB, int C>
__global__ void __launch_bounds__(kThreads)
mix_reg(const T* __restrict__ x, const float* __restrict__ P,
        const float* __restrict__ w2, T* __restrict__ out, int K, int64_t D,
        int debias) {
  __shared__ float sP[KB * KB];
  __shared__ float sW[KB];
  for (int e = threadIdx.x; e < K * K; e += blockDim.x) sP[e] = P[e];
  for (int e = threadIdx.x; e < K; e += blockDim.x) sW[e] = w2[e];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * C;
  for (int64_t j = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * C;
       j < D; j += stride) {
    float xs[KB][C];
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (k < K) {
        load_cols<C>(x + k * D + j, xs[k]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) xs[k][c] = 0.f;
      }
    }
    for (int i = 0; i < K; ++i) {
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k < K) {
          const float p = sP[i * K + k];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = fmaf(p, xs[k][c], acc[c]);
        }
      }
      if (debias) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = __fdiv_rn(acc[c], sW[i]);
      }
      store_cols<C>(out + i * D + j, acc);
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

template <typename T, int KB, int C>
void launch_reg(const void* x, const float* P, const float* w2, void* out,
                int K, int64_t D, int debias, cudaStream_t st) {
  mix_reg<T, KB, C><<<grid_for((D + C - 1) / C), kThreads, 0, st>>>(
      (const T*)x, P, w2, (T*)out, K, D, debias);
}

template <typename T, int KB>
void launch_bucket(const void* x, const float* P, const float* w2, void* out,
                   int K, int64_t D, int debias, cudaStream_t st) {
  // C columns a thread need every row start (k * D) and both bases aligned
  // to C elements; the column x[:KB][C] holds at most 32 floats
  constexpr int kMaxC = 32 / KB;
  const auto fits = [&](int c) {
    const uintptr_t a = c * sizeof(T);
    return D % c == 0 && (uintptr_t)x % a == 0 && (uintptr_t)out % a == 0;
  };
  if constexpr (kMaxC >= 4) {
    if (fits(4)) return launch_reg<T, KB, 4>(x, P, w2, out, K, D, debias, st);
  }
  if constexpr (kMaxC >= 2) {
    if (fits(2)) return launch_reg<T, KB, 2>(x, P, w2, out, K, D, debias, st);
  }
  launch_reg<T, KB, 1>(x, P, w2, out, K, D, debias, st);
}

template <typename T>
cudaError_t launch_mix(const void* x, const float* P, const float* w2,
                       void* out, int K, int64_t D, int debias,
                       cudaStream_t st) {
  if (K <= 8)
    launch_bucket<T, 8>(x, P, w2, out, K, D, debias, st);
  else if (K <= 16)
    launch_bucket<T, 16>(x, P, w2, out, K, D, debias, st);
  else if (K <= kRegK)
    launch_bucket<T, kRegK>(x, P, w2, out, K, D, debias, st);
  else
    mix_stream<T><<<grid_for(D), kThreads, 0, st>>>((const T*)x, P, w2,
                                                    (T*)out, K, D, debias);
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
