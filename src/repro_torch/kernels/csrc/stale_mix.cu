// Stale (async, staleness tau > 0) PushSum exchange over the stacked [K, D]
// proxies: the delayed-delivery counterpart of pushsum_mix.cu.
//
// repro_stale_mix replaces src/repro/kernels/pushsum_mix.py::
// fused_stale_mix (_stale_kernel):
//   theta[k, :] = x[k, :] * w[k]                            (re-bias, f32)
//   send[i, :]  = sum_k sent[i, k] * theta[k, :]            (f32 accumulation)
//   z[i, :]     = (kept[i] * theta[i, :] + buf[i, :]) / w2[i]
// with x and buf f32 or bf16 and both outputs in x's dtype. w2 = kept*w +
// buf_w and send_w = sent.w are O(K) and formed by the caller, as the
// reference forms them outside its kernel.
//   Bound: 4*K*4*D bytes (x and buf read once, z and send written once,
//   f32); 25.5 MB at the main path's K = 8, D = 199,210. 2*K*K*D + 4*K*D
//   operations are far below the card's rate, so bytes bound it.
//   Design: the TPU kernel fed [K, b] tiles to the matrix unit; here K is 8
//   on the main path, far below any tensor-core tile, so each thread owns
//   C neighbouring columns (C = 2 when D is even and the rows are 8-byte
//   aligned in f32, 4-byte in bf16, else 1) and streams them. For K <= 32
//   the register kernel is instantiated for a bucket KB in {8, 16, 32}
//   with K <= KB, picked on the host, so its column theta[KB][C] and the
//   unrolled loops cost what K needs: at the main path's K = 8 a thread
//   holds 16 floats of theta instead of 32, and enough warps fit on an SM
//   to keep device memory busy. The thread forms theta once into registers
//   while it writes z (row k of z needs theta[k, :] alone), then the K sends
//   by an FMA loop over sent in shared memory, read as a broadcast and used
//   for C columns; x, buf, z and send each cross device memory once,
//   neighbouring threads on neighbouring addresses, with C-wide loads and
//   stores. The re-bias, merge and de-bias use explicitly rounded
//   intrinsics (no FMA contraction), so z repeats the plain version's
//   arithmetic exactly and only the order of the sent.theta sum differs.
//   Above K = 32 the column has no room in registers nor sent in shared
//   memory: the streaming kernel re-reads x[:, j] and w through the cache
//   for each send row.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kRegK = 32;  // the largest K bucket of the register kernel

// K <= KB; each thread owns columns j .. j + C - 1 of a grid-stride loop
template <typename T, int KB, int C>
__global__ void __launch_bounds__(kThreads)
stale_reg(const T* __restrict__ x, const T* __restrict__ buf,
          const float* __restrict__ w, const float* __restrict__ kept,
          const float* __restrict__ sent, const float* __restrict__ w2,
          T* __restrict__ z, T* __restrict__ send, int K, int64_t D) {
  __shared__ float sS[KB * KB];
  __shared__ float sW[KB];
  __shared__ float sKept[KB];
  __shared__ float sW2[KB];
  for (int e = threadIdx.x; e < K * K; e += blockDim.x) sS[e] = sent[e];
  for (int e = threadIdx.x; e < K; e += blockDim.x) {
    sW[e] = w[e];
    sKept[e] = kept[e];
    sW2[e] = w2[e];
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * C;
  for (int64_t j = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * C;
       j < D; j += stride) {
    float th[KB][C];
#pragma unroll
    for (int k = 0; k < KB; ++k) {
#pragma unroll
      for (int c = 0; c < C; ++c) th[k][c] = 0.f;
      if (k < K) {
        float xv[C], bv[C], zv[C];
        load_cols<C>(x + k * D + j, xv);
        load_cols<C>(buf + k * D + j, bv);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          th[k][c] = __fmul_rn(xv[c], sW[k]);
          const float merged = __fadd_rn(__fmul_rn(sKept[k], th[k][c]), bv[c]);
          zv[c] = __fdiv_rn(merged, sW2[k]);
        }
        store_cols<C>(z + k * D + j, zv);
      }
    }
    for (int i = 0; i < K; ++i) {
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k < K) {
          const float s = sS[i * K + k];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = fmaf(s, th[k][c], acc[c]);
        }
      }
      store_cols<C>(send + i * D + j, acc);
    }
  }
}

template <typename T>
__global__ void stale_stream(const T* __restrict__ x,
                             const T* __restrict__ buf,
                             const float* __restrict__ w,
                             const float* __restrict__ kept,
                             const float* __restrict__ sent,
                             const float* __restrict__ w2,
                             T* __restrict__ z, T* __restrict__ send, int K,
                             int64_t D) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < D;
       j += stride) {
    for (int k = 0; k < K; ++k) {
      const int64_t e = k * D + j;
      const float th = __fmul_rn(to_f32(x[e]), __ldg(w + k));
      const float merged =
          __fadd_rn(__fmul_rn(__ldg(kept + k), th), to_f32(buf[e]));
      z[e] = from_f32<T>(__fdiv_rn(merged, __ldg(w2 + k)));
    }
    for (int i = 0; i < K; ++i) {
      float acc = 0.f;
      for (int k = 0; k < K; ++k) {
        const float th = __fmul_rn(to_f32(x[k * D + j]), __ldg(w + k));
        acc = fmaf(__ldg(sent + (int64_t)i * K + k), th, acc);
      }
      send[i * D + j] = from_f32<T>(acc);
    }
  }
}

template <typename T, int KB, int C>
void launch_reg(const void* x, const void* buf, const float* w,
                const float* kept, const float* sent, const float* w2,
                void* z, void* send, int K, int64_t D, cudaStream_t st) {
  stale_reg<T, KB, C><<<grid_for((D + C - 1) / C), kThreads, 0, st>>>(
      (const T*)x, (const T*)buf, w, kept, sent, w2, (T*)z, (T*)send, K, D);
}

template <typename T, int KB>
void launch_bucket(const void* x, const void* buf, const float* w,
                   const float* kept, const float* sent, const float* w2,
                   void* z, void* send, int K, int64_t D, cudaStream_t st) {
  // column pairs need every row start (k * D) and every base aligned to a
  // pair
  const uintptr_t pair = 2 * sizeof(T);
  const bool pairs = D % 2 == 0 && (uintptr_t)x % pair == 0 &&
                     (uintptr_t)buf % pair == 0 && (uintptr_t)z % pair == 0 &&
                     (uintptr_t)send % pair == 0;
  if (pairs)
    launch_reg<T, KB, 2>(x, buf, w, kept, sent, w2, z, send, K, D, st);
  else
    launch_reg<T, KB, 1>(x, buf, w, kept, sent, w2, z, send, K, D, st);
}

template <typename T>
cudaError_t launch_stale(const void* x, const void* buf, const float* w,
                         const float* kept, const float* sent,
                         const float* w2, void* z, void* send, int K,
                         int64_t D, cudaStream_t st) {
  if (K <= 8)
    launch_bucket<T, 8>(x, buf, w, kept, sent, w2, z, send, K, D, st);
  else if (K <= 16)
    launch_bucket<T, 16>(x, buf, w, kept, sent, w2, z, send, K, D, st);
  else if (K <= kRegK)
    launch_bucket<T, kRegK>(x, buf, w, kept, sent, w2, z, send, K, D, st);
  else
    stale_stream<T><<<grid_for(D), kThreads, 0, st>>>(
        (const T*)x, (const T*)buf, w, kept, sent, w2, (T*)z, (T*)send, K, D);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

using namespace repro;

extern "C" int repro_stale_mix(const void* x, const void* buf, int dtype,
                               const float* w, const float* kept,
                               const float* sent, const float* w2, void* z,
                               void* send, int K, int64_t D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return (int)launch_stale<float>(x, buf, w, kept, sent, w2, z, send, K, D,
                                    st);
  if (dtype == kBF16)
    return (int)launch_stale<__nv_bfloat16>(x, buf, w, kept, sent, w2, z,
                                            send, K, D, st);
  return (int)cudaErrorInvalidValue;
}
