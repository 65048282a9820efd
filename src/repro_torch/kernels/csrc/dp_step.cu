// Fused DP noise-add + clipped mean + weight decay + optimizer step (the
// tail of the paper's Eq. 7 chain): SGD and Adam.
//
// repro_noise_sgd_step replaces src/repro/kernels/dp_step.py::
// noise_sgd_step (_sgd_kernel):
//   p' = p - lr*((acc + stddev*noise)/n_units + wd*p)
// over f32 acc and noise [D] and p [D] f32 or bf16; p' in p's dtype.
//   Bound: 8*D + 2*D*sizeof(p) bytes; 3.19 MB at the mlp proxy's
//   D = 199,210 f32, so a call is near the launch cost.
//   Design: one grid-stride elementwise pass; stddev, n_units, lr and wd
//   from a four-float device vector (as the TPU kernel read them from
//   SMEM), each operation rounded on its own in the reference's order.
//
// repro_noise_adam_step replaces src/repro/kernels/dp_step.py::
// noise_adam_step (_adam_kernel):
//   g  = (acc + stddev*noise) / n_units + wd*p
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   p' = p - lr*(m'/c1) / (sqrt(v'/c2) + eps)
// over five f32 [D] inputs into three f32 [D] outputs.
//   Bound: 32*D bytes (five vectors read, three written); 6.4 MB at the main
//   path's D = 199,210, so a call is near the launch cost.
//   Design: one grid-stride elementwise pass. stddev, n_units, lr, wd, c1
//   and c2 are read from a six-float device vector, as the TPU kernel read
//   them from SMEM: c1 = 1 - b1^t and c2 = 1 - b2^t are computed on the
//   device from the step counter, so the step needs no host sync. b1, b2,
//   1-b1, 1-b2 and eps are optimizer constants passed by value; 1-b1 and 1-b2
//   come from the host in double and are rounded once, as the plain version
//   rounds the Python scalars. Every operation is rounded on its own in the
//   reference's order (no FMA contraction), so the kernel repeats the plain
//   version's arithmetic.
#include "common.cuh"

namespace repro {
namespace {

__global__ void noise_adam(const float* __restrict__ sc,
                           const float* __restrict__ acc,
                           const float* __restrict__ noise,
                           const float* __restrict__ p,
                           const float* __restrict__ m,
                           const float* __restrict__ v,
                           float* __restrict__ p2, float* __restrict__ m2,
                           float* __restrict__ v2, int64_t n, float b1,
                           float b2, float omb1, float omb2, float eps) {
  const float stddev = sc[0], n_units = sc[1], lr = sc[2];
  const float wd = sc[3], c1 = sc[4], c2 = sc[5];
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    float g = __fdiv_rn(__fadd_rn(acc[i], __fmul_rn(stddev, noise[i])),
                        n_units);
    const float pf = p[i];
    g = __fadd_rn(g, __fmul_rn(wd, pf));
    const float mm = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(omb1, g));
    const float vv =
        __fadd_rn(__fmul_rn(b2, v[i]), __fmul_rn(__fmul_rn(omb2, g), g));
    const float step =
        __fdiv_rn(__fmul_rn(lr, __fdiv_rn(mm, c1)),
                  __fadd_rn(__fsqrt_rn(__fdiv_rn(vv, c2)), eps));
    p2[i] = __fsub_rn(pf, step);
    m2[i] = mm;
    v2[i] = vv;
  }
}

template <typename T>
__global__ void noise_sgd(const float* __restrict__ sc,
                          const float* __restrict__ acc,
                          const float* __restrict__ noise,
                          const T* __restrict__ p, T* __restrict__ p2,
                          int64_t n) {
  const float stddev = sc[0], n_units = sc[1], lr = sc[2], wd = sc[3];
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    float g = __fdiv_rn(__fadd_rn(acc[i], __fmul_rn(stddev, noise[i])),
                        n_units);
    const float pf = to_f32(p[i]);
    g = __fadd_rn(g, __fmul_rn(wd, pf));
    p2[i] = from_f32<T>(__fsub_rn(pf, __fmul_rn(lr, g)));
  }
}

}  // namespace
}  // namespace repro

using namespace repro;

extern "C" int repro_noise_adam_step(const float* sc, const float* acc,
                                     const float* noise, const float* p,
                                     const float* m, const float* v,
                                     float* p2, float* m2, float* v2,
                                     int64_t n, float b1, float b2,
                                     float omb1, float omb2, float eps,
                                     void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  noise_adam<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      sc, acc, noise, p, m, v, p2, m2, v2, n, b1, b2, omb1, omb2, eps);
  return (int)cudaGetLastError();
}

extern "C" int repro_noise_sgd_step(const float* sc, const float* acc,
                                    const float* noise, const void* p,
                                    int p_code, void* p2, int64_t n,
                                    void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (p_code == kF32)
    noise_sgd<float><<<grid_for(n), kThreads, 0, st>>>(
        sc, acc, noise, (const float*)p, (float*)p2, n);
  else if (p_code == kBF16)
    noise_sgd<__nv_bfloat16><<<grid_for(n), kThreads, 0, st>>>(
        sc, acc, noise, (const __nv_bfloat16*)p, (__nv_bfloat16*)p2, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
