// Fused DP noise-add + clipped mean + weight decay + optimizer step (the
// tail of the paper's Eq. 7 chain): SGD and Adam.
//
// repro_noise_sgd_step replaces src/repro/kernels/dp_step.py::
// noise_sgd_step (_sgd_kernel):
//   p' = p - lr*((acc + stddev*noise)/n_units + wd*p)
// over f32 acc and noise [D] and p [D] f32 or bf16; p' in p's dtype.
//   Bound: 8*D + 2*D*sizeof(p) bytes; 3.19 MB at the mlp proxy's
//   D = 199,210 f32, about 0.95 us.
//   Design: one launch a call, as the Adam step below: stddev, n_units, lr
//   and wd go by value (the host rounds each once to f32, as the TPU kernel
//   read four f32 values from SMEM), C = 4, 2 or 1 neighbouring elements a
//   thread with one access of C elements per vector (kernels/dp_step.py::
//   step_columns: 16 bytes of f32 or 8 of bf16 where every base allows),
//   the D % C tail on the first threads; each operation rounded on its own
//   in the reference's order.
//
// repro_noise_adam_step replaces src/repro/kernels/dp_step.py::
// noise_adam_step (_adam_kernel):
//   g  = (acc + stddev*noise) / n_units + wd*p
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   p' = p - lr*(m'/c1) / (sqrt(v'/c2) + eps)
// over five f32 [D] inputs into three f32 [D] outputs.
//   Bound: 32*D + 8 bytes (five vectors and c1, c2 read, three vectors
//   written); 6.4 MB at the main path's D = 199,210, about 1.9 us.
//   Design: one launch a call, nothing assembled on the device before it.
//   stddev, n_units, lr, wd, b1, b2, 1-b1, 1-b2 and eps go by value (the
//   host rounds each once to f32, as the plain version rounds its Python
//   scalars); c1 = 1 - b1^t and c2 = 1 - b2^t are read through their own
//   device pointers, since they come from the step counter on the device
//   and the step must not sync with the host. A thread takes C = 4, 2 or 1
//   neighbouring elements with one 16-, 8- or 4-byte access per vector,
//   C chosen on the host as the widest that every vector's base is aligned
//   to (kernels/dp_step.py::step_columns); the D % C elements past the last
//   whole group go to the first threads of the grid. Every operation is
//   rounded on its own in the reference's order (no FMA contraction), so
//   the kernel repeats the plain version's arithmetic bit for bit at every C
//   where that divides by n_units (given n_units as a Python number,
//   PyTorch's CUDA division multiplies by its f32 reciprocal instead, an
//   ulp apart in g).
//   The client-grid route (repro_noise_adam_step_clients) runs the same
//   kernel on a 2-D grid: blockIdx.y is client k of [K, D] stacks and reads
//   its own c1[k] and c2[k] (Adam's step count is per client: dropout and
//   ragged step masks make the counts differ), so row k is bit-equal to the
//   flat call on that client's vectors. Bound: 32*K*D + 8*K bytes; 51 MB
//   at the main round's K = 8, D = 199,210, about 15.2 us.
#include "common.cuh"

namespace repro {
namespace {

struct AdamScalars {
  float stddev, n_units, lr, wd, b1, b2, omb1, omb2, eps;
};

// One element of the Adam step; writes p', m', v'.
__device__ __forceinline__ void adam_element(const AdamScalars& s, float c1,
                                             float c2, float acc, float noise,
                                             float pf, float m, float v,
                                             float& p2, float& m2,
                                             float& v2) {
  float g = __fdiv_rn(__fadd_rn(acc, __fmul_rn(s.stddev, noise)), s.n_units);
  g = __fadd_rn(g, __fmul_rn(s.wd, pf));
  m2 = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v2 = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
  const float step =
      __fdiv_rn(__fmul_rn(s.lr, __fdiv_rn(m2, c1)),
                __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, c2)), s.eps));
  p2 = __fsub_rn(pf, step);
}

template <int C>
__global__ void noise_adam(const float* __restrict__ c1p,
                           const float* __restrict__ c2p,
                           const float* __restrict__ acc,
                           const float* __restrict__ noise,
                           const float* __restrict__ p,
                           const float* __restrict__ m,
                           const float* __restrict__ v,
                           float* __restrict__ p2, float* __restrict__ m2,
                           float* __restrict__ v2, int64_t n,
                           AdamScalars s) {
  // blockIdx.y: the client of a [K, n] stack (0 for the flat call)
  const int64_t row = (int64_t)blockIdx.y * n;
  acc += row;
  noise += row;
  p += row;
  m += row;
  v += row;
  p2 += row;
  m2 += row;
  v2 += row;
  const float c1 = c1p[blockIdx.y], c2 = c2p[blockIdx.y];
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t groups = n / C;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t gi = first; gi < groups; gi += stride) {
    const int64_t i = gi * C;
    float a[C], z[C], pf[C], mm[C], vv[C], po[C], mo[C], vo[C];
    load_cols<C>(acc + i, a);
    load_cols<C>(noise + i, z);
    load_cols<C>(p + i, pf);
    load_cols<C>(m + i, mm);
    load_cols<C>(v + i, vv);
#pragma unroll
    for (int k = 0; k < C; ++k)
      adam_element(s, c1, c2, a[k], z[k], pf[k], mm[k], vv[k], po[k], mo[k],
                   vo[k]);
    store_cols<C>(p2 + i, po);
    store_cols<C>(m2 + i, mo);
    store_cols<C>(v2 + i, vo);
  }
  if constexpr (C > 1) {  // the n % C elements past the last group
    const int64_t i = groups * C + first;
    if (i < n)
      adam_element(s, c1, c2, acc[i], noise[i], p[i], m[i], v[i], p2[i],
                   m2[i], v2[i]);
  }
}

struct SgdScalars {
  float stddev, n_units, lr, wd;
};

// One element of the SGD step, p' as f32.
__device__ __forceinline__ float sgd_element(const SgdScalars& s, float acc,
                                             float noise, float pf) {
  float g = __fdiv_rn(__fadd_rn(acc, __fmul_rn(s.stddev, noise)), s.n_units);
  g = __fadd_rn(g, __fmul_rn(s.wd, pf));
  return __fsub_rn(pf, __fmul_rn(s.lr, g));
}

template <typename T, int C>
__global__ void noise_sgd(const float* __restrict__ acc,
                          const float* __restrict__ noise,
                          const T* __restrict__ p, T* __restrict__ p2,
                          int64_t n, SgdScalars s) {
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t groups = n / C;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t gi = first; gi < groups; gi += stride) {
    const int64_t i = gi * C;
    float a[C], z[C], pf[C], po[C];
    load_cols<C>(acc + i, a);
    load_cols<C>(noise + i, z);
    load_cols<C>(p + i, pf);
#pragma unroll
    for (int k = 0; k < C; ++k) po[k] = sgd_element(s, a[k], z[k], pf[k]);
    store_cols<C>(p2 + i, po);
  }
  if constexpr (C > 1) {  // the n % C elements past the last group
    const int64_t i = groups * C + first;
    if (i < n)
      p2[i] = from_f32<T>(sgd_element(s, acc[i], noise[i], to_f32(p[i])));
  }
}

template <typename T>
int launch_sgd(const float* acc, const float* noise, const void* p, void* p2,
               int64_t n, const SgdScalars& s, int cols, cudaStream_t st) {
  const T* pt = (const T*)p;
  T* p2t = (T*)p2;
  if (cols == 4)
    noise_sgd<T, 4><<<grid_for(n / 4 > 0 ? n / 4 : 1), kThreads, 0, st>>>(
        acc, noise, pt, p2t, n, s);
  else if (cols == 2)
    noise_sgd<T, 2><<<grid_for(n / 2 > 0 ? n / 2 : 1), kThreads, 0, st>>>(
        acc, noise, pt, p2t, n, s);
  else if (cols == 1)
    noise_sgd<T, 1><<<grid_for(n), kThreads, 0, st>>>(acc, noise, pt, p2t, n,
                                                      s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro

using namespace repro;

// K clients' rows of n elements in [K, n] stacks, c1 and c2 [K]; cols:
// elements a thread (1, 2 or 4); every row's base must be aligned to cols
// floats.
extern "C" int repro_noise_adam_step_clients(
    const float* c1, const float* c2, const float* acc, const float* noise,
    const float* p, const float* m, const float* v, float* p2, float* m2,
    float* v2, int K, int64_t n, float stddev, float n_units, float lr,
    float wd, float b1, float b2, float omb1, float omb2, float eps, int cols,
    void* stream) {
  if (n < 1 || K < 1 || K > 65535) return (int)cudaErrorInvalidValue;
  const AdamScalars s{stddev, n_units, lr, wd, b1, b2, omb1, omb2, eps};
  cudaStream_t st = (cudaStream_t)stream;
  // the flat call's grid over a row's groups of cols, one grid row a client
  const dim3 grid(grid_for(cols == 1 ? n : (n / cols > 0 ? n / cols : 1)),
                  K);
  if (cols == 4)
    noise_adam<4><<<grid, kThreads, 0, st>>>(c1, c2, acc, noise, p, m, v,
                                             p2, m2, v2, n, s);
  else if (cols == 2)
    noise_adam<2><<<grid, kThreads, 0, st>>>(c1, c2, acc, noise, p, m, v,
                                             p2, m2, v2, n, s);
  else if (cols == 1)
    noise_adam<1><<<grid, kThreads, 0, st>>>(c1, c2, acc, noise, p, m, v,
                                             p2, m2, v2, n, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// One client: cols elements a thread (1, 2 or 4); every vector's base must
// be aligned to cols floats.
extern "C" int repro_noise_adam_step(const float* c1, const float* c2,
                                     const float* acc, const float* noise,
                                     const float* p, const float* m,
                                     const float* v, float* p2, float* m2,
                                     float* v2, int64_t n, float stddev,
                                     float n_units, float lr, float wd,
                                     float b1, float b2, float omb1,
                                     float omb2, float eps, int cols,
                                     void* stream) {
  return repro_noise_adam_step_clients(c1, c2, acc, noise, p, m, v, p2, m2,
                                       v2, 1, n, stddev, n_units, lr, wd, b1,
                                       b2, omb1, omb2, eps, cols, stream);
}

// cols: elements a thread (1, 2 or 4); every vector's base must be aligned
// to cols of its elements.
extern "C" int repro_noise_sgd_step(const float* acc, const float* noise,
                                    const void* p, int p_code, void* p2,
                                    int64_t n, float stddev, float n_units,
                                    float lr, float wd, int cols,
                                    void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const SgdScalars s{stddev, n_units, lr, wd};
  cudaStream_t st = (cudaStream_t)stream;
  if (p_code == kF32)
    return launch_sgd<float>(acc, noise, p, p2, n, s, cols, st);
  if (p_code == kBF16)
    return launch_sgd<__nv_bfloat16>(acc, noise, p, p2, n, s, cols, st);
  return (int)cudaErrorInvalidValue;
}
