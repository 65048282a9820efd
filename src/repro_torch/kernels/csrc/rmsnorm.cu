// Fused RMSNorm over the last axis.
//
// repro_rmsnorm replaces src/repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel):
//   out = x * rsqrt(mean(x*x) + eps) * g, computed in f32 and cast to x's
//   dtype at the end (the gain is applied before the cast), over rows of a
//   [rows, d] x (f32 or bf16) with g [d] (f32 or bf16).
//   Bound: the bytes, 2*rows*d*sizeof(x) + d*sizeof(g); 58.7 MB for
//   qwen2-7b's d = 3,584 over 4,096 bf16 rows, 17.5 us at 3.35 TB/s.
//   Design: the TPU kernel tiled 256 rows by the whole d in VMEM; here a row
//   goes to one warp (or 2, 4, 8 warps of the 256-thread block when it is
//   long), several rows a block, so a row's reduction needs no block-wide
//   barrier at the usual widths. x is read once: each thread loads its
//   accesses of the row (16-byte vectors on the vector path) into registers
//   up front, all loads in flight together, sums their squares, and writes
//   the normalised values from the same registers; on the vector path the
//   loads and stores carry the streaming hint (.cs, evict first), which ran
//   faster in a one-call A/B on the card. The sum is a fixed-order
//   tree: each thread's accesses in order, a warp-shuffle butterfly (every
//   lane ends with the same bits), then the row's warps in order through
//   shared memory; no atomics, so two runs give the same bits. The mean,
//   the rsqrt and the two products are rounded on their own, in the
//   reference's order (x*r first, then *g). Two instantiations of the same
//   kernel: the vector path (16 bytes of x an access, the gain loaded as
//   wide) when x, g and out are 16-byte aligned and a row is a whole number
//   of 16 bytes, and the scalar path (one element an access) for the rest;
//   the host picks by alignment (kernels/rmsnorm.py::rmsnorm_route). A
//   thread holds at most 8 vectors (or 16 elements on the scalar path), so
//   that 64 registers do and four blocks (32 warps) fit on an SM: a bf16
//   row of qwen2-7b's 3,584 takes 2 warps, 7 vectors a lane (16 vectors a
//   thread, one warp a row at 125 registers and two blocks an SM, ran
//   slower in a one-call A/B on the card). A longer row (above d = 16,384
//   bf16 or 8,192 f32 on the vector path, 4,096 on the scalar one) does not
//   fit; there the kernel sums in a first pass and re-reads x (from L2) in
//   the second.
//   repro_rmsnorm_clients is the same kernel on a grid whose y is the
//   client: K clients' [rows, d] matrices, each with its own gain, in one
//   launch (what jax.vmap of the reference's pallas_call over a cohort
//   with per-client gains runs: a grid axis more). A block's row and its
//   arithmetic are those of the flat launch on that client's matrix, so
//   every client's output is bit-equal to a flat launch on it, on the
//   vector path and on the scalar one.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBlockWarps = kThreads / 32;
// accesses a thread holds in registers: 8 of 16 bytes, or 16 elements
template <int W>
constexpr int kHeld = W == 1 ? 16 : 8;

// One access of W values of T: 16 bytes, or one element.
template <typename T, int W>
struct Access;
template <>
struct Access<float, 4> { using Raw = float4; };
template <>
struct Access<__nv_bfloat16, 8> { using Raw = uint4; };
template <>
struct Access<float, 1> { using Raw = float; };
template <>
struct Access<__nv_bfloat16, 1> { using Raw = __nv_bfloat16; };

__device__ __forceinline__ void bf16x2_to_f32(uint32_t u, float* f) {
  const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&u);
  f[0] = __low2float(p);
  f[1] = __high2float(p);
}

__device__ __forceinline__ void unpack(const float4& r, float (&f)[4]) {
  f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  bf16x2_to_f32(r.x, f);
  bf16x2_to_f32(r.y, f + 2);
  bf16x2_to_f32(r.z, f + 4);
  bf16x2_to_f32(r.w, f + 6);
}
__device__ __forceinline__ void unpack(float r, float (&f)[1]) { f[0] = r; }
__device__ __forceinline__ void unpack(__nv_bfloat16 r, float (&f)[1]) {
  f[0] = __bfloat162float(r);
}

__device__ __forceinline__ uint32_t f32x2_to_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // nearest even
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void pack(const float (&f)[4], float4& r) {
  r = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void pack(const float (&f)[8], uint4& r) {
  r = make_uint4(f32x2_to_bf16(f[0], f[1]), f32x2_to_bf16(f[2], f[3]),
                 f32x2_to_bf16(f[4], f[5]), f32x2_to_bf16(f[6], f[7]));
}
__device__ __forceinline__ void pack(const float (&f)[1], float& r) {
  r = f[0];
}
__device__ __forceinline__ void pack(const float (&f)[1], __nv_bfloat16& r) {
  r = __float2bfloat16_rn(f[0]);  // round to nearest even, as torch's cast
}

// Gain values W*a .. W*a + W - 1 as f32, in accesses as wide as they allow
// (16 bytes of f32, or 8 / 16 bytes of bf16, on the vector path).
template <int W>
__device__ __forceinline__ void load_gain(const float* g, int a,
                                          float (&f)[W]) {
  if constexpr (W == 1) {
    f[0] = g[a];
  } else {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const float4 r = reinterpret_cast<const float4*>(g + W * a)[i];
      f[4 * i] = r.x; f[4 * i + 1] = r.y; f[4 * i + 2] = r.z;
      f[4 * i + 3] = r.w;
    }
  }
}
template <int W>
__device__ __forceinline__ void load_gain(const __nv_bfloat16* g, int a,
                                          float (&f)[W]) {
  if constexpr (W == 1) {
    f[0] = __bfloat162float(g[a]);
  } else if constexpr (W == 4) {
    const uint2 r = reinterpret_cast<const uint2*>(g)[a];
    bf16x2_to_f32(r.x, f);
    bf16x2_to_f32(r.y, f + 2);
  } else {
    unpack(reinterpret_cast<const uint4*>(g)[a], f);
  }
}

template <int W>
__device__ __forceinline__ float sum_squares(float s, const float (&f)[W]) {
#pragma unroll
  for (int e = 0; e < W; ++e) s = __fadd_rn(s, __fmul_rn(f[e], f[e]));
  return s;
}

// x*r first, then *g, each product rounded on its own
template <typename T, typename G, int W, typename Raw>
__device__ __forceinline__ Raw normalise(const Raw& raw, const G* g, int a,
                                         float r) {
  float f[W], gg[W];
  unpack(raw, f);
  load_gain<W>(g, a, gg);
#pragma unroll
  for (int e = 0; e < W; ++e) f[e] = __fmul_rn(__fmul_rn(f[e], r), gg[e]);
  Raw out;
  pack(f, out);
  return out;
}

// W values of T an access; warps_per_row in {1, 2, 4, 8}, rows of a block
// kBlockWarps / warps_per_row. x is read once and the output written once:
// on the vector path with the streaming hint (evict first, ld/st.global.cs).
template <typename T, typename G, int W>
__global__ void __launch_bounds__(kThreads, 4)
rmsnorm_rows(const T* __restrict__ x, const G* __restrict__ g,
             T* __restrict__ out, int64_t rows, int d, int warps_per_row,
             float eps, int64_t client_stride, int64_t g_client_stride) {
  using Raw = typename Access<T, W>::Raw;
  __shared__ float part[kBlockWarps];
  // the client of a client-grid launch (0 for a flat one): its matrix and
  // its gain, x and out laid out alike
  x += blockIdx.y * client_stride;
  out += blockIdx.y * client_stride;
  g += blockIdx.y * g_client_stride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = warp % warps_per_row;  // the warp's place in its row
  const int64_t row = (int64_t)blockIdx.x * (kBlockWarps / warps_per_row) +
                      warp / warps_per_row;
  const int tpr = 32 * warps_per_row;  // threads of a row
  const int ti = 32 * sub + lane;
  const int n = d / W;                  // accesses of a row
  const bool held = n <= kHeld<W> * tpr;   // uniform over the grid
  const bool live = row < rows;
  const Raw* const xr = reinterpret_cast<const Raw*>(x) + (live ? row : 0) * n;
  Raw* const orow = reinterpret_cast<Raw*>(out) + (live ? row : 0) * n;

  Raw hold[kHeld<W>];
  float s = 0.f;
  if (live) {
    if (held) {
#pragma unroll
      for (int i = 0; i < kHeld<W>; ++i)
        if (ti + i * tpr < n) {
          if constexpr (W > 1)
            hold[i] = __ldcs(xr + ti + i * tpr);
          else
            hold[i] = xr[ti + i * tpr];
        }
#pragma unroll
      for (int i = 0; i < kHeld<W>; ++i)
        if (ti + i * tpr < n) {
          float f[W];
          unpack(hold[i], f);
          s = sum_squares<W>(s, f);
        }
    } else {
      for (int a = ti; a < n; a += tpr) {
        float f[W];
        unpack(xr[a], f);
        s = sum_squares<W>(s, f);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if (warps_per_row > 1) {  // uniform over the block
    if (lane == 0) part[warp] = s;
    __syncthreads();
    const int w0 = warp - sub;
    s = part[w0];
    for (int w = 1; w < warps_per_row; ++w) s = __fadd_rn(s, part[w0 + w]);
  }
  if (!live) return;
  const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(s, (float)d), eps));
  if (held) {
#pragma unroll
    for (int i = 0; i < kHeld<W>; ++i) {
      const int a = ti + i * tpr;
      if (a < n) {
        if constexpr (W > 1)
          __stcs(orow + a, normalise<T, G, W>(hold[i], g, a, r));
        else
          orow[a] = normalise<T, G, W>(hold[i], g, a, r);
      }
    }
  } else {
    for (int a = ti; a < n; a += tpr) {
      if constexpr (W > 1)
        __stcs(orow + a, normalise<T, G, W>(xr[a], g, a, r));
      else
        orow[a] = normalise<T, G, W>(xr[a], g, a, r);
    }
  }
}

// K clients of `rows` rows each (K = 1: the flat call), client k's matrix
// at x + k * xs elements and its gain at g + k * gs.
template <typename T, typename G, int W>
int launch_rows(const void* x, const void* g, void* out, int K, int64_t rows,
                int d, int64_t xs, int64_t gs, float eps, cudaStream_t st) {
  const int n = d / W;
  int wpr = 1;  // the fewest warps that hold the row, at most the block's
  while (wpr < kBlockWarps && n > kHeld<W> * 32 * wpr) wpr *= 2;
  const int64_t rpb = kBlockWarps / wpr;
  const int64_t blocks = (rows + rpb - 1) / rpb;
  if (blocks > 0x7fffffff || K < 1 || K > 65535)
    return (int)cudaErrorInvalidValue;
  rmsnorm_rows<T, G, W><<<dim3((unsigned)blocks, (unsigned)K), kThreads, 0,
                          st>>>((const T*)x, (const G*)g, (T*)out, rows, d,
                                wpr, eps, xs, gs);
  return (int)cudaGetLastError();
}

template <typename T, int WV>
int dispatch_rows(const void* x, const void* g, int g_code, void* out, int K,
                  int64_t rows, int d, int64_t xs, int64_t gs, float eps,
                  int vec, cudaStream_t st) {
  if (vec) {
    const size_t g_size = g_code == kF32 ? 4 : 2;
    if (((uintptr_t)x | (uintptr_t)g | (uintptr_t)out) % 16 != 0 ||
        (int64_t)d * sizeof(T) % 16 != 0 || xs * sizeof(T) % 16 != 0 ||
        gs * g_size % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    return g_code == kF32
               ? launch_rows<T, float, WV>(x, g, out, K, rows, d, xs, gs, eps,
                                           st)
               : launch_rows<T, __nv_bfloat16, WV>(x, g, out, K, rows, d, xs,
                                                   gs, eps, st);
  }
  return g_code == kF32
             ? launch_rows<T, float, 1>(x, g, out, K, rows, d, xs, gs, eps,
                                        st)
             : launch_rows<T, __nv_bfloat16, 1>(x, g, out, K, rows, d, xs, gs,
                                                eps, st);
}

int rmsnorm_clients(const void* x, int x_code, const void* g, int g_code,
                    void* out, int K, int64_t rows, int d, int64_t xs,
                    int64_t gs, float eps, int vec, cudaStream_t st) {
  if (rows < 1 || d < 1 || (g_code != kF32 && g_code != kBF16))
    return (int)cudaErrorInvalidValue;
  if (x_code == kF32)
    return dispatch_rows<float, 4>(x, g, g_code, out, K, rows, d, xs, gs, eps,
                                   vec, st);
  if (x_code == kBF16)
    return dispatch_rows<__nv_bfloat16, 8>(x, g, g_code, out, K, rows, d, xs,
                                           gs, eps, vec, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

using namespace repro;

// vec = 1: the vector path (x, g and out 16-byte aligned, d * sizeof(x) a
// multiple of 16, else refused); vec = 0: the scalar path, any alignment.
extern "C" int repro_rmsnorm(const void* x, int x_code, const void* g,
                             int g_code, void* out, int64_t rows, int d,
                             float eps, int vec, void* stream) {
  return rmsnorm_clients(x, x_code, g, g_code, out, 1, rows, d, 0, 0, eps,
                         vec, (cudaStream_t)stream);
}

// K clients' matrices of `rows` rows of d (client k's at x + k * x_stride
// elements, out laid out alike) with their gains (client k's at g + k *
// g_stride elements) in one launch, y = client; vec = 1 also needs both
// client strides whole 16 bytes.
extern "C" int repro_rmsnorm_clients(const void* x, int x_code, const void* g,
                                     int g_code, void* out, int K,
                                     int64_t rows, int d, int64_t x_stride,
                                     int64_t g_stride, float eps, int vec,
                                     void* stream) {
  return rmsnorm_clients(x, x_code, g, g_code, out, K, rows, d, x_stride,
                         g_stride, eps, vec, (cudaStream_t)stream);
}
