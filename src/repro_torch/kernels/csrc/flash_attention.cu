// Causal / sliding-window attention with an online softmax (flash
// attention, forward) on the CUDA cores: the route for the head dims the
// tensor-core kernels do not take.
//
// repro_flash_attention replaces src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel), and serves ops.gqa_flash_attention too,
// for f32 and bf16 at the head dims D <= 256 whose rows are not whole 16
// bytes (bf16 D % 8 != 0, f32 D % 4 != 0; kernels/flash_attention.py::
// flash_route). Every aligned D runs on the tensor cores, zero-padded up to
// 64, 128 or 256 columns: bf16 on flash_attention_sm90.cu's wgmma kernel,
// f32 on the split-TF32 kernel of flash_attention_tf32x3.cu. The entry
// point still takes any D <= 256.
//   out[q] = sum_k softmax_k(scale * q.k | mask) v[k]
// with the mask "key < S, key <= query if causal, query - key < window if a
// window is given", over q, k, v, out of one dtype (f32 or bf16). The
// softmax state (m, l) and the accumulator are f32; a row with no key left
// gives 0. Tensors are addressed by (batch, head, position) strides with
// unit stride along the head dimension D, so the same kernel reads the
// [B, H, S, D] layout and the model's [B, S, H, D] layout; query head h
// reads kv head h / group (grouped-query attention without a repeat).
//   Bound: 4*D flops per (query, key) pair the mask keeps (QK^T and PV),
//   done here as f32 FMAs at up to the card's 67 TFLOP/s outside the tensor
//   cores, or the bytes of q, k, v and out over 3.35 TB/s, whichever is
//   larger; the same products in bf16 could run on the tensor cores (989
//   TFLOP/s), which is the bound chip_smoke.py holds a bf16 call to. At
//   phi-3-vision's causal S = 4,096 and 32 heads, an unaligned D = 100 in
//   bf16 is 107 GFLOP: 1.6 ms of FMAs, 109 us at the tensor-core peak.
//   Design: the TPU kernel's grid ran (B*H, q-blocks, kv-blocks) with the
//   kv axis in order, carrying m, l and acc in VMEM. Here one 256-thread
//   block owns one 64-query tile of one (batch, head) and loops over the
//   64-key tiles itself, carrying m, l and acc in registers. Q (once) and
//   each K tile are staged in shared memory transposed, V as it is, all in
//   the input dtype (a bf16 value widens to f32 exactly); P goes through
//   shared memory in f32. The 16 x 16 threads each own a 4 x 4 block of
//   scores and the matching 4 rows of the output (columns tx*4 + 64*j), so
//   QK^T and PV are register-tiled products of f32 FMAs. Row max and row
//   sum reduce over the 16 threads of a row with warp shuffles. Key tiles
//   wholly above the causal diagonal or left of the window are skipped
//   (their keys would add exactly nothing), and tiles are scheduled heavy
//   first. Shared memory is up to 217 KB at D = 256 f32, above the 48 KB
//   default, so the entry point raises the kernel's dynamic limit.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 64;             // query rows of a block
constexpr int kBK = 64;             // keys of a tile
constexpr int kTS = 68;             // row stride of the transposed tiles
constexpr int kFlashThreads = 256;  // 16 x 16
constexpr int kMaxD = 256;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// four consecutive values (16 B aligned for f32, 8 B for bf16) as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

__host__ __device__ inline int padded_d(int D) { return (D + 3) & ~3; }

// Qt [D][kTS] and Kt [D][kTS] and Vs [kBK][Dv] in T, then Pt [kBK][kTS] f32
template <typename T>
size_t flash_smem_bytes(int D) {
  return sizeof(T) * ((size_t)2 * D * kTS + (size_t)kBK * padded_d(D)) +
         sizeof(float) * (size_t)kBK * kTS;
}

// NV: groups of 64 output columns a thread row covers (D <= 64 * NV)
template <typename T, int NV>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int BH, int H,
          int group, int S, int D, int64_t q_sb, int64_t q_sh, int64_t q_ss,
          int64_t kv_sb, int64_t kv_sh, int64_t kv_ss, float scale,
          int causal, int window, int has_window) {
  extern __shared__ float4 smem4[];
  const int Dv = padded_d(D);
  T* Qt = reinterpret_cast<T*>(smem4);
  T* Kt = Qt + (size_t)D * kTS;
  T* Vs = Kt + (size_t)D * kTS;
  float* Pt = reinterpret_cast<float*>(Vs + (size_t)kBK * Dv);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);  // heavy tiles first
  const int b = bh / H, h = bh - b * H;
  const int q0 = qt * kBQ;
  const T* qb = q + b * q_sb + h * q_sh;
  T* ob = o + b * q_sb + h * q_sh;
  const T* kb = k + b * kv_sb + (h / group) * kv_sh;
  const T* vb = v + b * kv_sb + (h / group) * kv_sh;

  for (int idx = tid; idx < kBQ * D; idx += kFlashThreads) {
    const int r = idx / D, c = idx - r * D;
    Qt[c * kTS + r] = q0 + r < S ? qb[(int64_t)(q0 + r) * q_ss + c]
                                 : from_f32<T>(0.f);
  }

  // the key tiles some query of this tile may see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int lo = has_window ? q0 - window + 1 : 0;
  const int kt_lo = lo > 0 ? lo / kBK : 0;
  const int kt_hi = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;

  float m[4], l[4], acc[4][NV][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's Kt, Vs and Pt are consumed
    for (int idx = tid; idx < kBK * D; idx += kFlashThreads) {
      const int r = idx / D, c = idx - r * D;
      const bool in = k0 + r < S;
      const int64_t off = (int64_t)(k0 + r) * kv_ss + c;
      Kt[c * kTS + r] = in ? kb[off] : from_f32<T>(0.f);
      Vs[r * Dv + c] = in ? vb[off] : from_f32<T>(0.f);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float4 qa = load4(Qt + c * kTS + ty * 4);
      const float4 ka = load4(Kt + c * kTS + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[4];
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        ok[j] = kp < S && (!causal || kp <= qp) &&
                (!has_window || qp - kp < window);
        s[i][j] = ok[j] ? __fmul_rn(s[i][j], scale) : neg_inf();
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == neg_inf() ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = m[i] == neg_inf() ? 0.f : expf(m[i] - m_safe);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * kTS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pa = load4(Pt + kk * kTS + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = j * 64 + tx * 4;
        if (c < Dv) {
          const float4 va = load4(Vs + kk * Dv + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][j][0] = fmaf(pv[i], va.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(pv[i], va.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(pv[i], va.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(pv[i], va.w, acc[i][j][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float lm = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 64 + tx * 4 + e;
        if (c < D)
          ob[(int64_t)qp * q_ss + c] = from_f32<T>(__fdiv_rn(acc[i][j][e], lm));
      }
  }
}

template <typename T, int NV>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 int B, int H, int group, int S, int D, int64_t q_sb,
                 int64_t q_sh, int64_t q_ss, int64_t kv_sb, int64_t kv_sh,
                 int64_t kv_ss, float scale, int causal, int window,
                 int has_window, unsigned n_blocks, cudaStream_t st) {
  const size_t smem = flash_smem_bytes<T>(D);
  const cudaError_t e = cudaFuncSetAttribute(
      (const void*)flash_fwd<T, NV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd<T, NV><<<n_blocks, kFlashThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, B * H, H, group, S, D,
      q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss, scale, causal, window,
      has_window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_flash(int nv, const void* q, const void* k, const void* v,
                   void* o, int B, int H, int group, int S, int D,
                   int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t kv_sb,
                   int64_t kv_sh, int64_t kv_ss, float scale, int causal,
                   int window, int has_window, unsigned n_blocks,
                   cudaStream_t st) {
  if (nv == 1)
    return launch_flash<T, 1>(q, k, v, o, B, H, group, S, D, q_sb, q_sh,
                              q_ss, kv_sb, kv_sh, kv_ss, scale, causal,
                              window, has_window, n_blocks, st);
  if (nv == 2)
    return launch_flash<T, 2>(q, k, v, o, B, H, group, S, D, q_sb, q_sh,
                              q_ss, kv_sb, kv_sh, kv_ss, scale, causal,
                              window, has_window, n_blocks, st);
  return launch_flash<T, 4>(q, k, v, o, B, H, group, S, D, q_sb, q_sh,
                            q_ss, kv_sb, kv_sh, kv_ss, scale, causal, window,
                            has_window, n_blocks, st);
}

}  // namespace
}  // namespace repro

using namespace repro;

// q and out share the strides (q_sb, q_sh, q_ss), k and v share (kv_sb,
// kv_sh, kv_ss); the head dimension is contiguous in all four. Query head h
// of H reads kv head h / group.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int code, int B,
    int H, int group, int S, int D, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t kv_sb, int64_t kv_sh, int64_t kv_ss, float scale, int causal,
    int window, int has_window, void* stream) {
  if (B < 1 || H < 1 || S < 1 || D < 1 || D > kMaxD || group < 1 ||
      H % group != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n_blocks = (int64_t)B * H * ((S + kBQ - 1) / kBQ);
  if ((int64_t)B * H > 0x7fffffff || n_blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int nv = D <= 64 ? 1 : D <= 128 ? 2 : 4;
  cudaStream_t st = (cudaStream_t)stream;
  if (code == kF32)
    return dispatch_flash<float>(nv, q, k, v, o, B, H, group, S, D, q_sb,
                                 q_sh, q_ss, kv_sb, kv_sh, kv_ss, scale,
                                 causal, window, has_window,
                                 (unsigned)n_blocks, st);
  if (code == kBF16)
    return dispatch_flash<__nv_bfloat16>(
        nv, q, k, v, o, B, H, group, S, D, q_sb, q_sh, q_ss, kv_sb, kv_sh,
        kv_ss, scale, causal, window, has_window, (unsigned)n_blocks, st);
  return (int)cudaErrorInvalidValue;
}
