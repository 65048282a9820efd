// Causal / sliding-window attention with an online softmax (flash
// attention, forward) for f32 at every head dim D <= 256, on Hopper's
// tensor cores in split TF32.
//
// repro_flash_attention_tf32x3 and repro_flash_attention_tf32x3_narrow
// replace src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel) for f32 q, k, v, and serve ops.gqa_flash_attention too:
//   out[q] = sum_k softmax_k(scale * q.k | mask) v[k]
// with the mask "key < S, key <= query if causal, query - key < window if a
// window is given"; bf16 runs flash_attention_sm90.cu
// (kernels/flash_attention.py::flash_route picks the kernel by dtype,
// flash_copy_width the loader by alignment). The softmax state, the
// accumulator and the output are f32; a row with no key left gives 0.
// Tensors are addressed by (batch, head, position) strides with unit
// stride along D, so the kernel reads the
// [B, H, S, D] layout and the model's [B, S, H, D] layout alike; query head
// h reads kv head h / group (grouped-query attention without a repeat).
//   Precision: one TF32 product keeps about three decimal digits, outside
//   the f32 tolerance. Each f32 operand is split into a TF32 high part (its
//   bits rounded to 10 mantissa bits, half away from zero, as cvt.rna) and
//   the residual lo = x - hi (exact in f32; the tensor core reads its top 19
//   bits), and a product is formed as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with
//   f32 accumulation: the dropped a_lo*b_lo and the truncation of lo are
//   about 2^-21 of the product, f32-grade.
//   Bound: 4*D flops per (query, key) pair the mask keeps (QK^T and PV),
//   each done three times on the tensor cores: 4*D pairs of f32-grade flops
//   over 495 / 3 = 165 TFLOP/s, or the bytes of q, k, v and out over
//   3.35 TB/s, whichever is larger; for qwen2-7b's causal S = 4,096, 28
//   heads, D = 128 that is 120 GFLOP, about 729 us, bound by operations
//   (1.8 ms at the 67 TFLOP/s of f32 FMAs outside the tensor cores).
//   Design: wgmma in TF32 takes both operands K-major from shared memory,
//   which fits QK^T but not V (MN-major), and a second shared copy of each
//   lo part does not fit at D = 128 f32. mma.sync.m16n8k8.tf32 takes its
//   fragments in registers, so the split costs registers, not shared
//   memory, and P stays in registers: it runs both products. One CTA of 8
//   warps (256 threads) owns a 128-row query tile of one (batch, head), 16
//   rows a warp, and loops over key tiles of 64 keys (16 at D = 256, where Q
//   takes 132 KB), carrying m, l and O in registers. Q (once) and a two-
//   stage ring of K and V tiles are copied by cp.async (16 bytes a thread,
//   rows past S zero-filled) into shared memory with padded rows (D + 8
//   floats for Q and K, D + 4 for V), so every fragment load of a warp is
//   free of bank conflicts. Inside a k8 step the fragment columns t and
//   t + 4 of a thread are taken as the adjacent elements 2t and 2t + 1 of
//   both operands (the sum over k is the same in any order): Q and K
//   fragments are 8-byte loads, and the S accumulator of an n8 tile is
//   already the A fragment of P.V for its 8 keys, with V rows 2t and 2t + 1.
//   The online softmax runs on the accumulator fragments (row max over the
//   quad of threads that share a row, exp2 with scale*log2(e) folded in,
//   m_safe and corr = 0 for an empty row as in the reference; l kept per
//   thread and summed over the quad at the end). Each k8 step loads and
//   splits the B fragments of all its n8 tiles first and runs the three
//   products pass by pass, so consecutive mma do not wait on each other.
//   The high part is rounded with an integer add and mask: cvt.rna.tf32.f32
//   does the same and ran slower at qwen2-7b's width in a one-call A/B on
//   the card, as did key tiles of 32 at D = 128. Key tiles wholly above the
//   diagonal or left of the window are never loaded, tiles a warp cannot
//   see are skipped by it, only tiles that straddle an edge (or hold keys
//   >= S, zero-filled: a zero key would score 0, not -inf) take element
//   masks, and query tiles run heavy first. The epilogue divides by
//   max(l, 1e-30) and stores rows < S. Shared memory is
//   106 KB at D = 64, 158 KB at D = 96, 202 KB at D = 128 and 198 KB at
//   D = 256, above the 48 KB default, so the entry point raises the
//   kernel's dynamic limit.
//   Head dims: compiled at D in {64, 96, 128, 256}. 96 is phi-3-vision's
//   head dim and runs natively: its shared-memory plan fits (158 KB) and
//   keeps the padded rows' bank pattern (the row strides are 8 and 4 mod
//   32 floats at every width), and its 12 n8 tiles make whole groups of 4.
//   A call at another D runs the smallest compiled width above it, with D
//   passed at run time, in a second instantiation (PAD) so that a call at
//   a compiled width runs code without the checks: the copies of columns
//   >= D are zero-filled (src-size 0, as rows >= S are), a zero splits into
//   hi = lo = 0 exactly, so those columns add exact zeros to QK^T and fill
//   output columns >= D, which the epilogue never stores.
//   Loaders: where D * 4, every base and every stride are multiples of 16
//   bytes, flash_fwd_tf32x3 copies 16 bytes a cp.async. Anywhere else
//   flash_fwd_tf32x3_narrow (always PAD) fills the same padded rows with
//   the widest copy the rows allow, 8 bytes (two floats: D even, bases and
//   strides 8-byte aligned) or 4, through the same two-stage cp.async ring,
//   so the products, the softmax and the bits of the result are the same
//   kernel's; its epilogue stores float pairs where rows are 8-byte aligned
//   and single floats otherwise (an odd D ends in half a pair). The copies
//   are smaller, the bytes the same: at phi-3-vision's length and heads
//   with D = 98 (the 128-wide instantiation) the bound is still the
//   split-TF32 products, about 638 us.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 128;           // query rows of a CTA, 16 a warp
constexpr int kX3Threads = 256;    // 8 warps

template <int D>
struct TileX3 {
  static constexpr int BK = D <= 128 ? 64 : 16;  // keys of a tile
  static constexpr int QS = D + 8;  // row strides in floats: conflict-free
  static constexpr int KS = D + 8;  // 8-byte loads of 8 rows x 4 threads
  static constexpr int VS = D + 4;  // 4-byte loads of 4 row pairs x 8 cols
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)kBQ * QS + 2 * (size_t)BK * (KS + VS));
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async ---------------------------------------------------------------

// W bytes (16, 8 or 4) global -> shared; with in = false nothing is read
// and the destination is zero-filled. Only 16-byte copies may bypass L1.
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool in) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(W), "r"(in ? W : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ROWS rows of D floats from position p0 on (stride ss) into shared memory
// with row stride RS, W bytes a copy; rows at or past S and, with PAD,
// columns at or past d (a multiple of W / 4) read as zeros.
template <int D, int ROWS, int RS, bool PAD, int W>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t ss, int p0, int S, int d) {
  constexpr int E = W / 4;        // floats a copy
  constexpr int kChunks = D / E;  // copies of a row
  constexpr int kIters = ROWS * kChunks / kX3Threads;
  static_assert(ROWS * kChunks % kX3Threads == 0, "whole rounds of copies");
  auto copy = [&](int it) {
    const int i = threadIdx.x + it * kX3Threads;
    const int r = i / kChunks, c = (i - r * kChunks) * E;
    const bool in = p0 + r < S && (!PAD || c < d);
    cp_async<W>(dst + r * RS + c, in ? src + (int64_t)(p0 + r) * ss + c : src,
                in);
  };
  if constexpr (W == 16) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) copy(it);
  } else {   // up to 128 narrow copies a thread: unrolled fully they spill
#pragma unroll 4
    for (int it = 0; it < kIters; ++it) copy(it);
  }
}

// ---- split TF32 -------------------------------------------------------------

// x = hi + lo: hi is x rounded to TF32 (half away from zero, as cvt.rna),
// lo the exact residual (the tensor core reads its top 19 bits).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a * b, m16n8k8, f32 += tf32 * tf32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The kernel's body. PAD: the head dim d < D is passed at run time; W:
// bytes a copy of the loads, and with W < 8 the epilogue stores single
// floats.
template <int D, bool PAD, int W>
__device__ __forceinline__ void attend_x3(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int BH, int H,
    int group, int S, int d, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t kv_sb, int64_t kv_sh, int64_t kv_ss, float scale_log2,
    int causal, int window, int has_window) {
  using T = TileX3<D>;
  constexpr int BK = T::BK, NJ = BK / 8, QS = T::QS, KS = T::KS, VS = T::VS;
  constexpr int NG = 4;  // n8 tiles of V a P.V pass loads at once
  static_assert((D / 8) % NG == 0, "whole groups of V tiles");
  extern __shared__ float4 smem4[];
  float* const sQ = reinterpret_cast<float*>(smem4);
  float* const sK = sQ + kBQ * QS;     // [2][BK][KS]
  float* const sV = sK + 2 * BK * KS;  // [2][BK][VS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;  // fragment row, thread of a quad
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);  // heavy tiles first
  const int b = bh / H, h = bh - b * H, hk = h / group;
  const int q0 = qt * kBQ;
  const float* const qb = q + b * q_sb + h * q_sh;
  const float* const kb = k + b * kv_sb + hk * kv_sh;
  const float* const vb = v + b * kv_sb + hk * kv_sh;

  // the key tiles some query of this tile may see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int lo = has_window ? q0 - window + 1 : 0;
  const int kt_lo = lo > 0 ? lo / BK : 0;
  const int kt_hi = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  const int n_tiles = kt_hi - kt_lo;

  if (n_tiles > 0) {
    load_rows<D, kBQ, QS, PAD, W>(sQ, qb, q_ss, q0, S, d);
    load_rows<D, BK, KS, PAD, W>(sK, kb, kv_ss, kt_lo * BK, S, d);
    load_rows<D, BK, VS, PAD, W>(sV, vb, kv_ss, kt_lo * BK, S, d);
  }
  cp_commit();

  // this thread's rows: r0 and r0 + 8; its keys of an n8 tile and its
  // output columns of an 8-wide group: 2 * tq and + 1
  const int w_first = q0 + 16 * warp, w_last = w_first + 15;
  const int r0 = w_first + gr;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  const float* const qw = sQ + (16 * warp + gr) * QS + 2 * tq;

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n & 1, k0 = (kt_lo + n) * BK;
    if (n + 1 < n_tiles) {  // the next tile into the other stage
      load_rows<D, BK, KS, PAD, W>(sK + (st ^ 1) * BK * KS, kb, kv_ss,
                                   k0 + BK, S, d);
      load_rows<D, BK, VS, PAD, W>(sV + (st ^ 1) * BK * VS, vb, kv_ss,
                                   k0 + BK, S, d);
    }
    cp_commit();
    cp_wait<1>();  // this thread's copies of tile n have landed
    __syncthreads();  // and everyone's

    const bool unseen = (causal && k0 > w_last) ||
                        (has_window && w_first - (k0 + BK - 1) >= window);
    if (!unseen) {  // uniform over the warp
      const float* const kw = sK + st * BK * KS + gr * KS + 2 * tq;
      const float* const vw = sV + st * BK * VS + 2 * tq * VS + gr;

      // S = Q K^T: D / 8 steps of k8; s[j] is the n8 tile of keys
      // k0 + 8j .. k0 + 8j + 7
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const float2 qa = *reinterpret_cast<const float2*>(qw + 8 * kk);
        const float2 qc =
            *reinterpret_cast<const float2*>(qw + 8 * QS + 8 * kk);
        uint32_t ah[4], al[4];
        split_tf32(qa.x, ah[0], al[0]);
        split_tf32(qc.x, ah[1], al[1]);
        split_tf32(qa.y, ah[2], al[2]);
        split_tf32(qc.y, ah[3], al[3]);
        uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 kv2 =
              *reinterpret_cast<const float2*>(kw + 8 * j * KS + 8 * kk);
          split_tf32(kv2.x, bh[j][0], bl[j][0]);
          split_tf32(kv2.y, bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(s[j], al, bh[j]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(s[j], ah, bl[j]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(s[j], ah, bh[j]);
      }

      // scale into log2 units and mask; s[j][e] is row r0 + 8 * (e >> 1),
      // key k0 + 8j + 2 tq + (e & 1)
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > w_first) ||
                        (has_window && w_last - k0 >= window);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int kp = k0 + 8 * j + 2 * tq + (e & 1);
            const int qp = r0 + 8 * (e >> 1);
            const bool ok = kp < S && (!causal || kp <= qp) &&
                            (!has_window || qp - kp < window);
            x = ok ? x : neg_inf();
          }
          s[j][e] = x;
        }
      float corr[2], m_safe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = neg_inf();
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        m_safe[r] = m_new == neg_inf() ? 0.f : m_new;
        corr[r] = m[r] == neg_inf() ? 0.f : exp2f(m[r] - m_safe[r]);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - m_safe[e >> 1]);
          rs[e >> 1] += s[j][e];
        }
      l[0] = l[0] * corr[0] + rs[0];
      l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] *= corr[e >> 1];

      // O += P V: the n8 tile j of S is the A fragment of keys 8j .. 8j + 7
      // (columns tq and tq + 4 hold keys 2 tq and 2 tq + 1), V's B fragment
      // rows 2 tq and 2 tq + 1 of that tile
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const float* const vj = vw + 8 * j * VS;
#pragma unroll
        for (int c0 = 0; c0 < D / 8; c0 += NG) {
          uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
          for (int c = 0; c < NG; ++c) {
            split_tf32(vj[8 * (c0 + c)], bh[c][0], bl[c][0]);
            split_tf32(vj[VS + 8 * (c0 + c)], bh[c][1], bl[c][1]);
          }
#pragma unroll
          for (int c = 0; c < NG; ++c) mma_tf32(acc[c0 + c], pl, bh[c]);
#pragma unroll
          for (int c = 0; c < NG; ++c) mma_tf32(acc[c0 + c], ph, bl[c]);
#pragma unroll
          for (int c = 0; c < NG; ++c) mma_tf32(acc[c0 + c], ph, bh[c]);
        }
      }
    }
    __syncthreads();  // stage st is refilled at iteration n + 1
  }
  cp_wait<0>();

  // epilogue: O / l, rows < S (and with PAD columns < d)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  float* const ob = o + b * q_sb + h * q_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r0 + 8 * r;
    if (qp >= S) continue;
    float* const orow = ob + (int64_t)qp * q_ss + 2 * tq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * tq;
      if constexpr (W >= 8) {  // d even: a pair is in or out
        if (!PAD || col < d)
          *reinterpret_cast<float2*>(orow + 8 * c) =
              make_float2(__fdiv_rn(acc[c][2 * r], l[r]),
                          __fdiv_rn(acc[c][2 * r + 1], l[r]));
      } else {  // rows 4-byte aligned, d maybe odd
        if (col < d) orow[8 * c] = __fdiv_rn(acc[c][2 * r], l[r]);
        if (col + 1 < d) orow[8 * c + 1] = __fdiv_rn(acc[c][2 * r + 1], l[r]);
      }
    }
  }
}

// 16-byte copies: D * 4, bases and strides multiples of 16 bytes
template <int D, bool PAD>
__global__ void __launch_bounds__(kX3Threads, 1)
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int BH,
                 int H, int group, int S, int d, int64_t q_sb, int64_t q_sh,
                 int64_t q_ss, int64_t kv_sb, int64_t kv_sh, int64_t kv_ss,
                 float scale_log2, int causal, int window, int has_window) {
  attend_x3<D, PAD, 16>(q, k, v, o, BH, H, group, S, d, q_sb, q_sh, q_ss,
                        kv_sb, kv_sh, kv_ss, scale_log2, causal, window,
                        has_window);
}

// W = 8 or 4 bytes a copy: anything the 16-byte loader does not take
template <int D, int W>
__global__ void __launch_bounds__(kX3Threads, 1)
flash_fwd_tf32x3_narrow(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        int BH, int H, int group, int S, int d, int64_t q_sb,
                        int64_t q_sh, int64_t q_ss, int64_t kv_sb,
                        int64_t kv_sh, int64_t kv_ss, float scale_log2,
                        int causal, int window, int has_window) {
  attend_x3<D, true, W>(q, k, v, o, BH, H, group, S, d, q_sb, q_sh, q_ss,
                        kv_sb, kv_sh, kv_ss, scale_log2, causal, window,
                        has_window);
}

// head dim d on the kernel compiled at D >= d: the 16-byte loader (W = 16)
// or the narrow one (W = 8 or 4)
template <int D, bool PAD, int W>
int launch_tf32x3(const void* q, const void* k, const void* v, void* o,
                  int B, int H, int group, int S, int d, int64_t q_sb,
                  int64_t q_sh,
                  int64_t q_ss, int64_t kv_sb, int64_t kv_sh, int64_t kv_ss,
                  float scale, int causal, int window, int has_window,
                  unsigned n_blocks, cudaStream_t st) {
  const size_t smem = TileX3<D>::SMEM;
  using Kernel = void (*)(const float*, const float*, const float*, float*,
                          int, int, int, int, int, int64_t, int64_t, int64_t,
                          int64_t, int64_t, int64_t, float, int, int, int);
  Kernel kernel;
  if constexpr (W == 16)
    kernel = flash_fwd_tf32x3<D, PAD>;
  else
    kernel = flash_fwd_tf32x3_narrow<D, W>;
  const cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_blocks, kX3Threads, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, B * H, H,
      group, S, d, q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss,
      scale * 1.4426950408889634f, causal, window, has_window);
  return (int)cudaGetLastError();
}

// Shape checks shared by both entry points; the CTA count, or 0 to refuse.
int64_t x3_blocks(int B, int H, int group, int S, int D) {
  if (B < 1 || H < 1 || S < 1 || group < 1 || H % group != 0 || D < 1 ||
      D > 256)
    return 0;
  const int64_t n_blocks = (int64_t)B * H * ((S + kBQ - 1) / kBQ);
  if ((int64_t)B * H > 0x7fffffff || n_blocks > 0x7fffffff) return 0;
  return n_blocks;
}

}  // namespace
}  // namespace repro

using namespace repro;

// f32 q, k, v and out; q and out share the strides (q_sb, q_sh, q_ss), k
// and v share (kv_sb, kv_sh, kv_ss); the head dimension is contiguous in
// all four. The 16-byte copies need 16-byte aligned bases and strides that
// are multiples of 16 bytes: anything else is refused, as is a D that is
// not a multiple of 4 in 4..256 (repro_flash_attention_tf32x3_narrow takes
// those). D runs on the kernel compiled at the next of 64, 96, 128, 256.
extern "C" int repro_flash_attention_tf32x3(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int group, int S, int D, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t kv_sb, int64_t kv_sh, int64_t kv_ss, float scale, int causal,
    int window, int has_window, void* stream) {
  const int64_t n_blocks = x3_blocks(B, H, group, S, D);
  if (n_blocks == 0 || D % 4 != 0) return (int)cudaErrorInvalidValue;
  const uintptr_t bases[4] = {(uintptr_t)q, (uintptr_t)k, (uintptr_t)v,
                              (uintptr_t)o};
  const int64_t strides[6] = {q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss};
  for (int i = 0; i < 4; ++i)
    if (bases[i] % 16 != 0) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 6; ++i)
    if (strides[i] <= 0 || strides[i] * 4 % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned nb = (unsigned)n_blocks;
  const bool pad = D != 64 && D != 96 && D != 128 && D != 256;
  const auto launch =
      D <= 64 ? (pad ? launch_tf32x3<64, true, 16>
                     : launch_tf32x3<64, false, 16>)
      : D <= 96 ? (pad ? launch_tf32x3<96, true, 16>
                       : launch_tf32x3<96, false, 16>)
      : D <= 128 ? (pad ? launch_tf32x3<128, true, 16>
                        : launch_tf32x3<128, false, 16>)
                 : (pad ? launch_tf32x3<256, true, 16>
                        : launch_tf32x3<256, false, 16>);
  return launch(q, k, v, o, B, H, group, S, D, q_sb, q_sh, q_ss, kv_sb, kv_sh,
                kv_ss, scale, causal, window, has_window, nb, st);
}

// The narrow loader: the same arguments and any D in 1..256, plus width,
// the bytes a copy (8 or 4), which every base and stride and D * 4 must be
// multiples of; anything else is refused.
extern "C" int repro_flash_attention_tf32x3_narrow(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int group, int S, int D, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t kv_sb, int64_t kv_sh, int64_t kv_ss, float scale, int causal,
    int window, int has_window, int width, void* stream) {
  const int64_t n_blocks = x3_blocks(B, H, group, S, D);
  if (n_blocks == 0 || (width != 8 && width != 4) || D * 4 % width != 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t bases[4] = {(uintptr_t)q, (uintptr_t)k, (uintptr_t)v,
                              (uintptr_t)o};
  const int64_t strides[6] = {q_sb, q_sh, q_ss, kv_sb, kv_sh, kv_ss};
  for (int i = 0; i < 4; ++i)
    if (bases[i] % width != 0) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 6; ++i)
    if (strides[i] <= 0 || strides[i] * 4 % width != 0)
      return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned nb = (unsigned)n_blocks;
  const bool w8 = width == 8;
  const auto launch =
      D <= 64 ? (w8 ? launch_tf32x3<64, true, 8> : launch_tf32x3<64, true, 4>)
      : D <= 96 ? (w8 ? launch_tf32x3<96, true, 8>
                      : launch_tf32x3<96, true, 4>)
      : D <= 128 ? (w8 ? launch_tf32x3<128, true, 8>
                       : launch_tf32x3<128, true, 4>)
                 : (w8 ? launch_tf32x3<256, true, 8>
                       : launch_tf32x3<256, true, 4>);
  return launch(q, k, v, o, B, H, group, S, D, q_sb, q_sh, q_ss, kv_sb, kv_sh,
                kv_ss, scale, causal, window, has_window, nb, st);
}
