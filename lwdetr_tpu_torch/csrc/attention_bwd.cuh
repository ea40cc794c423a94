// Warp-level tensor-core products for the attention backwards (K6 in
// flash_attention_bwd.cu, K7 in window_attention_bwd.cu), in bf16 and in f32.
//
// Every operand sits in shared memory as rows of contiguous tokens (the
// channel-major layout of qkv: [channel d][token]), or, for the softmax
// weights and their gradients, in the f32 accumulators of the product that
// made them. Three products cover both kernels:
//   mma_tn: acc[m][n] += sum_k A[k][m] B[k][n]  (S = Q^T K, dP = dO^T V)
//   mma_rt: acc[m][n] += sum_k P[m][k] B[n][k]  (P in registers: dQ = dS K^T, ...)
//   mma_nn: acc[m][n] += sum_k A[m][k] B[k][n]  (K7's dK^T = Q dS, dV^T = dO P)
// acc holds C fragments of 16 x 8 tiles (lane = 4 g + t: rows g and g + 8,
// columns 2t and 2t + 1).
//
// bf16: mma.sync.m16n8k16, bf16 operands, f32 accumulators; fragments by
// ldmatrix(.trans) (the layouts are in mma.cuh). P goes from the
// accumulators to the A operand packed to bf16, rounded to nearest even:
// that is the JAX kernels' `p.astype(bf16)` / `ds.astype(bf16)`.
//
// f32: 3xTF32 on mma.sync.m16n8k8.tf32. Each operand is split a = a_hi +
// a_lo with a_hi = tf32(a), a_lo = tf32(a - a_hi), and a product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi (the small terms first), summed in f32;
// the dropped a_lo b_lo is below 2^-22 of the product. Fragments are read
// with 32-bit (and 64-bit) ld.shared in the m16n8k8 layout:
//   A (16 x 8): a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4)
//   B (8 x 8):  b0 = (k t, n g), b1 = (k t + 4, n g)
// A C fragment holds columns 2t, 2t + 1, not t, t + 4: mma_rt feeds it as
// the A operand with the k index permuted (logical k t <-> column 2t, k t + 4
// <-> column 2t + 1) and reads B in the same permuted order, one 64-bit load.
// The tensor cores add into an f32 accumulator without rounding to nearest:
// a chain of 600 such adds (K6's dQ, dK, dV over 1600 tokens) drifts by up
// to 4e-5 of the sum, twice the f32 tolerance's share (measured on the H100).
// So mma_rt sums each call's products (3 x 8 NK adds) in a fresh accumulator
// and adds that to the running one with f32 adds.
// f32 rows are padded so that the stride is 8 or 24 (mod 32) words: the
// 32-bit reads of mma_tn and the 64-bit reads of mma_rt hit distinct banks.
#pragma once

#include "mma.cuh"

namespace lw {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));  // exact difference, rounded to tf32
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of four f32 values, split
struct Tf32A {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ Tf32A(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};

// B fragment of two f32 values, split
struct Tf32B {
  uint32_t hi0, lo0, hi1, lo1;
  __device__ __forceinline__ Tf32B(float b0, float b1) {
    split_tf32(b0, hi0, lo0);
    split_tf32(b1, hi1, lo1);
  }
};

// c += a b in 3xTF32
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Tf32A& a, const Tf32B& b) {
  mma_tf32(c, a.lo, b.hi0, b.hi1);
  mma_tf32(c, a.hi, b.lo0, b.lo1);
  mma_tf32(c, a.hi, b.hi0, b.hi1);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// ---- mma_tn: acc (16 x 8 NT) += A^T B over kK rows; A rows [k][m0..m0+16),
// B rows [k][n0..n0 + 8 NT); only the first `live` 8-column tiles (even
// counts in bf16) are computed, the rest stay as they are ----------------------

template <int kK, int NT>
__device__ __forceinline__ void mma_tn(float (&acc)[NT][4], const bf16* a, int sa, const bf16* b,
                                       int sb, int m0, int n0, int lane, int live = NT) {
  const int r8 = lane % 8, mat = lane / 8;
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4_trans(af, &a[(16 * kk + r8 + 8 * (mat >> 1)) * sa + m0 + 8 * (mat & 1)]);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (2 * np < live) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, &b[(16 * kk + r8 + 8 * (mat & 1)) * sb + n0 + 16 * np + 8 * (mat >> 1)]);
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }
}

template <int kK, int NT>
__device__ __forceinline__ void mma_tn(float (&acc)[NT][4], const float* a, int sa, const float* b,
                                       int sb, int m0, int n0, int lane, int live = NT) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kK / 8; ++kk) {
    const float* ar = a + (8 * kk + t) * sa + m0 + g;
    const Tf32A af(ar[0], ar[8], ar[4 * sa], ar[4 * sa + 8]);
    const float* br = b + (8 * kk + t) * sb + n0 + g;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < live) mma_3xtf32(acc[n], af, Tf32B(br[8 * n], br[4 * sb + 8 * n]));
  }
}

// ---- mma_rt: acc (16 x 8 NB) += P B^T; P (16 x 8 NK) in C fragments, B rows
// [n0 + n][k0..k0 + 8 NK) for n < 8 NB; only the first `live` 8-column tiles
// of P (even counts in bf16) are read ------------------------------------------

template <int NK, int NB>
__device__ __forceinline__ void mma_rt(float (&acc)[NB][4], const float (&p)[NK][4],
                                       const bf16* b, int sb, int k0, int n0, int lane,
                                       int live = NK) {
  const int r8 = lane % 8, mat = lane / 8;
#pragma unroll
  for (int kk = 0; kk < NK / 2; ++kk) {
    if (2 * kk >= live) break;
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, &b[(n0 + 16 * np + r8 + 8 * (mat >> 1)) * sb + k0 + 16 * kk + 8 * (mat & 1)]);
      mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
    }
  }
}

template <int NK, int NB>
__device__ __forceinline__ void mma_rt(float (&acc)[NB][4], const float (&p)[NK][4],
                                       const float* b, int sb, int k0, int n0, int lane,
                                       int live = NK) {
  const int g = lane / 4, t = lane % 4;
  float part[NB][4];  // this call's sum, added to acc in f32 (see above)
  zero(part);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    if (kk >= live) break;
    const Tf32A pa(p[kk][0], p[kk][2], p[kk][1], p[kk][3]);  // k order 2t, 2t + 1
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float2 bb =
          *reinterpret_cast<const float2*>(&b[(n0 + 8 * n + g) * sb + k0 + 8 * kk + 2 * t]);
      mma_3xtf32(part[n], pa, Tf32B(bb.x, bb.y));
    }
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
}

// ---- mma_nn: acc[MT][2] (16 MT x 16) += A B over `k_rows` (a multiple of 16)
// rows of k; A rows [m][k] for m < 16 MT, B rows [k][n0..n0 + 16) ---------------

template <int MT, int kMaxK>
__device__ __forceinline__ void mma_nn(float (&acc)[MT][2][4], const bf16* a, int sa,
                                       const bf16* b, int sb, int n0, int k_rows, int lane) {
  const int r8 = lane % 8, mat = lane / 8;
#pragma unroll
  for (int kk = 0; kk < kMaxK / 16; ++kk) {
    if (16 * kk < k_rows) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, &b[(16 * kk + r8 + 8 * (mat & 1)) * sb + n0 + 8 * (mat >> 1)]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, &a[(16 * mt + r8 + 8 * (mat & 1)) * sa + 16 * kk + 8 * (mat >> 1)]);
        mma_bf16(acc[mt][0], af, bf[0], bf[1]);
        mma_bf16(acc[mt][1], af, bf[2], bf[3]);
      }
    }
  }
}

template <int MT, int kMaxK>
__device__ __forceinline__ void mma_nn(float (&acc)[MT][2][4], const float* a, int sa,
                                       const float* b, int sb, int n0, int k_rows, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kMaxK / 8; ++kk) {
    if (8 * kk < k_rows) {
      const float* br = b + (8 * kk + t) * sb + n0 + g;
      const Tf32B b0(br[0], br[4 * sb]), b1(br[8], br[4 * sb + 8]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* ar = a + (16 * mt + g) * sa + 8 * kk + t;
        const Tf32A af(ar[0], ar[8 * sa], ar[4], ar[8 * sa + 4]);
        mma_3xtf32(acc[mt][0], af, b0);
        mma_3xtf32(acc[mt][1], af, b1);
      }
    }
  }
}

// shared row stride (elements) for rows of `cols` tokens (a multiple of 16):
// bf16 an odd number of 16-byte units (ldmatrix's eight row addresses in
// eight bank groups), f32 8 or 24 words mod 32 (see above)
__host__ __device__ __forceinline__ constexpr int tile_stride(int cols) {
  return cols + 8;
}

}  // namespace lw
