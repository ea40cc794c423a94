// Tensor-core building blocks for the bf16 attention kernels (K1, K2, K9):
// asynchronous copies into shared memory, ldmatrix, mma.sync m16n8k16 with
// bf16 operands and f32 accumulators, and the fast exp2.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 g + t):
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..), a2 = (g, 2t + 8..),
//                           a3 = (g + 8, 2t + 8..)
//   B (16 x 8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g)
//   C (16 x 8, f32):        c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..2t+1)
// The attention operands all sit in shared memory as [channel d][token] rows
// (the channel-major layout of qkv, tokens contiguous): ldmatrix.trans of
// such a tile gives the A fragment of Q and the B fragment of K^T, a plain
// ldmatrix gives the B fragment of V, and the C fragments of two adjacent
// score tiles are, packed to bf16, the A fragment of P.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace lw {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy kBytes (4, 8 or 16) from global to shared memory without blocking;
// with `valid` false nothing is read and the kBytes are zero-filled (`src`
// must still be an aligned address).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(kBytes), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copy columns [c0, c0 + cols) of kRows rows of a bf16 or f32 array with row
// stride n (elements) into shared memory rows of stride `stride`, with
// zeros past column n. kVec elements a copy: a 16-byte or an 8-byte
// cp.async (bf16: 8 or 4; f32: 4 or 2), or for kVec = 1 a 4-byte cp.async
// (f32) or plain loads (bf16 rows that are not 8-byte aligned); the caller
// picks it from n and the base pointer (`copy_vec`), so that every vector lies
// wholly inside or wholly past the row. `cols` is a multiple of 8, and
// nthreads >= cols / kVec. Each thread keeps one column of vectors and
// walks the rows, nthreads / (cols / kVec) rows apart: where `cols` is not a
// compile-time constant (K1, K9) that is two integer divisions a thread, not
// one a copy in front of the first load. Plain loads go in batches of
// kBatch rows, all loads before the stores, so that their latencies overlap.
template <int kVec, int kRows, typename T>
__device__ __forceinline__ void load_rows(T* dst, int stride, const T* src, int n, int c0,
                                          int cols, int tid, int nthreads) {
  constexpr int kBytes = kVec * static_cast<int>(sizeof(T));
  const int per_row = cols / kVec;
  const int row_step = nthreads / per_row;
  const int r0 = tid / per_row;
  if (r0 >= row_step) return;  // past the last whole set of rows
  const int c = (tid - r0 * per_row) * kVec;
  const bool ok = c0 + c < n;
  const int col = ok ? c0 + c : 0;
  if constexpr (kBytes < 4) {
    constexpr int kBatch = 8;
    for (int r = r0; r < kRows; r += kBatch * row_step) {
      T v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int ri = r + i * row_step;
        v[i] = ok && ri < kRows ? src[static_cast<size_t>(ri) * n + col] : __ushort_as_bfloat16(0);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int ri = r + i * row_step;
        if (ri < kRows) dst[ri * stride + c] = v[i];
      }
    }
  } else {
    for (int r = r0; r < kRows; r += row_step)
      cp_async<kBytes>(dst + r * stride + c, src + static_cast<size_t>(r) * n + col, ok);
  }
}

// load_rows with the copy width `vec` (elements: the 16-byte, the 8-byte or the
// one-element case) chosen at run time: one kernel takes every row alignment,
// for kernels that load a few tiles and would otherwise be built three times
template <int kRows, typename T>
__device__ __forceinline__ void load_rows_vec(int vec, T* dst, int stride, const T* src, int n,
                                              int c0, int cols, int tid, int nthreads) {
  constexpr int v16 = 16 / sizeof(T), v8 = 8 / sizeof(T);
  if (vec == v16)
    load_rows<v16, kRows>(dst, stride, src, n, c0, cols, tid, nthreads);
  else if (vec == v8)
    load_rows<v8, kRows>(dst, stride, src, n, c0, cols, tid, nthreads);
  else
    load_rows<1, kRows>(dst, stride, src, n, c0, cols, tid, nthreads);
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// c += a b on the tensor cores: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to nearest even, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x + b on two packed bf16 values, the exact sum rounded once to nearest
// even (add.rn.bf16x2)
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t x, __nv_bfloat162 b) {
  const __nv_bfloat162 sum = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&x), b);
  return *reinterpret_cast<const uint32_t*>(&sum);
}

// 2^x on the special-function unit (MUFU.EX2), one instruction: relative
// error ~2^-22, far below the bf16 rounding that follows; 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max / sum over the four lanes that hold one row of a C fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The widest copy, in elements of `elem_bytes` (2: bf16, 4: f32), that keeps
// every row of a (rows, n) array at `base` aligned: 16 bytes when n fills whole
// 16-byte units and `base` is 16-byte aligned, 8 bytes likewise, else one
// element. Decided on the host from the shape and the pointer, never by a fault.
inline int copy_vec(const void* base, int n, int elem_bytes) {
  const auto p = reinterpret_cast<uintptr_t>(base);
  const int v16 = 16 / elem_bytes, v8 = 8 / elem_bytes;
  if (n % v16 == 0 && p % 16 == 0) return v16;
  if (n % v8 == 0 && p % 8 == 0) return v8;
  return 1;
}

inline int bf16_vec(const void* base, int n) { return copy_vec(base, n, 2); }

}  // namespace lw
