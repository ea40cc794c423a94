// Shared helpers for the port's kernels: dtype conversion through the
// intrinsics, a kernel's attributes, and the error-string export every
// library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>  // INFINITY

namespace lw {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

constexpr float kLog2e = 1.4426950408889634f;

// The pixel coordinate x size - 0.5 of a normalized sampling location,
// rounded as PyTorch, and so the plain versions, round it: the product, then
// the difference. nvcc would contract the two into one fused multiply-add,
// whose single rounding can put a point that lies within an ulp of a grid line
// on the other side of it: other corners than the plain version's, and, in a
// backward, a d(loc) that jumps by size w <g, second difference of the values>.
__device__ __forceinline__ float pixel(float x, int size) {
  return __fsub_rn(__fmul_rn(x, static_cast<float>(size)), 0.5f);
}

// attrs[0..2]: registers a thread, local (spilled) bytes a thread, static
// shared bytes a block of the kernel `fn`
inline int kernel_attributes(const void* fn, int* attrs) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return err;
  attrs[0] = a.numRegs;
  attrs[1] = static_cast<int>(a.localSizeBytes);
  attrs[2] = static_cast<int>(a.sharedSizeBytes);
  return cudaSuccess;
}

}  // namespace lw

extern "C" const char* lw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
