// What the samplers that keep a position's D channels contiguous share
// (deform_attn_sep.cu, deform_attn_sep_bwd.cu): the vector load and the two
// value layouts, each a policy that says where the (b, h) map of a level
// starts, from the level's first element, and how far apart two neighbouring
// positions lie, in elements.
#pragma once

#include "common.cuh"

namespace lw {

constexpr int kMaxLevels = 4;
constexpr int kVec = 4;  // channels per thread

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // a bf16 is the high half of an f32
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

struct PanelLayout {  // one array per level, (B, H, H_l, W_l * D)
  static __device__ __forceinline__ size_t origin(int b, int h, int H, int D, int Hl, int Wl,
                                                  int len_in) {
    return (static_cast<size_t>(b) * H + h) * Hl * Wl * D;
  }
  static __device__ __forceinline__ int x_stride(int H, int D) { return D; }
};

// one array (B, Len_in, H, D), the levels one after another along Len_in:
// level l's first element is start_l positions in
struct RowMajorLayout {
  static __device__ __forceinline__ size_t origin(int b, int h, int H, int D, int Hl, int Wl,
                                                  int len_in) {
    return (static_cast<size_t>(b) * len_in * H + h) * D;
  }
  static __device__ __forceinline__ int x_stride(int H, int D) { return H * D; }
};

}  // namespace lw
