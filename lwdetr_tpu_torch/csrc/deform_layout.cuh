// What the samplers share: the vector load and the two value layouts of the
// samplers that keep a position's D channels contiguous (deform_attn_sep.cu,
// deform_attn_sep_bwd.cu), each a policy that says where the (b, h) map of a
// level starts, from the level's first element, and how far apart two
// neighbouring positions lie, in elements; and the arithmetic of the
// backwards (deform_attn_sep_bwd.cu, deform_attn_bwd.cu): where a point falls,
// the dot products of its corners with d(out), and the float4 reduction of a
// corner's gradient.
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

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
// s a + t b
__device__ __forceinline__ float4 mix4(float s, float4 a, float t, float4 b) {
  return make_float4(fmaf(s, a.x, t * b.x), fmaf(s, a.y, t * b.y), fmaf(s, a.z, t * b.z),
                     fmaf(s, a.w, t * b.w));
}

// a sampling point of one level: where it falls, its fractions and weight
struct Point {
  bool inside;  // some corner may be in the map; false also for NaN
  int x0, y0;   // upper-left corner, >= -1 when inside
  float fx, fy, aw;
};

__device__ __forceinline__ Point point_at(const float* loc, const float* attw, size_t pt, int Wl,
                                          int Hl) {
  Point pnt;
  const float px = pixel(loc[2 * pt], Wl);
  const float py = pixel(loc[2 * pt + 1], Hl);
  // no corner of a point outside (-1, W) x (-1, H) is in bounds; this also
  // drops NaN and keeps the integer casts below in range
  pnt.inside = px > -1.f && px < Wl && py > -1.f && py < Hl;
  const float x0f = pnt.inside ? floorf(px) : 0.f;
  const float y0f = pnt.inside ? floorf(py) : 0.f;
  pnt.x0 = static_cast<int>(x0f);
  pnt.y0 = static_cast<int>(y0f);
  pnt.fx = pnt.inside ? px - x0f : 0.f;
  pnt.fy = pnt.inside ? py - y0f : 0.f;
  pnt.aw = attw[pt];
  return pnt;
}

// Over 4 channels, with g = d(out) and the corner values v00, v01, v10, v11
// (0 outside the map): sw = <g, bilinear value>, sx = <g, d/dx>, sy = <g, d/dy>.
// d(loc) differences the corner values before the one dot product:
// neighbouring values are close, and their difference is exact in f32
// (Sterbenz), where a difference of two dot products <g, v01> - <g, v00>
// would cancel and keep the rounding error of each.
__device__ __forceinline__ void corner_dots(float4 g, float4 v00, float4 v01, float4 v10,
                                            float4 v11, float fx, float fy, float& sw, float& sx,
                                            float& sy) {
  sw = dot4(g, mix4(1.f - fy, mix4(1.f - fx, v00, fx, v01), fy, mix4(1.f - fx, v10, fx, v11)));
  sx = dot4(g, mix4(1.f - fy, sub4(v01, v00), fy, sub4(v11, v10)));
  sy = dot4(g, mix4(1.f - fx, sub4(v10, v00), fx, sub4(v11, v01)));
}

// d(value)[4 channels at p] += c g: one vector reduction (atomicAdd on
// float4, sm_90) into f32 device memory; p is 16-byte aligned
__device__ __forceinline__ void add4(float* p, float c, float4 g) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(c * g.x, c * g.y, c * g.z, c * g.w));
}

}  // namespace lw
