// K5 and K10 (backward): backward of the deformable sampling over per-level
// head-major panels (K5) or over the row-major value (B, Len_in, H, D) (K10).
//
// K5 replaces lwdetr_tpu/ops/deform_attn.py::_sep_bwd_kernel (launched from
// _sep_bwd) together with the VJP of _prep_separable, which turns that
// kernel's d(y-weights) and d(x-weights) into gradients of the sampling
// locations and attention weights. K10's backward replaces ::_dvalue_kernel
// and ::_dweight_kernel (launched from _sample_bwd) together with the VJP of
// _prep_indices_weights. One device body serves both layouts over the layout
// policy of the forward (deform_attn_sep.cu); each kernel has its own entry
// symbol. For the forward
//   out[b, q, hD + d] = sum_{l, p} w[b, q, h, l, p]
//                       * bilinear(panel_l[b, h, :, :, d], loc[b, q, h, l, p])
// and g = d(out)[b, q, hD:(h+1)D], with the four corner values v00, v01, v10,
// v11 (row y0 / y0 + 1, column x0 / x0 + 1; a corner outside the map is 0)
// and the fractions fx, fy of a point, it computes
//   d(w)      = <g, (1-fy)(1-fx) v00 + (1-fy) fx v01 + fy (1-fx) v10 + fy fx v11>
//   d(loc_x)  = W_l w <g, (1-fy)(v01 - v00) + fy (v11 - v10)>
//   d(loc_y)  = H_l w <g, (1-fx)(v10 - v00) + fx (v11 - v01)>
//   d(panel_l)[b, h, corner, :] += w * corner weight * g      (corners in the map)
// floor carries no gradient, and a point outside (-1, W) x (-1, H), or NaN,
// gives zeros, as in the forward.
//
// The TPU kernel rebuilds the forward's one-hot row and column masks per
// query block and turns the scatter into matmuls against them, accumulating
// d(value) in f32 VMEM scratch over the query blocks of a sequential grid.
// None of that is carried over: here the scatter is an atomic add.
//
// What bounds it on an H100: per (b, q, h) it reads 4 L P corners of D
// channels and adds into as many, so it is bound by bytes, and in practice
// by the atomic adds into d(panel) (Q L P points spread over H_l W_l
// positions per head: about ten adds a position at Q = 3900, P = 2 on a
// 40 x 40 map). Design: the thread layout of the forward, each thread owning
// 4 neighbouring channels of one (b, q, h), so a corner is read as one
// 16-byte (f32) or 8-byte (bf16) vector and the D / 4 threads of a head are
// neighbouring lanes of one warp. Each lane takes the dot products <g, v> of
// its 4 channels, the lanes of a head sum them with shuffles, and the first
// lane writes d(loc) and d(w) (every element, so they need no zeroing). d(panel)
// is accumulated with f32 atomicAdd into buffers the caller zeroed, f32 also
// for bf16 panels (rounded once by the caller): the order of the adds is not
// fixed, so two runs differ in the last f32 bits. All lanes of a warp run the
// same L x P loop with no early exit, so the shuffles are convergent; a thread
// past the end carries zeros.
#include "deform_layout.cuh"

namespace {

using lw::kMaxLevels;
using lw::kVec;
using lw::load4;
using lw::PanelLayout;
using lw::RowMajorLayout;

constexpr int kThreads = 256;

struct Levels {
  int n;
  int len_in;  // positions of all levels together (the row-major layout's batch stride)
  int h[kMaxLevels];
  int w[kMaxLevels];
  const void* panel[kMaxLevels];  // level l's first element
  float* dpanel[kMaxLevels];      // and its gradient's
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

__device__ __forceinline__ void scatter4(float* p, float c, float4 g) {
  atomicAdd(p, c * g.x);
  atomicAdd(p + 1, c * g.y);
  atomicAdd(p + 2, c * g.z);
  atomicAdd(p + 3, c * g.w);
}

template <typename T, typename Layout>
__global__ void __launch_bounds__(kThreads)
deform_attn_sep_bwd_kernel(const float* __restrict__ loc, const float* __restrict__ attw,
                           const T* __restrict__ dout, float* __restrict__ dloc,
                           float* __restrict__ dattw, int Q, int H, int D, int P, Levels lv,
                           size_t total) {
  const size_t tid = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = tid < total;  // total = B Q C / kVec
  const size_t t = active ? tid : 0;  // an idle thread shadows thread 0 and writes nothing
  const int C = H * D;
  const int vec_per_row = C / kVec;
  const int c = static_cast<int>(t % vec_per_row) * kVec;  // first of this thread's channels
  const size_t bq = t / vec_per_row;
  const int b = static_cast<int>(bq / Q);
  const int h = c / D;
  const int d = c - h * D;
  const int lanes = D / kVec;  // lanes of one head: 4 or 8, aligned in the warp

  const size_t bqh = bq * H + h;
  const float* lp = loc + bqh * lv.n * P * 2;
  const float* wp = attw + bqh * lv.n * P;
  float* dlp = dloc + bqh * lv.n * P * 2;
  float* dwp = dattw + bqh * lv.n * P;
  const float4 g = active ? load4(dout + bq * C + c) : make_float4(0.f, 0.f, 0.f, 0.f);

  for (int l = 0; l < lv.n; ++l) {
    const int Wl = lv.w[l];
    const int Hl = lv.h[l];
    const int xs = Layout::x_stride(H, D);           // elements between neighbouring positions
    const size_t row = static_cast<size_t>(Wl) * xs;  // elements per map row
    const size_t off = Layout::origin(b, h, H, D, Hl, Wl, lv.len_in) + d;
    const T* map = static_cast<const T*>(lv.panel[l]) + off;
    float* dmap = lv.dpanel[l] + off;
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const float px = lp[2 * k] * Wl - 0.5f;
      const float py = lp[2 * k + 1] * Hl - 0.5f;
      const float aw = wp[k];
      // no corner of a point outside (-1, W) x (-1, H) is in bounds; this
      // also drops NaN and keeps the integer casts below in range
      const bool inside = px > -1.f && px < Wl && py > -1.f && py < Hl;
      float fx = 0.f, fy = 0.f;
      float d00 = 0.f, d01 = 0.f, d10 = 0.f, d11 = 0.f;
      if (inside) {
        const float x0f = floorf(px);
        const float y0f = floorf(py);
        fx = px - x0f;
        fy = py - y0f;
        const int x0 = static_cast<int>(x0f);
        const int y0 = static_cast<int>(y0f);
        const bool x0ok = x0 >= 0, x1ok = x0 + 1 < Wl;
        const bool y0ok = y0 >= 0, y1ok = y0 + 1 < Hl;
        // x0 >= -1 and y0 >= -1 here; a pointer is used only for a corner in bounds
        const ptrdiff_t at = y0 * static_cast<ptrdiff_t>(row) + x0 * xs;
        if (y0ok && x0ok) {
          d00 = dot4(g, load4(map + at));
          if (active) scatter4(dmap + at, aw * (1.f - fy) * (1.f - fx), g);
        }
        if (y0ok && x1ok) {
          d01 = dot4(g, load4(map + at + xs));
          if (active) scatter4(dmap + at + xs, aw * (1.f - fy) * fx, g);
        }
        if (y1ok && x0ok) {
          d10 = dot4(g, load4(map + at + row));
          if (active) scatter4(dmap + at + row, aw * fy * (1.f - fx), g);
        }
        if (y1ok && x1ok) {
          d11 = dot4(g, load4(map + at + row + xs));
          if (active) scatter4(dmap + at + row + xs, aw * fy * fx, g);
        }
      }
      // sum the four dot products over the lanes of this head
      for (int s = 1; s < lanes; s <<= 1) {
        d00 += __shfl_xor_sync(0xffffffffu, d00, s);
        d01 += __shfl_xor_sync(0xffffffffu, d01, s);
        d10 += __shfl_xor_sync(0xffffffffu, d10, s);
        d11 += __shfl_xor_sync(0xffffffffu, d11, s);
      }
      if (active && d == 0) {
        dwp[k] = (1.f - fy) * ((1.f - fx) * d00 + fx * d01) + fy * ((1.f - fx) * d10 + fx * d11);
        dlp[2 * k] = Wl * aw * ((1.f - fy) * (d01 - d00) + fy * (d11 - d10));
        dlp[2 * k + 1] = Hl * aw * ((1.f - fx) * (d10 - d00) + fx * (d11 - d01));
      }
    }
  }
}

template <typename Layout>
int launch(const Levels& lv, const void* loc, const void* attw, const void* dout, void* dloc,
           void* dattw, int B, int Q, int num_heads, int head_dim, int n_points, int dtype,
           void* stream) {
  const size_t total = static_cast<size_t>(B) * Q * num_heads * head_dim / kVec;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(loc);
  const float* wp = static_cast<const float*>(attw);
  float* dlp = static_cast<float*>(dloc);
  float* dwp = static_cast<float*>(dattw);
  if (dtype == lw::kFloat32) {
    deform_attn_sep_bwd_kernel<float, Layout><<<blocks, kThreads, 0, st>>>(
        lp, wp, static_cast<const float*>(dout), dlp, dwp, Q, num_heads, head_dim, n_points, lv,
        total);
  } else if (dtype == lw::kBFloat16) {
    deform_attn_sep_bwd_kernel<__nv_bfloat16, Layout><<<blocks, kThreads, 0, st>>>(
        lp, wp, static_cast<const __nv_bfloat16*>(dout), dlp, dwp, Q, num_heads, head_dim,
        n_points, lv, total);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the lanes of a head must be a power of two that divides a warp
bool sizes_ok(int B, int Q, int num_heads, int head_dim, int n_levels, int n_points) {
  return B >= 1 && Q >= 1 && num_heads >= 1 && (head_dim == 16 || head_dim == 32) &&
         n_points >= 1 && n_levels >= 1 && n_levels <= kMaxLevels;
}

}  // namespace

// K5. panels[l]: level l's values (B, H, h[l], w[l] * D) in `dtype`, contiguous,
// 16-byte aligned; dpanels[l]: its gradient, f32, same shape, zeroed by the
// caller; level_hw: (h, w) per level; loc (B, Q, H, L, P, 2) and attw
// (B, Q, H, L, P) f32 with gradients dloc, dattw of the same shapes; dout
// (B, Q, H * D) in `dtype`. `panels`, `dpanels` and `level_hw` are host arrays.
extern "C" int lw_deform_attn_sep_bwd(const void* const* panels, void* const* dpanels,
                                      const int* level_hw, const void* loc, const void* attw,
                                      const void* dout, void* dloc, void* dattw, int B, int Q,
                                      int num_heads, int head_dim, int n_levels, int n_points,
                                      int dtype, void* stream) {
  if (!sizes_ok(B, Q, num_heads, head_dim, n_levels, n_points)) return cudaErrorInvalidValue;
  Levels lv;
  lv.n = n_levels;
  lv.len_in = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    lv.panel[l] = panels[l];
    lv.dpanel[l] = static_cast<float*>(dpanels[l]);
    if (lv.h[l] < 1 || lv.w[l] < 1 || lv.panel[l] == nullptr || lv.dpanel[l] == nullptr ||
        reinterpret_cast<size_t>(lv.panel[l]) % 16 != 0)
      return cudaErrorInvalidValue;
  }
  return launch<PanelLayout>(lv, loc, attw, dout, dloc, dattw, B, Q, num_heads, head_dim,
                             n_points, dtype, stream);
}

// K10, backward. value (B, len_in, H, D) in `dtype`, contiguous, 16-byte
// aligned, the levels one after another along len_in; dvalue: its gradient,
// f32, same shape, zeroed by the caller; the rest as for K5. `level_hw` is a
// host array.
extern "C" int lw_deform_attn_rowmajor_bwd(const void* value, void* dvalue, const int* level_hw,
                                           const void* loc, const void* attw, const void* dout,
                                           void* dloc, void* dattw, int B, int len_in, int Q,
                                           int num_heads, int head_dim, int n_levels,
                                           int n_points, int dtype, void* stream) {
  if (!sizes_ok(B, Q, num_heads, head_dim, n_levels, n_points) || value == nullptr ||
      dvalue == nullptr || reinterpret_cast<size_t>(value) % 16 != 0 ||
      (dtype != lw::kFloat32 && dtype != lw::kBFloat16))
    return cudaErrorInvalidValue;
  const size_t position = static_cast<size_t>(num_heads) * head_dim;  // elements
  const size_t isz = dtype == lw::kFloat32 ? sizeof(float) : sizeof(__nv_bfloat16);
  Levels lv;
  lv.n = n_levels;
  lv.len_in = len_in;
  long long start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    if (lv.h[l] < 1 || lv.w[l] < 1) return cudaErrorInvalidValue;
    lv.panel[l] = static_cast<const char*>(value) + start * position * isz;
    lv.dpanel[l] = static_cast<float*>(dvalue) + start * position;
    start += static_cast<long long>(lv.h[l]) * lv.w[l];
  }
  if (start != len_in) return cudaErrorInvalidValue;
  return launch<RowMajorLayout>(lv, loc, attw, dout, dloc, dattw, B, Q, num_heads, head_dim,
                                n_points, dtype, stream);
}
