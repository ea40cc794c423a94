// K8: backward of the channel-major deformable attention sampling.
//
// Replaces lwdetr_tpu/ops/deform_attn.py::_dvalue_cm_kernel and
// ::_dweight_cm_kernel (launched from _sample_cm_bwd) together with the VJP
// of _prep_indices_weights_lanes, which turns the second kernel's d(fused
// corner weights) into gradients of the sampling locations and attention
// weights. For the forward (deform_attn.cu)
//   out[b, hD + d, q] = sum_{l, p} w[b, q, h, l, p]
//                       * bilinear(value_t[b, hD + d, level l], loc[b, q, h, l, p])
// and g[d] = d(out)[b, hD + d, q], with the four corner values v00, v01, v10,
// v11 of a point (row y0 / y0 + 1, column x0 / x0 + 1; a corner outside the
// map is 0), its fractions fx, fy, and <g, v> the sum over the head's D
// channels, it computes
//   d(w)       = <g, (1-fy)(1-fx) v00 + (1-fy) fx v01 + fy (1-fx) v10 + fy fx v11>
//   d(loc_x)   = W_l w <g, (1-fy)(v01 - v00) + fy (v11 - v10)>
//   d(loc_y)   = H_l w <g, (1-fx)(v10 - v00) + fx (v11 - v01)>
//   d(value_t)[b, hD + d, corner] += w * corner weight * g[d]   (corners in the map)
// floor carries no gradient, and a point outside (-1, W) x (-1, H), or NaN,
// gives zeros to all three, as it gives nothing to the forward.
//
// The TPU pair rebuilds the (q, n) one-hot sampling matrix per block and
// takes d(value) and d(corner weights) as two matmuls against it, with
// d(value) accumulated in f32 VMEM scratch over a sequential grid. None of
// that is carried over: the scatter is an atomic add.
//
// What bounds it on an H100: per (b, q, h) it reads 4 L P corners of D
// channels and adds into as many, with next to no arithmetic: bytes, and in
// practice the atomic adds into d(value_t). In this layout the D channels of
// one corner lie Len_in elements apart and d(out) is contiguous along q, so
// the thread map of the panel backward (4 neighbouring channels a thread, the
// lanes of a head summing with shuffles) does not fit. Thread map: one
// thread per (b, h, q) with q fastest, each walking the D channels of its
// head in a loop. The threads of a warp then read d(out)[b, hD + d, q..q+31]
// as one contiguous segment at every step of the loop, gather from and add
// into one channel row of Len_in elements at a time (6.4 KB in f32 at 1600
// positions: the row stays in L1 / L2 while the warp's 32 x 4 L P corners hit
// it), and each thread keeps its own three dot products in registers, so no
// sum crosses threads and d(loc), d(w) are written by the thread that formed
// them (every element, so they need no zeroing). d(value_t) is accumulated
// with f32 atomicAdd into a buffer the caller zeroed, f32 also for bf16
// values (rounded once by the caller): the order of the adds is not fixed, so
// two runs differ in the last f32 bits.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kThreads = 128;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_attn_cm_bwd_kernel(const T* __restrict__ value_t, const float* __restrict__ loc,
                          const float* __restrict__ attw, const T* __restrict__ dout,
                          float* __restrict__ dvalue_t, float* __restrict__ dloc,
                          float* __restrict__ dattw, int C, int len_in, int Q, int H, int P,
                          Levels lv, size_t total) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;  // total = B H Q; no thread waits on another
  const int q = static_cast<int>(t % Q);
  const size_t bh = t / Q;
  const int h = static_cast<int>(bh % H);
  const int b = static_cast<int>(bh / H);
  const int D = C / H;

  const size_t chan0 = static_cast<size_t>(b) * C + static_cast<size_t>(h) * D;
  const T* vrows = value_t + chan0 * len_in;   // the head's D channel rows
  float* dvrows = dvalue_t + chan0 * len_in;
  const T* g = dout + chan0 * Q + q;           // g[d] at g[d * Q]
  const size_t bqh = (static_cast<size_t>(b) * Q + q) * H + h;
  const float* lp = loc + bqh * lv.n * P * 2;
  const float* wp = attw + bqh * lv.n * P;
  float* dlp = dloc + bqh * lv.n * P * 2;
  float* dwp = dattw + bqh * lv.n * P;

  for (int l = 0; l < lv.n; ++l) {
    const int Wl = lv.w[l];
    const int Hl = lv.h[l];
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const float px = lw::pixel(lp[2 * k], Wl);
      const float py = lw::pixel(lp[2 * k + 1], Hl);
      const float aw = wp[k];
      float fx = 0.f, fy = 0.f;
      float sw = 0.f, sx = 0.f, sy = 0.f;  // <g, value>, <g, d/dx>, <g, d/dy> over the head
      // no corner of a point outside (-1, W) x (-1, H) is in bounds; this
      // also drops NaN and keeps the integer casts below in range
      if (px > -1.f && px < Wl && py > -1.f && py < Hl) {
        const float x0f = floorf(px);
        const float y0f = floorf(py);
        fx = px - x0f;
        fy = py - y0f;
        const int x0 = static_cast<int>(x0f);
        const int y0 = static_cast<int>(y0f);
        const bool x0ok = x0 >= 0, x1ok = x0 + 1 < Wl;
        const bool y0ok = y0 >= 0, y1ok = y0 + 1 < Hl;
        const bool ok00 = y0ok && x0ok, ok01 = y0ok && x1ok;
        const bool ok10 = y1ok && x0ok, ok11 = y1ok && x1ok;
        // x0 >= -1 and y0 >= -1 here; an index is used only for a corner in bounds
        const ptrdiff_t at = lv.start[l] + y0 * static_cast<ptrdiff_t>(Wl) + x0;
        const float c00 = aw * (1.f - fy) * (1.f - fx), c01 = aw * (1.f - fy) * fx;
        const float c10 = aw * fy * (1.f - fx), c11 = aw * fy * fx;
        for (int d = 0; d < D; ++d) {
          const float gd = lw::to_f32(g[static_cast<size_t>(d) * Q]);
          const T* v = vrows + static_cast<size_t>(d) * len_in + at;
          float* dv = dvrows + static_cast<size_t>(d) * len_in + at;
          float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
          if (ok00) {
            v00 = lw::to_f32(v[0]);
            atomicAdd(dv, c00 * gd);
          }
          if (ok01) {
            v01 = lw::to_f32(v[1]);
            atomicAdd(dv + 1, c01 * gd);
          }
          if (ok10) {
            v10 = lw::to_f32(v[Wl]);
            atomicAdd(dv + Wl, c10 * gd);
          }
          if (ok11) {
            v11 = lw::to_f32(v[Wl + 1]);
            atomicAdd(dv + Wl + 1, c11 * gd);
          }
          // d(loc) from the differenced corners (exact for close values), not
          // from a difference of two dot products, which would cancel
          sw = fmaf(gd, (1.f - fy) * ((1.f - fx) * v00 + fx * v01)
                            + fy * ((1.f - fx) * v10 + fx * v11), sw);
          sx = fmaf(gd, (1.f - fy) * (v01 - v00) + fy * (v11 - v10), sx);
          sy = fmaf(gd, (1.f - fx) * (v10 - v00) + fx * (v11 - v01), sy);
        }
      }
      dwp[k] = sw;
      dlp[2 * k] = Wl * aw * sx;
      dlp[2 * k + 1] = Hl * aw * sy;
    }
  }
}

}  // namespace

// value_t (B, C, len_in) and dout (B, C, Q) in `dtype`; dvalue_t (B, C, len_in)
// f32, zeroed by the caller; loc (B, Q, H, L, P, 2) and attw (B, Q, H, L, P)
// f32 with gradients dloc, dattw of the same shapes; level l spans
// value_t[..., start[l] : start[l] + h[l] w[l]]. All contiguous;
// `level_hw_start` is a host array.
extern "C" int lw_deform_attn_cm_bwd(const void* value_t, const void* loc, const void* attw,
                                     const void* dout, void* dvalue_t, void* dloc, void* dattw,
                                     int B, int C, int len_in, int Q, int num_heads,
                                     int n_levels, int n_points, const int* level_hw_start,
                                     int dtype, void* stream) {
  if (B < 1 || C < 1 || Q < 1 || num_heads < 1 || C % num_heads != 0 || n_points < 1 ||
      n_levels < 1 || n_levels > kMaxLevels)
    return cudaErrorInvalidValue;
  Levels lv;
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_hw_start[3 * l];
    lv.w[l] = level_hw_start[3 * l + 1];
    lv.start[l] = level_hw_start[3 * l + 2];
    if (lv.h[l] < 1 || lv.w[l] < 1 || lv.start[l] < 0 ||
        lv.start[l] + static_cast<long long>(lv.h[l]) * lv.w[l] > len_in)
      return cudaErrorInvalidValue;
  }
  const size_t total = static_cast<size_t>(B) * num_heads * Q;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(loc);
  const float* wp = static_cast<const float*>(attw);
  float* dv = static_cast<float*>(dvalue_t);
  float* dlp = static_cast<float*>(dloc);
  float* dwp = static_cast<float*>(dattw);
  if (dtype == lw::kFloat32) {
    deform_attn_cm_bwd_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(value_t), lp, wp, static_cast<const float*>(dout), dv, dlp,
        dwp, C, len_in, Q, num_heads, n_points, lv, total);
  } else if (dtype == lw::kBFloat16) {
    deform_attn_cm_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(value_t), lp, wp,
        static_cast<const __nv_bfloat16*>(dout), dv, dlp, dwp, C, len_in, Q, num_heads,
        n_points, lv, total);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
