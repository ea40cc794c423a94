// K3: multi-scale deformable attention sampling, channel-major.
//
// Replaces lwdetr_tpu/ops/deform_attn.py::_deform_cm_kernel (launched from
// _sample_cm_fwd / ms_deform_attn_cm). It computes
//   out[b, hD + d, q] = sum_{l, p} w[b, q, h, l, p]
//                       * bilinear(value_t[b, hD + d, level l], loc[b, q, h, l, p])
// with grid_sample(align_corners=False, padding_mode='zeros') semantics: a
// location x in [0, 1] maps to the pixel coordinate x W_l - 0.5, the four
// corners around it are weighted bilinearly, and a corner outside the level
// contributes zero.
//
// The TPU kernel builds a (q, n) one-hot sampling matrix and multiplies it
// on the MXU, because gathers are slow there. On a GPU a gather is a plain
// load, so this kernel reads the corners directly, the way the reference's
// CUDA im2col does. What bounds it on an H100: each output element reads
// 4 L P corners and does as many multiply-adds, so the work is a few
// megabytes of gathered reads and next to no arithmetic; the value tensor at
// small@640 (B = 8: 13 MB in f32) stays in the 50 MB L2, so it is bound by
// the latency of the scattered reads. Design: one thread per output element
// (b, q, c) with the channel fastest, so the threads of one (query, head)
// read the same location and weight (a broadcast) and write their outputs
// in one pass; each thread accumulates in f32. Coordinates use floorf, not a
// truncating cast, and a location far outside the level is skipped before
// any index is formed.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kThreads = 256;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_attn_cm_kernel(const T* __restrict__ value_t, const float* __restrict__ loc,
                      const float* __restrict__ attw, T* __restrict__ out, int C, int len_in,
                      int Q, int H, int P, Levels lv, size_t total) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int c = static_cast<int>(t % C);
  const size_t bq = t / C;
  const int q = static_cast<int>(bq % Q);
  const int b = static_cast<int>(bq / Q);
  const int h = c / (C / H);

  const T* row = value_t + (static_cast<size_t>(b) * C + c) * len_in;
  const size_t bqh = (static_cast<size_t>(b) * Q + q) * H + h;
  const float* lp = loc + bqh * lv.n * P * 2;
  const float* wp = attw + bqh * lv.n * P;

  float acc = 0.f;
  for (int l = 0; l < lv.n; ++l) {
    const int Wl = lv.w[l];
    const int Hl = lv.h[l];
    const T* lrow = row + lv.start[l];
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const float px = lw::pixel(lp[2 * k], Wl);
      const float py = lw::pixel(lp[2 * k + 1], Hl);
      // no corner of a point outside (-1, W) x (-1, H) is in bounds; this
      // also drops NaN and keeps the integer casts below in range
      if (!(px > -1.f && px < Wl && py > -1.f && py < Hl)) continue;
      const float x0f = floorf(px);
      const float y0f = floorf(py);
      const float fx = px - x0f;
      const float fy = py - y0f;
      const int x0 = static_cast<int>(x0f);
      const int y0 = static_cast<int>(y0f);
      const float aw = wp[k];
      const bool x0ok = x0 >= 0, x1ok = x0 + 1 < Wl;
      const bool y0ok = y0 >= 0, y1ok = y0 + 1 < Hl;
      float s = 0.f;
      if (y0ok && x0ok) s += (1.f - fy) * (1.f - fx) * lw::to_f32(lrow[y0 * Wl + x0]);
      if (y0ok && x1ok) s += (1.f - fy) * fx * lw::to_f32(lrow[y0 * Wl + x0 + 1]);
      if (y1ok && x0ok) s += fy * (1.f - fx) * lw::to_f32(lrow[(y0 + 1) * Wl + x0]);
      if (y1ok && x1ok) s += fy * fx * lw::to_f32(lrow[(y0 + 1) * Wl + x0 + 1]);
      acc = fmaf(aw, s, acc);
    }
  }
  out[(static_cast<size_t>(b) * C + c) * Q + q] = lw::from_f32<T>(acc);
}

}  // namespace

// value_t (B, C, len_in) and out (B, C, Q) in `dtype`; loc (B, Q, H, L, P, 2)
// and attw (B, Q, H, L, P) f32; level l spans value_t[..., start[l] :
// start[l] + h[l] w[l]]. All contiguous.
extern "C" int lw_deform_attn_cm(const void* value_t, const void* loc, const void* attw,
                                 void* out, int B, int C, int len_in, int Q, int num_heads,
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
  const size_t total = static_cast<size_t>(B) * Q * C;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(loc);
  const float* wp = static_cast<const float*>(attw);
  if (dtype == lw::kFloat32) {
    deform_attn_cm_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(value_t), lp, wp, static_cast<float*>(out), C, len_in, Q,
        num_heads, n_points, lv, total);
  } else if (dtype == lw::kBFloat16) {
    deform_attn_cm_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(value_t), lp, wp, static_cast<__nv_bfloat16*>(out), C,
        len_in, Q, num_heads, n_points, lv, total);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
