// K4 and K10: multi-scale deformable attention sampling over per-level
// head-major value panels (K4) or over the row-major value (B, Len_in, H, D)
// of the reference CUDA op's own contract (K10, forward).
//
// K4 replaces lwdetr_tpu/ops/deform_attn.py::_sep_kernel (launched from
// _sep_fwd / ms_deform_attn_sep_panels); K10 replaces ::_deform_kernel
// (launched from _sample_fwd / ms_deform_attn_pallas). Both layouts keep the
// D channels of one position contiguous, so one device body serves both over
// a layout policy that says where a head's map starts and how far apart two
// neighbouring positions lie; each kernel has its own entry symbol. K4 computes
//   out[b, q, hD + d] = sum_{l, p} w[b, q, h, l, p]
//                       * bilinear(panel_l[b, h, :, :, d], loc[b, q, h, l, p])
// where panel_l is (B, H, H_l, W_l * D): the head-h map of level l with the
// D channels of one position contiguous. Sampling has
// grid_sample(align_corners=False, padding_mode='zeros') semantics: a
// location x in [0, 1] maps to the pixel coordinate x W_l - 0.5, the four
// corners around it are weighted bilinearly, and a corner outside the level
// contributes zero.
//
// The TPU kernel factors the gather into a (q, H_l) one-hot row-mask matmul,
// a (q, W_l D) column mask and a lane-regroup matmul, fed by packed per-axis
// indices and weights, because a TPU gathers badly. None of that is carried
// over: here the gather is a load. The kernel takes the sampling locations
// and attention weights as they are and forms the floor, the fractions and
// the corner weights in registers.
//
// What bounds it on an H100: each (b, q, h) reads 4 L P corners of D
// channels and does as many D-wide multiply-adds, a few hundred bytes per
// flop-pair, so it is bound by bytes: at least the panels once, in practice
// the gathered corner reads (at large@640, batch 8, 57,600 groups x 32
// corners x 64 B = 118 MB in f32). Design: the panel layout keeps a corner's
// D channels contiguous (64 B in f32 at D = 16), so each thread owns 4
// neighbouring channels of one (b, q, h) and loads them as one 16-byte (f32)
// or 8-byte (bf16) vector; the D / 4 threads of a head read one whole corner
// as one contiguous segment, and they share the location and weight (a
// broadcast). Threads run channel-fastest over the (B, Q, C) output, so a
// warp writes 512 contiguous bytes of one output row. Accumulation is f32,
// rounded once on the store. Coordinates use floorf, not a truncating cast,
// and a location far outside the level (or NaN) is skipped before any index
// is formed. K10 differs in the addresses alone: position (y, x) of level l
// lies at value[b, start_l + y W_l + x, h, :], so neighbouring positions are
// H D elements apart and the heads of one position are contiguous.
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
};

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  auto bits = [](float x) -> unsigned {
    return __bfloat16_as_ushort(lw::from_f32<__nv_bfloat16>(x));
  };
  uint2 raw;
  raw.x = bits(v.x) | (bits(v.y) << 16);
  raw.y = bits(v.z) | (bits(v.w) << 16);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

template <typename T, typename Layout>
__global__ void __launch_bounds__(kThreads)
deform_attn_sep_kernel(const float* __restrict__ loc, const float* __restrict__ attw,
                       T* __restrict__ out, int Q, int H, int D, int P, Levels lv,
                       size_t total) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;  // total = B Q C / kVec
  const int C = H * D;
  const int vec_per_row = C / kVec;
  const int c = static_cast<int>(t % vec_per_row) * kVec;  // first of this thread's channels
  const size_t bq = t / vec_per_row;
  const int b = static_cast<int>(bq / Q);
  const int h = c / D;
  const int d = c - h * D;

  const size_t bqh = bq * H + h;
  const float* lp = loc + bqh * lv.n * P * 2;
  const float* wp = attw + bqh * lv.n * P;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int l = 0; l < lv.n; ++l) {
    const int Wl = lv.w[l];
    const int Hl = lv.h[l];
    const int xs = Layout::x_stride(H, D);           // elements between neighbouring positions
    const size_t row = static_cast<size_t>(Wl) * xs;  // elements per map row
    // this thread's channels of position (0, 0) of the (b, h) map
    const T* map = static_cast<const T*>(lv.panel[l]) +
                   Layout::origin(b, h, H, D, Hl, Wl, lv.len_in) + d;
#pragma unroll 4
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
      // x0 >= -1 and y0 >= -1 here; a pointer is formed only for a corner in bounds
      const T* c00 = map + y0 * static_cast<ptrdiff_t>(row) + x0 * xs;
      if (y0ok && x0ok) axpy4(aw * (1.f - fy) * (1.f - fx), load4(c00), acc);
      if (y0ok && x1ok) axpy4(aw * (1.f - fy) * fx, load4(c00 + xs), acc);
      if (y1ok && x0ok) axpy4(aw * fy * (1.f - fx), load4(c00 + row), acc);
      if (y1ok && x1ok) axpy4(aw * fy * fx, load4(c00 + row + xs), acc);
    }
  }
  store4(out + bq * C + c, acc);
}

template <typename Layout>
int launch(const Levels& lv, const void* loc, const void* attw, void* out, int B, int Q,
           int num_heads, int head_dim, int n_points, int dtype, void* stream) {
  const size_t total = static_cast<size_t>(B) * Q * num_heads * head_dim / kVec;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(loc);
  const float* wp = static_cast<const float*>(attw);
  if (dtype == lw::kFloat32) {
    deform_attn_sep_kernel<float, Layout><<<blocks, kThreads, 0, st>>>(
        lp, wp, static_cast<float*>(out), Q, num_heads, head_dim, n_points, lv, total);
  } else if (dtype == lw::kBFloat16) {
    deform_attn_sep_kernel<__nv_bfloat16, Layout><<<blocks, kThreads, 0, st>>>(
        lp, wp, static_cast<__nv_bfloat16*>(out), Q, num_heads, head_dim, n_points, lv, total);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool sizes_ok(int B, int Q, int num_heads, int head_dim, int n_levels, int n_points) {
  return B >= 1 && Q >= 1 && num_heads >= 1 && head_dim >= kVec && head_dim % kVec == 0 &&
         n_points >= 1 && n_levels >= 1 && n_levels <= kMaxLevels;
}

}  // namespace

// K4. panels[l]: level l's values (B, H, h[l], w[l] * D) in `dtype`, contiguous,
// 16-byte aligned; level_hw: (h, w) per level; loc (B, Q, H, L, P, 2) and
// attw (B, Q, H, L, P) f32; out (B, Q, H * D) in `dtype`. `panels` and
// `level_hw` are host arrays.
extern "C" int lw_deform_attn_sep(const void* const* panels, const int* level_hw,
                                  const void* loc, const void* attw, void* out, int B, int Q,
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
    if (lv.h[l] < 1 || lv.w[l] < 1 || lv.panel[l] == nullptr ||
        reinterpret_cast<size_t>(lv.panel[l]) % 16 != 0)
      return cudaErrorInvalidValue;
  }
  return launch<PanelLayout>(lv, loc, attw, out, B, Q, num_heads, head_dim, n_points, dtype,
                             stream);
}

// K10, forward. value (B, len_in, H, D) in `dtype`, contiguous, 16-byte
// aligned, the levels one after another along len_in; level_hw: (h, w) per
// level; loc (B, Q, H, L, P, 2) and attw (B, Q, H, L, P) f32; out
// (B, Q, H * D) in `dtype`. `level_hw` is a host array.
extern "C" int lw_deform_attn_rowmajor(const void* value, const int* level_hw, const void* loc,
                                       const void* attw, void* out, int B, int len_in, int Q,
                                       int num_heads, int head_dim, int n_levels, int n_points,
                                       int dtype, void* stream) {
  if (!sizes_ok(B, Q, num_heads, head_dim, n_levels, n_points) || value == nullptr ||
      reinterpret_cast<size_t>(value) % 16 != 0 ||
      (dtype != lw::kFloat32 && dtype != lw::kBFloat16))
    return cudaErrorInvalidValue;
  const size_t position = static_cast<size_t>(num_heads) * head_dim *
                          (dtype == lw::kFloat32 ? sizeof(float) : sizeof(__nv_bfloat16));
  Levels lv;
  lv.n = n_levels;
  lv.len_in = len_in;
  long long start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    if (lv.h[l] < 1 || lv.w[l] < 1) return cudaErrorInvalidValue;
    lv.panel[l] = static_cast<const char*>(value) + start * position;
    start += static_cast<long long>(lv.h[l]) * lv.w[l];
  }
  if (start != len_in) return cudaErrorInvalidValue;
  return launch<RowMajorLayout>(lv, loc, attw, out, B, Q, num_heads, head_dim, n_points, dtype,
                                stream);
}
