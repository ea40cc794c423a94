// K5 and K10 (backward): backward of the deformable sampling over per-level
// head-major panels (K5) or over the row-major value (B, Len_in, H, D) (K10).
//
// K5 replaces lwdetr_tpu/ops/deform_attn.py::_sep_bwd_kernel (launched from
// _sep_bwd) together with the VJP of _prep_separable, which turns that
// kernel's d(y-weights) and d(x-weights) into gradients of the sampling
// locations and attention weights. K10's backward replaces ::_dvalue_kernel
// and ::_dweight_kernel (launched from _sample_bwd) together with the VJP of
// _prep_indices_weights. One device body serves both layouts over the layout
// policy of the forward (deform_layout.cuh); each kernel has its own entry
// symbol. For the forward
//   out[b, q, hD + d] = sum_{l, p} w[b, q, h, l, p]
//                       * bilinear(panel_l[b, h, :, :, d], loc[b, q, h, l, p])
// and g = d(out)[b, q, hD:(h+1)D], with the four corner values v00, v01, v10,
// v11 (row y0 / y0 + 1, column x0 / x0 + 1; a corner outside the map is 0)
// and the fractions fx, fy of a point, it computes
//   d(w)      = <g, (1-fy)((1-fx) v00 + fx v01) + fy((1-fx) v10 + fx v11)>
//   d(loc_x)  = W_l w <g, (1-fy)(v01 - v00) + fy (v11 - v10)>
//   d(loc_y)  = H_l w <g, (1-fx)(v10 - v00) + fx (v11 - v01)>
//   d(panel_l)[b, h, corner, :] += w * corner weight * g      (corners in the map)
// floor carries no gradient, and a point outside (-1, W) x (-1, H), or NaN,
// gives zeros, as in the forward. d(loc) differences the corner values
// before the one dot product: neighbouring values are close, and their
// difference is exact in f32 (Sterbenz), where a difference of two dot
// products <g, v01> - <g, v00> would cancel and keep the rounding error of
// each, of order eps |<g, v00>|, against a result of order |<g, v01 - v00>|.
//
// The TPU kernel rebuilds the forward's one-hot row and column masks per
// query block, turns the scatter into matmuls against them, and keeps d(value)
// of one batch element in f32 VMEM scratch across a sequential grid of query
// blocks. Neither is carried over.
//
// What bounds it on an H100: per (b, q, h) it reads 4 L P corners of D
// channels and d(out) once, and adds 32-383 M products into d(value) at the
// train shapes (Q L P points x 4 corners x D channels). Design, one launch a
// level: a point is taken by the D / 4 neighbouring lanes of a warp, each
// owning 4 channels, which read a corner as one 16-byte (f32) or 8-byte (bf16)
// vector through the read-only path, add w x corner weight x g into d(value)
// with one float4 vector reduction (atomicAdd on float4, sm_90) into an f32
// buffer the caller zeroed (f32 also for bf16 values, rounded once by the
// caller), and sum their dot products for d(loc) and d(w) with shuffles among
// themselves; CTAs of 512 threads over slices of the queries of one (b, h)
// map, so that the card is full and its loads overlap. The order of the adds
// is not fixed, so two runs differ in the last f32 bits.
//
// bf16 panels (K5) compute as _sep_bwd_kernel and the VJP of _prep_separable
// do, not by the f32 formulas above (deform_attn_sep.cu packs the same bf16
// y- and x-weights wy_r, wx_c for the forward): with a point's row gathers
// g_c = wy0 v[ya, x_c] + wy1 v[yb, x_c] (f32) at its clamped columns,
//   d(wx_c)  = bf16(sum_d g_c g)           (each product rounded, then summed)
//   dg_c     = bf16(wx_c g)
//   d(wy_r)  = bf16(sum_{c, d} dg_c v[y_r, x_c])
//   d(value)[y_r, x_c] += wy_r dg_c        (corners in the map)
// and in f32 d(w) = d(wx_0) (1-fx) + d(wx_1) fx, d(loc_x) = W_l (aw d(wx_1) -
// aw d(wx_0)), d(loc_y) = H_l (d(wy_1) - d(wy_0)), a flag zeroing each term
// whose row or column is outside the map. The row-major bf16 backward (K10's)
// keeps the f32 formulas.
//
// A point takes the fewest lanes, a power of two, that cover D / 4: head dims
// 8 to 64 in steps of 8, idle lanes where D / 4 is no power of two.
//
// Summing d(value) in shared memory instead, and writing it once, was measured
// slower on an H100 at every driven shape (f32 device time at small's / large's
// train shape, against this design, `bench_deform.py`): the card has no f32
// add in shared memory, an atomicAdd there is a compare-and-swap loop (SASS
// ATOMS.CAST.SPIN), and bands of a map's rows, one CTA a band, with a shared
// atomicAdd per corner channel read 2.6x / 2.1x; the bands as one cluster
// whose CTAs split the queries and add through distributed shared memory 4.3x
// / 3.8x; corners filed by position with integer shared atomics and a block
// scan, then summed per position in registers, no float atomics, 1.22x /
// 1.34x, this design's zeroing of its buffer included (PERF.md, section 6).
#include <type_traits>

#include "deform_layout.cuh"

namespace {

using lw::kMaxLevels;
using lw::kVec;
using lw::load4;
using lw::PanelLayout;
using lw::Point;
using lw::RowMajorLayout;

constexpr int kThreads = 512;
constexpr int kChunkIters = 4;  // queries a CTA = groups of a CTA x kChunkIters

// lanes of one point: the fewest, a power of two, that cover D / kVec channels
__host__ __device__ __forceinline__ int point_lanes(int D) {
  int n = 1;
  while (n * kVec < D) n <<= 1;
  return n;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// wy0 a + wy1 b per channel: two exact products (bf16 x bf16), one rounding
__device__ __forceinline__ float4 row_gather(float wy0, float4 a, float wy1, float4 b) {
  return make_float4(fmaf(wy0, a.x, wy1 * b.x), fmaf(wy0, a.y, wy1 * b.y),
                     fmaf(wy0, a.z, wy1 * b.z), fmaf(wy0, a.w, wy1 * b.w));
}
// sum of the products a b, each rounded to f32 first (no fused multiply-add)
__device__ __forceinline__ float rounded_dot(float4 a, float4 b) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                             __fmul_rn(a.z, b.z)), __fmul_rn(a.w, b.w));
}
// bf16(c g) per channel
__device__ __forceinline__ float4 bf16_scaled(float c, float4 g) {
  return make_float4(round_bf16(__fmul_rn(c, g.x)), round_bf16(__fmul_rn(c, g.y)),
                     round_bf16(__fmul_rn(c, g.z)), round_bf16(__fmul_rn(c, g.w)));
}
__device__ __forceinline__ float4 scale4(float c, float4 g) {
  return make_float4(c * g.x, c * g.y, c * g.z, c * g.w);
}
// d(value)[4 channels at p] += v: one vector reduction into f32 device memory
__device__ __forceinline__ void add4v(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

// one level of one launch
struct Level {
  int l;           // its index among the L levels of loc / weights
  int h, w;        // map rows, columns
  int len_in;      // positions of all levels together (the row-major layout's batch stride)
  const void* value;  // the level's first element
  float* dvalue;      // its gradient's, f32, zeroed by the caller
};

struct Args {
  const float* loc;
  const float* attw;
  const void* dout;
  float* dloc;
  float* dattw;
  int B, Q, H, D, L, P;
};

// d(value), d(loc) and d(w) of queries [blockIdx.x q_per_cta, ...) of map
// (b, h) = blockIdx.y at level lv
template <typename T, typename Layout>
__global__ void __launch_bounds__(kThreads)
deform_attn_sep_bwd_kernel(const float* __restrict__ loc, const float* __restrict__ attw,
                           const T* __restrict__ dout, float* __restrict__ dloc,
                           float* __restrict__ dattw, int Q, int H, int D, int L, int P, Level lv,
                           int q_per_cta) {
  const int Hl = lv.h, Wl = lv.w;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int lanes = point_lanes(D);  // lanes of one point, a power of two in the warp
  const int group = threadIdx.x / lanes;
  const int lane = threadIdx.x - group * lanes;
  const int groups = kThreads / lanes;
  const bool active = lane * kVec < D;  // idle lanes add zeros to the sums
  const int d = active ? lane * kVec : 0;  // first of this lane's channels
  const unsigned gmask = (lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u))
                         << ((threadIdx.x & 31) & ~(lanes - 1));
  const int xs = Layout::x_stride(H, D);
  const size_t row = static_cast<size_t>(Wl) * xs;
  const size_t origin = Layout::origin(b, h, H, D, Hl, Wl, lv.len_in) + d;
  const T* map = static_cast<const T*>(lv.value) + origin;
  float* dmap = lv.dvalue + origin;
  const size_t bq0 = static_cast<size_t>(b) * Q;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int q1 = min(Q, static_cast<int>(blockIdx.x + 1) * q_per_cta);
  constexpr bool kRoundAsTpu =
      std::is_same<T, __nv_bfloat16>::value && std::is_same<Layout, PanelLayout>::value;
  // every lane of a group runs the same loop, so the shuffles are convergent
  for (int q = blockIdx.x * q_per_cta + group; q < q1; q += groups) {
    const float4 g = active ? load4(dout + ((bq0 + q) * H + h) * D + d) : zero;
    for (int p = 0; p < P; ++p) {
      const size_t pt = (((bq0 + q) * H + h) * L + lv.l) * P + p;
      const Point pnt = lw::point_at(loc, attw, pt, Wl, Hl);
      float sw = 0.f, sx = 0.f, sy = 0.f;  // d(w), and d(loc) before the scale by W_l, H_l
      if (pnt.inside) {
        const int x0 = pnt.x0, y0 = pnt.y0;
        const float fx = pnt.fx, fy = pnt.fy, aw = pnt.aw;
        const bool x0ok = x0 >= 0, x1ok = x0 + 1 < Wl, y0ok = y0 >= 0, y1ok = y0 + 1 < Hl;
        if constexpr (kRoundAsTpu) {
          // clamped rows and columns, as _prep_separable packs them
          const ptrdiff_t ra = max(y0, 0) * static_cast<ptrdiff_t>(row);
          const ptrdiff_t rb = min(y0 + 1, Hl - 1) * static_cast<ptrdiff_t>(row);
          const ptrdiff_t ca = max(x0, 0) * static_cast<ptrdiff_t>(xs);
          const ptrdiff_t cb = min(x0 + 1, Wl - 1) * static_cast<ptrdiff_t>(xs);
          const float xwu0 = x0ok ? __fsub_rn(1.f, fx) : 0.f, xwu1 = x1ok ? fx : 0.f;
          const float wy0 = round_bf16(y0ok ? __fsub_rn(1.f, fy) : 0.f);
          const float wy1 = round_bf16(y1ok ? fy : 0.f);
          const float wx0 = round_bf16(__fmul_rn(xwu0, aw));
          const float wx1 = round_bf16(__fmul_rn(xwu1, aw));
          const float4 vaa = active ? load4(map + ra + ca) : zero;
          const float4 vab = active ? load4(map + ra + cb) : zero;
          const float4 vba = active ? load4(map + rb + ca) : zero;
          const float4 vbb = active ? load4(map + rb + cb) : zero;
          const float4 ga = row_gather(wy0, vaa, wy1, vba);
          const float4 gb = row_gather(wy0, vab, wy1, vbb);
          float s0 = rounded_dot(ga, g), s1 = rounded_dot(gb, g);
          const float4 dga = bf16_scaled(wx0, g), dgb = bf16_scaled(wx1, g);
          float t0 = lw::dot4(dga, vaa) + lw::dot4(dgb, vab);  // exact products
          float t1 = lw::dot4(dga, vba) + lw::dot4(dgb, vbb);
          if (active) {
            if (y0ok && x0ok) add4v(dmap + ra + ca, scale4(wy0, dga));
            if (y0ok && x1ok) add4v(dmap + ra + cb, scale4(wy0, dgb));
            if (y1ok && x0ok) add4v(dmap + rb + ca, scale4(wy1, dga));
            if (y1ok && x1ok) add4v(dmap + rb + cb, scale4(wy1, dgb));
          }
          for (int s = 1; s < lanes; s <<= 1) {
            s0 += __shfl_xor_sync(gmask, s0, s);
            s1 += __shfl_xor_sync(gmask, s1, s);
            t0 += __shfl_xor_sync(gmask, t0, s);
            t1 += __shfl_xor_sync(gmask, t1, s);
          }
          const float dx0 = round_bf16(s0), dx1 = round_bf16(s1);
          const float dy0 = round_bf16(t0), dy1 = round_bf16(t1);
          sw = __fadd_rn(__fmul_rn(dx0, xwu0), __fmul_rn(dx1, xwu1));
          sx = __fsub_rn(x1ok ? __fmul_rn(dx1, aw) : 0.f, x0ok ? __fmul_rn(dx0, aw) : 0.f);
          sy = __fsub_rn(y1ok ? dy1 : 0.f, y0ok ? dy0 : 0.f);
          sx = __fmul_rn(sx, static_cast<float>(Wl));
          sy = __fmul_rn(sy, static_cast<float>(Hl));
        } else {
          // x0 >= -1 and y0 >= -1 here; a pointer is used only for a corner in the map
          const ptrdiff_t at = y0 * static_cast<ptrdiff_t>(row) + x0 * xs;
          if (active) {
            if (y0ok && x0ok) lw::add4(dmap + at, aw * (1.f - fy) * (1.f - fx), g);
            if (y0ok && x1ok) lw::add4(dmap + at + xs, aw * (1.f - fy) * fx, g);
            if (y1ok && x0ok) lw::add4(dmap + at + row, aw * fy * (1.f - fx), g);
            if (y1ok && x1ok) lw::add4(dmap + at + row + xs, aw * fy * fx, g);
          }
          const float4 v00 = active && y0ok && x0ok ? load4(map + at) : zero;
          const float4 v01 = active && y0ok && x1ok ? load4(map + at + xs) : zero;
          const float4 v10 = active && y1ok && x0ok ? load4(map + at + row) : zero;
          const float4 v11 = active && y1ok && x1ok ? load4(map + at + row + xs) : zero;
          lw::corner_dots(g, v00, v01, v10, v11, fx, fy, sw, sx, sy);
          for (int s = 1; s < lanes; s <<= 1) {  // sum over the lanes of this point
            sw += __shfl_xor_sync(gmask, sw, s);
            sx += __shfl_xor_sync(gmask, sx, s);
            sy += __shfl_xor_sync(gmask, sy, s);
          }
          sx = Wl * pnt.aw * sx;
          sy = Hl * pnt.aw * sy;
        }
      }
      if (lane == 0) {  // every element, so d(loc) and d(w) need no zeroing
        dattw[pt] = sw;
        dloc[2 * pt] = sx;
        dloc[2 * pt + 1] = sy;
      }
    }
  }
}

// one launch a level
template <typename Layout>
int launch(const Args& a, const Level* levels, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q_per_cta = kThreads / point_lanes(a.D) * kChunkIters;
  const dim3 grid((a.Q + q_per_cta - 1) / q_per_cta, a.B * a.H);
  for (int l = 0; l < a.L; ++l) {
    if (dtype == lw::kFloat32)
      deform_attn_sep_bwd_kernel<float, Layout><<<grid, kThreads, 0, st>>>(
          a.loc, a.attw, static_cast<const float*>(a.dout), a.dloc, a.dattw, a.Q, a.H, a.D, a.L,
          a.P, levels[l], q_per_cta);
    else
      deform_attn_sep_bwd_kernel<__nv_bfloat16, Layout><<<grid, kThreads, 0, st>>>(
          a.loc, a.attw, static_cast<const __nv_bfloat16*>(a.dout), a.dloc, a.dattw, a.Q, a.H,
          a.D, a.L, a.P, levels[l], q_per_cta);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// head dims 8 to 64 in steps of 8 (a point's lanes, a power of two, divide a warp)
bool sizes_ok(int B, int Q, int num_heads, int head_dim, int n_levels, int n_points, int dtype) {
  return B >= 1 && Q >= 1 && num_heads >= 1 && head_dim >= 8 && head_dim <= 64 &&
         head_dim % 8 == 0 &&
         n_points >= 1 && n_levels >= 1 && n_levels <= kMaxLevels &&
         (dtype == lw::kFloat32 || dtype == lw::kBFloat16);
}

}  // namespace

// K5. panels[l]: level l's values (B, H, h[l], w[l] * D) in `dtype`, contiguous,
// 16-byte aligned; dpanels[l]: its gradient, f32, same shape, zeroed by the
// caller, 16-byte aligned; level_hw: (h, w) per level; loc (B, Q, H, L, P, 2)
// and attw (B, Q, H, L, P) f32 with gradients dloc, dattw of the same shapes;
// dout (B, Q, H * D) in `dtype`. `panels`, `dpanels` and `level_hw` are host
// arrays.
extern "C" int lw_deform_attn_sep_bwd(const void* const* panels, void* const* dpanels,
                                      const int* level_hw, const void* loc, const void* attw,
                                      const void* dout, void* dloc, void* dattw, int B, int Q,
                                      int num_heads, int head_dim, int n_levels, int n_points,
                                      int dtype, void* stream) {
  if (!sizes_ok(B, Q, num_heads, head_dim, n_levels, n_points, dtype))
    return cudaErrorInvalidValue;
  Level levels[kMaxLevels];
  for (int l = 0; l < n_levels; ++l) {
    Level& lv = levels[l];
    lv.l = l;
    lv.h = level_hw[2 * l];
    lv.w = level_hw[2 * l + 1];
    lv.len_in = 0;
    lv.value = panels[l];
    lv.dvalue = static_cast<float*>(dpanels[l]);
    if (lv.h < 1 || lv.w < 1 || lv.value == nullptr || lv.dvalue == nullptr ||
        reinterpret_cast<size_t>(lv.value) % 16 != 0 ||
        reinterpret_cast<size_t>(lv.dvalue) % 16 != 0)
      return cudaErrorInvalidValue;
  }
  const Args a = {static_cast<const float*>(loc), static_cast<const float*>(attw), dout,
                  static_cast<float*>(dloc), static_cast<float*>(dattw), B, Q, num_heads,
                  head_dim, n_levels, n_points};
  return launch<PanelLayout>(a, levels, dtype, stream);
}

// K10, backward. value (B, len_in, H, D) in `dtype`, contiguous, 16-byte
// aligned, the levels one after another along len_in; dvalue: its gradient,
// f32, same shape, zeroed by the caller, 16-byte aligned; the rest as for K5.
// `level_hw` is a host array.
extern "C" int lw_deform_attn_rowmajor_bwd(const void* value, void* dvalue, const int* level_hw,
                                           const void* loc, const void* attw, const void* dout,
                                           void* dloc, void* dattw, int B, int len_in, int Q,
                                           int num_heads, int head_dim, int n_levels,
                                           int n_points, int dtype, void* stream) {
  if (!sizes_ok(B, Q, num_heads, head_dim, n_levels, n_points, dtype) || value == nullptr ||
      dvalue == nullptr || reinterpret_cast<size_t>(value) % 16 != 0 ||
      reinterpret_cast<size_t>(dvalue) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t position = static_cast<size_t>(num_heads) * head_dim;  // elements
  const size_t isz = dtype == lw::kFloat32 ? sizeof(float) : sizeof(__nv_bfloat16);
  Level levels[kMaxLevels];
  long long start = 0;
  for (int l = 0; l < n_levels; ++l) {
    Level& lv = levels[l];
    lv.l = l;
    lv.h = level_hw[2 * l];
    lv.w = level_hw[2 * l + 1];
    if (lv.h < 1 || lv.w < 1) return cudaErrorInvalidValue;
    lv.len_in = len_in;
    lv.value = static_cast<const char*>(value) + start * position * isz;
    lv.dvalue = static_cast<float*>(dvalue) + start * position;
    start += static_cast<long long>(lv.h) * lv.w;
  }
  if (start != len_in) return cudaErrorInvalidValue;
  const Args a = {static_cast<const float*>(loc), static_cast<const float*>(attw), dout,
                  static_cast<float*>(dloc), static_cast<float*>(dattw), B, Q, num_heads,
                  head_dim, n_levels, n_points};
  return launch<RowMajorLayout>(a, levels, dtype, stream);
}
