// K3: multi-scale deformable attention sampling, channel-major.
//
// Replaces lwdetr_tpu/ops/deform_attn.py::_deform_cm_kernel (launched from
// _sample_cm_fwd / ms_deform_attn_cm). It computes
//   out[b, hD + d, q] = sum_{l, p} w[b, q, h, l, p]
//                       * bilinear(value_t[b, hD + d, level l], loc[b, q, h, l, p])
// with grid_sample(align_corners=False, padding_mode='zeros') semantics: a
// location x in [0, 1] maps to the pixel coordinate x W_l - 0.5 (rounded as
// PyTorch rounds it, lw::pixel), the four corners around it are weighted
// bilinearly, and a corner outside the level contributes zero; a point
// outside (-1, W) x (-1, H), or NaN, contributes nothing.
//
// The TPU kernel copies a (C, n_blk) block of the value into VMEM and
// builds a (q, n) one-hot sampling matrix for the MXU there. Here the block
// is the (b, h) map (D channel rows of Len_in: 51 KB in bf16, 102 KB in f32
// at small's and tiny's 40 x 40 level), staged in shared memory by bulk
// copies (deform_cm.cuh), and a corner is a plain load from it. What bounds
// it on an H100: each output element reads 4 L P corners and does as many
// multiply-adds, so the work is a few megabytes and next to no arithmetic;
// gathering those corners straight from device memory, a warp's lanes are
// Len_in elements apart (a sector each), so the latency of scattered loads,
// not bytes, set the pace. Thread map: one thread per query, q fastest across
// the lanes. A thread reads its points' locations and weights once, keeps up
// to 16 channels' sums in f32 registers (more channels: the points again for
// each 16), gathers the corners from shared memory (the lanes of a warp read
// positions of one channel row: the bank follows the position) and writes
// out[b, hD + d, q .. q + 31] as one coalesced store a channel. A map over the
// staging budget (large's levels) takes the same thread map, gathering from
// device memory.
//
// bf16 rounds where the TPU kernel rounds: the weights (1-fy)(1-fx) aw of the
// corners of one (q, h) that land on one position are summed in f32 (in the
// order of _prep_indices_weights_lanes: level, corner, point) and the sum is
// rounded to bf16 before its product with the value (`p.astype(val.dtype)`).
// A thread finds a position's corners by recomputing and comparing them, first
// occurrence first: quadratic in the corners of a level, where f32 is linear.
#include <type_traits>

#include "deform_cm.cuh"

namespace {

using lw::CmLevels;
using lw::CmRoute;

constexpr int kChunk = 16;  // channels a pass over the points

// Corner cc (0: (y0, x0), 1: (y0, x0 + 1), 2: (y0 + 1, x0), 3: (y0 + 1, x0 + 1))
// of point k of a (q, h) at a level starting at `start`: its position in the
// level-concatenated map, -1 outside it (and for a point outside (-1, W) x
// (-1, H), or NaN), and its weight, formed as _prep_indices_weights_lanes
// forms it: (1-fy)(1-fx) aw, ...
__device__ __forceinline__ int cm_corner(const float2* lp, const float* wp, int k, int cc, int Wl,
                                         int Hl, int start, float& w) {
  w = 0.f;
  const float2 xy = lp[k];
  const float px = lw::pixel(xy.x, Wl);
  const float py = lw::pixel(xy.y, Hl);
  if (!(px > -1.f && px < Wl && py > -1.f && py < Hl)) return -1;
  const float x0f = floorf(px);
  const float y0f = floorf(py);
  const int xi = static_cast<int>(x0f) + (cc & 1);
  const int yi = static_cast<int>(y0f) + (cc >> 1);
  if (xi < 0 || xi >= Wl || yi < 0 || yi >= Hl) return -1;
  const float fx = __fsub_rn(px, x0f);
  const float fy = __fsub_rn(py, y0f);
  const float wy = cc >> 1 ? fy : __fsub_rn(1.f, fy);
  const float wx = cc & 1 ? fx : __fsub_rn(1.f, fx);
  w = __fmul_rn(__fmul_rn(wy, wx), wp[k]);
  return start + yi * Wl + xi;
}

template <typename T, bool kStaged>
__device__ __forceinline__ void cm_sample(const T* __restrict__ value_t,
                                          const float* __restrict__ loc,
                                          const float* __restrict__ attw, T* __restrict__ out,
                                          int C, int len_in, int Q, int H, int P,
                                          const CmLevels& lv, const CmRoute& route) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  // the (b, h) map (channels bh D .. bh D + D - 1 of the batch) and its query slice
  const int bh = blockIdx.x / route.ctas_per_map;
  const int slice = blockIdx.x - bh * route.ctas_per_map;
  const int b = bh / H;
  const int h = bh - b * H;
  const int D = C / H;
  const T* gmap = value_t + static_cast<size_t>(bh) * D * len_in;
  const T* map = kStaged ? lw::cm_stage(gmap, static_cast<size_t>(D) * len_in, smem, &bar,
                                        route.bulk)
                         : gmap;
  const int q1 = min(Q, (slice + 1) * route.q_per_cta);
  const int LP = lv.n * P;
  for (int q = slice * route.q_per_cta + threadIdx.x; q < q1; q += blockDim.x) {
    const size_t bqh = (static_cast<size_t>(b) * Q + q) * H + h;
    const float2* lp = reinterpret_cast<const float2*>(loc) + bqh * LP;
    const float* wp = attw + bqh * LP;
    T* o = out + static_cast<size_t>(bh) * D * Q + q;
    for (int c0 = 0; c0 < D; c0 += kChunk) {
      const int nc = min(kChunk, D - c0);
      const T* rows = map + static_cast<size_t>(c0) * len_in;
      float acc[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
      // unrolled, so that lv is read at fixed offsets (indexed, it goes to local memory)
#pragma unroll
      for (int l = 0; l < lw::kMaxLevels; ++l) {
        if (l == lv.n) break;
        const int Wl = lv.w[l];
        const int Hl = lv.h[l];
        if constexpr (std::is_same<T, __nv_bfloat16>::value) {
          // corners j = corner * P + p: a position's merged weight, rounded once
          for (int j = 0; j < 4 * P; ++j) {
            const int cj = j / P;
            float wj;
            const int pos = cm_corner(lp, wp, l * P + j - cj * P, cj, Wl, Hl, lv.start[l], wj);
            if (pos < 0) continue;
            bool first = true;
            for (int f = 0; f < j && first; ++f) {
              float wf;
              const int cf = f / P;
              first = cm_corner(lp, wp, l * P + f - cf * P, cf, Wl, Hl, lv.start[l], wf) != pos;
            }
            if (!first) continue;
            float wsum = wj;
            for (int f = j + 1; f < 4 * P; ++f) {
              float wf;
              const int cf = f / P;
              if (cm_corner(lp, wp, l * P + f - cf * P, cf, Wl, Hl, lv.start[l], wf) == pos)
                wsum = __fadd_rn(wsum, wf);
            }
            const float wr = __bfloat162float(__float2bfloat16_rn(wsum));
#pragma unroll
            for (int c = 0; c < kChunk; ++c)
              if (c < nc)  // bf16 x bf16: an exact product
                acc[c] = fmaf(wr, lw::to_f32(rows[static_cast<size_t>(c) * len_in + pos]), acc[c]);
          }
          continue;
        }
        for (int p = 0; p < P; ++p) {
          const int k = l * P + p;
          const float2 xy = lp[k];
          const float px = lw::pixel(xy.x, Wl);
          const float py = lw::pixel(xy.y, Hl);
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
          // a corner outside the map weighs 0 and reads a position inside it
          const bool x0ok = x0 >= 0, x1ok = x0 + 1 < Wl;
          const bool y0ok = y0 >= 0, y1ok = y0 + 1 < Hl;
          const float w00 = y0ok && x0ok ? aw * ((1.f - fy) * (1.f - fx)) : 0.f;
          const float w01 = y0ok && x1ok ? aw * ((1.f - fy) * fx) : 0.f;
          const float w10 = y1ok && x0ok ? aw * (fy * (1.f - fx)) : 0.f;
          const float w11 = y1ok && x1ok ? aw * (fy * fx) : 0.f;
          const int xa = x0ok ? x0 : 0, xb = x1ok ? x0 + 1 : Wl - 1;
          const int ya = (y0ok ? y0 : 0) * Wl + lv.start[l];
          const int yb = (y1ok ? y0 + 1 : Hl - 1) * Wl + lv.start[l];
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            if (j < nc) {
              const T* row = rows + static_cast<size_t>(j) * len_in;
              acc[j] = fmaf(w00, lw::to_f32(row[ya + xa]),
                            fmaf(w01, lw::to_f32(row[ya + xb]),
                                 fmaf(w10, lw::to_f32(row[yb + xa]),
                                      fmaf(w11, lw::to_f32(row[yb + xb]), acc[j]))));
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < nc) o[static_cast<size_t>(c0 + j) * Q] = lw::from_f32<T>(acc[j]);
    }
  }
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(lw::kCmThreads)
deform_attn_cm_kernel(const T* __restrict__ value_t, const float* __restrict__ loc,
                      const float* __restrict__ attw, T* __restrict__ out, int C, int len_in,
                      int Q, int H, int P, CmLevels lv, CmRoute route) {
  cm_sample<T, kStaged>(value_t, loc, attw, out, C, len_in, Q, H, P, lv, route);
}

// bf16, whose position merging is heavier: a minimum of one CTA an SM (at the
// default ptxas spilled 36 bytes to stay at 64 registers)
template <bool kStaged>
__global__ void __launch_bounds__(lw::kCmThreads, 1)
deform_attn_cm_kernel_bf16(const __nv_bfloat16* __restrict__ value_t,
                           const float* __restrict__ loc, const float* __restrict__ attw,
                           __nv_bfloat16* __restrict__ out, int C, int len_in, int Q, int H, int P,
                           CmLevels lv, CmRoute route) {
  cm_sample<__nv_bfloat16, kStaged>(value_t, loc, attw, out, C, len_in, Q, H, P, lv, route);
}

int check(int B, int C, int len_in, int Q, int num_heads, int n_points, int dtype) {
  if (B < 1 || C < 1 || len_in < 1 || Q < 1 || num_heads < 1 || C % num_heads != 0 ||
      n_points < 1 || (dtype != lw::kFloat32 && dtype != lw::kBFloat16))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

CmRoute route_of(const void* value_t, int B, int C, int len_in, int Q, int num_heads, int dtype) {
  const size_t isz = dtype == lw::kFloat32 ? sizeof(float) : sizeof(__nv_bfloat16);
  return lw::cm_route(value_t, B, num_heads, C / num_heads, len_in, Q, isz, 1);
}

template <typename T>
auto kernel_for(const CmRoute& r) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return r.staged ? &deform_attn_cm_kernel_bf16<true> : &deform_attn_cm_kernel_bf16<false>;
  else
    return r.staged ? &deform_attn_cm_kernel<T, true> : &deform_attn_cm_kernel<T, false>;
}

template <typename T>
int launch(const CmRoute& r, const void* value_t, const void* loc, const void* attw, void* out,
           int B, int C, int len_in, int Q, int H, int P, const CmLevels& lv, cudaStream_t st) {
  return lw::cm_launch(kernel_for<T>(r), r, B * H, st, static_cast<const T*>(value_t),
                       static_cast<const float*>(loc), static_cast<const float*>(attw),
                       static_cast<T*>(out), C, len_in, Q, H, P, lv, r);
}

}  // namespace

// value_t (B, C, len_in) and out (B, C, Q) in `dtype`; loc (B, Q, H, L, P, 2)
// and attw (B, Q, H, L, P) f32; level l spans value_t[..., start[l] :
// start[l] + h[l] w[l]]. All contiguous; `level_hw_start` is a host array.
extern "C" int lw_deform_attn_cm(const void* value_t, const void* loc, const void* attw,
                                 void* out, int B, int C, int len_in, int Q, int num_heads,
                                 int n_levels, int n_points, const int* level_hw_start,
                                 int dtype, void* stream) {
  if (const int err = check(B, C, len_in, Q, num_heads, n_points, dtype)) return err;
  CmLevels lv;
  if (const int err = lw::cm_levels(level_hw_start, n_levels, len_in, &lv)) return err;
  const CmRoute r = route_of(value_t, B, C, len_in, Q, num_heads, dtype);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == lw::kFloat32)
    return launch<float>(r, value_t, loc, attw, out, B, C, len_in, Q, num_heads, n_points, lv, st);
  return launch<__nv_bfloat16>(r, value_t, loc, attw, out, B, C, len_in, Q, num_heads, n_points,
                               lv, st);
}

// The route `lw_deform_attn_cm` takes for these arguments (deform_cm.cuh,
// `report_route`): route[0..6].
extern "C" int lw_deform_attn_cm_route(const void* value_t, int B, int C, int len_in, int Q,
                                       int num_heads, int dtype, int* route) {
  if (const int err = check(B, C, len_in, Q, num_heads, 1, dtype)) return err;
  const CmRoute r = route_of(value_t, B, C, len_in, Q, num_heads, dtype);
  return lw::report_route(r,
                          dtype == lw::kFloat32
                              ? reinterpret_cast<const void*>(kernel_for<float>(r))
                              : reinterpret_cast<const void*>(kernel_for<__nv_bfloat16>(r)),
                          route);
}
