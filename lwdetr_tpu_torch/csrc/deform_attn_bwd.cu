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
// gives zeros to all three, as it gives nothing to the forward. d(loc) comes
// from differenced corners (lw::corner_dots). On bf16 values d(value_t) is
// formed as _dvalue_cm_kernel forms it: the weights of a (q, h)'s corners that
// land on one position summed in f32 and rounded to bf16 (the forward's
// merged weights, deform_attn.cu), times g, one reduction a position.
//
// The TPU pair rebuilds the (q, n) one-hot sampling matrix per block and
// takes d(value) and d(corner weights) as two matmuls against it, with
// d(value) accumulated in f32 VMEM scratch over a sequential grid. None of
// that is carried over.
//
// What bounds it on an H100: per (b, q, h) it reads 4 L P corners of D
// channels and adds into as many, with next to no arithmetic: the reductions
// into d(value) (10.6 M channel additions at tiny's train shape). In the
// channel-major layout a corner's D channels lie Len_in elements apart, so a
// reduction could add one channel only. Design: the sums go into an f32
// scratch laid out position-major, (B, Len_in, H, D), zeroed by the caller,
// where 4 channels of a corner are 16 contiguous bytes: one float4 vector
// reduction (atomicAdd on float4, sm_90) each, as K5 adds (on sm_90 shared
// memory has no f32 add: an atomicAdd there is a compare-and-swap loop, and
// K5's shared sums measured slower). Thread map, K5's: a point is taken by
// D / 4 neighbouring lanes (rounded up to a power of two), each owning 4
// channels, which sum their dot products for d(loc) and d(w) with shuffles;
// the lanes of one channel read d(out)[b, hD + d, q .. q + 7] contiguously.
// The (b, h) map is staged in shared memory as in K3 (deform_cm.cuh), and a
// lane gathers its 4 channels of a corner from 4 rows there. Then one pass
// turns the scratch into channel-major d(value_t) in the value's dtype (a
// 32 x 32 tiled transpose through shared memory, rounding bf16 once). The
// order of the adds is not fixed, so two runs differ in the last f32 bits.
#include <type_traits>

#include "deform_cm.cuh"

namespace {

using lw::CmLevels;
using lw::CmRoute;
using lw::kVec;
using lw::Point;

constexpr int kTile = 32;       // the transposing pass: a 32 x 32 tile a CTA
constexpr int kTileRows = 8;    // rows a thread of it moves: 32 x 8 threads

// 4 channels, Len_in apart, of one position
template <typename T>
__device__ __forceinline__ float4 load_cm4(const T* p, int len_in) {
  return make_float4(lw::to_f32(p[0]), lw::to_f32(p[len_in]), lw::to_f32(p[2 * len_in]),
                     lw::to_f32(p[3 * len_in]));
}

// Corner cc (0: (y0, x0), 1: (y0, x0 + 1), 2: (y0 + 1, x0), 3: (y0 + 1, x0 + 1))
// of the point at pt of a level starting at `start`: its position in the
// level-concatenated map, -1 outside it (or for a point outside or NaN), and
// its weight as _prep_indices_weights_lanes forms it, (1-fy)(1-fx) aw, ...
__device__ __forceinline__ int merged_corner(const float* loc, const float* attw, size_t pt,
                                             int cc, int Wl, int Hl, int start, float& w) {
  w = 0.f;
  const Point pnt = lw::point_at(loc, attw, pt, Wl, Hl);
  if (!pnt.inside) return -1;
  const int xi = pnt.x0 + (cc & 1);
  const int yi = pnt.y0 + (cc >> 1);
  if (xi < 0 || xi >= Wl || yi < 0 || yi >= Hl) return -1;
  const float wy = cc >> 1 ? pnt.fy : __fsub_rn(1.f, pnt.fy);
  const float wx = cc & 1 ? pnt.fx : __fsub_rn(1.f, pnt.fx);
  w = __fmul_rn(__fmul_rn(wy, wx), pnt.aw);
  return start + yi * Wl + xi;
}

template <typename T, bool kStaged>
__device__ __forceinline__ void cm_bwd(const T* __restrict__ value_t,
                                       const float* __restrict__ loc,
                                       const float* __restrict__ attw,
                                       const T* __restrict__ dout, float* __restrict__ dscratch,
                                       float* __restrict__ dloc, float* __restrict__ dattw, int C,
                                       int len_in, int Q, int H, int P, int lanes,
                                       const CmLevels& lv, const CmRoute& route) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int bh = blockIdx.x / route.ctas_per_map;  // the (b, h) map
  const int slice = blockIdx.x - bh * route.ctas_per_map;
  const int b = bh / H;
  const int h = bh - b * H;
  const int D = C / H;
  const T* gmap = value_t + static_cast<size_t>(bh) * D * len_in;
  const T* map = kStaged ? lw::cm_stage(gmap, static_cast<size_t>(D) * len_in, smem, &bar,
                                        route.bulk)
                         : gmap;
  const int group = threadIdx.x / lanes;  // lanes of one query: aligned in the warp
  const int lane = threadIdx.x - group * lanes;
  const int groups = blockDim.x / lanes;
  const int d = lane * kVec;  // first of this lane's channels
  const bool active = d < D;  // lanes past D (D / 4 not a power of two) add nothing
  const unsigned gmask = ((lanes == 32 ? 0u : 1u << lanes) - 1u)
                         << ((threadIdx.x & 31) & ~(lanes - 1));
  const T* vrows = map + static_cast<size_t>(active ? d : 0) * len_in;
  const T* grows = dout + (static_cast<size_t>(bh) * D + (active ? d : 0)) * Q;
  // position s of the scratch: dmap + s C
  float* dmap = dscratch + static_cast<size_t>(b) * len_in * C + h * D + d;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int LP = lv.n * P;
  const int q1 = min(Q, (slice + 1) * route.q_per_cta);
  // every lane of a group runs the same loop, so the shuffles are convergent
  for (int q = slice * route.q_per_cta + group; q < q1; q += groups) {
    const float4 g = active ? make_float4(lw::to_f32(grows[q]), lw::to_f32(grows[Q + q]),
                                          lw::to_f32(grows[2 * Q + q]),
                                          lw::to_f32(grows[3 * static_cast<size_t>(Q) + q]))
                            : zero;
    const size_t pt0 = ((static_cast<size_t>(b) * Q + q) * H + h) * LP;
    // unrolled, so that lv is read at fixed offsets (indexed, it goes to local memory)
#pragma unroll
    for (int l = 0; l < lw::kMaxLevels; ++l) {
      if (l == lv.n) break;
      const int Wl = lv.w[l];
      const int Hl = lv.h[l];
      for (int p = 0; p < P; ++p) {
        const size_t pt = pt0 + l * P + p;
        const Point pnt = lw::point_at(loc, attw, pt, Wl, Hl);
        float sw = 0.f, sx = 0.f, sy = 0.f;
        if (pnt.inside) {
          const int x0 = pnt.x0, y0 = pnt.y0;
          const float fx = pnt.fx, fy = pnt.fy, aw = pnt.aw;
          const bool ok00 = y0 >= 0 && x0 >= 0, ok01 = y0 >= 0 && x0 + 1 < Wl;
          const bool ok10 = y0 + 1 < Hl && x0 >= 0, ok11 = y0 + 1 < Hl && x0 + 1 < Wl;
          // x0 >= -1 and y0 >= -1 here; a position is used only for a corner in the map
          const ptrdiff_t at = lv.start[l] + y0 * static_cast<ptrdiff_t>(Wl) + x0;
          if constexpr (std::is_same<T, __nv_bfloat16>::value) {
            // as _dvalue_cm_kernel: the weights of the (q, h)'s corners on one
            // position summed in f32, in (level, corner, point) order, and the
            // sum rounded to bf16 (the forward's merged weights), times g
            const size_t base = pt0 + l * P;
            for (int cc = 0; active && cc < 4; ++cc) {
              float wj;
              const int pos = merged_corner(loc, attw, base + p, cc, Wl, Hl, lv.start[l], wj);
              if (pos < 0) continue;
              const int j = cc * P + p;
              bool first = true;
              for (int f = 0; f < j && first; ++f) {
                float wf;
                const int cf = f / P;
                first = merged_corner(loc, attw, base + f - cf * P, cf, Wl, Hl, lv.start[l],
                                      wf) != pos;
              }
              if (!first) continue;
              float wsum = wj;
              for (int f = j + 1; f < 4 * P; ++f) {
                float wf;
                const int cf = f / P;
                if (merged_corner(loc, attw, base + f - cf * P, cf, Wl, Hl, lv.start[l], wf) ==
                    pos)
                  wsum = __fadd_rn(wsum, wf);
              }
              // bf16 x bf16 products: exact
              lw::add4(dmap + static_cast<ptrdiff_t>(pos) * C,
                       __bfloat162float(__float2bfloat16_rn(wsum)), g);
            }
          } else if (active) {
            if (ok00) lw::add4(dmap + at * C, aw * (1.f - fy) * (1.f - fx), g);
            if (ok01) lw::add4(dmap + (at + 1) * C, aw * (1.f - fy) * fx, g);
            if (ok10) lw::add4(dmap + (at + Wl) * C, aw * fy * (1.f - fx), g);
            if (ok11) lw::add4(dmap + (at + Wl + 1) * C, aw * fy * fx, g);
          }
          const float4 v00 = active && ok00 ? load_cm4(vrows + at, len_in) : zero;
          const float4 v01 = active && ok01 ? load_cm4(vrows + at + 1, len_in) : zero;
          const float4 v10 = active && ok10 ? load_cm4(vrows + at + Wl, len_in) : zero;
          const float4 v11 = active && ok11 ? load_cm4(vrows + at + Wl + 1, len_in) : zero;
          lw::corner_dots(g, v00, v01, v10, v11, fx, fy, sw, sx, sy);
          for (int s = 1; s < lanes; s <<= 1) {  // sum over the lanes of this point
            sw += __shfl_xor_sync(gmask, sw, s);
            sx += __shfl_xor_sync(gmask, sx, s);
            sy += __shfl_xor_sync(gmask, sy, s);
          }
        }
        if (lane == 0) {  // every element, so d(loc) and d(w) need no zeroing
          dattw[pt] = sw;
          dloc[2 * pt] = Wl * pnt.aw * sx;
          dloc[2 * pt + 1] = Hl * pnt.aw * sy;
        }
      }
    }
  }
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(lw::kCmThreads)
deform_attn_cm_bwd_kernel(const T* __restrict__ value_t, const float* __restrict__ loc,
                          const float* __restrict__ attw, const T* __restrict__ dout,
                          float* __restrict__ dscratch, float* __restrict__ dloc,
                          float* __restrict__ dattw, int C, int len_in, int Q, int H, int P,
                          int lanes, CmLevels lv, CmRoute route) {
  cm_bwd<T, kStaged>(value_t, loc, attw, dout, dscratch, dloc, dattw, C, len_in, Q, H, P, lanes,
                     lv, route);
}

// bf16, whose position merging is heavier: a minimum of one CTA an SM, so that
// ptxas keeps it in registers
template <bool kStaged>
__global__ void __launch_bounds__(lw::kCmThreads, 1)
deform_attn_cm_bwd_kernel_bf16(const __nv_bfloat16* __restrict__ value_t,
                               const float* __restrict__ loc, const float* __restrict__ attw,
                               const __nv_bfloat16* __restrict__ dout,
                               float* __restrict__ dscratch, float* __restrict__ dloc,
                               float* __restrict__ dattw, int C, int len_in, int Q, int H, int P,
                               int lanes, CmLevels lv, CmRoute route) {
  cm_bwd<__nv_bfloat16, kStaged>(value_t, loc, attw, dout, dscratch, dloc, dattw, C, len_in, Q,
                                 H, P, lanes, lv, route);
}

// dst[b, c, s] = src[b, s, c]: (B, len_in, C) f32 -> (B, C, len_in) in T,
// one 32 x 32 tile of (s, c) a CTA, read and written 32 contiguous elements
// a warp
template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows)
position_to_channel_major(const float* __restrict__ src, T* __restrict__ dst, int C, int len_in) {
  __shared__ float tile[kTile][kTile + 1];  // + 1: a column read hits 32 banks
  const int s0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const size_t batch = static_cast<size_t>(blockIdx.z) * len_in * C;
  for (int i = threadIdx.y; i < kTile; i += kTileRows) {
    const int s = s0 + i, c = c0 + threadIdx.x;
    if (s < len_in && c < C) tile[i][threadIdx.x] = src[batch + static_cast<size_t>(s) * C + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < kTile; i += kTileRows) {
    const int c = c0 + i, s = s0 + threadIdx.x;
    if (c < C && s < len_in)
      dst[batch + static_cast<size_t>(c) * len_in + s] = lw::from_f32<T>(tile[threadIdx.x][i]);
  }
}

// lanes of one query: D / 4, rounded up to a power of two
int lanes_of(int D) { return static_cast<int>(lw::pow2_at_least((D + kVec - 1) / kVec)); }

int check(int B, int C, int len_in, int Q, int num_heads, int n_points, int dtype) {
  if (B < 1 || C < 1 || len_in < 1 || Q < 1 || num_heads < 1 || C % num_heads != 0 ||
      n_points < 1 || (dtype != lw::kFloat32 && dtype != lw::kBFloat16))
    return cudaErrorInvalidValue;
  const int D = C / num_heads;  // whole float4s of channels, and at most a warp a point
  if (D % kVec != 0 || lanes_of(D) > 32 || B > 65535) return cudaErrorInvalidValue;
  return cudaSuccess;
}

CmRoute route_of(const void* value_t, int B, int C, int len_in, int Q, int num_heads, int dtype) {
  const size_t isz = dtype == lw::kFloat32 ? sizeof(float) : sizeof(__nv_bfloat16);
  const int D = C / num_heads;
  return lw::cm_route(value_t, B, num_heads, D, len_in, Q, isz, lanes_of(D));
}

template <typename T>
auto kernel_for(const CmRoute& r) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return r.staged ? &deform_attn_cm_bwd_kernel_bf16<true> : &deform_attn_cm_bwd_kernel_bf16<false>;
  else
    return r.staged ? &deform_attn_cm_bwd_kernel<T, true> : &deform_attn_cm_bwd_kernel<T, false>;
}

template <typename T>
int launch(const CmRoute& r, const void* value_t, const void* loc, const void* attw,
           const void* dout, void* dscratch, void* dvalue_t, void* dloc, void* dattw, int B,
           int C, int len_in, int Q, int H, int P, const CmLevels& lv, cudaStream_t st) {
  const cudaError_t err = lw::cm_launch(
      kernel_for<T>(r), r, B * H, st, static_cast<const T*>(value_t),
      static_cast<const float*>(loc), static_cast<const float*>(attw), static_cast<const T*>(dout),
      static_cast<float*>(dscratch), static_cast<float*>(dloc), static_cast<float*>(dattw), C,
      len_in, Q, H, P, lanes_of(C / H), lv, r);
  if (err != cudaSuccess) return err;
  const dim3 grid((len_in + kTile - 1) / kTile, (C + kTile - 1) / kTile, B);
  position_to_channel_major<T><<<grid, dim3(kTile, kTileRows), 0, st>>>(
      static_cast<const float*>(dscratch), static_cast<T*>(dvalue_t), C, len_in);
  return cudaGetLastError();
}

}  // namespace

// value_t (B, C, len_in) and dout (B, C, Q) in `dtype`, with the gradient
// dvalue_t (B, C, len_in) in `dtype`; dscratch (B, len_in, C) f32, zeroed by
// the caller, 16-byte aligned, which the kernel adds into; loc (B, Q, H, L, P,
// 2) and attw (B, Q, H, L, P) f32 with gradients dloc, dattw of the same
// shapes; level l spans value_t[..., start[l] : start[l] + h[l] w[l]]. All
// contiguous; the head dim C / num_heads a multiple of 4, at most 128;
// `level_hw_start` is a host array.
extern "C" int lw_deform_attn_cm_bwd(const void* value_t, const void* loc, const void* attw,
                                     const void* dout, void* dscratch, void* dvalue_t, void* dloc,
                                     void* dattw, int B, int C, int len_in, int Q, int num_heads,
                                     int n_levels, int n_points, const int* level_hw_start,
                                     int dtype, void* stream) {
  if (const int err = check(B, C, len_in, Q, num_heads, n_points, dtype)) return err;
  if (reinterpret_cast<uintptr_t>(dscratch) % 16 != 0) return cudaErrorInvalidValue;
  CmLevels lv;
  if (const int err = lw::cm_levels(level_hw_start, n_levels, len_in, &lv)) return err;
  const CmRoute r = route_of(value_t, B, C, len_in, Q, num_heads, dtype);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == lw::kFloat32)
    return launch<float>(r, value_t, loc, attw, dout, dscratch, dvalue_t, dloc, dattw, B, C,
                         len_in, Q, num_heads, n_points, lv, st);
  return launch<__nv_bfloat16>(r, value_t, loc, attw, dout, dscratch, dvalue_t, dloc, dattw, B,
                               C, len_in, Q, num_heads, n_points, lv, st);
}

// The route `lw_deform_attn_cm_bwd` takes for these arguments (deform_cm.cuh,
// `report_route`): route[0..6].
extern "C" int lw_deform_attn_cm_bwd_route(const void* value_t, int B, int C, int len_in, int Q,
                                           int num_heads, int dtype, int* route) {
  if (const int err = check(B, C, len_in, Q, num_heads, 1, dtype)) return err;
  const CmRoute r = route_of(value_t, B, C, len_in, Q, num_heads, dtype);
  return lw::report_route(r,
                          dtype == lw::kFloat32
                              ? reinterpret_cast<const void*>(kernel_for<float>(r))
                              : reinterpret_cast<const void*>(kernel_for<__nv_bfloat16>(r)),
                          route);
}
