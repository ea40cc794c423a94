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
// location x in [0, 1] maps to the pixel coordinate x W_l - 0.5 (rounded as
// PyTorch rounds it, `lw::pixel`), the four corners around it are weighted
// bilinearly, and a corner outside the level contributes zero.
//
// The TPU kernel factors the gather into a (q, H_l) one-hot row-mask matmul,
// a (q, W_l D) column mask and a lane-regroup matmul, fed by per-axis indices
// and weights packed ahead of it, because a TPU gathers badly. What carries
// over is its order: the indices and weights once, then the values. Here the
// gather is a load.
//
// What bounds it on an H100: each (b, q, h) reads 4 L P corners of D
// channels and does as many D-wide multiply-adds, a few hundred bytes per
// flop-pair, so it is bound by bytes: at least the corners its points name,
// once, in practice every corner read from L2 (at large@640, batch 8, 57,600
// (b, q, h) x 32 corners x 64 B = 118 MB in f32). The design keeps enough
// of those reads in flight that L2's rate for them, not their latency, is
// what it waits on:
// 1. The point table. A CTA takes a tile of `queries` queries x `heads`
//    heads of one image. Its threads first form, once per sampling point
//    (one thread a point, reading loc and the attention weight coalesced), the
//    address of the point's upper-left corner in its (b, h, l) map and the
//    step to the row below, both clamped into the map, and the four corner
//    weights aw x bilinear, zero for a corner outside the map or a point
//    outside (-1, W) x (-1, H) or NaN (no index is formed from those), into
//    shared memory: 28 bytes a point.
// 2. The gathers. Each thread then owns V neighbouring channels of one (q, h)
//    (V = 4 in f32: one 16-byte load a corner; V = 8 in bf16: one 16-byte
//    load): it reads its point's table entries (a broadcast over the head's D /
//    V threads) and issues the four corner loads of G points (2 or 4) before
//    it uses any of them. Every address is inside the map and every weight is
//    already zero where a corner drops out, so nothing branches between the
//    loads and 4 G of them are in flight. Accumulation is f32, in the order
//    levels, points, corners, rounded once on the store. Points are padded to
//    a multiple of G with points of weight 0.
// 3. The work order. A CTA covers a run of queries of one (b, h) map, so its
//    gathers stay in one map and neighbouring CTAs take the same map (all
//    heads of a few queries ran 14-68% slower in bf16 at large's eval), or of
//    as few heads as fill a 32-byte sector with a query's attention weights
//    (4 heads at 2 points a (q, h): 8-16% faster than one map at small's train
//    shape). The output rows of a (q, h) are D contiguous channels.
// The times are device times on an H100 (`bench_variants.py`, which builds
// the variants named here from this source).
// K10 differs in the addresses alone: position (y, x) of level l lies at
// value[b, start_l + y W_l + x, h, :], so neighbouring positions are H D
// elements apart and the heads of one position are contiguous.
//
// bf16 rounds where the TPU kernels round, not once (deform_attn_sep_bf16_kernel;
// the f32 kernel above is untouched by it). K4 as _sep_kernel: the table holds
// a point's y-weights and x-weights rounded to bf16 (the attention weight
// folded into the x-weights first, _prep_separable), the row gather of each of
// its two columns is summed in f32 and times its x-weight, rounded; the
// entries of one level's points that share a column are summed in f32, in
// point order, and the sum rounded to bf16 before the columns are summed in
// f32 (`msum.astype(dt)`). K10 as _deform_kernel:
// the weights (1-fy)(1-fx) aw of the corners of one (q, h) that land on one
// position are summed in f32 and the sum rounded to bf16 before its product
// with the value. A thread finds the entries of a column (a position) by
// comparing the table's columns (addresses), first occurrence first, and
// loads one entry's rows at a time: slower than the f32 kernel's loads in
// flight, and bound by their latency.
#include <algorithm>
#include <type_traits>

#include "deform_layout.cuh"

namespace {

using lw::kMaxLevels;
using lw::PanelLayout;
using lw::RowMajorLayout;

constexpr int kThreads = 256;  // most threads a CTA

struct Levels {
  int n;
  int len_in;  // positions of all levels together (the row-major layout's batch stride)
  int h[kMaxLevels];
  int w[kMaxLevels];
  const void* panel[kMaxLevels];  // level l's first element
};

// A launch's cover of its B x H maps and Q queries: CTA x takes image b, heads
// [h0, h0 + heads) and queries [q0, q0 + queries), the query tile fastest
struct Tile {
  int heads;        // a CTA
  int queries;      // a CTA
  int head_groups;  // ceil(H / heads)
  int query_tiles;  // ceil(Q / queries)
};

// A thread's channels of a corner: 16 bytes, one vector load
constexpr int kLoadBytes = 16;
template <typename T> struct Channels;
template <> struct Channels<float> {
  static constexpr int V = 4;
  using Raw = float4;
};

// a bf16 is the high half of an f32
__device__ __forceinline__ float lo(unsigned x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi(unsigned x) { return __uint_as_float(x & 0xffff0000u); }

// acc += a x channels
__device__ __forceinline__ void axpy(float a, float4 x, float (&acc)[4]) {
  acc[0] = fmaf(a, x.x, acc[0]);
  acc[1] = fmaf(a, x.y, acc[1]);
  acc[2] = fmaf(a, x.z, acc[2]);
  acc[3] = fmaf(a, x.w, acc[3]);
}
__device__ __forceinline__ void axpy(float a, uint4 x, float (&acc)[8]) {
  acc[0] = fmaf(a, lo(x.x), acc[0]);
  acc[1] = fmaf(a, hi(x.x), acc[1]);
  acc[2] = fmaf(a, lo(x.y), acc[2]);
  acc[3] = fmaf(a, hi(x.y), acc[3]);
  acc[4] = fmaf(a, lo(x.z), acc[4]);
  acc[5] = fmaf(a, hi(x.z), acc[5]);
  acc[6] = fmaf(a, lo(x.w), acc[6]);
  acc[7] = fmaf(a, hi(x.w), acc[7]);
}

// a and b rounded to bf16, to nearest even, a in the low half
__device__ __forceinline__ unsigned bf16x2(float a, float b) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(b), "f"(a));
  return r;
}
__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]),
                                            bf16x2(v[4], v[5]), bf16x2(v[6], v[7]));
}

// One table entry: where the point's corners lie, and their weights.
//   at: the address of channel 0 of corner (ya, xa) in the point's (b, h, l)
//       map, | 1 when (ya, xb) is the next position (xb = xa + 1); a corner's
//       channels start on 8 bytes at least, which frees the low bits
//   dy: elements from (ya, xa) to (yb, xa): a row, or 0
//   w: the weights of (ya, xa), (ya, xb), (yb, xa), (yb, xb)
// with xa, xb, ya, yb the corner coordinates clamped into the map (a corner
// that was clamped has weight 0).
struct Entry {
  unsigned long long at;
  unsigned dy;
  float4 w;
};
// bytes an entry takes in the table, which keeps its three fields apart; the
// bf16 kernel keeps a point's two clamped columns besides
constexpr int kEntryBytes = sizeof(unsigned long long) + sizeof(unsigned) + sizeof(float4);
constexpr int kBf16EntryBytes = kEntryBytes + sizeof(unsigned);
inline int entry_bytes(int dtype) { return dtype == lw::kFloat32 ? kEntryBytes : kBf16EntryBytes; }

// `map`: position (0, 0) of the point's (b, h, l) map
template <typename T>
__device__ __forceinline__ Entry point_entry(const float* loc, const float* attw, size_t pt,
                                             bool real, const T* map, int Wl, int Hl, int xs) {
  float x = 0.f, y = 0.f, aw = 0.f;
  if (real) {
    const float2 xy = __ldg(reinterpret_cast<const float2*>(loc) + pt);
    x = xy.x;
    y = xy.y;
    aw = __ldg(attw + pt);
  }
  const float px = lw::pixel(x, Wl);
  const float py = lw::pixel(y, Hl);
  // no corner of a point outside (-1, W) x (-1, H) is in bounds; this also
  // drops NaN and keeps the integer casts below in range
  const bool inside = real && px > -1.f && px < Wl && py > -1.f && py < Hl;
  const float x0f = inside ? floorf(px) : 0.f;
  const float y0f = inside ? floorf(py) : 0.f;
  const float fx = px - x0f;
  const float fy = py - y0f;
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const bool x0ok = inside && x0 >= 0, x1ok = inside && x0 + 1 < Wl;
  const bool y0ok = inside && y0 >= 0, y1ok = inside && y0 + 1 < Hl;
  const int xa = max(x0, 0), xb = min(x0 + 1, Wl - 1);
  const int ya = max(y0, 0), yb = min(y0 + 1, Hl - 1);
  const size_t row = static_cast<size_t>(Wl) * xs;
  Entry e;
  e.at = reinterpret_cast<unsigned long long>(map + ya * row + static_cast<size_t>(xa) * xs) |
         (xb > xa ? 1ull : 0ull);
  e.dy = static_cast<unsigned>((yb - ya) * row);
  e.w.x = y0ok && x0ok ? aw * (1.f - fy) * (1.f - fx) : 0.f;
  e.w.y = y0ok && x1ok ? aw * (1.f - fy) * fx : 0.f;
  e.w.z = y1ok && x0ok ? aw * fy * (1.f - fx) : 0.f;
  e.w.w = y1ok && x1ok ? aw * fy * fx : 0.f;
  return e;
}

// T: the value's dtype; G: points whose loads are in flight together
template <typename T, typename Layout, int G>
__global__ void __launch_bounds__(kThreads)
deform_attn_sep_kernel(const float* __restrict__ loc, const float* __restrict__ attw,
                       T* __restrict__ out, int Q, int H, int D, int P, Levels lv, Tile tile) {
  constexpr int V = Channels<T>::V;
  using R = typename Channels<T>::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  const int KP = lv.n * P;  // points a (q, h)
  const int KG = (KP + G - 1) / G * G;  // padded with points of weight 0
  const int S = tile.heads * tile.queries;  // (q, h) slots of the tile
  float4* tw = reinterpret_cast<float4*>(smem);  // [KG][S], slot fastest
  unsigned long long* ta = reinterpret_cast<unsigned long long*>(tw + KG * S);
  unsigned* td = reinterpret_cast<unsigned*>(ta + KG * S);

  int blk = blockIdx.x;
  const int qt = blk % tile.query_tiles;
  blk /= tile.query_tiles;
  const int h0 = (blk % tile.head_groups) * tile.heads;
  const int b = blk / tile.head_groups;
  const int q0 = qt * tile.queries;
  const int xs = Layout::x_stride(H, D);  // elements between neighbouring positions

  // 1. the point table: one thread a point, the tile's points in memory order
  for (int i = threadIdx.x; i < S * KG; i += blockDim.x) {
    const int s = i / KG;
    const int k = i - s * KG;
    const int q = q0 + s / tile.heads;
    const int h = h0 + s % tile.heads;
    const int l = min(k / P, lv.n - 1);  // a padding point takes the last level
    const int hc = min(h, H - 1);
    int Wl = lv.w[0], Hl = lv.h[0];
    const void* panel = lv.panel[0];
#pragma unroll
    for (int j = 1; j < kMaxLevels; ++j) {  // constant indices: no stack
      Wl = l == j ? lv.w[j] : Wl;
      Hl = l == j ? lv.h[j] : Hl;
      panel = l == j ? lv.panel[j] : panel;
    }
    const T* map = static_cast<const T*>(panel) + Layout::origin(b, hc, H, D, Hl, Wl, lv.len_in);
    const bool real = k < KP && q < Q && h < H;
    const size_t pt = (static_cast<size_t>(b * Q + min(q, Q - 1)) * H + hc) * KP + min(k, KP - 1);
    const Entry e = point_entry(loc, attw, pt, real, map, Wl, Hl, xs);
    tw[k * S + s] = e.w;
    ta[k * S + s] = e.at;
    td[k * S + s] = e.dy;
  }
  __syncthreads();

  // 2. the gathers: D / V threads a (q, h), V channels each
  const int lanes = D / V;
  const int s = threadIdx.x / lanes;
  const int q = q0 + s / tile.heads;
  const int h = h0 + s % tile.heads;
  if (s >= S || q >= Q || h >= H) return;
  const int c = (threadIdx.x - s * lanes) * V;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int k = 0; k < KG; k += G) {
    R x[G][4];
    float4 w[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const unsigned long long at = ta[(k + j) * S + s];
      w[j] = tw[(k + j) * S + s];
      const T* r0 = reinterpret_cast<const T*>(at & ~7ull) + c;
      const T* r1 = r0 + td[(k + j) * S + s];
      const int dx = at & 1ull ? xs : 0;
      x[j][0] = __ldg(reinterpret_cast<const R*>(r0));
      x[j][1] = __ldg(reinterpret_cast<const R*>(r0 + dx));
      x[j][2] = __ldg(reinterpret_cast<const R*>(r1));
      x[j][3] = __ldg(reinterpret_cast<const R*>(r1 + dx));
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      axpy(w[j].x, x[j][0], acc);
      axpy(w[j].y, x[j][1], acc);
      axpy(w[j].z, x[j][2], acc);
      axpy(w[j].w, x[j][3], acc);
    }
  }
  store(out + (static_cast<size_t>(b * Q + q) * H + h) * D + c, acc);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A point's entry for the bf16 kernel: `at` and `dy` as above; w holds, for
// K4 (kColumns), the y-weights (1-fy), fy and the x-weights (1-fx) aw, fx aw
// of _prep_separable rounded to bf16 (0 where the row or column is outside
// the map), for K10 the four corner weights (1-fy)(1-fx) aw, ... formed in
// _prep_indices_weights' order (0 for a corner outside); col: the clamped
// columns xa | xb << 16.
template <bool kColumns>
__device__ __forceinline__ Entry point_entry_bf16(const float* loc, const float* attw, size_t pt,
                                                  bool real, const __nv_bfloat16* map, int Wl,
                                                  int Hl, int xs, unsigned& col) {
  float x = 0.f, y = 0.f, aw = 0.f;
  if (real) {
    const float2 xy = __ldg(reinterpret_cast<const float2*>(loc) + pt);
    x = xy.x;
    y = xy.y;
    aw = __ldg(attw + pt);
  }
  const float px = lw::pixel(x, Wl);
  const float py = lw::pixel(y, Hl);
  const bool inside = real && px > -1.f && px < Wl && py > -1.f && py < Hl;
  const float x0f = inside ? floorf(px) : 0.f;
  const float y0f = inside ? floorf(py) : 0.f;
  const float fx = __fsub_rn(px, x0f);
  const float fy = __fsub_rn(py, y0f);
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const bool x0ok = inside && x0 >= 0, x1ok = inside && x0 + 1 < Wl;
  const bool y0ok = inside && y0 >= 0, y1ok = inside && y0 + 1 < Hl;
  const int xa = max(x0, 0), xb = min(x0 + 1, Wl - 1);
  const int ya = max(y0, 0), yb = min(y0 + 1, Hl - 1);
  const size_t row = static_cast<size_t>(Wl) * xs;
  Entry e;
  e.at = reinterpret_cast<unsigned long long>(map + ya * row + static_cast<size_t>(xa) * xs) |
         (xb > xa ? 1ull : 0ull);
  e.dy = static_cast<unsigned>((yb - ya) * row);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  if (kColumns) {
    e.w.x = round_bf16(y0ok ? gy : 0.f);
    e.w.y = round_bf16(y1ok ? fy : 0.f);
    e.w.z = round_bf16(x0ok ? __fmul_rn(gx, aw) : 0.f);
    e.w.w = round_bf16(x1ok ? __fmul_rn(fx, aw) : 0.f);
  } else {
    e.w.x = y0ok && x0ok ? __fmul_rn(__fmul_rn(gy, gx), aw) : 0.f;
    e.w.y = y0ok && x1ok ? __fmul_rn(__fmul_rn(gy, fx), aw) : 0.f;
    e.w.z = y1ok && x0ok ? __fmul_rn(__fmul_rn(fy, gx), aw) : 0.f;
    e.w.w = y1ok && x1ok ? __fmul_rn(__fmul_rn(fy, fx), aw) : 0.f;
  }
  col = static_cast<unsigned>(xa) | static_cast<unsigned>(xb) << 16;
  return e;
}

// a channel pair of the row gather: two exact products (bf16 x bf16), one
// rounding; times the x-weight, rounded; added in f32
__device__ __forceinline__ void mix2(float wy0, unsigned a, float wy1, unsigned b, float wx,
                                     float& s0, float& s1) {
  s0 = __fadd_rn(s0, __fmul_rn(wx, fmaf(wy0, lo(a), wy1 * lo(b))));
  s1 = __fadd_rn(s1, __fmul_rn(wx, fmaf(wy0, hi(a), wy1 * hi(b))));
}
// sum += wx (wy0 v0 + wy1 v1) over 8 bf16 channels, rounded as _sep_kernel
__device__ __forceinline__ void row_mix(float wy0, uint4 v0, float wy1, uint4 v1, float wx,
                                        float (&sum)[8]) {
  mix2(wy0, v0.x, wy1, v1.x, wx, sum[0], sum[1]);
  mix2(wy0, v0.y, wy1, v1.y, wx, sum[2], sum[3]);
  mix2(wy0, v0.z, wy1, v1.z, wx, sum[4], sum[5]);
  mix2(wy0, v0.w, wy1, v1.w, wx, sum[6], sum[7]);
}

// weight `i` of an entry's four, picked without indexing (no stack)
__device__ __forceinline__ float comp(const float4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// the bf16 samplers (K4: kColumns, K10: positions), rounding as the TPU kernels do
// (a minimum of one CTA an SM: at the default ptxas spilled 8 bytes to stay at 48 registers)
template <typename Layout, bool kColumns>
__global__ void __launch_bounds__(kThreads, 1)
deform_attn_sep_bf16_kernel(const float* __restrict__ loc, const float* __restrict__ attw,
                            __nv_bfloat16* __restrict__ out, int Q, int H, int D, int P,
                            Levels lv, Tile tile) {
  using T = __nv_bfloat16;
  constexpr int V = 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int KP = lv.n * P;  // points a (q, h)
  const int S = tile.heads * tile.queries;
  float4* tw = reinterpret_cast<float4*>(smem);  // [KP][S], slot fastest
  unsigned long long* ta = reinterpret_cast<unsigned long long*>(tw + KP * S);
  unsigned* td = reinterpret_cast<unsigned*>(ta + KP * S);
  unsigned* tc = td + KP * S;

  int blk = blockIdx.x;
  const int qt = blk % tile.query_tiles;  // the query tile
  blk /= tile.query_tiles;
  const int h0 = (blk % tile.head_groups) * tile.heads;
  const int b = blk / tile.head_groups;
  const int q0 = qt * tile.queries;
  const int xs = Layout::x_stride(H, D);

  for (int i = threadIdx.x; i < S * KP; i += blockDim.x) {
    const int s = i / KP;
    const int k = i - s * KP;
    const int q = q0 + s / tile.heads;
    const int h = h0 + s % tile.heads;
    const int l = k / P;
    const int hc = min(h, H - 1);
    int Wl = lv.w[0], Hl = lv.h[0];
    const void* panel = lv.panel[0];
#pragma unroll
    for (int j = 1; j < kMaxLevels; ++j) {
      Wl = l == j ? lv.w[j] : Wl;
      Hl = l == j ? lv.h[j] : Hl;
      panel = l == j ? lv.panel[j] : panel;
    }
    const T* map = static_cast<const T*>(panel) + Layout::origin(b, hc, H, D, Hl, Wl, lv.len_in);
    const bool real = q < Q && h < H;
    const size_t pt = (static_cast<size_t>(b * Q + min(q, Q - 1)) * H + hc) * KP + k;
    unsigned col;
    const Entry e = point_entry_bf16<kColumns>(loc, attw, pt, real, map, Wl, Hl, xs, col);
    tw[k * S + s] = e.w;
    ta[k * S + s] = e.at;
    td[k * S + s] = e.dy;
    tc[k * S + s] = col;
  }
  __syncthreads();

  const int lanes = D / V;
  const int s = threadIdx.x / lanes;
  const int q = q0 + s / tile.heads;
  const int h = h0 + s % tile.heads;
  if (s >= S || q >= Q || h >= H) {  // a slot past the tile
    return;
  }
  const int c = (threadIdx.x - s * lanes) * V;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int l = 0; l < lv.n; ++l) {
    const int k0 = l * P;
    if (kColumns) {
      // entries e = 2 p + side: point p's column xa (side 0) or xb (side 1)
      for (int e = 0; e < 2 * P; ++e) {
        const unsigned cl = (tc[(k0 + e / 2) * S + s] >> (16 * (e & 1))) & 0xffffu;
        bool first = true;
        for (int f = 0; f < e; ++f)
          first = first && ((tc[(k0 + f / 2) * S + s] >> (16 * (f & 1))) & 0xffffu) != cl;
        if (!first) continue;
        float sum[V];
#pragma unroll
        for (int v = 0; v < V; ++v) sum[v] = 0.f;
        for (int f = e; f < 2 * P; ++f) {  // the column's entries, in point order
          const int k = (k0 + f / 2) * S + s;
          if (((tc[k] >> (16 * (f & 1))) & 0xffffu) != cl) continue;
          const unsigned long long at = ta[k];
          const float4 w = tw[k];
          const T* r0 = reinterpret_cast<const T*>(at & ~7ull) + c + ((f & 1) && (at & 1ull) ? xs : 0);
          const uint4 v0 = __ldg(reinterpret_cast<const uint4*>(r0));
          const uint4 v1 = __ldg(reinterpret_cast<const uint4*>(r0 + td[k]));
          row_mix(w.x, v0, w.y, v1, (f & 1) ? w.w : w.z, sum);
        }
        // the column's rounded sum, added in f32 (the TPU kernel sums a
        // level's columns first, then adds the level: another f32 order)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], round_bf16(sum[v]));
      }
    } else {
      // entries j = corner * P + p, the order of _prep_indices_weights; a
      // corner's position is its address
      for (int j = 0; j < 4 * P; ++j) {
        const int cj = j / P;
        const int k = (k0 + j - cj * P) * S + s;
        const unsigned long long at = ta[k];
        const T* pj = reinterpret_cast<const T*>(at & ~7ull) + ((cj & 1) && (at & 1ull) ? xs : 0) +
                      (cj >= 2 ? td[k] : 0u);
        bool first = true;
        for (int f = 0; f < j; ++f) {
          const int cf = f / P;
          const int kf = (k0 + f - cf * P) * S + s;
          const unsigned long long af = ta[kf];
          const T* pf = reinterpret_cast<const T*>(af & ~7ull) +
                        ((cf & 1) && (af & 1ull) ? xs : 0) + (cf >= 2 ? td[kf] : 0u);
          first = first && pf != pj;
        }
        if (!first) continue;
        float wsum = 0.f;
        for (int f = j; f < 4 * P; ++f) {
          const int cf = f / P;
          const int kf = (k0 + f - cf * P) * S + s;
          const unsigned long long af = ta[kf];
          const T* pf = reinterpret_cast<const T*>(af & ~7ull) +
                        ((cf & 1) && (af & 1ull) ? xs : 0) + (cf >= 2 ? td[kf] : 0u);
          if (pf == pj) wsum = __fadd_rn(wsum, comp(tw[kf], cf));
        }
        const float wr = round_bf16(wsum);
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(pj + c));
        axpy(wr, x, acc);  // bf16 x bf16: exact products
      }
    }
  }
  store(out + (static_cast<size_t>(b * Q + q) * H + h) * D + c, acc);  // rounded once
}

// How one launch covers its work
struct Route {
  int vec;    // channels a thread
  int group;  // points whose loads are in flight together
  Tile tile;
  int threads;  // a CTA
  int smem;     // bytes of the point table
  long long ctas;
};

Route route(int B, int Q, int H, int D, int n_levels, int P, int dtype) {
  Route r;
  r.vec = kLoadBytes / (dtype == lw::kFloat32 ? sizeof(float) : sizeof(__nv_bfloat16));
  const int KP = n_levels * P;
  // f32 takes 4 points when they divide a (q, h)'s points (1-4% faster than 2
  // at large's eval), else 2; the bf16 kernel loads one entry's rows at a time
  r.group = dtype != lw::kFloat32 ? 1 : KP % 4 == 0 ? 4 : 2;
  const int KG = (KP + r.group - 1) / r.group * r.group;
  const int lanes = D / r.vec;
  // (q, h) slots a CTA: a CTA's threads, and a table of at most 48 KB
  const int slots = std::max(1, std::min(kThreads / lanes,
                                         48 * 1024 / (KG * entry_bytes(dtype))));
  // the fewest heads (a power of two) whose points of one query fill a
  // 32-byte sector of the attention weights, so that the table reads whole
  // sectors: one (b, h) map a CTA at 8 points a (q, h), 4 heads at 2 points
  r.tile.heads = 1;
  while (r.tile.heads < H && r.tile.heads * KP * static_cast<int>(sizeof(float)) < 32 &&
         2 * r.tile.heads <= slots)
    r.tile.heads *= 2;
  r.tile.head_groups = (H + r.tile.heads - 1) / r.tile.heads;
  const int qslots = slots / r.tile.heads;
  r.tile.query_tiles = (Q + qslots - 1) / qslots;
  r.tile.queries = (Q + r.tile.query_tiles - 1) / r.tile.query_tiles;
  r.threads = (r.tile.queries * r.tile.heads * lanes + 31) / 32 * 32;
  r.smem = KG * r.tile.queries * r.tile.heads * entry_bytes(dtype);
  r.ctas = static_cast<long long>(B) * r.tile.head_groups * r.tile.query_tiles;
  return r;
}

template <typename T, typename Layout, int G>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(&deform_attn_sep_kernel<T, Layout, G>);
}

// the kernel a route runs, nullptr for a dtype it does not take; bf16 rounds
// as the TPU kernel of its layout does (K4: per column, K10: per position)
template <typename Layout>
const void* pick(const Route& r, int dtype) {
  if (dtype == lw::kFloat32)
    return r.group == 4 ? kernel_fn<float, Layout, 4>() : kernel_fn<float, Layout, 2>();
  constexpr bool kColumns = std::is_same<Layout, PanelLayout>::value;
  return dtype == lw::kBFloat16
             ? reinterpret_cast<const void*>(&deform_attn_sep_bf16_kernel<Layout, kColumns>)
             : nullptr;
}

template <typename Layout>
int launch(const Levels& lv, const void* loc, const void* attw, void* out, int B, int Q,
           int num_heads, int head_dim, int n_points, int dtype, void* stream) {
  const Route r = route(B, Q, num_heads, head_dim, lv.n, n_points, dtype);
  const void* fn = pick<Layout>(r, dtype);
  if (fn == nullptr) return cudaErrorInvalidValue;
  if (r.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, r.smem);
    if (err != cudaSuccess) return err;
  }
  const float* lp = static_cast<const float*>(loc);
  const float* wp = static_cast<const float*>(attw);
  Tile tile = r.tile;
  Levels levels = lv;
  void* args[] = {&lp, &wp, &out, &Q, &num_heads, &head_dim, &n_points, &levels, &tile};
  return cudaLaunchKernel(fn, dim3(static_cast<unsigned>(r.ctas)), dim3(r.threads), args,
                          r.smem, static_cast<cudaStream_t>(stream));
}

// head_dim: whole 16-byte loads (4 f32 channels, 8 bf16), at most one CTA's
bool sizes_ok(int B, int Q, int num_heads, int head_dim, int n_levels, int n_points,
              int dtype) {
  const int vec = dtype == lw::kFloat32 ? 4 : 8;
  return (dtype == lw::kFloat32 || dtype == lw::kBFloat16) && B >= 1 && Q >= 1 &&
         num_heads >= 1 && head_dim >= vec && head_dim % vec == 0 &&
         head_dim <= vec * kThreads && n_points >= 1 && n_levels >= 1 &&
         n_levels <= kMaxLevels;
}

// route[0..8]: channels a thread, points in flight together, heads and
// queries a CTA, threads a CTA, shared bytes, CTAs, and the registers and
// local (stack and spilled) bytes a thread of the kernel that runs
template <typename Layout>
int report(int B, int Q, int num_heads, int head_dim, int n_levels, int n_points, int dtype,
           int* out) {
  if (!sizes_ok(B, Q, num_heads, head_dim, n_levels, n_points, dtype)) return cudaErrorInvalidValue;
  const Route r = route(B, Q, num_heads, head_dim, n_levels, n_points, dtype);
  const void* fn = pick<Layout>(r, dtype);
  if (fn == nullptr) return cudaErrorInvalidValue;
  int attrs[3];
  if (const int err = lw::kernel_attributes(fn, attrs)) return err;
  const int v[9] = {r.vec, r.group, r.tile.heads, r.tile.queries, r.threads, r.smem,
                    static_cast<int>(r.ctas), attrs[0], attrs[1]};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return cudaSuccess;
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
  if (!sizes_ok(B, Q, num_heads, head_dim, n_levels, n_points, dtype)) return cudaErrorInvalidValue;
  Levels lv{};
  lv.n = n_levels;
  lv.len_in = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    lv.panel[l] = panels[l];
    // the table's row step is 32-bit
    if (lv.h[l] < 1 || lv.w[l] < 1 || lv.panel[l] == nullptr ||
        reinterpret_cast<size_t>(lv.panel[l]) % 16 != 0 ||
        static_cast<long long>(lv.w[l]) * head_dim >= (1LL << 31))
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
  if (!sizes_ok(B, Q, num_heads, head_dim, n_levels, n_points, dtype) || value == nullptr ||
      reinterpret_cast<size_t>(value) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t position = static_cast<size_t>(num_heads) * head_dim *
                          (dtype == lw::kFloat32 ? sizeof(float) : sizeof(__nv_bfloat16));
  Levels lv{};
  lv.n = n_levels;
  lv.len_in = len_in;
  long long start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    // the table's row step is 32-bit
    if (lv.h[l] < 1 || lv.w[l] < 1 ||
        static_cast<long long>(lv.w[l]) * num_heads * head_dim >= (1LL << 31))
      return cudaErrorInvalidValue;
    lv.panel[l] = static_cast<const char*>(value) + start * position;
    start += static_cast<long long>(lv.h[l]) * lv.w[l];
  }
  if (start != len_in) return cudaErrorInvalidValue;
  return launch<RowMajorLayout>(lv, loc, attw, out, B, Q, num_heads, head_dim, n_points, dtype,
                                stream);
}

// The route a K4 / K10 launch of these sizes takes (see `report`).
extern "C" int lw_deform_attn_sep_route(int B, int Q, int num_heads, int head_dim, int n_levels,
                                        int n_points, int dtype, int* route) {
  return report<PanelLayout>(B, Q, num_heads, head_dim, n_levels, n_points, dtype, route);
}
extern "C" int lw_deform_attn_rowmajor_route(int B, int Q, int num_heads, int head_dim,
                                             int n_levels, int n_points, int dtype, int* route) {
  return report<RowMajorLayout>(B, Q, num_heads, head_dim, n_levels, n_points, dtype, route);
}
