// The wide case of the attention kernels: any head_dim that is a multiple of
// 64, from 128 up.
//
// Replaces, at those head dims, lwdetr_tpu/ops/flash_attention.py's
// _attn_cm_kernel and _attn_cm_allheads_kernel (forwards) and
// _attn_cm_bwd_kernel and _attn_cm_bwd_allheads_kernel (backwards). The JAX
// package computes the decoder's head_dim from the CLI's --hidden_dim /
// --sa_nheads (e.g. 256 / 2 = 128, 512 / 1 = 512); the ViT's heads never
// exceed 64. K2 (flash_attention.cu), K9 (window_attention.cu), K6
// (flash_attention_bwd.cu) and the no-bias case of K7 (window_attention_bwd.cu,
// "K7nb") launch these kernels at those head dims; `attention_cm` zero-pads
// any other head_dim above 64 to the next multiple of 64. They compute what
// the narrow cases compute, in f32 and bf16, with the bf16 roundings of the
// JAX kernels: p = exp2(s - max) rounded to bf16 before PV and the f32 row
// sum of the unrounded p after it (forward); ds and p rounded to bf16 before
// the three products of the backward, the row term sum_j p dp from the
// unrounded p.
//
// What bounds them on an H100. Per (query, key) pair the forward does 2 D
// multiply-adds (QK^T, PV) and the backward 5 (S, dP, dQ, dK, dV) against
// one exponential, so at D >= 128 the tensor cores' rate is the bound the
// card sets (the bytes, q, k, v read once, are less). Three things stand in
// the way of feeding them:
// - a head's rows do not fit on an SM: at D = 2048 the output accumulator of
//   64 queries alone is 512 KB in f32, their q 256 KB in bf16;
// - the eval shapes give few (image, head) pairs: 8 images x 1 head x 300
//   queries is 40 blocks of 64 queries for 132 SMs;
// - N = 300 / 100 rows are no multiple of 16 bytes, so no TMA, and a step's
//   copies go by 8-byte cp.async (4-byte for N = 150).
// What bounds these kernels as built is none of the card's rates: a step
// (one 64-channel chunk of a 64-token tile) costs its block about 1 to 2 us,
// of which the thread's issue of the step's copies takes most (clock64 around
// each part, NVIDIA H100: 580-1320 cycles issuing, 135-180 waiting, 20-90 at
// the barrier), and neither a deeper ring (3, 4 and 8 slots timed alike) nor
// dropping phase 1's copies (10-20 % less time) or its products (11-12 % in
// bf16, 28-30 % in f32) removes it. PERF.md has the numbers.
//
// The design: nothing a block keeps grows with D.
// - A score accumulates over 64-channel chunks of D: each step of a block
//   stages a 64-channel chunk of the streamed key (or query) tile, with that
//   of its own rows, and the warps add the chunk's products into the scores'
//   f32 accumulators (mma.sync; `mma_tn` of attention_bwd.cuh reads the
//   fragments straight from the [channel][token] rows). No row of D floats
//   is held anywhere.
// - Where a block's rows of scores over all N tokens fit in shared memory
//   (N up to about 1150 to 3000 by dtype and pass), the resident kernels
//   (below) keep them there: each score is formed once, the softmax is
//   exact, and the output channels are walked 128 at a time against the
//   resident weights. A cluster of blocks shares a block's rows where the
//   shape gives too few blocks.
// - bf16 heads of 128 channels, where the shape gives every SM a block of 64
//   rows, take FlashAttention-2's shape instead (below): the block's q (or k,
//   v) staged once, the output accumulators in registers, one step a whole
//   64-token tile (1.7-2.6x the resident kernels there).
// - Longer rows take the streaming kernels (past about 1150 tokens in the
//   f32 backward, 3000 in the bf16 forward: no configuration of the JAX
//   package gives them, so they keep one plan, untuned). A block of 4 warps
//   of 16 rows (2 warps of one group where 4 leave SMs idle) owns a span of
//   output channels (forward and dQ: 128; dK and dV: 64) and each warp keeps
//   that span of its rows in registers (FlashAttention-2's shape; P and dS
//   go through shared memory to the next product's A operand). Every block
//   forms its scores over all D channels, so a head split into D / span
//   spans forms them D / span times: the price of registers and shared
//   memory that do not grow with D.
// - Steps stream through a ring of 2 to 8 slots in shared memory (cp.async,
//   16-, 8- or 4-byte copies or plain loads, picked on the host from N and
//   the pointers: `copy_width`); a slot holds 128 channel rows of 64 tokens
//   (two 64-row tiles). Each thread's copy geometry and the steps' tile and
//   chunk are worked out once a kernel (`Copier`, `FastDiv`).
// - bf16: mma.sync.m16n8k16, bf16 operands, f32 accumulators; packing P and
//   dS to bf16 for the A operand rounds them to nearest even, as the JAX
//   kernels round. f32: 3xTF32 on mma.sync.m16n8k8.tf32 (attention_bwd.cuh),
//   and each 64-channel chunk's products are summed in fresh accumulators and
//   added to the running scores with f32 adds (the tensor cores' accumulator
//   truncates: a chain of D / 8 x 3 adds would drift past the f32 tolerance).
//
// The streaming kernels:
//   forward (K2, K9): a block of queries and one span walks the key tiles
//     with an online softmax: D / 64 score steps, then steps that stage the
//     span of v and add P V; writes the row log-sum-exp in log2 units when
//     asked (K6 reads it).
//   backward pass 1, a block of queries: the row term row_i = sum_j p dp
//     (and, when no forward wrote one, K7nb, the row log-sum-exp, online: one
//     sweep) into `delta` / `lse`.
//   backward pass 2, a block of queries and a dq span: S and dP over the key
//     tiles, dS, dQ += dS K^T.
//   backward pass 3, a block of keys and a dk / dv span: S^T and dP^T over
//     the query tiles, P^T, dS^T, dK += dS^T Q^T, dV += P^T dO^T.
// Ragged tails: a key past N gets p = 0 (the last key tile is masked); a
// query past N has lse = +inf, so p = 0 and it adds nothing to dk or dv.
#pragma once

#include <cooperative_groups.h>

#include "attention_bwd.cuh"
#include "common.cuh"

namespace lw_wide {

namespace cg = cooperative_groups;

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // at most 4 warps a block
constexpr int kCols = 64;      // tokens of a streamed tile
constexpr int kChunk = 64;     // channels a score step adds
constexpr int kStride = lw::tile_stride(kCols);
constexpr int kSlotRows = 128;  // channel rows of a ring slot: two 64-row tiles
constexpr int kSlotElems = kSlotRows * kStride;
constexpr int kGroup = 32;  // output channels of one accumulator group (4 C tiles)
constexpr int kMaxRowGroups = 4;
// a block's score tiles in shared memory (put_tiles): (warp, tile, element,
// lane) floats
constexpr int kTileFloats = kMaxRowGroups * 8 * 4 * 32;

inline bool takes(int D) { return D >= 128 && D % 64 == 0; }

constexpr int kMaxStages = 8;  // slots of the ring, at most; the host picks 2 to 8

// The widest copy (elements) that keeps every row of a (rows, n) array at
// `base` aligned: `lw::copy_vec`'s 16 and 8 bytes, and for bf16 rows of an
// even length 4 bytes (two tokens) before single elements, so that N = 150
// still streams by cp.async.
inline int copy_width(const void* base, int n, int elem_bytes) {
  const int v = lw::copy_vec(base, n, elem_bytes);
  if (v > 1 || elem_bytes != 2) return v;
  return n % 2 == 0 && reinterpret_cast<uintptr_t>(base) % 4 == 0 ? 2 : 1;
}

// A thread's share of copying a (rows x cols) tile, tokens contiguous, of a
// (rows, n) array into slot rows of kStride, zeros past column n: its first
// row r0, every `step` rows after it, and its column c, a vector of `vec`
// elements (copy_width's). Worked out once a kernel: no division lies on a
// copy's path (an integer division is a long dependent sequence on the GPU,
// and a step's copies are issued on its critical path).
struct Copier {
  int vec, cols, tid, nthreads, r0, step, c;
  __device__ __forceinline__ Copier(int vec_, int cols_, int tid_, int nthreads_)
      : vec(vec_), cols(cols_), tid(tid_), nthreads(nthreads_) {
    const int per_row = cols / vec;
    step = nthreads / per_row;
    r0 = tid / per_row;
    c = (tid - r0 * per_row) * vec;
  }

  // rows [0, kRows) x columns [c0, c0 + cols) of src (row stride n) into dst
  template <int kRows, typename T>
  __device__ __forceinline__ void copy(T* dst, const T* src, int n, int c0) const {
    const int bytes = vec * static_cast<int>(sizeof(T));
    if (bytes < 4) {  // bf16 rows of an odd length: plain loads
      lw::load_rows<1, kRows>(dst, kStride, src, n, c0, cols, tid, nthreads);
      return;
    }
    if (r0 >= step) return;  // past the last whole set of rows
    const bool ok = c0 + c < n;
    const T* s = src + static_cast<size_t>(r0) * n + (ok ? c0 + c : 0);
    T* d = dst + r0 * kStride + c;
    const size_t ss = static_cast<size_t>(step) * n;
    const int ds = step * kStride;
    if (bytes == 16) {
      for (int r = r0; r < kRows; r += step, s += ss, d += ds) lw::cp_async<16>(d, s, ok);
    } else if (bytes == 8) {
      for (int r = r0; r < kRows; r += step, s += ss, d += ds) lw::cp_async<8>(d, s, ok);
    } else {
      for (int r = r0; r < kRows; r += step, s += ss, d += ds) lw::cp_async<4>(d, s, ok);
    }
  }
};

// n / d and n % d for 0 <= n < 2^31 by a multiply-high and a shift, d fixed
// a kernel (the step bookkeeping's divisions)
struct FastDiv {
  int d;
  unsigned m, sh;
  __device__ __forceinline__ explicit FastDiv(int div) : d(div), m(0), sh(0) {
    if (d > 1) {
      const unsigned k = 32 - __clz(d - 1);  // ceil(log2 d)
      m = static_cast<unsigned>(((1ull << (31 + k)) + d - 1) / d);
      sh = k - 1;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d > 1 ? static_cast<int>(__umulhi(static_cast<unsigned>(n), m) >> sh) : n;
  }
  __device__ __forceinline__ int mod(int n) const { return n - div(n) * d; }
};

template <typename T>
constexpr size_t slot_bytes() {
  return kSlotElems * sizeof(T);
}

// dynamic shared bytes of a streaming kernel beside its ring: the score
// tiles (`tiles` arrays) and a query tile's lse and delta
inline size_t streaming_extra(int tiles) {
  return (static_cast<size_t>(tiles) * kTileFloats + 2 * kCols) * sizeof(float);
}

// the block's layout: warps in G column groups of R = warps / G row groups
template <int G>
struct Layout {
  int tid, lane, g, t, rg, cg, rows, m0;
  __device__ __forceinline__ Layout() {
    tid = threadIdx.x;
    const int warp = tid / 32, R = blockDim.x / 32 / G;
    lane = tid % 32;
    g = lane / 4;
    t = lane % 4;
    rg = warp % R;
    cg = warp / R;
    rows = 16 * R;
    m0 = 16 * rg;
  }
};

// this block's head and span of `span` output channels from blockIdx.y
struct Span {
  int h, c0, live;
  bool first;
  __device__ __forceinline__ Span(int y, int D, int span) {
    const int spans = (D + span - 1) / span;
    h = y / spans;
    const int k = y - h * spans;
    c0 = k * span;
    live = min(span, D - c0);  // a multiple of 32: D % 64 == 0
    first = k == 0;
  }
};

// wait until at most `pending` (0 to kMaxStages - 1) of this thread's copy
// groups are in flight
__device__ __forceinline__ void wait_groups(int pending) {
  switch (pending) {
    case 0: lw::cp_async_wait<0>(); break;
    case 1: lw::cp_async_wait<1>(); break;
    case 2: lw::cp_async_wait<2>(); break;
    case 3: lw::cp_async_wait<3>(); break;
    case 4: lw::cp_async_wait<4>(); break;
    case 5: lw::cp_async_wait<5>(); break;
    case 6: lw::cp_async_wait<6>(); break;
    default: lw::cp_async_wait<7>(); break;
  }
}

// The ring of `stages` slots of `slot` elements: step k's tiles go to slot
// k mod stages, issued stages - 1 steps ahead by issue(slot, k), one copy
// group a step.
template <typename T>
struct Ring {
  T* base;
  int stages, n_steps, slot = kSlotElems, issued = 0, fill = 0, take = 0;

  template <typename Issue>
  __device__ __forceinline__ void push(Issue& issue) {
    if (issued < n_steps) {
      issue(base + fill * slot, issued);
      ++issued;
      if (++fill == stages) fill = 0;
    }
    lw::cp_async_commit();  // one group a step, empty or not
  }

  template <typename Issue>
  __device__ __forceinline__ void prologue(Issue& issue) {
    for (int s = 0; s < stages - 1; ++s) push(issue);
  }

  // the next step's slot, once its tiles are in (the tiles of the step
  // stages - 1 later issued first, into the slot the last step freed)
  template <typename Issue>
  __device__ __forceinline__ const T* next(Issue& issue) {
    push(issue);
    wait_groups(stages - 1);
    __syncthreads();
    const T* cur = base + take * slot;
    if (++take == stages) take = 0;
    return cur;
  }
};

// s (16 rows x 8 NT columns) += the products of one 64-channel chunk: a rows
// [channel][row m0..m0+16), b rows [channel][column n0..]; `first` starts s
// over. f32 sums the chunk in fresh accumulators and adds it with f32 adds.
template <int NT, typename T>
__device__ __forceinline__ void add_chunk(float (&s)[NT][4], bool first, const T* a, const T* b,
                                          int m0, int n0, int lane) {
  if constexpr (sizeof(T) == 2) {
    if (first) lw::zero(s);
    lw::mma_tn<kChunk, NT>(s, a, kStride, b, kStride, m0, n0, lane);
  } else {
    float part[NT][4];
    lw::zero(part);
    lw::mma_tn<kChunk, NT>(part, a, kStride, b, kStride, m0, n0, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = first ? part[n][e] : s[n][e] + part[n][e];
    }
  }
}

// `live` channel rows (a multiple of 32) of the (rows, N) array at src,
// columns c0 .. c0 + kCols, into the slot's rows from dst
template <typename T>
__device__ __forceinline__ void load_slice(const Copier& tc, T* dst, const T* src, int N, int c0,
                                           int live) {
  for (int r = 0; r < live; r += kGroup)
    tc.copy<kGroup>(dst + r * kStride, src + static_cast<size_t>(r) * N, N, c0);
}

// columns c0 + 8 n + .. at or past N (a ragged last tile) get -inf
template <int NT>
__device__ __forceinline__ void mask_columns(float (&s)[NT][4], int c0, int N, int t) {
  if (c0 + 8 * NT <= N) return;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = c0 + 8 * n + 2 * t;
    if (c >= N) s[n][0] = s[n][2] = -INFINITY;
    if (c + 1 >= N) s[n][1] = s[n][3] = -INFINITY;
  }
}

template <int NG>
__device__ __forceinline__ void zero_groups(float (&acc)[NG][4][4]) {
#pragma unroll
  for (int k = 0; k < NG; ++k) lw::zero(acc[k]);
}

// A warp's 16 x 64 score-shaped tile through shared memory, read back a
// k-step at a time as the A operand of the next product (`tiles_of`): (warp,
// tile, element, lane) floats, no bank conflict.
__device__ __forceinline__ void put_tiles(float* xs, const float (&own)[8][4],
                                          const Layout<1>& L) {
  float* base = xs + L.rg * 8 * 4 * 32 + L.lane;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) base[(n * 4 + e) * 32] = own[n][e];
  }
}

// channel rows (2t, 2t + 1 of each C tile) x tokens (i_lo, i_hi) of the
// accumulator groups into dst (rows of stride N from the warp's first
// channel), `live` channels of them, scaled by (r_lo, r_hi)
template <typename T, int NG>
__device__ __forceinline__ void store_groups(T* dst, const float (&acc)[NG][4][4], int live, int N,
                                             int i_lo, int i_hi, int t, float r_lo = 1.f,
                                             float r_hi = 1.f) {
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    if (kGroup * k >= live) break;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? i_lo : i_hi;
        const size_t ch = kGroup * k + 8 * n + 2 * t + (e & 1);
        if (i < N) dst[ch * N + i] = lw::from_f32<T>(acc[k][n][e] * (e < 2 ? r_lo : r_hi));
      }
    }
  }
}

// acc (16 x 8 NB) += P B^T, P a 16 x 64 tile read a k-step at a time from
// shared memory by p(n, e) (element e of its C-fragment tile n), B rows
// [n0 + n][0..64): `lw::mma_rt` with k0 = 0, without holding P in registers.
template <int NB, typename PF>
__device__ __forceinline__ void mma_pb(float (&acc)[NB][4], const PF& p, const bf16* b, int sb,
                                       int n0, int lane) {
  const int r8 = lane % 8, mat = lane / 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {lw::pack_bf16(p(2 * kk, 0), p(2 * kk, 1)),
                            lw::pack_bf16(p(2 * kk, 2), p(2 * kk, 3)),
                            lw::pack_bf16(p(2 * kk + 1, 0), p(2 * kk + 1, 1)),
                            lw::pack_bf16(p(2 * kk + 1, 2), p(2 * kk + 1, 3))};
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t bf[4];
      lw::ldsm_x4(bf, &b[(n0 + 16 * np + r8 + 8 * (mat >> 1)) * sb + 16 * kk + 8 * (mat & 1)]);
      lw::mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
      lw::mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
    }
  }
}

template <int NB, typename PF>
__device__ __forceinline__ void mma_pb(float (&acc)[NB][4], const PF& p, const float* b, int sb,
                                       int n0, int lane) {
  const int g = lane / 4, t = lane % 4;
  float part[NB][4];  // this call's sum, added to acc in f32 (attention_bwd.cuh)
  lw::zero(part);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const lw::Tf32A pa(p(kk, 0), p(kk, 2), p(kk, 1), p(kk, 3));  // k order 2t, 2t + 1
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float2 bb =
          *reinterpret_cast<const float2*>(&b[(n0 + 8 * n + g) * sb + 8 * kk + 2 * t]);
      lw::mma_3xtf32(part[n], pa, lw::Tf32B(bb.x, bb.y));
    }
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
}

// p(n, e) of the warp's tiles (put_tiles)
struct TilesOf {
  const float* base;
  __device__ __forceinline__ float operator()(int n, int e) const { return base[(n * 4 + e) * 32]; }
};

__device__ __forceinline__ TilesOf tiles_of(const float* xs, const Layout<1>& L) {
  return TilesOf{xs + L.rg * 8 * 4 * 32 + L.lane};
}

// ---- forward ----------------------------------------------------------------

// out[b, hD:(h+1)D, :] = softmax(scale q^T k) v for this block's queries and
// span of 32 NG channels; lse (B, H, N) in log2 units, or null
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads, 2)
forward_kernel(const T* __restrict__ qkv, T* __restrict__ out, float* __restrict__ lse, int C,
               int N, int D, float sl2, int vec, int stages) {
  constexpr int NT = 8, kSpan = kGroup * NG;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* const ring = reinterpret_cast<T*>(wide_smem);
  float* const xs = reinterpret_cast<float*>(ring + stages * kSlotElems);
  const Layout<1> L;
  const int nthreads = blockDim.x;
  const Copier rc(vec, L.rows, L.tid, nthreads), tc(vec, kCols, L.tid, nthreads);
  const int i0 = blockIdx.x * L.rows;
  const Span sp(blockIdx.y, D, kSpan);
  const int b = blockIdx.z;
  const T* qp = qkv + (static_cast<size_t>(b) * 3 * C + sp.h * D) * N;
  const T* kp = qp + static_cast<size_t>(C) * N;
  const T* vp = kp + static_cast<size_t>(C) * N + static_cast<size_t>(sp.c0) * N;
  const int nc = D / kChunk, nv = (sp.live + kSlotRows - 1) / kSlotRows, per_tile = nc + nv;
  const int n_steps = (N + kCols - 1) / kCols * per_tile;
  const FastDiv pt(per_tile);  // the step's tile and place in it, without a division

  auto issue = [&](T* dst, int step) {  // q and k chunks, then the span of v, 128 channels a step
    const int j0 = pt.div(step) * kCols, c = pt.mod(step);
    if (c < nc) {
      const size_t off = static_cast<size_t>(c) * kChunk * N;
      rc.copy<kChunk>(dst, qp + off, N, i0);
      tc.copy<kChunk>(dst + kChunk * kStride, kp + off, N, j0);
    } else {
      const int r0 = (c - nc) * kSlotRows;
      load_slice(tc, dst, vp + static_cast<size_t>(r0) * N, N, j0, min(kSlotRows, sp.live - r0));
    }
  };

  float s[NT][4];
  float o[NG][4][4];
  zero_groups(o);
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of rows g and g + 8, x scale log2 e
  float l_lo = 0.f, l_hi = 0.f;              // this lane's part of their row sums (own columns)
  Ring<T> rng{ring, stages, n_steps};
  rng.prologue(issue);
  for (int step = 0; step < n_steps; ++step) {
    const T* cur = rng.next(issue);
    const int c = pt.mod(step);
    if (c < nc) {
      add_chunk(s, c == 0, cur, cur + kChunk * kStride, L.m0, 0, L.lane);
    } else {
      const int v = c - nc;
      if (v == 0) {  // the softmax of the tile, and the row's weights to every warp
        mask_columns(s, pt.div(step) * kCols, N, L.t);
        float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
          mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
        }
        mx_lo = lw::quad_max(mx_lo);
        mx_hi = lw::quad_max(mx_hi);
        // scale > 0: the max of the scaled scores is the scaled max; finite,
        // since every tile holds a live key
        const float mn_lo = fmaxf(m_lo, mx_lo * sl2), mn_hi = fmaxf(m_hi, mx_hi * sl2);
        const float al_lo = lw::fast_exp2(m_lo - mn_lo), al_hi = lw::fast_exp2(m_hi - mn_hi);
        m_lo = mn_lo;
        m_hi = mn_hi;
        l_lo *= al_lo;
        l_hi *= al_hi;
#pragma unroll
        for (int k = 0; k < NG; ++k) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            o[k][n][0] *= al_lo;
            o[k][n][1] *= al_lo;
            o[k][n][2] *= al_hi;
            o[k][n][3] *= al_hi;
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = lw::fast_exp2(fmaf(s[n][e], sl2, e < 2 ? -mn_lo : -mn_hi));
            if (e < 2) l_lo += pe; else l_hi += pe;
            s[n][e] = pe;
          }
        }
        put_tiles(xs, s, L);
        __syncthreads();  // every warp's weights are in place
      }
      // O += P V on this warp's channels in the step's 128, P rounded to bf16 in bf16
      const TilesOf p = tiles_of(xs, L);
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const int off = kGroup * k;
        if (off / kSlotRows == v && off < sp.live)
          mma_pb<4>(o[k], p, cur, kStride, off % kSlotRows, L.lane);
      }
    }
    __syncthreads();  // the slot is consumed: a later step's issue may refill it
  }

  const float sum_lo = lw::quad_sum(l_lo), sum_hi = lw::quad_sum(l_hi);
  const int i_lo = i0 + L.m0 + L.g, i_hi = i_lo + 8;
  if (lse != nullptr && sp.first && L.t == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * (C / D) + sp.h) * N;
    if (i_lo < N) lrow[i_lo] = m_lo + log2f(sum_lo);
    if (i_hi < N) lrow[i_hi] = m_hi + log2f(sum_hi);
  }
  // normalised after PV; a row sum holds exp2(0) = 1, so l >= 1
  store_groups<T, NG>(out + (static_cast<size_t>(b) * C + sp.h * D + sp.c0) * N, o,
                      sp.live, N, i_lo, i_hi, L.t, 1.f / sum_lo, 1.f / sum_hi);
}

// ---- backward pass 1: the row term (and log-sum-exp) ------------------------

// delta[b, h, i] = sum_j p_ij dp_ij; with `take_lse` also lse[b, h, i] (log2
// units), taken online in the same sweep (no forward wrote it: K7nb)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rows_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, float* __restrict__ lse,
            float* __restrict__ delta, int C, int N, int D, float sl2, int take_lse, int vec,
            int stages) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* const ring = reinterpret_cast<T*>(wide_smem);
  const Layout<1> L;
  const int nthreads = blockDim.x;
  const Copier rc(vec, L.rows, L.tid, nthreads), tc(vec, kCols, L.tid, nthreads);
  const int i0 = blockIdx.x * L.rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qp = qkv + (static_cast<size_t>(b) * 3 * C + h * D) * N;
  const T* kp = qp + static_cast<size_t>(C) * N;
  const T* vp = kp + static_cast<size_t>(C) * N;
  const T* gp = dout + (static_cast<size_t>(b) * C + h * D) * N;
  const size_t row = (static_cast<size_t>(b) * gridDim.y + h) * N;
  const int nc = D / kChunk, per_tile = 2 * nc;
  const int n_steps = (N + kCols - 1) / kCols * per_tile;
  const FastDiv pt(per_tile);  // the step's tile and place in it, without a division

  auto issue = [&](T* dst, int step) {  // even: (q, k) chunk; odd: (d(out), v) chunk
    const int j0 = pt.div(step) * kCols, c = pt.mod(step);
    const size_t off = static_cast<size_t>(c / 2) * kChunk * N;
    rc.copy<kChunk>(dst, (c & 1 ? gp : qp) + off, N, i0);
    tc.copy<kChunk>(dst + kChunk * kStride, (c & 1 ? vp : kp) + off, N, j0);
  };

  const int i_lo = i0 + L.m0 + L.g, i_hi = i_lo + 8;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // take_lse: running max x scale log2 e
  if (!take_lse) {  // p = exp2(s scale log2 e - lse); past N: p = 0
    m_lo = i_lo < N ? lse[row + i_lo] : INFINITY;
    m_hi = i_hi < N ? lse[row + i_hi] : INFINITY;
  }
  float l_lo = 0.f, l_hi = 0.f, r_lo = 0.f, r_hi = 0.f;  // this lane's parts
  float s[8][4], dp[8][4];
  Ring<T> rng{ring, stages, n_steps};
  rng.prologue(issue);
  for (int step = 0; step < n_steps; ++step) {
    const T* cur = rng.next(issue);
    const int c = pt.mod(step);
    if (c & 1)
      add_chunk(dp, c == 1, cur, cur + kChunk * kStride, L.m0, 0, L.lane);
    else
      add_chunk(s, c == 0, cur, cur + kChunk * kStride, L.m0, 0, L.lane);
    if (c == per_tile - 1) {
      mask_columns(s, pt.div(step) * kCols, N, L.t);
      float al_lo = 1.f, al_hi = 1.f;
      if (take_lse) {
        float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
          mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
        }
        const float mn_lo = fmaxf(m_lo, lw::quad_max(mx_lo) * sl2);
        const float mn_hi = fmaxf(m_hi, lw::quad_max(mx_hi) * sl2);
        al_lo = lw::fast_exp2(m_lo - mn_lo);
        al_hi = lw::fast_exp2(m_hi - mn_hi);
        m_lo = mn_lo;
        m_hi = mn_hi;
      }
      l_lo *= al_lo;
      l_hi *= al_hi;
      r_lo *= al_lo;
      r_hi *= al_hi;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = lw::fast_exp2(fmaf(s[n][e], sl2, e < 2 ? -m_lo : -m_hi));
          if (e < 2) {
            l_lo += p;
            r_lo = fmaf(p, dp[n][e], r_lo);
          } else {
            l_hi += p;
            r_hi = fmaf(p, dp[n][e], r_hi);
          }
        }
      }
    }
    __syncthreads();
  }
  r_lo = lw::quad_sum(r_lo);
  r_hi = lw::quad_sum(r_hi);
  if (take_lse) {
    l_lo = lw::quad_sum(l_lo);
    l_hi = lw::quad_sum(l_hi);
    r_lo /= l_lo;  // p = exp2(s - m) / l
    r_hi /= l_hi;
  }
  if (L.t != 0) return;
  if (i_lo < N) {
    delta[row + i_lo] = r_lo;
    if (take_lse) lse[row + i_lo] = m_lo + log2f(l_lo);
  }
  if (i_hi < N) {
    delta[row + i_hi] = r_hi;
    if (take_lse) lse[row + i_hi] = m_hi + log2f(l_hi);
  }
}

// ---- backward pass 2: dq ----------------------------------------------------

// dq = sum_j ds k for this block's queries and span of 32 NG channels
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads, 2)
dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dqkv, int C, int N, int D, float scale,
          int vec, int stages) {
  constexpr int NT = 8, kSpan = kGroup * NG;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* const ring = reinterpret_cast<T*>(wide_smem);
  float* const xs = reinterpret_cast<float*>(ring + stages * kSlotElems);
  const Layout<1> L;
  const int nthreads = blockDim.x;
  const Copier rc(vec, L.rows, L.tid, nthreads), tc(vec, kCols, L.tid, nthreads);
  const int i0 = blockIdx.x * L.rows;
  const Span sp(blockIdx.y, D, kSpan);
  const int b = blockIdx.z;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const T* qp = qkv + (img + sp.h * D) * N;
  const T* kp = qp + static_cast<size_t>(C) * N;
  const T* vp = kp + static_cast<size_t>(C) * N;
  const T* gp = dout + (static_cast<size_t>(b) * C + sp.h * D) * N;
  const size_t row = (static_cast<size_t>(b) * (C / D) + sp.h) * N;
  const int nc = D / kChunk, nv = (sp.live + kSlotRows - 1) / kSlotRows;
  const int per_tile = 2 * nc + nv;
  const int n_steps = (N + kCols - 1) / kCols * per_tile;
  const FastDiv pt(per_tile);  // the step's tile and place in it, without a division

  auto issue = [&](T* dst, int step) {  // (q, k) and (d(out), v) chunks, then the span of k
    const int j0 = pt.div(step) * kCols, c = pt.mod(step);
    if (c < 2 * nc) {
      const size_t off = static_cast<size_t>(c / 2) * kChunk * N;
      rc.copy<kChunk>(dst, (c & 1 ? gp : qp) + off, N, i0);
      tc.copy<kChunk>(dst + kChunk * kStride, (c & 1 ? vp : kp) + off, N, j0);
    } else {
      const int r0 = (c - 2 * nc) * kSlotRows;
      load_slice(tc, dst, kp + static_cast<size_t>(sp.c0 + r0) * N, N, j0,
                 min(kSlotRows, sp.live - r0));
    }
  };

  const float sl2 = scale * lw::kLog2e;
  const int i_lo = i0 + L.m0 + L.g, i_hi = i_lo + 8;
  const float l_lo = i_lo < N ? lse[row + i_lo] : INFINITY;  // past N: p = 0
  const float l_hi = i_hi < N ? lse[row + i_hi] : INFINITY;
  const float r_lo = i_lo < N ? delta[row + i_lo] : 0.f;
  const float r_hi = i_hi < N ? delta[row + i_hi] : 0.f;
  float s[NT][4], dp[NT][4];
  float dq[NG][4][4];
  zero_groups(dq);
  Ring<T> rng{ring, stages, n_steps};
  rng.prologue(issue);
  for (int step = 0; step < n_steps; ++step) {
    const T* cur = rng.next(issue);
    const int c = pt.mod(step);
    if (c < 2 * nc) {
      if (c & 1)
        add_chunk(dp, c == 1, cur, cur + kChunk * kStride, L.m0, 0, L.lane);
      else
        add_chunk(s, c == 0, cur, cur + kChunk * kStride, L.m0, 0, L.lane);
    } else {
      const int v = c - 2 * nc;
      if (v == 0) {
        mask_columns(s, pt.div(step) * kCols, N, L.t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = lw::fast_exp2(fmaf(s[n][e], sl2, e < 2 ? -l_lo : -l_hi));
            s[n][e] = p * (dp[n][e] - (e < 2 ? r_lo : r_hi)) * scale;  // ds
          }
        }
        put_tiles(xs, s, L);
        __syncthreads();
      }
      const TilesOf ds = tiles_of(xs, L);
#pragma unroll
      for (int k = 0; k < NG; ++k) {  // dQ += dS K^T, dS rounded to bf16 in bf16
        const int off = kGroup * k;
        if (off / kSlotRows == v && off < sp.live)
          mma_pb<4>(dq[k], ds, cur, kStride, off % kSlotRows, L.lane);
      }
    }
    __syncthreads();
  }
  store_groups<T, NG>(dqkv + (img + sp.h * D + sp.c0) * N, dq, sp.live, N, i_lo, i_hi,
                      L.t);
}

// ---- backward pass 3: dk and dv ---------------------------------------------

// dk = sum_i ds q and dv = sum_i p d(out) for this block's keys and span of
// 32 NG channels
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads, 2)
dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dqkv, int C, int N, int D,
            float scale, int vec, int stages) {
  constexpr int NT = 8, kSpan = kGroup * NG;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* const ring = reinterpret_cast<T*>(wide_smem);
  float* const xs = reinterpret_cast<float*>(ring + stages * kSlotElems);  // p, then ds
  float* const ls = xs + 2 * kTileFloats;  // a query tile's lse
  float* const dls = ls + kCols;                                     // and delta
  const Layout<1> L;
  const int nthreads = blockDim.x;
  const Copier rc(vec, L.rows, L.tid, nthreads), tc(vec, kCols, L.tid, nthreads);
  const int j0 = blockIdx.x * L.rows;
  const Span sp(blockIdx.y, D, kSpan);
  const int b = blockIdx.z;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const T* qp = qkv + (img + sp.h * D) * N;
  const T* kp = qp + static_cast<size_t>(C) * N;
  const T* vp = kp + static_cast<size_t>(C) * N;
  const T* gp = dout + (static_cast<size_t>(b) * C + sp.h * D) * N;
  const size_t row = (static_cast<size_t>(b) * (C / D) + sp.h) * N;
  const int nc = D / kChunk, nu = (sp.live + kChunk - 1) / kChunk;
  const int per_tile = 2 * nc + nu;
  const int n_steps = (N + kCols - 1) / kCols * per_tile;
  const FastDiv pt(per_tile);  // the step's tile and place in it, without a division

  // (k, q) and (v, d(out)) chunks, then the span of q and d(out), 64 channels a step
  auto issue = [&](T* dst, int step) {
    const int i0 = pt.div(step) * kCols, c = pt.mod(step);
    if (c < 2 * nc) {
      const size_t off = static_cast<size_t>(c / 2) * kChunk * N;
      rc.copy<kChunk>(dst, (c & 1 ? vp : kp) + off, N, j0);
      tc.copy<kChunk>(dst + kChunk * kStride, (c & 1 ? gp : qp) + off, N, i0);
    } else {
      const int r0 = (c - 2 * nc) * kChunk;
      const size_t off = static_cast<size_t>(sp.c0 + r0) * N;
      const int live = min(kChunk, sp.live - r0);
      load_slice(tc, dst, qp + off, N, i0, live);
      load_slice(tc, dst + kChunk * kStride, gp + off, N, i0, live);
    }
  };

  const float sl2 = scale * lw::kLog2e;
  float s[NT][4], dp[NT][4];  // (16 keys) x (8 NT queries): S^T, dP^T, then P^T, dS^T
  float dk[NG][4][4], dv[NG][4][4];
  zero_groups(dk);
  zero_groups(dv);
  Ring<T> rng{ring, stages, n_steps};
  rng.prologue(issue);
  for (int step = 0; step < n_steps; ++step) {
    const T* cur = rng.next(issue);
    const int c = pt.mod(step);
    if (c < 2 * nc) {
      if (c == 0 && L.tid < kCols) {  // read after this step's closing barrier
        const int i = pt.div(step) * kCols + L.tid;  // a query past N: p = 0, no row term
        ls[L.tid] = i < N ? lse[row + i] : INFINITY;
        dls[L.tid] = i < N ? delta[row + i] : 0.f;
      }
      if (c & 1)
        add_chunk(dp, c == 1, cur, cur + kChunk * kStride, L.m0, 0, L.lane);
      else
        add_chunk(s, c == 0, cur, cur + kChunk * kStride, L.m0, 0, L.lane);
    } else {
      const int u = c - 2 * nc;
      if (u == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * n + 2 * L.t + (e & 1);
            const float pe = lw::fast_exp2(fmaf(s[n][e], sl2, -ls[i]));
            s[n][e] = pe;
            dp[n][e] = pe * (dp[n][e] - dls[i]) * scale;
          }
        }
        put_tiles(xs, s, L);
        put_tiles(xs + kTileFloats, dp, L);
        __syncthreads();
      }
      // dV += P^T dO^T and dK += dS^T Q^T on this warp's channels in the step's 64
      const TilesOf p = tiles_of(xs, L), ds = tiles_of(xs + kTileFloats, L);
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const int off = kGroup * k;
        if (off / kChunk == u && off < sp.live) {
          mma_pb<4>(dk[k], ds, cur, kStride, off % kChunk, L.lane);
          mma_pb<4>(dv[k], p, cur + kChunk * kStride, kStride, off % kChunk, L.lane);
        }
      }
    }
    __syncthreads();
  }
  const int j_lo = j0 + L.m0 + L.g, j_hi = j_lo + 8;
  store_groups<T, NG>(dqkv + (img + C + sp.h * D + sp.c0) * N, dk, sp.live, N, j_lo,
                      j_hi, L.t);
  store_groups<T, NG>(dqkv + (img + 2 * C + sp.h * D + sp.c0) * N, dv, sp.live, N,
                      j_lo, j_hi, L.t);
}

// channel rows (8 n + 2t, + 1) x tokens (i_lo, i_hi) of NB C tiles into dst
// (rows of stride N), scaled by (r_lo, r_hi)
template <typename T, int NB>
__device__ __forceinline__ void store_tiles(T* dst, const float (&acc)[NB][4], int N, int i_lo,
                                            int i_hi, int t, float r_lo = 1.f, float r_hi = 1.f) {
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? i_lo : i_hi;
      const size_t ch = 8 * n + 2 * t + (e & 1);
      if (i < N) dst[ch * N + i] = lw::from_f32<T>(acc[n][e] * (e < 2 ? r_lo : r_hi));
    }
  }
}

// ---- heads of 128 channels: FlashAttention-2's shape ------------------------
//
// At D = 128 a block can keep its queries' q in shared memory and each warp
// its output accumulator in registers, so a step can take a whole 64-key
// tile: the products over all 128 channels at once (twice a chunk step's) and
// no resident rows. A block of 4 warps takes 64 queries (16 a warp); each
// step stages the key tile's k and v (128 rows each) through the ring; the
// online softmax is the streaming forward's. The host takes these kernels in
// bf16 where they put a block on every SM (on an H100, at two heads of 128
// over 52 x 300 tokens: the forward 2.6x, the backward 1.7x the resident
// kernels; in f32 the forward, at 255 registers and one block an SM, only
// matched the resident kernel).
constexpr int kFaD = 128;
// a step's k and v (or q and d(out)) tiles, and the dk / dv pass's lse and
// delta of the tile's 64 queries (2 x 64 floats)
constexpr int kFaSlot = 2 * kFaD * kStride + 4 * kCols;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fa2_forward_kernel(const T* __restrict__ qkv, T* __restrict__ out, float* __restrict__ lse, int C,
                   int N, float sl2, int vec, int stages) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* const ring = reinterpret_cast<T*>(wide_smem);
  T* const qs = ring + stages * kFaSlot;  // the block's q, 128 x 64
  const Layout<1> L;
  const int nthreads = blockDim.x;
  const Copier rc(vec, L.rows, L.tid, nthreads), tc(vec, kCols, L.tid, nthreads);
  const int i0 = blockIdx.x * L.rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qp = qkv + (static_cast<size_t>(b) * 3 * C + h * kFaD) * N;
  const T* kp = qp + static_cast<size_t>(C) * N;
  const T* vp = kp + static_cast<size_t>(C) * N;
  const int n_steps = (N + kCols - 1) / kCols;

  auto issue = [&](T* dst, int step) {  // key tile `step`: k in the slot's first 128 rows, v after
    tc.copy<kFaD>(dst, kp, N, step * kCols);
    tc.copy<kFaD>(dst + kFaD * kStride, vp, N, step * kCols);
  };

  float s[8][4], o[2][8][4];
  lw::zero(o[0]);
  lw::zero(o[1]);
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of rows g and g + 8, x scale log2 e
  float l_lo = 0.f, l_hi = 0.f;              // this lane's part of their row sums
  rc.copy<kFaD>(qs, qp, N, i0);              // in the first step's copy group
  Ring<T> rng{ring, stages, n_steps, kFaSlot};
  rng.prologue(issue);
  for (int step = 0; step < n_steps; ++step) {
    const T* cur = rng.next(issue);
    add_chunk(s, true, qs, cur, L.m0, 0, L.lane);  // S = q^T k, 64 channels a call
    add_chunk(s, false, qs + kChunk * kStride, cur + kChunk * kStride, L.m0, 0, L.lane);
    mask_columns(s, step * kCols, N, L.t);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
    // scale > 0: the max of the scaled scores is the scaled max; finite,
    // since every tile holds a live key
    const float mn_lo = fmaxf(m_lo, lw::quad_max(mx_lo) * sl2);
    const float mn_hi = fmaxf(m_hi, lw::quad_max(mx_hi) * sl2);
    const float al_lo = lw::fast_exp2(m_lo - mn_lo), al_hi = lw::fast_exp2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= al_lo;
    l_hi *= al_hi;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[u][n][0] *= al_lo;
        o[u][n][1] *= al_lo;
        o[u][n][2] *= al_hi;
        o[u][n][3] *= al_hi;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = lw::fast_exp2(fmaf(s[n][e], sl2, e < 2 ? -mn_lo : -mn_hi));
        if (e < 2) l_lo += p; else l_hi += p;
        s[n][e] = p;
      }
    }
    const T* vt = cur + kFaD * kStride;  // O += P V, P rounded to bf16 in bf16, 64 channels a call
    lw::mma_rt<8, 8>(o[0], s, vt, kStride, 0, 0, L.lane);
    lw::mma_rt<8, 8>(o[1], s, vt, kStride, 0, kChunk, L.lane);
    __syncthreads();  // the slot is consumed: a later step's issue may refill it
  }
  const float sum_lo = lw::quad_sum(l_lo), sum_hi = lw::quad_sum(l_hi);
  const int i_lo = i0 + L.m0 + L.g, i_hi = i_lo + 8;
  if (lse != nullptr && L.t == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * gridDim.y + h) * N;
    if (i_lo < N) lrow[i_lo] = m_lo + log2f(sum_lo);
    if (i_hi < N) lrow[i_hi] = m_hi + log2f(sum_hi);
  }
  // normalised after PV; a row sum holds exp2(0) = 1, so l >= 1
  T* o0 = out + (static_cast<size_t>(b) * C + h * kFaD) * N;
  store_tiles<T, 8>(o0, o[0], N, i_lo, i_hi, L.t, 1.f / sum_lo, 1.f / sum_hi);
  store_tiles<T, 8>(o0 + static_cast<size_t>(kChunk) * N, o[1], N, i_lo, i_hi, L.t, 1.f / sum_lo,
                    1.f / sum_hi);
}

// the backward in the same shape (bf16, D = 128), after the streaming row
// pass (`rows_kernel`: delta, and for K7nb the log-sum-exp): dq for a block
// of 64 queries over the key tiles, then dk and dv for a block of 64 keys
// over the query tiles, the block's own 128 x 64 operands staged once.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fa2_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dqkv, int C, int N, float scale,
              int vec, int stages) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* const ring = reinterpret_cast<T*>(wide_smem);
  T* const qs = ring + stages * kFaSlot;  // the block's q, then its d(out)
  T* const gs = qs + kFaD * kStride;
  const Layout<1> L;
  const int nthreads = blockDim.x;
  const Copier rc(vec, L.rows, L.tid, nthreads), tc(vec, kCols, L.tid, nthreads);
  const int i0 = blockIdx.x * L.rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const T* qp = qkv + (img + h * kFaD) * N;
  const T* kp = qp + static_cast<size_t>(C) * N;
  const T* vp = kp + static_cast<size_t>(C) * N;
  const T* gp = dout + (static_cast<size_t>(b) * C + h * kFaD) * N;
  const size_t row = (static_cast<size_t>(b) * gridDim.y + h) * N;
  const int n_steps = (N + kCols - 1) / kCols;
  const float sl2 = scale * lw::kLog2e;

  auto issue = [&](T* dst, int step) {  // key tile `step`: k, then v
    tc.copy<kFaD>(dst, kp, N, step * kCols);
    tc.copy<kFaD>(dst + kFaD * kStride, vp, N, step * kCols);
  };

  const int i_lo = i0 + L.m0 + L.g, i_hi = i_lo + 8;
  const float l_lo = i_lo < N ? lse[row + i_lo] : INFINITY;  // past N: p = 0
  const float l_hi = i_hi < N ? lse[row + i_hi] : INFINITY;
  const float r_lo = i_lo < N ? delta[row + i_lo] : 0.f;
  const float r_hi = i_hi < N ? delta[row + i_hi] : 0.f;
  float s[8][4], dp[8][4], dq[2][8][4];
  lw::zero(dq[0]);
  lw::zero(dq[1]);
  rc.copy<kFaD>(qs, qp, N, i0);  // in the first step's copy group
  rc.copy<kFaD>(gs, gp, N, i0);
  Ring<T> rng{ring, stages, n_steps, kFaSlot};
  rng.prologue(issue);
  for (int step = 0; step < n_steps; ++step) {
    const T* cur = rng.next(issue);
    const T* vt = cur + kFaD * kStride;
    add_chunk(s, true, qs, cur, L.m0, 0, L.lane);  // S = q^T k
    add_chunk(s, false, qs + kChunk * kStride, cur + kChunk * kStride, L.m0, 0, L.lane);
    add_chunk(dp, true, gs, vt, L.m0, 0, L.lane);  // dP = d(out)^T v
    add_chunk(dp, false, gs + kChunk * kStride, vt + kChunk * kStride, L.m0, 0, L.lane);
    mask_columns(s, step * kCols, N, L.t);  // a key past N: p = 0
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = lw::fast_exp2(fmaf(s[n][e], sl2, e < 2 ? -l_lo : -l_hi));
        s[n][e] = p * (dp[n][e] - (e < 2 ? r_lo : r_hi)) * scale;  // ds
      }
    }
    lw::mma_rt<8, 8>(dq[0], s, cur, kStride, 0, 0, L.lane);  // dQ += dS K^T, 64 channels a call
    lw::mma_rt<8, 8>(dq[1], s, cur, kStride, 0, kChunk, L.lane);
    __syncthreads();
  }
  T* o = dqkv + (img + h * kFaD) * N;
  store_tiles<T, 8>(o, dq[0], N, i_lo, i_hi, L.t);
  store_tiles<T, 8>(o + static_cast<size_t>(kChunk) * N, dq[1], N, i_lo, i_hi, L.t);
}

// dk (kDk) or dv for a block of 64 keys over the query tiles: two launches,
// since one warp's dk and dv accumulators (128 registers) beside its scores
// spill; dv's launch forms S again but no dP.
template <typename T, bool kDk>
__global__ void __launch_bounds__(kThreads, 2)
fa2_kv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dqkv, int C, int N, float scale,
              int vec, int stages) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* const ring = reinterpret_cast<T*>(wide_smem);
  T* const ks = ring + stages * kFaSlot;  // the block's k, then its v
  T* const vs = ks + kFaD * kStride;
  const Layout<1> L;
  const int nthreads = blockDim.x;
  const Copier rc(vec, L.rows, L.tid, nthreads), tc(vec, kCols, L.tid, nthreads);
  const int j0 = blockIdx.x * L.rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const T* qp = qkv + (img + h * kFaD) * N;
  const T* kp = qp + static_cast<size_t>(C) * N;
  const T* vp = kp + static_cast<size_t>(C) * N;
  const T* gp = dout + (static_cast<size_t>(b) * C + h * kFaD) * N;
  const size_t row = (static_cast<size_t>(b) * gridDim.y + h) * N;
  const int n_steps = (N + kCols - 1) / kCols;
  const float sl2 = scale * lw::kLog2e;

  // query tile `step`: q, then d(out), then its queries' lse and delta
  auto issue = [&](T* dst, int step) {
    tc.copy<kFaD>(dst, qp, N, step * kCols);
    tc.copy<kFaD>(dst + kFaD * kStride, gp, N, step * kCols);
    if (L.tid < 2 * kCols) {
      const int i = step * kCols + L.tid % kCols;
      const float* src = (L.tid < kCols ? lse : delta) + row + (i < N ? i : 0);
      lw::cp_async<4>(reinterpret_cast<float*>(dst + 2 * kFaD * kStride) + L.tid, src, i < N);
    }
  };

  float s[8][4], dp[8][4];  // (16 keys) x (64 queries): S^T, dP^T, then P^T, dS^T
  float acc[2][8][4];       // dk, or dv
  lw::zero(acc[0]);
  lw::zero(acc[1]);
  rc.copy<kFaD>(ks, kp, N, j0);  // in the first step's copy group
  if constexpr (kDk) rc.copy<kFaD>(vs, vp, N, j0);
  Ring<T> rng{ring, stages, n_steps, kFaSlot};
  rng.prologue(issue);
  for (int step = 0; step < n_steps; ++step) {
    const T* cur = rng.next(issue);
    const T* gt = cur + kFaD * kStride;
    const float* lt = reinterpret_cast<const float*>(cur + 2 * kFaD * kStride);  // lse, delta
    add_chunk(s, true, ks, cur, L.m0, 0, L.lane);  // S^T = k^T q
    add_chunk(s, false, ks + kChunk * kStride, cur + kChunk * kStride, L.m0, 0, L.lane);
    if constexpr (kDk) {
      add_chunk(dp, true, vs, gt, L.m0, 0, L.lane);  // dP^T = v^T d(out)
      add_chunk(dp, false, vs + kChunk * kStride, gt + kChunk * kStride, L.m0, 0, L.lane);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * L.t + (e & 1);
        const bool live = step * kCols + c < N;  // a query past N: p = 0, no row term
        const float p = live ? lw::fast_exp2(fmaf(s[n][e], sl2, -lt[c])) : 0.f;
        if constexpr (kDk)
          s[n][e] = live ? p * (dp[n][e] - lt[kCols + c]) * scale : 0.f;  // ds
        else
          s[n][e] = p;
      }
    }
    // dK += dS^T Q^T, or dV += P^T dO^T, 64 channels a call
    const T* b_tile = kDk ? cur : gt;
    lw::mma_rt<8, 8>(acc[0], s, b_tile, kStride, 0, 0, L.lane);
    lw::mma_rt<8, 8>(acc[1], s, b_tile, kStride, 0, kChunk, L.lane);
    __syncthreads();
  }
  const int j_lo = j0 + L.m0 + L.g, j_hi = j_lo + 8;
  T* o = dqkv + (img + (kDk ? C : 2 * C) + h * kFaD) * N;
  store_tiles<T, 8>(o, acc[0], N, j_lo, j_hi, L.t);
  store_tiles<T, 8>(o + static_cast<size_t>(kChunk) * N, acc[1], N, j_lo, j_hi, L.t);
}

// ---- the resident case: a block's rows of scores in shared memory ---------
//
// Where a block's rows of scores over all N tokens fit in shared memory (at
// 16 rows, N up to 1152 in the f32 backward and 3008 in the bf16 forward),
// the host takes these kernels, and they keep the rows there instead of
// streaming an online softmax: phase 1 forms the scores (and dP) over the
// 64-channel chunks, tile by tile, into the resident rows; then the exact
// softmax over each row; phase 2 walks the output channels, 128 (64 for dK, dV) at a time,
// and adds the resident weights times the streamed value (or key, query,
// d(out)) tiles. Each score is formed once, however wide the head. A block is
// R row groups of 16 rows x 2 column groups (32 columns of each 64-token tile
// in phase 1, half of the channels in phase 2), R = 1, 2 or 4 (up to 8 warps,
// so that a thread may take 255 registers; 4 warps with whole tiles, and 16
// with 128 registers, ran slower). A block's steps bound it, and each of its
// rows shares them, so the host takes the most rows a block that fit. Where
// that leaves SMs idle (8 images x 300 queries: 40 blocks of 64 rows), a
// cluster of CS blocks (2, 4 or 8) shares the rows: each block forms the
// partial scores of its share of the D chunks, the partials are summed
// through distributed shared memory (each block sums a share of the columns,
// then gathers the others'), and each block then adds the weights into its
// share of the output channels. No score is formed twice, and every block
// takes 1 / CS of the steps.

constexpr int kResG = 2;  // column groups of the resident kernels
constexpr int kResMaxThreads = 32 * kResG * kMaxRowGroups;
constexpr int kRowThreads = 32 * kResG / 16;  // threads a resident row in the row-wise passes
constexpr int kMaxSplit = 8;  // blocks of a cluster, the portable most

__host__ __device__ inline int padded_cols(int N) { return (N + kCols - 1) / kCols * kCols; }
// a resident row's stride in floats: 8 (mod 32), so that the float2 reads of
// a C fragment's rows hit distinct banks
__host__ __device__ inline int score_stride(int N) { return padded_cols(N) + 8; }

inline dim3 resident_grid(int B, int H, int N, int R, int CS) {
  return dim3((N + 16 * R - 1) / (16 * R) * CS, H, B);
}

// dynamic shared bytes of a resident kernel beside its ring: `arrays` rows x
// score_stride score arrays, the rows' statistics (4 floats a row) and (pass
// 2) every query's lse and delta
inline size_t resident_extra(int rows, int N, int arrays, bool stats) {
  return (static_cast<size_t>(arrays) * rows * score_stride(N) + 4 * 16 * kMaxRowGroups +
          (stats ? 2 * padded_cols(N) : 0)) *
         sizeof(float);
}

// the C fragments of a 16 x 8 NT tile into column c0 of the resident rows
// from m0 (float2 a row pair)
template <int NT>
__device__ __forceinline__ void put_rows(float* S, int ld, const float (&s)[NT][4], int m0, int c0,
                                         int g, int t) {
  float* r = S + (m0 + g) * ld + c0 + 2 * t;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<float2*>(r + 8 * n) = make_float2(s[n][0], s[n][1]);
    *reinterpret_cast<float2*>(r + 8 * ld + 8 * n) = make_float2(s[n][2], s[n][3]);
  }
}

// the C fragments of a 16 x 64 tile from column c0 of the resident rows
// from m0
__device__ __forceinline__ void get_rows(const float* S, int ld, float (&s)[8][4], int m0, int c0,
                                         int g, int t) {
  const float* r = S + (m0 + g) * ld + c0 + 2 * t;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 a = *reinterpret_cast<const float2*>(r + 8 * n);
    const float2 c = *reinterpret_cast<const float2*>(r + 8 * ld + 8 * n);
    s[n][0] = a.x;
    s[n][1] = a.y;
    s[n][2] = c.x;
    s[n][3] = c.y;
  }
}


// The block's place in its cluster of CS blocks: its share [k0, k1) of the nc
// chunks of D, of the resident columns [c0, c1) (float4 units) that it sums
// and normalises, and its row and place there (kRowThreads a row) for the
// row-wise passes.
struct Share {
  int rank, CS, k0, k1, c0, c1, row, j;
  __device__ __forceinline__ Share(cg::cluster_group& cl, int nc, int n4) {
    rank = static_cast<int>(cl.block_rank());
    CS = static_cast<int>(cl.num_blocks());
    k0 = rank * nc / CS;
    k1 = (rank + 1) * nc / CS;
    const int per = (n4 + CS - 1) / CS;
    c0 = min(n4, rank * per);
    c1 = min(n4, c0 + per);
    row = threadIdx.x / kRowThreads;
    j = threadIdx.x % kRowThreads;
  }
  __device__ __forceinline__ void cols_of(int q, int n4, int& a, int& b) const {
    const int per = (n4 + CS - 1) / CS;
    a = min(n4, q * per);
    b = min(n4, a + per);
  }
};

// the max (or sum) of x over a row's threads
template <bool kMax>
__device__ __forceinline__ float row_all(float x) {
#pragma unroll
  for (int off = 1; off < kRowThreads; off <<= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  return x;
}

// A's share of the columns <- the sum of the cluster's partial rows there, in
// the order of the ranks; returns this thread's max of the sums. Every rank's
// load is issued before the first add: distributed shared memory answers at
// about L2's latency.
__device__ __forceinline__ float sum_partials(cg::cluster_group& cl, float* A, int ld,
                                              const Share& sh) {
  float mx = -INFINITY;
  const float4* src[kMaxSplit];
#pragma unroll
  for (int q = 0; q < kMaxSplit; ++q)
    src[q] = reinterpret_cast<const float4*>(cl.map_shared_rank(A, q < sh.CS ? q : 0) + sh.row * ld);
  float4* own = reinterpret_cast<float4*>(A + sh.row * ld);
  if (sh.CS == 1) {  // the block's own rows are the sums
#pragma unroll 4
    for (int c = sh.c0 + sh.j; c < sh.c1; c += kRowThreads) {
      const float4 v = own[c];
      mx = fmaxf(mx, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
    }
    return mx;
  }
  for (int c = sh.c0 + sh.j; c < sh.c1; c += kRowThreads) {
    float4 v[kMaxSplit];
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      if (q < sh.CS) v[q] = src[q][c];
    float4 acc = v[0];
#pragma unroll
    for (int q = 1; q < kMaxSplit; ++q) {
      if (q < sh.CS) {
        acc.x += v[q].x;
        acc.y += v[q].y;
        acc.z += v[q].z;
        acc.w += v[q].w;
      }
    }
    own[c] = acc;
    mx = fmaxf(mx, fmaxf(fmaxf(acc.x, acc.y), fmaxf(acc.z, acc.w)));
  }
  return mx;
}

// A's columns of every other block of the cluster, copied into this block's
// rows, four loads in flight before their stores
__device__ __forceinline__ void gather_shares(cg::cluster_group& cl, float* A, int ld, int n4,
                                              const Share& sh) {
  float4* own = reinterpret_cast<float4*>(A + sh.row * ld);
  for (int q = 0; q < sh.CS; ++q) {
    if (q == sh.rank) continue;
    int a, b;
    sh.cols_of(q, n4, a, b);
    const float4* src = reinterpret_cast<const float4*>(cl.map_shared_rank(A, q) + sh.row * ld);
    for (int c = a + sh.j; c < b; c += 4 * kRowThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + kRowThreads * u < b) v[u] = src[c + kRowThreads * u];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + kRowThreads * u < b) own[c + kRowThreads * u] = v[u];
    }
  }
}

// a row's max and sum over the cluster: each block's (m_q, l_q) at st[0 / 1 x
// 64 + row], l_q = sum of exp2((s - m_q) sl2) over its columns
__device__ __forceinline__ void combine_rows(cg::cluster_group& cl, const float* st, int row,
                                             float sl2, int CS, float& m, float& l) {
  m = -INFINITY;
  for (int q = 0; q < CS; ++q) m = fmaxf(m, cl.map_shared_rank(st, q)[row]);
  l = 0.f;
  for (int q = 0; q < CS; ++q) {
    const float* o = cl.map_shared_rank(st, q);
    const float mq = o[row];
    l += mq == -INFINITY ? 0.f : o[64 + row] * exp2f((mq - m) * sl2);
  }
}

// this thread's share of a row's sum of exp2((s - m) sl2), m its max there
// (-inf: no live column, sum 0)
__device__ __forceinline__ float share_sum(const float* A, int ld, const Share& sh, float m,
                                           float sl2) {
  const float mm = m == -INFINITY ? 0.f : m * sl2;
  float l = 0.f;
  const float4* r = reinterpret_cast<const float4*>(A + sh.row * ld);
#pragma unroll 4
  for (int c = sh.c0 + sh.j; c < sh.c1; c += kRowThreads) {
    const float4 v = r[c];
    l += lw::fast_exp2(fmaf(v.x, sl2, -mm)) + lw::fast_exp2(fmaf(v.y, sl2, -mm)) +
         lw::fast_exp2(fmaf(v.z, sl2, -mm)) + lw::fast_exp2(fmaf(v.w, sl2, -mm));
  }
  return l;
}

// forward: out = softmax(scale q^T k) v for this block's queries and its
// share of the channels
template <typename T>
__global__ void __launch_bounds__(kResMaxThreads, 1)
resident_forward_kernel(const T* __restrict__ qkv, T* __restrict__ out, float* __restrict__ lse,
                        int C, int N, int D, float sl2, int vec, int stages) {
  constexpr int G = kResG, NT = 8 / G;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* const ring = reinterpret_cast<T*>(wide_smem);
  cg::cluster_group cl = cg::this_cluster();
  const Layout<G> L;
  const int ld = score_stride(N), nthreads = blockDim.x;
  const Copier rc(vec, L.rows, L.tid, nthreads), tc(vec, kCols, L.tid, nthreads);
  const int nt = (N + kCols - 1) / kCols, nc = D / kChunk, n4 = nt * kCols / 4;
  const Share sh(cl, nc, n4);
  float* const S = reinterpret_cast<float*>(ring + stages * kSlotElems);
  float* const st = S + L.rows * ld;  // rows' max, sum (64 floats each), then 1 / sum
  const int i0 = blockIdx.x / sh.CS * L.rows, n0 = L.cg * 8 * NT;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qp = qkv + (static_cast<size_t>(b) * 3 * C + h * D) * N;
  const T* kp = qp + static_cast<size_t>(C) * N;
  const T* vp = kp + static_cast<size_t>(C) * N;
  const int ncr = sh.k1 - sh.k0, ch0 = sh.k0 * kChunk, ch1 = sh.k1 * kChunk;
  const int spans = (ch1 - ch0 + kSlotRows - 1) / kSlotRows;
  const int p1 = nt * ncr, n_steps = p1 + spans * nt;
  const FastDiv fc(ncr), ft(nt);  // a step's tile and chunk, without a division

  auto issue = [&](T* dst, int step) {  // phase 1: q and k chunks; phase 2: 128 channels of v
    if (step < p1) {
      const int j0 = fc.div(step) * kCols;
      const size_t off = static_cast<size_t>(sh.k0 + fc.mod(step)) * kChunk * N;
      rc.copy<kChunk>(dst, qp + off, N, i0);
      tc.copy<kChunk>(dst + kChunk * kStride, kp + off, N, j0);
    } else {
      const int c0 = ch0 + ft.div(step - p1) * kSlotRows, j0 = ft.mod(step - p1) * kCols;
      load_slice(tc, dst, vp + static_cast<size_t>(c0) * N, N, j0, min(kSlotRows, ch1 - c0));
    }
  };

  float s[NT][4], o[8][4];
  const int i_lo = i0 + L.m0 + L.g, i_hi = i_lo + 8;
  Ring<T> rng{ring, stages, n_steps};
  rng.prologue(issue);
  for (int step = 0; step < n_steps; ++step) {
    const T* cur = rng.next(issue);
    if (step < p1) {
      const int c = fc.mod(step);
      add_chunk(s, c == 0, cur, cur + kChunk * kStride, L.m0, n0, L.lane);
      if (c == ncr - 1) {
        const int j0 = fc.div(step) * kCols;
        mask_columns(s, j0 + n0, N, L.t);
        put_rows(S, ld, s, L.m0, j0 + n0, L.g, L.t);  // this block's partial scores
      }
    } else {
      const int k = step - p1, c0 = ch0 + ft.div(k) * kSlotRows, jt = ft.mod(k);
      if (k == 0) {  // the exact softmax of the resident rows, over the cluster
        cl.sync();  // every block's partial rows are complete
        float m = row_all<true>(sum_partials(cl, S, ld, sh));
        const float l = row_all<false>(share_sum(S, ld, sh, m, sl2));
        if (sh.j == 0) {
          st[sh.row] = m;
          st[64 + sh.row] = l;
        }
        cl.sync();
        float lsum;
        combine_rows(cl, st, sh.row, sl2, sh.CS, m, lsum);
        float4* r = reinterpret_cast<float4*>(S + sh.row * ld);
#pragma unroll 4
        for (int cc = sh.c0 + sh.j; cc < sh.c1; cc += kRowThreads) {  // p = exp2((s - m) scale log2 e)
          float4 v = r[cc];
          v.x = lw::fast_exp2(fmaf(v.x, sl2, -m * sl2));
          v.y = lw::fast_exp2(fmaf(v.y, sl2, -m * sl2));
          v.z = lw::fast_exp2(fmaf(v.z, sl2, -m * sl2));
          v.w = lw::fast_exp2(fmaf(v.w, sl2, -m * sl2));
          r[cc] = v;
        }
        const int i = i0 + sh.row;
        if (lse != nullptr && sh.rank == 0 && sh.j == 0 && i < N)
          lse[(static_cast<size_t>(b) * gridDim.y + h) * N + i] = m * sl2 + log2f(lsum);
        cl.sync();  // every block's share of p is in place
        gather_shares(cl, S, ld, n4, sh);
        if (sh.j == 0) st[128 + sh.row] = 1.f / lsum;  // l >= 1: the max term is exp2(0)
        cl.sync();  // no block reads another's rows from here on
      }
      if (jt == 0) lw::zero(o);
      const int w = kChunk * L.cg;  // this warp's 64 of the step's 128 channels
      if (c0 + w < ch1) {
        float p[8][4];
        get_rows(S, ld, p, L.m0, jt * kCols, L.g, L.t);
        lw::mma_rt<8, 8>(o, p, cur, kStride, 0, w, L.lane);  // O += P V, P rounded to bf16 in bf16
        if (jt == nt - 1)
          store_tiles<T, 8>(out + (static_cast<size_t>(b) * C + h * D + c0 + w) * N, o, N, i_lo,
                            i_hi, L.t, st[128 + L.m0 + L.g], st[128 + L.m0 + L.g + 8]);
      }
    }
    __syncthreads();
  }
}

// backward pass 1: the row term (and, `take_lse`, the row log-sum-exp) and dq
// for this block's queries and its share of the channels
template <typename T>
__global__ void __launch_bounds__(kResMaxThreads, 1)
resident_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, float* __restrict__ lse,
                   float* __restrict__ delta, T* __restrict__ dqkv, int C, int N, int D,
                   float scale, int take_lse, int vec, int stages) {
  constexpr int G = kResG, NT = 8 / G;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* const ring = reinterpret_cast<T*>(wide_smem);
  cg::cluster_group cl = cg::this_cluster();
  const Layout<G> L;
  const int ld = score_stride(N), nthreads = blockDim.x;
  const Copier rc(vec, L.rows, L.tid, nthreads), tc(vec, kCols, L.tid, nthreads);
  const int nt = (N + kCols - 1) / kCols, nc = D / kChunk, n4 = nt * kCols / 4;
  const Share sh(cl, nc, n4);
  float* const SS = reinterpret_cast<float*>(ring + stages * kSlotElems);  // s, then p
  float* const DS = SS + L.rows * ld;                                      // dp, then ds
  float* const st = DS + L.rows * ld;  // rows' max, sum, row term (64 floats each)
  const int i0 = blockIdx.x / sh.CS * L.rows, n0 = L.cg * 8 * NT;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const T* qp = qkv + (img + h * D) * N;
  const T* kp = qp + static_cast<size_t>(C) * N;
  const T* vp = kp + static_cast<size_t>(C) * N;
  const T* gp = dout + (static_cast<size_t>(b) * C + h * D) * N;
  const size_t row = (static_cast<size_t>(b) * gridDim.y + h) * N;
  const int ncr = sh.k1 - sh.k0, ch0 = sh.k0 * kChunk, ch1 = sh.k1 * kChunk;
  const int spans = (ch1 - ch0 + kSlotRows - 1) / kSlotRows;
  const int p1 = nt * 2 * ncr, n_steps = p1 + spans * nt;
  const FastDiv fc(2 * ncr), ft(nt);  // a step's tile and chunk, without a division
  const float sl2 = scale * lw::kLog2e;

  auto issue = [&](T* dst, int step) {  // phase 1: (q, k) and (d(out), v) chunks; phase 2: 128 channels of k
    if (step < p1) {
      const int j0 = fc.div(step) * kCols, c = fc.mod(step);
      const size_t off = static_cast<size_t>(sh.k0 + c / 2) * kChunk * N;
      rc.copy<kChunk>(dst, (c & 1 ? gp : qp) + off, N, i0);
      tc.copy<kChunk>(dst + kChunk * kStride, (c & 1 ? vp : kp) + off, N, j0);
    } else {
      const int c0 = ch0 + ft.div(step - p1) * kSlotRows, j0 = ft.mod(step - p1) * kCols;
      load_slice(tc, dst, kp + static_cast<size_t>(c0) * N, N, j0, min(kSlotRows, ch1 - c0));
    }
  };

  float s[NT][4], dp[NT][4], dq[8][4];
  const int i_lo = i0 + L.m0 + L.g, i_hi = i_lo + 8;
  Ring<T> rng{ring, stages, n_steps};
  rng.prologue(issue);
  for (int step = 0; step < n_steps; ++step) {
    const T* cur = rng.next(issue);
    if (step < p1) {
      const int c = fc.mod(step);
      if (c & 1)
        add_chunk(dp, c == 1, cur, cur + kChunk * kStride, L.m0, n0, L.lane);
      else
        add_chunk(s, c == 0, cur, cur + kChunk * kStride, L.m0, n0, L.lane);
      if (c == 2 * ncr - 1) {
        const int j0 = fc.div(step) * kCols;
        mask_columns(s, j0 + n0, N, L.t);  // a key past N: p = 0
        put_rows(SS, ld, s, L.m0, j0 + n0, L.g, L.t);
        put_rows(DS, ld, dp, L.m0, j0 + n0, L.g, L.t);
      }
    } else {
      const int k = step - p1, c0 = ch0 + ft.div(k) * kSlotRows, jt = ft.mod(k);
      if (k == 0) {  // p, the row term and ds of the resident rows, over the cluster
        cl.sync();
        float m = row_all<true>(sum_partials(cl, SS, ld, sh));
        sum_partials(cl, DS, ld, sh);
        const int i = i0 + sh.row;
        float lse_i;
        if (take_lse) {
          const float l = row_all<false>(share_sum(SS, ld, sh, m, sl2));
          if (sh.j == 0) {
            st[sh.row] = m;
            st[64 + sh.row] = l;
          }
          cl.sync();
          float lsum;
          combine_rows(cl, st, sh.row, sl2, sh.CS, m, lsum);
          lse_i = m * sl2 + log2f(lsum);
        } else {  // past N: p = 0
          lse_i = i < N ? lse[row + i] : INFINITY;
        }
        float r = 0.f;
        float4* sr = reinterpret_cast<float4*>(SS + sh.row * ld);
        const float4* dr = reinterpret_cast<const float4*>(DS + sh.row * ld);
#pragma unroll 4
        for (int cc = sh.c0 + sh.j; cc < sh.c1; cc += kRowThreads) {
          float4 v = sr[cc];
          const float4 d = dr[cc];
          v.x = lw::fast_exp2(fmaf(v.x, sl2, -lse_i));
          v.y = lw::fast_exp2(fmaf(v.y, sl2, -lse_i));
          v.z = lw::fast_exp2(fmaf(v.z, sl2, -lse_i));
          v.w = lw::fast_exp2(fmaf(v.w, sl2, -lse_i));
          r = fmaf(v.x, d.x, fmaf(v.y, d.y, fmaf(v.z, d.z, fmaf(v.w, d.w, r))));
          sr[cc] = v;
        }
        r = row_all<false>(r);
        if (sh.j == 0) st[128 + sh.row] = r;
        cl.sync();
        float dsum = 0.f;  // the row term, in the order of the ranks
        for (int q = 0; q < sh.CS; ++q) dsum += cl.map_shared_rank(st, q)[128 + sh.row];
        float4* dw = reinterpret_cast<float4*>(DS + sh.row * ld);
#pragma unroll 4
        for (int cc = sh.c0 + sh.j; cc < sh.c1; cc += kRowThreads) {  // ds = p (dp - row) scale
          const float4 p = sr[cc];
          float4 d = dw[cc];
          d.x = p.x * (d.x - dsum) * scale;
          d.y = p.y * (d.y - dsum) * scale;
          d.z = p.z * (d.z - dsum) * scale;
          d.w = p.w * (d.w - dsum) * scale;
          dw[cc] = d;
        }
        if (sh.rank == 0 && sh.j == 0 && i < N) {
          delta[row + i] = dsum;
          if (take_lse) lse[row + i] = lse_i;
        }
        cl.sync();  // every block's share of ds is in place
        gather_shares(cl, DS, ld, n4, sh);
        cl.sync();
      }
      if (jt == 0) lw::zero(dq);
      const int w = kChunk * L.cg;  // this warp's 64 of the step's 128 channels
      if (c0 + w < ch1) {
        float ds[8][4];
        get_rows(DS, ld, ds, L.m0, jt * kCols, L.g, L.t);
        lw::mma_rt<8, 8>(dq, ds, cur, kStride, 0, w, L.lane);  // dQ += dS K^T
        if (jt == nt - 1)
          store_tiles<T, 8>(dqkv + (img + h * D + c0 + w) * N, dq, N, i_lo, i_hi, L.t);
      }
    }
    __syncthreads();
  }
}

// backward pass 2: dk and dv for this block's keys and its share of the
// channels; lse and delta of every query as pass 1 stored them
template <typename T>
__global__ void __launch_bounds__(kResMaxThreads, 1)
resident_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dqkv, int C, int N, int D, float scale, int vec,
                     int stages) {
  constexpr int G = kResG, NT = 8 / G;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* const ring = reinterpret_cast<T*>(wide_smem);
  cg::cluster_group cl = cg::this_cluster();
  const Layout<G> L;
  const int ld = score_stride(N), nthreads = blockDim.x;
  const Copier rc(vec, L.rows, L.tid, nthreads), tc(vec, kCols, L.tid, nthreads);
  const int nt = (N + kCols - 1) / kCols, nc = D / kChunk, n4 = nt * kCols / 4;
  const Share sh(cl, nc, n4);
  float* const PP = reinterpret_cast<float*>(ring + stages * kSlotElems);  // s^T, then p^T
  float* const DD = PP + L.rows * ld;                                      // dp^T, then ds^T
  float* const ls = DD + L.rows * ld + 4 * 16 * kMaxRowGroups;  // every query's lse
  float* const dls = ls + padded_cols(N);                        // and delta
  const int j0 = blockIdx.x / sh.CS * L.rows, n0 = L.cg * 8 * NT;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const T* qp = qkv + (img + h * D) * N;
  const T* kp = qp + static_cast<size_t>(C) * N;
  const T* vp = kp + static_cast<size_t>(C) * N;
  const T* gp = dout + (static_cast<size_t>(b) * C + h * D) * N;
  const size_t row = (static_cast<size_t>(b) * gridDim.y + h) * N;
  const int ncr = sh.k1 - sh.k0;
  const int p1 = nt * 2 * ncr, n_steps = p1 + ncr * nt;
  const FastDiv fc(2 * ncr), ft(nt);  // a step's tile and chunk, without a division
  const float sl2 = scale * lw::kLog2e;

  // phase 1: (k, q) and (v, d(out)) chunks; phase 2: 64 channels of q and of d(out)
  auto issue = [&](T* dst, int step) {
    if (step < p1) {
      const int i0 = fc.div(step) * kCols, c = fc.mod(step);
      const size_t off = static_cast<size_t>(sh.k0 + c / 2) * kChunk * N;
      rc.copy<kChunk>(dst, (c & 1 ? vp : kp) + off, N, j0);
      tc.copy<kChunk>(dst + kChunk * kStride, (c & 1 ? gp : qp) + off, N, i0);
    } else {
      const size_t off = static_cast<size_t>((sh.k0 + ft.div(step - p1)) * kChunk) * N;
      const int i0 = ft.mod(step - p1) * kCols;
      load_slice(tc, dst, qp + off, N, i0, kChunk);
      load_slice(tc, dst + kChunk * kStride, gp + off, N, i0, kChunk);
    }
  };

  for (int i = L.tid; i < nt * kCols; i += nthreads) {  // a query past N: p = 0, no row term
    ls[i] = i < N ? lse[row + i] : INFINITY;
    dls[i] = i < N ? delta[row + i] : 0.f;
  }
  float s[NT][4], dp[NT][4];  // (16 keys) x (8 NT queries): partial S^T, dP^T
  float dk[4][4], dv[4][4];   // 32 channels of 64
  const int j_lo = j0 + L.m0 + L.g, j_hi = j_lo + 8;
  Ring<T> rng{ring, stages, n_steps};
  rng.prologue(issue);
  for (int step = 0; step < n_steps; ++step) {
    const T* cur = rng.next(issue);
    if (step < p1) {
      const int c = fc.mod(step);
      if (c & 1)
        add_chunk(dp, c == 1, cur, cur + kChunk * kStride, L.m0, n0, L.lane);
      else
        add_chunk(s, c == 0, cur, cur + kChunk * kStride, L.m0, n0, L.lane);
      if (c == 2 * ncr - 1) {
        const int i0 = fc.div(step) * kCols + n0;
        put_rows(PP, ld, s, L.m0, i0, L.g, L.t);
        put_rows(DD, ld, dp, L.m0, i0, L.g, L.t);
      }
    } else {
      const int k = step - p1, c0 = (sh.k0 + ft.div(k)) * kChunk, it = ft.mod(k);
      if (k == 0) {  // p and ds of the resident rows, over the cluster
        cl.sync();
        sum_partials(cl, PP, ld, sh);
        sum_partials(cl, DD, ld, sh);
        float4* pr = reinterpret_cast<float4*>(PP + sh.row * ld);
        float4* dr = reinterpret_cast<float4*>(DD + sh.row * ld);
#pragma unroll 4
        for (int cc = sh.c0 + sh.j; cc < sh.c1; cc += kRowThreads) {
          const float4 l4 = reinterpret_cast<const float4*>(ls)[cc];
          const float4 d4 = reinterpret_cast<const float4*>(dls)[cc];
          float4 v = pr[cc], d = dr[cc];
          v.x = lw::fast_exp2(fmaf(v.x, sl2, -l4.x));
          v.y = lw::fast_exp2(fmaf(v.y, sl2, -l4.y));
          v.z = lw::fast_exp2(fmaf(v.z, sl2, -l4.z));
          v.w = lw::fast_exp2(fmaf(v.w, sl2, -l4.w));
          d.x = v.x * (d.x - d4.x) * scale;
          d.y = v.y * (d.y - d4.y) * scale;
          d.z = v.z * (d.z - d4.z) * scale;
          d.w = v.w * (d.w - d4.w) * scale;
          pr[cc] = v;
          dr[cc] = d;
        }
        cl.sync();
        gather_shares(cl, PP, ld, n4, sh);
        gather_shares(cl, DD, ld, n4, sh);
        cl.sync();
      }
      if (it == 0) {
        lw::zero(dk);
        lw::zero(dv);
      }
      float p[8][4];
      const int w = kGroup * L.cg;  // this warp's 32 channels of the step's 64
      get_rows(DD, ld, p, L.m0, it * kCols, L.g, L.t);
      lw::mma_rt<8, 4>(dk, p, cur, kStride, 0, w, L.lane);  // dK += dS^T Q^T
      get_rows(PP, ld, p, L.m0, it * kCols, L.g, L.t);
      lw::mma_rt<8, 4>(dv, p, cur + kChunk * kStride, kStride, 0, w, L.lane);  // dV += P^T dO^T
      if (it == nt - 1) {
        store_tiles<T, 4>(dqkv + (img + C + h * D + c0 + w) * N, dk, N, j_lo, j_hi, L.t);
        store_tiles<T, 4>(dqkv + (img + 2 * C + h * D + c0 + w) * N, dv, N, j_lo, j_hi, L.t);
      }
    }
    __syncthreads();
  }
}

// ---- host side ------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

inline int max_smem() {
  static const int n = [] {
    int dev = 0, bytes = 227 * 1024;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return bytes;
  }();
  return n;
}

inline size_t sm_smem() {
  static const size_t n = [] {
    int dev = 0, bytes = 228 * 1024;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    return static_cast<size_t>(bytes);
  }();
  return n;
}

// The ring's slots beside `extra` bytes a block: the most (2 to kMaxStages)
// that leave room for two blocks an SM, else for one; 0 when not even two
// slots fit.
template <typename T>
inline int ring_stages(size_t extra, size_t slot = slot_bytes<T>()) {
  for (int blocks = 2; blocks >= 1; --blocks) {
    size_t room = sm_smem() / blocks - 1024;  // the system's reserve a block
    if (room > static_cast<size_t>(max_smem())) room = max_smem();
    if (room <= extra) continue;
    const size_t n = (room - extra) / slot;
    if (n >= 2) return n < kMaxStages ? static_cast<int>(n) : kMaxStages;
  }
  return 0;
}

inline long long blocks_of(const dim3& grid) {
  return static_cast<long long>(grid.x) * grid.y * grid.z;
}

// A resident launch: R row groups (16 R rows a block), clusters of CS blocks
// splitting the D chunks, and the ring's slots; R = 0: the rows do not fit.
struct ResPlan {
  int R = 0, CS = 1, stages = 0;
};

// The plan that puts a block on every SM (else the most blocks) in the
// fewest step times an SM: the blocks it carries times a block's steps (phase
// 1's chunk steps, phase 2's channel steps, and about kExchangeSteps for a
// cluster's exchange through distributed shared memory). A step's wait for
// its tiles, not its products, is what these kernels spend, and a block's
// steps fall with its share of D.
constexpr int kExchangeSteps = 4;

template <typename T>
inline ResPlan resident_plan(int B, int H, int N, int D, int arrays, bool stats) {
  const int nc = D / kChunk, nt = (N + kCols - 1) / kCols;
  ResPlan best;
  bool filled = false;
  long long best_cost = 0, best_blocks = 0;
  for (int R = kMaxRowGroups; R >= 1; R /= 2) {
    const int stages = ring_stages<T>(resident_extra(16 * R, N, arrays, stats));
    if (stages == 0) continue;
    for (int CS = 1; CS <= kMaxSplit && CS <= nc; CS *= 2) {
      const long long blocks = blocks_of(resident_grid(B, H, N, R, CS));
      const bool fills = blocks >= sm_count();
      const int ncr = (nc + CS - 1) / CS, span = stats ? kChunk : kSlotRows;
      const long long steps = static_cast<long long>(nt) * (ncr * arrays +
                                                         (ncr * kChunk + span - 1) / span) +
                              (CS > 1 ? kExchangeSteps : 0);
      const long long cost = (blocks + sm_count() - 1) / sm_count() * steps;
      const bool better = best.R == 0 || (fills && !filled) ||
                          (fills == filled && (fills ? cost < best_cost : blocks > best_blocks));
      if (better) {
        best = ResPlan{R, CS, stages};
        filled = fills;
        best_cost = cost;
        best_blocks = blocks;
      }
    }
  }
  return best;
}

// a kernel launched in clusters of CS blocks along x
template <typename K, typename... Args>
cudaError_t launch_clusters(K kernel, dim3 grid, int threads, size_t smem, int CS,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// A streaming launch: warps a block (16 rows each) and 32-channel
// accumulator groups a warp (a block's span of output channels)
struct Plan {
  int warps, groups;
  dim3 grid(int B, int H, int N, int D) const {
    const int rows = 16 * warps, span = kGroup * groups;
    return dim3((N + rows - 1) / rows, H * ((D + span - 1) / span), B);
  }
};

constexpr int kForwardGroups = 4;  // a span of 128 channels
constexpr int kDqGroups = 4;
constexpr int kDkdvGroups = 2;     // dk and dv both: 64 channels
constexpr Plan kSmallPlan = {2, 1};

// 4 warps of `groups` accumulator groups; where that leaves SMs idle, 2 warps
// of one group (the most blocks)
inline Plan plan(int B, int H, int N, int D, int groups) {
  const Plan p{4, groups};
  return blocks_of(p.grid(B, H, N, D)) >= sm_count() ? p : kSmallPlan;
}

template <typename T>
using ForwardKernel = void (*)(const T*, T*, float*, int, int, int, float, int, int);
template <typename T>
using GradKernel = void (*)(const T*, const T*, const float*, const float*, T*, int, int, int,
                            float, int, int);

template <typename T>
ForwardKernel<T> forward_kernel_of(const Plan& p) {
  return p.groups == kForwardGroups ? forward_kernel<T, kForwardGroups> : forward_kernel<T, 1>;
}

template <typename T>
GradKernel<T> dq_kernel_of(const Plan& p) {
  return p.groups == kDqGroups ? dq_kernel<T, kDqGroups> : dq_kernel<T, 1>;
}

template <typename T>
GradKernel<T> dkdv_kernel_of(const Plan& p) {
  return p.groups == kDkdvGroups ? dkdv_kernel<T, kDkdvGroups> : dkdv_kernel<T, 1>;
}

template <typename T>
cudaError_t forward(const void* qkv, void* out, float* lse, int B, int C, int N, int D,
                    float scale, cudaStream_t stream) {
  const int H = C / D, vec = copy_width(qkv, N, sizeof(T));
  if constexpr (sizeof(T) == 2) {
    if (D == kFaD && blocks_of(dim3((N + kCols - 1) / kCols, H, B)) >= sm_count()) {
      const size_t q_bytes = static_cast<size_t>(kFaD) * kStride * sizeof(T);
      const int stages = ring_stages<T>(q_bytes, kFaSlot * sizeof(T));
      const size_t smem = stages * kFaSlot * sizeof(T) + q_bytes;
      if (cudaError_t err = allow_smem(fa2_forward_kernel<T>, smem)) return err;
      fa2_forward_kernel<T><<<dim3((N + kCols - 1) / kCols, H, B), kThreads, smem, stream>>>(
          static_cast<const T*>(qkv), static_cast<T*>(out), lse, C, N, scale * lw::kLog2e, vec,
          stages);
      return cudaGetLastError();
    }
  }
  const ResPlan r = resident_plan<T>(B, H, N, D, 1, false);
  if (r.R > 0) {
    const size_t smem = r.stages * slot_bytes<T>() + resident_extra(16 * r.R, N, 1, false);
    if (cudaError_t err = allow_smem(resident_forward_kernel<T>, smem)) return err;
    return launch_clusters(resident_forward_kernel<T>, resident_grid(B, H, N, r.R, r.CS),
                           32 * kResG * r.R, smem, r.CS, stream, static_cast<const T*>(qkv),
                           static_cast<T*>(out), lse, C, N, D, scale * lw::kLog2e, vec,
                           r.stages);
  }
  const Plan p = plan(B, H, N, D, kForwardGroups);
  const ForwardKernel<T> kernel = forward_kernel_of<T>(p);
  const int stages = ring_stages<T>(streaming_extra(1));
  const size_t smem = stages * slot_bytes<T>() + streaming_extra(1);
  if (cudaError_t err = allow_smem(kernel, smem)) return err;
  kernel<<<p.grid(B, H, N, D), 32 * p.warps, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), lse, C, N, D, scale * lw::kLog2e, vec,
      stages);
  return cudaGetLastError();
}

// lse and delta (B, H, N) f32: lse as the forward wrote it, or, when
// `take_lse`, scratch into which pass 1 writes the row log-sum-exp it takes
// itself (no forward wrote one: K7nb); delta scratch. Three launches on one
// stream, each reading what the one before stored.
template <typename T>
cudaError_t backward(const void* qkv, float* lse, const void* dout, void* dqkv, float* delta,
                     int B, int C, int N, int D, float scale, bool take_lse,
                     cudaStream_t stream) {
  const T* x = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* dx = static_cast<T*>(dqkv);
  const int H = C / D;
  const int vq = copy_width(qkv, N, sizeof(T)), vg = copy_width(dout, N, sizeof(T));
  const int vec = vq < vg ? vq : vg;
  if constexpr (sizeof(T) == 2) {
    if (D == kFaD && blocks_of(dim3((N + kCols - 1) / kCols, H, B)) >= sm_count()) {
      const size_t own = 2 * static_cast<size_t>(kFaD) * kStride * sizeof(T);
      const size_t rows_smem = ring_stages<T>(streaming_extra(1)) * slot_bytes<T>() +
                               streaming_extra(1);
      const int stages = ring_stages<T>(own, kFaSlot * sizeof(T));
      const size_t smem = stages * kFaSlot * sizeof(T) + own;
      if (cudaError_t err = allow_smem(rows_kernel<T>, rows_smem)) return err;
      if (cudaError_t err = allow_smem(fa2_dq_kernel<T>, smem)) return err;
      if (cudaError_t err = allow_smem(fa2_kv_kernel<T, true>, smem)) return err;
      if (cudaError_t err = allow_smem(fa2_kv_kernel<T, false>, smem)) return err;
      const dim3 grid((N + kCols - 1) / kCols, H, B);
      rows_kernel<T><<<grid, kThreads, rows_smem, stream>>>(
          x, g, lse, delta, C, N, D, scale * lw::kLog2e, take_lse,
          vec, ring_stages<T>(streaming_extra(1)));
      if (cudaError_t err = cudaGetLastError()) return err;
      fa2_dq_kernel<T><<<grid, kThreads, smem, stream>>>(x, g, lse, delta, dx, C, N, scale, vec,
                                                           stages);
      if (cudaError_t err = cudaGetLastError()) return err;
      fa2_kv_kernel<T, true><<<grid, kThreads, smem, stream>>>(x, g, lse, delta, dx, C, N, scale,
                                                                 vec, stages);
      if (cudaError_t err = cudaGetLastError()) return err;
      fa2_kv_kernel<T, false><<<grid, kThreads, smem, stream>>>(x, g, lse, delta, dx, C, N, scale,
                                                                  vec, stages);
      return cudaGetLastError();
    }
  }
  const ResPlan rq = resident_plan<T>(B, H, N, D, 2, false);
  const ResPlan rk = resident_plan<T>(B, H, N, D, 2, true);
  if (rq.R > 0 && rk.R > 0) {
    const size_t smem_q = rq.stages * slot_bytes<T>() + resident_extra(16 * rq.R, N, 2, false);
    const size_t smem_k = rk.stages * slot_bytes<T>() + resident_extra(16 * rk.R, N, 2, true);
    if (cudaError_t err = allow_smem(resident_dq_kernel<T>, smem_q)) return err;
    if (cudaError_t err = allow_smem(resident_dkdv_kernel<T>, smem_k)) return err;
    if (cudaError_t err = launch_clusters(resident_dq_kernel<T>,
                                          resident_grid(B, H, N, rq.R, rq.CS), 32 * kResG * rq.R,
                                          smem_q, rq.CS, stream, x, g, lse, delta, dx, C, N, D,
                                          scale, static_cast<int>(take_lse), vec, rq.stages))
      return err;
    return launch_clusters(resident_dkdv_kernel<T>, resident_grid(B, H, N, rk.R, rk.CS),
                           32 * kResG * rk.R, smem_k, rk.CS, stream, x, g,
                           static_cast<const float*>(lse), static_cast<const float*>(delta), dx,
                           C, N, D, scale, vec, rk.stages);
  }
  const int stages = ring_stages<T>(streaming_extra(2));
  const size_t smem = stages * slot_bytes<T>() + streaming_extra(1);
  const size_t dkdv_smem = stages * slot_bytes<T>() + streaming_extra(2);
  const int rows_warps = static_cast<long long>((N + 63) / 64) * H * B >= sm_count() ? 4 : 2;
  const Plan pq = plan(B, H, N, D, kDqGroups), pk = plan(B, H, N, D, kDkdvGroups);
  const GradKernel<T> dq = dq_kernel_of<T>(pq), dkdv = dkdv_kernel_of<T>(pk);
  if (cudaError_t err = allow_smem(rows_kernel<T>, smem)) return err;
  if (cudaError_t err = allow_smem(dq, smem)) return err;
  if (cudaError_t err = allow_smem(dkdv, dkdv_smem)) return err;
  const int rows = 16 * rows_warps;
  rows_kernel<T><<<dim3((N + rows - 1) / rows, H, B), 32 * rows_warps, smem, stream>>>(
      x, g, lse, delta, C, N, D, scale * lw::kLog2e, take_lse, vec, stages);
  if (cudaError_t err = cudaGetLastError()) return err;
  dq<<<pq.grid(B, H, N, D), 32 * pq.warps, smem, stream>>>(x, g, lse, delta, dx, C, N, D, scale,
                                                           vec, stages);
  if (cudaError_t err = cudaGetLastError()) return err;
  dkdv<<<pk.grid(B, H, N, D), 32 * pk.warps, dkdv_smem, stream>>>(x, g, lse, delta, dx, C, N, D,
                                                                  scale, vec, stages);
  return cudaGetLastError();
}

// attrs[0..2] <- the larger registers, the summed local bytes and the larger
// static shared bytes of attrs[0..2] and the kernel fn's
inline int fold_attributes(const void* fn, int* attrs) {
  int a[3];
  if (int err = lw::kernel_attributes(fn, a)) return err;
  attrs[0] = attrs[0] > a[0] ? attrs[0] : a[0];
  attrs[1] += a[1];
  attrs[2] = attrs[2] > a[2] ? attrs[2] : a[2];
  return cudaSuccess;
}

// attrs[0..2]: registers (the most), local bytes (the sum) and static shared
// bytes of the forward's cases (the host picks one per shape); D
// is any head dim the wide case takes
template <typename T>
int forward_attributes(int D, int* attrs) {
  (void)D;
  attrs[0] = attrs[1] = attrs[2] = 0;
  if (int err = fold_attributes(reinterpret_cast<const void*>(resident_forward_kernel<T>), attrs))
    return err;
  if constexpr (sizeof(T) == 2) {
    if (int err = fold_attributes(reinterpret_cast<const void*>(fa2_forward_kernel<T>), attrs))
      return err;
  }
  const Plan fwd_plans[] = {{4, kForwardGroups}, kSmallPlan};
  for (const Plan& p : fwd_plans)
    if (int err = fold_attributes(reinterpret_cast<const void*>(forward_kernel_of<T>(p)), attrs))
      return err;
  return cudaSuccess;
}

// attrs[0..2]: those of backward passes 1 and 2 (every case) folded as
// above; attrs[3..5]: those of pass 3
template <typename T>
int backward_attributes(int D, int* attrs) {
  (void)D;
  for (int i = 0; i < 6; ++i) attrs[i] = 0;
  if (int err = fold_attributes(reinterpret_cast<const void*>(rows_kernel<T>), attrs)) return err;
  if (int err = fold_attributes(reinterpret_cast<const void*>(resident_dq_kernel<T>), attrs))
    return err;
  if (int err = fold_attributes(reinterpret_cast<const void*>(resident_dkdv_kernel<T>), attrs + 3))
    return err;
  if constexpr (sizeof(T) == 2) {
    if (int err = fold_attributes(reinterpret_cast<const void*>(fa2_dq_kernel<T>), attrs)) return err;
    if (int err = fold_attributes(reinterpret_cast<const void*>(fa2_kv_kernel<T, true>), attrs + 3))
      return err;
    if (int err = fold_attributes(reinterpret_cast<const void*>(fa2_kv_kernel<T, false>), attrs + 3))
      return err;
  }
  const Plan dq_plans[] = {{4, kDqGroups}, kSmallPlan};
  for (const Plan& p : dq_plans)
    if (int err = fold_attributes(reinterpret_cast<const void*>(dq_kernel_of<T>(p)), attrs))
      return err;
  const Plan dkdv_plans[] = {{4, kDkdvGroups}, kSmallPlan};
  for (const Plan& p : dkdv_plans)
    if (int err = fold_attributes(reinterpret_cast<const void*>(dkdv_kernel_of<T>(p)), attrs + 3))
      return err;
  return cudaSuccess;
}

}  // namespace lw_wide
