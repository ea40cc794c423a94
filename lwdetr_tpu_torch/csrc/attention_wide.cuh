// The wide case of the attention kernels: head_dim 128, 256, 512, 1024 and
// 2048.
//
// The JAX package computes the decoder's head_dim from the CLI's
// --hidden_dim / --sa_nheads (e.g. 256 / 2 = 128, 512 / 1 = 512); the ViT's
// heads never exceed 64. K2 (flash_attention.cu), K9 (window_attention.cu),
// K6 (flash_attention_bwd.cu) and the no-bias case of K7
// (window_attention_bwd.cu, "K7nb") launch these kernels at those head dims;
// `attention_cm` zero-pads a head_dim between two cases up to the next one.
// They compute what the narrow cases compute, in f32 and bf16, with the bf16
// roundings of the JAX kernels: p = exp2(s - max) rounded to bf16 before PV
// and the f32 row sum of the unrounded p after it (forward); ds and p rounded
// to bf16 before the three products of the backward, the row term
// sum_j p dp from the unrounded p.
//
// A simple tiling on the CUDA cores, f32 arithmetic in both dtypes.
//
// 128 and 256: a thread holds P channels of one query (or key), so D / P
// adjacent lanes share a row and sum their partial dot products with xor
// shuffles; a block of 128 threads takes 128 / (D / P) rows and streams tiles
// of 16 keys (or queries) of the (D, N) channel rows through shared memory,
// staged as f32. Each lane of a row reads its own P rows of the tile, offset
// by one float a lane so that the lanes' reads fall in different banks. P =
// 32 in the forward (q and the accumulator: 64 registers of data); the
// backward holds four such sets (q, d(out), dq; k, v, dk, dv), so P = 16 there
// (P = 32 spilled at D = 128: 255 registers).
//   forward (K2, K9): one sweep over the keys with an online softmax, as K2's
//     f32 case; writes the row log-sum-exp in log2 units when asked (K6 reads
//     it).
//   backward pass 1, a row per query: the row log-sum-exp (read, or taken in
//     a first sweep when no forward wrote it: K7nb), row_i = sum_j p dp, then
//     dq = sum_j ds k in a last sweep; writes dq and row_i.
//   backward pass 2, a row per key: dk = sum_i ds q and dv = sum_i p d(out)
//     over the query tiles.
//
// 512 to 2048 ("chunked"): a row is one warp, and a row's channels go in
// chunks of 512, 16 a lane (lane l holds channels c * 512 + 16 l + t of chunk
// c). What a row keeps across the tiles (q and the output accumulator; q,
// d(out) and dq; k, v, dk and dv) lies in shared memory, each lane's values
// its own (no lane reads another's), so a thread's registers do not grow with
// D and nothing spills. A tile of keys (or queries) is staged one chunk of
// channels at a time; a score sums the chunks' partial dot products and then
// the warp's lanes (xor shuffles) before the softmax. The products into the
// accumulators then run chunk by chunk again, starting from the chunk still
// staged. Four rows a block of 128 threads, declared at least one block an
// SM (`__launch_bounds__(128, 1)`): the rows' shared memory admits few blocks
// an SM anyway, and without it ptxas capped the f32 forward at 40 registers and
// spilled 48 bytes. 2048 is the widest case (pass 2
// holds 4 x 4 x 2048 floats of rows and two 512-channel tiles: 193 KB of the
// 227 KB a block may take). `attention_cm` refuses a wider head on the card.
#pragma once

#include "common.cuh"

namespace lw_wide {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kForwardPart = 32;  // channels a thread holds in the forward
constexpr int kTile = 16;  // keys (forward, pass 1) or queries (pass 2) a shared tile

constexpr int kChunk = 512;     // channels of a row a warp covers at a time, chunked case
constexpr int kChunkPart = 16;  // of them, a lane's
constexpr int kRows = kThreads / 32;  // rows a block, chunked case: a warp each
constexpr int kWidest = 2048;

inline bool chunked(int D) { return D == 512 || D == 1024 || D == 2048; }
inline bool takes(int D) { return D == 128 || D == 256 || chunked(D); }

constexpr int kBackwardPart = 16;  // channels a thread holds in the backward

// a tile's f32 floats: D channel rows of kTile, one float of offset a lane
template <int P>
__host__ __device__ inline size_t tile_floats(int D) {
  return static_cast<size_t>(D) * kTile + D / P;
}

template <int P>
__device__ __forceinline__ int at(int r, int j) {
  return (r / P) * (P * kTile + 1) + (r % P) * kTile + j;
}

// what the JAX kernels do to p and ds before a product: nothing in f32, a
// round to nearest even bf16 in bf16
template <typename T> __device__ __forceinline__ float operand(float x);
template <> __device__ __forceinline__ float operand<float>(float x) { return x; }
template <> __device__ __forceinline__ float operand<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the sum of x over the `split` adjacent lanes of a row
__device__ __forceinline__ float row_sum(float x, int split) {
  for (int off = 1; off < split; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// tile[(D, kTile)] <- rows [0, D) of src (channel rows of stride N), tokens
// j0 .. j0 + kTile, 0 past N
template <int P, typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src, int D, int N,
                                          int j0) {
  for (int idx = threadIdx.x; idx < D * kTile; idx += kThreads) {
    const int r = idx / kTile, j = idx - r * kTile;
    const int n = j0 + j;
    tile[at<P>(r, j)] = n < N ? lw::to_f32(src[static_cast<size_t>(r) * N + n]) : 0.f;
  }
}

// out[b, hD:(h+1)D, :] = softmax(scale q^T k) v; lse (B, H, N) in log2 units, or null
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, float* __restrict__ lse, int C,
                 int N, int D, float scale_log2) {
  constexpr int kPart = kForwardPart;
  extern __shared__ float wide_smem[];
  float* ks = wide_smem;
  float* vs = wide_smem + tile_floats<kPart>(D);
  const int split = D / kPart;
  const int h = blockIdx.y, b = blockIdx.z;
  const int part = threadIdx.x % split;
  const int i = blockIdx.x * (kThreads / split) + threadIdx.x / split;
  const bool live = i < N;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const T* qp = qkv + (img + h * D + part * kPart) * N;
  const T* kp = qkv + (img + C + h * D) * N;
  const T* vp = qkv + (img + 2 * C + h * D) * N;

  float q[kPart], acc[kPart];
#pragma unroll
  for (int d = 0; d < kPart; ++d) {
    q[d] = live ? lw::to_f32(qp[static_cast<size_t>(d) * N + i]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < N; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<kPart>(ks, kp, D, N, j0);
    load_tile<kPart>(vs, vp, D, N, j0);
    __syncthreads();
    float s[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < kPart; ++d) {
      const float* kr = ks + at<kPart>(part * kPart + d, 0);
#pragma unroll
      for (int j = 0; j < kTile; ++j) s[j] = fmaf(q[d], kr[j], s[j]);
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = j0 + j < N ? row_sum(s[j], split) * scale_log2 : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);  // finite: every tile holds a live key
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kPart; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
      const float pr = operand<T>(p);
#pragma unroll
      for (int d = 0; d < kPart; ++d)
        acc[d] = fmaf(pr, vs[at<kPart>(part * kPart + d, j)], acc[d]);
    }
    m = m_new;
  }
  if (!live) return;
  if (lse != nullptr && part == 0)
    lse[(static_cast<size_t>(b) * gridDim.y + h) * N + i] = m + log2f(l);
  T* o = out + (static_cast<size_t>(b) * C + h * D + part * kPart) * N + i;
#pragma unroll
  for (int d = 0; d < kPart; ++d) o[static_cast<size_t>(d) * N] = lw::from_f32<T>(acc[d] / l);
}

// pass 1: dq and row_i = sum_j p dp per query; takes the row log-sum-exp
// first when `take_lse` (no forward wrote it), and stores it
template <typename T, int kPart>
__global__ void __launch_bounds__(kThreads)
attention_bwd_rows_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                          float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dqkv,
                          int C, int N, int D, float scale, int take_lse) {
  extern __shared__ float wide_smem[];
  float* ks = wide_smem;
  float* vs = wide_smem + tile_floats<kPart>(D);
  const int split = D / kPart;
  const int h = blockIdx.y, b = blockIdx.z;
  const int part = threadIdx.x % split;
  const int i = blockIdx.x * (kThreads / split) + threadIdx.x / split;
  const bool live = i < N;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const size_t row = (static_cast<size_t>(b) * gridDim.y + h) * N + i;
  const T* kp = qkv + (img + C + h * D) * N;
  const T* vp = qkv + (img + 2 * C + h * D) * N;
  const T* qp = qkv + (img + h * D + part * kPart) * N;
  const T* gp = dout + (static_cast<size_t>(b) * C + h * D + part * kPart) * N;
  const float sl2 = scale * lw::kLog2e;

  float q[kPart], g[kPart], dq[kPart];
#pragma unroll
  for (int d = 0; d < kPart; ++d) {
    q[d] = live ? lw::to_f32(qp[static_cast<size_t>(d) * N + i]) : 0.f;
    g[d] = live ? lw::to_f32(gp[static_cast<size_t>(d) * N + i]) : 0.f;
    dq[d] = 0.f;
  }
  float row_lse = live && !take_lse ? lse[row] : 0.f;
  if (take_lse) {
    float m = -INFINITY, l = 0.f;
    for (int j0 = 0; j0 < N; j0 += kTile) {
      __syncthreads();
      load_tile<kPart>(ks, kp, D, N, j0);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < kPart; ++d) s = fmaf(q[d], ks[at<kPart>(part * kPart + d, j)], s);
        s = row_sum(s, split) * sl2;
        if (j0 + j < N) {
          const float m_new = fmaxf(m, s);
          l = l * exp2f(m - m_new) + exp2f(s - m_new);
          m = m_new;
        }
      }
    }
    row_lse = m + log2f(l);
  }
  if (!live) row_lse = INFINITY;  // p = 0

  // sweep 2: row_i = sum_j p dp; sweep 3: dq = sum_j ds k
  float dsum = 0.f;
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int j0 = 0; j0 < N; j0 += kTile) {
      __syncthreads();
      load_tile<kPart>(ks, kp, D, N, j0);
      load_tile<kPart>(vs, vp, D, N, j0);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < kPart; ++d) {
          s = fmaf(q[d], ks[at<kPart>(part * kPart + d, j)], s);
          dp = fmaf(g[d], vs[at<kPart>(part * kPart + d, j)], dp);
        }
        s = row_sum(s, split);
        dp = row_sum(dp, split);
        const float p = j0 + j < N ? exp2f(s * sl2 - row_lse) : 0.f;
        if (sweep == 0) {
          dsum = fmaf(p, dp, dsum);
        } else {
          const float ds = operand<T>(p * (dp - dsum) * scale);
#pragma unroll
          for (int d = 0; d < kPart; ++d)
            dq[d] = fmaf(ds, ks[at<kPart>(part * kPart + d, j)], dq[d]);
        }
      }
    }
  }
  if (!live) return;
  if (part == 0) {
    delta[row] = dsum;
    if (take_lse) lse[row] = row_lse;
  }
  T* o = dqkv + (img + h * D + part * kPart) * N + i;
#pragma unroll
  for (int d = 0; d < kPart; ++d) o[static_cast<size_t>(d) * N] = lw::from_f32<T>(dq[d]);
}

// pass 2: dk = sum_i ds q and dv = sum_i p d(out) per key
template <typename T, int kPart>
__global__ void __launch_bounds__(kThreads)
attention_bwd_cols_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dqkv, int C, int N, int D, float scale) {
  extern __shared__ float wide_smem[];
  float* qs = wide_smem;
  float* gs = wide_smem + tile_floats<kPart>(D);
  float* lse_t = gs + tile_floats<kPart>(D);
  float* delta_t = lse_t + kTile;
  const int split = D / kPart;
  const int h = blockIdx.y, b = blockIdx.z;
  const int part = threadIdx.x % split;
  const int j = blockIdx.x * (kThreads / split) + threadIdx.x / split;
  const bool live = j < N;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const size_t rows = (static_cast<size_t>(b) * gridDim.y + h) * N;
  const T* qp = qkv + (img + h * D) * N;
  const T* gp = dout + (static_cast<size_t>(b) * C + h * D) * N;
  const T* kp = qkv + (img + C + h * D + part * kPart) * N;
  const T* vp = qkv + (img + 2 * C + h * D + part * kPart) * N;
  const float sl2 = scale * lw::kLog2e;

  float k[kPart], v[kPart], dk[kPart], dv[kPart];
#pragma unroll
  for (int d = 0; d < kPart; ++d) {
    k[d] = live ? lw::to_f32(kp[static_cast<size_t>(d) * N + j]) : 0.f;
    v[d] = live ? lw::to_f32(vp[static_cast<size_t>(d) * N + j]) : 0.f;
    dk[d] = dv[d] = 0.f;
  }
  for (int i0 = 0; i0 < N; i0 += kTile) {
    __syncthreads();
    load_tile<kPart>(qs, qp, D, N, i0);
    load_tile<kPart>(gs, gp, D, N, i0);
    if (threadIdx.x < kTile) {
      const int i = i0 + threadIdx.x;
      lse_t[threadIdx.x] = i < N ? lse[rows + i] : INFINITY;  // a query past N: p = 0
      delta_t[threadIdx.x] = i < N ? delta[rows + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int ii = 0; ii < kTile; ++ii) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kPart; ++d) {
        s = fmaf(k[d], qs[at<kPart>(part * kPart + d, ii)], s);
        dp = fmaf(v[d], gs[at<kPart>(part * kPart + d, ii)], dp);
      }
      s = row_sum(s, split);
      dp = row_sum(dp, split);
      const float p = exp2f(s * sl2 - lse_t[ii]);
      const float ds = operand<T>(p * (dp - delta_t[ii]) * scale);
      const float pr = operand<T>(p);
#pragma unroll
      for (int d = 0; d < kPart; ++d) {
        dk[d] = fmaf(ds, qs[at<kPart>(part * kPart + d, ii)], dk[d]);
        dv[d] = fmaf(pr, gs[at<kPart>(part * kPart + d, ii)], dv[d]);
      }
    }
  }
  if (!live) return;
  T* ok = dqkv + (img + C + h * D + part * kPart) * N + j;
  T* ov = dqkv + (img + 2 * C + h * D + part * kPart) * N + j;
#pragma unroll
  for (int d = 0; d < kPart; ++d) {
    ok[static_cast<size_t>(d) * N] = lw::from_f32<T>(dk[d]);
    ov[static_cast<size_t>(d) * N] = lw::from_f32<T>(dv[d]);
  }
}

// ---- the chunked case: 512 to 2048 channels a head -----------------------

// the index of this lane's value t of chunk c in a row's vector in shared
// memory (D floats a row, laid out (chunk, t, lane): no bank conflicts)
__device__ __forceinline__ int own(int c, int t) {
  return (c * kChunkPart + t) * 32 + static_cast<int>(threadIdx.x % 32);
}

// the tile float of this lane's channel t of a staged chunk, key (or query) j
__device__ __forceinline__ const float* chunk_row(const float* tile, int t) {
  return tile + at<kChunkPart>(static_cast<int>(threadIdx.x % 32) * kChunkPart + t, 0);
}

// vec <- this lane's channels of token i of the (D, N) channel rows at src, 0 when dead
template <typename T>
__device__ __forceinline__ void stage_row(float* vec, const T* __restrict__ src, int D, int N,
                                          int i, bool live) {
  const int lane = threadIdx.x % 32;
  for (int c = 0; c < D / kChunk; ++c) {
#pragma unroll
    for (int t = 0; t < kChunkPart; ++t) {
      const size_t d = static_cast<size_t>(c) * kChunk + lane * kChunkPart + t;
      vec[own(c, t)] = live ? lw::to_f32(src[d * N + i]) : 0.f;
    }
  }
}

__device__ __forceinline__ void zero_row(float* vec, int D) {
  for (int c = 0; c < D / kChunk; ++c) {
#pragma unroll
    for (int t = 0; t < kChunkPart; ++t) vec[own(c, t)] = 0.f;
  }
}

// token i of the (D, N) channel rows at dst <- this lane's channels of vec / l.
// l >= 1 (a row sum of the softmax holds exp2(0) = 1), where __fdividef needs
// no slow path: the precise division's would be a call, and its spills.
template <typename T>
__device__ __forceinline__ void write_row(T* __restrict__ dst, const float* vec, int D, int N,
                                          int i, float l = 1.f) {
  const int lane = threadIdx.x % 32;
  for (int c = 0; c < D / kChunk; ++c) {
#pragma unroll
    for (int t = 0; t < kChunkPart; ++t) {
      const size_t d = static_cast<size_t>(c) * kChunk + lane * kChunkPart + t;
      const float x = vec[own(c, t)];
      dst[d * N + i] = lw::from_f32<T>(l == 1.f ? x : __fdividef(x, l));
    }
  }
}

// acc[j] += this lane's part of the dot product of a row's chunk c with
// token j of the staged chunk
__device__ __forceinline__ void chunk_dots(float (&acc)[kTile], const float* vec, int c,
                                           const float* tile) {
#pragma unroll
  for (int t = 0; t < kChunkPart; ++t) {
    const float x = vec[own(c, t)];
    const float* r = chunk_row(tile, t);
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[j] = fmaf(x, r[j], acc[j]);
  }
}

// a row's chunk c of vec <- vec x alpha + sum_j w[j] x token j of the staged chunk
__device__ __forceinline__ void chunk_accumulate(float* vec, int c, float alpha,
                                                 const float (&w)[kTile], const float* tile) {
#pragma unroll
  for (int t = 0; t < kChunkPart; ++t) {
    const int idx = own(c, t);
    const float* r = chunk_row(tile, t);
    float a = vec[idx] * alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) a = fmaf(w[j], r[j], a);
    vec[idx] = a;
  }
}

// the staged chunk c of the (D, N) channel rows at src, tokens j0 .. j0 + kTile
template <typename T>
__device__ __forceinline__ void stage_chunk(float* tile, const T* __restrict__ src, int c, int N,
                                            int j0) {
  __syncthreads();  // the previous chunk is consumed
  load_tile<kChunkPart>(tile, src + static_cast<size_t>(c) * kChunk * N, kChunk, N, j0);
  __syncthreads();
}

__host__ __device__ inline size_t chunk_tile_floats() { return tile_floats<kChunkPart>(kChunk); }

// the forward, chunked: what attention_kernel computes
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
attention_chunked_kernel(const T* __restrict__ qkv, T* __restrict__ out, float* __restrict__ lse,
                         int C, int N, int D, float scale_log2) {
  extern __shared__ float wide_smem[];
  float* tile = wide_smem;
  const int warp = threadIdx.x / 32;
  float* qv = wide_smem + chunk_tile_floats() + static_cast<size_t>(warp) * 2 * D;
  float* acc = qv + D;
  const int chunks = D / kChunk;
  const int h = blockIdx.y, b = blockIdx.z;
  const int i = blockIdx.x * kRows + warp;
  const bool live = i < N;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const T* kp = qkv + (img + C + h * D) * N;
  const T* vp = qkv + (img + 2 * C + h * D) * N;
  stage_row(qv, qkv + (img + h * D) * N, D, N, i, live);
  zero_row(acc, D);

  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < N; j0 += kTile) {
    float s[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) s[j] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      stage_chunk(tile, kp, c, N, j0);
      chunk_dots(s, qv, c, tile);
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = j0 + j < N ? row_sum(s[j], 32) * scale_log2 : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);  // finite: every tile holds a live key
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
      s[j] = operand<T>(p);
    }
    for (int c = 0; c < chunks; ++c) {
      stage_chunk(tile, vp, c, N, j0);
      chunk_accumulate(acc, c, alpha, s, tile);
    }
    m = m_new;
  }
  if (!live) return;
  if (lse != nullptr && threadIdx.x % 32 == 0)
    lse[(static_cast<size_t>(b) * gridDim.y + h) * N + i] = m + log2f(l);
  write_row(out + (static_cast<size_t>(b) * C + h * D) * N, acc, D, N, i, l);
}

// pass 1, chunked: what attention_bwd_rows_kernel computes
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_rows_chunked_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                  float* __restrict__ lse, float* __restrict__ delta,
                                  T* __restrict__ dqkv, int C, int N, int D, float scale,
                                  int take_lse) {
  extern __shared__ float wide_smem[];
  float* ks = wide_smem;
  float* vs = wide_smem + chunk_tile_floats();
  const int warp = threadIdx.x / 32;
  float* qv = vs + chunk_tile_floats() + static_cast<size_t>(warp) * 3 * D;
  float* gv = qv + D;
  float* dq = gv + D;
  const int chunks = D / kChunk;
  const int h = blockIdx.y, b = blockIdx.z;
  const int i = blockIdx.x * kRows + warp;
  const bool live = i < N;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const size_t row = (static_cast<size_t>(b) * gridDim.y + h) * N + i;
  const T* kp = qkv + (img + C + h * D) * N;
  const T* vp = qkv + (img + 2 * C + h * D) * N;
  const float sl2 = scale * lw::kLog2e;
  stage_row(qv, qkv + (img + h * D) * N, D, N, i, live);
  stage_row(gv, dout + (static_cast<size_t>(b) * C + h * D) * N, D, N, i, live);
  zero_row(dq, D);

  float row_lse = live && !take_lse ? lse[row] : 0.f;
  if (take_lse) {
    float m = -INFINITY, l = 0.f;
    for (int j0 = 0; j0 < N; j0 += kTile) {
      float s[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) s[j] = 0.f;
      for (int c = 0; c < chunks; ++c) {
        stage_chunk(ks, kp, c, N, j0);
        chunk_dots(s, qv, c, ks);
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float sj = row_sum(s[j], 32) * sl2;
        if (j0 + j < N) {
          const float m_new = fmaxf(m, sj);
          l = l * exp2f(m - m_new) + exp2f(sj - m_new);
          m = m_new;
        }
      }
    }
    row_lse = m + log2f(l);
  }
  if (!live) row_lse = INFINITY;  // p = 0

  // sweep 0: row_i = sum_j p dp; sweep 1: dq = sum_j ds k
  float dsum = 0.f;
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int j0 = 0; j0 < N; j0 += kTile) {
      float s[kTile], dp[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) s[j] = dp[j] = 0.f;
      for (int c = 0; c < chunks; ++c) {
        __syncthreads();  // the previous chunks are consumed
        load_tile<kChunkPart>(ks, kp + static_cast<size_t>(c) * kChunk * N, kChunk, N, j0);
        load_tile<kChunkPart>(vs, vp + static_cast<size_t>(c) * kChunk * N, kChunk, N, j0);
        __syncthreads();
        chunk_dots(s, qv, c, ks);
        chunk_dots(dp, gv, c, vs);
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float p = j0 + j < N ? exp2f(row_sum(s[j], 32) * sl2 - row_lse) : 0.f;
        const float dpj = row_sum(dp[j], 32);
        if (sweep == 0) dsum = fmaf(p, dpj, dsum);
        s[j] = operand<T>(p * (dpj - dsum) * scale);  // ds (sweep 1)
      }
      if (sweep == 0) continue;
      // the last chunk of k is still staged; the others are staged again
      for (int c = chunks - 1; c >= 0; --c) {
        if (c != chunks - 1) stage_chunk(ks, kp, c, N, j0);
        chunk_accumulate(dq, c, 1.f, s, ks);
      }
    }
  }
  if (!live) return;
  if (threadIdx.x % 32 == 0) {
    delta[row] = dsum;
    if (take_lse) lse[row] = row_lse;
  }
  write_row(dqkv + (img + h * D) * N, dq, D, N, i);
}

// pass 2, chunked: what attention_bwd_cols_kernel computes
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_cols_chunked_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  T* __restrict__ dqkv, int C, int N, int D, float scale) {
  extern __shared__ float wide_smem[];
  float* qs = wide_smem;
  float* gs = qs + chunk_tile_floats();
  float* lse_t = gs + chunk_tile_floats();
  float* delta_t = lse_t + kTile;
  const int warp = threadIdx.x / 32;
  float* kv = delta_t + kTile + static_cast<size_t>(warp) * 4 * D;
  float* vv = kv + D;
  float* dk = vv + D;
  float* dv = dk + D;
  const int chunks = D / kChunk;
  const int h = blockIdx.y, b = blockIdx.z;
  const int j = blockIdx.x * kRows + warp;
  const bool live = j < N;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const size_t rows = (static_cast<size_t>(b) * gridDim.y + h) * N;
  const T* qp = qkv + (img + h * D) * N;
  const T* gp = dout + (static_cast<size_t>(b) * C + h * D) * N;
  const float sl2 = scale * lw::kLog2e;
  stage_row(kv, qkv + (img + C + h * D) * N, D, N, j, live);
  stage_row(vv, qkv + (img + 2 * C + h * D) * N, D, N, j, live);
  zero_row(dk, D);
  zero_row(dv, D);

  for (int i0 = 0; i0 < N; i0 += kTile) {
    float s[kTile], dp[kTile];
#pragma unroll
    for (int ii = 0; ii < kTile; ++ii) s[ii] = dp[ii] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();  // the previous chunks and row statistics are consumed
      load_tile<kChunkPart>(qs, qp + static_cast<size_t>(c) * kChunk * N, kChunk, N, i0);
      load_tile<kChunkPart>(gs, gp + static_cast<size_t>(c) * kChunk * N, kChunk, N, i0);
      if (c == 0 && threadIdx.x < kTile) {
        const int i = i0 + threadIdx.x;
        lse_t[threadIdx.x] = i < N ? lse[rows + i] : INFINITY;  // a query past N: p = 0
        delta_t[threadIdx.x] = i < N ? delta[rows + i] : 0.f;
      }
      __syncthreads();
      chunk_dots(s, kv, c, qs);
      chunk_dots(dp, vv, c, gs);
    }
#pragma unroll
    for (int ii = 0; ii < kTile; ++ii) {
      const float p = exp2f(row_sum(s[ii], 32) * sl2 - lse_t[ii]);
      s[ii] = operand<T>(p * (row_sum(dp[ii], 32) - delta_t[ii]) * scale);  // ds
      dp[ii] = operand<T>(p);
    }
    // the last chunks of q and d(out) are still staged; the others are staged again
    for (int c = chunks - 1; c >= 0; --c) {
      if (c != chunks - 1) {
        __syncthreads();
        load_tile<kChunkPart>(qs, qp + static_cast<size_t>(c) * kChunk * N, kChunk, N, i0);
        load_tile<kChunkPart>(gs, gp + static_cast<size_t>(c) * kChunk * N, kChunk, N, i0);
        __syncthreads();
      }
      chunk_accumulate(dk, c, 1.f, s, qs);
      chunk_accumulate(dv, c, 1.f, dp, gs);
    }
  }
  if (!live) return;
  write_row(dqkv + (img + C + h * D) * N, dk, D, N, j);
  write_row(dqkv + (img + 2 * C + h * D) * N, dv, D, N, j);
}

// ---- host side ------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline dim3 grid_of(int B, int C, int N, int D, int part) {
  const int rows = kThreads / (D / part);
  return dim3((N + rows - 1) / rows, C / D, B);
}

inline dim3 chunked_grid(int B, int C, int N, int D) {
  return dim3((N + kRows - 1) / kRows, C / D, B);
}

// dynamic shared bytes of the chunked kernels: the staged tiles and the rows' vectors
inline size_t chunked_forward_smem(int D) {
  return (chunk_tile_floats() + static_cast<size_t>(kRows) * 2 * D) * sizeof(float);
}
inline size_t chunked_rows_smem(int D) {
  return (2 * chunk_tile_floats() + static_cast<size_t>(kRows) * 3 * D) * sizeof(float);
}
inline size_t chunked_cols_smem(int D) {
  return (2 * chunk_tile_floats() + 2 * kTile + static_cast<size_t>(kRows) * 4 * D) *
         sizeof(float);
}

template <typename T>
cudaError_t forward(const void* qkv, void* out, float* lse, int B, int C, int N, int D,
                    float scale, cudaStream_t stream) {
  if (chunked(D)) {
    const size_t smem = chunked_forward_smem(D);
    if (cudaError_t err = allow_smem(attention_chunked_kernel<T>, smem)) return err;
    attention_chunked_kernel<T><<<chunked_grid(B, C, N, D), kThreads, smem, stream>>>(
        static_cast<const T*>(qkv), static_cast<T*>(out), lse, C, N, D, scale * lw::kLog2e);
    return cudaGetLastError();
  }
  const size_t smem = 2 * tile_floats<kForwardPart>(D) * sizeof(float);
  if (cudaError_t err = allow_smem(attention_kernel<T>, smem)) return err;
  attention_kernel<T><<<grid_of(B, C, N, D, kForwardPart), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), lse, C, N, D, scale * lw::kLog2e);
  return cudaGetLastError();
}

// lse and delta (B, H, N) f32: lse as the forward wrote it, or, when
// `take_lse`, scratch into which pass 1 writes the row log-sum-exp it takes
// itself (no forward wrote one: K7nb); delta scratch
template <typename T>
cudaError_t backward(const void* qkv, float* lse, const void* dout, void* dqkv, float* delta,
                     int B, int C, int N, int D, float scale, bool take_lse,
                     cudaStream_t stream) {
  const T* x = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* dx = static_cast<T*>(dqkv);
  if (chunked(D)) {
    const size_t rows_smem = chunked_rows_smem(D), cols_smem = chunked_cols_smem(D);
    if (cudaError_t err = allow_smem(attention_bwd_rows_chunked_kernel<T>, rows_smem)) return err;
    if (cudaError_t err = allow_smem(attention_bwd_cols_chunked_kernel<T>, cols_smem)) return err;
    const dim3 grid = chunked_grid(B, C, N, D);
    attention_bwd_rows_chunked_kernel<T><<<grid, kThreads, rows_smem, stream>>>(
        x, g, lse, delta, dx, C, N, D, scale, take_lse);
    if (cudaError_t err = cudaGetLastError()) return err;
    attention_bwd_cols_chunked_kernel<T><<<grid, kThreads, cols_smem, stream>>>(
        x, g, lse, delta, dx, C, N, D, scale);
    return cudaGetLastError();
  }
  constexpr int P = kBackwardPart;
  const size_t rows_smem = 2 * tile_floats<P>(D) * sizeof(float);
  const size_t cols_smem = rows_smem + 2 * kTile * sizeof(float);
  if (cudaError_t err = allow_smem(attention_bwd_rows_kernel<T, P>, rows_smem)) return err;
  if (cudaError_t err = allow_smem(attention_bwd_cols_kernel<T, P>, cols_smem)) return err;
  const dim3 grid = grid_of(B, C, N, D, P);
  attention_bwd_rows_kernel<T, P><<<grid, kThreads, rows_smem, stream>>>(x, g, lse, delta, dx,
                                                                         C, N, D, scale, take_lse);
  if (cudaError_t err = cudaGetLastError()) return err;
  // pass 2 reads what pass 1 stored: same stream, in order
  attention_bwd_cols_kernel<T, P><<<grid, kThreads, cols_smem, stream>>>(x, g, lse, delta, dx,
                                                                         C, N, D, scale);
  return cudaGetLastError();
}

// attrs[0..2]: registers, local bytes, static shared bytes of the forward at head_dim D
template <typename T>
int forward_attributes(int D, int* attrs) {
  const void* fn = chunked(D) ? reinterpret_cast<const void*>(attention_chunked_kernel<T>)
                              : reinterpret_cast<const void*>(attention_kernel<T>);
  return lw::kernel_attributes(fn, attrs);
}

// attrs[0..2] and [3..5]: those of backward passes 1 and 2 at head_dim D
template <typename T>
int backward_attributes(int D, int* attrs) {
  const void* rows =
      chunked(D) ? reinterpret_cast<const void*>(attention_bwd_rows_chunked_kernel<T>)
                 : reinterpret_cast<const void*>(attention_bwd_rows_kernel<T, kBackwardPart>);
  const void* cols =
      chunked(D) ? reinterpret_cast<const void*>(attention_bwd_cols_chunked_kernel<T>)
                 : reinterpret_cast<const void*>(attention_bwd_cols_kernel<T, kBackwardPart>);
  if (int err = lw::kernel_attributes(rows, attrs)) return err;
  return lw::kernel_attributes(cols, attrs + 3);
}

}  // namespace lw_wide
