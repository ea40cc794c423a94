// The wide case of the attention kernels: head_dim 128 or 256.
//
// The JAX package computes the decoder's head_dim from the CLI's
// --hidden_dim / --sa_nheads (e.g. 256 / 2 = 128); the ViT's heads never
// exceed 64. K2 (flash_attention.cu), K9 (window_attention.cu), K6
// (flash_attention_bwd.cu) and the no-bias case of K7 (window_attention_bwd.cu,
// "K7nb") launch these kernels at those head dims; `attention_cm` zero-pads a
// head_dim between two cases up to the next one. They compute what the
// narrow cases compute, in f32 and bf16, with the bf16 roundings of the JAX
// kernels: p = exp2(s - max) rounded to bf16 before PV and the f32 row sum of
// the unrounded p after it (forward); ds and p rounded to bf16 before the
// three products of the backward, the row term sum_j p dp from the unrounded
// p.
//
// A simple tiling on the CUDA cores, f32 arithmetic in both dtypes. A thread
// holds P channels of one query (or key), so D / P adjacent lanes share a row
// and sum their partial dot products with xor shuffles; a block of 128
// threads takes 128 / (D / P) rows and streams tiles of 16 keys (or queries)
// of the (D, N) channel rows through shared memory, staged as f32. Each lane
// of a row reads its own P rows of the tile, offset by one float a lane so
// that the lanes' reads fall in different banks. P = 32 in the forward (q
// and the accumulator: 64 registers of data); the backward holds four such
// sets (q, d(out), dq; k, v, dk, dv), so P = 16 there (P = 32 spilled at
// D = 128: 255 registers). A wider head (more than 256 channels) is refused
// by `attention_cm`: no case here has been held against the plain version.
//   forward (K2, K9): one sweep over the keys with an online softmax, as K2's
//     f32 case; writes the row log-sum-exp in log2 units when asked (K6 reads
//     it).
//   backward pass 1, a row per query: the row log-sum-exp (read, or taken in
//     a first sweep when no forward wrote it: K7nb), row_i = sum_j p dp, then
//     dq = sum_j ds k in a last sweep; writes dq and row_i.
//   backward pass 2, a row per key: dk = sum_i ds q and dv = sum_i p d(out)
//     over the query tiles.
#pragma once

#include "common.cuh"

namespace lw_wide {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kForwardPart = 32;  // channels a thread holds in the forward
constexpr int kTile = 16;  // keys (forward, pass 1) or queries (pass 2) a shared tile

inline bool takes(int D) { return D == 128 || D == 256; }

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

template <typename T>
cudaError_t forward(const void* qkv, void* out, float* lse, int B, int C, int N, int D,
                    float scale, cudaStream_t stream) {
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
  constexpr int P = kBackwardPart;
  const size_t rows_smem = 2 * tile_floats<P>(D) * sizeof(float);
  const size_t cols_smem = rows_smem + 2 * kTile * sizeof(float);
  if (cudaError_t err = allow_smem(attention_bwd_rows_kernel<T, P>, rows_smem)) return err;
  if (cudaError_t err = allow_smem(attention_bwd_cols_kernel<T, P>, cols_smem)) return err;
  const T* x = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* dx = static_cast<T*>(dqkv);
  const dim3 grid = grid_of(B, C, N, D, P);
  attention_bwd_rows_kernel<T, P><<<grid, kThreads, rows_smem, stream>>>(x, g, lse, delta, dx,
                                                                         C, N, D, scale, take_lse);
  if (cudaError_t err = cudaGetLastError()) return err;
  // pass 2 reads what pass 1 stored: same stream, in order
  attention_bwd_cols_kernel<T, P><<<grid, kThreads, cols_smem, stream>>>(x, g, lse, delta, dx,
                                                                         C, N, D, scale);
  return cudaGetLastError();
}

// attrs[0..2]: registers, local bytes, static shared bytes of the forward
template <typename T>
int forward_attributes(int* attrs) {
  return lw::kernel_attributes(reinterpret_cast<const void*>(attention_kernel<T>), attrs);
}

// attrs[0..2] and [3..5]: those of backward passes 1 and 2
template <typename T>
int backward_attributes(int* attrs) {
  const void* rows = reinterpret_cast<const void*>(attention_bwd_rows_kernel<T, kBackwardPart>);
  const void* cols = reinterpret_cast<const void*>(attention_bwd_cols_kernel<T, kBackwardPart>);
  if (int err = lw::kernel_attributes(rows, attrs)) return err;
  return lw::kernel_attributes(cols, attrs + 3);
}

}  // namespace lw_wide
