// K6: backward of the global attention over channel-major packed qkv, on the
// tensor cores.
//
// Replaces lwdetr_tpu/ops/flash_attention.py::_attn_cm_bwd_kernel (launched
// from _attn_cm_bwd_pallas_call). Given qkv (B, 3C, N), the forward's per-row
// log-sum-exp lse (B, H, N) (K2 writes it, in log2 units) and d(out) (B, C, N),
// it computes per image b and head h, with p = softmax(scale q^T k):
//   dp_ij   = sum_d d(out)[d, i] v[d, j]
//   row_i   = sum_j p_ij dp_ij
//   ds_ij   = p_ij (dp_ij - row_i) scale
//   dq[:, i] = sum_j ds_ij k[:, j]
//   dk[:, j] = sum_i ds_ij q[:, i]
//   dv[:, j] = sum_i p_ij d(out)[:, i]
// and writes dq, dk, dv straight into the three channel thirds of d(qkv)
// (B, 3C, N).
//
// The TPU kernel walks the query blocks in order on one core and keeps dk and
// dv of the whole key panel in VMEM scratch across grid steps. Blocks on this
// card run in no order and share nothing, so the sums over keys and over
// queries are two passes, each a loop inside a block, with no atomics
// (deterministic):
//   pass 1, a block per (64 queries, head, image), a warp per 16 queries:
//     walks the key tiles twice. The first sweep forms S = Q^T K and
//     dP = dO^T V and sums row_i = sum_j p_ij dp_ij from the unrounded f32 p,
//     as the JAX kernel does, and stores it (`delta`, (B, H, N)) for pass 2;
//     the second forms S and dP again, dS, and dQ += dS K^T.
//   pass 2, a block per (64 keys, head, image), a warp per 16 keys: walks the
//     query tiles once: S^T = K^T Q, dP^T = V^T dO, P^T, dS^T,
//     dV += P^T dO^T and dK += dS^T Q^T.
// The softmax is not taken again: p_ij = exp2(s_ij scale log2 e - lse_i), one
// FFMA and one MUFU.EX2 a score.
//
// The row term. row_i could also be sum_d d(out)[d, i] out[d, i] from the
// forward's output, one product fewer. In f32 the two agree to rounding, but
// the bf16 output is rounded: on the CPU (tests/test_torch_port_bwd_bf16.py)
// that form moves 15-17% of the bf16 gradient's elements off the JAX
// package's bits, against 0.01-0.06% for sum_j p dp. So pass 1 sweeps the
// keys twice: 5 (query, key, D) products in pass 1 and 4 in pass 2, 9 where
// the forward does 2.
//
// What bounds it on an H100: per (query, key) pair 9 D multiply-adds (18 D
// flops) on the tensor cores and two exponentials (one a pass) on the
// special-function units, against one read of qkv, d(out) and lse and one
// write of d(qkv): at D <= 64 the exponentials and the per-score f32 work
// around them (the FFMA, the mask of the ragged tile, ds) weigh more than
// the products. Design: everything per score stays in registers. Tiles of q,
// k, v and d(out) are [d][token] rows of the channel-major arrays, staged
// through a double-buffered cp.async ring (16-byte, 8-byte or narrower
// copies, picked on the host from N and the pointers and passed in: one
// kernel a case, `lw::load_rows_vec`) and read as fragments
// (attention_bwd.cuh): S and dP come out as f32 C fragments and P and dS go
// from them to the next product's A operand in registers, never through
// shared memory. The results leave from the accumulators.
//
// bf16: mma.sync.m16n8k16, bf16 operands, f32 accumulators. Packing P and dS
// to bf16 for the A operand rounds them to nearest even, which is the JAX
// kernel's `ds.astype(q.dtype)` and `p.astype(do.dtype)` (the plain version
// rounds alike). f32 (the train step's dtype): 3xTF32 on
// mma.sync.m16n8k8.tf32, three products for one, which keeps the f32
// tolerance that one TF32 product would not.
//
// Ragged tails: a key past N gets p = 0 (only the last key tile is masked);
// a query past N has lse = +inf, so p = 0 and it adds nothing to dk or dv.
//
// Head dims that are multiples of 64 from 128 up (the decoder's wider heads)
// take the wide case, attention_wide.cuh: its own passes, on the tensor cores.
#include "attention_wide.cuh"
#include "common.cuh"
#include "attention_bwd.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // rows of a block: queries (pass 1), keys (pass 2)
constexpr int kTile = 64;           // columns of a streamed tile: keys (pass 1), queries (pass 2)
constexpr int kStride = lw::tile_stride(kTile);
constexpr int kThreads = 32 * kWarps;
// Blocks an SM that ptxas must leave registers for (`__launch_bounds__`), the
// most that spills nothing, per case: bf16 4 at D = 16 (<= 128 registers), 3 at
// D = 32 (<= 170), 2 at D = 64; f32 2: on the H100 the bf16 cases ran 6-7%
// faster than with 2 for all. Without a minimum ptxas aims lower by itself and
// spilled 12-16 bytes in five bf16 cases.
template <typename T, int D>
constexpr int kMinBlocks = sizeof(T) == 4 || D == 64 ? 2 : D == 32 ? 3 : 4;

// six (D, tile) tiles (pass 1: q, d(out), two stages of k and v; pass 2: k,
// v, two stages of q and d(out)) and, in pass 2, two stages of lse and delta
template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(T) * 6 * D * kStride + sizeof(float) * 4 * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, D>)
attention_bwd_dq_kernel(const T* __restrict__ qkv, const float* __restrict__ lse,
                        const T* __restrict__ dout, T* __restrict__ dqkv,
                        float* __restrict__ delta, int C, int N, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const qs = reinterpret_cast<T*>(smem);
  T* const gs = qs + D * kStride;
  T* const ks = gs + D * kStride;      // two stages
  T* const vs = ks + 2 * D * kStride;  // two stages
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = blockIdx.x * kRows;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const T* qp = qkv + (img + h * D) * N;
  const T* kp = qkv + (img + C + h * D) * N;
  const T* vp = qkv + (img + 2 * C + h * D) * N;
  const T* gp = dout + (static_cast<size_t>(b) * C + h * D) * N;
  const size_t row = (static_cast<size_t>(b) * gridDim.y + h) * N;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = 16 * warp;

  lw::load_rows_vec<D>(vec, qs, kStride, qp, N, i0, kRows, tid, kThreads);
  lw::load_rows_vec<D>(vec, gs, kStride, gp, N, i0, kRows, tid, kThreads);
  lw::load_rows_vec<D>(vec, ks, kStride, kp, N, 0, kTile, tid, kThreads);
  lw::load_rows_vec<D>(vec, vs, kStride, vp, N, 0, kTile, tid, kThreads);
  lw::cp_async_commit();

  const float sl2 = scale * lw::kLog2e;
  const int i_lo = i0 + m0 + g, i_hi = i_lo + 8;
  const float l_lo = i_lo < N ? lse[row + i_lo] : INFINITY;  // past N: p = 0
  const float l_hi = i_hi < N ? lse[row + i_hi] : INFINITY;
  float r_lo = 0.f, r_hi = 0.f;  // row_i, this lane's part, then the whole
  float dq[D / 8][4];
  lw::zero(dq);

  const int n_tiles = (N + kTile - 1) / kTile;
  for (int it = 0; it < 2 * n_tiles; ++it) {  // sweep 1: the row term; sweep 2: dQ
    const int jt = it < n_tiles ? it : it - n_tiles;
    const int st = it & 1;
    if (it + 1 < 2 * n_tiles) {  // the next tile into the other stage, then wait for this one
      const int next = (jt + 1) % n_tiles;
      lw::load_rows_vec<D>(vec, ks + (st ^ 1) * D * kStride, kStride, kp, N, next * kTile, kTile,
                             tid, kThreads);
      lw::load_rows_vec<D>(vec, vs + (st ^ 1) * D * kStride, kStride, vp, N, next * kTile, kTile,
                             tid, kThreads);
      lw::cp_async_commit();
      lw::cp_async_wait<1>();
    } else {
      lw::cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + st * D * kStride;
    const T* vt = vs + st * D * kStride;

    float s[kTile / 8][4], dp[kTile / 8][4];
    lw::zero(s);
    lw::zero(dp);
    lw::mma_tn<D, kTile / 8>(s, qs, kStride, kt, kStride, m0, 0, lane);
    lw::mma_tn<D, kTile / 8>(dp, gs, kStride, vt, kStride, m0, 0, lane);
    const bool ragged = (jt + 1) * kTile > N;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = lw::fast_exp2(fmaf(s[n][e], sl2, e < 2 ? -l_lo : -l_hi));
        if (ragged && jt * kTile + 8 * n + 2 * t + (e & 1) >= N) p = 0.f;
        s[n][e] = p;
      }
    }
    if (it < n_tiles) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        r_lo = fmaf(s[n][0], dp[n][0], fmaf(s[n][1], dp[n][1], r_lo));
        r_hi = fmaf(s[n][2], dp[n][2], fmaf(s[n][3], dp[n][3], r_hi));
      }
      if (it == n_tiles - 1) {
        r_lo = lw::quad_sum(r_lo);
        r_hi = lw::quad_sum(r_hi);
        if (t == 0) {
          if (i_lo < N) delta[row + i_lo] = r_lo;
          if (i_hi < N) delta[row + i_hi] = r_hi;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] * (dp[n][e] - (e < 2 ? r_lo : r_hi)) * scale;
      }
      lw::mma_rt<kTile / 8, D / 8>(dq, s, kt, kStride, 0, 0, lane);  // dQ += dS K^T
    }
    __syncthreads();  // stage st is consumed: the next iteration may refill it
  }

  T* o = dqkv + (img + h * D) * N;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? i_lo : i_hi;
      if (i < N) o[static_cast<size_t>(8 * n + 2 * t + (e & 1)) * N + i] = lw::from_f32<T>(dq[n][e]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, D>)
attention_bwd_dkdv_kernel(const T* __restrict__ qkv, const float* __restrict__ lse,
                          const float* __restrict__ delta, const T* __restrict__ dout,
                          T* __restrict__ dqkv, int C, int N, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ks = reinterpret_cast<T*>(smem);
  T* const vs = ks + D * kStride;
  T* const qs = vs + D * kStride;      // two stages
  T* const gs = qs + 2 * D * kStride;  // two stages
  float* const ls = reinterpret_cast<float*>(gs + 2 * D * kStride);  // two stages of kTile
  float* const dls = ls + 2 * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * kRows;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const T* qp = qkv + (img + h * D) * N;
  const T* kp = qkv + (img + C + h * D) * N;
  const T* vp = qkv + (img + 2 * C + h * D) * N;
  const T* gp = dout + (static_cast<size_t>(b) * C + h * D) * N;
  const size_t row = (static_cast<size_t>(b) * gridDim.y + h) * N;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = 16 * warp;

  lw::load_rows_vec<D>(vec, ks, kStride, kp, N, j0, kRows, tid, kThreads);
  lw::load_rows_vec<D>(vec, vs, kStride, vp, N, j0, kRows, tid, kThreads);
  lw::load_rows_vec<D>(vec, qs, kStride, qp, N, 0, kTile, tid, kThreads);
  lw::load_rows_vec<D>(vec, gs, kStride, gp, N, 0, kTile, tid, kThreads);
  lw::cp_async_commit();
  if (tid < kTile) {  // a query past N: p = exp2(-inf) = 0, and no row term
    ls[tid] = tid < N ? lse[row + tid] : INFINITY;
    dls[tid] = tid < N ? delta[row + tid] : 0.f;
  }

  const float sl2 = scale * lw::kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
  lw::zero(dk);
  lw::zero(dv);
  const int n_tiles = (N + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      const int c0 = (it + 1) * kTile;
      lw::load_rows_vec<D>(vec, qs + (st ^ 1) * D * kStride, kStride, qp, N, c0, kTile, tid,
                             kThreads);
      lw::load_rows_vec<D>(vec, gs + (st ^ 1) * D * kStride, kStride, gp, N, c0, kTile, tid,
                             kThreads);
      lw::cp_async_commit();
      if (tid < kTile) {
        const int i = c0 + tid;
        ls[(st ^ 1) * kTile + tid] = i < N ? lse[row + i] : INFINITY;
        dls[(st ^ 1) * kTile + tid] = i < N ? delta[row + i] : 0.f;
      }
      lw::cp_async_wait<1>();
    } else {
      lw::cp_async_wait<0>();
    }
    __syncthreads();
    const T* qt = qs + st * D * kStride;
    const T* gt = gs + st * D * kStride;
    const float* lt = ls + st * kTile;
    const float* dlt = dls + st * kTile;

    float s[kTile / 8][4], dp[kTile / 8][4];  // (16 keys) x (64 queries)
    lw::zero(s);
    lw::zero(dp);
    lw::mma_tn<D, kTile / 8>(s, ks, kStride, qt, kStride, m0, 0, lane);
    lw::mma_tn<D, kTile / 8>(dp, vs, kStride, gt, kStride, m0, 0, lane);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * n + 2 * t + (e & 1);
        const float p = lw::fast_exp2(fmaf(s[n][e], sl2, -lt[i]));
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dlt[i]) * scale;
      }
    }
    lw::mma_rt<kTile / 8, D / 8>(dv, s, gt, kStride, 0, 0, lane);   // dV += P^T dO^T
    lw::mma_rt<kTile / 8, D / 8>(dk, dp, qt, kStride, 0, 0, lane);  // dK += dS^T Q^T
    __syncthreads();  // stage st is consumed: the next iteration may refill it
  }

  const int j_lo = j0 + m0 + g, j_hi = j_lo + 8;
  T* dkp = dqkv + (img + C + h * D) * N;
  T* dvp = dqkv + (img + 2 * C + h * D) * N;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = e < 2 ? j_lo : j_hi;
      const size_t at = static_cast<size_t>(8 * n + 2 * t + (e & 1)) * N + j;
      if (j < N) {
        dkp[at] = lw::from_f32<T>(dk[n][e]);
        dvp[at] = lw::from_f32<T>(dv[n][e]);
      }
    }
  }
}

// ---- host side ------------------------------------------------------------

// the narrower of the copy widths (elements) that qkv and d(out) allow
template <typename T>
int vec_of(const void* qkv, const void* dout, int N) {
  const int a = lw::copy_vec(qkv, N, sizeof(T)), b = lw::copy_vec(dout, N, sizeof(T));
  return a < b ? a : b;
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const float* lse, const void* dout, void* dqkv, float* delta,
                   int B, int C, int N, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const T* x = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* dx = static_cast<T*>(dqkv);
  const int vec = vec_of<T>(qkv, dout, N);
  const dim3 grid((N + kRows - 1) / kRows, C / D, B);
  attention_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(x, lse, g, dx, delta, C, N,
                                                                  scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the second pass reads the delta the first one stored: same stream, in order
  attention_bwd_dkdv_kernel<T, D><<<grid, kThreads, smem, stream>>>(x, lse, delta, g, dx, C, N,
                                                                    scale, vec);
  return cudaGetLastError();
}

template <typename T, int D>
int attributes(int* attrs) {
  if (int err = lw::kernel_attributes(reinterpret_cast<const void*>(attention_bwd_dq_kernel<T, D>),
                                      attrs))
    return err;
  return lw::kernel_attributes(reinterpret_cast<const void*>(attention_bwd_dkdv_kernel<T, D>),
                               attrs + 3);
}

int check(int B, int C, int N, int num_heads, int dtype) {
  if (B < 1 || B > 65535 || N < 1 || num_heads < 1 || C % num_heads != 0 ||
      (dtype != lw::kFloat32 && dtype != lw::kBFloat16))
    return cudaErrorInvalidValue;
  const int D = C / num_heads;
  return D == 16 || D == 32 || D == 64 || lw_wide::takes(D) ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
int dispatch(int D, const void* qkv, const float* lse, const void* dout, void* dqkv,
             float* delta, int B, int C, int N, float scale, cudaStream_t st) {
  if (lw_wide::takes(D))
    return lw_wide::backward<T>(qkv, const_cast<float*>(lse), dout, dqkv, delta, B, C, N, D,
                                scale, false, st);
  switch (D) {
    case 16: return launch<T, 16>(qkv, lse, dout, dqkv, delta, B, C, N, scale, st);
    case 32: return launch<T, 32>(qkv, lse, dout, dqkv, delta, B, C, N, scale, st);
    default: return launch<T, 64>(qkv, lse, dout, dqkv, delta, B, C, N, scale, st);
  }
}

template <typename T>
int dispatch_attributes(int D, int* attrs) {
  if (lw_wide::takes(D)) return lw_wide::backward_attributes<T>(D, attrs);
  switch (D) {
    case 16: return attributes<T, 16>(attrs);
    case 32: return attributes<T, 32>(attrs);
    default: return attributes<T, 64>(attrs);
  }
}

}  // namespace

// qkv and dqkv (B, 3C, N), dout (B, C, N) in `dtype`; lse (B, H, N) f32 as the
// forward kernel wrote it; delta (B, H, N) f32 scratch. All contiguous.
extern "C" int lw_flash_attention_cm_bwd(const void* qkv, const void* lse, const void* dout,
                                         void* dqkv, void* delta, int B, int C, int N,
                                         int num_heads, float scale, int dtype, void* stream) {
  if (int err = check(B, C, N, num_heads, dtype)) return err;
  const int D = C / num_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  if (dtype == lw::kFloat32)
    return dispatch<float>(D, qkv, lp, dout, dqkv, dp, B, C, N, scale, st);
  return dispatch<lw::bf16>(D, qkv, lp, dout, dqkv, dp, B, C, N, scale, st);
}

// attrs[0..2] and [3..5]: registers, local (spill) bytes and static shared
// bytes a thread / block of pass 1 and pass 2 that lw_flash_attention_cm_bwd
// would launch for these arguments.
extern "C" int lw_flash_attention_cm_bwd_attributes(int B, int C, int N, int num_heads,
                                                    int dtype, int* attrs) {
  if (int err = check(B, C, N, num_heads, dtype)) return err;
  const int D = C / num_heads;
  if (dtype == lw::kFloat32) return dispatch_attributes<float>(D, attrs);
  return dispatch_attributes<lw::bf16>(D, attrs);
}
