// K6: backward of the global attention over channel-major packed qkv.
//
// Replaces lwdetr_tpu/ops/flash_attention.py::_attn_cm_bwd_kernel (launched
// from _attn_cm_bwd_pallas_call). Given qkv (B, 3C, N), the forward's output
// out (B, C, N), its per-row log-sum-exp lse (B, H, N) and d(out) (B, C, N),
// it computes per image b and head h, with p = softmax(scale q^T k):
//   delta_i = sum_d d(out)[d, i] out[d, i]        (= sum_j p_ij dp_ij)
//   dp_ij   = sum_d d(out)[d, i] v[d, j]
//   ds_ij   = p_ij (dp_ij - delta_i) scale
//   dq[:, i] = sum_j ds_ij k[:, j]
//   dk[:, j] = sum_i ds_ij q[:, i]
//   dv[:, j] = sum_i p_ij d(out)[:, i]
// and writes dq, dk, dv straight into the three channel thirds of d(qkv)
// (B, 3C, N).
//
// The TPU kernel walks the query blocks in order on one core, keeps dk and dv
// of the whole key panel in VMEM scratch across grid steps, and takes each
// row's max and sum again from the whole-N score tile. Blocks on this card run
// in no order and share nothing, so the sums over queries and over keys are
// two passes, each a loop inside a block, and neither needs an atomic:
//   pass 1, one block per (query tile, head, image): loops over key tiles,
//     gives dq and stores delta (B, H, N);
//   pass 2, one block per (key tile, head, image): loops over query tiles,
//     gives dk and dv.
// The softmax is not taken again: p_ij = exp2(s_ij - lse_i) with the scores
// in log2 units, from the log-sum-exp the forward kernel saved.
//
// What bounds it on an H100: per (query, key) pair pass 1 does 3D and pass 2
// 4D multiply-adds and each one exponential on the CUDA cores in f32, 7D
// multiply-adds in all against 2D in the forward, so it is bound by
// arithmetic. Design: registers are what runs out (three D-long vectors a
// row in pass 1, four in pass 2), so a row (a query in pass 1, a key in pass
// 2) is shared by S = D / 16 neighbouring lanes of a warp, each owning the 16
// channels d = lane + S c: every head_dim runs with the register budget of
// head_dim 16. The lanes of a row add their partial scores and dp with
// shuffles and then repeat the cheap p and ds. Tiles are staged in shared
// memory as (D, tile) rows (coalesced global reads over the token index) and
// read back as float4 along the tile, one shared load feeding four
// multiply-adds; rows are padded by 4 floats so that the S rows a warp reads
// at once fall in different banks. Accumulation is f32, rounded once on the
// store. Ragged tails: a key past N gives p = 0, a query past N has
// lse = +inf, so p = 0 and it adds nothing to dk or dv.
#include "common.cuh"

namespace {

constexpr int DT = 16;   // channels per thread
constexpr int ROWS = 64; // rows (queries in pass 1, keys in pass 2) per block
constexpr int BK = 32;   // pass 1: keys per shared-memory tile
constexpr int BQT = 32;  // pass 2: queries per shared-memory tile
constexpr int CH = 4;    // columns of a tile handled together (one float4)
constexpr int PAD = 4;   // floats of padding per shared-memory row

// sums x over the S lanes of a row (neighbouring lanes; S is 1, 2 or 4)
template <int S>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 1; m < S; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(ROWS * (D / DT))
attention_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ out,
                        const float* __restrict__ lse, const T* __restrict__ dout,
                        T* __restrict__ dqkv, float* __restrict__ delta, int C, int N,
                        float scale) {
  constexpr int S = D / DT;
  __shared__ __align__(16) float ks[D][BK + PAD];
  __shared__ __align__(16) float vs[D][BK + PAD];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const T* qp = qkv + (img + h * D) * N;
  const T* kp = qkv + (img + C + h * D) * N;
  const T* vp = qkv + (img + 2 * C + h * D) * N;
  const size_t head = (static_cast<size_t>(b) * C + h * D) * N;
  const size_t row = (static_cast<size_t>(b) * gridDim.y + h) * N;
  const int part = threadIdx.x % S;  // this thread's channels: part + S c
  const int i = blockIdx.x * ROWS + threadIdx.x / S;
  const bool live = i < N;
  const float scale_log2 = scale * lw::kLog2e;

  // a thread past N carries zeros: its p is 1, its ds 0, and it stores nothing
  float q[DT], g[DT], dq[DT];
  float dl = 0.f;
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    const size_t at = static_cast<size_t>(part + S * c) * N + i;
    q[c] = live ? lw::to_f32(qp[at]) * scale_log2 : 0.f;
    g[c] = live ? lw::to_f32(dout[head + at]) : 0.f;
    dl = live ? fmaf(g[c], lw::to_f32(out[head + at]), dl) : 0.f;
    dq[c] = 0.f;
  }
  dl = row_sum<S>(dl);
  const float l2 = live ? lse[row + i] : 0.f;
  if (live && part == 0) delta[row + i] = dl;

  for (int j0 = 0; j0 < N; j0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < D * BK; idx += ROWS * S) {
      const int d = idx / BK;
      const int j = idx - d * BK;
      const int n = j0 + j;
      const bool ok = n < N;
      ks[d][j] = ok ? lw::to_f32(kp[static_cast<size_t>(d) * N + n]) : 0.f;
      vs[d][j] = ok ? lw::to_f32(vp[static_cast<size_t>(d) * N + n]) : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int jj = 0; jj < BK; jj += CH) {
      float s[CH] = {0.f, 0.f, 0.f, 0.f};
      float dp[CH] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[part + S * c][jj]);
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[part + S * c][jj]);
        s[0] = fmaf(q[c], k4.x, s[0]);
        s[1] = fmaf(q[c], k4.y, s[1]);
        s[2] = fmaf(q[c], k4.z, s[2]);
        s[3] = fmaf(q[c], k4.w, s[3]);
        dp[0] = fmaf(g[c], v4.x, dp[0]);
        dp[1] = fmaf(g[c], v4.y, dp[1]);
        dp[2] = fmaf(g[c], v4.z, dp[2]);
        dp[3] = fmaf(g[c], v4.w, dp[3]);
      }
      float ds[CH];
#pragma unroll
      for (int x = 0; x < CH; ++x) {
        const float sx = row_sum<S>(s[x]);
        const float dpx = row_sum<S>(dp[x]);
        const float p = (j0 + jj + x < N) ? exp2f(sx - l2) : 0.f;  // ragged key tail
        ds[x] = p * (dpx - dl) * scale;
      }
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[part + S * c][jj]);
        float a = dq[c];
        a = fmaf(ds[0], k4.x, a);
        a = fmaf(ds[1], k4.y, a);
        a = fmaf(ds[2], k4.z, a);
        a = fmaf(ds[3], k4.w, a);
        dq[c] = a;
      }
    }
  }
  if (!live) return;
  T* o = dqkv + (img + h * D + part) * N + i;
#pragma unroll
  for (int c = 0; c < DT; ++c) o[static_cast<size_t>(S * c) * N] = lw::from_f32<T>(dq[c]);
}

template <typename T, int D>
__global__ void __launch_bounds__(ROWS * (D / DT))
attention_bwd_dkdv_kernel(const T* __restrict__ qkv, const float* __restrict__ lse,
                          const float* __restrict__ delta, const T* __restrict__ dout,
                          T* __restrict__ dqkv, int C, int N, float scale) {
  constexpr int S = D / DT;
  __shared__ __align__(16) float qs[D][BQT + PAD];  // one query tile: raw q and d(out)
  __shared__ __align__(16) float gs[D][BQT + PAD];
  __shared__ float ls[BQT];
  __shared__ float dls[BQT];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const T* qp = qkv + (img + h * D) * N;
  const T* kp = qkv + (img + C + h * D) * N;
  const T* vp = qkv + (img + 2 * C + h * D) * N;
  const T* gp = dout + (static_cast<size_t>(b) * C + h * D) * N;
  const size_t row = (static_cast<size_t>(b) * gridDim.y + h) * N;
  const int t = threadIdx.x;
  const int part = t % S;  // this thread's channels: part + S c
  const int j = blockIdx.x * ROWS + t / S;
  const bool live = j < N;
  const float scale_log2 = scale * lw::kLog2e;

  float k[DT], v[DT], dk[DT], dv[DT];
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    const size_t at = static_cast<size_t>(part + S * c) * N + j;
    k[c] = live ? lw::to_f32(kp[at]) : 0.f;
    v[c] = live ? lw::to_f32(vp[at]) : 0.f;
    dk[c] = 0.f;
    dv[c] = 0.f;
  }

  for (int i0 = 0; i0 < N; i0 += BQT) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = t; idx < D * BQT; idx += ROWS * S) {
      const int d = idx / BQT;
      const int ii = idx - d * BQT;
      const int n = i0 + ii;
      const bool ok = n < N;
      qs[d][ii] = ok ? lw::to_f32(qp[static_cast<size_t>(d) * N + n]) : 0.f;
      gs[d][ii] = ok ? lw::to_f32(gp[static_cast<size_t>(d) * N + n]) : 0.f;
    }
    if (t < BQT) {
      const int n = i0 + t;
      ls[t] = n < N ? lse[row + n] : INFINITY;  // a query past N: p = exp2(-inf) = 0
      dls[t] = n < N ? delta[row + n] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int ii = 0; ii < BQT; ii += CH) {
      float s[CH] = {0.f, 0.f, 0.f, 0.f};
      float dp[CH] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        const float4 q4 = *reinterpret_cast<const float4*>(&qs[part + S * c][ii]);
        const float4 g4 = *reinterpret_cast<const float4*>(&gs[part + S * c][ii]);
        s[0] = fmaf(k[c], q4.x, s[0]);
        s[1] = fmaf(k[c], q4.y, s[1]);
        s[2] = fmaf(k[c], q4.z, s[2]);
        s[3] = fmaf(k[c], q4.w, s[3]);
        dp[0] = fmaf(v[c], g4.x, dp[0]);
        dp[1] = fmaf(v[c], g4.y, dp[1]);
        dp[2] = fmaf(v[c], g4.z, dp[2]);
        dp[3] = fmaf(v[c], g4.w, dp[3]);
      }
      float p[CH], ds[CH];
#pragma unroll
      for (int x = 0; x < CH; ++x) {
        const float sx = row_sum<S>(s[x]);
        const float dpx = row_sum<S>(dp[x]);
        p[x] = exp2f(sx * scale_log2 - ls[ii + x]);
        ds[x] = p[x] * (dpx - dls[ii + x]) * scale;
      }
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        const float4 q4 = *reinterpret_cast<const float4*>(&qs[part + S * c][ii]);
        const float4 g4 = *reinterpret_cast<const float4*>(&gs[part + S * c][ii]);
        float a = dk[c];
        a = fmaf(ds[0], q4.x, a);
        a = fmaf(ds[1], q4.y, a);
        a = fmaf(ds[2], q4.z, a);
        a = fmaf(ds[3], q4.w, a);
        dk[c] = a;
        float e = dv[c];
        e = fmaf(p[0], g4.x, e);
        e = fmaf(p[1], g4.y, e);
        e = fmaf(p[2], g4.z, e);
        e = fmaf(p[3], g4.w, e);
        dv[c] = e;
      }
    }
  }
  if (!live) return;
  T* dkp = dqkv + (img + C + h * D + part) * N + j;
  T* dvp = dqkv + (img + 2 * C + h * D + part) * N + j;
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    dkp[static_cast<size_t>(S * c) * N] = lw::from_f32<T>(dk[c]);
    dvp[static_cast<size_t>(S * c) * N] = lw::from_f32<T>(dv[c]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const void* out, const float* lse, const void* dout,
                   void* dqkv, float* delta, int B, int C, int N, float scale,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* dx = static_cast<T*>(dqkv);
  const dim3 grid((N + ROWS - 1) / ROWS, C / D, B);
  const int threads = ROWS * (D / DT);
  attention_bwd_dq_kernel<T, D><<<grid, threads, 0, stream>>>(
      x, static_cast<const T*>(out), lse, g, dx, delta, C, N, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the second pass reads the delta the first one stored: same stream, in order
  attention_bwd_dkdv_kernel<T, D><<<grid, threads, 0, stream>>>(x, lse, delta, g, dx, C, N,
                                                                scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* qkv, const void* out, const float* lse,
                       const void* dout, void* dqkv, float* delta, int B, int C, int N,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(qkv, out, lse, dout, dqkv, delta, B, C, N, scale, stream);
    case 32: return launch<T, 32>(qkv, out, lse, dout, dqkv, delta, B, C, N, scale, stream);
    case 64: return launch<T, 64>(qkv, out, lse, dout, dqkv, delta, B, C, N, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv and dqkv (B, 3C, N), out and dout (B, C, N) in `dtype`; lse (B, H, N) f32
// as the forward kernel wrote it; delta (B, H, N) f32 scratch. All contiguous.
extern "C" int lw_flash_attention_cm_bwd(const void* qkv, const void* out, const void* lse,
                                         const void* dout, void* dqkv, void* delta, int B,
                                         int C, int N, int num_heads, float scale, int dtype,
                                         void* stream) {
  if (B < 1 || B > 65535 || N < 1 || num_heads < 1 || C % num_heads != 0)
    return cudaErrorInvalidValue;
  const int D = C / num_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  if (dtype == lw::kFloat32)
    return dispatch_d<float>(D, qkv, out, lp, dout, dqkv, dp, B, C, N, scale, st);
  if (dtype == lw::kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, qkv, out, lp, dout, dqkv, dp, B, C, N, scale, st);
  return cudaErrorInvalidValue;
}
