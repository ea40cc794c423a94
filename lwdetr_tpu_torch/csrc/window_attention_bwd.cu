// K7: backward of the short-sequence (window) attention, with the fused qkv
// bias (the backward of K1) or without a bias (the backward of K9).
//
// Replaces lwdetr_tpu/ops/flash_attention.py::_attn_cm_bwd_allheads_kernel
// (launched from _attn_cm_bwd_pallas, the N <= 128 branch, which serves both
// forwards). Given qkv (B, 3C, N <= 128), the (3C,) f32 bias (or none: the
// template case kBias = false never reads one) and d(out) (B, C, N), it
// computes per window b and head h, on q, k, v = the head's rows of
// qkv + bias and p = softmax(scale q^T k):
//   dp_ij  = sum_d d(out)[d, i] v[d, j]
//   row_i  = sum_j p_ij dp_ij
//   ds_ij  = p_ij (dp_ij - row_i) scale
//   dq[:, i] = sum_j ds_ij k[:, j]
//   dk[:, j] = sum_i ds_ij q[:, i]
//   dv[:, j] = sum_i p_ij d(out)[:, i]
// and writes them into the three channel thirds of d(qkv) (B, 3C, N). The
// gradient of the bias is the sum of d(qkv) over windows and tokens; the
// caller takes it outside the kernel.
//
// The TPU kernel takes qkv with the bias already added (its caller writes
// that sum to device memory first) and works on all heads of a few windows
// per program. Here the bias is added on the panel as it is loaded, as in the
// forward kernel (window_attention.cu), so no qkv + bias tensor exists, and
// one block handles one (window, head): the whole (N, N) score tile of that
// head is within the block's reach, so nothing is saved by the forward.
//
// What bounds it on an H100: per (query, key) pair 10D multiply-adds (scores
// three times and dp twice in the query phase, both again in the key phase,
// and the three products) and three exponentials on the CUDA cores in f32,
// against one read of the panels: arithmetic. Design: the q, k, v and d(out)
// panels of the head are staged in shared memory, (D, N) each, reads
// coalesced over the token index. Phase 1, one thread per query: the row max,
// then the row sum and row_i, then dq, with q and d(out) in registers and the
// key / value columns read as broadcasts; it leaves the row max, 1 / row sum
// and row_i in shared memory. Phase 2, one thread per key: rebuilds p_ij and
// ds_ij for every query from those and accumulates dk and dv in registers,
// reading its own key / value column conflict-free. No atomics: each sum is
// a loop inside one thread. Accumulation is f32, rounded once on the store.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // one thread per query, then per key; N <= 128

template <typename T, int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
window_attention_bias_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                                 const T* __restrict__ dout, T* __restrict__ dqkv, int C, int N,
                                 float scale) {
  extern __shared__ float smem[];
  float* qs = smem;             // q, k, v head panels, each (D, N), bias added
  float* ks = qs + D * N;
  float* vs = ks + D * N;
  float* gs = vs + D * N;       // d(out) head panel (D, N)
  float* ms = gs + D * N;       // per query: row max (log2 units), 1 / row sum, row_i
  float* ils = ms + N;
  float* rows = ils + N;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const size_t img = static_cast<size_t>(b) * 3 * C * N;
  for (int idx = threadIdx.x; idx < 3 * D * N; idx += kThreads) {
    const int part = idx / (D * N);
    const int rem = idx - part * D * N;
    const int d = rem / N;
    const int n = rem - d * N;
    const int ch = part * C + h * D + d;
    const float x = lw::to_f32(qkv[img + static_cast<size_t>(ch) * N + n]);
    smem[idx] = kBias ? x + bias[ch] : x;
  }
  const T* gp = dout + (static_cast<size_t>(b) * C + h * D) * N;
  for (int idx = threadIdx.x; idx < D * N; idx += kThreads) gs[idx] = lw::to_f32(gp[idx]);
  __syncthreads();

  const int t = threadIdx.x;
  const bool live = t < N;  // threads past N only help load and keep the barriers
  const float scale_log2 = scale * lw::kLog2e;

  if (live) {  // phase 1: thread t is query t
    float q[D], g[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      q[d] = qs[d * N + t] * scale_log2;
      g[d] = gs[d * N + t];
    }
    float m = -INFINITY;
    for (int j = 0; j < N; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(q[d], ks[d * N + j], s);
      m = fmaxf(m, s);
    }
    float l = 0.f, r = 0.f;
    for (int j = 0; j < N; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(q[d], ks[d * N + j], s);
        dp = fmaf(g[d], vs[d * N + j], dp);
      }
      const float e = exp2f(s - m);  // scores are in log2 units: exp2 == exp
      l += e;
      r = fmaf(e, dp, r);
    }
    const float il = 1.f / l;
    r *= il;
    ms[t] = m;
    ils[t] = il;
    rows[t] = r;

    float dq[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dq[d] = 0.f;
    for (int j = 0; j < N; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(q[d], ks[d * N + j], s);
        dp = fmaf(g[d], vs[d * N + j], dp);
      }
      const float ds = exp2f(s - m) * il * (dp - r) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, ks[d * N + j], dq[d]);
    }
    T* o = dqkv + img + static_cast<size_t>(h * D) * N + t;
#pragma unroll
    for (int d = 0; d < D; ++d) o[static_cast<size_t>(d) * N] = lw::from_f32<T>(dq[d]);
  }
  __syncthreads();
  if (!live) return;

  // phase 2: thread t is key t
  float dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  for (int i = 0; i < N; ++i) {
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      s = fmaf(qs[d * N + i], ks[d * N + t], s);
      dp = fmaf(gs[d * N + i], vs[d * N + t], dp);
    }
    const float p = exp2f(s * scale_log2 - ms[i]) * ils[i];
    const float ds = p * (dp - rows[i]) * scale;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[d] = fmaf(ds, qs[d * N + i], dk[d]);
      dv[d] = fmaf(p, gs[d * N + i], dv[d]);
    }
  }
  T* dkp = dqkv + img + static_cast<size_t>(C + h * D) * N + t;
  T* dvp = dqkv + img + static_cast<size_t>(2 * C + h * D) * N + t;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dkp[static_cast<size_t>(d) * N] = lw::from_f32<T>(dk[d]);
    dvp[static_cast<size_t>(d) * N] = lw::from_f32<T>(dv[d]);
  }
}

template <typename T, int D, bool kBias>
cudaError_t launch(const void* qkv, const void* bias, const void* dout, void* dqkv, int B,
                   int C, int N, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * D * N + 3 * N);
  auto kernel = window_attention_bias_bwd_kernel<T, D, kBias>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(B, C / D), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias), static_cast<const T*>(dout),
      static_cast<T*>(dqkv), C, N, scale);
  return cudaGetLastError();
}

template <typename T, bool kBias>
cudaError_t dispatch_d(int D, const void* qkv, const void* bias, const void* dout, void* dqkv,
                       int B, int C, int N, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16, kBias>(qkv, bias, dout, dqkv, B, C, N, scale, stream);
    case 32: return launch<T, 32, kBias>(qkv, bias, dout, dqkv, B, C, N, scale, stream);
    case 64: return launch<T, 64, kBias>(qkv, bias, dout, dqkv, B, C, N, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kBias>
int dispatch(const void* qkv, const void* bias, const void* dout, void* dqkv, int B, int C,
             int N, int num_heads, float scale, int dtype, void* stream) {
  if (B < 1 || N < 1 || N > kThreads || num_heads < 1 || C % num_heads != 0)
    return cudaErrorInvalidValue;
  const int D = C / num_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == lw::kFloat32)
    return dispatch_d<float, kBias>(D, qkv, bias, dout, dqkv, B, C, N, scale, st);
  if (dtype == lw::kBFloat16)
    return dispatch_d<__nv_bfloat16, kBias>(D, qkv, bias, dout, dqkv, B, C, N, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The backward of K1. qkv and dqkv (B, 3C, N), dout (B, C, N) in `dtype`, bias
// (3C,) f32, all contiguous.
extern "C" int lw_window_attention_bias_bwd(const void* qkv, const void* bias, const void* dout,
                                            void* dqkv, int B, int C, int N, int num_heads,
                                            float scale, int dtype, void* stream) {
  if (bias == nullptr) return cudaErrorInvalidValue;
  return dispatch<true>(qkv, bias, dout, dqkv, B, C, N, num_heads, scale, dtype, stream);
}

// The backward of K9: the same, without a bias.
extern "C" int lw_window_attention_bwd(const void* qkv, const void* dout, void* dqkv, int B,
                                       int C, int N, int num_heads, float scale, int dtype,
                                       void* stream) {
  return dispatch<false>(qkv, nullptr, dout, dqkv, B, C, N, num_heads, scale, dtype, stream);
}
