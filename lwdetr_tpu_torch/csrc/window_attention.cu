// K1 and K9: short-sequence (window) attention, channel-major, with the
// fused qkv bias (K1) or without a bias (K9).
//
// K1 replaces lwdetr_tpu/ops/flash_attention.py::_attn_cm_allheads_bias_kernel
// (launched from _attn_cm_allheads_bias_call), K9 replaces
// ::_attn_cm_allheads_kernel (launched from _attn_cm_impl, the N <= 128
// branch: the decoder's self-attention over 100 queries). They compute, per
// window b and head h,
//   out[b, hD:(h+1)D, :] = softmax((q + bq)^T (k + bk)) (v + bv)
// over the channel-major packed qkv (B, 3C, N), N <= 128, with the (3C,)
// bias added on the panel as it is loaded (K1; K9 has none: the template
// case kBias = false never reads a bias, and no zeros tensor stands in for
// one), f32 accumulation, an exact softmax, and the normalisation applied
// after PV. The softmax scale is folded into q by the caller (scale = 1) or
// passed in.
//
// What bounds it on an H100: at the ViT window shape (N = 100, D = 16) each
// (window, head) panel is 3 x 16 x 100 values, read once from device memory,
// and each query does 2 N D multiply-adds for QK^T (computed twice: once for
// the row max, once for the weights) plus N D for PV on the CUDA cores, and
// N exponentials. The arithmetic is small against the bytes only in bf16 on
// tensor cores; this kernel runs on the CUDA cores in f32, so it is bound by
// the f32 FMA rate. Design: one block per (window, head), one thread per
// query; the panel is staged in shared memory with the bias added, reads
// coalesced over the token index (contiguous in the channel-major layout);
// every thread then reads the same key/value column at once (a shared-memory
// broadcast). The whole (3C, N) panel (230 KB in f32 at C = 192) would not
// fit in one block's shared memory, so the kernel works head by head.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // one thread per query; N <= 128

template <typename T, int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
window_attention_bias_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                             T* __restrict__ out, int C, int N, float scale_log2) {
  extern __shared__ float panel[];  // q, k, v head panels, each (D, N), bias added
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
    panel[idx] = kBias ? x + bias[ch] : x;
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i >= N) return;  // ragged tail: threads past the last query only helped load

  const float* ks = panel + D * N;
  const float* vs = panel + 2 * D * N;
  float q[D];
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = panel[d * N + i] * scale_log2;

  float m = -INFINITY;
  for (int j = 0; j < N; ++j) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(q[d], ks[d * N + j], s);
    m = fmaxf(m, s);
  }
  float l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int j = 0; j < N; ++j) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(q[d], ks[d * N + j], s);
    const float p = exp2f(s - m);  // scores are in log2 units: exp2 == exp
    l += p;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[d * N + j], acc[d]);
  }
  T* o = out + (static_cast<size_t>(b) * C + h * D) * N + i;
#pragma unroll
  for (int d = 0; d < D; ++d) o[static_cast<size_t>(d) * N] = lw::from_f32<T>(acc[d] / l);
}

template <typename T, int D, bool kBias>
cudaError_t launch(const void* qkv, const void* bias, void* out, int B, int C, int N,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * D * N;
  auto kernel = window_attention_bias_kernel<T, D, kBias>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(B, C / D), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias), static_cast<T*>(out),
      C, N, scale * lw::kLog2e);
  return cudaGetLastError();
}

template <typename T, bool kBias>
cudaError_t dispatch_d(int D, const void* qkv, const void* bias, void* out, int B, int C,
                       int N, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16, kBias>(qkv, bias, out, B, C, N, scale, stream);
    case 32: return launch<T, 32, kBias>(qkv, bias, out, B, C, N, scale, stream);
    case 64: return launch<T, 64, kBias>(qkv, bias, out, B, C, N, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kBias>
int dispatch(const void* qkv, const void* bias, void* out, int B, int C, int N, int num_heads,
             float scale, int dtype, void* stream) {
  if (B < 1 || N < 1 || N > kThreads || num_heads < 1 || C % num_heads != 0)
    return cudaErrorInvalidValue;
  const int D = C / num_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == lw::kFloat32)
    return dispatch_d<float, kBias>(D, qkv, bias, out, B, C, N, scale, st);
  if (dtype == lw::kBFloat16)
    return dispatch_d<__nv_bfloat16, kBias>(D, qkv, bias, out, B, C, N, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// K1. qkv (B, 3C, N) and out (B, C, N) in `dtype`, bias (3C,) f32, all contiguous.
extern "C" int lw_window_attention_bias(const void* qkv, const void* bias, void* out, int B,
                                        int C, int N, int num_heads, float scale, int dtype,
                                        void* stream) {
  if (bias == nullptr) return cudaErrorInvalidValue;
  return dispatch<true>(qkv, bias, out, B, C, N, num_heads, scale, dtype, stream);
}

// K9. qkv (B, 3C, N) and out (B, C, N) in `dtype`, contiguous; no bias.
extern "C" int lw_window_attention(const void* qkv, void* out, int B, int C, int N,
                                   int num_heads, float scale, int dtype, void* stream) {
  return dispatch<false>(qkv, nullptr, out, B, C, N, num_heads, scale, dtype, stream);
}
