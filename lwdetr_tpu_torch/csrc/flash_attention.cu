// K2: global attention over channel-major packed qkv, with an online softmax.
//
// Replaces lwdetr_tpu/ops/flash_attention.py::_attn_cm_kernel (launched from
// _attn_cm_impl). It computes, per image b and head h,
//   out[b, hD:(h+1)D, :] = softmax(scale q^T k) v
// over qkv (B, 3C, N): q, k and v of head h are the channel rows hD..,
// C + hD.. and 2C + hD.., each (D, N) with the token index contiguous.
//
// The TPU kernel holds the whole-N key and value panels in VMEM and does a
// single-pass exact softmax. At N = 1600, D = 16 in f32 those panels need
// ~205 KB, too much for one block's shared memory with room for others, so
// this kernel tiles the keys (BK at a time) and keeps a running row max and
// row sum (the online softmax). That is the same function: the result is
// normalised by the row sum after PV, as on the TPU.
//
// What bounds it on an H100: per (query, key) pair it does 2D multiply-adds
// and one exponential on the CUDA cores in f32; at the ViT global shape
// (B = 8, H = 12, N = 1600, D = 16) that is 7.9 G multiply-adds and 0.25 G
// exponentials against 3.7 MB of input, so it is bound by arithmetic, not
// bytes. Design: one block per (query tile of BQ, head, image), one thread
// per query holding q, the accumulator and a tile of BK scores in registers;
// each key/value tile is staged in shared memory as (D, BK) rows (coalesced
// global reads over the token index, conflict-free stores) and read back as
// float4 along the keys, so one shared load feeds four multiply-adds. Scores
// are kept in log2 units (scale * log2 e is folded into q) so the
// exponential is one exp2. The ragged last key tile is masked to -inf.
//
// For training the kernel can also write each row's log-sum-exp of the
// scaled scores, in log2 units (row max + log2 row sum), to `lse` (B, H, N):
// the backward kernel (flash_attention_bwd.cu) rebuilds the softmax weights
// from it instead of taking the row max and sum again. `lse` is null in eval,
// which then pays nothing for it.
#include "common.cuh"

namespace {

constexpr int BQ = 64;  // queries (threads) per block
constexpr int BK = 32;  // keys per shared-memory tile

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
flash_attention_cm_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                          float* __restrict__ lse, int C, int N, float scale_log2) {
  __shared__ __align__(16) float ks[D][BK];
  __shared__ __align__(16) float vs[D][BK];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const T* qp = qkv + (img + h * D) * N;
  const T* kp = qkv + (img + C + h * D) * N;
  const T* vp = qkv + (img + 2 * C + h * D) * N;
  const int i = blockIdx.x * BQ + threadIdx.x;
  const bool live = i < N;

  float q[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    q[d] = live ? lw::to_f32(qp[static_cast<size_t>(d) * N + i]) * scale_log2 : 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < N; j0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < D * BK; idx += BQ) {
      const int d = idx / BK;
      const int j = idx - d * BK;
      const int n = j0 + j;
      const bool ok = n < N;
      ks[d][j] = ok ? lw::to_f32(kp[static_cast<size_t>(d) * N + n]) : 0.f;
      vs[d][j] = ok ? lw::to_f32(vp[static_cast<size_t>(d) * N + n]) : 0.f;
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int j = 0; j < BK; j += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[d][j]);
        s[j] = fmaf(q[d], k4.x, s[j]);
        s[j + 1] = fmaf(q[d], k4.y, s[j + 1]);
        s[j + 2] = fmaf(q[d], k4.z, s[j + 2]);
        s[j + 3] = fmaf(q[d], k4.w, s[j + 3]);
      }
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      if (j0 + j >= N) s[j] = -INFINITY;  // ragged key tail
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);  // finite: every tile holds a live key
    const float alpha = exp2f(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = exp2f(s[j] - m_new);
      l += s[j];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float a = acc[d] * alpha;
#pragma unroll
      for (int j = 0; j < BK; j += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[d][j]);
        a = fmaf(s[j], v4.x, a);
        a = fmaf(s[j + 1], v4.y, a);
        a = fmaf(s[j + 2], v4.z, a);
        a = fmaf(s[j + 3], v4.w, a);
      }
      acc[d] = a;
    }
    m = m_new;
  }
  if (!live) return;
  if (lse != nullptr)
    lse[(static_cast<size_t>(b) * gridDim.y + h) * N + i] = m + log2f(l);
  T* o = out + (static_cast<size_t>(b) * C + h * D) * N + i;
#pragma unroll
  for (int d = 0; d < D; ++d) o[static_cast<size_t>(d) * N] = lw::from_f32<T>(acc[d] / l);
}

template <typename T, int D>
cudaError_t launch(const void* qkv, void* out, float* lse, int B, int C, int N, float scale,
                   cudaStream_t stream) {
  const dim3 grid((N + BQ - 1) / BQ, C / D, B);
  flash_attention_cm_kernel<T, D><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), lse, C, N, scale * lw::kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* qkv, void* out, float* lse, int B, int C, int N,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(qkv, out, lse, B, C, N, scale, stream);
    case 32: return launch<T, 32>(qkv, out, lse, B, C, N, scale, stream);
    case 64: return launch<T, 64>(qkv, out, lse, B, C, N, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv (B, 3C, N) and out (B, C, N) in `dtype`, contiguous; lse (B, H, N) f32 or null.
extern "C" int lw_flash_attention_cm(const void* qkv, void* out, void* lse, int B, int C, int N,
                                     int num_heads, float scale, int dtype, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || num_heads < 1 || C % num_heads != 0)
    return cudaErrorInvalidValue;
  const int D = C / num_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  if (dtype == lw::kFloat32) return dispatch_d<float>(D, qkv, out, lp, B, C, N, scale, st);
  if (dtype == lw::kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, qkv, out, lp, B, C, N, scale, st);
  return cudaErrorInvalidValue;
}
