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
// one), f32 accumulation, an exact single-pass softmax, and the
// normalisation applied after PV. The softmax scale is folded into q by the
// caller (scale = 1) or passed in.
//
// bf16 (the eval path), on the tensor cores. What bounds it on an H100: a
// (window, head) panel is 3 x D x 100 values, read once; per (query, key)
// pair there are 4 D multiply-adds and one exponential. On the tensor cores
// the multiply-adds cost less than the exponentials (16 per clock per SM):
// at small's window shape (128 windows x 12 heads, N = 100) 15 M exponentials
// take 0.004 ms, the 2.9 MB 0.001 ms; so, as in K2, the exponentials and the
// per-score work around them bound it, and at this size also the latency of
// one block. Design: one block per (window, head); the whole (D, N) Q, K and
// V panels of the head in shared memory, loaded by cp.async (8-byte copies:
// a 100-token bf16 row is 200 bytes, 8-byte aligned but not 16; 16-byte ones
// when N % 8 == 0, plain loads when N % 4 != 0; the host picks), zero past N
// up to N padded to a multiple of 16 (100 -> 112), Q and K in one copy group
// and V in a second, so that QK^T runs while V lands; one warp per 16 queries
// (7 warps at N = 100; not two heads a block at D = 16: 1536 blocks of 7
// warps already fill the card at small's shape, and K9's 64 blocks at batch
// 8 need the warps inside a block, which one warp per 16 queries gives).
// Each warp keeps its 16 x 112 scores in registers (56 f32 a lane): the row
// max and the weights come from one QK^T (mma.sync.m16n8k16, bf16 operands,
// f32 accumulators, fragments by ldmatrix(.trans) from the [d][token] rows,
// padded by 8 elements against bank conflicts); p = exp2(s scale log2 e -
// max) is rounded to bf16 in registers as the A operand of PV and the f32
// row sum divides after PV, as the TPU kernel's `p.astype(v.dtype)`. K1's
// bias goes onto each Q, K and V fragment in registers as it leaves shared
// memory, as the TPU kernel forms the biased panel in bf16: round(x +
// round(bias)), one rounding of the sum (add.rn.bf16x2): two packed adds per
// four mma, and no pass over the panel with its barriers. The output goes
// through the warp's own columns of the Q panel and leaves as 16-token runs.
// f32 (the parity path and the train step) keeps the CUDA-core body: one
// thread per query; the panel staged in f32 with the bias added, read as
// shared-memory broadcasts; QK^T computed twice (the row max, then the
// weights); bound by the f32 FMA rate.
//
// Without a bias, head dims that are multiples of 64 from 128 up (the
// decoder's wider heads) take the wide case, attention_wide.cuh; K1 (the ViT's, whose heads never exceed 64
// channels) takes none of them.
#include "attention_wide.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

// ---- f32: CUDA cores ------------------------------------------------------

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

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int kMaxN = 128;               // tokens a panel holds: 8 warps, 16 key tiles of 8
constexpr int kMaxThreads = 2 * kMaxN;   // one warp per 16 queries

// padded tokens and shared row stride (elements) of a panel of N tokens: the
// stride is an odd number of 16-byte units, so ldmatrix's eight row addresses
// fall in eight different bank groups
__host__ __device__ __forceinline__ int padded(int N) { return (N + 15) & ~15; }
__host__ __device__ __forceinline__ int row_stride(int N) { return padded(N) + 8; }

template <int D, int kVec, bool kBias>
__global__ void __launch_bounds__(kMaxThreads)
window_attention_mma_kernel(const lw::bf16* __restrict__ qkv, const float* __restrict__ bias,
                            lw::bf16* __restrict__ out, int C, int N, float scale_log2) {
  using lw::bf16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const qs = reinterpret_cast<bf16*>(smem);  // q, k, v panels, each D rows
  const int np = padded(N);
  const int stride = row_stride(N);
  bf16* const ks = qs + D * stride;
  bf16* const vs = ks + D * stride;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  // Q and K in one group, V in a second: QK^T runs while V lands
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    lw::load_rows<kVec, D>(qs + part * D * stride, stride, qkv + (img + part * C + h * D) * N, N,
                           0, np, tid, nthreads);
    if (part > 0) lw::cp_async_commit();
  }
  lw::cp_async_wait<1>();
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;

  const int g = lane / 4, t = lane % 4;    // fragment row / column pair
  const int r8 = lane % 8, mat = lane / 8;  // ldmatrix: row of matrix `mat`
  const int m0 = 16 * warp;                 // this warp's queries
  const int steps = np / 16;                // 16-key steps

  // K1: the bias goes onto each fragment in registers as it is loaded,
  // bf16(x + bf16(b)) as the TPU kernel forms the panel (add.rn.bf16x2: the
  // exact sum rounded once). A fragment register holds two channels of Q or
  // K (d = 16 kk + 2t.., + 8) or two keys of one V channel (d = 16 n + g, + 8).
  __nv_bfloat162 kbias[D / 16][2], vbias[D / 16][2];
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    lw::ldsm_x4_trans(qa[kk], &qs[(16 * kk + r8 + 8 * (mat >> 1)) * stride + m0 + 8 * (mat & 1)]);
    if constexpr (kBias) {
      const float* bq = bias + h * D + 16 * kk + 2 * t;
      const float* bk = bq + C;
      const float* bv = bias + 2 * C + h * D + 16 * kk + g;
      const __nv_bfloat162 q_lo = __floats2bfloat162_rn(bq[0], bq[1]);
      const __nv_bfloat162 q_hi = __floats2bfloat162_rn(bq[8], bq[9]);
      qa[kk][0] = lw::add_bf16x2(qa[kk][0], q_lo);
      qa[kk][1] = lw::add_bf16x2(qa[kk][1], q_lo);
      qa[kk][2] = lw::add_bf16x2(qa[kk][2], q_hi);
      qa[kk][3] = lw::add_bf16x2(qa[kk][3], q_hi);
      kbias[kk][0] = __floats2bfloat162_rn(bk[0], bk[1]);
      kbias[kk][1] = __floats2bfloat162_rn(bk[8], bk[9]);
      vbias[kk][0] = __float2bfloat162_rn(bv[0]);
      vbias[kk][1] = __float2bfloat162_rn(bv[8]);
    }
  }

  // S = Q K^T over all keys: one C fragment per 8 keys, up to 16
  float s[kMaxN / 8][4];
#pragma unroll
  for (int kp = 0; kp < kMaxN / 16; ++kp) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * kp][e] = s[2 * kp + 1][e] = 0.f;
    if (kp < steps) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kb[4];
        lw::ldsm_x4_trans(kb, &ks[(16 * kk + r8 + 8 * (mat & 1)) * stride + 16 * kp + 8 * (mat >> 1)]);
        if constexpr (kBias) {
#pragma unroll
          for (int e = 0; e < 4; ++e) kb[e] = lw::add_bf16x2(kb[e], kbias[kk][e & 1]);
        }
        lw::mma_bf16(s[2 * kp], qa[kk], kb[0], kb[1]);
        lw::mma_bf16(s[2 * kp + 1], qa[kk], kb[2], kb[3]);
      }
    }
  }
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int kp = 0; kp < kMaxN / 16; ++kp) {
    if (kp == steps - 1 && N < np) {  // keys past N, all in the last step, get no weight
#pragma unroll
      for (int n = 2 * kp; n < 2 * kp + 2; ++n) {
        const int key = 8 * n + 2 * t;
        if (key >= N) s[n][0] = s[n][2] = -INFINITY;
        if (key + 1 >= N) s[n][1] = s[n][3] = -INFINITY;
      }
    }
    if (kp < steps) {
#pragma unroll
      for (int n = 2 * kp; n < 2 * kp + 2; ++n) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
      }
    }
  }
  // rows g and g + 8: the exact max, x scale log2 e (scale > 0)
  const float m_lo = lw::quad_max(mx_lo) * scale_log2;
  const float m_hi = lw::quad_max(mx_hi) * scale_log2;
  lw::cp_async_wait<0>();
  __syncthreads();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
  for (int kp = 0; kp < kMaxN / 16; ++kp) {
    if (kp < steps) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = lw::fast_exp2(fmaf(s[2 * kp][e], scale_log2, e < 2 ? -m_lo : -m_hi));
        p[4 + e] = lw::fast_exp2(fmaf(s[2 * kp + 1][e], scale_log2, e < 2 ? -m_lo : -m_hi));
      }
      l_lo += (p[0] + p[1]) + (p[4] + p[5]);
      l_hi += (p[2] + p[3]) + (p[6] + p[7]);
      const uint32_t pa[4] = {lw::pack_bf16(p[0], p[1]), lw::pack_bf16(p[2], p[3]),
                              lw::pack_bf16(p[4], p[5]), lw::pack_bf16(p[6], p[7])};
#pragma unroll
      for (int np2 = 0; np2 < D / 16; ++np2) {
        uint32_t vb[4];
        lw::ldsm_x4(vb, &vs[(16 * np2 + r8 + 8 * (mat >> 1)) * stride + 16 * kp + 8 * (mat & 1)]);
        if constexpr (kBias) {
#pragma unroll
          for (int e = 0; e < 4; ++e) vb[e] = lw::add_bf16x2(vb[e], vbias[np2][e >> 1]);
        }
        lw::mma_bf16(acc[2 * np2], pa, vb[0], vb[1]);
        lw::mma_bf16(acc[2 * np2 + 1], pa, vb[2], vb[3]);
      }
    }
  }
  const float sum_lo = lw::quad_sum(l_lo), sum_hi = lw::quad_sum(l_hi);
  // normalise after PV; stage (D, 16) in this warp's own Q columns (only this
  // warp reads them, and its Q fragments are in registers), store token runs
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = 8 * n + 2 * t;
    qs[d * stride + m0 + g] = __float2bfloat16(acc[n][0] / sum_lo);
    qs[(d + 1) * stride + m0 + g] = __float2bfloat16(acc[n][1] / sum_lo);
    qs[d * stride + m0 + g + 8] = __float2bfloat16(acc[n][2] / sum_hi);
    qs[(d + 1) * stride + m0 + g + 8] = __float2bfloat16(acc[n][3] / sum_hi);
  }
  __syncwarp();
  bf16* o = out + (static_cast<size_t>(b) * C + h * D) * N + m0;
  for (int e = lane; e < 16 * D; e += 32) {
    const int d = e / 16, j = e % 16;
    if (m0 + j < N) o[static_cast<size_t>(d) * N + j] = qs[d * stride + m0 + j];
  }
}

// ---- host side ------------------------------------------------------------

using MmaKernel = void (*)(const lw::bf16*, const float*, lw::bf16*, int, int, float);

template <int D, bool kBias>
MmaKernel pick_mma(int vec) {
  switch (vec) {
    case 8: return window_attention_mma_kernel<D, 8, kBias>;
    case 4: return window_attention_mma_kernel<D, 4, kBias>;
    default: return window_attention_mma_kernel<D, 1, kBias>;
  }
}

template <int D, bool kBias>
const void* pick(int dtype, int vec) {
  if (dtype == lw::kFloat32)
    return reinterpret_cast<const void*>(window_attention_bias_kernel<float, D, kBias>);
  return reinterpret_cast<const void*>(pick_mma<D, kBias>(vec));
}

template <int D, bool kBias>
cudaError_t launch(const void* qkv, const void* bias, void* out, int B, int C, int N,
                   float scale, int dtype, cudaStream_t stream) {
  const float sl2 = scale * lw::kLog2e;
  const float* bp = static_cast<const float*>(bias);
  if (dtype == lw::kFloat32) {
    const size_t smem = sizeof(float) * 3 * D * N;
    auto kernel = window_attention_bias_kernel<float, D, kBias>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kernel<<<dim3(B, C / D), kThreads, smem, stream>>>(
        static_cast<const float*>(qkv), bp, static_cast<float*>(out), C, N, sl2);
  } else {
    const size_t smem = sizeof(lw::bf16) * 3 * D * row_stride(N);
    MmaKernel kernel = pick_mma<D, kBias>(lw::bf16_vec(qkv, N));
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kernel<<<dim3(B, C / D), 2 * padded(N), smem, stream>>>(
        static_cast<const lw::bf16*>(qkv), bp, static_cast<lw::bf16*>(out), C, N, sl2);
  }
  return cudaGetLastError();
}

int check(int B, int C, int N, int num_heads, int dtype, bool bias) {
  if (B < 1 || N < 1 || N > kMaxN || num_heads < 1 || C % num_heads != 0 ||
      (dtype != lw::kFloat32 && dtype != lw::kBFloat16))
    return cudaErrorInvalidValue;
  const int D = C / num_heads;
  return D == 16 || D == 32 || D == 64 || (!bias && lw_wide::takes(D)) ? cudaSuccess
                                                                       : cudaErrorInvalidValue;
}

template <bool kBias>
int dispatch(const void* qkv, const void* bias, void* out, int B, int C, int N, int num_heads,
             float scale, int dtype, void* stream) {
  if (int err = check(B, C, N, num_heads, dtype, kBias)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = C / num_heads;
  if (lw_wide::takes(D))
    return dtype == lw::kFloat32
               ? lw_wide::forward<float>(qkv, out, nullptr, B, C, N, D, scale, st)
               : lw_wide::forward<lw::bf16>(qkv, out, nullptr, B, C, N, D, scale, st);
  switch (D) {
    case 16: return launch<16, kBias>(qkv, bias, out, B, C, N, scale, dtype, st);
    case 32: return launch<32, kBias>(qkv, bias, out, B, C, N, scale, dtype, st);
    default: return launch<64, kBias>(qkv, bias, out, B, C, N, scale, dtype, st);
  }
}

template <bool kBias>
int attributes(const void* qkv, int B, int C, int N, int num_heads, int dtype, int* attrs) {
  if (int err = check(B, C, N, num_heads, dtype, kBias)) return err;
  const int vec = lw::bf16_vec(qkv, N);
  const int D = C / num_heads;
  if (lw_wide::takes(D))
    return dtype == lw::kFloat32 ? lw_wide::forward_attributes<float>(D, attrs)
                                 : lw_wide::forward_attributes<lw::bf16>(D, attrs);
  const void* fn = D == 16 ? pick<16, kBias>(dtype, vec)
                   : D == 32 ? pick<32, kBias>(dtype, vec) : pick<64, kBias>(dtype, vec);
  return lw::kernel_attributes(fn, attrs);
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

// Registers, local (spill) bytes and static shared bytes of the kernel that
// K1 (`with_bias` 1) or K9 (0) would launch for these arguments.
extern "C" int lw_window_attention_attributes(const void* qkv, int B, int C, int N,
                                              int num_heads, int dtype, int with_bias,
                                              int* attrs) {
  return with_bias ? attributes<true>(qkv, B, C, N, num_heads, dtype, attrs)
                   : attributes<false>(qkv, B, C, N, num_heads, dtype, attrs);
}
