// K7: backward of the short-sequence (window) attention, with the fused qkv
// bias (the backward of K1) or without a bias (the backward of K9), on the
// tensor cores.
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
// per program. Here one block handles one (window, head), and the bias is
// added on the loaded panel: bf16(x + bf16(b)) in bf16 (add.rn, one rounding,
// the JAX package's `qkv_t + bias2d.astype(qkv_t.dtype)`), the f32 sum in f32.
//
// What bounds it on an H100: a (window, head) reads 4 (D, N) panels and
// writes 3; per (query, key) pair 5 D multiply-adds and one exponential. At
// small's shape (64 windows x 12 heads, N = 100, D = 16) the bytes take
// 0.005 ms and the tensor-core products far less: as in K1, the per-score
// work and the latency of one block bound it. Design: the whole panels of the
// head sit in shared memory ([d][token] rows, N padded to a multiple of 16:
// 100 -> 112, zero past N), loaded by cp.async with the copy width picked on
// the host and passed in (a 100-token bf16 row is 8-byte aligned, not 16). One warp per 16
// queries (7 warps at N = 100; not two heads a block at D = 16: 768 blocks of
// 7 warps already fill the card at small's train shape).
// Phase 1, per warp, the whole 16 x 112 score row in registers: S = Q^T K
// once, the exact row max and sum (a single-pass softmax, no second QK^T),
// dP = dO^T V, row_i = sum_j p dp from the unrounded f32 p exactly as the JAX
// kernel forms it, dS, and dQ = dS K^T with dS going from the accumulators to
// the A operand in registers (attention_bwd.cuh). Phase 2: P and dS are
// written once into shared memory as [query][key] rows (bf16 rounded to
// nearest even in bf16, the JAX kernel's `p.astype` / `ds.astype`; f32 in
// f32) over the K and V panels, which phase 1 no longer needs; each warp then
// takes 16 keys and all D channels: dV^T = dO P and dK^T = Q dS, whose
// results are [d][token] and leave straight from the accumulators. Nothing
// is computed twice.
// bf16: mma.sync.m16n8k16 with f32 accumulators. f32: 3xTF32 on
// mma.sync.m16n8k8.tf32 (three products for one: the f32 tolerance holds).
// Shared memory: (2 D + 2 max(Np, D)) (Np + 8) elements, at D = 64 and
// N = 100 84 KB in bf16 and 169 KB in f32; N = 128, D = 64, f32 is the
// largest case, 209 KB.
// Padded rows: a key past N gets p = 0 (masked before the max); a query past N
// has d(out) = 0, so its dp, row and ds are 0 and it adds nothing to dK or dV,
// as the JAX kernel's docstring says.
#include "attention_wide.cuh"
#include "common.cuh"
#include "attention_bwd.cuh"

namespace {

constexpr int kMaxN = 128;          // tokens a panel holds
constexpr int kMaxThreads = 2 * kMaxN;  // one warp per 16 queries

__host__ __device__ __forceinline__ int padded(int N) { return (N + 15) & ~15; }

template <typename T, int D>
size_t smem_bytes(int N) {
  const int np = padded(N);
  return sizeof(T) * (2 * D + 2 * (np > D ? np : D)) * lw::tile_stride(np);
}

// x + b as the JAX package forms the biased panel: one rounding in bf16
__device__ __forceinline__ float add_bias(float x, float b) { return x + b; }
__device__ __forceinline__ lw::bf16 add_bias(lw::bf16 x, float b) {
  return __hadd(x, __float2bfloat16(b));
}

// two adjacent values of one row, stored together
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(lw::bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = lw::pack_bf16(a, b);
}

template <typename T, int D, bool kBias>
__global__ void __launch_bounds__(kMaxThreads)
window_attention_bias_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                                 const T* __restrict__ dout, T* __restrict__ dqkv, int C, int N,
                                 float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = padded(N);
  const int stride = lw::tile_stride(np);
  T* const qs = reinterpret_cast<T*>(smem);  // q, d(out), k, v panels, D rows each
  T* const gs = qs + D * stride;
  T* const ks = gs + D * stride;
  T* const vs = ks + D * stride;
  T* const ps = ks;                  // phase 2: P and dS, np rows each, over k and v
  T* const dss = ps + np * stride;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const T* gp = dout + (static_cast<size_t>(b) * C + h * D) * N;
  lw::load_rows_vec<D>(vec, qs, stride, qkv + (img + h * D) * N, N, 0, np, tid, nthreads);
  lw::load_rows_vec<D>(vec, gs, stride, gp, N, 0, np, tid, nthreads);
  lw::load_rows_vec<D>(vec, ks, stride, qkv + (img + C + h * D) * N, N, 0, np, tid, nthreads);
  lw::load_rows_vec<D>(vec, vs, stride, qkv + (img + 2 * C + h * D) * N, N, 0, np, tid, nthreads);
  lw::cp_async_commit();
  lw::cp_async_wait<0>();
  __syncthreads();
  if constexpr (kBias) {  // on the live columns; past N the panels stay zero
    for (int idx = tid; idx < 3 * D * N; idx += nthreads) {
      const int r = idx / N;  // row of q, k, v: part * D + d
      const int n = idx - r * N;
      const int part = r / D;
      T* panel = part == 0 ? qs : part == 1 ? ks : vs;
      T& x = panel[(r - part * D) * stride + n];
      x = add_bias(x, bias[part * C + h * D + (r - part * D)]);
    }
    __syncthreads();
  }

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = 16 * warp;    // phase 1: this warp's queries; phase 2: its keys
  const int live = np / 8;     // 8-key tiles
  const float sl2 = scale * lw::kLog2e;

  // ---- phase 1: S, the softmax, dP, the row term, dS, dQ (this warp's queries)
  float s[kMaxN / 8][4], dp[kMaxN / 8][4];
  lw::zero(s);
  lw::zero(dp);
  lw::mma_tn<D, kMaxN / 8>(s, qs, stride, ks, stride, m0, 0, lane, live);
  lw::mma_tn<D, kMaxN / 8>(dp, gs, stride, vs, stride, m0, 0, lane, live);
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int n = 0; n < kMaxN / 8; ++n) {
    if (n < live) {
      const int key = 8 * n + 2 * t;
      if (key >= N) s[n][0] = s[n][2] = -INFINITY;  // keys past N get no weight
      if (key + 1 >= N) s[n][1] = s[n][3] = -INFINITY;
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
  }
  const float m_lo = lw::quad_max(mx_lo) * sl2, m_hi = lw::quad_max(mx_hi) * sl2;  // scale > 0
  float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
  for (int n = 0; n < kMaxN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = n < live ? lw::fast_exp2(fmaf(s[n][e], sl2, e < 2 ? -m_lo : -m_hi)) : 0.f;
    }
    l_lo += s[n][0] + s[n][1];
    l_hi += s[n][2] + s[n][3];
  }
  l_lo = lw::quad_sum(l_lo);
  l_hi = lw::quad_sum(l_hi);
  float r_lo = 0.f, r_hi = 0.f;
#pragma unroll
  for (int n = 0; n < kMaxN / 8; ++n) {
    s[n][0] /= l_lo;  // p = e / sum e, as the JAX kernel divides
    s[n][1] /= l_lo;
    s[n][2] /= l_hi;
    s[n][3] /= l_hi;
    r_lo = fmaf(s[n][0], dp[n][0], fmaf(s[n][1], dp[n][1], r_lo));
    r_hi = fmaf(s[n][2], dp[n][2], fmaf(s[n][3], dp[n][3], r_hi));
  }
  r_lo = lw::quad_sum(r_lo);
  r_hi = lw::quad_sum(r_hi);
#pragma unroll
  for (int n = 0; n < kMaxN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - (e < 2 ? r_lo : r_hi)) * scale;
  }
  {
    float dq[D / 8][4];
    lw::zero(dq);
    lw::mma_rt<kMaxN / 8, D / 8>(dq, dp, ks, stride, 0, 0, lane, live);  // dQ = dS K^T
    T* o = dqkv + (img + h * D) * N;
    const int i_lo = m0 + g, i_hi = i_lo + 8;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? i_lo : i_hi;
        if (i < N) o[static_cast<size_t>(8 * n + 2 * t + (e & 1)) * N + i] = lw::from_f32<T>(dq[n][e]);
      }
    }
  }
  __syncthreads();  // every warp is done with the K and V panels
#pragma unroll
  for (int n = 0; n < kMaxN / 8; ++n) {
    if (n < live) {
      const int key = 8 * n + 2 * t;
      store_pair(&ps[(m0 + g) * stride + key], s[n][0], s[n][1]);
      store_pair(&ps[(m0 + g + 8) * stride + key], s[n][2], s[n][3]);
      store_pair(&dss[(m0 + g) * stride + key], dp[n][0], dp[n][1]);
      store_pair(&dss[(m0 + g + 8) * stride + key], dp[n][2], dp[n][3]);
    }
  }
  __syncthreads();

  // ---- phase 2: dV^T = dO P and dK^T = Q dS for this warp's 16 keys
  float dv[D / 16][2][4], dk[D / 16][2][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) {
    lw::zero(dv[mt]);
    lw::zero(dk[mt]);
  }
  lw::mma_nn<D / 16, kMaxN>(dv, gs, stride, ps, stride, m0, np, lane);
  lw::mma_nn<D / 16, kMaxN>(dk, qs, stride, dss, stride, m0, np, lane);
  T* dkp = dqkv + (img + C + h * D) * N;
  T* dvp = dqkv + (img + 2 * C + h * D) * N;
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * mt + g + (e < 2 ? 0 : 8);
        const int j = m0 + 8 * nt + 2 * t + (e & 1);
        if (j < N) {
          const size_t at = static_cast<size_t>(d) * N + j;
          dkp[at] = lw::from_f32<T>(dk[mt][nt][e]);
          dvp[at] = lw::from_f32<T>(dv[mt][nt][e]);
        }
      }
    }
  }
}

// ---- host side ------------------------------------------------------------

template <typename T, int D, bool kBias>
cudaError_t launch(const void* qkv, const void* bias, const void* dout, void* dqkv, int B,
                   int C, int N, float scale, cudaStream_t stream) {
  const auto kernel = window_attention_bias_bwd_kernel<T, D, kBias>;
  const size_t smem = smem_bytes<T, D>(N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // the narrower of the copy widths (elements) that qkv and d(out) allow
  const int a = lw::copy_vec(qkv, N, sizeof(T)), b = lw::copy_vec(dout, N, sizeof(T));
  kernel<<<dim3(B, C / D), 2 * padded(N), smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias), static_cast<const T*>(dout),
      static_cast<T*>(dqkv), C, N, scale, a < b ? a : b);
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

template <typename T, bool kBias>
int dispatch_d(int D, const void* qkv, const void* bias, const void* dout, void* dqkv,
               float* stats, int B, int C, int N, float scale, cudaStream_t st) {
  if (lw_wide::takes(D)) {  // no forward wrote a log-sum-exp: pass 1 takes it
    if (stats == nullptr) return cudaErrorInvalidValue;
    float* delta = stats + static_cast<size_t>(B) * (C / D) * N;
    return lw_wide::backward<T>(qkv, stats, dout, dqkv, delta, B, C, N, D, scale, true, st);
  }
  switch (D) {
    case 16: return launch<T, 16, kBias>(qkv, bias, dout, dqkv, B, C, N, scale, st);
    case 32: return launch<T, 32, kBias>(qkv, bias, dout, dqkv, B, C, N, scale, st);
    default: return launch<T, 64, kBias>(qkv, bias, dout, dqkv, B, C, N, scale, st);
  }
}

template <bool kBias>
int dispatch(const void* qkv, const void* bias, const void* dout, void* dqkv, float* stats,
             int B, int C, int N, int num_heads, float scale, int dtype, void* stream) {
  if (int err = check(B, C, N, num_heads, dtype, kBias)) return err;
  const int D = C / num_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == lw::kFloat32)
    return dispatch_d<float, kBias>(D, qkv, bias, dout, dqkv, stats, B, C, N, scale, st);
  return dispatch_d<lw::bf16, kBias>(D, qkv, bias, dout, dqkv, stats, B, C, N, scale, st);
}

template <typename T, bool kBias>
int attributes_t(int D, int* attrs) {
  if (lw_wide::takes(D)) {  // its passes: the larger registers, the summed spills
    int both[6];
    if (int err = lw_wide::backward_attributes<T>(D, both)) return err;
    attrs[0] = both[0] > both[3] ? both[0] : both[3];
    attrs[1] = both[1] + both[4];
    attrs[2] = both[2] > both[5] ? both[2] : both[5];
    return cudaSuccess;
  }
  const void* fn = reinterpret_cast<const void*>(
      D == 16   ? window_attention_bias_bwd_kernel<T, 16, kBias>
      : D == 32 ? window_attention_bias_bwd_kernel<T, 32, kBias>
                : window_attention_bias_bwd_kernel<T, 64, kBias>);
  return lw::kernel_attributes(fn, attrs);
}

template <bool kBias>
int attributes(int B, int C, int N, int num_heads, int dtype, int* attrs) {
  if (int err = check(B, C, N, num_heads, dtype, kBias)) return err;
  const int D = C / num_heads;
  return dtype == lw::kFloat32 ? attributes_t<float, kBias>(D, attrs)
                               : attributes_t<lw::bf16, kBias>(D, attrs);
}

}  // namespace

// The backward of K1. qkv and dqkv (B, 3C, N), dout (B, C, N) in `dtype`, bias
// (3C,) f32, all contiguous.
extern "C" int lw_window_attention_bias_bwd(const void* qkv, const void* bias, const void* dout,
                                            void* dqkv, int B, int C, int N, int num_heads,
                                            float scale, int dtype, void* stream) {
  if (bias == nullptr) return cudaErrorInvalidValue;
  return dispatch<true>(qkv, bias, dout, dqkv, nullptr, B, C, N, num_heads, scale, dtype,
                        stream);
}

// The backward of K9: the same, without a bias. `stats` (2, B, H, N) f32
// scratch for the wide case's row log-sum-exp and row term (null otherwise).
extern "C" int lw_window_attention_bwd(const void* qkv, const void* dout, void* dqkv,
                                       void* stats, int B, int C, int N, int num_heads,
                                       float scale, int dtype, void* stream) {
  return dispatch<false>(qkv, nullptr, dout, dqkv, static_cast<float*>(stats), B, C, N,
                         num_heads, scale, dtype, stream);
}

// Registers, local (spill) bytes and static shared bytes a thread / block of
// the kernel that the backward of K1 (`with_bias` 1) or of K9 (0) would launch
// for these arguments.
extern "C" int lw_window_attention_bwd_attributes(int B, int C, int N, int num_heads, int dtype,
                                                  int with_bias, int* attrs) {
  return with_bias ? attributes<true>(B, C, N, num_heads, dtype, attrs)
                   : attributes<false>(B, C, N, num_heads, dtype, attrs);
}
