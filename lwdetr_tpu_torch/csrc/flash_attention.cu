// K2: global attention over channel-major packed qkv, with an online softmax.
//
// Replaces lwdetr_tpu/ops/flash_attention.py::_attn_cm_kernel (launched from
// _attn_cm_impl). It computes, per image b and head h,
//   out[b, hD:(h+1)D, :] = softmax(scale q^T k) v
// over qkv (B, 3C, N): q, k and v of head h are the channel rows hD..,
// C + hD.. and 2C + hD.., each (D, N) with the token index contiguous.
//
// The TPU kernel holds the whole-N key and value panels in VMEM and does a
// single-pass exact softmax. A block here cannot hold them next to enough
// others, so both cases tile the keys and keep a running row max and row sum
// (the online softmax): the same function, normalised by the row sum after
// PV as on the TPU.
//
// bf16 (the eval path), on the tensor cores. What bounds it on an H100: at
// head_dim D <= 64 the 4 D multiply-adds a (query, key) pair cost the tensor
// cores less than the one exponential costs the special-function units (16
// per clock per SM): at the ViT global shape (B = 8, H = 12, N = 1600) the
// 246 M exponentials take 0.059 ms, the bytes 0.002 ms. So the design keeps
// the exponential unit fed and every other per-score cost small:
// - mma.sync.m16n8k16 (bf16 operands, f32 accumulators; FlashAttention-2's
//   shape), not wgmma: a warpgroup's 64-row tile would leave N = 300's
//   decoder blocks mostly padding, and at D = 16 one k-step of QK^T is all
//   there is to issue, so wgmma's asynchrony buys nothing the exponentials
//   do not already hide;
// - a block of 4 warps takes 64 queries, each warp 16 of them, and walks the
//   keys in tiles of 64 through a double-buffered ring in shared memory
//   filled by cp.async (16-byte copies when N % 8 == 0 and the base is
//   16-byte aligned, 8-byte ones when N % 4 == 0, plain loads otherwise: the
//   host picks, `lw::bf16_vec`; TMA would need 16-byte row strides, which
//   N = 300 and N = 100 do not have);
// - the tiles stay in the layout of qkv, (D, tokens) rows, and ldmatrix(.trans)
//   reads them as fragments: no transposing copy anywhere; rows are padded to
//   72 elements (144 bytes, an odd number of 16-byte units), so the eight row
//   addresses of an 8x8 matrix hit eight different bank groups;
// - per score: one FFMA (scale x log2 e applied to the f32 score together
//   with the max subtraction: the JAX kernel scales the f32 score, not q), one
//   MUFU.EX2, one FMNMX, one FADD and half a pack to bf16; P goes from the
//   accumulator registers straight back as the A operand of PV (the JAX
//   kernel's `p.astype(v.dtype)`), the row sums stay per lane until the end,
//   and only the ragged last key tile pays a per-score mask;
// - the output tile goes through the warp's columns of the query tile in
//   shared memory, so the warp writes 16-token runs of each channel row.
// f32 (the parity path and today's train step) keeps the CUDA-core body:
// one thread per query holding q, the accumulator and 32 scores in
// registers; tiles staged as f32 (D, 32) rows and read back as float4.
//
// For training the kernel can also write each row's log-sum-exp of the
// scaled scores, in log2 units (row max + log2 row sum), to `lse` (B, H, N):
// the backward kernel (flash_attention_bwd.cu) rebuilds the softmax weights
// from it instead of taking the row max and sum again. `lse` is null in eval,
// which then pays nothing for it. Both cases write it.
//
// Head dims that are multiples of 64 from 128 up (the decoder's wider heads)
// take the wide case, attention_wide.cuh: tensor cores in both dtypes.
#include "attention_wide.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

// ---- f32: CUDA cores ------------------------------------------------------

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

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;  // queries per block = keys per tile = 64
constexpr int kStride = kTile + 8;  // shared row: 144 bytes, an odd number of 16-byte units

template <int D, int kVec>
__global__ void __launch_bounds__(32 * kWarps)
flash_attention_cm_mma_kernel(const lw::bf16* __restrict__ qkv, lw::bf16* __restrict__ out,
                              float* __restrict__ lse, int C, int N, float scale_log2) {
  using lw::bf16;
  __shared__ __align__(16) bf16 qs[D * kStride];
  __shared__ __align__(16) bf16 ks[2][D * kStride];
  __shared__ __align__(16) bf16 vs[2][D * kStride];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = blockIdx.x * kTile;
  const size_t img = static_cast<size_t>(b) * 3 * C;
  const bf16* qp = qkv + (img + h * D) * N;
  const bf16* kp = qkv + (img + C + h * D) * N;
  const bf16* vp = qkv + (img + 2 * C + h * D) * N;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;    // fragment row / column pair
  const int r8 = lane % 8, mat = lane / 8;  // ldmatrix: row of matrix `mat`
  const int m0 = 16 * warp;                 // this warp's queries in the tile

  lw::load_rows<kVec, D>(qs, kStride, qp, N, i0, kTile, tid, 32 * kWarps);
  lw::load_rows<kVec, D>(ks[0], kStride, kp, N, 0, kTile, tid, 32 * kWarps);
  lw::load_rows<kVec, D>(vs[0], kStride, vp, N, 0, kTile, tid, 32 * kWarps);
  lw::cp_async_commit();

  uint32_t qa[D / 16][4];  // Q as A fragments, one per 16 channels
  float acc[D / 8][4];     // O, one C fragment per 8 channels
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of rows g and g + 8, x scale log2 e
  float l_lo = 0.f, l_hi = 0.f;              // this lane's part of their row sums

  const int n_tiles = (N + kTile - 1) / kTile;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int st = jt & 1;
    if (jt + 1 < n_tiles) {  // the next tile into the other stage, then wait for this one
      lw::load_rows<kVec, D>(ks[st ^ 1], kStride, kp, N, (jt + 1) * kTile, kTile, tid,
                             32 * kWarps);
      lw::load_rows<kVec, D>(vs[st ^ 1], kStride, vp, N, (jt + 1) * kTile, kTile, tid,
                             32 * kWarps);
      lw::cp_async_commit();
      lw::cp_async_wait<1>();
    } else {
      lw::cp_async_wait<0>();
    }
    __syncthreads();
    if (jt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        lw::ldsm_x4_trans(qa[kk], &qs[(16 * kk + r8 + 8 * (mat >> 1)) * kStride + m0 + 8 * (mat & 1)]);
    }

    // S = Q K^T for this warp's 16 queries and the tile's 64 keys
    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const bf16* kt = ks[st];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t kb[4];
        lw::ldsm_x4_trans(kb, &kt[(16 * kk + r8 + 8 * (mat & 1)) * kStride + 16 * np + 8 * (mat >> 1)]);
        lw::mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
        lw::mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
      }
    }
    if ((jt + 1) * kTile > N) {  // ragged last tile: keys past N get no weight
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const int key = jt * kTile + 8 * n + 2 * t;
        if (key >= N) s[n][0] = s[n][2] = -INFINITY;
        if (key + 1 >= N) s[n][1] = s[n][3] = -INFINITY;
      }
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
    // scale > 0, so the max of the scaled scores is the scaled max; finite,
    // since every tile holds a live key
    const float mn_lo = fmaxf(m_lo, lw::quad_max(mx_lo) * scale_log2);
    const float mn_hi = fmaxf(m_hi, lw::quad_max(mx_hi) * scale_log2);
    const float al_lo = lw::fast_exp2(m_lo - mn_lo);  // 0 on the first tile
    const float al_hi = lw::fast_exp2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= al_lo;
    l_hi *= al_hi;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= al_lo;
      acc[n][1] *= al_lo;
      acc[n][2] *= al_hi;
      acc[n][3] *= al_hi;
    }

    // P (rounded to bf16) V, 16 keys a step
    const bf16* vt = vs[st];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = lw::fast_exp2(fmaf(s[2 * kk][e], scale_log2, e < 2 ? -mn_lo : -mn_hi));
        p[4 + e] = lw::fast_exp2(fmaf(s[2 * kk + 1][e], scale_log2, e < 2 ? -mn_lo : -mn_hi));
      }
      l_lo += (p[0] + p[1]) + (p[4] + p[5]);
      l_hi += (p[2] + p[3]) + (p[6] + p[7]);
      const uint32_t pa[4] = {lw::pack_bf16(p[0], p[1]), lw::pack_bf16(p[2], p[3]),
                              lw::pack_bf16(p[4], p[5]), lw::pack_bf16(p[6], p[7])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vb[4];
        lw::ldsm_x4(vb, &vt[(16 * np + r8 + 8 * (mat >> 1)) * kStride + 16 * kk + 8 * (mat & 1)]);
        lw::mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
        lw::mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // stage st is consumed: the next iteration may refill it
  }

  const float sum_lo = lw::quad_sum(l_lo), sum_hi = lw::quad_sum(l_hi);
  const int i_lo = i0 + m0 + g, i_hi = i_lo + 8;
  if (lse != nullptr && t == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * gridDim.y + h) * N;
    if (i_lo < N) lrow[i_lo] = m_lo + log2f(sum_lo);
    if (i_hi < N) lrow[i_hi] = m_hi + log2f(sum_hi);
  }
  // normalise after PV, stage the (D, 16) output in this warp's columns of
  // the query tile (no warp reads qs after the first tile), store token runs
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = 8 * n + 2 * t;
    qs[d * kStride + m0 + g] = __float2bfloat16(acc[n][0] / sum_lo);
    qs[(d + 1) * kStride + m0 + g] = __float2bfloat16(acc[n][1] / sum_lo);
    qs[d * kStride + m0 + g + 8] = __float2bfloat16(acc[n][2] / sum_hi);
    qs[(d + 1) * kStride + m0 + g + 8] = __float2bfloat16(acc[n][3] / sum_hi);
  }
  __syncwarp();
  bf16* o = out + (static_cast<size_t>(b) * C + h * D) * N + i0 + m0;
  for (int e = lane; e < 16 * D; e += 32) {
    const int d = e / 16, j = e % 16;
    if (i0 + m0 + j < N) o[static_cast<size_t>(d) * N + j] = qs[d * kStride + m0 + j];
  }
}

// ---- host side ------------------------------------------------------------

using MmaKernel = void (*)(const lw::bf16*, lw::bf16*, float*, int, int, float);

template <int D>
MmaKernel pick_mma(int vec) {
  switch (vec) {
    case 8: return flash_attention_cm_mma_kernel<D, 8>;
    case 4: return flash_attention_cm_mma_kernel<D, 4>;
    default: return flash_attention_cm_mma_kernel<D, 1>;
  }
}

template <int D>
const void* pick(int dtype, int vec) {
  if (dtype == lw::kFloat32) return reinterpret_cast<const void*>(flash_attention_cm_kernel<float, D>);
  return reinterpret_cast<const void*>(pick_mma<D>(vec));
}

template <int D>
cudaError_t launch(const void* qkv, void* out, float* lse, int B, int C, int N, float scale,
                   int dtype, cudaStream_t stream) {
  const float sl2 = scale * lw::kLog2e;
  if (dtype == lw::kFloat32) {
    const dim3 grid((N + BQ - 1) / BQ, C / D, B);
    flash_attention_cm_kernel<float, D><<<grid, BQ, 0, stream>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), lse, C, N, sl2);
  } else {
    const dim3 grid((N + kTile - 1) / kTile, C / D, B);
    const MmaKernel kernel = pick_mma<D>(lw::bf16_vec(qkv, N));
    kernel<<<grid, 32 * kWarps, 0, stream>>>(static_cast<const lw::bf16*>(qkv),
                                             static_cast<lw::bf16*>(out), lse, C, N, sl2);
  }
  return cudaGetLastError();
}

int check(int B, int C, int N, int num_heads, int dtype) {
  if (B < 1 || B > 65535 || N < 1 || num_heads < 1 || C % num_heads != 0 ||
      (dtype != lw::kFloat32 && dtype != lw::kBFloat16))
    return cudaErrorInvalidValue;
  const int D = C / num_heads;
  return D == 16 || D == 32 || D == 64 || lw_wide::takes(D) ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// qkv (B, 3C, N) and out (B, C, N) in `dtype`, contiguous; lse (B, H, N) f32 or null.
extern "C" int lw_flash_attention_cm(const void* qkv, void* out, void* lse, int B, int C, int N,
                                     int num_heads, float scale, int dtype, void* stream) {
  if (int err = check(B, C, N, num_heads, dtype)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  const int D = C / num_heads;
  if (lw_wide::takes(D))
    return dtype == lw::kFloat32 ? lw_wide::forward<float>(qkv, out, lp, B, C, N, D, scale, st)
                                 : lw_wide::forward<lw::bf16>(qkv, out, lp, B, C, N, D, scale, st);
  switch (D) {
    case 16: return launch<16>(qkv, out, lp, B, C, N, scale, dtype, st);
    case 32: return launch<32>(qkv, out, lp, B, C, N, scale, dtype, st);
    default: return launch<64>(qkv, out, lp, B, C, N, scale, dtype, st);
  }
}

// Registers, local (spill) bytes and static shared bytes a thread / block of
// the kernel that lw_flash_attention_cm would launch for these arguments.
extern "C" int lw_flash_attention_cm_attributes(const void* qkv, int B, int C, int N,
                                                int num_heads, int dtype, int* attrs) {
  if (int err = check(B, C, N, num_heads, dtype)) return err;
  const int D = C / num_heads;
  if (lw_wide::takes(D))
    return dtype == lw::kFloat32 ? lw_wide::forward_attributes<float>(D, attrs)
                                 : lw_wide::forward_attributes<lw::bf16>(D, attrs);
  const int vec = lw::bf16_vec(qkv, N);
  const void* fn = C / num_heads == 16 ? pick<16>(dtype, vec)
                   : C / num_heads == 32 ? pick<32>(dtype, vec) : pick<64>(dtype, vec);
  return lw::kernel_attributes(fn, attrs);
}
