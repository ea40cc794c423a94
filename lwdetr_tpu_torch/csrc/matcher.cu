// M1: the minimum-cost assignment of the Hungarian matcher, one CTA a
// problem.
//
// Replaces lwdetr_tpu/models/matcher.py::solve_assignment (device code that is
// not Pallas: Jonker-Volgenant shortest augmenting paths under
// lax.while_loop, vmapped by hungarian_match over (image, group)). The port
// stacks the matcher's output sets, so one launch solves every (set s,
// image b, group g) problem of a train step: 4 x 4 x 13 = 208 at small's
// batch 4.
//
// Function. The JAX loop, step for step, on the 1-indexed (T + 1, Q + 1)
// cost with a zero row 0 and column 0: rows 1..n of each problem are
// augmented in order, n = min(sum(valid[b]), Q) read here on the device (the
// loader packs the valid targets first); each Dijkstra step forms
// cur = (C[i0][j] - u[i0]) - v[j] as two f32 subtractions, updates minv and
// way where cur < minv, and takes the argmin of minv over the unused columns
// (used ones read as 1e15), the lowest column among equal minima and a NaN
// before any number, as jnp.argmin does; u[p[j]] += delta and v[j] -= delta on
// the used columns, minv[j] -= delta on the others, as plain adds, never
// contracted. The JAX code forms C[i0] and u[i0] as one-hot contractions, so
// one non-finite entry in another row of a column makes that column NaN
// (0 x inf) and a non-finite delta makes every u NaN: both are reproduced
// (`bad` counts a column's non-finite entries, `poisoned` records a
// non-finite delta). "Infinity" is the JAX solver's finite 1e15: when every
// unused column is masked the argmin returns a used one once, delta = 1e15
// brings the unused minv back to <= 0, and the next step takes a new column.
// With INFINITY that step would be inf - inf = NaN and never end. As a guard
// a row's Dijkstra stops after 2 (Q + 1) + 1 steps and a backtrack after
// n + 1; the JAX loop never reaches either. Same operations, same order,
// same ties: the same columns as JAX, bit for bit, on the same cost.
//
// Layout. A thread owns column j in [0, Q] (blockDim = Q + 1 rounded up to
// a warp); its v, minv, used, way and non-finite count live in registers.
// u (T + 1), p (Q + 1), way at the backtrack (Q + 1) and the argmin's
// per-warp results live in shared memory, and so do the problem's first
// augmented rows, as many as fit in kSmemBudget (96 KB: two CTAs an SM);
// the other rows are read from L2 at each step. This file owns the layout:
// lw_assignment_shared reports it to the wrapper.
//
// Bound. Not bytes: the cost is read once (25 MB at small's step, ~8 us at
// 3.35 TB/s). The dependent chain is: a row's Dijkstra takes one CTA-wide
// argmin (warp shuffles, one shared-memory pass, two barriers) a step, and
// the steps of a problem run one after the other, about sum over rows of
// the augmenting path's length (1-3 a row at 7 targets; up to tens at 100).
// The backtrack runs on one thread.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kInf = 1e15f;           // lwdetr_tpu/models/matcher.py:26 _INF
constexpr int kSmemBudget = 96 * 1024;  // two CTAs an SM: 264 on an H100
constexpr int kMaxWarps = 32;

// u (T + 1), p and way (Q + 1 each), the argmin's per-warp value and column
__host__ __device__ inline int fixed_shared_bytes(int T, int Q) {
  return 4 * (T + 1) + 8 * (Q + 1) + kMaxWarps * 8;
}

// the problem's first cost rows staged in shared memory, as many as fit in the budget
__host__ __device__ inline int staged_rows(int T, int Q) {
  const int rows = (kSmemBudget - fixed_shared_bytes(T, Q)) / (4 * Q);
  return rows < 0 ? 0 : (rows < T ? rows : T);
}

inline int shared_bytes(int T, int Q) {
  return fixed_shared_bytes(T, Q) + 4 * Q * staged_rows(T, Q);
}

// (a, ia) comes before (b, ib) in jnp.argmin's order: a NaN first, then the
// smaller value, then the lower column
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a < b;
  return ia < ib;
}

__global__ void __launch_bounds__(1024) assignment_kernel(
    const float* __restrict__ cost, const bool* __restrict__ valid, int64_t* __restrict__ out,
    int B, int T, int G, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* u_sh = reinterpret_cast<float*>(smem);               // T + 1
  int* p_sh = reinterpret_cast<int*>(u_sh + (T + 1));          // Q + 1
  int* way_sh = p_sh + (Q + 1);                                // Q + 1
  float* red_v = reinterpret_cast<float*>(way_sh + (Q + 1));  // kMaxWarps
  int* red_j = reinterpret_cast<int*>(red_v + kMaxWarps);     // kMaxWarps
  float* rows_sh = reinterpret_cast<float*>(red_j + kMaxWarps);
  __shared__ int n_sh;

  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarps = blockDim.x >> 5;
  const bool active = j <= Q;
  const int problem = blockIdx.x;
  const int g = problem % G;
  const int sb = problem / G;  // s * B + b
  const int b = sb % B;
  const long long row_stride = static_cast<long long>(G) * Q;
  // cost row t (0-based; the 1-indexed row t + 1) of this problem, column j - 1
  const float* base =
      cost + static_cast<long long>(sb) * T * row_stride + static_cast<long long>(g) * Q;
  int64_t* out_p = out + static_cast<long long>(problem) * T;

  // the valid count of image b
  if (j == 0) n_sh = 0;
  __syncthreads();
  int mine = 0;
  for (int t = j; t < T; t += blockDim.x) mine += valid[static_cast<long long>(b) * T + t] ? 1 : 0;
  if (mine) atomicAdd(&n_sh, mine);
  __syncthreads();
  // at most Q rows find a column (T may exceed Q when few targets are valid)
  const int n = min(n_sh, min(T, Q));
  const int staged = staged_rows(T, Q) < n ? staged_rows(T, Q) : n;

  // one pass over the problem's rows: each column's non-finite count (the
  // zero row 0 and column 0 have none), and the first augmented rows staged
  int bad = 0;
  if (active && j > 0) {
    for (int t = 0; t < T; ++t) {
      const float x = base[t * row_stride + (j - 1)];
      bad += isfinite(x) ? 0 : 1;
      if (t < staged) rows_sh[t * Q + (j - 1)] = x;
    }
  }
  for (int t = j; t <= T; t += blockDim.x) u_sh[t] = 0.0f;
  if (active) p_sh[j] = 0;
  float v = 0.0f;
  bool poisoned = false;  // a delta was non-finite: every u is NaN in the JAX loop
  const int cap = 2 * (Q + 1) + 1;
  __syncthreads();

  for (int i = 1; i <= n; ++i) {
    if (j == 0) p_sh[0] = i;
    __syncthreads();
    float minv = kInf;
    bool used = false;
    int way = 0;
    int j0 = 0;
    for (int step = 0; step < cap && p_sh[j0] != 0; ++step) {
      if (j == j0) used = true;
      const int i0 = p_sh[j0];
      float masked = INFINITY;  // threads past column Q never win: +inf, and a higher index
      if (active) {
        float c = 0.0f;
        if (j > 0) {
          c = (i0 - 1 < staged) ? rows_sh[(i0 - 1) * Q + (j - 1)]
                                : base[(i0 - 1) * row_stride + (j - 1)];
        }
        // the one-hot product over every row: 0 x (inf or NaN) elsewhere is NaN
        const float dot = (bad - (isfinite(c) ? 0 : 1)) > 0 ? NAN : c;
        const float u_i0 = poisoned ? NAN : u_sh[i0];
        const float cur = __fsub_rn(__fsub_rn(dot, u_i0), v);
        if (!used && cur < minv) {
          minv = cur;
          way = j0;
        }
        masked = used ? kInf : minv;
      }
      // CTA-wide argmin: warp shuffles, then every thread reduces the warps' results
      float bv = masked;
      int bj = j;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
        if (before(ov, oj, bv, bj)) {
          bv = ov;
          bj = oj;
        }
      }
      // one buffer: the barrier that ends each step keeps the next step's writes
      // behind every thread's reads
      if (lane == 0) {
        red_v[warp] = bv;
        red_j[warp] = bj;
      }
      __syncthreads();
      float delta = red_v[0];
      int j1 = red_j[0];
      // not unrolled: unrolled, ptxas keeps 32 registers and spills 16 bytes
#pragma unroll 1
      for (int w = 1; w < nwarps; ++w) {
        const float ov = red_v[w];
        const int oj = red_j[w];
        if (before(ov, oj, delta, j1)) {
          delta = ov;
          j1 = oj;
        }
      }
      if (active) {
        if (used) {
          v = __fsub_rn(v, delta);
          const int r = p_sh[j];
          u_sh[r] = __fadd_rn(u_sh[r], delta);  // distinct rows: one writer each
        } else {
          minv = __fsub_rn(minv, delta);
        }
      }
      poisoned = poisoned || !isfinite(delta);
      j0 = j1;
      __syncthreads();
    }
    // backtrack on one thread, along the way columns
    if (active) way_sh[j] = way;
    __syncthreads();
    if (j == 0) {
      for (int step = 0; step <= n && j0 != 0; ++step) {
        const int j1 = way_sh[j0];
        p_sh[j0] = p_sh[j1];
        j0 = j1;
      }
    }
    __syncthreads();
  }

  // invert p: rows 1..n take their column (global in G * Q), the others 0
  for (int t = j; t < T; t += blockDim.x) out_p[t] = 0;
  __syncthreads();
  if (active && j > 0 && p_sh[j] != 0) out_p[p_sh[j] - 1] = static_cast<int64_t>(g) * Q + (j - 1);
}

}  // namespace

// cost (S, B, T, G * Q) f32, valid (B, T) bool, out (S, B, G, T) int64
extern "C" int lw_assignment(const void* cost, const void* valid, void* out, int S, int B, int T,
                             int G, int Q, cudaStream_t stream) {
  if (Q + 1 > 1024 || Q < 1 || T < 1) return cudaErrorInvalidValue;
  const int problems = S * B * G;
  if (problems == 0) return cudaSuccess;
  const int threads = (Q + 1 + 31) / 32 * 32;
  const int smem = shared_bytes(T, Q);
  cudaError_t err = cudaFuncSetAttribute(assignment_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  assignment_kernel<<<problems, threads, smem, stream>>>(
      static_cast<const float*>(cost), static_cast<const bool*>(valid),
      static_cast<int64_t*>(out), B, T, G, Q);
  return cudaGetLastError();
}

// the dynamic shared memory a launch at (T, Q) takes, and the cost rows it stages
extern "C" int lw_assignment_shared(int T, int Q, int* out) {
  if (Q < 1 || T < 1) return cudaErrorInvalidValue;
  out[0] = shared_bytes(T, Q);
  out[1] = staged_rows(T, Q);
  out[2] = kSmemBudget;
  return cudaSuccess;
}

extern "C" int lw_assignment_attributes(int* attrs) {
  return lw::kernel_attributes(reinterpret_cast<const void*>(assignment_kernel), attrs);
}
