// What the channel-major sampler pair shares (K3 deform_attn.cu, K8
// deform_attn_bwd.cu): the levels, the route a launch takes, and the staging
// of one (b, h) map into shared memory.
//
// In the channel-major value (B, C, Len_in) the D channel rows of head h of
// batch element b are one contiguous block of D Len_in elements, the (b, h)
// map. A CTA takes one map and a slice of its queries. Where the map fits in
// at most half an SM's shared memory (so that two CTAs share an SM), the CTA
// copies it there and gathers its corners from there: one thread issues bulk
// copies (TMA's 1-D form, `cp.async.bulk`, no tensor map) that complete on an
// mbarrier the CTA waits on. A map whose address or size is not a multiple of
// 16 bytes, which a bulk copy refuses, is copied by the CTA's threads element
// by element. A map over the budget (large's two levels: 435 KB in f32) is
// gathered from device memory directly. A map's queries go to the fewest CTAs
// of at most 512 threads; staged, to more (a power of two) only while they
// fill the card once, since every CTA of a map copies the whole map; from
// device memory, to enough for 4 CTAs an SM. (Spreading the
// queries further, and clusters whose CTAs share one multicast copy of the
// map, each measured slower on an H100: PERF.md, section 6.) The route is
// chosen here only; `lw_deform_attn_cm_route` and `lw_deform_attn_cm_bwd_route`
// report it.
#pragma once

#include <algorithm>
#include <cstdint>

#include "deform_layout.cuh"

namespace lw {

constexpr int kCmThreads = 512;              // most threads a CTA
constexpr int kGatherCtas = 4;               // CTAs an SM at least, gathering from device memory
constexpr int kSmemPerSM = 233472;           // shared bytes an SM has (228 KB, sm_90)
constexpr int kStageMax = kSmemPerSM / 2 - 1024;  // a map staged so that two CTAs fit an SM
constexpr uint32_t kCopyPiece = 32768;       // bytes a bulk copy instruction

struct CmLevels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// (h, w, start) per level, checked against len_in
inline int cm_levels(const int* level_hw_start, int n_levels, int len_in, CmLevels* lv) {
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  lv->n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv->h[l] = level_hw_start[3 * l];
    lv->w[l] = level_hw_start[3 * l + 1];
    lv->start[l] = level_hw_start[3 * l + 2];
    if (lv->h[l] < 1 || lv->w[l] < 1 || lv->start[l] < 0 ||
        lv->start[l] + static_cast<long long>(lv->h[l]) * lv->w[l] > len_in)
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// How one launch covers its B H maps: CTA x takes map x / ctas_per_map and
// its query slice x % ctas_per_map
struct CmRoute {
  int staged;        // 1: each CTA gathers from its copy of the map in shared memory
  int bulk;          // 1: copied by bulk copies; 0: by the threads, element by element
  int smem_bytes;    // dynamic shared memory a CTA
  int ctas_per_map;
  int q_per_cta;
  int threads;       // a CTA
};

inline long long pow2_at_least(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

inline long long pow2_at_most(long long n) {
  long long p = 1;
  while (2 * p <= n) p <<= 1;
  return p;
}

// `lanes`: threads that share one query (K3 1, K8 D / 4 rounded up to a power of two)
inline CmRoute cm_route(const void* value_t, int B, int H, int D, int len_in, int Q, size_t isz,
                        int lanes) {
  CmRoute r;
  const size_t map_bytes = static_cast<size_t>(D) * len_in * isz;
  const size_t smem = (map_bytes + 15) / 16 * 16;
  r.staged = smem <= static_cast<size_t>(kStageMax);
  r.bulk = r.staged && map_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(value_t) % 16 == 0;
  r.smem_bytes = r.staged ? static_cast<int>(smem) : 0;
  const long long work = static_cast<long long>(Q) * lanes;
  const long long maps = static_cast<long long>(B) * H;
  const long long fewest = (work + kCmThreads - 1) / kCmThreads;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long ctas;
  if (r.staged) {
    // every CTA of a map copies it: the fewest CTAs a map, a power of two,
    // more only while they fill the card once
    const long long slots = static_cast<long long>(sms) * (kSmemPerSM / (r.smem_bytes + 1024));
    const long long fill = std::max(1LL, slots / maps);
    ctas = std::min(pow2_at_least(fewest), pow2_at_most(fill));
  } else {
    // from device memory: the fewest CTAs a map, but kGatherCtas an SM at
    // least, of a warp's work or more, to hide the gathers' latency
    const long long fill = (static_cast<long long>(kGatherCtas) * sms + maps - 1) / maps;
    ctas = std::max(fewest, std::min(fill, (work + 31) / 32));
  }
  r.ctas_per_map = static_cast<int>(ctas);
  r.q_per_cta = static_cast<int>((Q + ctas - 1) / ctas);
  r.threads = std::min(kCmThreads, (r.q_per_cta * lanes + 31) / 32 * 32);
  return r;
}

// Launch `kernel` on ctas_per_map x maps CTAs with the route's threads and shared memory.
template <typename... KArgs, typename... Args>
cudaError_t cm_launch(void (*kernel)(KArgs...), const CmRoute& r, int maps, cudaStream_t st,
                      Args... args) {
  if (r.smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, r.smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(r.ctas_per_map) * maps, r.threads, r.smem_bytes, st>>>(
      static_cast<KArgs>(args)...);
  return cudaGetLastError();
}

// route[0..6]: staged, bulk, shared bytes, CTAs a map, threads a CTA, and
// the registers and local (stack and spilled) bytes a thread of `fn`
inline int report_route(const CmRoute& r, const void* fn, int* route) {
  int attrs[3];
  if (const int err = kernel_attributes(fn, attrs)) return err;
  const int v[7] = {r.staged, r.bulk, r.smem_bytes, r.ctas_per_map, r.threads, attrs[0],
                    attrs[1]};
  for (int i = 0; i < 7; ++i) route[i] = v[i];
  return cudaSuccess;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The (b, h) map `gmap` (n elements) in this CTA's shared memory `smem`, for
// every thread of the CTA to read, by bulk copies or element by element
// (`bulk`). Every thread of the CTA calls it.
template <typename T>
__device__ __forceinline__ const T* cm_stage(const T* gmap, size_t n, unsigned char* smem,
                                             uint64_t* bar, int bulk) {
  T* s = reinterpret_cast<T*>(smem);
  if (!bulk) {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) s[i] = gmap[i];
    __syncthreads();
    return s;
  }
  const uint32_t bytes = static_cast<uint32_t>(n * sizeof(T));
  const uint32_t b = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    // the barrier visible to the copy engine before it completes a copy on it
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the one arrival, with the bytes still to land: the phase completes when they have
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
                 : "memory");
    const char* src = reinterpret_cast<const char*>(gmap);
    for (uint32_t at = 0; at < bytes; at += kCopyPiece) {
      const uint32_t len = bytes - at < kCopyPiece ? bytes - at : kCopyPiece;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(smem) + at),
          "l"(src + at), "r"(len), "r"(b)
          : "memory");
    }
  }
  __syncthreads();  // the barrier initialised before any thread waits on it
  uint32_t done = 0;
  do {  // the first phase (parity 0) of the barrier
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(0u)
        : "memory");
  } while (!done);
  return s;
}

}  // namespace lw
