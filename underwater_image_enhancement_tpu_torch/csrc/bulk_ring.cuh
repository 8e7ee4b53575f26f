// The pieces of a shared-memory ring of tiles fed by bulk copies (the 1D
// TMA of sm_90), shared by the forward-LAB kernels (csrc/lab_forward.cu)
// and the inverse-LAB kernels (csrc/lab_inverse.cu): the mbarrier and
// bulk-copy instructions, the proxy fence that orders a thread's reads of
// a stage before the copy that refills it, 16-byte vector lanes, and the
// resident-block count that sizes a one-wave grid.  Included, not compiled
// alone.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace uie_detail {

constexpr int kMaxDevices = 64;

// 4 adjacent values of a plane, one 16-byte access
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

template <typename V>
__device__ __forceinline__ auto lane(const V& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The shared-memory address of p, and the mbarrier and bulk-copy (1D TMA)
// instructions of sm_90.
__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar)));
}

// the inits visible to the bulk copies
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// this thread's shared-memory accesses ordered against the async proxy's
// (the bulk copies)
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(smem(bar)), "r"(parity) : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar)) : "memory");
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Blocks of `kernel` (launched with `threads` threads and no dynamic
// shared memory) resident on the current device, all SMs together, cached
// in `cache` (one entry a device, zero-initialised by the caller): the
// grid at which every block runs in the first wave.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, int (&cache)[kMaxDevices]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) dev = kMaxDevices - 1;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  return cache[dev];
}

// The streaming multiprocessors of the current device.
inline int device_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace uie_detail
