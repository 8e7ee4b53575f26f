// Helpers shared by the per-pixel kernels (included, not compiled alone).

#pragma once

#include <cuda_runtime.h>

namespace uie_detail {

// OpenCV's CV_DESCALE: round-half-up shift; `>>` on a negative int is
// arithmetic, as in XLA.
__device__ __forceinline__ int descale(int v, int n) {
  return (v + (1 << (n - 1))) >> n;
}

__device__ __forceinline__ int clamp_i(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Blocks of `threads` for a grid-stride loop over n items: enough to cover
// them, at most 4 a streaming multiprocessor (so that each block stages its
// tables in shared memory once for many pixels).
inline int grid_for(long long n, int threads) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)sms * 4;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace uie_detail
