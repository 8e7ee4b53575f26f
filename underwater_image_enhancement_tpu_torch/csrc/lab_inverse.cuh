// OpenCV's integer Lab2RGBinteger on one pixel, with its tables in shared
// memory: the body of the inverse LAB kernels (csrc/lab_inverse.cu) and of
// the fused CLAHE + inverse kernel (csrc/clahe_lab_apply.cu).  The JAX
// package's _lab_inv_body (underwater_image_enhancement_tpu/ops/
// pallas_kernels.py), op for op; its _ctrunc_div is an exact emulation of
// C's truncating integer division, so here it is plain `/`.
//
// Table block (int32, ops/lab_tables.py INV_TABLE_U8, the bytes of
// LabInvTables):
//   [0..8] COEFFS_INV (3x3 row-major)  [9] MIN_AB  [10] AB_MAX
//   [11] AB_LIN_THRESH  [12] AB_LIN_K  [13] ADIV_OFFSET  [14] BDIV_OFFSET
//   [15] 0  [16..271] L2Y  [272..527] L2IFY
//   [528..1551] INV_GAMMA_TAB (4096) as bytes, four a word

#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace uie_detail {

constexpr int kInvHeader = 15;
constexpr int kInvIgSize = 4096;
constexpr int kInvBase = 1 << 14;

// The inverse's tables in shared memory, laid out as INV_TABLE_U8 (6208
// bytes, INV_GAMMA as u8, sections on 16-byte boundaries; declare it
// __align__(16)).
struct LabInvTables {
  int head[kInvHeader + 1];
  int y[256];
  int ify[256];
  unsigned char ig[kInvIgSize];
};
static_assert(sizeof(LabInvTables) == 6208, "INV_TABLE_U8's layout");

// INV_TABLE_U8 (16-byte aligned) into s, 16 bytes a thread, all loads
// before the stores.  Every thread of the block (kThreads of them) takes
// part; the caller synchronises after.
template <int kThreads>
__device__ __forceinline__ void stage_lab_inv_tables(LabInvTables& s,
                                                     const int* tab) {
  constexpr int kChunks = sizeof(LabInvTables) / 16;
  constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
  int4 chunk[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = threadIdx.x + k * kThreads;
    if (c < kChunks) chunk[k] = __ldg(reinterpret_cast<const int4*>(tab) + c);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = threadIdx.x + k * kThreads;
    if (c < kChunks) reinterpret_cast<int4*>(&s)[c] = chunk[k];
  }
}

__device__ __forceinline__ int ab_to_xz(int v, const int* h) {
  v = min(max(v, h[9]), h[10]);
  if (v <= h[11]) return (v * 108) / 841 - h[12];
  return ((v * v) / kInvBase * v) / kInvBase;
}

// (L, a, b) -> u8 values (r, g, b) in rgb[0..2].
__device__ __forceinline__ void lab_inv_pixel(const LabInvTables& s, int L,
                                              int a, int b, int rgb[3]) {
  const int* h = s.head;
  const int Lc = clamp_i(L, 0, 255);
  const int y = s.y[Lc], ify = s.ify[Lc];
  const int adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - h[13];
  const int bdiv = ((b * 41943 + (1 << 4)) >> 9) - h[14];
  const int x = ab_to_xz(ify + adiv, h);
  const int z = ab_to_xz(ify - bdiv, h);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int idx = descale(x * h[3 * ch] + y * h[3 * ch + 1] + z * h[3 * ch + 2], 14);
    rgb[ch] = s.ig[clamp_i(idx, 0, kInvIgSize - 1)];
  }
}

}  // namespace uie_detail
