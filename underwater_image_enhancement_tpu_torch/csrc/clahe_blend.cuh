// CLAHE's per-pixel map: OpenCV's f32 bilinear blend of four tile-LUT
// values, shared by the CLAHE apply kernel (csrc/clahe_apply.cu, which
// finds a block's tiles once) and the fused CLAHE + inverse LAB kernel
// (csrc/clahe_lab_apply.cu, whose clahe_pixel finds each pixel's tiles and
// reads their LUTs from global memory).
//
// Pixel (y, x) of the unpadded (H, W) plane sits at (y+pt, x+plf) of the
// JAX package's half-tile-padded band frame, so its band block is
// (i, j) = ((y+pt)/th, (x+plf)/tw) and its four tiles follow from it
// (ops/histeq.py in the JAX package, r1/r2/c1/c2).  luts: (T, 256) int32
// per-tile LUTs; ya/xa: the f32 interpolation fractions in the band frame.
//
// The blend (m0*xa1 + m1*xa)*ya1 + (m2*xa1 + m3*xa)*ya is evaluated with
// __fmul_rn/__fadd_rn (and the sources are built with -fmad=false): an FMA
// would move exact .5 ties in the final rintf (round half to even).

#pragma once

#include <cuda_runtime.h>

namespace uie_detail {

struct ClaheGeometry {
  int th, tw, pt, plf, tiles_x, tiles_y;
};

// The CLAHE value (0..255) of a pixel whose four LUT values are m0..m3,
// at fractions wx and wy (wy1 = 1 - wy, computed once a row).
__device__ __forceinline__ int clahe_blend(float m0, float m1, float m2,
                                           float m3, float wx, float wy,
                                           float wy1) {
  const float wx1 = __fadd_rn(1.0f, -wx);
  const float top = __fadd_rn(__fmul_rn(m0, wx1), __fmul_rn(m1, wx));
  const float bot = __fadd_rn(__fmul_rn(m2, wx1), __fmul_rn(m3, wx));
  const float val = __fadd_rn(__fmul_rn(top, wy1), __fmul_rn(bot, wy));
  return (int)fminf(fmaxf(rintf(val), 0.0f), 255.0f);
}

// The CLAHE value (0..255) of pixel (y, x) whose source value is v.
__device__ __forceinline__ int clahe_pixel(int v, int y, int x,
                                           const int* __restrict__ luts,
                                           const float* __restrict__ ya,
                                           const float* __restrict__ xa,
                                           const ClaheGeometry& geo) {
  const int yb = y + geo.pt, xb = x + geo.plf;
  const int i = yb / geo.th, j = xb / geo.tw;
  const int r1 = min(max(i - 1, 0), geo.tiles_y - 1);
  const int r2 = min(max(i, 0), geo.tiles_y - 1);
  const int c1 = min(max(j - 1, 0), geo.tiles_x - 1);
  const int c2 = min(max(j, 0), geo.tiles_x - 1);
  v = min(max(v, 0), 255);
  const float m0 = (float)__ldg(luts + (r1 * geo.tiles_x + c1) * 256 + v);
  const float m1 = (float)__ldg(luts + (r1 * geo.tiles_x + c2) * 256 + v);
  const float m2 = (float)__ldg(luts + (r2 * geo.tiles_x + c1) * 256 + v);
  const float m3 = (float)__ldg(luts + (r2 * geo.tiles_x + c2) * 256 + v);
  const float wy = __ldg(ya + yb);
  return clahe_blend(m0, m1, m2, m3, __ldg(xa + xb), wy,
                     __fadd_rn(1.0f, -wy));
}

}  // namespace uie_detail
