// CLAHE apply: four tile-LUT lookups per pixel and OpenCV's f32 bilinear
// blend (csrc/clahe_blend.cuh), bit-exact against
// cv2.createCLAHE(...).apply on 8-bit planes.
//
// Replaces: underwater_image_enhancement_tpu/ops/pallas_kernels.py,
//   clahe_apply (kernel _clahe_apply_kernel, blend _cv_bilinear_f32).
//
// The TPU kernel walks a half-tile-padded "band-block" frame so that every
// block shares one set of four LUTs.  Here one thread computes one OUTPUT
// pixel (y, x) of the unpadded (H, W) plane: the band-frame crop
// [pt:pt+H, plf:plf+W] is the original plane, so the thread reads L[y, x]
// directly and derives its band block and four tiles from (y, x).
//
// Bound on an H100: memory.  4 bytes in and 4 bytes out a pixel (16.6 MB
// at 1920x1080, ~5 us at 3.35 TB/s); the 64 KB of LUTs stay in L1/L2.

#include <cuda_runtime.h>

#include "clahe_blend.cuh"

namespace {

__global__ void clahe_apply_kernel(const int* __restrict__ src,
                                   const int* __restrict__ luts,
                                   const float* __restrict__ ya,
                                   const float* __restrict__ xa,
                                   int* __restrict__ out, int H, int W,
                                   uie_detail::ClaheGeometry geo) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long p = (long long)y * W + x;
  out[p] = uie_detail::clahe_pixel(src[p], y, x, luts, ya, xa, geo);
}

}  // namespace

namespace uie {

// Launch only; csrc/bindings.cpp checks the tensors and the launch.
void launch_clahe_apply(const int* src, const int* luts, const float* ya,
                        const float* xa, int* out, int H, int W, int th,
                        int tw, int pt, int plf, int tiles_x, int tiles_y,
                        cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  const uie_detail::ClaheGeometry geo{th, tw, pt, plf, tiles_x, tiles_y};
  clahe_apply_kernel<<<grid, block, 0, stream>>>(src, luts, ya, xa, out, H, W,
                                                 geo);
}

}  // namespace uie
