// CLAHE apply: four tile-LUT lookups per pixel and OpenCV's f32 bilinear
// blend, bit-exact against cv2.createCLAHE(...).apply on 8-bit planes.
//
// Replaces: underwater_image_enhancement_tpu/ops/pallas_kernels.py,
//   clahe_apply (kernel _clahe_apply_kernel, blend _cv_bilinear_f32).
//
// The TPU kernel walks a half-tile-padded "band-block" frame so that every
// block shares one set of four LUTs.  Here one thread computes one OUTPUT
// pixel (y, x) of the unpadded (H, W) plane: the band-frame crop
// [pt:pt+H, plf:plf+W] is the original plane, so the thread reads L[y, x]
// directly and derives its band block (i, j) = ((y+pt)/th, (x+plf)/tw) and
// the four tile ids from it (ops/histeq.py in the JAX package, r1/r2/c1/c2).
// The per-tile LUTs are the (T, 256) int32 tables the histogram stage
// built; ya/xa are the host-built f32 interpolation fractions in the band
// frame, indexed at y+pt and x+plf.
//
// The blend (m0*xa1 + m1*xa)*ya1 + (m2*xa1 + m3*xa)*ya is evaluated with
// __fmul_rn/__fadd_rn (and the file is built with -fmad=false): an FMA would
// move exact .5 ties in the final rintf (round half to even).
//
// Bound on an H100: memory.  4 bytes in and 4 bytes out a pixel (16.6 MB
// at 1920x1080, ~5 us at 3.35 TB/s); the 64 KB of LUTs stay in L1/L2.

#include <cuda_runtime.h>

namespace {

__global__ void clahe_apply_kernel(const int* __restrict__ src,
                                   const int* __restrict__ luts,
                                   const float* __restrict__ ya,
                                   const float* __restrict__ xa,
                                   int* __restrict__ out, int H, int W,
                                   int th, int tw, int pt, int plf,
                                   int tiles_x, int tiles_y) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int yb = y + pt, xb = x + plf;
  const int i = yb / th, j = xb / tw;
  const int r1 = min(max(i - 1, 0), tiles_y - 1);
  const int r2 = min(max(i, 0), tiles_y - 1);
  const int c1 = min(max(j - 1, 0), tiles_x - 1);
  const int c2 = min(max(j, 0), tiles_x - 1);
  const long long p = (long long)y * W + x;
  const int v = min(max(src[p], 0), 255);
  const float m0 = (float)__ldg(luts + (r1 * tiles_x + c1) * 256 + v);
  const float m1 = (float)__ldg(luts + (r1 * tiles_x + c2) * 256 + v);
  const float m2 = (float)__ldg(luts + (r2 * tiles_x + c1) * 256 + v);
  const float m3 = (float)__ldg(luts + (r2 * tiles_x + c2) * 256 + v);
  const float wy = __ldg(ya + yb), wx = __ldg(xa + xb);
  const float wy1 = __fadd_rn(1.0f, -wy), wx1 = __fadd_rn(1.0f, -wx);
  const float top = __fadd_rn(__fmul_rn(m0, wx1), __fmul_rn(m1, wx));
  const float bot = __fadd_rn(__fmul_rn(m2, wx1), __fmul_rn(m3, wx));
  const float val = __fadd_rn(__fmul_rn(top, wy1), __fmul_rn(bot, wy));
  out[p] = (int)fminf(fmaxf(rintf(val), 0.0f), 255.0f);
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
  clahe_apply_kernel<<<grid, block, 0, stream>>>(
      src, luts, ya, xa, out, H, W, th, tw, pt, plf, tiles_x, tiles_y);
}

}  // namespace uie
