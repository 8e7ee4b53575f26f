// Fused CLAHE apply + inverse LAB: each pixel's L goes through its four
// tile LUTs and OpenCV's f32 blend (csrc/clahe_blend.cuh, as the CLAHE
// apply kernel), is rounded and clamped to [0, 255], and with the pixel's
// a and b goes through OpenCV's integer Lab2RGBinteger
// (csrc/lab_inverse.cuh, as the u8 inverse kernel) -> u8-valued int32
// (r, g, b).  The mapped L never reaches device memory.
//
// Replaces: underwater_image_enhancement_tpu/ops/pallas_kernels.py,
//   clahe_lab_apply (kernel _make_clahe_lab_kernel).
//
// The TPU kernel runs on clahe's half-tile-padded band-block frame, with a
// and b padded into the same frame (ops/histeq.py _pad_bands), and the
// caller crops.  Here one thread computes one OUTPUT pixel of the
// unpadded (H, W) frame, which needs neither the padding of a/b nor the
// crop: the thread derives its band block from (y, x) as the CLAHE apply
// kernel does.
//
// Bound on an H100: memory.  Reads 3 i32 planes and writes 3 (24 bytes a
// pixel, 49.8 MB at 1920x1080, ~15 us at 3.35 TB/s); the split path (CLAHE
// apply then the u8 inverse) moves 32 bytes a pixel.  Design: one thread
// per pixel in a grid-stride loop over a few blocks per SM, so the
// inverse's 6 KB of tables (INV_TABLE_U8) are staged in shared memory
// once per block; the 64 KB of LUTs and the fractions are read through
// the read-only cache.

#include <cuda_runtime.h>

#include "clahe_blend.cuh"
#include "common.cuh"
#include "lab_inverse.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
clahe_lab_apply_kernel(const int* __restrict__ L, const int* __restrict__ a,
                       const int* __restrict__ b, const int* __restrict__ luts,
                       const float* __restrict__ ya,
                       const float* __restrict__ xa,
                       const int* __restrict__ tab, int* __restrict__ r_out,
                       int* __restrict__ g_out, int* __restrict__ b_out,
                       int H, int W, uie_detail::ClaheGeometry geo) {
  __shared__ __align__(16) uie_detail::LabInvTables s;
  uie_detail::stage_lab_inv_tables<kThreads>(s, tab);
  __syncthreads();

  const long long n = (long long)H * W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    // a 32-bit divide (n < 2^31, checked by csrc/bindings.cpp): the 64-bit
    // one is a long software routine on the card
    const int p = (int)i;
    const int y = p / W, x = p - y * W;
    const int Lm = uie_detail::clahe_pixel(L[i], y, x, luts, ya, xa, geo);
    int v8[3];
    uie_detail::lab_inv_pixel(s, Lm, a[i], b[i], v8);
    r_out[i] = v8[0];
    g_out[i] = v8[1];
    b_out[i] = v8[2];
  }
}

}  // namespace

namespace uie {

// Launch only; csrc/bindings.cpp checks the tensors and the launch.
void launch_clahe_lab_apply(const int* L, const int* a, const int* b,
                            const int* luts, const float* ya, const float* xa,
                            const int* tab, int* r, int* g, int* bb, int H,
                            int W, int th, int tw, int pt, int plf,
                            int tiles_x, int tiles_y, cudaStream_t stream) {
  const uie_detail::ClaheGeometry geo{th, tw, pt, plf, tiles_x, tiles_y};
  clahe_lab_apply_kernel<<<uie_detail::grid_for((long long)H * W, kThreads),
                           kThreads, 0, stream>>>(
      L, a, b, luts, ya, xa, tab, r, g, bb, H, W, geo);
}

}  // namespace uie
