// Inverse LAB: OpenCV's integer Lab2RGBinteger (csrc/lab_inverse.cuh) on
// int32 (L, a, b) planes, with three epilogues: the u8 values as int32
// (lab_inverse_u8), an IEEE f32 /255 (lab_inverse_unit), or a 256-entry
// f32 LUT gather that folds the six recipes' trailing out**gamma
// (lab_inverse_unit_gamma).
//
// Replaces: underwater_image_enhancement_tpu/ops/pallas_kernels.py,
//   lab_inverse_planes (K3b), lab_inverse_planes_unit (K3) and
//   lab_inverse_planes_unit_gamma (K3g) (_make_lab_inverse /
//   _make_lab_inverse_gamma / _make_lab_inv_kernel, integer body
//   _lab_inv_body).
//
// Per pixel: L2YF gather (y, ify), the a/b fixed-point divides, abToXZ,
// the COEFFS_INV dot, descale, INV_GAMMA_TAB gather.  The TPU kernel
// evaluates INV_GAMMA with an arithmetic surrogate plus the fix-ups of its
// probe (_corrections) because lane gathers are slow on Mosaic.  The
// port's probe K9 (ops/kernels.py surrogate_corrections, csrc/probe.cu)
// runs that surrogate on the card too, but the inverse kernels keep the
// table: on Hopper its 4 KB sit in shared memory and a gather costs one
// load, less than the ~45 f32 ops of the surrogate.
//
// Bound on an H100: memory.  It reads 3 i32 planes and writes 3 i32 or f32
// planes, 24 bytes a pixel (49.8 MB at 1920x1080, ~15 us at 3.35 TB/s).
// Design: one thread per pixel in a grid-stride loop over a few blocks per
// SM; L2Y/IFY (2 KB), INV_GAMMA (4 KB as u8) and the gamma LUT (1 KB) are
// staged in shared memory once per block.  Built without --use_fast_math:
// the unit output is the correctly rounded v / 255.0f.

#include <cuda_runtime.h>

#include "common.cuh"
#include "lab_inverse.cuh"

namespace {

constexpr int kThreads = 512;

// epilogues
constexpr int kOutU8 = 0;     // int32 u8 values (K3b)
constexpr int kOutUnit = 1;   // f32 v / 255 (K3)
constexpr int kOutGamma = 2;  // f32 glut[v] (K3g)

template <typename Out, int kOut>
__global__ void __launch_bounds__(kThreads)
lab_inverse_kernel(const int* __restrict__ L, const int* __restrict__ a,
                   const int* __restrict__ b, const int* __restrict__ tab,
                   const float* __restrict__ glut, Out* __restrict__ r_out,
                   Out* __restrict__ g_out, Out* __restrict__ b_out,
                   long long n) {
  __shared__ uie_detail::LabInvTables s;
  __shared__ float s_glut[kOut == kOutGamma ? 256 : 1];
  uie_detail::stage_lab_inv_tables(s, tab);
  if (kOut == kOutGamma)
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s_glut[i] = glut[i];
  __syncthreads();

  Out* outs[3] = {r_out, g_out, b_out};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int v8[3];
    uie_detail::lab_inv_pixel(s, L[i], a[i], b[i], v8);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if constexpr (kOut == kOutU8)
        outs[ch][i] = v8[ch];
      else if constexpr (kOut == kOutGamma)
        outs[ch][i] = s_glut[v8[ch]];
      else
        outs[ch][i] = __fdiv_rn((float)v8[ch], 255.0f);
    }
  }
}

template <typename Out, int kOut>
void launch(const int* L, const int* a, const int* b, const int* tab,
            const float* glut, Out* r, Out* g, Out* bb, long long n,
            cudaStream_t stream) {
  lab_inverse_kernel<Out, kOut>
      <<<uie_detail::grid_for(n, kThreads), kThreads, 0, stream>>>(
          L, a, b, tab, glut, r, g, bb, n);
}

}  // namespace

namespace uie {

// Launch only; csrc/bindings.cpp checks the tensors and the launch.  glut
// is the (256,) f32 gamma table, or nullptr for the plain /255 output.
void launch_lab_inverse_unit(const int* L, const int* a, const int* b,
                             const int* tab, const float* glut, float* r,
                             float* g, float* bb, long long n,
                             cudaStream_t stream) {
  if (glut == nullptr)
    launch<float, kOutUnit>(L, a, b, tab, nullptr, r, g, bb, n, stream);
  else
    launch<float, kOutGamma>(L, a, b, tab, glut, r, g, bb, n, stream);
}

void launch_lab_inverse_u8(const int* L, const int* a, const int* b,
                           const int* tab, int* r, int* g, int* bb,
                           long long n, cudaStream_t stream) {
  launch<int, kOutU8>(L, a, b, tab, nullptr, r, g, bb, n, stream);
}

}  // namespace uie
