// Inverse LAB to float unit planes: OpenCV's integer Lab2RGBinteger, then
// an IEEE f32 /255 (lab_inverse_unit) or a 256-entry f32 LUT gather that
// folds the six recipes' trailing out**gamma (lab_inverse_unit_gamma).
//
// Replaces: underwater_image_enhancement_tpu/ops/pallas_kernels.py,
//   lab_inverse_planes_unit and lab_inverse_planes_unit_gamma
//   (_make_lab_inverse / _make_lab_inverse_gamma / _make_lab_inv_kernel,
//   integer body _lab_inv_body).
//
// Per pixel: L2YF gather (y, ify), the a/b fixed-point divides, abToXZ,
// the COEFFS_INV dot, descale, INV_GAMMA_TAB gather.  The JAX kernel's
// _ctrunc_div is an exact emulation of C's truncating integer division,
// so here it is plain `/`.  The TPU kernel evaluates INV_GAMMA with an
// arithmetic surrogate plus probe-found fix-ups (its K9 probe) because
// lane gathers are slow on Mosaic; on Hopper the 4 KB table sits in shared
// memory and needs neither.
//
// Bound on an H100: memory.  It reads 3 i32 planes and writes 3 f32
// planes, 24 bytes a pixel (49.8 MB at 1920x1080, ~15 us at 3.35 TB/s).
// Design: one thread per pixel in a grid-stride loop over a few blocks per
// SM; L2Y/IFY (2 KB), INV_GAMMA (4 KB as u8) and the gamma LUT (1 KB) are
// staged in shared memory once per block.  Built without
// --use_fast_math: the unit output is the correctly rounded v / 255.0f.
//
// Table block (int32, ops/lab_tables.py INV_TABLE):
//   [0..8] COEFFS_INV (3x3 row-major)  [9] MIN_AB  [10] AB_MAX
//   [11] AB_LIN_THRESH  [12] AB_LIN_K  [13] ADIV_OFFSET  [14] BDIV_OFFSET
//   [15..270] L2Y  [271..526] L2IFY  [527..4622] INV_GAMMA_TAB (4096)

#include <cuda_runtime.h>

namespace {

constexpr int kHeader = 15;
constexpr int kL2y = kHeader;
constexpr int kIfy = kL2y + 256;
constexpr int kIg = kIfy + 256;
constexpr int kIgSize = 4096;
constexpr int kBase = 1 << 14;
constexpr int kThreads = 512;

__device__ __forceinline__ int descale(int v, int n) {
  return (v + (1 << (n - 1))) >> n;
}

__device__ __forceinline__ int ab_to_xz(int v, const int* h) {
  v = min(max(v, h[9]), h[10]);
  if (v <= h[11]) return (v * 108) / 841 - h[12];
  return ((v * v) / kBase * v) / kBase;
}

template <bool kGammaLut>
__global__ void __launch_bounds__(kThreads)
lab_inverse_unit_kernel(const int* __restrict__ L, const int* __restrict__ a,
                        const int* __restrict__ b, const int* __restrict__ tab,
                        const float* __restrict__ glut,
                        float* __restrict__ r_out, float* __restrict__ g_out,
                        float* __restrict__ b_out, long long n) {
  __shared__ int s_head[kHeader];
  __shared__ int s_y[256];
  __shared__ int s_ify[256];
  __shared__ unsigned char s_ig[kIgSize];
  __shared__ float s_glut[256];
  if (threadIdx.x < kHeader) s_head[threadIdx.x] = tab[threadIdx.x];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_y[i] = tab[kL2y + i];
    s_ify[i] = tab[kIfy + i];
    if (kGammaLut) s_glut[i] = glut[i];
  }
  for (int i = threadIdx.x; i < kIgSize; i += blockDim.x)
    s_ig[i] = (unsigned char)tab[kIg + i];
  __syncthreads();

  const int* C = s_head;
  float* outs[3] = {r_out, g_out, b_out};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int Lc = min(max(L[i], 0), 255);
    const int y = s_y[Lc], ify = s_ify[Lc];
    const int av = a[i], bv = b[i];
    const int adiv = ((5 * av * 53687 + (1 << 7)) >> 13) - s_head[13];
    const int bdiv = ((bv * 41943 + (1 << 4)) >> 9) - s_head[14];
    const int x = ab_to_xz(ify + adiv, s_head);
    const int z = ab_to_xz(ify - bdiv, s_head);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      int idx = descale(x * C[3 * ch] + y * C[3 * ch + 1] + z * C[3 * ch + 2], 14);
      idx = min(max(idx, 0), kIgSize - 1);
      const int v8 = s_ig[idx];
      outs[ch][i] = kGammaLut ? s_glut[v8] : __fdiv_rn((float)v8, 255.0f);
    }
  }
}

int grid_for(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  long long cap = (long long)sms * 4;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
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
    lab_inverse_unit_kernel<false><<<grid_for(n), kThreads, 0, stream>>>(
        L, a, b, tab, nullptr, r, g, bb, n);
  else
    lab_inverse_unit_kernel<true><<<grid_for(n), kThreads, 0, stream>>>(
        L, a, b, tab, glut, r, g, bb, n);
}

}  // namespace uie
