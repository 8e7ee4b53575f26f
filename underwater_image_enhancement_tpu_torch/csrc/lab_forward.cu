// Forward LAB on float unit planes: OpenCV's integer RGB2Lab_b, bit-exact.
//
// Replaces: underwater_image_enhancement_tpu/ops/pallas_kernels.py,
//   lab_forward_planes_unit (_make_lab_forward / _make_lab_fwd_kernel).
//
// Per pixel: quantize each channel like (v*255).astype(uint8) (clip, then
// truncate), GAMMA_TAB gather, fixed-point COEFFS dot, descale, three
// CBRT_TAB gathers, L/a/b descale and clip.  Integer arithmetic is the JAX
// kernel's, op for op; `>>` on a negative int is arithmetic, as in XLA.
//
// Bound on an H100: memory.  It reads 3 f32 planes and writes 3 i32 planes,
// 24 bytes a pixel (49.8 MB at 1920x1080, ~15 us at 3.35 TB/s); the integer
// work is ~40 ops a pixel.  Design: one thread per pixel in a grid-stride
// loop over a few blocks per SM, so the 6 KB CBRT table (u16) and the
// 1 KB GAMMA table are staged into shared memory once per block rather
// than once per 256 pixels; shared memory (not __constant__) because the
// gather indices diverge within a warp.  The TPU kernel's 128-lane segment
// gathers and int32 packing are Mosaic workarounds and are not carried
// over.  Built without --use_fast_math: the f32 multiply must round.
//
// Table block (int32, ops/lab_tables.py FWD_TABLE):
//   [0] L_SCALE  [1] L_SHIFT  [2..10] COEFFS (3x3 row-major)
//   [11..266] GAMMA_TAB (256)  [267..3338] CBRT_TAB (3072)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeader = 11;
constexpr int kGamma = kHeader;
constexpr int kCbrt = kGamma + 256;
constexpr int kNcbrt = 3072;
constexpr int kLabShift = 12;
constexpr int kLabShift2 = 15;
constexpr int kThreads = 512;

__device__ __forceinline__ int descale(int v, int n) {
  return (v + (1 << (n - 1))) >> n;
}

__device__ __forceinline__ int clamp_i(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int quantize_u8(float v) {
  // jnp.clip(v * 255, 0, 255).astype(int32): truncation toward zero
  return (int)fminf(fmaxf(__fmul_rn(v, 255.0f), 0.0f), 255.0f);
}

__global__ void __launch_bounds__(kThreads)
lab_forward_unit_kernel(const float* __restrict__ r,
                        const float* __restrict__ g,
                        const float* __restrict__ b,
                        const int* __restrict__ tab,
                        int* __restrict__ L_out,
                        int* __restrict__ a_out,
                        int* __restrict__ b_out,
                        long long n) {
  __shared__ int s_gamma[256];
  __shared__ unsigned short s_cbrt[kNcbrt];
  __shared__ int s_head[kHeader];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_gamma[i] = tab[kGamma + i];
  for (int i = threadIdx.x; i < kNcbrt; i += blockDim.x)
    s_cbrt[i] = (unsigned short)tab[kCbrt + i];
  if (threadIdx.x < kHeader) s_head[threadIdx.x] = tab[threadIdx.x];
  __syncthreads();

  const int l_scale = s_head[0], l_shift = s_head[1];
  const int* C = s_head + 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int R = s_gamma[quantize_u8(r[i])];
    const int G = s_gamma[quantize_u8(g[i])];
    const int B = s_gamma[quantize_u8(b[i])];
    const int iX = clamp_i(descale(R * C[0] + G * C[1] + B * C[2], kLabShift), 0, kNcbrt - 1);
    const int iY = clamp_i(descale(R * C[3] + G * C[4] + B * C[5], kLabShift), 0, kNcbrt - 1);
    const int iZ = clamp_i(descale(R * C[6] + G * C[7] + B * C[8], kLabShift), 0, kNcbrt - 1);
    const int fX = s_cbrt[iX], fY = s_cbrt[iY], fZ = s_cbrt[iZ];
    L_out[i] = clamp_i(descale(l_scale * fY + l_shift, kLabShift2), 0, 255);
    a_out[i] = clamp_i(descale(500 * (fX - fY) + (128 << kLabShift2), kLabShift2), 0, 255);
    b_out[i] = clamp_i(descale(200 * (fY - fZ) + (128 << kLabShift2), kLabShift2), 0, 255);
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

// Launch only; csrc/bindings.cpp checks the tensors and the launch.
void launch_lab_forward_unit(const float* r, const float* g, const float* b,
                             const int* tab, int* L, int* a, int* bb,
                             long long n, cudaStream_t stream) {
  lab_forward_unit_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      r, g, b, tab, L, a, bb, n);
}

}  // namespace uie
