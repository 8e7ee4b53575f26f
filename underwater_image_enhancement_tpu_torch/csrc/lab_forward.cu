// Forward LAB: OpenCV's integer RGB2Lab_b, bit-exact, on float unit planes
// or on u8-valued int32 planes, and the six --fast tier's approximate
// variant.
//
// Replaces (underwater_image_enhancement_tpu/ops/pallas_kernels.py, all
// built by _make_lab_forward / _make_lab_fwd_kernel):
//   lab_forward_planes_unit (K1): f32 unit planes -> (L, a, b);
//   lab_forward_planes_unit_approx (K8 _approx): K1 with cbrt_corr="approx2",
//     CBRT_TAB evaluated by _cbrt_tab_surrogate(idx, steps=2), no
//     corrections; within +-1 u8 LSB of the exact table;
//   lab_forward_planes (K1b): u8-valued int32 planes (clipped to [0, 255])
//     -> (L, a, b);
//   lab_forward_l_plane (K4): K1b's L plane alone (one CBRT gather, one
//     output plane), the brightness metric's input.
//
// Per pixel: bring each channel to a u8 index (f32: quantize like
// (v*255).astype(uint8), clip then truncate; int32: clip to [0, 255]),
// GAMMA_TAB gather, fixed-point COEFFS dot, descale, the cube roots
// (CBRT_TAB gathers, or the surrogate), L/a/b descale and clip.  Integer
// arithmetic is the JAX kernel's, op for op; `>>` on a negative int is
// arithmetic, as in XLA.  The surrogate rounds every multiply and add on
// its own (__fmul_rn/__fsub_rn/__fadd_rn), in the JAX order, and rounds
// half to even (jnp.round); its constants are the f32 values numpy gives,
// written in hex.
//
// Bound on an H100: memory.  K1, K8 and K1b read 3 planes and write 3
// (24 bytes a pixel, 49.8 MB at 1920x1080, ~15 us at 3.35 TB/s); K4 reads
// 3 and writes 1 (16 bytes a pixel, 33.2 MB, ~9.9 us).  The exact integer
// work is ~40 ops a pixel (~20 for K4); the surrogate adds ~20 f32 ops per
// cube root (~100 a pixel).  Design: one thread per pixel in a grid-stride
// loop over a few blocks per SM, so the 6 KB CBRT table (u16) and the 1 KB
// GAMMA table are staged into shared memory once per block rather than
// once per 256 pixels; shared memory (not __constant__) because the gather
// indices diverge within a warp.  One template serves the four kernels:
// the input type, the cube root and the L-only epilogue are its
// parameters; the approximate variant stages only GAMMA.  The TPU kernel's
// 128-lane segment gathers and int32 packing are Mosaic workarounds and
// are not carried over.  Built without --use_fast_math: the f32 multiply
// must round.
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

// np.float32 constants of pallas_kernels._cbrt_tab_surrogate / _rcbrt
constexpr float kInv2040 = 0x1.010102p-11f;    // 1.0 / 2040.0
constexpr float kTiny = 0x1.4484cp-100f;       // 1e-30
constexpr float kThird = 0x1.555556p-2f;       // 1.0 / 3.0
constexpr float kLinThresh = 0x1.223184p-7f;   // 0.008856
constexpr float kLinSlope = 0x1.f25e36p+2f;    // 7.787
constexpr float kLinOffset = 0x1.1a7b96p-3f;   // 16.0 / 116.0

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

// _cbrt_tab_surrogate(idx, steps=2): round(labF(idx/2040) * 2^15), the
// cube root as t * rcbrt(t)^2 with rcbrt from the bit-trick seed
// 0x54A21D2A - bits/3 and two division-free Newton steps
// r <- r * ((4 - t*r^2*r) * (1/3)).
__device__ __forceinline__ int cbrt_approx(int idx) {
  const float t = __fmul_rn((float)idx, kInv2040);
  float f;
  if (t < kLinThresh) {
    f = __fadd_rn(__fmul_rn(t, kLinSlope), kLinOffset);
  } else {
    const float tc = fmaxf(t, kTiny);
    // bits of a positive float: C's truncating / equals jnp's floor //
    float r = __int_as_float(0x54A21D2A - __float_as_int(tc) / 3);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float t_r3 = __fmul_rn(__fmul_rn(tc, __fmul_rn(r, r)), r);
      r = __fmul_rn(r, __fmul_rn(__fsub_rn(4.0f, t_r3), kThird));
    }
    f = __fmul_rn(tc, __fmul_rn(r, r));
  }
  return __float2int_rn(__fmul_rn(f, 32768.0f));  // jnp.round: half to even
}

// A channel value -> its u8 index.
__device__ __forceinline__ int to_u8(float v) { return quantize_u8(v); }
__device__ __forceinline__ int to_u8(int v) { return clamp_i(v, 0, 255); }

template <typename In, bool kApprox, bool kLOnly>
__global__ void __launch_bounds__(kThreads)
lab_forward_kernel(const In* __restrict__ r, const In* __restrict__ g,
                   const In* __restrict__ b, const int* __restrict__ tab,
                   int* __restrict__ L_out, int* __restrict__ a_out,
                   int* __restrict__ b_out, long long n) {
  __shared__ int s_gamma[256];
  __shared__ unsigned short s_cbrt[kApprox ? 1 : kNcbrt];
  __shared__ int s_head[kHeader];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_gamma[i] = tab[kGamma + i];
  if (!kApprox) {
    for (int i = threadIdx.x; i < kNcbrt; i += blockDim.x)
      s_cbrt[i] = (unsigned short)tab[kCbrt + i];
  }
  if (threadIdx.x < kHeader) s_head[threadIdx.x] = tab[threadIdx.x];
  __syncthreads();

  const int l_scale = s_head[0], l_shift = s_head[1];
  const int* C = s_head + 2;
  // the labF cube root of COEFFS row `row` applied to (R, G, B)
  auto cube_root = [&](int row, int R, int G, int B) -> int {
    const int idx = clamp_i(
        descale(R * C[3 * row] + G * C[3 * row + 1] + B * C[3 * row + 2], kLabShift),
        0, kNcbrt - 1);
    if constexpr (kApprox) {
      return cbrt_approx(idx);
    } else {
      return s_cbrt[idx];
    }
  };
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int R = s_gamma[to_u8(r[i])];
    const int G = s_gamma[to_u8(g[i])];
    const int B = s_gamma[to_u8(b[i])];
    const int fY = cube_root(1, R, G, B);
    L_out[i] = clamp_i(descale(l_scale * fY + l_shift, kLabShift2), 0, 255);
    if (!kLOnly) {
      const int fX = cube_root(0, R, G, B);
      const int fZ = cube_root(2, R, G, B);
      a_out[i] = clamp_i(descale(500 * (fX - fY) + (128 << kLabShift2), kLabShift2), 0, 255);
      b_out[i] = clamp_i(descale(200 * (fY - fZ) + (128 << kLabShift2), kLabShift2), 0, 255);
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

// Launch only; csrc/bindings.cpp checks the tensors and the launch.
void launch_lab_forward_unit(const float* r, const float* g, const float* b,
                             const int* tab, int* L, int* a, int* bb,
                             long long n, bool approx, cudaStream_t stream) {
  if (approx) {
    lab_forward_kernel<float, true, false><<<grid_for(n), kThreads, 0, stream>>>(
        r, g, b, tab, L, a, bb, n);
  } else {
    lab_forward_kernel<float, false, false><<<grid_for(n), kThreads, 0, stream>>>(
        r, g, b, tab, L, a, bb, n);
  }
}

// u8-valued int32 planes; l_only writes L alone (a and bb may be null).
void launch_lab_forward_u8(const int* r, const int* g, const int* b,
                           const int* tab, int* L, int* a, int* bb,
                           long long n, bool l_only, cudaStream_t stream) {
  if (l_only) {
    lab_forward_kernel<int, false, true><<<grid_for(n), kThreads, 0, stream>>>(
        r, g, b, tab, L, a, bb, n);
  } else {
    lab_forward_kernel<int, false, false><<<grid_for(n), kThreads, 0, stream>>>(
        r, g, b, tab, L, a, bb, n);
  }
}

}  // namespace uie
