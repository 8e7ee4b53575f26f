// Forward LAB: OpenCV's integer RGB2Lab_b, bit-exact, on float unit planes
// or on u8-valued int32 planes, and the variants whose cube root is an
// arithmetic surrogate of the CBRT table.
//
// Replaces (underwater_image_enhancement_tpu/ops/pallas_kernels.py, all
// built by _make_lab_forward / _make_lab_fwd_kernel):
//   lab_forward_planes_unit (K1): f32 unit planes -> (L, a, b);
//   lab_forward_planes_unit_approx (K8 _approx): K1 with cbrt_corr="approx2",
//     CBRT_TAB evaluated by _cbrt_tab_surrogate(idx, steps=2), no
//     corrections; within +-1 u8 LSB of the exact table;
//   lab_forward_planes_unit_fast (K8 _fast): K1 with CBRT_TAB evaluated by
//     _cbrt_tab_surrogate(idx, steps=4) plus the probe's (index, delta)
//     fix-ups (_apply_corrections; the probe is csrc/probe.cu), so equal
//     to the table by construction;
//   lab_forward_planes (K1b): u8-valued int32 planes (clipped to [0, 255])
//     -> (L, a, b);
//   lab_forward_l_plane (K4): K1b's L plane alone (one CBRT gather, one
//     output plane), the brightness metric's input.
//
// Per pixel: bring each channel to a u8 index (f32: quantize like
// (v*255).astype(uint8), clip then truncate; int32: clip to [0, 255]),
// GAMMA_TAB gather, fixed-point COEFFS dot, descale, the cube roots
// (CBRT_TAB gathers, or the surrogate of csrc/surrogates.cuh), L/a/b
// descale and clip.  Integer arithmetic is the JAX kernel's, op for op.
//
// Bound on an H100: memory.  K1, K8 and K1b read 3 planes and write 3
// (24 bytes a pixel, 49.8 MB at 1920x1080, ~15 us at 3.35 TB/s); K4 reads
// 3 and writes 1 (16 bytes a pixel, 33.2 MB, ~9.9 us).  The exact integer
// work is ~40 ops a pixel (~20 for K4); the surrogate adds ~20 f32 ops per
// cube root at 2 steps, ~35 at 4 (~100 and ~150 a pixel).  Design: one
// thread per pixel in a grid-stride loop over a few blocks per SM, so the
// 6 KB CBRT table (u16) and the 1 KB GAMMA table are staged into shared
// memory once per block rather than once per 256 pixels; shared memory
// (not __constant__) because the gather indices diverge within a warp.
// One template serves the five kernels: the input type, the cube-root
// policy and the L-only epilogue are its parameters; the surrogate
// policies stage GAMMA and, for K8 _fast, the at most 32 fix-ups.  The
// TPU kernel's 128-lane segment gathers and int32 packing are Mosaic
// workarounds and are not carried over.  Built without --use_fast_math:
// the f32 multiply must round.
//
// Table block (int32, ops/lab_tables.py FWD_TABLE):
//   [0] L_SCALE  [1] L_SHIFT  [2..10] COEFFS (3x3 row-major)
//   [11..266] GAMMA_TAB (256)  [267..3338] CBRT_TAB (3072)

#include <cuda_runtime.h>

#include "common.cuh"
#include "surrogates.cuh"

namespace {

using uie_detail::clamp_i;
using uie_detail::descale;

constexpr int kHeader = 11;
constexpr int kGamma = kHeader;
constexpr int kCbrt = kGamma + 256;
constexpr int kNcbrt = 3072;
constexpr int kLabShift = 12;
constexpr int kLabShift2 = 15;
constexpr int kThreads = 512;
constexpr int kMaxFix = 32;  // ops/kernels.py MAX_CORRECTIONS

// cube-root policies
constexpr int kCbrtTable = 0;      // CBRT_TAB gather (K1, K1b, K4)
constexpr int kCbrtApprox = 1;     // 2-step surrogate (K8 _approx)
constexpr int kCbrtCorrected = 2;  // 4-step surrogate + fix-ups (K8 _fast)

__device__ __forceinline__ int quantize_u8(float v) {
  // jnp.clip(v * 255, 0, 255).astype(int32): truncation toward zero
  return (int)fminf(fmaxf(__fmul_rn(v, 255.0f), 0.0f), 255.0f);
}

// A channel value -> its u8 index.
__device__ __forceinline__ int to_u8(float v) { return quantize_u8(v); }
__device__ __forceinline__ int to_u8(int v) { return clamp_i(v, 0, 255); }

// fix: (2, n_fix) int32, the probe's indices then deltas (kCbrtCorrected)
template <typename In, int kCbrtPolicy, bool kLOnly>
__global__ void __launch_bounds__(kThreads)
lab_forward_kernel(const In* __restrict__ r, const In* __restrict__ g,
                   const In* __restrict__ b, const int* __restrict__ tab,
                   const int* __restrict__ fix, int n_fix,
                   int* __restrict__ L_out, int* __restrict__ a_out,
                   int* __restrict__ b_out, long long n) {
  constexpr bool kTable = kCbrtPolicy == kCbrtTable;
  __shared__ int s_gamma[256];
  __shared__ unsigned short s_cbrt[kTable ? kNcbrt : 1];
  __shared__ int s_head[kHeader];
  __shared__ int s_fix[2 * kMaxFix];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_gamma[i] = tab[kGamma + i];
  if (kTable) {
    for (int i = threadIdx.x; i < kNcbrt; i += blockDim.x)
      s_cbrt[i] = (unsigned short)tab[kCbrt + i];
  }
  if (kCbrtPolicy == kCbrtCorrected && threadIdx.x < 2 * n_fix)
    s_fix[threadIdx.x] = fix[threadIdx.x];
  if (threadIdx.x < kHeader) s_head[threadIdx.x] = tab[threadIdx.x];
  __syncthreads();

  const int l_scale = s_head[0], l_shift = s_head[1];
  const int* C = s_head + 2;
  // the labF cube root of COEFFS row `row` applied to (R, G, B)
  auto cube_root = [&](int row, int R, int G, int B) -> int {
    const int idx = clamp_i(
        descale(R * C[3 * row] + G * C[3 * row + 1] + B * C[3 * row + 2], kLabShift),
        0, kNcbrt - 1);
    if constexpr (kCbrtPolicy == kCbrtApprox) {
      return uie_detail::cbrt_tab_surrogate<2>(idx);
    } else if constexpr (kCbrtPolicy == kCbrtCorrected) {
      int v = uie_detail::cbrt_tab_surrogate<4>(idx);
      for (int k = 0; k < n_fix; ++k)
        v += idx == s_fix[k] ? s_fix[n_fix + k] : 0;
      return v;
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

template <typename In, int kCbrtPolicy, bool kLOnly>
void launch(const In* r, const In* g, const In* b, const int* tab,
            const int* fix, int n_fix, int* L, int* a, int* bb, long long n,
            cudaStream_t stream) {
  lab_forward_kernel<In, kCbrtPolicy, kLOnly>
      <<<uie_detail::grid_for(n, kThreads), kThreads, 0, stream>>>(
          r, g, b, tab, fix, n_fix, L, a, bb, n);
}

}  // namespace

namespace uie {

// Launch only; csrc/bindings.cpp checks the tensors and the launch.
// cbrt: 0 table (K1), 1 two-step surrogate (K8 _approx), 2 four-step
// surrogate plus the (2, n_fix) fix-ups `fix` (K8 _fast).
void launch_lab_forward_unit(const float* r, const float* g, const float* b,
                             const int* tab, const int* fix, int n_fix,
                             int* L, int* a, int* bb, long long n, int cbrt,
                             cudaStream_t stream) {
  if (cbrt == kCbrtApprox)
    launch<float, kCbrtApprox, false>(r, g, b, tab, fix, 0, L, a, bb, n, stream);
  else if (cbrt == kCbrtCorrected)
    launch<float, kCbrtCorrected, false>(r, g, b, tab, fix, n_fix, L, a, bb, n,
                                         stream);
  else
    launch<float, kCbrtTable, false>(r, g, b, tab, fix, 0, L, a, bb, n, stream);
}

// u8-valued int32 planes; l_only writes L alone (a and bb may be null).
void launch_lab_forward_u8(const int* r, const int* g, const int* b,
                           const int* tab, int* L, int* a, int* bb,
                           long long n, bool l_only, cudaStream_t stream) {
  if (l_only)
    launch<int, kCbrtTable, true>(r, g, b, tab, nullptr, 0, L, a, bb, n, stream);
  else
    launch<int, kCbrtTable, false>(r, g, b, tab, nullptr, 0, L, a, bb, n, stream);
}

}  // namespace uie
