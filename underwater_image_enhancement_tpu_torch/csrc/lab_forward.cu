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
// cube root at 2 steps, ~35 at 4 (~100 and ~150 a pixel).
//
// Design (one template for the five kernels: the input type, the
// cube-root policy and the L-only epilogue are its parameters; the ring's
// pieces are csrc/bulk_ring.cuh, shared with csrc/lab_inverse.cu):
// - one wave: the grid is the instantiation's resident blocks
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, once a device),
//   so no block starts late, and each block stages its tables once;
// - bytes in flight without registers: a block streams tiles of 1024
//   pixels (blockIdx.x, then gridDim.x apart) through a ring of three
//   stages in shared memory, each plane's 4 KB of a tile one bulk copy
//   (cp.async.bulk, the 1D TMA) completing on the stage's mbarrier; a
//   thread reads its 4 adjacent pixels of each plane as one 16-byte
//   vector, hands the stage back to the next tile (after a proxy fence:
//   the bulk copy must not overtake the reads), computes, and stores
//   16-byte vectors;
// - tables off the critical path: the first three tiles' copies are issued
//   before the block stages its tables, 16 bytes a thread, from a table
//   block laid out for it (ops/lab_tables.py FWD_TABLE_U16: the header,
//   the 256 GAMMA entries and, for the table policy, the 3072 CBRT entries
//   as u16, 7.2 KB; the surrogate policies stage the first 1 KB), and K8
//   _fast turns its at most 32 fix-ups into a 3072-entry delta table, one
//   gather a cube root instead of a loop over the fix-ups; shared memory,
//   not __constant__, because the gather indices diverge within a warp;
// - the ragged end and misaligned planes: the pixels past the last whole
//   tile run through the kernel's scalar loop, and so does the whole call
//   where a plane does not start on 16 bytes (a view at an odd offset);
//   nothing leaves the kernel.
// The TPU kernel's 128-lane segment gathers and int32 packing are Mosaic
// workarounds and are not carried over.  Built without --use_fast_math:
// the f32 multiply must round.
//
// Table block (int32, ops/lab_tables.py FWD_TABLE_U16):
//   [0] L_SCALE  [1] L_SHIFT  [2..10] COEFFS (3x3 row-major)  [11] 0
//   [12..267] GAMMA_TAB (256)  [268..1803] CBRT_TAB (3072 u16, two an int)

#include <cuda_runtime.h>

#include "bulk_ring.cuh"
#include "common.cuh"
#include "surrogates.cuh"

namespace {

using uie_detail::aligned16;
using uie_detail::bar_expect;
using uie_detail::bar_fence_init;
using uie_detail::bar_init;
using uie_detail::bar_wait;
using uie_detail::bulk_load;
using uie_detail::clamp_i;
using uie_detail::descale;
using uie_detail::lane;
using uie_detail::proxy_fence;
using uie_detail::Vec4;

constexpr int kGamma = 12;
constexpr int kHead = kGamma + 256;
constexpr int kNcbrt = 3072;
constexpr int kTabInts = kHead + kNcbrt / 2;
constexpr int kLabShift = 12;
constexpr int kLabShift2 = 15;
constexpr int kThreads = 256;
constexpr int kTile = 4 * kThreads;  // pixels a tile: a 16-byte vector a thread
constexpr int kStages = 3;           // tiles in flight a block
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

// n pixels: ntiles whole tiles of kTile from the planes' start (0 where a
// plane is not 16-byte aligned), streamed through a ring of kStages tiles
// in shared memory, then the rest one pixel a thread.  A block takes the
// tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// fix: (2, n_fix) int32, the probe's indices then deltas (kCbrtCorrected)
template <typename In, int kCbrtPolicy, bool kLOnly>
__global__ void __launch_bounds__(kThreads)
lab_forward_kernel(const In* __restrict__ r, const In* __restrict__ g,
                   const In* __restrict__ b, const int* __restrict__ tab,
                   const int* __restrict__ fix, int n_fix,
                   int* __restrict__ L_out, int* __restrict__ a_out,
                   int* __restrict__ b_out, long long n, long long ntiles) {
  using V = typename Vec4<In>::type;
  constexpr bool kTable = kCbrtPolicy == kCbrtTable;
  constexpr bool kCorrected = kCbrtPolicy == kCbrtCorrected;
  __shared__ __align__(128) In s_ring[kStages][3][kTile];
  __shared__ __align__(8) unsigned long long s_full[kStages];
  // the staged table (FWD_TABLE_U16, or its first kHead ints) and K8
  // _fast's deltas by cube-root index
  __shared__ __align__(16) int s_tab[kTable ? kTabInts : kHead];
  __shared__ __align__(16) short s_delta[kCorrected ? kNcbrt : 1];
  __shared__ int s_fix[kCorrected ? 2 * kMaxFix : 1];

  const long long mine = blockIdx.x < ntiles
                             ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  // tile i of this block into its stage of the ring
  auto issue = [&](long long i) {
    const int s = (int)(i % kStages);
    const long long px = (blockIdx.x + i * gridDim.x) * kTile;
    bar_expect(&s_full[s], 3 * kTile * sizeof(In));
    bulk_load(s_ring[s][0], r + px, kTile * sizeof(In), &s_full[s]);
    bulk_load(s_ring[s][1], g + px, kTile * sizeof(In), &s_full[s]);
    bulk_load(s_ring[s][2], b + px, kTile * sizeof(In), &s_full[s]);
  };
  // the first tiles' loads go out before the tables are staged
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&s_full[s]);
    bar_fence_init();
    for (int i = 0; i < kStages && i < mine; ++i) issue(i);
  }

  // the tables, 16 bytes a thread (the block's base is 16-byte aligned);
  // K8 _fast's fix-ups summed into deltas by index
  constexpr int kChunks = (kTable ? kTabInts : kHead) / 4;
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
    if (c < kChunks) reinterpret_cast<int4*>(s_tab)[c] = chunk[k];
  }
  if constexpr (kCorrected) {
    for (int c = threadIdx.x; c < kNcbrt / 8; c += kThreads)
      reinterpret_cast<int4*>(s_delta)[c] = make_int4(0, 0, 0, 0);
    if (threadIdx.x < 2 * n_fix) s_fix[threadIdx.x] = fix[threadIdx.x];
    __syncthreads();
    // fix-up k writes the sum of the deltas at its index, once
    if (threadIdx.x < n_fix) {
      const int i = s_fix[threadIdx.x];
      int sum = 0;
      bool first = true;
      for (int k = 0; k < n_fix; ++k) {
        if (s_fix[k] != i) continue;
        first = first && k >= (int)threadIdx.x;
        sum += s_fix[n_fix + k];
      }
      if (first && i >= 0 && i < kNcbrt) s_delta[i] = (short)sum;
    }
  }
  __syncthreads();
  const int* s_head = s_tab;
  const int* s_gamma = s_tab + kGamma;
  const unsigned short* s_cbrt =
      reinterpret_cast<const unsigned short*>(s_tab + kHead);

  const int l_scale = s_head[0], l_shift = s_head[1];
  const int* C = s_head + 2;
  // the labF cube root of COEFFS row `row` applied to (R, G, B)
  auto cube_root = [&](int row, int R, int G, int B) -> int {
    const int idx = clamp_i(
        descale(R * C[3 * row] + G * C[3 * row + 1] + B * C[3 * row + 2], kLabShift),
        0, kNcbrt - 1);
    if constexpr (kCbrtPolicy == kCbrtApprox) {
      return uie_detail::cbrt_tab_surrogate<2>(idx);
    } else if constexpr (kCorrected) {
      return uie_detail::cbrt_tab_surrogate<4>(idx) + s_delta[idx];
    } else {
      return s_cbrt[idx];
    }
  };
  // one pixel: (L, a, b), a and b left alone for kLOnly
  auto lab = [&](In rv, In gv, In bv, int& Lo, int& ao, int& bo) {
    const int R = s_gamma[to_u8(rv)];
    const int G = s_gamma[to_u8(gv)];
    const int B = s_gamma[to_u8(bv)];
    const int fY = cube_root(1, R, G, B);
    Lo = clamp_i(descale(l_scale * fY + l_shift, kLabShift2), 0, 255);
    if (!kLOnly) {
      const int fX = cube_root(0, R, G, B);
      const int fZ = cube_root(2, R, G, B);
      ao = clamp_i(descale(500 * (fX - fY) + (128 << kLabShift2), kLabShift2), 0, 255);
      bo = clamp_i(descale(200 * (fY - fZ) + (128 << kLabShift2), kLabShift2), 0, 255);
    }
  };

  for (long long i = 0; i < mine; ++i) {
    const int s = (int)(i % kStages);
    bar_wait(&s_full[s], (unsigned)((i / kStages) & 1));
    V x[3];
#pragma unroll
    for (int p = 0; p < 3; ++p)
      x[p] = reinterpret_cast<const V*>(s_ring[s][p])[threadIdx.x];
    // every thread has its vector: the stage takes the block's next tile.
    // The proxy fence orders this thread's reads of the stage before the
    // bulk copy that overwrites it (without it, repeated calls on 4096^2
    // planes read a few vectors of the next tile)
    proxy_fence();
    __syncthreads();
    if (threadIdx.x == 0 && i + kStages < mine) issue(i + kStages);
    int o[3][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      lab(lane(x[0], k), lane(x[1], k), lane(x[2], k), o[0][k], o[1][k],
          o[2][k]);
    const long long v = (blockIdx.x + i * gridDim.x) * kThreads + threadIdx.x;
    reinterpret_cast<int4*>(L_out)[v] = make_int4(o[0][0], o[0][1], o[0][2], o[0][3]);
    if (!kLOnly) {
      reinterpret_cast<int4*>(a_out)[v] = make_int4(o[1][0], o[1][1], o[1][2], o[1][3]);
      reinterpret_cast<int4*>(b_out)[v] = make_int4(o[2][0], o[2][1], o[2][2], o[2][3]);
    }
  }
  // the pixels past the last whole tile (all of them when ntiles is 0)
  for (long long i = ntiles * kTile + (long long)blockIdx.x * kThreads +
                     threadIdx.x;
       i < n; i += (long long)gridDim.x * kThreads) {
    int Lo, ao, bo;
    lab(__ldg(r + i), __ldg(g + i), __ldg(b + i), Lo, ao, bo);
    L_out[i] = Lo;
    if (!kLOnly) a_out[i] = ao, b_out[i] = bo;
  }
}

// Blocks of the instantiation resident on the current device, all SMs
// together: its grid, so that every block runs in the first wave.
template <typename In, int kCbrtPolicy, bool kLOnly>
int resident_blocks() {
  static int cache[uie_detail::kMaxDevices] = {};
  return uie_detail::resident_blocks(
      lab_forward_kernel<In, kCbrtPolicy, kLOnly>, kThreads, cache);
}

// The launch of n pixels: its whole tiles (0 unless every plane starts
// on 16 bytes) and its grid (the resident blocks, or fewer for a small
// call).
template <typename In, int kCbrtPolicy, bool kLOnly>
void plan(const In* r, const In* g, const In* b, const int* L, const int* a,
          const int* bb, long long n, long long* ntiles, int* grid) {
  const bool vec = aligned16(r) && aligned16(g) && aligned16(b) &&
                   aligned16(L) && (kLOnly || (aligned16(a) && aligned16(bb)));
  *ntiles = vec ? n / kTile : 0;
  // a block's work: tiles, or kThreads pixels of the rest a round
  const long long rest = (n - *ntiles * kTile + kThreads - 1) / kThreads;
  const long long want = *ntiles > rest ? *ntiles : rest;
  const int cap = resident_blocks<In, kCbrtPolicy, kLOnly>();
  *grid = (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

template <typename In, int kCbrtPolicy, bool kLOnly>
void launch(const In* r, const In* g, const In* b, const int* tab,
            const int* fix, int n_fix, int* L, int* a, int* bb, long long n,
            cudaStream_t stream) {
  long long ntiles = 0;
  int grid = 1;
  plan<In, kCbrtPolicy, kLOnly>(r, g, b, L, a, bb, n, &ntiles, &grid);
  lab_forward_kernel<In, kCbrtPolicy, kLOnly><<<grid, kThreads, 0, stream>>>(
      r, g, b, tab, fix, n_fix, L, a, bb, n, ntiles);
}

// registers, local bytes a thread (spills), resident blocks a SM, the grid
// of an aligned call of n pixels, threads a block
template <typename In, int kCbrtPolicy, bool kLOnly>
void info(long long n, int* out) {
  cudaFuncAttributes attr{};
  cudaFuncGetAttributes(&attr, lab_forward_kernel<In, kCbrtPolicy, kLOnly>);
  long long ntiles = 0;
  alignas(16) static const int kAligned[4] = {};
  const In* p = reinterpret_cast<const In*>(kAligned);
  plan<In, kCbrtPolicy, kLOnly>(p, p, p, kAligned, kAligned, kAligned, n,
                                &ntiles, &out[3]);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = resident_blocks<In, kCbrtPolicy, kLOnly>() / uie_detail::device_sms();
  out[4] = kThreads;
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

// `which`: 0 K1, 1 K8 _approx, 2 K8 _fast, 3 K1b, 4 K4; out: registers,
// local bytes a thread, resident blocks a SM, grid for n pixels, threads.
void lab_forward_info(int which, long long n, int* out) {
  switch (which) {
    case 0: info<float, kCbrtTable, false>(n, out); break;
    case 1: info<float, kCbrtApprox, false>(n, out); break;
    case 2: info<float, kCbrtCorrected, false>(n, out); break;
    case 3: info<int, kCbrtTable, false>(n, out); break;
    default: info<int, kCbrtTable, true>(n, out); break;
  }
}

}  // namespace uie
