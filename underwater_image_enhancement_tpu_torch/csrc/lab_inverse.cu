// Inverse LAB: OpenCV's integer Lab2RGBinteger (csrc/lab_inverse.cuh) on
// int32 (L, a, b) planes, with two epilogues: the u8 values as int32
// (lab_inverse_u8), or a 256-entry f32 table gathered at each u8 value
// (lab_inverse_lut): IEEE k / 255 for the unit output (stretch.U8_GRID,
// the bits of a correctly rounded division), (k/255)**gamma for the six
// recipes' trailing gamma.
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
// planes, 24 bytes a pixel (49.8 MB at 1920x1080, ~15 us at 3.35 TB/s);
// the integer work is ~60 ops a pixel.
//
// Design (the forward-LAB template's, csrc/lab_forward.cu, mirrored; the
// ring's pieces are csrc/bulk_ring.cuh):
// - one wave: the grid is the instantiation's resident blocks
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, once a device);
// - bytes in flight without registers: a block streams tiles of 1024
//   pixels (blockIdx.x, then gridDim.x apart) through a ring of three
//   stages in shared memory, each plane's 4 KB of a tile one bulk copy
//   completing on the stage's mbarrier; a thread reads its 4 adjacent
//   pixels of each plane as one 16-byte vector, fences the async proxy,
//   hands the stage back to the next tile, computes, and stores 16-byte
//   vectors;
// - tables off the critical path: the first three tiles' copies are issued
//   before the block stages its tables, 16 bytes a thread, from a block
//   laid out as the shared-memory tables (ops/lab_tables.py INV_TABLE_U8,
//   INV_GAMMA as bytes, 6.1 KB) and the epilogue's 1 KB f32 table;
// - the ragged end and misaligned planes: the pixels past the last whole
//   tile run through the kernel's scalar loop, and so does the whole call
//   where a plane does not start on 16 bytes; nothing leaves the kernel.
// Built without --use_fast_math.

#include <cuda_runtime.h>

#include "bulk_ring.cuh"
#include "common.cuh"
#include "lab_inverse.cuh"

namespace {

using uie_detail::aligned16;
using uie_detail::bar_expect;
using uie_detail::bar_fence_init;
using uie_detail::bar_init;
using uie_detail::bar_wait;
using uie_detail::bulk_load;
using uie_detail::proxy_fence;
using uie_detail::Vec4;

constexpr int kThreads = 256;
constexpr int kTile = 4 * kThreads;  // pixels a tile: a 16-byte vector a thread
constexpr int kStages = 3;           // tiles in flight a block

// An epilogue's value of a u8 result: itself (K3b) or its table entry.
template <bool kLut>
__device__ __forceinline__ auto epilogue(int v, const float* s_lut) {
  if constexpr (kLut) return s_lut[v]; else return v;
}

// n pixels: ntiles whole tiles of kTile from the planes' start (0 where a
// plane is not 16-byte aligned), streamed through a ring of kStages tiles
// in shared memory, then the rest one pixel a thread.  A block takes the
// tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// tab: INV_TABLE_U8; lut: the (256,) f32 epilogue table (kLut)
template <typename Out, bool kLut>
__global__ void __launch_bounds__(kThreads)
lab_inverse_kernel(const int* __restrict__ L, const int* __restrict__ a,
                   const int* __restrict__ b, const int* __restrict__ tab,
                   const float* __restrict__ lut, Out* __restrict__ r_out,
                   Out* __restrict__ g_out, Out* __restrict__ b_out,
                   long long n, long long ntiles) {
  using V = typename Vec4<Out>::type;
  __shared__ __align__(128) int s_ring[kStages][3][kTile];
  __shared__ __align__(8) unsigned long long s_full[kStages];
  __shared__ __align__(16) uie_detail::LabInvTables s;
  __shared__ __align__(16) float s_lut[kLut ? 256 : 4];

  const long long mine = blockIdx.x < ntiles
                             ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  // tile i of this block into its stage of the ring
  auto issue = [&](long long i) {
    const int st = (int)(i % kStages);
    const long long px = (blockIdx.x + i * gridDim.x) * kTile;
    bar_expect(&s_full[st], 3 * kTile * sizeof(int));
    bulk_load(s_ring[st][0], L + px, kTile * sizeof(int), &s_full[st]);
    bulk_load(s_ring[st][1], a + px, kTile * sizeof(int), &s_full[st]);
    bulk_load(s_ring[st][2], b + px, kTile * sizeof(int), &s_full[st]);
  };
  // the first tiles' loads go out before the tables are staged
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) bar_init(&s_full[st]);
    bar_fence_init();
    for (int i = 0; i < kStages && i < mine; ++i) issue(i);
  }

  // the tables, 16 bytes a thread
  float4 lut4;
  if (kLut && threadIdx.x < 64)
    lut4 = __ldg(reinterpret_cast<const float4*>(lut) + threadIdx.x);
  uie_detail::stage_lab_inv_tables<kThreads>(s, tab);
  if (kLut && threadIdx.x < 64)
    reinterpret_cast<float4*>(s_lut)[threadIdx.x] = lut4;
  __syncthreads();

  Out* outs[3] = {r_out, g_out, b_out};
  for (long long i = 0; i < mine; ++i) {
    const int st = (int)(i % kStages);
    bar_wait(&s_full[st], (unsigned)((i / kStages) & 1));
    int4 x[3];
#pragma unroll
    for (int p = 0; p < 3; ++p)
      x[p] = reinterpret_cast<const int4*>(s_ring[st][p])[threadIdx.x];
    // every thread has its vectors: the stage takes the block's next tile,
    // after a proxy fence that orders these reads before the bulk copy
    // that overwrites them
    proxy_fence();
    __syncthreads();
    if (threadIdx.x == 0 && i + kStages < mine) issue(i + kStages);
    int v8[4][3];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      uie_detail::lab_inv_pixel(s, uie_detail::lane(x[0], k),
                                uie_detail::lane(x[1], k),
                                uie_detail::lane(x[2], k), v8[k]);
    const long long v = (blockIdx.x + i * gridDim.x) * kThreads + threadIdx.x;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      V o;
      o.x = epilogue<kLut>(v8[0][ch], s_lut);
      o.y = epilogue<kLut>(v8[1][ch], s_lut);
      o.z = epilogue<kLut>(v8[2][ch], s_lut);
      o.w = epilogue<kLut>(v8[3][ch], s_lut);
      reinterpret_cast<V*>(outs[ch])[v] = o;
    }
  }
  // the pixels past the last whole tile (all of them when ntiles is 0)
  for (long long i = ntiles * kTile + (long long)blockIdx.x * kThreads +
                     threadIdx.x;
       i < n; i += (long long)gridDim.x * kThreads) {
    int v8[3];
    uie_detail::lab_inv_pixel(s, __ldg(L + i), __ldg(a + i), __ldg(b + i), v8);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) outs[ch][i] = epilogue<kLut>(v8[ch], s_lut);
  }
}

// Blocks of the instantiation resident on the current device, all SMs
// together: its grid, so that every block runs in the first wave.
template <typename Out, bool kLut>
int resident_blocks() {
  static int cache[uie_detail::kMaxDevices] = {};
  return uie_detail::resident_blocks(lab_inverse_kernel<Out, kLut>, kThreads,
                                     cache);
}

// The launch of n pixels: its whole tiles (0 unless every plane starts
// on 16 bytes) and its grid (the resident blocks, or fewer for a small
// call).
template <typename Out, bool kLut>
void plan(const int* L, const int* a, const int* b, const Out* r,
          const Out* g, const Out* bb, long long n, long long* ntiles,
          int* grid) {
  const bool vec = aligned16(L) && aligned16(a) && aligned16(b) &&
                   aligned16(r) && aligned16(g) && aligned16(bb);
  *ntiles = vec ? n / kTile : 0;
  // a block's work: tiles, or kThreads pixels of the rest a round
  const long long rest = (n - *ntiles * kTile + kThreads - 1) / kThreads;
  const long long want = *ntiles > rest ? *ntiles : rest;
  const int cap = resident_blocks<Out, kLut>();
  *grid = (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

template <typename Out, bool kLut>
void launch(const int* L, const int* a, const int* b, const int* tab,
            const float* lut, Out* r, Out* g, Out* bb, long long n,
            cudaStream_t stream) {
  long long ntiles = 0;
  int grid = 1;
  plan<Out, kLut>(L, a, b, r, g, bb, n, &ntiles, &grid);
  lab_inverse_kernel<Out, kLut><<<grid, kThreads, 0, stream>>>(
      L, a, b, tab, lut, r, g, bb, n, ntiles);
}

// registers, local bytes a thread (spills), resident blocks a SM, the grid
// of an aligned call of n pixels, threads a block
template <typename Out, bool kLut>
void info(long long n, int* out) {
  cudaFuncAttributes attr{};
  cudaFuncGetAttributes(&attr, lab_inverse_kernel<Out, kLut>);
  long long ntiles = 0;
  alignas(16) static const int kAligned[4] = {};
  const Out* p = reinterpret_cast<const Out*>(kAligned);
  plan<Out, kLut>(kAligned, kAligned, kAligned, p, p, p, n, &ntiles, &out[3]);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = resident_blocks<Out, kLut>() / uie_detail::device_sms();
  out[4] = kThreads;
}

}  // namespace

namespace uie {

// Launch only; csrc/bindings.cpp checks the tensors and the launch.  tab
// is INV_TABLE_U8, lut the (256,) f32 table of the u8 values (K3, K3g).
void launch_lab_inverse_lut(const int* L, const int* a, const int* b,
                            const int* tab, const float* lut, float* r,
                            float* g, float* bb, long long n,
                            cudaStream_t stream) {
  launch<float, true>(L, a, b, tab, lut, r, g, bb, n, stream);
}

void launch_lab_inverse_u8(const int* L, const int* a, const int* b,
                           const int* tab, int* r, int* g, int* bb,
                           long long n, cudaStream_t stream) {
  launch<int, false>(L, a, b, tab, nullptr, r, g, bb, n, stream);
}

// `which`: 0 the f32 table epilogue (K3, K3g), 1 the u8 one (K3b); out:
// registers, local bytes a thread, resident blocks a SM, grid for n
// pixels, threads.
void lab_inverse_info(int which, long long n, int* out) {
  if (which == 0)
    info<float, true>(n, out);
  else
    info<int, false>(n, out);
}

}  // namespace uie
