// CLAHE apply: each pixel through the four LUTs of its tiles and OpenCV's
// f32 bilinear blend, bit-exact against cv2.createCLAHE(...).apply on
// 8-bit planes.
//
// Replaces: underwater_image_enhancement_tpu/ops/pallas_kernels.py,
//   clahe_apply (kernel _clahe_apply_kernel, blend _cv_bilinear_f32).
//
// The TPU kernel walks a half-tile-padded "band-block" frame so that every
// block shares one set of four LUTs.  Pixel (y, x) of the unpadded (H, W)
// plane sits at (y+pt, x+plf) of that frame, in band block
// (i, j) = ((y+pt)/th, (x+plf)/tw), whose four tiles are rows r1/r2 =
// clamp(i-1), clamp(i) and columns c1/c2 = clamp(j-1), clamp(j) of the
// tile grid (ops/histeq.py in the JAX package).
//
// Bound on an H100: memory.  4 bytes in and 4 bytes out a pixel (16.6 MB
// at 1920x1080, ~5 us at 3.35 TB/s); the blend is ~30 f32 ops a pixel.
//
// Design: a block owns a strip of rows inside one band block, cropped to
// the plane (grid: band blocks x strips of equal height, as many as one
// wave of resident blocks holds; ops/kernels.py clahe_strip_rows and
// clahe_apply_plan mirror it), so the tiles, and so the LUTs, are the
// block's constants and no pixel divides:
// - at its start the block packs its band block's four LUTs into one
//   256-word table in shared memory, m0 | m1<<8 | m2<<16 | m3<<24 (CLAHE's
//   LUT values lie in 0..255), and each pixel does one shared-memory
//   gather instead of four from global memory; where an entry lies outside
//   0..255 the block reads the int32 LUTs from global memory instead, so
//   every input keeps the plain version's bits;
// - a thread keeps its columns for the whole strip: their fractions wx in
//   registers, and wy read once a row;
// - 16-byte loads and stores of 4 adjacent pixels where the block's span
//   starts on 16 bytes (both planes on 16 bytes, W and the span's first
//   column multiples of 4: at 1080p the spans start at multiples of 120
//   pixels), one pixel a thread otherwise; a thread issues the loads of
//   its next row before it computes the one it holds, and those of its
//   first row before the LUTs are read (more rows in flight a thread cost
//   registers, and so resident blocks, and did not pay: PERF.md);
// - the blend of csrc/clahe_blend.cuh, in its exact order.

#include <cuda_runtime.h>

#include "bulk_ring.cuh"
#include "clahe_blend.cuh"

namespace {

constexpr int kThreads = 256;  // one a LUT entry

struct Geometry {
  int H, W, th, tw, pt, plf, tiles_x, tiles_y, strip_rows;
};

// The block's rectangle [y0, y1) x [x0, x1) of the plane (empty where its
// strip lies below its band block's rows) and its band block (i, j).
struct Rect {
  int y0, y1, x0, x1, i, j;
};

__device__ __forceinline__ Rect block_rect(const Geometry& g) {
  Rect r;
  r.i = blockIdx.x / (g.tiles_x + 1);
  r.j = blockIdx.x - r.i * (g.tiles_x + 1);
  const int band_y1 = min((r.i + 1) * g.th - g.pt, g.H);
  r.y0 = max(r.i * g.th - g.pt, 0) + blockIdx.y * g.strip_rows;
  r.y1 = min(r.y0 + g.strip_rows, band_y1);
  r.x0 = max(r.j * g.tw - g.plf, 0);
  r.x1 = min((r.j + 1) * g.tw - g.plf, g.W);
  return r;
}

// How the block's threads cover its rectangle: groups of V adjacent
// pixels, `cpr` threads across a row, `rps` rows a step; thread (tc, tr).
template <int V>
struct Cover {
  int ng, cpr, rps, tc, tr;
  __device__ __forceinline__ explicit Cover(const Rect& r) {
    ng = (r.x1 - r.x0 + V - 1) / V;
    cpr = min(ng, kThreads);
    rps = kThreads / cpr;
    tc = threadIdx.x % cpr;
    tr = threadIdx.x / cpr;
  }
};

// Row y of group x..x+V-1 into in; nv lanes valid.
template <int V>
__device__ __forceinline__ void load_row(const int* __restrict__ src, int W,
                                         int x, int nv, int y, int (&in)[V]) {
  const int* row = src + (long long)y * W + x;
  if constexpr (V == 4) {
    if (nv == 4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(row));
      in[0] = q.x, in[1] = q.y, in[2] = q.z, in[3] = q.w;
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (k < nv) in[k] = __ldg(row + k);
}

// The block's rectangle, its first row already in `in` where `loaded`.
// kPacked: the four LUTs from the packed table s_lut; else from the int32
// LUTs lut[0..3] in global memory.
template <int V, bool kPacked>
__device__ __forceinline__ void map_rect(
    const int* __restrict__ src, int* __restrict__ out,
    const float* __restrict__ ya, const float* __restrict__ xa,
    const Geometry& g, const Rect& r, const Cover<V>& c,
    const unsigned* s_lut, const int* const (&lut)[4], int (&in)[V],
    bool loaded) {
  for (int grp = c.tc; grp < c.ng; grp += c.cpr, loaded = false) {
    const int x = r.x0 + grp * V;
    const int nv = min(V, r.x1 - x);
    float wx[V];
#pragma unroll
    for (int k = 0; k < V; ++k) wx[k] = __ldg(xa + g.plf + x + min(k, nv - 1));
    if (!loaded && r.y0 + c.tr < r.y1)
      load_row<V>(src, g.W, x, nv, r.y0 + c.tr, in);
    for (int y = r.y0 + c.tr; y < r.y1; y += c.rps) {
      // the next row's loads go out before this row is computed
      int next[V];
      if (y + c.rps < r.y1) load_row<V>(src, g.W, x, nv, y + c.rps, next);
      const float wy = __ldg(ya + g.pt + y);
      const float wy1 = __fadd_rn(1.0f, -wy);
      int o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int v = min(max(in[k], 0), 255);
        float m0, m1, m2, m3;
        if constexpr (kPacked) {
          const unsigned w = s_lut[v];
          m0 = (float)(w & 255u);
          m1 = (float)((w >> 8) & 255u);
          m2 = (float)((w >> 16) & 255u);
          m3 = (float)(w >> 24);
        } else {
          m0 = (float)__ldg(lut[0] + v);
          m1 = (float)__ldg(lut[1] + v);
          m2 = (float)__ldg(lut[2] + v);
          m3 = (float)__ldg(lut[3] + v);
        }
        o[k] = uie_detail::clahe_blend(m0, m1, m2, m3, wx[k], wy, wy1);
        in[k] = next[k];
      }
      int* row = out + (long long)y * g.W + x;
      if constexpr (V == 4) {
        if (nv == 4) {
          *reinterpret_cast<int4*>(row) = make_int4(o[0], o[1], o[2], o[3]);
          continue;
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (k < nv) row[k] = o[k];
    }
  }
}

// The block's work with groups of V pixels: its first row's loads, the
// packed LUT table, then the rectangle.
template <int V>
__device__ __forceinline__ void run_block(const int* __restrict__ src,
                                          const int* __restrict__ luts,
                                          const float* __restrict__ ya,
                                          const float* __restrict__ xa,
                                          int* __restrict__ out,
                                          const Geometry& g, const Rect& r,
                                          unsigned* s_lut) {
  const Cover<V> c(r);
  const bool active = c.tr < c.rps;
  int in[V];
  // the first row goes out before the LUTs are read
  const int x = r.x0 + c.tc * V;
  const bool first = active && c.tc < c.ng && r.y0 + c.tr < r.y1;
  if (first) load_row<V>(src, g.W, x, min(V, r.x1 - x), r.y0 + c.tr, in);

  const int r1 = min(max(r.i - 1, 0), g.tiles_y - 1);
  const int r2 = min(max(r.i, 0), g.tiles_y - 1);
  const int c1 = min(max(r.j - 1, 0), g.tiles_x - 1);
  const int c2 = min(max(r.j, 0), g.tiles_x - 1);
  const int* const lut[4] = {luts + (r1 * g.tiles_x + c1) * 256,
                             luts + (r1 * g.tiles_x + c2) * 256,
                             luts + (r2 * g.tiles_x + c1) * 256,
                             luts + (r2 * g.tiles_x + c2) * 256};
  const int v = threadIdx.x;
  const int m0 = __ldg(lut[0] + v), m1 = __ldg(lut[1] + v);
  const int m2 = __ldg(lut[2] + v), m3 = __ldg(lut[3] + v);
  const bool wide = (unsigned)m0 > 255u || (unsigned)m1 > 255u ||
                    (unsigned)m2 > 255u || (unsigned)m3 > 255u;
  s_lut[v] = (unsigned)m0 | (unsigned)m1 << 8 | (unsigned)m2 << 16 |
             (unsigned)m3 << 24;
  // the table is complete, and whether any entry needs the int32 LUTs
  if (__syncthreads_or(wide)) {
    // entries outside 0..255: one pixel a thread from the int32 LUTs
    const Cover<1> scalar(r);
    int in1[1];
    if (scalar.tr < scalar.rps)
      map_rect<1, false>(src, out, ya, xa, g, r, scalar, s_lut, lut, in1,
                         false);
  } else if (active) {
    map_rect<V, true>(src, out, ya, xa, g, r, c, s_lut, lut, in, first);
  }
}

__global__ void __launch_bounds__(kThreads)
clahe_apply_kernel(const int* __restrict__ src, const int* __restrict__ luts,
                   const float* __restrict__ ya, const float* __restrict__ xa,
                   int* __restrict__ out, Geometry g, bool vec) {
  __shared__ unsigned s_lut[256];
  const Rect r = block_rect(g);
  if (r.y0 >= r.y1 || r.x0 >= r.x1) return;  // the whole block
  // 16-byte groups where the span starts on 16 bytes
  if (vec && r.x0 % 4 == 0)
    run_block<4>(src, luts, ya, xa, out, g, r, s_lut);
  else
    run_block<1>(src, luts, ya, xa, out, g, r, s_lut);
}

int resident_blocks() {
  static int cache[uie_detail::kMaxDevices] = {};
  return uie_detail::resident_blocks(clahe_apply_kernel, kThreads, cache);
}

// The grid (band blocks, strips) and the strip height: as many strips of
// equal height a band block as one wave of resident blocks holds, at most
// one a row (ops/kernels.py clahe_strip_rows, clahe_apply_plan).
void plan(int th, int tiles_x, int tiles_y, dim3* grid, int* strip_rows) {
  const long long bands = (long long)(tiles_x + 1) * (tiles_y + 1);
  const long long want = (resident_blocks() + bands - 1) / bands;
  const long long strips = want < th ? want : th;
  *strip_rows = (int)((th + strips - 1) / strips);
  *grid = dim3((unsigned)bands, (unsigned)((th + *strip_rows - 1) / *strip_rows));
}

}  // namespace

namespace uie {

// Launch only; csrc/bindings.cpp checks the tensors and the launch.
void launch_clahe_apply(const int* src, const int* luts, const float* ya,
                        const float* xa, int* out, int H, int W, int th,
                        int tw, int pt, int plf, int tiles_x, int tiles_y,
                        cudaStream_t stream) {
  dim3 grid;
  int strip_rows = 1;
  plan(th, tiles_x, tiles_y, &grid, &strip_rows);
  const Geometry g{H, W, th, tw, pt, plf, tiles_x, tiles_y, strip_rows};
  const bool vec = uie_detail::aligned16(src) && uie_detail::aligned16(out) &&
                   W % 4 == 0;
  clahe_apply_kernel<<<grid, kThreads, 0, stream>>>(src, luts, ya, xa, out, g,
                                                    vec);
}

// out: registers, local bytes a thread, resident blocks a SM, grid x
// (band blocks), grid y (strips), strip rows, threads a block.
void clahe_apply_info(int th, int tiles_x, int tiles_y, int* out) {
  cudaFuncAttributes attr{};
  cudaFuncGetAttributes(&attr, clahe_apply_kernel);
  dim3 grid;
  plan(th, tiles_x, tiles_y, &grid, &out[5]);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = resident_blocks() / uie_detail::device_sms();
  out[3] = (int)grid.x;
  out[4] = (int)grid.y;
  out[6] = kThreads;
}

}  // namespace uie
