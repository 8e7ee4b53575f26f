// Canny's bounded hysteresis: strong | (weak reachable from strong in
// <= iters 8-connected steps), on (N, H, W) int32 {0, 1} planes, zero
// outside each plane.
//
// Replaces: underwater_image_enhancement_tpu/ops/pallas_kernels.py,
//   hysteresis_propagate (_make_hyst_kernel): row bands of 128 plus an
//   `iters`-row halo in VMEM, `iters` rounds of e | (weak & dilate8(e)).
//
// Design: two launches.  The first packs the inputs into bits, 32 cells a
// word (a warp loads 128 adjacent cells of a row, coalesced, 16 bytes a
// lane, and ORs each word's nibbles together with shuffles): 8 bytes a
// cell in, a quarter of a byte out.  The second runs one block (512
// threads) per (plane, output tile), or one block (1024 threads) per plane
// where the plane fits one region: the tile plus a halo of
// `halo_rows` rows and `halo_words` words on each side is read from the
// bits into shared memory (the state twice, for double buffering, and the
// weak mask), the block runs Jacobi rounds e' = e | (weak & dilate8(e)) on
// the words, and a warp unpacks each word of the tile into 32 int32 cells
// with one coalesced store.  The halo's re-reads cost bits, not int32s.  A
// round, per word: the words to the left and right come from the
// neighbouring lanes (__shfl_up/down_sync in a group of `group` lanes, one
// lane a word column), the horizontal dilation is shifts with the carries
// from those words, OR-ed over rows y-1, y and y+1 and masked with weak.
// A thread walks a segment of rows with the dilations of rows y-1, y and
// y+1 in registers: one shared-memory load of the state and one of the
// weak mask, two shuffles and one store a word, ~20 integer ops for 32
// cells.
//
// Exact for the same reason as the TPU kernel's band: an 8-connected path
// of length k moves at most k cells, so with a halo of at least `iters`
// cells (rows, and 32 * halo_words columns) the cells outside the region,
// read as zero, cannot reach the tile in `iters` rounds.  Where the whole
// plane fits one region (the descent's later levels), the region is the
// plane, with no halo, and zero outside it is the definition.  Two cuts of
// work keep it exact:
//   - round k updates only the rows that can still reach the tile in the
//     rounds left (rows within iters - 1 - k of it);
//   - the rounds stop once one changes nothing (a fixed point: every later
//     round reads what the last one read).
// No in-place (Gauss-Seidel) update: it would carry a cell farther than one
// step a round.
//
// Bound on an H100: the bytes are 12 a pixel (two int32 inputs read once,
// one output written), 24.9 MB on a 1080x1920 plane, ~7.4 us at 3.35 TB/s.
// The bits cost 0.5 byte a cell more; the rounds ~0.8 integer op a cell
// of the region, which the tile (ops/kernels.py hysteresis_tile, by
// `iters`) keeps near 4x the tile at 64 rounds.

#include <cuda_runtime.h>

namespace {

// Horizontal 3-dilation of this lane's word v of one row, with the
// neighbouring words of the row from the lanes beside it (zero past the
// region's edge: lm, rm are 0 at the first and last word).
__device__ __forceinline__ unsigned hdilate(unsigned v, unsigned gmask,
                                            int group, unsigned lm,
                                            unsigned rm) {
  const unsigned l = __shfl_up_sync(gmask, v, 1, group) & lm;
  const unsigned r = __shfl_down_sync(gmask, v, 1, group) & rm;
  return v | (v << 1) | (l >> 31) | (v >> 1) | (r << 31);
}

// Pack the int32 planes into bits: bits[0] the strong cells, bits[1] the
// weak ones, (N, H, Wd) words each, bit j of word w = cell 32 w + j (zero
// past W).  A warp packs 128 cells of a row, four words, at a time: a lane
// loads 4 adjacent cells of each plane (16 bytes, where W is a multiple of
// 4 and the planes are 16-byte aligned; else four loads of 4 bytes), makes
// a nibble of each, and three xor-shuffles OR the 8 nibbles of a word
// together.  Two groups a warp, their loads issued first.
__device__ __forceinline__ unsigned nibble(int4 v) {
  return (v.x != 0) | (v.y != 0) << 1 | (v.z != 0) << 2 | (v.w != 0) << 3;
}

__device__ __forceinline__ int4 load4(const int* p, int x, int W, bool vec) {
  if (vec) return x < W ? *reinterpret_cast<const int4*>(p + x)
                        : make_int4(0, 0, 0, 0);
  return make_int4(x < W ? p[x] : 0, x + 1 < W ? p[x + 1] : 0,
                   x + 2 < W ? p[x + 2] : 0, x + 3 < W ? p[x + 3] : 0);
}

__global__ void __launch_bounds__(256)
hysteresis_pack_kernel(const int* __restrict__ strong,
                       const int* __restrict__ weak,
                       unsigned* __restrict__ bits, int rows, int W, int Wd,
                       bool vec) {
  constexpr int kGroups = 2;  // 128-cell groups a warp
  const int lane = threadIdx.x & 31;
  const int G = (Wd + 3) / 4;  // groups a row
  const long long words = (long long)rows * Wd;
  const long long first =
      ((long long)blockIdx.x * 8 + (threadIdx.x >> 5)) * kGroups;
  int4 s[kGroups], w[kGroups];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {  // every load first
    const long long it = first + j;
    const int row = (int)(it / G), g = (int)(it - (long long)row * G);
    const int x = g * 128 + 4 * lane;
    s[j] = w[j] = make_int4(0, 0, 0, 0);
    if (row < rows) {
      const long long o = (long long)row * W;
      s[j] = load4(strong + o, x, W, vec);
      w[j] = load4(weak + o, x, W, vec);
    }
  }
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const long long it = first + j;
    const int row = (int)(it / G), g = (int)(it - (long long)row * G);
    unsigned sb = nibble(s[j]) << (4 * (lane & 7));
    unsigned wb = nibble(w[j]) << (4 * (lane & 7));
#pragma unroll
    for (int d = 1; d < 8; d <<= 1) {
      sb |= __shfl_xor_sync(0xffffffffu, sb, d);
      wb |= __shfl_xor_sync(0xffffffffu, wb, d);
    }
    const int word = g * 4 + (lane >> 3);
    if (row < rows && (lane & 7) == 0 && word < Wd) {
      const long long o = (long long)row * Wd + word;
      bits[o] = sb;
      bits[words + o] = wb;
    }
  }
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
hysteresis_flood_kernel(const unsigned* __restrict__ bits,
                        int* __restrict__ out, long long words, int H, int W,
                        int iters, int tile_h, int halo_rows, int halo_words,
                        int group) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ unsigned smem[];
  const int RH = tile_h + 2 * halo_rows;  // region rows
  const int RW = group;                   // region words a row
  const int TW = group - 2 * halo_words;  // tile words a row
  unsigned* cur = smem;
  unsigned* nxt = smem + RH * RW;
  unsigned* wk = smem + 2 * RH * RW;

  const int Wd = (W + 31) / 32;
  const int tiles_x = (Wd + TW - 1) / TW, tiles_y = (H + tile_h - 1) / tile_h;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const long long plane = blockIdx.x / (tiles_x * tiles_y);
  const int ry0 = ty * tile_h - halo_rows;  // region's first row
  const int rw0 = tx * TW - halo_words;     // region's first word

  // the region's words; zero outside the plane
  const unsigned* sp = bits + plane * H * Wd;
  for (int it = threadIdx.x; it < RH * RW; it += kThreads) {
    const int y = ry0 + it / RW, w = rw0 + it % RW;
    unsigned s = 0, k = 0;
    if (y >= 0 && y < H && w >= 0 && w < Wd) {
      const long long o = (long long)y * Wd + w;
      s = sp[o];
      k = sp[words + o];
    }
    cur[it] = s;
    nxt[it] = s;
    wk[it] = k;
  }
  __syncthreads();

  // a group of `group` lanes a row segment, one lane a word column
  const int word = threadIdx.x % group, seg = threadIdx.x / group;
  const int K = (RH + kThreads / group - 1) / (kThreads / group);
  const unsigned gmask =
      group == 32 ? 0xffffffffu : (0xffffu << ((threadIdx.x & 31) & 16));
  const unsigned lm = word > 0 ? ~0u : 0u, rm = word < group - 1 ? ~0u : 0u;
  const int seg_lo = seg * K, seg_hi = min(seg_lo + K, RH);
  for (int k = 0; k < iters; ++k) {
    const int reach = iters - 1 - k;  // rounds left after this one
    const int ya = max(seg_lo, max(0, halo_rows - reach));
    const int yb = min(seg_hi, min(RH, halo_rows + tile_h + reach));
    int changed = 0;
    if (ya < yb) {  // the same for every lane of the group
      // the dilations of rows y-1, y and y+1 slide down the segment; the
      // unrolled loop overlaps the loads and shuffles of several rows
      unsigned hprev = 0, cy = cur[ya * RW + word], cn;
      if (ya > 0)
        hprev = hdilate(cur[(ya - 1) * RW + word], gmask, group, lm, rm);
      unsigned hcur = hdilate(cy, gmask, group, lm, rm);
#pragma unroll 4
      for (int y = ya; y < yb; ++y) {
        cn = y + 1 < RH ? cur[(y + 1) * RW + word] : 0u;
        const unsigned hnext = hdilate(cn, gmask, group, lm, rm);
        const unsigned nv = cy | (wk[y * RW + word] & (hprev | hcur | hnext));
        changed |= nv != cy;
        nxt[y * RW + word] = nv;
        hprev = hcur;
        hcur = hnext;
        cy = cn;
      }
    }
    const int any = __syncthreads_or(changed);
    unsigned* t = cur;
    cur = nxt;
    nxt = t;
    if (!any) break;
  }

  // the tile, unpacked: a warp writes one word's 32 cells at a time
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* op = out + plane * H * W;
  const int x0 = tx * TW * 32 + lane;
  for (int r = warp; r < tile_h; r += kWarps) {
    const int y = ty * tile_h + r;
    if (y >= H) break;
    const unsigned* src = cur + (r + halo_rows) * RW + halo_words;
    int* dst = op + (long long)y * W;
#pragma unroll 4
    for (int w = 0; w < TW; ++w) {
      const int x = x0 + 32 * w;
      if (x < W) dst[x] = (src[w] >> lane) & 1u;
    }
  }
}

template <int kThreads>
cudaError_t launch_flood(const unsigned* bits, int* out, long long words,
                         int H, int W, int iters, int tile_h, int halo_rows,
                         int halo_words, int group, int smem, long long blocks,
                         cudaStream_t stream) {
  static int smem_set = 0;  // the largest size set on this instance so far
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        hysteresis_flood_kernel<kThreads>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  hysteresis_flood_kernel<kThreads>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          bits, out, words, H, W, iters, tile_h, halo_rows, halo_words,
          group);
  return cudaGetLastError();
}

}  // namespace

namespace uie {

// Shared memory of one block: three words a cell of the region's
// (tile_h + 2 * halo_rows) rows of `group` words.
long long hysteresis_smem_bytes(int tile_h, int halo_rows, int group) {
  return 3LL * (tile_h + 2LL * halo_rows) * group * 4;
}

// Launch only; csrc/bindings.cpp checks the tensors and the plan (which
// ops/kernels.py hysteresis_tile picks), allocates `bits` (2 * N * H *
// ceil(W / 32) words) and checks the launches.  A plan with no halo covers
// the whole plane in one block of 1024 threads, a tiled one takes 512.
cudaError_t launch_hysteresis(const int* strong, const int* weak,
                              unsigned* bits, int* out, int N, int H, int W,
                              int iters, int tile_h, int halo_rows,
                              int halo_words, int group,
                              cudaStream_t stream) {
  const int smem = (int)hysteresis_smem_bytes(tile_h, halo_rows, group);
  const int Wd = (W + 31) / 32, TW = group - 2 * halo_words;
  const long long words = (long long)N * H * Wd;
  const long long blocks = (long long)N * ((H + tile_h - 1) / tile_h) *
                           ((Wd + TW - 1) / TW);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (words > 0x7fffffffLL) return cudaErrorInvalidValue;
  // 8 warps a block, 2 groups of 128 cells a warp
  const long long groups = (long long)N * H * ((Wd + 3) / 4);
  const bool vec = W % 4 == 0 &&
                   ((reinterpret_cast<size_t>(strong) |
                     reinterpret_cast<size_t>(weak)) & 15) == 0;
  hysteresis_pack_kernel<<<(unsigned)((groups + 15) / 16), 256, 0, stream>>>(
      strong, weak, bits, N * H, W, Wd, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (halo_rows == 0 && halo_words == 0)
    return launch_flood<1024>(bits, out, words, H, W, iters, tile_h,
                              halo_rows, halo_words, group, smem, blocks,
                              stream);
  return launch_flood<512>(bits, out, words, H, W, iters, tile_h, halo_rows,
                           halo_words, group, smem, blocks, stream);
}

}  // namespace uie
