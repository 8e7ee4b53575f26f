// Canny's bounded hysteresis: strong | (weak reachable from strong in
// <= iters 8-connected steps), on (N, H, W) int32 {0, 1} planes, zero
// outside each plane.
//
// Replaces: underwater_image_enhancement_tpu/ops/pallas_kernels.py,
//   hysteresis_propagate (_make_hyst_kernel): row bands of 128 plus an
//   `iters`-row halo in VMEM, `iters` rounds of e | (weak & dilate8(e)).
//
// Design: one block per (plane, TILE x TILE output tile).  The tile plus a
// halo of `iters` cells on every side is staged into shared memory as bytes
// (the state twice, for double buffering, and the weak mask), then the
// block runs the rounds locally and writes the centre tile.  Exact for the
// same reason as the TPU kernel's band (halo >= iters): an 8-connected path
// of length L moves at most L cells, so cells farther than `iters` from
// the tile cannot reach it.  Two cuts of work keep it exact:
//   - round k updates only the cells at least k+1 from the halo's edge
//     (their neighbours are still exact after k rounds; the rest are not
//     read again);
//   - the rounds stop once one changes nothing (a fixed point: every later
//     round reads what the last one read).
//
// Bound on an H100: the bytes are 12 a pixel (two int32 inputs read once,
// one output written), 24.9 MB on a 1080x1920 plane, ~7.4 us at 3.35 TB/s.
// The halo re-reads ((TILE + 2*iters) / TILE)^2 times the inputs from L2,
// and each round costs ~10 shared-memory byte loads a cell; the early stop
// bounds the rounds by the longest weak chain a tile holds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
hysteresis_kernel(const int* __restrict__ strong, const int* __restrict__ weak,
                  int* __restrict__ out, int H, int W, int iters, int tile) {
  extern __shared__ unsigned char smem[];
  const int R = tile + 2 * iters;  // side of the staged region
  unsigned char* cur = smem;
  unsigned char* nxt = smem + R * R;
  unsigned char* wk = smem + 2 * R * R;

  const long long plane = (long long)blockIdx.z * H * W;
  const int y0 = blockIdx.y * tile - iters;
  const int x0 = blockIdx.x * tile - iters;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int ry = ty; ry < R; ry += kThreadsY) {
    const int y = y0 + ry;
    for (int rx = tx; rx < R; rx += kThreadsX) {
      const int x = x0 + rx;
      unsigned char s = 0, w = 0;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const long long o = plane + (long long)y * W + x;
        s = strong[o] != 0;
        w = weak[o] != 0;
      }
      const int c = ry * R + rx;
      cur[c] = s;
      nxt[c] = s;
      wk[c] = w;
    }
  }
  __syncthreads();

  for (int k = 0; k < iters; ++k) {
    const int lo = k + 1, hi = R - k - 1;  // rows and cols [lo, hi)
    int changed = 0;
    for (int ry = lo + ty; ry < hi; ry += kThreadsY) {
      for (int rx = lo + tx; rx < hi; rx += kThreadsX) {
        const int c = ry * R + rx;
        unsigned char v = cur[c];
        if (!v && wk[c]) {
          v = cur[c - R - 1] | cur[c - R] | cur[c - R + 1] | cur[c - 1] |
              cur[c + 1] | cur[c + R - 1] | cur[c + R] | cur[c + R + 1];
          changed |= v;
        }
        nxt[c] = v;
      }
    }
    const int any = __syncthreads_or(changed);
    unsigned char* t = cur;
    cur = nxt;
    nxt = t;
    if (!any) break;
  }

  for (int oy = ty; oy < tile; oy += kThreadsY) {
    const int y = blockIdx.y * tile + oy;
    if (y >= H) break;
    for (int ox = tx; ox < tile; ox += kThreadsX) {
      const int x = blockIdx.x * tile + ox;
      if (x >= W) break;
      out[plane + (long long)y * W + x] = cur[(oy + iters) * R + ox + iters];
    }
  }
}

}  // namespace

namespace uie {

// Shared memory of one block: 3 bytes a cell of the (tile + 2*iters)^2
// region.
long long hysteresis_smem_bytes(int iters, int tile) {
  const long long R = tile + 2LL * iters;
  return 3 * R * R;
}

// Launch only; csrc/bindings.cpp checks the tensors, picks the tile (so
// that the region fits in shared memory) and checks the launch.
cudaError_t launch_hysteresis(const int* strong, const int* weak, int* out,
                              int N, int H, int W, int iters, int tile,
                              cudaStream_t stream) {
  const int smem = (int)hysteresis_smem_bytes(iters, tile);
  cudaError_t err = cudaFuncSetAttribute(
      hysteresis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile, N);
  hysteresis_kernel<<<grid, block, smem, stream>>>(strong, weak, out, H, W,
                                                   iters, tile);
  return cudaGetLastError();
}

}  // namespace uie
