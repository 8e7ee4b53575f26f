// Inclusive f32 prefix sum along the middle axis of a contiguous (N, L, M)
// tensor in XLA:CPU's association, with an optional leading zero:
// out (N, L + lead, M).
//
// Replaces: underwater_image_enhancement_tpu/ops/pallas_kernels.py,
//   sat_rows (_make_cumsum_rows_kernel): (P, H, W) -> (P, H+1, W) row
//   prefix with a leading zero row, one VMEM pass per 128-lane block.
//
// What it computes is the JAX package's airlight prefix sums, which the
// reference runs as jnp.cumsum (airlight._sat_rows / _corner_grid and the
// banded SAT's band prefix), not the Pallas kernel's Hillis-Steele
// doubling: the f32 association decides near-tie quadtree descents, and
// the port's reference is XLA:CPU's.  That association (ops/kernels.py
// xla_cumsum, the plain version):
//   - L <= 16: sequential, acc = x0, acc += x1, ...;
//   - else: blocks of 16 (the last padded with zeros) scanned sequentially;
//     the block totals scanned by the same rule, recursively; each block's
//     values plus the exclusive prefix of the block totals (0 for block 0,
//     added too).
// Every add is __fadd_rn, so the card's bits equal the CPU's.
//
// Design: the recursion runs on the host (csrc/bindings.cpp), two kernels
// a level: block_totals_kernel sums each block of 16 into an (N, nb, M)
// scratch, the scratch is scanned by the same rule (one more level while
// nb > 16), and block_scan_kernel rescans each block and adds its block's
// exclusive prefix.  One thread per (n, block, m), m fastest: neighbouring
// threads read neighbouring m where M is wide (the row tables, coalesced),
// neighbouring blocks where M == 1 (a scan along the last axis, the
// descent's corner strips), so both shapes fill the card.  A (6, 1080,
// 1920) row table takes 5 launches (two levels of totals and the rescans).
//
// Bound on an H100: memory, 8 bytes a value (read once, written once):
// 99.6 MB for the (6, 1080, 1920) exact row table, ~30 us at 3.35 TB/s.
// It reads the input twice (once for the totals, once for the rescan) and
// the totals are 1/16 of it.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;  // XLA:CPU's scan block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
block_totals_kernel(const float* __restrict__ x, float* __restrict__ tot,
                    int N, int L, int M, int nb) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)N * nb * M) return;
  const long long m = t % M;
  const long long b = (t / M) % nb;
  const long long n = t / ((long long)M * nb);
  const int s = (int)b * kBlock, e = min(s + kBlock, L);
  const float* xc = x + (n * L + s) * M + m;
  float acc = xc[0];
#pragma unroll 4
  for (int l = 1; l < e - s; ++l) acc = __fadd_rn(acc, xc[(long long)l * M]);
  // the zeros that pad a short last block (they change only a -0)
  tot[t] = e - s < kBlock ? __fadd_rn(acc, 0.0f) : acc;
}

// excl: the inclusive scan of the block totals, (N, nb, M), or null when
// L <= 16 (one block, no prefix added).
__global__ void __launch_bounds__(kThreads)
block_scan_kernel(const float* __restrict__ x, const float* __restrict__ excl,
                  float* __restrict__ out, int N, int L, int M, int nb,
                  int lead) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)N * nb * M) return;
  const long long m = t % M;
  const long long b = (t / M) % nb;
  const long long n = t / ((long long)M * nb);
  const int s = (int)b * kBlock, e = min(s + kBlock, L);
  const float* xc = x + (n * L + s) * M + m;
  float* oc = out + (n * (L + lead) + lead + s) * M + m;
  if (lead && b == 0) out[n * (L + lead) * M + m] = 0.0f;
  float acc = xc[0];
  if (excl == nullptr) {
    oc[0] = acc;
    for (int l = 1; l < e - s; ++l) {
      acc = __fadd_rn(acc, xc[(long long)l * M]);
      oc[(long long)l * M] = acc;
    }
    return;
  }
  const float pre = b ? excl[t - M] : 0.0f;  // block b-1 of the same (n, m)
  oc[0] = __fadd_rn(acc, pre);
#pragma unroll 4
  for (int l = 1; l < e - s; ++l) {
    acc = __fadd_rn(acc, xc[(long long)l * M]);
    oc[(long long)l * M] = __fadd_rn(acc, pre);
  }
}

int blocks_for(long long threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

namespace uie {

int scan_block() { return kBlock; }

// Launch only; csrc/bindings.cpp runs the recursion, allocates the
// scratch and checks each launch.
void launch_block_totals(const float* x, float* tot, int N, int L, int M,
                         cudaStream_t stream) {
  const int nb = (L + kBlock - 1) / kBlock;
  block_totals_kernel<<<blocks_for((long long)N * nb * M), kThreads, 0,
                        stream>>>(x, tot, N, L, M, nb);
}

void launch_block_scan(const float* x, const float* excl, float* out, int N,
                       int L, int M, bool lead, cudaStream_t stream) {
  const int nb = (L + kBlock - 1) / kBlock;
  block_scan_kernel<<<blocks_for((long long)N * nb * M), kThreads, 0,
                      stream>>>(x, excl, out, N, L, M, nb, lead ? 1 : 0);
}

}  // namespace uie
