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
// Design: one launch, one block per (n, slab of S adjacent columns m), S a
// power of two up to 16 (1 for a scan along the last axis).  The block
//   1. stages the slab's L x S inputs in shared memory (coalesced: a warp
//      reads 32 / S rows of S columns), where they fit, else reads them
//      from global memory twice (L large; the second read mostly hits L2);
//   2. sums every block of 16 of each column (level-0 totals), then the
//      blocks of 16 of those while more than 16 remain (at most 3 levels
//      for L <= 2^16: 4096, 256, 16 totals a column), all in shared
//      memory;
//   3. scans the top level sequentially and rescans each lower level's
//      blocks with their exclusive prefix, in place, top down;
//   4. rescans each block of the input with its prefix into the staged
//      slab (or straight to the output);
//   5. writes the staged slab out, coalesced.
// No host recursion, no scratch tensor.  Staging reads the input once:
// the (6, 1080, 1920) table's slab of 16 columns takes 74 KB and its
// totals 9 KB, two blocks an SM, 720 blocks.  Shared memory is laid out
// column-major with one pad word every 16 values and a column pitch chosen
// so that the warp's accesses of steps 2-4 fall in distinct banks.
//
// Bound on an H100: memory, 8 bytes a value (read once, written once):
// 99.6 MB for the (6, 1080, 1920) exact row table, ~30 us at 3.35 TB/s.
// A descent's corner strip (18 rows of 1920) is 0.28 MB: one launch is
// its floor.

#include <cuda_runtime.h>

namespace uie {

// What the host picks for a launch (scan_plan) and the kernel reads.
struct ScanPlan {
  int S;          // columns a block
  int staged;     // inputs staged in shared memory
  int Lp;         // staged column pitch (floats)
  int nlev;       // levels of block totals (0 for L <= 16)
  int cnt[3];     // totals a column at each level
  int pitch[3];   // column pitch of each level (floats)
  int off[3];     // offset of each level in shared memory (floats)
  int stage_off;  // offset of the staged slab (floats)
  int smem;       // bytes of shared memory
};

}  // namespace uie

namespace {

constexpr int kBlock = 16;     // XLA:CPU's scan block
constexpr int kThreads = 512;
constexpr int kMaxL = 1 << 16;  // 3 levels of totals at most
// shared memory a block may take: two blocks fit on one SM
constexpr int kSmemCap = 110 * 1024;

__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

// Level-k totals of column c: element j.
__device__ __forceinline__ float& tot(float* sm, const uie::ScanPlan& p,
                                      int k, int c, int j) {
  return sm[p.off[k] + c * p.pitch[k] + padded(j)];
}

// Sequential sum of the block [s, e) of a level array.
__device__ __forceinline__ float block_sum(const float* v, int s, int e) {
  float acc = v[padded(s)];
  for (int l = s + 1; l < e; ++l) acc = __fadd_rn(acc, v[padded(l)]);
  // the zeros that pad a short last block (they change only a -0)
  return e - s < kBlock ? __fadd_rn(acc, 0.0f) : acc;
}

// Steps 2-4 on one slab: `st` is the column's staged inputs, which the
// outputs replace (null where the inputs are read from global memory and
// the outputs written there), xc and oc its input and output columns.
// Every thread of the block calls it.
__device__ void scan_slab(const uie::ScanPlan& p, float* sm, float* st,
                          const float* xc, float* oc, bool live, int L,
                          int M, int lead, int col, int row, int R) {
  auto val = [&](int i) -> float {
    return st ? st[padded(i)] : (live ? xc[(long long)i * M] : 0.0f);
  };
  if (lead && row == 0 && live) oc[0] = 0.0f;

  // an output value: into the staged slab, or to the output
  auto put = [&](int i, float o) {
    if (st)
      st[padded(i)] = o;
    else if (live)
      oc[(long long)(i + lead) * M] = o;
  };

  if (p.nlev == 0) {  // L <= 16: one sequential pass a column
    if (row == 0) {
      float acc = val(0);
      put(0, acc);
      for (int i = 1; i < L; ++i) {
        acc = __fadd_rn(acc, val(i));
        put(i, acc);
      }
    }
    return;
  }

  // 2. block totals, level 0 from the input, level k+1 from level k
  const int nb = p.cnt[0];
  for (int b = row; b < nb; b += R) {
    const int s = b * kBlock, e = min(s + kBlock, L);
    float acc = val(s);
    for (int i = s + 1; i < e; ++i) acc = __fadd_rn(acc, val(i));
    tot(sm, p, 0, col, b) = e - s < kBlock ? __fadd_rn(acc, 0.0f) : acc;
  }
  __syncthreads();
  for (int k = 0; k + 1 < p.nlev; ++k) {
    const float* v = &tot(sm, p, k, col, 0);
    for (int c = row; c < p.cnt[k + 1]; c += R) {
      const int s = c * kBlock, e = min(s + kBlock, p.cnt[k]);
      tot(sm, p, k + 1, col, c) = block_sum(v, s, e);
    }
    __syncthreads();
  }

  // 3. the top level (<= 16 totals) in order, then each level below
  // rescanned with its block's exclusive prefix from the level above
  const int top = p.nlev - 1;
  if (row == 0) {
    float* v = &tot(sm, p, top, col, 0);
    float acc = v[0];
    for (int j = 1; j < p.cnt[top]; ++j) {
      acc = __fadd_rn(acc, v[padded(j)]);
      v[padded(j)] = acc;
    }
  }
  __syncthreads();
  for (int k = top - 1; k >= 0; --k) {
    float* v = &tot(sm, p, k, col, 0);
    for (int c = row; c < p.cnt[k + 1]; c += R) {
      const float pre = c ? tot(sm, p, k + 1, col, c - 1) : 0.0f;
      const int s = c * kBlock, e = min(s + kBlock, p.cnt[k]);
      float acc = v[padded(s)];
      v[padded(s)] = __fadd_rn(acc, pre);
      for (int j = s + 1; j < e; ++j) {
        acc = __fadd_rn(acc, v[padded(j)]);
        v[padded(j)] = __fadd_rn(acc, pre);
      }
    }
    __syncthreads();
  }

  // 4. each block of the input plus its exclusive prefix
  for (int b = row; b < nb; b += R) {
    const float pre = b ? tot(sm, p, 0, col, b - 1) : 0.0f;
    const int s = b * kBlock, e = min(s + kBlock, L);
    float acc = 0.0f;
    for (int i = s; i < e; ++i) {
      acc = i == s ? val(i) : __fadd_rn(acc, val(i));
      put(i, __fadd_rn(acc, pre));
    }
  }
}

// One block a slab: the columns m of one n.
__global__ void __launch_bounds__(kThreads)
prefix_scan_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int L, int M, int lead, uie::ScanPlan p) {
  extern __shared__ float sm[];
  const int S = p.S;
  const int col = threadIdx.x % S, row = threadIdx.x / S;
  const int R = kThreads / S;  // threads a column
  const int slabs = (M + S - 1) / S;
  const int m = (int)(blockIdx.x % slabs) * S + col;
  const bool live = m < M;
  const long long n = blockIdx.x / slabs;
  const float* xc = x + n * L * M + m;
  float* oc = out + n * (L + lead) * M + m;
  if (!p.staged) {
    scan_slab(p, sm, nullptr, xc, oc, live, L, M, lead, col, row, R);
    return;
  }
  // 1. stage the slab
  float* st = sm + p.stage_off + col * p.Lp;
#pragma unroll 4
  for (int i = row; i < L; i += R)
    st[padded(i)] = live ? xc[(long long)i * M] : 0.0f;
  __syncthreads();
  scan_slab(p, sm, st, xc, oc, live, L, M, lead, col, row, R);
  __syncthreads();
  // 5. write the slab out, coalesced
  if (live) {
#pragma unroll 8
    for (int i = row; i < L; i += R)
      oc[(long long)(i + lead) * M] = st[padded(i)];
  }
}

// Floats that padded() spreads n values over.
int padded_len(int n) { return n + (n - 1) / 16; }

// Smallest pitch >= need that is congruent to 32 / S modulo 32 (S < 32):
// a warp's S columns then start in banks 32 / S apart, and its 32 / S
// rows or blocks fill the banks between.
int pitch_for(int need, int S) {
  const int r = 32 / S % 32;
  int p = need - need % 32 + r;
  return p < need ? p + 32 : p;
}

}  // namespace

namespace uie {

int scan_max_length() { return kMaxL; }

// The plan for (L, M), or smem = 0 where L is out of range.
ScanPlan scan_plan(int L, int M) {
  ScanPlan p{};
  if (L < 1 || L > kMaxL) return p;
  int c = L;
  while (c > kBlock) {
    c = (c + kBlock - 1) / kBlock;
    p.cnt[p.nlev++] = c;
  }
  int S0 = 1;
  while (S0 < 16 && S0 < M) S0 *= 2;
  for (int staged = 1; staged >= 0; --staged) {
    for (int S = S0; S >= 1; S /= 2) {
      int off = 0;
      for (int k = 0; k < p.nlev; ++k) {
        p.pitch[k] = pitch_for(padded_len(p.cnt[k]), S);
        p.off[k] = off;
        off += S * p.pitch[k];
      }
      p.Lp = staged ? pitch_for(padded_len(L), S) : 0;
      p.stage_off = off;
      off += S * p.Lp;
      if (off * 4 <= kSmemCap) {
        p.S = S;
        p.staged = staged;
        p.smem = off * 4;
        return p;
      }
    }
  }
  p.smem = 0;
  return p;
}

// Launch only; csrc/bindings.cpp checks the tensors and the launch.
cudaError_t launch_scan(const float* x, float* out, int N, int L, int M,
                        bool lead, cudaStream_t stream) {
  const ScanPlan p = scan_plan(L, M);
  if (p.smem == 0) return cudaErrorInvalidValue;
  static int smem_set = 0;  // the largest size the kernel accepts so far
  if (p.smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        prefix_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemCap);
    if (err != cudaSuccess) return err;
    smem_set = kSmemCap;
  }
  const long long blocks = (long long)N * ((M + p.S - 1) / p.S);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  prefix_scan_kernel<<<(unsigned)blocks, kThreads, p.smem, stream>>>(
      x, out, L, M, lead ? 1 : 0, p);
  return cudaGetLastError();
}

}  // namespace uie
