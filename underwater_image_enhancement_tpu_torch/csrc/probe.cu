// The surrogate probe: a table's arithmetic surrogate at every index of the
// table, computed on the card with the arithmetic of the kernels that use
// it (csrc/surrogates.cuh).  ops/kernels.py (surrogate_corrections)
// compares the result with the table on the host and keeps the sparse
// (index, delta) fix-ups, or None above 32 differences, once per table and
// device.
//
// Replaces: underwater_image_enhancement_tpu/ops/pallas_kernels.py,
//   _corrections (its probe_kernel pallas_call) over _cbrt_tab_surrogate
//   (steps=4) and _ig_tab_surrogate.
//
// The TPU probes each backend because Mosaic may contract or reassociate
// f32 ops differently per kernel instance.  Here every op is an explicitly
// rounded intrinsic and the file is built with -fmad=false, so the probe's
// values are those of the forward LAB kernel's surrogate policy (K8 _fast)
// by construction; the probe still runs on the card, so a compiler that
// broke that would show as other fix-ups (and K8 _fast vs K1 mismatches).
//
// Bound on an H100: launch latency.  3072 or 4096 indices, 8 bytes and
// ~50 f32 ops each (~33 KB at most): nanoseconds of work against a few
// microseconds of launch.  One thread per index.

#include <cuda_runtime.h>

#include "surrogates.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
surrogate_probe_kernel(const int* __restrict__ idx, int* __restrict__ out,
                       int n, int which) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = which == 0 ? uie_detail::cbrt_tab_surrogate<4>(idx[i])
                      : uie_detail::ig_tab_surrogate(idx[i]);
}

}  // namespace

namespace uie {

// Launch only; csrc/bindings.cpp checks the tensors and the launch.
// which: 0 = CBRT_TAB (4 Newton steps), 1 = INV_GAMMA_TAB.
void launch_surrogate_probe(const int* idx, int* out, int n, int which,
                            cudaStream_t stream) {
  surrogate_probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(idx, out, n, which);
}

}  // namespace uie
