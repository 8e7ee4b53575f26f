// Arithmetic surrogates of the CBRT_TAB (3072) and INV_GAMMA_TAB (4096)
// tables: the JAX package's _cbrt_tab_surrogate and _ig_tab_surrogate
// (underwater_image_enhancement_tpu/ops/pallas_kernels.py), op for op.
// Every f32 multiply, add and square root is rounded on its own
// (__fmul_rn, __fsub_rn, __fadd_rn, __fsqrt_rn) in the JAX order, and
// jnp.round is round half to even (__float2int_rn), so a kernel gives the
// same surrogate wherever it is inlined: the probe kernel (csrc/probe.cu)
// and the forward LAB kernels (csrc/lab_forward.cu) agree by construction.
// The constants are the f32 values numpy gives, in hex.

#pragma once

#include <cuda_runtime.h>

namespace uie_detail {

constexpr float kInv2040 = 0x1.010102p-11f;    // 1.0 / 2040.0
constexpr float kInv4096 = 0x1p-12f;           // 1.0 / 4096.0
constexpr float kTiny = 0x1.4484cp-100f;       // 1e-30
constexpr float kThird = 0x1.555556p-2f;       // 1.0 / 3.0
constexpr float kLinThresh = 0x1.223184p-7f;   // 0.008856
constexpr float kLinSlope = 0x1.f25e36p+2f;    // 7.787
constexpr float kLinOffset = 0x1.1a7b96p-3f;   // 16.0 / 116.0
constexpr float kGammaA = 0x1.0e147ap+0f;      // 1.055
constexpr float kGammaB = 0x1.c28f5cp-5f;      // 0.055
constexpr float kGammaLin = 0x1.9a5c38p-9f;    // 0.0031308
constexpr float kGammaSlope = 0x1.9d70a4p+3f;  // 12.92

// _newton_cbrt(t, steps): t clamped to 1e-30, then t * r^2 with r the
// reciprocal cube root from the bit-trick seed 0x54A21D2A - bits/3 and
// `kSteps` division-free Newton steps r <- r * ((4 - t*r^2*r) * (1/3)).
template <int kSteps>
__device__ __forceinline__ float newton_cbrt(float t) {
  const float tc = fmaxf(t, kTiny);
  // bits of a positive float: C's truncating / equals jnp's floor //
  float r = __int_as_float(0x54A21D2A - __float_as_int(tc) / 3);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const float t_r3 = __fmul_rn(__fmul_rn(tc, __fmul_rn(r, r)), r);
    r = __fmul_rn(r, __fmul_rn(__fsub_rn(4.0f, t_r3), kThird));
  }
  return __fmul_rn(tc, __fmul_rn(r, r));
}

// _cbrt_tab_surrogate(idx, steps): round(labF(idx/2040) * 2^15).
template <int kSteps>
__device__ __forceinline__ int cbrt_tab_surrogate(int idx) {
  const float t = __fmul_rn((float)idx, kInv2040);
  const float f = t < kLinThresh ? __fadd_rn(__fmul_rn(t, kLinSlope), kLinOffset)
                                 : newton_cbrt<kSteps>(t);
  return __float2int_rn(__fmul_rn(f, 32768.0f));
}

// _ig_tab_surrogate(idx): clip(round(255 * srgb_gamma(idx/4096))), with
// x^(1/2.4) = (sqrt(sqrt(cbrt(x))))^5 and a 3-step Newton cube root.
__device__ __forceinline__ int ig_tab_surrogate(int idx) {
  const float x = __fmul_rn((float)idx, kInv4096);
  const float s = __fsqrt_rn(__fsqrt_rn(newton_cbrt<3>(x)));
  const float s2 = __fmul_rn(s, s);
  const float p = __fmul_rn(__fmul_rn(s2, s2), s);
  const float g = x <= kGammaLin ? __fmul_rn(x, kGammaSlope)
                                 : __fsub_rn(__fmul_rn(kGammaA, p), kGammaB);
  return min(max(__float2int_rn(__fmul_rn(255.0f, g)), 0), 255);
}

}  // namespace uie_detail
