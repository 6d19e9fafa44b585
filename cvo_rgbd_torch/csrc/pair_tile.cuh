// Device functions shared by the CVO kernels.
//
// exp_neg ports the JAX package's core/numerics.py:exp_neg (same constants,
// same operation order, rintf rounds half to even like jnp.round), and
// the pair_* functions port the JAX package's ops/pallas_gram.py:_pair_tile:
// the gated kernel entry A_ij of one fixed point i and one moving point j,
// in the se color mode (color kernel recomputed or cached) and in MATLAB's
// linear color mode.
//
// Numerics rules carried over from the JAX package: per-component d2
// (never |x|^2+|y|^2-2x.y), and an accurate exp.  Build without
// --use_fast_math.  The one exception is the compile-time flag FAST of the
// pair functions, params.exp_mode="fast" (the JAX package's jnp.exp(-z) in
// place of exp_neg, pallas_gram.py:96): it takes the card's hardware
// exponential __expf (ex2.approx on the SFU, a few ulp), which converges
// at the MATLAB stops 5e-4/1e-4 only.  Every kernel instantiates both
// forms; FAST=false, the default, is exp_neg.
//
// The tile skip stays exact under FAST.  In se mode the gate d2 < d2_thres
// holds on a skipped tile whatever the exponential.  In linear mode the
// gate is k >= sp_thres alone, and a tile is skipped where every d2 >
// d2_thres + SKIP_MARGIN (1e-5 m^2): there the exact k is below sp_thres
// by the factor exp(-1e-5 / 2 ell^2), a relative gap of 1e-5 / 2 ell^2
// (2.2e-4 at ell 0.15, 5e-5 at ell 0.3), while __expf's error at the gate
// (|z| = ln(s2 / sp_thres) = 2.3 at the MATLAB parameters, 2 +
// floor(1.17 |z|) = 4 ulp) and the rounding of z = d2 / 2 ell^2 together
// stay below 1e-6 relative.  tests/test_torch_fastexp.py holds the bound
// at the largest ell the schedules and acvo reach.
#pragma once

#include <cuda_runtime.h>

namespace cvo {

// Scalar row written by cvo_rgbd_torch/ops/gram.py:scalars, the layout
// of the JAX package's _scal_vector.
enum Scal {
  S_ELL = 0,
  S_S2,
  S_CS2,
  S_INV_2L2,
  S_INV_2CL2,
  S_D2_THRES,
  S_D2_C_THRES,
  S_SP_THRES,
  N_SCAL
};

constexpr int NFEAT = 5;

__device__ __forceinline__ float exp_neg(float z) {
  z = fminf(z, 80.0f);
  const float n = rintf(z * 1.4426950408889634f);
  const float r = (z - n * 0.693145751953125f) - n * 1.42860677e-06f;
  float p = 1.9761959601e-04f;
  p = p * (-r) + 1.3944149940e-03f;
  p = p * (-r) + 8.3335634999e-03f;
  p = p * (-r) + 4.1666287710e-02f;
  p = p * (-r) + 1.6666665277e-01f;
  p = p * (-r) + 5.0000000815e-01f;
  p = p * (-r) + 1.0000000002e+00f;
  p = p * (-r) + 9.9999999997e-01f;
  return p * __int_as_float((127 - static_cast<int>(n)) << 23);
}

// exp(-z) of the Gram: exp_neg, or with FAST the hardware __expf.
template <bool FAST>
__device__ __forceinline__ float gram_exp(float z) {
  if constexpr (FAST) {
    return __expf(-z);
  } else {
    return exp_neg(z);
  }
}

// Squared distance in difference form, summed in the JAX order.
__device__ __forceinline__ float sqdist3(float x0, float x1, float x2,
                                         float y0, float y1, float y2) {
  const float d0 = x0 - y0, d1 = x1 - y1, d2 = x2 - y2;
  return d0 * d0 + d1 * d1 + d2 * d2;
}

// Color kernel cs2*exp(-d2c/2c_ell^2) of two 5-feature rows; d2c out.
template <bool FAST = false>
__device__ __forceinline__ float color_kernel(const float* fx,
                                              const float* fy,
                                              const float* s, float* d2c) {
  float d = fx[0] - fy[0];
  float acc = d * d;
#pragma unroll
  for (int c = 1; c < NFEAT; ++c) {
    d = fx[c] - fy[c];
    acc = acc + d * d;
  }
  *d2c = acc;
  return s[S_CS2] * gram_exp<FAST>(acc * s[S_INV_2CL2]);
}

// A_ij with the cached color kernel ck (zero where the color gate or a
// mask fails, cvo_rgbd_torch/ops/gram.py:color_gram).
template <bool FAST = false>
__device__ __forceinline__ float pair_cached(float d2, float ck,
                                             const float* s) {
  const float k = s[S_S2] * gram_exp<FAST>(d2 * s[S_INV_2L2]);
  const float a = k * ck;
  return (d2 < s[S_D2_THRES] && a > s[S_SP_THRES]) ? a : 0.0f;
}

// A_ij with the color kernel recomputed: the full reference gate
// (cvo.cpp:119-153) on position radius, color radius, sparsity and masks.
template <bool FAST = false>
__device__ __forceinline__ float pair_full(float d2, const float* fx,
                                           float xm, const float* fy,
                                           float ym, const float* s) {
  const float k = s[S_S2] * gram_exp<FAST>(d2 * s[S_INV_2L2]);
  float d2c;
  const float ck = color_kernel<FAST>(fx, fy, s, &d2c);
  const float a = k * ck;
  const bool gate = d2 < s[S_D2_THRES] && d2c < s[S_D2_C_THRES] &&
                    a > s[S_SP_THRES] && xm > 0.0f && ym > 0.0f;
  return gate ? a : 0.0f;
}

// A_ij in MATLAB's linear color mode (rkhs_se3_registration.m:125-127): ci
// is the pair's pre-masked linear color weight (zero where a mask fails),
// the gate is on the position kernel alone, k >= sp_thres, with no d2 gate.
template <bool FAST = false>
__device__ __forceinline__ float pair_linear(float d2, float ci,
                                             const float* s) {
  const float k = s[S_S2] * gram_exp<FAST>(d2 * s[S_INV_2L2]);
  return k >= s[S_SP_THRES] ? ci * k : 0.0f;
}

}  // namespace cvo
