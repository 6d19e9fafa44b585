// Device functions shared by the CVO kernels.
//
// exp_neg ports the JAX package's core/numerics.py:exp_neg (same constants,
// same operation order, rintf rounds half to even like jnp.round), and
// the pair_* functions port the JAX package's ops/pallas_gram.py:_pair_tile:
// the gated kernel entry A_ij of one fixed point i and one moving point j.
//
// Numerics rules carried over from the JAX package: per-component d2
// (never |x|^2+|y|^2-2x.y), and an accurate exp, never __expf.  Build
// without --use_fast_math.
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

// Squared distance in difference form, summed in the JAX order.
__device__ __forceinline__ float sqdist3(float x0, float x1, float x2,
                                         float y0, float y1, float y2) {
  const float d0 = x0 - y0, d1 = x1 - y1, d2 = x2 - y2;
  return d0 * d0 + d1 * d1 + d2 * d2;
}

// Color kernel cs2*exp(-d2c/2c_ell^2) of two 5-feature rows; d2c out.
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
  return s[S_CS2] * exp_neg(acc * s[S_INV_2CL2]);
}

// A_ij with the cached color kernel ck (zero where the color gate or a
// mask fails, cvo_rgbd_torch/ops/gram.py:color_gram).
__device__ __forceinline__ float pair_cached(float d2, float ck,
                                             const float* s) {
  const float k = s[S_S2] * exp_neg(d2 * s[S_INV_2L2]);
  const float a = k * ck;
  return (d2 < s[S_D2_THRES] && a > s[S_SP_THRES]) ? a : 0.0f;
}

// A_ij with the color kernel recomputed: the full reference gate
// (cvo.cpp:119-153) on position radius, color radius, sparsity and masks.
__device__ __forceinline__ float pair_full(float d2, const float* fx,
                                           float xm, const float* fy,
                                           float ym, const float* s) {
  const float k = s[S_S2] * exp_neg(d2 * s[S_INV_2L2]);
  float d2c;
  const float ck = color_kernel(fx, fy, s, &d2c);
  const float a = k * ck;
  const bool gate = d2 < s[S_D2_THRES] && d2c < s[S_D2_C_THRES] &&
                    a > s[S_SP_THRES] && xm > 0.0f && ym > 0.0f;
  return gate ? a : 0.0f;
}

}  // namespace cvo
