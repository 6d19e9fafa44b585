// Scalar tail of one align iteration, for one thread: the line-search
// cubic, the SE_K(3) exponential and the se(3) distance of the stop.
//
// Transcribed from the port's core/cubic.py (cubic_roots followed by
// min_positive_root) and se3.py (exp_sek3, dist_se3, with their
// left_jacobian_inv_so3 and log_so3), in the same operation order, so the
// plain version of ops/align_fused.py and the kernel agree to fp32
// rounding.  acosf, cbrtf, sinf and cosf are the accurate library
// functions: build without --use_fast_math.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace cvo {

constexpr float TWO_PI = 6.2831855f;  // float(2 * pi), as torch rounds it

__device__ __forceinline__ float cubic_eval(float a, float b, float c,
                                            float d, float t) {
  return ((a * t + b) * t + c) * t + d;
}

__device__ __forceinline__ float sign_nz(float x) {
  // torch.sign(x + (x == 0)): 1 for x >= 0, -1 below
  return x < 0.0f ? -1.0f : 1.0f;
}

// Min positive real root of a t^3 + b t^2 + c t + d, else min_step,
// clamped to max_step (cvo.cpp:298-307).
__device__ float cubic_step(float a, float b, float c, float d,
                            float min_step, float max_step) {
  const float coef_scale =
      fmaxf(fmaxf(fabsf(a), fabsf(b)), fmaxf(fabsf(c), fabsf(d)));
  const float tiny = 1e-12f * fmaxf(coef_scale, 1e-30f);
  const bool is_cubic = fabsf(a) > tiny;
  const bool is_quad = !is_cubic && fabsf(b) > tiny;
  const bool is_lin = !is_cubic && !is_quad && fabsf(c) > tiny;

  // cubic branch, rescaled: t = tau * u with tau a root bound
  const float a_s = is_cubic ? a : 1.0f;
  float tau = fmaxf(fmaxf(fabsf(b / a_s), sqrtf(fabsf(c / a_s))),
                    cbrtf(fabsf(d / a_s)));
  tau = fmaxf(tau, 1e-20f);
  const float p = b / (a_s * tau);
  const float q = c / (a_s * tau * tau);
  const float r = d / (a_s * tau * tau * tau);
  const float ps = q - p * p / 3.0f;
  const float qs = 2.0f * (p * p * p) / 27.0f - p * q / 3.0f + r;
  const float delta = (qs / 2.0f) * (qs / 2.0f) +
                      (ps / 3.0f) * (ps / 3.0f) * (ps / 3.0f);
  const float sq = sqrtf(fmaxf(delta, 0.0f));
  const float s_single = cbrtf(-qs / 2.0f + sq) + cbrtf(-qs / 2.0f - sq);

  const float ps_neg = fminf(ps, -1e-30f);
  const float mm = 2.0f * sqrtf(-ps_neg / 3.0f);
  float denom = ps_neg * mm;
  if (fabsf(denom) < 1e-30f) denom = -1e-30f;
  const float acos_arg = fminf(fmaxf(3.0f * qs / denom, -1.0f), 1.0f);
  const float phi = acosf(acos_arg);
  float u_dom = 0.0f;
  float u_abs = -1.0f;
  for (int k = 0; k < 3; ++k) {
    const float u =
        mm * cosf((phi - TWO_PI * static_cast<float>(k)) / 3.0f) - p / 3.0f;
    if (fabsf(u) > u_abs) {  // first maximum, as torch.argmax
      u_abs = fabsf(u);
      u_dom = u;
    }
  }
  const bool three = delta <= 0.0f;
  const float t1 = tau * (three ? u_dom : s_single - p / 3.0f);

  // deflate by (t - t1), backward (constant term first)
  const bool use_back = fabsf(t1) >= 1e-20f;
  const float t1_s = use_back ? t1 : 1.0f;
  const float c2_back = -d / t1_s;
  const float b2_back = (c2_back - c) / t1_s;
  const float b2_fwd = b + a * t1;
  const float c2_fwd = c + t1 * b2_fwd;
  const float b2 = use_back ? b2_back : b2_fwd;
  const float c2 = use_back ? c2_back : c2_fwd;
  const float ddisc = b2 * b2 - 4.0f * a_s * c2;
  const float dsq = sqrtf(fmaxf(ddisc, 0.0f));
  const float dtmp = -0.5f * (b2 + sign_nz(b2) * dsq);
  const bool dtmp_ok = fabsf(dtmp) > 1e-30f;

  // quadratic branch
  const float b_s = is_quad ? b : 1.0f;
  const float qdisc = c * c - 4.0f * b_s * d;
  const float qsq = sqrtf(fmaxf(qdisc, 0.0f));
  const float qtmp = -0.5f * (c + sign_nz(c) * qsq);
  const bool qtmp_ok = fabsf(qtmp) > 1e-30f;

  // linear branch
  const float c_s = is_lin ? c : 1.0f;

  float roots[3] = {0.0f, 0.0f, 0.0f};
  bool valid[3] = {false, false, false};
  if (is_cubic) {
    roots[0] = t1;
    roots[1] = dtmp / a_s;
    roots[2] = dtmp_ok ? c2 / dtmp : 0.0f;
    valid[0] = true;
    valid[1] = ddisc >= 0.0f;
    valid[2] = ddisc >= 0.0f && dtmp_ok;
  } else if (is_quad) {
    roots[0] = qtmp / b_s;
    roots[1] = qtmp_ok ? d / qtmp : 0.0f;
    valid[0] = qdisc >= 0.0f;
    valid[1] = qdisc >= 0.0f && qtmp_ok;
  } else if (is_lin) {
    roots[0] = -d / c_s;
    valid[0] = true;
  }

  float best = INFINITY;
  for (int k = 0; k < 3; ++k) {
    // three Newton steps on the original polynomial, kept when finite
    // and near; then the residual test
    float t = roots[k];
    for (int s = 0; s < 3; ++s) {
      const float pv = cubic_eval(a, b, c, d, t);
      float dp = (3.0f * a * t + 2.0f * b) * t + c;
      if (fabsf(dp) < 1e-30f) dp = 1e-30f;
      t = t - pv / dp;
    }
    const bool near = fabsf(t - roots[k]) <= 0.25f * (fabsf(roots[k]) + 1.0f);
    const float root = (isfinite(t) && near) ? t : roots[k];
    const float res = fabsf(cubic_eval(a, b, c, d, root));
    const float term =
        fmaxf(fmaxf(fabsf(a * (root * root * root)), fabsf(b * (root * root))),
              fmaxf(fabsf(c * root), fabsf(d)));
    const bool ok = valid[k] && res <= 1e-3f * fmaxf(term, 1e-30f) &&
                    root > 0.0f && isfinite(root);
    if (ok) best = fminf(best, root);
  }
  const float step = isfinite(best) ? best : min_step;
  return fminf(step, max_step);
}

// out = I + c1 * skew(w) + c2 * skew(w)^2, row-major; skew(w)^2 formed
// as the matrix product, as se3.py does
__device__ __forceinline__ void rod(const float* w, float c0, float c1,
                                    float c2, float* out) {
  const float S[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0], -w[1], w[0], 0.0f};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float s2 = S[3 * i] * S[j] + S[3 * i + 1] * S[3 + j] +
                       S[3 * i + 2] * S[6 + j];
      out[3 * i + j] = (i == j ? c0 : 0.0f) + c1 * S[3 * i + j] + c2 * s2;
    }
}

__device__ __forceinline__ void mat3_vec(const float* A, const float* v,
                                         float* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// (dR, dT) = Exp_SEK3([omega; v], dt), LieGroup.cpp:159-186, with the
// reference quirk Jl = I (not dt I) below TOLERANCE.
__device__ void exp_sek3(const float* om, const float* v, float dt,
                         float* dR, float* dT) {
  const float th2 = dot3(om, om);
  const bool small = th2 < 1e-12f;
  const float th = sqrtf(small ? 1.0f : th2);
  const float th2s = th * th;
  const float st = sinf(dt * th);
  const float ct = cosf(dt * th);
  const float one_m_ct = (1.0f - ct) / th2s;
  float Jl[9];
  rod(om, 1.0f, st / th, one_m_ct, dR);
  rod(om, dt, one_m_ct, (dt * th - st) / (th2s * th), Jl);
  if (small) {
    for (int i = 0; i < 9; ++i) dR[i] = Jl[i] = (i % 4 == 0) ? 1.0f : 0.0f;
  }
  mat3_vec(Jl, v, dT);
}

// sqrt(2 |w|^2 + |u|^2), w = log_so3(R), u = Jl^-1(w) t (cvo.cpp:71-81).
__device__ float dist_se3(const float* R, const float* t) {
  const float tr = R[0] + R[4] + R[8];
  const float cos_th = fminf(fmaxf((tr - 1.0f) / 2.0f, -1.0f), 1.0f);
  const float th = acosf(cos_th);
  const bool small = th < 1e-6f;
  const float th_s = small ? 1.0f : th;
  float f = th_s / (2.0f * sinf(th_s));
  if (small) f = 0.5f + th * th / 12.0f;
  const float w[3] = {f * (R[7] - R[5]), f * (R[2] - R[6]),
                      f * (R[3] - R[1])};
  const float wth2 = dot3(w, w);
  const bool wsmall = wth2 < 1e-12f;
  const float wth = sqrtf(wsmall ? 1.0f : wth2);
  float c = 1.0f / (wth * wth) -
            (1.0f + cosf(wth)) / (2.0f * wth * sinf(wth));
  if (wsmall) c = 1.0f / 12.0f + wth2 / 720.0f;
  float Jinv[9];
  rod(w, 1.0f, -0.5f, c, Jinv);
  float u[3];
  mat3_vec(Jinv, t, u);
  return sqrtf(2.0f * wth2 + dot3(u, u));
}

}  // namespace cvo
