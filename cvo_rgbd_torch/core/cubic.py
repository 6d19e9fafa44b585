"""Closed-form cubic root solver for the CVO line search.

Port of the JAX package's `core/cubic.py`.  The reference finds the roots of
4E t^3 + 3D t^2 + 2C t + B (the derivative of the quartic line-search
objective) with a companion-matrix eigensolve (cvo.cpp:53-69, 291-307);
here the closed form (Cardano + trigonometric method) runs branch-free
on device tensors:
- the variable is rescaled by a Fujiwara-type root bound;
- every candidate gets three Newton polish steps on the original
  polynomial;
- candidates are validated by residual, which rejects a complex pair a
  borderline discriminant projects onto the real axis.

`min_positive_root` reproduces the reference selection: min positive
real root, else `min_step`, clamped to `max_step` (cvo.cpp:298-307).
"""

from __future__ import annotations

import math

import torch

_BIG = float("inf")


def _cbrt(x):
    """Real cube root (torch has no cbrt)."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _eval(a, b, c, d, t):
    return ((a * t + b) * t + c) * t + d


def cubic_roots(a, b, c, d, dtype=torch.float32):
    """Real roots of a t^3 + b t^2 + c t + d, degenerate-degree safe,
    computed in `dtype` (float32 but for a float64 reference).

    Returns (roots [..,3], valid [..,3]); invalid slots hold +inf."""
    a, b, c, d = (v.to(dtype) for v in (a, b, c, d))
    coef_scale = torch.maximum(
        torch.maximum(torch.abs(a), torch.abs(b)),
        torch.maximum(torch.abs(c), torch.abs(d)),
    )
    # far below any coefficient ratio fp32 represents: a leading
    # coefficient 1e-6 of the others still has a genuine (huge) root
    tiny = 1e-12 * torch.clamp_min(coef_scale, 1e-30)
    is_cubic = torch.abs(a) > tiny
    is_quad = ~is_cubic & (torch.abs(b) > tiny)
    is_lin = ~is_cubic & ~is_quad & (torch.abs(c) > tiny)
    one = torch.ones_like(a)

    # --- cubic branch, rescaled: t = tau * u with tau a root bound ---
    a_s = torch.where(is_cubic, a, one)
    tau = torch.maximum(
        torch.maximum(torch.abs(b / a_s), torch.sqrt(torch.abs(c / a_s))),
        _cbrt(torch.abs(d / a_s)),
    )
    tau = torch.clamp_min(tau, 1e-20)
    p = b / (a_s * tau)
    q = c / (a_s * tau * tau)
    r = d / (a_s * tau * tau * tau)
    # depressed: u = s - p/3 ;  s^3 + ps*s + qs
    ps = q - p * p / 3.0
    qs = 2.0 * (p * p * p) / 27.0 - p * q / 3.0 + r
    delta = (qs / 2.0) * (qs / 2.0) + (ps / 3.0) * (ps / 3.0) * (ps / 3.0)

    # one real root (delta > 0)
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    s_single = _cbrt(-qs / 2.0 + sq) + _cbrt(-qs / 2.0 - sq)

    # three real roots (delta <= 0, ps <= 0)
    ps_neg = torch.clamp_max(ps, -1e-30)
    m = 2.0 * torch.sqrt(-ps_neg / 3.0)
    denom = ps_neg * m
    denom = torch.where(torch.abs(denom) < 1e-30, torch.full_like(denom, -1e-30),
                   denom)
    acos_arg = torch.clamp(3.0 * qs / denom, -1.0, 1.0)
    phi = torch.acos(acos_arg)
    k = torch.arange(3, dtype=dtype, device=a.device)
    s_triple = m[..., None] * torch.cos(
        (phi[..., None] - 2.0 * math.pi * k) / 3.0
    )

    three = delta <= 0
    # the largest-magnitude trig root is well-conditioned under tau
    u_triple = s_triple - p[..., None] / 3.0
    u_dom3 = torch.gather(
        u_triple, -1, torch.argmax(torch.abs(u_triple), dim=-1)[..., None]
    )[..., 0]
    t1 = tau * torch.where(three, u_dom3, s_single - p / 3.0)

    # deflate by (t - t1) in the ORIGINAL scale; backward deflation
    # (match the constant term first) since t1 is the dominant root
    use_back = torch.abs(t1) >= 1e-20
    t1_s = torch.where(use_back, t1, one)
    c2_back = -d / t1_s
    b2_back = (c2_back - c) / t1_s
    b2_fwd = b + a * t1
    c2_fwd = c + t1 * b2_fwd
    b2 = torch.where(use_back, b2_back, b2_fwd)
    c2 = torch.where(use_back, c2_back, c2_fwd)
    ddisc = b2 * b2 - 4.0 * a_s * c2
    dsq = torch.sqrt(torch.clamp_min(ddisc, 0.0))
    dtmp = -0.5 * (b2 + torch.sign(b2 + (b2 == 0).to(b2.dtype)) * dsq)
    d1 = dtmp / a_s
    dtmp_ok = torch.abs(dtmp) > 1e-30
    d2r = torch.where(dtmp_ok, c2 / dtmp, torch.zeros_like(c2))
    cub_roots = torch.stack([t1, d1, d2r], dim=-1)
    cub_valid = torch.stack(
        [torch.ones_like(ddisc, dtype=torch.bool), ddisc >= 0,
         (ddisc >= 0) & dtmp_ok],
        dim=-1,
    )

    # --- quadratic branch ---
    b_s = torch.where(is_quad, b, one)
    qdisc = c * c - 4.0 * b_s * d
    qsq = torch.sqrt(torch.clamp_min(qdisc, 0.0))
    qtmp = -0.5 * (c + torch.sign(c + (c == 0).to(c.dtype)) * qsq)
    q1 = qtmp / b_s
    qtmp_ok = torch.abs(qtmp) > 1e-30
    q2 = torch.where(qtmp_ok, d / qtmp, torch.zeros_like(d))
    quad_roots = torch.stack([q1, q2, torch.zeros_like(q1)], dim=-1)
    false = torch.zeros_like(qdisc, dtype=torch.bool)
    quad_valid = torch.stack(
        [qdisc >= 0, (qdisc >= 0) & qtmp_ok, false], dim=-1
    )

    # --- linear branch ---
    c_s = torch.where(is_lin, c, one)
    zero = torch.zeros_like(p)
    lin_roots = torch.stack([-d / c_s, zero, zero], dim=-1)
    lin_valid = torch.stack([~false, false, false], dim=-1)

    cub = is_cubic[..., None]
    quad = is_quad[..., None]
    lin = is_lin[..., None]
    roots = torch.where(cub, cub_roots,
                   torch.where(quad, quad_roots,
                          torch.where(lin, lin_roots, torch.zeros_like(cub_roots))))
    valid = torch.where(cub, cub_valid,
                   torch.where(quad, quad_valid,
                          torch.where(lin, lin_valid, torch.zeros_like(cub_valid))))

    # --- Newton polish (3 steps) + residual validation ---
    ab, bb, cb, db = (v[..., None] for v in (a, b, c, d))

    def polish(t):
        pv = _eval(ab, bb, cb, db, t)
        dp = (3.0 * ab * t + 2.0 * bb) * t + cb
        dp = torch.where(torch.abs(dp) < 1e-30, torch.full_like(dp, 1e-30), dp)
        return t - pv / dp

    polished = polish(polish(polish(roots)))
    near = torch.abs(polished - roots) <= 0.25 * (torch.abs(roots) + 1.0)
    roots = torch.where(torch.isfinite(polished) & near, polished, roots)

    # residual test: |p(t)| small relative to the term magnitudes
    res = torch.abs(_eval(ab, bb, cb, db, roots))
    term = torch.maximum(
        torch.maximum(torch.abs(ab * (roots * roots * roots)),
                      torch.abs(bb * (roots * roots))),
        torch.maximum(torch.abs(cb * roots), torch.abs(db)),
    )
    valid = valid & (res <= 1e-3 * torch.clamp_min(term, 1e-30))
    roots = torch.where(valid, roots, torch.full_like(roots, _BIG))
    return roots, valid


def min_positive_root(roots, valid, min_step, max_step):
    """Reference step selection (cvo.cpp:298-307): min positive real
    root; if none, min_step; clamped to max_step."""
    ok = valid & (roots > 0) & torch.isfinite(roots)
    best = torch.where(ok, roots, _BIG).amin(dim=-1)
    step = torch.where(torch.isfinite(best), best, min_step)
    return torch.clamp_max(step, max_step)
