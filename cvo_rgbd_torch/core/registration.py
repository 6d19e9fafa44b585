"""Frame-to-frame RKHS SE(3) registration — the align loop.

Port of the JAX package's `core/registration.py` for cvo and adaptive
cvo (acvo) on two backends: "kernel" (the JAX "pallas" backend, the
hand-written CUDA kernels of `cvo_rgbd_torch.ops`) and "dense" (the JAX
"xla" backend, the dense masked Gram in plain torch).  Reference loop
semantics (cvo.cpp:361-420, adaptive_cvo.cpp:490-555), kept exactly:

  per iteration k:
    tf   = [R', -R'T]                  (update_tf, cvo.cpp:83-87)
    y    = tf * y0                     (transform_pcd, cvo.cpp:310-315)
    kernel: Mom, nnz = fused_moments   (one Gram sweep, ops/moments.py)
    dense:  A = se_gram                (core/gram.py)
    omega, v [, dl] ; B..E ; step      (epilogues)
    if |omega|<eps and |v|<eps: break  (BEFORE the update, cvo.cpp:380)
    dR, dT = Exp_SEK3([omega;v], step) (cvo.cpp:391)
    T = R dT + T ; R = R dR            (cvo.cpp:398-399)
    if dist_se3(dR,dT)<eps_2: break    (AFTER the update, cvo.cpp:402)
    cvo:  ell schedule k>2/9/19        (cvo.cpp:408-410)
    acvo: ell += dl_step*dl, shrinking ceiling, floor
                                       (adaptive_cvo.cpp:537-545)

and the returned `tf` is the one from the top of the last executed
iteration (cvo.cpp:413-415).

acvo's dl needs sum A|x-y|^2 and nnz of the cross Gram (from the moment
sweep) and of the self-Grams Axx, Ayy: on the kernel backend two
`fused_wsq` sweeps per iteration (`self_mode="exact"`), or per-align
Chebyshev tables in ell (`self_mode="cheb"`).

The loop state lives on the device and the host never waits on it per
iteration.  Once converged, every state field freezes (the JAX body's
freeze-on-converge), so iterations run past convergence are exact
no-ops, and the host reads `converged` once every CHECK_EVERY
iterations with a single `.item()`.  The result is bit-identical to
stopping at the first converged iteration, because `k` freezes too.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cvo_rgbd_torch import se3
from cvo_rgbd_torch.core import flow as flow_mod
from cvo_rgbd_torch.core.cloud import (
    PointCloud,
    aabb_min_d2,
    block_bounds,
    kd_sort,
    transform_cloud,
)
from cvo_rgbd_torch.core.cubic import cubic_roots, min_positive_root
from cvo_rgbd_torch.core.gram import (
    linear_color_gram,
    matlab_gram,
    se_gram,
)
from cvo_rgbd_torch.core.moments import flow_from_moments, step_from_moments
from cvo_rgbd_torch.core.step import step_size
from cvo_rgbd_torch.core.step_factored import (
    monomial_features,
    step_coefficients_factored,
)
from cvo_rgbd_torch.device import pin_fp32, resolve_device
from cvo_rgbd_torch.ops import color_gram, fused_moments, fused_wsq
from cvo_rgbd_torch.ops.moments import TILE_I, TILE_J
from cvo_rgbd_torch.ops.wsq import TILE_W
from cvo_rgbd_torch.params import AcvoParams

# iterations between host reads of `converged`
CHECK_EVERY = 8


class AlignState(NamedTuple):
    k: torch.Tensor          # iteration counter, int32
    R: torch.Tensor          # [3,3]
    T: torch.Tensor          # [3]
    ell: torch.Tensor        # current length-scale
    ell_max: torch.Tensor    # adaptive ceiling (unused for cvo)
    tf: torch.Tensor         # [4,4] inverse transform from top of last iter
    converged: torch.Tensor  # bool
    omega: torch.Tensor      # [3] last flow (diagnostics)
    v: torch.Tensor          # [3]


class AlignResult(NamedTuple):
    tf: torch.Tensor         # [4,4] the transform the reference chains into accum
    R: torch.Tensor          # final R (internal state)
    T: torch.Tensor          # final T
    iterations: torch.Tensor
    converged: torch.Tensor
    ell: torch.Tensor
    omega: torch.Tensor
    v: torch.Tensor


class AlignPre(NamedTuple):
    """Loop-invariant precomputations of the kernel backend."""

    ck: tuple | None      # (ck_xy, ck_xx, ck_yy); None when ck_cache is off
    moments: tuple        # (c0, x - c0, Phi(x - c0))
    skip: tuple | None    # (lo_x, hi_x, md_xx, md_yy); None: tile_skip off
    cheb: tuple | None    # self_mode="cheb" tables; None otherwise


def check_supported(p) -> None:
    """Raise for what this slice of the port does not run."""
    adaptive = isinstance(p, AcvoParams)
    if p.backend == "fused":
        raise NotImplementedError(
            "backend='fused' (the whole-align kernel) is not ported yet: "
            "ROADMAP queue 2, kernels #4-#5"
        )
    if p.backend not in ("kernel", "dense"):
        raise ValueError(f"unknown backend {p.backend!r}")
    if adaptive and p.backend == "kernel":
        # as the JAX package's pallas backend
        if p.color_mode == "linear":
            raise ValueError(
                "the kernel backend supports linear color mode for cvo only"
            )
        if p.yy_quirk:
            raise ValueError("yy_quirk emulation requires backend='dense'")
    if p.color_mode != "se":
        raise NotImplementedError(
            f"color_mode={p.color_mode!r} is not ported yet: ROADMAP queue "
            "1, item 14"
        )
    if p.exp_mode != "precise":
        raise NotImplementedError(
            f"exp_mode={p.exp_mode!r} is not ported yet: ROADMAP queue 1, "
            "item 4"
        )


def _schedule_ell(ell, k, sched):
    """Fixed schedule (cvo.cpp:408-410): applied at end of iteration k."""
    for thresh, val in sched:
        ell = torch.where(k > thresh, val, ell)
    return ell


def _self(cloud: PointCloud):
    return (*cloud, *cloud)


def build_ck_caches(p, adaptive, fixed: PointCloud, moving: PointCloud):
    """Loop-invariant color-kernel caches (ck_xy, ck_xx, ck_yy), the
    self-pairs for acvo only; None when `p.ck_cache` is off.  Features
    never transform (cvo.cpp:143-153).  Each is an [N,M] f32 tensor."""
    if not p.ck_cache:
        return None
    ck_xy = color_gram(*fixed, *moving, p=p)
    if not adaptive:
        return ck_xy, None, None
    return (ck_xy, color_gram(*_self(fixed), p=p),
            color_gram(*_self(moving), p=p))


def build_moments_pre(fixed: PointCloud):
    """(c0, x - c0, Phi(x - c0)): the masked centroid keeps |x'| at
    cloud-extent scale, which bounds the degree-4 monomial
    cancellation in fp32 (core/step_factored.py)."""
    w = fixed.mask
    c0 = torch.sum(fixed.positions * w[:, None], dim=0) / torch.clamp_min(
        torch.sum(w), 1.0
    )
    x_c = fixed.positions - c0
    return c0, x_c, monomial_features(x_c)


def _self_bounds(cloud: PointCloud):
    lo, hi = block_bounds(cloud.positions, cloud.mask, TILE_W)
    return aabb_min_d2(lo, hi, lo, hi)


def build_skip_pre(p, adaptive, fixed: PointCloud, moving: PointCloud):
    """Tile bounds for the exact AABB skip, (lo_x, hi_x, md_xx, md_yy);
    None when `p.tile_skip` is off.  lo_x/hi_x are the fixed cloud's at
    the moment kernel's row tile (it never moves).  md_xx/md_yy (acvo
    only) are the self-sweep bound matrices at TILE_W, computed ONCE from
    the untransformed clouds: distances inside one rigidly moved cloud
    do not change (the transform's fp32 rounding is far below
    SKIP_MARGIN)."""
    if not p.tile_skip:
        return None
    lo_x, hi_x = block_bounds(fixed.positions, fixed.mask, TILE_I)
    md_xx = md_yy = None
    if adaptive:
        md_xx, md_yy = _self_bounds(fixed), _self_bounds(moving)
    return lo_x, hi_x, md_xx, md_yy


def build_selfsweep_cheb(p, adaptive, fixed: PointCloud, moving: PointCloud,
                         ck_caches, skip_pre, ell0=None):
    """Per-align Chebyshev tables of the four self-sweep reductions
    (`self_mode="cheb"`): wsq_xx, nnz_xx, wsq_yy, nnz_yy are functions
    of ell alone (self distances are rigid-invariant), so K sweep pairs
    at log-space Chebyshev nodes replace a pair every iteration.
    Returns (log values [4, K], (lo, hi, nodes, weights)) or None.

    The span is [ell_min, max(ell_max_init, ell0)]: ell never exceeds
    its ceiling within an align.  An `ell0` that is a number or a CPU
    tensor widens it; a CUDA tensor keeps the default span, so building
    the tables adds no host sync (as a traced ell0 in the JAX package)."""
    if not adaptive or p.backend != "kernel" or p.self_mode != "cheb":
        return None
    K = int(p.self_cheb_k)
    ell_hi = p.ell_max_init
    if ell0 is not None and not (
        isinstance(ell0, torch.Tensor) and ell0.device.type != "cpu"
    ):
        ell_hi = max(ell_hi, float(ell0))
    lo = math.log(1.0 / (2.0 * ell_hi ** 2))
    hi = math.log(1.0 / (2.0 * p.ell_min ** 2))
    kk = torch.arange(K, dtype=torch.float64)
    xch = torch.cos(math.pi * (kk + 0.5) / K)
    t_nodes = 0.5 * (lo + hi) + 0.5 * (hi - lo) * xch
    ell_nodes = 1.0 / torch.sqrt(2.0 * torch.exp(t_nodes))
    wts = (-1.0) ** kk * torch.sin(math.pi * (kk + 0.5) / K)

    dev = fixed.positions.device
    _, ck_xx, ck_yy = ck_caches if ck_caches else (None,) * 3
    md_xx = md_yy = None
    if skip_pre is not None:
        _, _, md_xx, md_yy = skip_pre
    cols = []
    for e in ell_nodes.tolist():
        ell = torch.tensor(e, dtype=torch.float32, device=dev)
        wxx, nxx = fused_wsq(*_self(fixed), ell, ck_xx, md_xx, p=p,
                             symmetric=True)
        wyy, nyy = fused_wsq(*_self(moving), ell, ck_yy, md_yy, p=p,
                             symmetric=True)
        cols.append(torch.stack([wxx, nxx, wyy, nyy]))
    logv = torch.log(torch.clamp_min(torch.stack(cols, dim=1), 1e-30))

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32).to(dev)

    return logv, (f32(lo), f32(hi), f32(xch), f32(wts))


def _cheb_self(cheb_pre, ell):
    """(wsq_xx, nnz_xx, wsq_yy, nnz_yy) at `ell` from the tables:
    barycentric interpolation in t = log(1/2ell^2), exact at a node."""
    logv, (lo_t, hi_t, xch, wts) = cheb_pre
    t = torch.log(1.0 / (2.0 * ell * ell))
    x = torch.clamp((2.0 * t - (lo_t + hi_t)) / (hi_t - lo_t), -1.0, 1.0)
    dch = x - xch
    hit = torch.abs(dch) < 1e-10
    tt = wts / torch.where(hit, 1.0, dch)
    interp = torch.sum(tt[None, :] * logv, dim=1) / torch.sum(tt)
    exact_row = torch.sum(torch.where(hit[None, :], logv, 0.0), dim=1)
    return torch.exp(torch.where(torch.any(hit), exact_row, interp))


def prepare(p, fixed: PointCloud, moving: PointCloud, ell0=None):
    """The kernel backend's AlignPre for (already kd-sorted) clouds; None
    for the dense backend, which precomputes nothing."""
    if p.backend != "kernel":
        return None
    adaptive = isinstance(p, AcvoParams)
    ck = build_ck_caches(p, adaptive, fixed, moving)
    skip = build_skip_pre(p, adaptive, fixed, moving)
    cheb = build_selfsweep_cheb(p, adaptive, fixed, moving, ck, skip, ell0)
    return AlignPre(ck, build_moments_pre(fixed), skip, cheb)


def _kernel_terms(p, adaptive, state, fixed, moving, y_pos, pre):
    """(omega, v, step, dl) of one kernel-backend iteration."""
    ck_xy, ck_xx, ck_yy = pre.ck if pre.ck else (None,) * 3
    c0, x_c, phi = pre.moments
    md_xy = md_xx = md_yy = None
    if pre.skip is not None:
        # the gap is shift-invariant: uncentered bounds serve the
        # centered kernel coordinates
        lo_x, hi_x, md_xx, md_yy = pre.skip
        lo_y, hi_y = block_bounds(y_pos, moving.mask, TILE_J)
        md_xy = aabb_min_d2(lo_x, hi_x, lo_y, hi_y)
    Mom, nnz_xy = fused_moments(
        x_c, fixed.features, fixed.mask,
        y_pos - c0, moving.features, moving.mask,
        phi, state.ell, ck_xy, md_xy, p=p,
    )
    omega, v, wsq_xy, _ = flow_from_moments(Mom, y_pos, c0, c=p.c, d=p.d)
    dl = None
    if adaptive:
        # the self-Grams feed only dl (adaptive_cvo.cpp:156-160,
        # 222-271): two lean sweeps, or the per-align tables
        if pre.cheb is not None:
            wsq_xx, nnz_xx, wsq_yy, nnz_yy = _cheb_self(pre.cheb, state.ell)
        else:
            wsq_xx, nnz_xx = fused_wsq(*_self(fixed), state.ell, ck_xx,
                                       md_xx, p=p, symmetric=True)
            y_cloud = (y_pos, moving.features, moving.mask)
            wsq_yy, nnz_yy = fused_wsq(*y_cloud, *y_cloud, state.ell, ck_yy,
                                       md_yy, p=p, symmetric=True)
        ell3 = state.ell * (state.ell * state.ell)
        numer = (wsq_yy - 2.0 * wsq_xy + wsq_xx) / ell3
        denom = nnz_xx + nnz_yy - 2.0 * nnz_xy
        dl = numer / torch.where(denom == 0, 1.0, denom)
    B, C, D, E = step_from_moments(Mom, y_pos, c0, omega, v, state.ell)
    roots, valid = cubic_roots(4.0 * E, 3.0 * D, 2.0 * C, B)
    step = min_positive_root(roots, valid, p.min_step, p.max_step)
    return omega, v, step, dl


def _gram(p, x_pos, x: PointCloud, y_pos, y: PointCloud, ell):
    """se_gram of x_pos and y_pos with the features and masks of x, y."""
    return se_gram(
        x_pos, x.features, x.mask, y_pos, y.features, y.mask, ell,
        sigma=p.sigma, c_ell=p.c_ell, c_sigma=p.c_sigma,
        sp_thres=p.sp_thres, c_sp_thres=p.c_sp_thres,
    )


def _dense_terms(p, adaptive, state, fixed, moving, y_pos):
    """(omega, v, step, dl) of one dense-backend iteration."""
    x_pos = fixed.positions
    A = _gram(p, x_pos, fixed, y_pos, moving, state.ell)
    omega, v = flow_mod.flow(A, x_pos, y_pos, c=p.c, d=p.d)
    dl = None
    if adaptive:
        # Axx depends on the iteration only through ell; Ayy moves with y
        Axx = _gram(p, x_pos, fixed, x_pos, fixed, state.ell)
        Ayy = _gram(p, y_pos, moving, y_pos, moving, state.ell)
        dl = flow_mod.adaptive_dl(
            A, Axx, Ayy, x_pos, y_pos, state.ell,
            num_fixed=fixed.num_valid(), yy_quirk=p.yy_quirk,
        )
    if p.step_mode == "factored":
        B, C, D, E = step_coefficients_factored(
            A, x_pos, y_pos, omega, v, state.ell)
        roots, valid = cubic_roots(4.0 * E, 3.0 * D, 2.0 * C, B)
        step = min_positive_root(roots, valid, p.min_step, p.max_step)
    else:
        step = step_size(A, x_pos, y_pos, omega, v, state.ell,
                         min_step=p.min_step, max_step=p.max_step)
    return omega, v, step, dl


def make_align_step(p):
    """The per-iteration body, body(state, fixed, moving, pre) -> state,
    of the backend `p` names; `pre` is `prepare`'s result."""
    adaptive = isinstance(p, AcvoParams)
    kernel = p.backend == "kernel"

    def body(state: AlignState, fixed: PointCloud, moving: PointCloud,
             pre) -> AlignState:
        tf_R, tf_T = se3.se3_inv(state.R, state.T)
        tf = se3.make_se3(tf_R, tf_T)
        y_pos = transform_cloud(tf_R, tf_T, moving.positions)
        if kernel:
            omega, v, step, dl = _kernel_terms(p, adaptive, state, fixed,
                                               moving, y_pos, pre)
        else:
            omega, v, step, dl = _dense_terms(p, adaptive, state, fixed,
                                              moving, y_pos)

        # stop 1: flow norm, BEFORE the update (cvo.cpp:380)
        stop1 = (torch.linalg.norm(omega) < p.eps) & (
            torch.linalg.norm(v) < p.eps
        )
        dR, dT = se3.exp_sek3(omega, v, step)
        R_new = torch.where(stop1, state.R, state.R @ dR)
        T_new = torch.where(
            stop1, state.T, (state.R @ dT[..., None])[..., 0] + state.T
        )
        # stop 2: se3 distance, AFTER the update (cvo.cpp:402)
        stop2 = se3.dist_se3(dR, dT) < p.eps_2
        converged = stop1 | stop2

        if adaptive:
            # ell step, shrinking ceiling, floor (adaptive_cvo.cpp:537-545)
            ell_new = state.ell + p.dl_step * dl
            hit = ell_new >= state.ell_max
            shrunk = state.ell_max * p.ell_shrink
            ell_max_new = torch.where(hit, shrunk, state.ell_max)
            ell_new = torch.clamp_min(torch.where(hit, shrunk, ell_new),
                                      p.ell_min)
        else:
            ell_new = _schedule_ell(state.ell, state.k, p.ell_sched)
            ell_max_new = state.ell_max
        # the reference `break` skips the ell update
        ell_new = torch.where(converged, state.ell, ell_new)

        new_state = AlignState(
            k=state.k + 1,
            R=R_new,
            T=T_new,
            ell=ell_new,
            ell_max=ell_max_new,
            tf=tf,
            converged=converged,
            omega=omega,
            v=v,
        )
        # freeze everything once converged: the extra iterations between
        # host checks change no value
        return AlignState(
            *(torch.where(state.converged, old, new)
              for old, new in zip(state, new_state))
        )

    return body


def init_state(p, device, R0=None, T0=None, ell0=None) -> AlignState:
    """The loop state at iteration 0 on `device`: identity and
    p.ell_init unless R0/T0/ell0 say otherwise; the acvo ceiling starts
    at p.ell_max_init (reset per pair, adaptive_cvo.cpp:477)."""
    f32 = torch.float32

    def given(v, default):
        return (default if v is None
                else torch.as_tensor(v, dtype=f32).to(device))

    ell_max0 = p.ell_max_init if isinstance(p, AcvoParams) else 1e9
    return AlignState(
        k=torch.zeros((), dtype=torch.int32, device=device),
        R=given(R0, torch.eye(3, dtype=f32, device=device)),
        T=given(T0, torch.zeros(3, dtype=f32, device=device)),
        ell=given(ell0, torch.full((), p.ell_init, dtype=f32,
                                   device=device)).reshape(()),
        ell_max=torch.full((), ell_max0, dtype=f32, device=device),
        tf=torch.eye(4, dtype=f32, device=device),
        converged=torch.zeros((), dtype=torch.bool, device=device),
        omega=torch.zeros(3, dtype=f32, device=device),
        v=torch.zeros(3, dtype=f32, device=device),
    )


def align(p, fixed: PointCloud, moving: PointCloud, R0=None, T0=None,
          ell0=None, device=None) -> AlignResult:
    """Register `moving` onto `fixed` on `device` (the card unless
    `device="cpu"`); `p` a CvoParams (cvo) or AcvoParams (acvo).

    `R0`/`T0`/`ell0` warm-start the state: the reference never resets
    R or T between pairs (cvo.cpp:43-45, 398-399), and cvo keeps its
    ell too (cvo.cpp:408-410), so sequential odometry passes the previous
    pair's `AlignResult.R/.T` (and `.ell` for cvo; acvo resets ell per
    pair, adaptive_cvo.cpp:475) — odometry.run_odometry_frames does.
    Defaults: identity, p.ell_init.

    The kernel backend kd-sorts both clouds (compact tiles are what the
    AABB skip prunes); the dense backend keeps the given point order.
    """
    check_supported(p)
    dev = resolve_device(device)
    pin_fp32()
    fixed, moving = fixed.to(dev), moving.to(dev)
    if p.backend == "kernel":
        fixed, moving = kd_sort(fixed), kd_sort(moving)
    state = init_state(p, dev, R0, T0, ell0)
    pre = prepare(p, fixed, moving, ell0)
    body = make_align_step(p)

    for it in range(p.max_iter):
        state = body(state, fixed, moving, pre)
        if (it + 1) % CHECK_EVERY == 0 and bool(state.converged.item()):
            break

    return AlignResult(
        tf=state.tf,
        R=state.R,
        T=state.T,
        iterations=state.k - 1,
        converged=state.converged,
        ell=state.ell,
        omega=state.omega,
        v=state.v,
    )


def function_inner_product(p, cloud_a: PointCloud, cloud_b: PointCloud,
                           ell=None):
    """Mean kernel value over gated pairs (adaptive_cvo.cpp:385-439), on
    the dense Gram, where the clouds lie.

    A keyframe-selection hook of the reference (defined, not called by
    its mains).  The reference gates color with sp_thres, not
    c_sp_thres (adaptive_cvo.cpp:392); kept.  `ell` defaults to
    p.ell_init; pass the previous align's `AlignResult.ell` for the
    reference's member length-scale (adaptive_cvo.cpp:393).  Linear
    color mode evaluates the MATLAB-mode A = CI .* K instead."""
    if ell is None:
        ell = p.ell_init
    if p.color_mode == "linear":
        ci = linear_color_gram(cloud_a.features, cloud_b.features,
                               p.color_scale)
        A = matlab_gram(cloud_a.positions, cloud_a.mask, cloud_b.positions,
                        cloud_b.mask, ci, ell, sigma=p.sigma,
                        sp_thres=p.sp_thres)
    else:
        A = se_gram(*cloud_a, *cloud_b, ell, sigma=p.sigma, c_ell=p.c_ell,
                    c_sigma=p.c_sigma, sp_thres=p.sp_thres,
                    c_sp_thres=p.sp_thres)
    n = flow_mod.nnz(A)
    return torch.sum(A) / torch.clamp_min(n, 1).to(torch.float32)
