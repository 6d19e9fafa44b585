"""Frame-to-frame RKHS SE(3) registration — the align loop.

Port of the JAX package's `core/registration.py` for the kernel backend
(the JAX "pallas" backend).  Reference loop semantics (cvo.cpp:361-420),
kept exactly:

  per iteration k:
    tf   = [R', -R'T]                  (update_tf, cvo.cpp:83-87)
    y    = tf * y0                     (transform_pcd, cvo.cpp:310-315)
    Mom, nnz = fused_moments(...)      (one Gram sweep, ops/moments.py)
    omega, v ; B..E ; step             (O(M) epilogues, core/moments.py)
    if |omega|<eps and |v|<eps: break  (BEFORE the update, cvo.cpp:380)
    dR, dT = Exp_SEK3([omega;v], step) (cvo.cpp:391)
    T = R dT + T ; R = R dR            (cvo.cpp:398-399)
    if dist_se3(dR,dT)<eps_2: break    (AFTER the update, cvo.cpp:402)
    ell schedule k>2/9/19              (cvo.cpp:408-410)

and the returned `tf` is the one from the top of the last executed
iteration (cvo.cpp:413-415).

The loop state lives on the device and the host never waits on it per
iteration.  Once converged, every state field freezes (the JAX body's
freeze-on-converge), so iterations run past convergence are exact
no-ops, and the host reads `converged` once every CHECK_EVERY
iterations with a single `.item()`.  The result is bit-identical to
stopping at the first converged iteration, because `k` freezes too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cvo_rgbd_torch import se3
from cvo_rgbd_torch.core.cloud import (
    PointCloud,
    aabb_min_d2,
    block_bounds,
    kd_sort,
    transform_cloud,
)
from cvo_rgbd_torch.core.cubic import cubic_roots, min_positive_root
from cvo_rgbd_torch.core.moments import flow_from_moments, step_from_moments
from cvo_rgbd_torch.core.step_factored import monomial_features
from cvo_rgbd_torch.device import pin_fp32, resolve_device
from cvo_rgbd_torch.ops import color_gram, fused_moments
from cvo_rgbd_torch.ops.moments import TILE_I, TILE_J
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


def check_supported(p) -> None:
    """Raise for what this slice of the port does not run yet."""
    if isinstance(p, AcvoParams):
        raise NotImplementedError(
            "adaptive CVO (AcvoParams) is not ported yet: ROADMAP queue 1, "
            "item 10 (with the fused_wsq kernel, queue 2)"
        )
    if p.backend == "dense":
        raise NotImplementedError(
            "backend='dense' is not ported yet: ROADMAP queue 1, item 5"
        )
    if p.backend == "fused":
        raise NotImplementedError(
            "backend='fused' (the whole-align kernel) is not ported yet: "
            "ROADMAP queue 2, kernels #4-#5"
        )
    if p.backend != "kernel":
        raise ValueError(f"unknown backend {p.backend!r}")
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


def build_ck_caches(p, fixed: PointCloud, moving: PointCloud):
    """Loop-invariant color-kernel cache ck_xy [N,M] (None when
    `p.ck_cache` is off): features never transform (cvo.cpp:143-153)."""
    if not p.ck_cache:
        return None
    return color_gram(*fixed, *moving, p=p)


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


def build_skip_pre(p, fixed: PointCloud):
    """Fixed-cloud tile bounds at the moment kernel's row tile (None when
    `p.tile_skip` is off).  The fixed cloud never moves."""
    if not p.tile_skip:
        return None
    return block_bounds(fixed.positions, fixed.mask, TILE_I)


def make_align_step(p):
    """The per-iteration body of the kernel backend."""

    def body(state: AlignState, fixed: PointCloud, moving: PointCloud,
             ck_xy, moments_pre, skip_pre) -> AlignState:
        tf_R, tf_T = se3.se3_inv(state.R, state.T)
        tf = se3.make_se3(tf_R, tf_T)
        y_pos = transform_cloud(tf_R, tf_T, moving.positions)

        c0, x_c, phi = moments_pre
        md_xy = None
        if skip_pre is not None:
            # the gap is shift-invariant: uncentered bounds serve the
            # centered kernel coordinates
            lo_x, hi_x = skip_pre
            lo_y, hi_y = block_bounds(y_pos, moving.mask, TILE_J)
            md_xy = aabb_min_d2(lo_x, hi_x, lo_y, hi_y)
        Mom, _ = fused_moments(
            x_c, fixed.features, fixed.mask,
            y_pos - c0, moving.features, moving.mask,
            phi, state.ell, ck_xy, md_xy, p=p,
        )
        omega, v, _, _ = flow_from_moments(Mom, y_pos, c0, c=p.c, d=p.d)
        B, C, D, E = step_from_moments(Mom, y_pos, c0, omega, v, state.ell)
        roots, valid = cubic_roots(4.0 * E, 3.0 * D, 2.0 * C, B)
        step = min_positive_root(roots, valid, p.min_step, p.max_step)

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

        ell_new = _schedule_ell(state.ell, state.k, p.ell_sched)
        # the reference `break` skips the ell update
        ell_new = torch.where(converged, state.ell, ell_new)

        new_state = AlignState(
            k=state.k + 1,
            R=R_new,
            T=T_new,
            ell=ell_new,
            ell_max=state.ell_max,
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


def align(p, fixed: PointCloud, moving: PointCloud, R0=None, T0=None,
          ell0=None, device=None) -> AlignResult:
    """Register `moving` onto `fixed` on `device` (the card unless
    `device="cpu"`).

    `R0`/`T0`/`ell0` warm-start the state: the reference never resets
    R, T or ell between pairs (cvo.cpp:43-45, 398-399, 408-410), so
    sequential odometry passes the previous pair's `AlignResult.R/.T/.ell`
    (odometry.run_odometry_frames does).  Defaults: identity, p.ell_init.
    """
    check_supported(p)
    dev = resolve_device(device)
    pin_fp32()
    f32 = torch.float32
    fixed = kd_sort(fixed.to(dev))
    moving = kd_sort(moving.to(dev))
    R0 = (torch.eye(3, dtype=f32, device=dev) if R0 is None
          else torch.as_tensor(R0, dtype=f32).to(dev))
    T0 = (torch.zeros(3, dtype=f32, device=dev) if T0 is None
          else torch.as_tensor(T0, dtype=f32).to(dev))
    ell0 = (torch.full((), p.ell_init, dtype=f32, device=dev) if ell0 is None
            else torch.as_tensor(ell0, dtype=f32).to(dev).reshape(()))

    state = AlignState(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        R=R0,
        T=T0,
        ell=ell0,
        ell_max=torch.full((), 1e9, dtype=f32, device=dev),
        tf=torch.eye(4, dtype=f32, device=dev),
        converged=torch.zeros((), dtype=torch.bool, device=dev),
        omega=torch.zeros(3, dtype=f32, device=dev),
        v=torch.zeros(3, dtype=f32, device=dev),
    )
    body = make_align_step(p)
    ck_xy = build_ck_caches(p, fixed, moving)
    moments_pre = build_moments_pre(fixed)
    skip_pre = build_skip_pre(p, fixed)

    for it in range(p.max_iter):
        state = body(state, fixed, moving, ck_xy, moments_pre, skip_pre)
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
