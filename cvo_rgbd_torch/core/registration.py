"""Frame-to-frame RKHS SE(3) registration — the align loop.

Port of the JAX package's `core/registration.py` for cvo and adaptive
cvo (acvo) on three backends: "kernel" (the JAX "pallas" backend, the
hand-written CUDA kernels of `cvo_rgbd_torch.ops`, one sweep per
iteration), "dense" (the JAX "xla" backend, the dense masked Gram in
plain torch) and "fused" (the whole loop below in one kernel launch,
`ops/align_fused.py`).  Reference loop semantics (cvo.cpp:361-420,
adaptive_cvo.cpp:490-555), kept exactly:

  per iteration k:
    tf   = [R', -R'T]                  (update_tf, cvo.cpp:83-87)
    y    = tf * y0                     (transform_pcd, cvo.cpp:310-315)
    kernel: Mom, nnz = fused_moments   (one Gram sweep, ops/moments.py;
            or, step_mode="direct", the two sweeps of ops/flow.py)
    dense:  A = se_gram / matlab_gram  (core/gram.py)
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
sweep) and of the self-Grams Axx, Ayy: on the kernel backend both
self-sweeps in one `fused_wsq_sweeps` launch per iteration
(`self_mode="exact"`), or per-align Chebyshev tables in ell
(`self_mode="cheb"`), all 2K sweeps of the tables in one launch (of
every lane's tables, for a batch).

MATLAB's linear color mode (`color_mode="linear"`, MATLAB_PARAMS) weighs
each pair by CI = color_scale * Cx Cz^T, computed once per align
(`prepare_ci`): the dense backend gates it in `matlab_gram`; the kernel
backend reads it, pre-masked, from the color-cache slot (cvo only, as the
JAX package's pallas backend); the fused backend forms it in the kernel.

The loop state lives on the device and the host never waits on it per
iteration.  Once converged, every state field freezes (the JAX body's
freeze-on-converge), so iterations run past convergence are exact
no-ops, and the host reads `converged` once every CHECK_EVERY
iterations with a single `.item()`.  The result is bit-identical to
stopping at the first converged iteration, because `k` freezes too.
`core/compiled.align_jit` runs the same body as CUDA graphs of
CHECK_EVERY iterations, for `align`'s bits.

The kernel backend's moment step and the dense backend also run on B
pairs at once, the state and the clouds on a leading lane axis
(`make_batched_step`, the loop of `parallel.align_batched`, JAX's
vmap(align)): on the kernel backend one `fused_moments` launch an
iteration sweeps every lane that has not converged (and exact acvo's
self-sweeps of every live lane one `fused_wsq` launch), the O(M)
epilogue runs on [B, ...] tensors; on the dense backend the Grams are
[B, N, M]; a converged lane freezes.  The ops whose batched call rounds
otherwise than the one-pair call (the sums over a lane's points or
pairs, the small matmuls) run lane by lane (`core.lanes`), so a lane is
the bits of `align` on its pair.
"""

from __future__ import annotations

import dataclasses
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
from cvo_rgbd_torch.core.lanes import by_lane, lane_matmul
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
from cvo_rgbd_torch.ops import (
    color_gram,
    fused_flow,
    fused_moments,
    fused_step_coeffs,
)
from cvo_rgbd_torch.ops.align_fused import align_fused, fused_eligible
from cvo_rgbd_torch.ops.gram import pad_feat
from cvo_rgbd_torch.ops.moments import TILE_I, TILE_J
from cvo_rgbd_torch.ops.wsq import TILE_W, Sweep, fused_wsq_sweeps, tile_order
from cvo_rgbd_torch.params import AcvoParams, color_scale, fast_exp

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

    ck: tuple | None      # (ck_xy, ck_xx, ck_yy); None when ck_cache is off;
                          # linear mode: (ci, None, None), masked
    moments: tuple        # (c0, x - c0, Phi(x - c0))
    skip: tuple | None    # (lo_x, hi_x, tiles_xx, tiles_yy); None: tile_skip off
    cheb: tuple | None    # self_mode="cheb" tables; None otherwise


def check_supported(p) -> None:
    """Raise for what this slice of the port does not run."""
    adaptive = isinstance(p, AcvoParams)
    if p.backend not in ("kernel", "dense", "fused"):
        raise ValueError(f"unknown backend {p.backend!r}")
    if p.color_mode not in ("se", "linear"):
        raise ValueError(f"unknown color_mode {p.color_mode!r}")
    if p.exp_mode not in ("precise", "fast"):
        raise ValueError(f"unknown exp_mode {p.exp_mode!r}")
    if adaptive and p.backend == "kernel":
        # as the JAX package's pallas backend
        if p.color_mode == "linear":
            raise ValueError(
                "the kernel backend supports linear color mode for cvo only"
            )
        if p.yy_quirk:
            raise ValueError("yy_quirk emulation requires backend='dense'")


def _schedule_ell(ell, k, sched):
    """Fixed schedule (cvo.cpp:408-410): applied at end of iteration k."""
    for thresh, val in sched:
        ell = torch.where(k > thresh, val, ell)
    return ell


def _self(cloud: PointCloud):
    return (*cloud, *cloud)


def prepare_ci(p, fixed: PointCloud, moving: PointCloud):
    """Linear mode's CI = color_scale * Cx Cz^T of the pair, once per
    align (rkhs_se3_registration.m:108); None in se mode.  A plain
    [N,3]x[3,M] product (zero feature planes add nothing) at full fp32
    (`pin_fp32`: TF32 would move it by ~1e-3).  The kernel backend's is
    masked, as its kernels take the masks from zeros in it;
    `matlab_gram` gates the dense one itself."""
    if p.color_mode != "linear":
        return None
    ci = linear_color_gram(fixed.features, moving.features, color_scale(p))
    if p.backend == "kernel":
        ci = torch.where(
            (fixed.mask[:, None] > 0) & (moving.mask[None, :] > 0), ci, 0.0)
    return ci


def build_ck_caches(p, adaptive, fixed: PointCloud, moving: PointCloud):
    """Loop-invariant color-kernel caches (ck_xy, ck_xx, ck_yy), the
    self-pairs for acvo only; None when `p.ck_cache` is off.  Features
    never transform (cvo.cpp:143-153).  Each is an [N,M] f32 tensor, or
    for clouds stacked on a lane axis [B,N,M], one `color_gram` launch
    for all the lanes."""
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
    """Tile bounds for the exact AABB skip, (lo_x, hi_x, tiles_xx,
    tiles_yy); None when `p.tile_skip` is off.  lo_x/hi_x are the fixed
    cloud's at the moment kernel's row tile (it never moves).
    tiles_xx/tiles_yy (acvo only) are the self-sweeps' bounds at TILE_W
    as `ops.wsq.TileOrder`s (upper-triangle tiles sorted by bound),
    computed ONCE from the untransformed clouds: distances inside one
    rigidly moved cloud do not change (the transform's fp32 rounding is
    far below SKIP_MARGIN), so the tiles kept at any ell are a prefix of
    that order."""
    if not p.tile_skip:
        return None
    lo_x, hi_x = block_bounds(fixed.positions, fixed.mask, TILE_I)
    tiles_xx = tiles_yy = None
    if adaptive:
        tiles_xx, tiles_yy = (tile_order(_self_bounds(c), symmetric=True)
                              for c in (fixed, moving))
    return lo_x, hi_x, tiles_xx, tiles_yy


def _cheb_span(p, ell0):
    """(lo, hi, nodes, weights, ell at each node) of one align's tables:
    the span in t = log(1/2ell^2) from `ell0` (see build_selfsweep_cheb),
    in float64."""
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
    return lo, hi, xch, wts, ell_nodes.tolist()


def build_selfsweep_cheb(p, adaptive, fixed: PointCloud, moving: PointCloud,
                         ck_caches, skip_pre, ell0=None):
    """Per-align Chebyshev tables of the four self-sweep reductions
    (`self_mode="cheb"`): wsq_xx, nnz_xx, wsq_yy, nnz_yy are functions
    of ell alone (self distances are rigid-invariant), so K sweep pairs
    at log-space Chebyshev nodes, all 2K in one launch, replace a pair
    every iteration.
    Returns (log values [4, K], (lo, hi, nodes, weights)) or None.

    The span is [ell_min, max(ell_max_init, ell0)]: ell never exceeds
    its ceiling within an align.  An `ell0` that is a number or a CPU
    tensor widens it; a CUDA tensor keeps the default span, so building
    the tables adds no host sync (as a traced ell0 in the JAX package).

    For clouds, caches and tile orders stacked on a lane axis, `ell0` is
    each lane's (a list) and every lane's 2K sweeps, each lane at its
    own nodes, run in one launch; the tables come stacked (logv [B, 4,
    K], lo and hi [B], nodes and weights [B, K]), each lane the bits of
    the one-pair call on it."""
    if not adaptive or p.backend != "kernel" or p.self_mode != "cheb":
        return None
    lanes = fixed.positions.dim() == 3
    spans = [_cheb_span(p, e) for e in (ell0 if lanes else [ell0])]
    dev = fixed.positions.device
    ells = torch.tensor([s[4] for s in spans], dtype=torch.float32,
                        device=dev).repeat_interleave(2, dim=-1)
    # sweeps xx, yy at node 0, then at node 1, ...
    w, nz = fused_wsq_sweeps(
        _self_sweeps(fixed, moving, ck_caches, skip_pre) * int(p.self_cheb_k),
        ells if lanes else ells[0], p=p)
    cols = torch.stack([w[..., 0::2], nz[..., 0::2], w[..., 1::2],
                        nz[..., 1::2]], dim=-2)
    logv = by_lane(lanes)(lambda c: torch.log(torch.clamp_min(c, 1e-30)),
                          cols)

    def f32(*v):
        out = [torch.as_tensor(x, dtype=torch.float32).to(dev) for x in v]
        return torch.stack(out) if lanes else out[0]

    return logv, tuple(f32(*(s[k] for s in spans)) for k in range(4))


def _self_sweeps(x_cloud, y_cloud, ck_caches, skip_pre):
    """[Sweep xx, Sweep yy]: the symmetric self-sweeps of two clouds (the
    fixed one, and the moving one where it lies), each with its color
    cache and its tile order (None where the option is off); of every
    lane where they are stacked on a lane axis."""
    _, ck_xx, ck_yy = ck_caches if ck_caches else (None,) * 3
    tiles_xx = tiles_yy = None
    if skip_pre is not None:
        _, _, tiles_xx, tiles_yy = skip_pre
    return [Sweep(tuple(x_cloud), tuple(x_cloud), ck_xx, tiles_xx, True),
            Sweep(tuple(y_cloud), tuple(y_cloud), ck_yy, tiles_yy, True)]


def _cheb_self(cheb_pre, ell):
    """(wsq_xx, nnz_xx, wsq_yy, nnz_yy) at `ell` from the tables:
    barycentric interpolation in t = log(1/2ell^2), exact at a node.
    A [4] tensor, or [B, 4] for stacked tables and one ell a lane (the
    sums over the nodes lane by lane)."""
    logv, (lo_t, hi_t, xch, wts) = cheb_pre
    lane = by_lane(logv.dim() == 3)
    t = torch.log(1.0 / (2.0 * ell * ell))
    x = torch.clamp((2.0 * t - (lo_t + hi_t)) / (hi_t - lo_t), -1.0, 1.0)
    dch = x[..., None] - xch
    hit = torch.abs(dch) < 1e-10
    tt = wts / torch.where(hit, 1.0, dch)
    interp = lane(lambda a, v: torch.sum(a[None, :] * v, dim=1)
                  / torch.sum(a), tt, logv)
    exact_row = lane(lambda h, v: torch.sum(torch.where(h[None, :], v, 0.0),
                                            dim=1), hit, logv)
    return torch.exp(torch.where(torch.any(hit, dim=-1)[..., None],
                                 exact_row, interp))


def prepare(p, fixed: PointCloud, moving: PointCloud, ell0=None,
            ck=None, cheb=True):
    """The AlignPre of (already kd-sorted) clouds.  The dense backend
    keeps only linear mode's CI, in the `ck` slot (None in se mode).
    `ck`: the pair's color caches where they are built already (a lane
    of `prepare_batch`'s), else built here; `cheb=False` leaves acvo's
    Chebyshev tables to the caller (`prepare_batch` builds every lane's
    in one launch)."""
    ci = prepare_ci(p, fixed, moving)
    ci_pre = None if ci is None else (ci, None, None)
    if p.backend != "kernel":
        return None if ci is None else AlignPre(ci_pre, None, None, None)
    adaptive = isinstance(p, AcvoParams)
    ck = ci_pre or ck or build_ck_caches(p, adaptive, fixed, moving)
    skip = build_skip_pre(p, adaptive, fixed, moving)
    tables = (build_selfsweep_cheb(p, adaptive, fixed, moving, ck, skip, ell0)
              if cheb else None)
    return AlignPre(ck, build_moments_pre(fixed), skip, tables)


def _map_tensors(fn, *trees):
    """fn over the tensors of trees of one structure (tuples,
    NamedTuples, tensors, None), field by field."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, tuple):
        fields = [_map_tensors(fn, *f) for f in zip(*trees)]
        return type(first)(*fields) if hasattr(first, "_fields") \
            else tuple(fields)
    return first


def lane_pre(pre, i: int):
    """Lane `i` of a stacked AlignPre (views of its tensors)."""
    return _map_tensors(lambda t: t[i], pre)


def prepare_batch(p, fixed: PointCloud, moving: PointCloud, ell0s):
    """One AlignPre of (already kd-sorted) clouds stacked on a lane axis,
    its tensors stacked on that axis too, `ell0s` each lane's ell0 (or
    None): the kernel backend's color caches of all the lanes from one
    `color_gram` launch a cache, kept as the [B, N, M] tensors it
    returns, as JAX's vmap(align) runs the kernel once for the batch (its
    scalars come from `p.ell_init`, not from a lane's state), and acvo's
    Chebyshev tables of all the lanes from one `fused_wsq` launch, each
    lane's span from its own ell0; the rest built lane by lane as
    `prepare` builds it and stacked (the moment precompute c0 [B, 3],
    x - c0 [B, N, 3] and Phi [B, N, 35], the tile bounds and orders,
    linear mode's CI).  `lane_pre(pre, i)` is the bits of `prepare` on
    pair i.  None where `prepare` gives None (the dense backend in se
    mode)."""
    cks = None
    adaptive = isinstance(p, AcvoParams)
    if p.backend == "kernel" and p.color_mode != "linear":
        cks = build_ck_caches(p, adaptive, fixed, moving)
    lanes = [
        prepare(p, fixed.lane(i), moving.lane(i), ell0,
                None if cks is None
                else tuple(None if c is None else c[i] for c in cks),
                cheb=False)
        for i, ell0 in enumerate(ell0s)
    ]
    if cks is not None:
        # the caches stay the launch's own tensors: no copy of B N M floats
        lanes = [pre._replace(ck=None) for pre in lanes]
    pre = _map_tensors(lambda *ts: torch.stack(ts), *lanes)
    if pre is None:
        return None
    if cks is not None:
        pre = pre._replace(ck=cks)
    return pre._replace(cheb=build_selfsweep_cheb(
        p, adaptive, fixed, moving, pre.ck, pre.skip, list(ell0s)))


def _kernel_terms(p, adaptive, state, fixed, moving, y_pos, pre):
    """(omega, v, step, dl) of one kernel-backend iteration: one moment
    sweep and its epilogues, or under step_mode="direct" the flow sweep
    and then the line-search sweep (the two passes of cvo.cpp:164-308).
    The moment step also runs on B lanes (a leading lane axis on the
    state, the clouds and `pre`): one `fused_moments` launch for the
    batch, and exact acvo's one `fused_wsq` launch, the lanes that have
    converged not swept."""
    ck_xy = pre.ck[0] if pre.ck else None
    direct = p.step_mode == "direct"
    y_cloud = (y_pos, moving.features, moving.mask)
    live = ~state.converged if y_pos.dim() == 3 else None
    if direct:
        omega, v, wsq_xy, nnz_xy, _ = fused_flow(*fixed, *y_cloud, state.ell,
                                                 ck_xy, p=p)
    else:
        c0, x_c, phi = pre.moments
        md_xy = None
        if pre.skip is not None:
            # the gap is shift-invariant: uncentered bounds serve the
            # centered kernel coordinates
            lo_x, hi_x = pre.skip[:2]
            lo_y, hi_y = block_bounds(y_pos, moving.mask, TILE_J)
            md_xy = aabb_min_d2(lo_x, hi_x, lo_y, hi_y)
        Mom, nnz_xy = fused_moments(
            x_c, fixed.features, fixed.mask,
            y_pos - c0[..., None, :], moving.features, moving.mask,
            phi, state.ell, ck_xy, md_xy, p=p, live=live,
        )
        omega, v, wsq_xy, _ = flow_from_moments(Mom, y_pos, c0, c=p.c,
                                                d=p.d)
    dl = None
    if adaptive:
        # the self-Grams feed only dl (adaptive_cvo.cpp:156-160,
        # 222-271): both lean sweeps (of every live lane) in one launch,
        # or the per-align tables
        if pre.cheb is not None:
            wsq_xx, nnz_xx, wsq_yy, nnz_yy = _cheb_self(
                pre.cheb, state.ell).unbind(-1)
        else:
            w, nz = fused_wsq_sweeps(
                _self_sweeps(fixed, y_cloud, pre.ck, pre.skip), state.ell,
                p=p, live=live)
            wsq_xx, wsq_yy = w.unbind(-1)
            nnz_xx, nnz_yy = nz.unbind(-1)
        ell3 = state.ell * (state.ell * state.ell)
        numer = (wsq_yy - 2.0 * wsq_xy + wsq_xx) / ell3
        denom = nnz_xx + nnz_yy - 2.0 * nnz_xy
        dl = numer / torch.where(denom == 0, 1.0, denom)
    if direct:
        B, C, D, E = fused_step_coeffs(*fixed, *y_cloud, state.ell, omega, v,
                                       ck_xy, p=p)
    else:
        B, C, D, E = step_from_moments(Mom, y_pos, c0, omega, v, state.ell)
    roots, valid = cubic_roots(4.0 * E, 3.0 * D, 2.0 * C, B)
    step = min_positive_root(roots, valid, p.min_step, p.max_step)
    return omega, v, step, dl


def _se(p, x_pos, x: PointCloud, y_pos, y: PointCloud, ell):
    """se_gram of x_pos and y_pos with the features and masks of x, y."""
    return se_gram(
        x_pos, x.features, x.mask, y_pos, y.features, y.mask, ell,
        sigma=p.sigma, c_ell=p.c_ell, c_sigma=p.c_sigma,
        sp_thres=p.sp_thres, c_sp_thres=p.c_sp_thres, fast_exp=fast_exp(p),
    )


def _gram(p, x_pos, x: PointCloud, y_pos, y: PointCloud, ell, ci):
    """The dense Gram of the color mode (the JAX package's _gram):
    matlab_gram with the pair's CI in linear mode, else se_gram."""
    if p.color_mode == "linear":
        return matlab_gram(x_pos, x.mask, y_pos, y.mask, ci, ell,
                           sigma=p.sigma, sp_thres=p.sp_thres,
                           fast_exp=fast_exp(p))
    return _se(p, x_pos, x, y_pos, y, ell)


def _dense_terms(p, adaptive, state, fixed, moving, y_pos, pre):
    """(omega, v, step, dl) of one dense-backend iteration; on B lanes
    (a leading lane axis on the state, the clouds and `pre`) the Grams
    are [B, N, M] and the reductions run lane by lane (`core/flow.py`,
    `core/step*.py`), as JAX's vmap(align) runs the "xla" body."""
    x_pos = fixed.positions
    ci = pre.ck[0] if pre is not None else None
    A = _gram(p, x_pos, fixed, y_pos, moving, state.ell, ci)
    omega, v = flow_mod.flow(A, x_pos, y_pos, c=p.c, d=p.d)
    dl = None
    if adaptive:
        # Axx depends on the iteration only through ell; Ayy moves with y.
        # Linear mode keeps the JAX algebra (its registration.py:212-220):
        # Axx takes the cross pair's CI, and Ayy stays se_gram (ROADMAP
        # queue 3)
        Axx = _gram(p, x_pos, fixed, x_pos, fixed, state.ell, ci)
        Ayy = _se(p, y_pos, moving, y_pos, moving, state.ell)
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


def _lanewise(flag, like):
    """A per-lane flag ([B], or 0-dim for one pair) shaped to broadcast
    against `like`, a field with that lane axis."""
    return flag.reshape(flag.shape + (1,) * (like.dim() - flag.dim()))


def integrate(p, adaptive, state: AlignState, tf, omega, v, step,
              dl) -> AlignState:
    """The tail of an iteration, every backend's and the mesh paths':
    the stops, the exp update and the ell update from the iteration's
    (omega, v, step, dl), `tf` the transform from its top; a converged
    state stays frozen.  Each lane of a batched state (a leading lane
    axis on every field) stops and freezes on its own."""
    # stop 1: flow norm, BEFORE the update (cvo.cpp:380)
    stop1 = (torch.linalg.norm(omega, dim=-1) < p.eps) & (
        torch.linalg.norm(v, dim=-1) < p.eps
    )
    dR, dT = se3.exp_sek3(omega, v, step, mm=lane_matmul)
    R_new = torch.where(_lanewise(stop1, state.R), state.R,
                        lane_matmul(state.R, dR))
    T_new = torch.where(
        _lanewise(stop1, state.T), state.T,
        lane_matmul(state.R, dT[..., None])[..., 0] + state.T
    )
    # stop 2: se3 distance, AFTER the update (cvo.cpp:402)
    stop2 = se3.dist_se3(dR, dT, mm=lane_matmul) < p.eps_2
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
        *(torch.where(_lanewise(state.converged, old), old, new)
          for old, new in zip(state, new_state))
    )


def make_align_step(p):
    """The per-iteration body, body(state, fixed, moving, pre) -> state,
    of the backend `p` names; `pre` is `prepare`'s result.  On the
    kernel backend's moment step the body also takes B lanes
    (`make_batched_step`)."""
    adaptive = isinstance(p, AcvoParams)
    kernel = p.backend == "kernel"

    def body(state: AlignState, fixed: PointCloud, moving: PointCloud,
             pre) -> AlignState:
        tf_R, tf_T = se3.se3_inv(state.R, state.T, mm=lane_matmul)
        tf = se3.make_se3(tf_R, tf_T)
        y_pos = transform_cloud(tf_R, tf_T, moving.positions,
                                mm=lane_matmul)
        if kernel:
            omega, v, step, dl = _kernel_terms(p, adaptive, state, fixed,
                                               moving, y_pos, pre)
        else:
            omega, v, step, dl = _dense_terms(p, adaptive, state, fixed,
                                              moving, y_pos, pre)
        return integrate(p, adaptive, state, tf, omega, v, step, dl)

    return body


def batched_loop(p) -> bool:
    """Whether `p` runs B pairs in one loop (`make_batched_step`): the
    dense backend (both step modes, JAX's vmap(align) on "xla") and the
    kernel backend's moment step (JAX's on "pallas").  The kernel
    backend's direct step, the port's own, runs its lanes one by one."""
    return p.backend == "dense" or (p.backend == "kernel"
                                    and p.step_mode != "direct")


def make_batched_step(p):
    """The per-iteration body on B lanes, body(state, fixed, moving, pre)
    -> state with a leading lane axis on the state (`init_state(...,
    lanes=B)`), the clouds and `pre` (`prepare_batch`): `make_align_step`'s
    body, whose moment step sweeps every live lane in one `fused_moments`
    launch (and exact acvo's self-sweeps in one `fused_wsq` launch), or
    on the dense backend forms the [B, N, M] Grams, and runs the
    epilogue on the [B, ...] tensors.  A lane is the bits of the
    one-pair body on it."""
    if not batched_loop(p):
        raise ValueError("the batched loop runs the dense backend and the "
                         "kernel backend's moment step, not "
                         f"backend={p.backend!r} step_mode={p.step_mode!r}")
    return make_align_step(p)


def init_state(p, device, R0=None, T0=None, ell0=None,
               lanes=None) -> AlignState:
    """The loop state at iteration 0 on `device`: identity and
    p.ell_init unless R0/T0/ell0 say otherwise; the acvo ceiling starts
    at p.ell_max_init (reset per pair, adaptive_cvo.cpp:477).  `lanes`:
    B lanes, each field with a leading lane axis (R0 [B,3,3], T0 [B,3],
    ell0 [B] where given)."""
    f32 = torch.float32
    lead = () if lanes is None else (lanes,)

    def given(v, default):
        return (default if v is None
                else torch.as_tensor(v, dtype=f32).to(device))

    def full(shape, value, dtype=f32):
        return torch.full(lead + shape, value, dtype=dtype, device=device)

    ell_max0 = p.ell_max_init if isinstance(p, AcvoParams) else 1e9
    return AlignState(
        k=full((), 0, torch.int32),
        R=given(R0, torch.eye(3, dtype=f32, device=device).repeat(
            lead + (1, 1))),
        T=given(T0, full((3,), 0.0)),
        ell=given(ell0, full((), p.ell_init)).reshape(lead),
        ell_max=full((), ell_max0),
        tf=torch.eye(4, dtype=f32, device=device).repeat(lead + (1, 1)),
        converged=full((), False, torch.bool),
        omega=full((3,), 0.0),
        v=full((3,), 0.0),
    )


def route(p, fixed: PointCloud, moving: PointCloud):
    """(p, fixed, moving) as the backend runs them, the clouds on its
    device already: a problem the fused backend cannot run goes to the
    dense or the kernel backend (see `align`), the features are padded
    to the kernels' NFEAT planes (the zero planes change no color term
    and no CI), and the kernel and fused backends kd-sort the clouds."""
    if p.backend == "fused" and not fused_eligible(p, fixed, moving):
        adaptive = isinstance(p, AcvoParams)
        to_dense = (
            (adaptive and (p.yy_quirk or p.color_mode == "linear"))
            or fixed.capacity % 128 or moving.capacity % 128
        )
        p = dataclasses.replace(p, backend="dense" if to_dense else "kernel")
    fixed, moving = (c._replace(features=pad_feat(c.features))
                     for c in (fixed, moving))
    if p.backend == "fused":
        # compact tiles for the in-kernel skip, sorted whether or not
        # tile_skip is on, so skip on and off stay comparable
        if fixed.capacity % 128 == 0:
            fixed = kd_sort(fixed)
        if moving.capacity % 128 == 0:
            moving = kd_sort(moving)
    elif p.backend == "kernel":
        fixed, moving = kd_sort(fixed), kd_sort(moving)
    return p, fixed, moving


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
    Linear-mode clouds carry 3 color features (MATLAB_PARAMS); every
    backend pads them with zeros to the kernels' 5, here, once per align.

    The fused backend runs the whole loop in one launch on kd-sorted
    clouds (`ops/align_fused.py`).  It recomputes the color kernel in the
    kernel and always sweeps the self-Grams exactly, so it ignores
    `ck_cache` and `self_mode`.  A problem it cannot run goes, as in the
    JAX package, to the dense backend (yy_quirk, linear acvo, a capacity
    that is not a multiple of 128) or else to the kernel backend.
    """
    check_supported(p)
    dev = resolve_device(device)
    pin_fp32()
    p, fixed, moving = route(p, fixed.to(dev), moving.to(dev))
    if p.backend == "fused":
        return align_fused(p, fixed, moving, R0, T0, ell0)
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
                               color_scale(p))
        A = matlab_gram(cloud_a.positions, cloud_a.mask, cloud_b.positions,
                        cloud_b.mask, ci, ell, sigma=p.sigma,
                        sp_thres=p.sp_thres)
    else:
        A = se_gram(*cloud_a, *cloud_b, ell, sigma=p.sigma, c_ell=p.c_ell,
                    c_sigma=p.c_sigma, sp_thres=p.sp_thres,
                    c_sp_thres=p.sp_thres)
    n = flow_mod.nnz(A)
    return torch.sum(A) / torch.clamp_min(n, 1).to(torch.float32)
