"""Registration over a mesh of ranks, and batch data parallelism.

Port of the JAX package's `parallel/sharded.py`.  The reference's
mutex-guarded accumulations (omega/v, cvo.cpp:201-204; B..E,
cvo.cpp:283-288; dl, adaptive_cvo.cpp:234-263) are all-reduces over a
mesh axis here (`collectives.psum`):

- `align_sharded`: the fixed cloud's rows shard over axis `sp`; each rank
  sweeps its row block against the whole moving cloud and the iteration
  takes two packed psums.  The loop state stays replicated, because
  every rank sees the same sums.
- `train_step_2d`: frame pairs over `dp`, each pair's fixed rows over
  `sp`; a dp rank's pairs run one after another.
- `align_ring`: both clouds shard; blocks of them ride the ring of `sp`
  (`collectives.ppermute`), so no rank holds a whole cloud or an [N, M]
  block.
- `align_batched`: pairs stacked on a lane axis, one fused launch or
  compiled lanes (`core/compiled.py`) with one `color_gram` launch a
  batch; with a mesh, the lanes shard over `dp`.

The port is SPMD (`parallel/mesh.py`): every rank calls an entry point
with the same global clouds, kd-sorts them itself (`kd_sort` is
deterministic, so the ranks hold one permutation), takes its block by
its index on the axis, and returns the same replicated AlignResult.

On the kernel backend (and on "fused", which these paths run as the
kernel backend, as JAX runs "fused" as "pallas" here) a rank's work is
the single-device kernels on its block: `color_gram` once an align,
`fused_moments` and the self-sweeps of `fused_wsq` each iteration, and
the flow and line search as O(M) epilogues of the block's moments
(`core/moments.py`), which are linear in the moments and so sum across
ranks exactly.  Rows that do not tile (a block that is not a multiple of
128), adaptive linear mode and `yy_quirk` take the dense body, as in
JAX.  The mesh paths sweep the self-pairs exactly each iteration (no
`self_mode="cheb"`) and take the moment step (no `step_mode="direct"`),
as JAX has no other form there.

Each path's loop is compiled, as JAX jits its shard_map'ed while loop:
the body's per-align precompute (`_sharded_kernel_pre`,
`_ring_kernel_pre` with every ring hop's up front, `_ring_dense_pre`,
acvo's gathered fixed cloud) runs eagerly, and its step, a function of
the state, the rank's blocks and that precompute, runs through
`core.compiled.run_mesh`: blocks of CHECK_EVERY iterations as CUDA
graphs on the card (one graph a block on NCCL; on gloo, graph segments
with the staged collectives between them), the same step uncaptured on
the CPU.  `_run_eager` runs the step op by op, the reference.
"""

from __future__ import annotations

import dataclasses
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
from cvo_rgbd_torch.core.compiled import run_compiled, run_mesh
from cvo_rgbd_torch.core.cubic import cubic_roots, min_positive_root
from cvo_rgbd_torch.core.gram import linear_color_gram, matlab_gram, se_gram
from cvo_rgbd_torch.core.moments import flow_from_moments, step_from_moments
from cvo_rgbd_torch.core.registration import (
    CHECK_EVERY,
    AlignResult,
    batched_loop,
    check_supported,
    init_state,
    integrate,
    lane_pre,
    prepare_batch,
    route,
)
from cvo_rgbd_torch.core.step_factored import (
    NUM_MONO,
    monomial_features,
    step_coefficients_factored,
)
from cvo_rgbd_torch.device import pin_fp32, resolve_device
from cvo_rgbd_torch.ops import color_gram, fused_moments
from cvo_rgbd_torch.ops.align_fused import align_fused_batched
from cvo_rgbd_torch.ops.gram import pad_feat
from cvo_rgbd_torch.ops.moments import TILE_I, TILE_J
from cvo_rgbd_torch.ops.wsq import TILE_W, Sweep, fused_wsq_sweeps, tile_order
from cvo_rgbd_torch.collectives import all_gather, ppermute, psum
from cvo_rgbd_torch.parallel.mesh import rank_device
from cvo_rgbd_torch.params import AcvoParams, color_scale, fast_exp


def _se_gram(p, xp, xf, xm, yp, yf, ym, ell):
    """The dense Gram of a block pair in the params' color mode; linear
    mode forms the block's CI on each call, as JAX does."""
    if p.color_mode == "linear":
        ci = linear_color_gram(xf, yf, color_scale(p))
        return matlab_gram(xp, xm, yp, ym, ci, ell, sigma=p.sigma,
                           sp_thres=p.sp_thres, fast_exp=fast_exp(p))
    return se_gram(xp, xf, xm, yp, yf, ym, ell, sigma=p.sigma,
                   c_ell=p.c_ell, c_sigma=p.c_sigma, sp_thres=p.sp_thres,
                   c_sp_thres=p.c_sp_thres, fast_exp=fast_exp(p))


def _masked_ci(p, x: PointCloud, y: PointCloud):
    """Linear mode's CI of a block pair, pre-masked: the moment kernel's
    color cache (as `registration.prepare_ci` on the kernel backend)."""
    ci = linear_color_gram(x.features, y.features, color_scale(p))
    return torch.where((x.mask[:, None] > 0) & (y.mask[None, :] > 0), ci,
                       0.0)


def _step_from_coeffs(p, B, C, D, E):
    roots, valid = cubic_roots(4.0 * E, 3.0 * D, 2.0 * C, B)
    return min_positive_root(roots, valid, p.min_step, p.max_step)


def _finish(state) -> AlignResult:
    return AlignResult(tf=state.tf, R=state.R, T=state.T,
                       iterations=state.k - 1, converged=state.converged,
                       ell=state.ell, omega=state.omega, v=state.v)


def _run_eager(entry, p, ax, body, x, y, pre, state) -> AlignResult:
    """`core.compiled.run_mesh` op by op, its reference: `body` until
    the replicated state converges or max_iter, read every CHECK_EVERY
    iterations as `registration.align` reads it (every rank reads the
    same bits, so every rank stops at the same iteration)."""
    for it in range(p.max_iter):
        state = body(state, x, y, pre)
        if (it + 1) % CHECK_EVERY == 0 and bool(state.converged.item()):
            break
    return _finish(state)


def _check(p):
    """The names check_supported checks; a problem the kernel body cannot
    take goes to the dense body here instead of raising."""
    if p.backend not in ("kernel", "dense", "fused"):
        raise ValueError(f"unknown backend {p.backend!r}")
    check_supported(dataclasses.replace(p, backend="dense"))


def _sharded_kernel_eligible(p, adaptive, n_local, m):
    """The kernel body runs when the params ask for it ("kernel", or
    "fused") and the block tiles; yy_quirk and adaptive linear mode are
    the dense body's alone (the JAX package's `_sharded_pallas_eligible`)."""
    if p.backend not in ("kernel", "fused"):
        return False
    if adaptive and (p.yy_quirk or p.color_mode == "linear"):
        return False
    return not (n_local % 128 or m % 128)


def _maybe_kd_sort(p, adaptive, fixed, moving, nsp, both=False):
    """kd-sort both clouds (whole, before any rank takes its block) when
    the kernel body will run, so a row block is a run of compact kd
    cells that the tile skip prunes; whether or not the skip is on, as
    the single-device kernel backend sorts.  `both` (the ring): the
    moving cloud's blocks must tile too."""
    m = moving.capacity // nsp if both else moving.capacity
    if not _sharded_kernel_eligible(p, adaptive, fixed.capacity // nsp, m):
        return fixed, moving
    return kd_sort(fixed), kd_sort(moving)


def _block(cloud: PointCloud, index: int, nblocks: int) -> PointCloud:
    """Block `index` of `nblocks` along the points axis (the last but one
    for positions and features, the last for the mask)."""
    n = cloud.capacity // nblocks
    sl = slice(index * n, (index + 1) * n)
    return PointCloud(cloud.positions[..., sl, :], cloud.features[..., sl, :],
                      cloud.mask[..., sl])


def _on(clouds, dev):
    """The clouds on `dev`, features padded to the kernels' planes."""
    return [c.to(dev)._replace(features=pad_feat(c.features.to(dev)))
            for c in clouds]


def _centered(x: PointCloud, ax):
    """(c0, x - c0, Phi(x - c0)) of a row block, c0 the masked centroid
    of the whole fixed cloud from one psum, so every rank centers with
    the same bits."""
    w = x.mask
    s_g, n_g = psum((torch.sum(x.positions * w[:, None], dim=0),
                     torch.sum(w)), ax)
    c0 = s_g / torch.clamp_min(n_g, 1.0)
    x_c = x.positions - c0
    return c0, x_c, monomial_features(x_c)


# ---------------------------------------------------------------------------
# Row-sharded align
# ---------------------------------------------------------------------------

class _RowPre(NamedTuple):
    """The kernel body's per-align precompute of a row block (None where
    the params need none)."""

    moments: tuple            # (c0, x - c0, Phi(x - c0)), c0 psum'd
    bounds: tuple | None      # (lo_x, hi_x) at the moment kernel's tiles
    tiles: tuple | None       # acvo's self-sweep TileOrders (xx, yy)
    ck: tuple                 # (ck_xy, ck_xx, ck_yy)
    x_full: PointCloud | None  # acvo: the whole fixed cloud


def _sharded_inner(entry, p, ax, adaptive, x: PointCloud, y: PointCloud,
                   run):
    """One rank's align of its row block `x` against the whole moving
    cloud `y` (the JAX package's `_make_sharded_inner`): the body's
    per-align precompute here, eagerly, then its loop through `run`
    (`run_mesh`, or `_run_eager`, its reference)."""
    use_kernel = _sharded_kernel_eligible(p, adaptive, x.capacity,
                                          y.capacity)
    # the fixed cloud never moves: acvo's Axx gathers it once an align
    x_full = (PointCloud(*(all_gather(t, ax) for t in x)) if adaptive
              else None)
    if use_kernel:
        pre = _sharded_kernel_pre(p, ax, adaptive, x, y, x_full)
        body = _sharded_kernel_body(p, ax, adaptive)
    else:
        pre, body = x_full, _sharded_dense_body(p, ax, adaptive)
    return run(f"{entry}'s {'kernel' if use_kernel else 'dense'} body", p,
               ax, body, x, y, pre, init_state(p, x.positions.device))


def _sharded_dense_body(p, ax, adaptive):
    """The dense body of `_sharded_inner`, body(state, x, y, x_full):
    the block's Gram each iteration, and two packed psums, the flow's
    sums (with dl's when adaptive), then the omega-dependent line
    search's."""

    def body(state, x, y, x_full):
        xp, xf, xm = x
        yp0, yf, ym = y
        tf_R, tf_T = se3.se3_inv(state.R, state.T)
        tf = se3.make_se3(tf_R, tf_T)
        yp = transform_cloud(tf_R, tf_T, yp0)
        A = _se_gram(p, xp, xf, xm, yp, yf, ym, state.ell)
        om_l, v_l = flow_mod.flow(A, xp, yp, c=p.c, d=p.d)
        dl = None
        if adaptive:
            Axx = _se_gram(p, xp, xf, xm, *x_full, state.ell)
            Ayy = _se_gram(p, yp, yf, ym, yp, yf, ym, state.ell)
            omega, v, s_xy, s_xx, nnz_xx, nnz_xy = psum((
                om_l, v_l,
                flow_mod.weighted_sqdist_sum(A, xp, yp),
                flow_mod.weighted_sqdist_sum(Axx, xp, x_full.positions),
                flow_mod.nnz(Axx), flow_mod.nnz(A)), ax)
            if p.yy_quirk:
                rows = torch.arange(yp.shape[0], device=yp.device)
                keep = (rows >= torch.sum(x_full.mask)).to(Ayy.dtype)
                Ayy_eff = Ayy * keep[:, None]
            else:
                Ayy_eff = Ayy
            s_yy = flow_mod.weighted_sqdist_sum(Ayy_eff, yp, yp)
            numer = (s_yy - 2.0 * s_xy + s_xx) / state.ell ** 3
            denom = nnz_xx + flow_mod.nnz(Ayy) - 2 * nnz_xy
            dl = numer / torch.where(denom == 0, 1, denom).to(numer.dtype)
        else:
            omega, v = psum((om_l, v_l), ax)
        # moment-factored on the local block: the per-block A-weighted
        # centering is exact, so the psum'd coefficients are the
        # unsharded ones
        B, C, D, E = psum(step_coefficients_factored(
            A, xp, yp, omega, v, state.ell), ax)
        step = _step_from_coeffs(p, B, C, D, E)
        return integrate(p, adaptive, state, tf, omega, v, step, dl)

    return body


def _sharded_kernel_pre(p, ax, adaptive, x, y, x_full) -> _RowPre:
    """The kernel body's per-align precompute: the centering (one
    psum), the tile bounds of the fixed rows, which never move, the
    self-sweeps' TileOrders (a self-pair's distances do not move with
    the transform) and the color caches."""
    nsp = ax.size
    bounds = tiles = None
    if p.tile_skip:
        # the tile bounds at the kernels' own tiles
        bounds = block_bounds(x.positions, x.mask, TILE_I)
        if adaptive:
            md_xx = aabb_min_d2(*block_bounds(x.positions, x.mask, TILE_W),
                                *block_bounds(x_full.positions, x_full.mask,
                                              TILE_W))
            box_y = block_bounds(y.positions, y.mask, TILE_W)
            # the block is the whole self-pair only at sp=1
            tiles = (tile_order(md_xx, symmetric=nsp == 1),
                     tile_order(aabb_min_d2(*box_y, *box_y), symmetric=True))
    ck_xy = ck_xx = ck_yy = None
    if p.color_mode == "linear":
        ck_xy = _masked_ci(p, x, y)
    elif p.ck_cache:
        ck_xy = color_gram(*x, *y, p=p)
        if adaptive:
            ck_xx = color_gram(*x, *x_full, p=p)
            ck_yy = color_gram(*y, *y, p=p)
    return _RowPre(_centered(x, ax), bounds, tiles, (ck_xy, ck_xx, ck_yy),
                   x_full)


def _sharded_kernel_body(p, ax, adaptive):
    """The kernel body of `_sharded_inner`, body(state, x, y, pre), `pre`
    a `_RowPre`: one `fused_moments` sweep of the block (and acvo's
    self-sweeps in one `fused_wsq` launch), the flow and line search as
    its epilogues, and two packed psums."""
    nsp = ax.size

    def body(state, x, y, pre):
        yp0, yf, ym = y
        c0, x_c, phi = pre.moments
        ck_xy, ck_xx, ck_yy = pre.ck
        tf_R, tf_T = se3.se3_inv(state.R, state.T)
        tf = se3.make_se3(tf_R, tf_T)
        yp = transform_cloud(tf_R, tf_T, yp0)
        md_xy = None
        if pre.bounds is not None:
            md_xy = aabb_min_d2(*pre.bounds,
                                *block_bounds(yp, ym, TILE_J))
        Mom_l, nnz_l = fused_moments(x_c, x.features, x.mask, yp - c0, yf,
                                     ym, phi, state.ell, ck_xy, md_xy, p=p)
        om_l, v_l, wsq_l, _ = flow_from_moments(Mom_l, yp, c0, c=p.c,
                                                d=p.d)
        dl = None
        if adaptive:
            # the self-sweeps feed only dl: the block's rows against the
            # whole fixed cloud, and y against itself (replicated), in
            # one launch
            tiles_xx, tiles_yy = pre.tiles or (None, None)
            w, nz = fused_wsq_sweeps([
                Sweep(tuple(x), tuple(pre.x_full), ck_xx, tiles_xx,
                      nsp == 1),
                Sweep((yp, yf, ym), (yp, yf, ym), ck_yy, tiles_yy, True),
            ], state.ell, p=p)
            omega, v, s_xy, s_xx, nnz_xx, nnz_xy = psum(
                (om_l, v_l, wsq_l, w[0], nz[0], nnz_l), ax)
            numer = (w[1] - 2.0 * s_xy + s_xx) / state.ell ** 3
            denom = nnz_xx + nz[1] - 2.0 * nnz_xy
            dl = numer / torch.where(denom == 0, 1.0, denom)
        else:
            omega, v = psum((om_l, v_l), ax)
        B, C, D, E = psum(step_from_moments(Mom_l, yp, c0, omega, v,
                                            state.ell), ax)
        step = _step_from_coeffs(p, B, C, D, E)
        return integrate(p, adaptive, state, tf, omega, v, step, dl)

    return body


def align_sharded(p, mesh, fixed: PointCloud, moving: PointCloud,
                  axis: str = "sp", device=None) -> AlignResult:
    """Register `moving` onto `fixed` with the fixed cloud's rows sharded
    over `axis` of `mesh` and the moving cloud whole on every rank.
    Every rank of the mesh calls it with the same clouds and gets the
    same result, on `device` (the rank's card unless `device="cpu"`).
    The fixed capacity must divide by the axis size.  The loop is
    compiled, as JAX jits the shard_map'ed while loop
    (`core.compiled.run_mesh`)."""
    return _align_sharded(p, mesh, fixed, moving, axis, device, run_mesh)


def _align_sharded(p, mesh, fixed, moving, axis, device, run):
    _check(p)
    adaptive = isinstance(p, AcvoParams)
    dev = rank_device(device)
    pin_fp32()
    ax = mesh.axis(axis)
    if fixed.capacity % ax.size:
        raise ValueError(f"fixed capacity {fixed.capacity} not divisible "
                         f"by {axis}={ax.size}")
    fixed, moving = _on((fixed, moving), dev)
    fixed, moving = _maybe_kd_sort(p, adaptive, fixed, moving, ax.size)
    return _sharded_inner("align_sharded", p, ax, adaptive,
                          _block(fixed, ax.index, ax.size), moving, run)


def _gather_lanes(res: AlignResult, ax) -> AlignResult:
    """The lanes of every rank of `ax`, in axis order, on every rank."""
    out = []
    for t in res:
        g = all_gather(t.to(torch.int32) if t.dtype == torch.bool else t,
                       ax)
        out.append(g.to(t.dtype))
    return AlignResult(*out)


def train_step_2d(p, mesh, fixed_b: PointCloud, moving_b: PointCloud,
                  dp: str = "dp", sp: str = "sp", device=None) -> AlignResult:
    """Register B pairs stacked on a lane axis over a 2-D mesh: the pairs
    shard over `dp`, each pair's fixed rows over `sp` (as
    `align_sharded`).  A dp rank's pairs run one after another (JAX's
    `lax.scan`), every pair of a key through one compiled loop; the
    batched result is on every rank.  B must divide by the dp size and
    the fixed capacity by the sp size."""
    return _train_step_2d(p, mesh, fixed_b, moving_b, dp, sp, device,
                          run_mesh)


def _train_step_2d(p, mesh, fixed_b, moving_b, dp, sp, device, run):
    _check(p)
    adaptive = isinstance(p, AcvoParams)
    dev = rank_device(device)
    pin_fp32()
    adp, asp = mesh.axis(dp), mesh.axis(sp)
    B = fixed_b.positions.shape[0]
    if B % adp.size or fixed_b.capacity % asp.size:
        raise ValueError(
            f"batch {B} must divide {dp}={adp.size}; capacity "
            f"{fixed_b.capacity} must divide {sp}={asp.size}")
    # this dp rank's pairs, each sorted as align_sharded sorts a pair
    # (kd_sort sorts lane by lane)
    per = B // adp.size
    mine = slice(adp.index * per, (adp.index + 1) * per)
    fixed_b, moving_b = _on((PointCloud(*(t[mine] for t in fixed_b)),
                             PointCloud(*(t[mine] for t in moving_b))), dev)
    fixed_b, moving_b = _maybe_kd_sort(p, adaptive, fixed_b, moving_b,
                                       asp.size)
    lanes = [
        _sharded_inner("train_step_2d", p, asp, adaptive,
                       _block(fixed_b.lane(i), asp.index, asp.size),
                       moving_b.lane(i), run)
        for i in range(per)
    ]
    return _gather_lanes(
        AlignResult(*(torch.stack(f) for f in zip(*lanes))), adp)


# ---------------------------------------------------------------------------
# Ring-streamed align
# ---------------------------------------------------------------------------

class _RingPre(NamedTuple):
    """The ring kernel body's per-align precompute (None where the
    params need none); `hops` holds, for each hop, what does not move
    during an align: linear mode's CI of the resident rows and the
    visiting block, and acvo's self-sweep TileOrders (x never moves; a y
    pair moves rigidly together)."""

    moments: tuple            # (c0, x - c0, Phi(x - c0)), c0 psum'd
    bounds: tuple | None      # (lo_x, hi_x) at the moment kernel's tiles
    hops: tuple               # per hop (ci, (tiles_xx, tiles_yy))


def _ring_kernel_pre(p, ax, adaptive, fixed, moving) -> _RingPre:
    """`_RingPre` of this rank's home blocks of the whole (sorted)
    clouds, every hop's up front.  At hop h a rank holds the blocks of
    the rank h steps back on the ring; every rank holds the same sorted
    clouds, so it takes them here by index, the bits they arrive with."""
    nsp = ax.size
    x = _block(fixed, ax.index, nsp)
    y = _block(moving, ax.index, nsp)
    bounds = None
    if p.tile_skip:
        bounds = block_bounds(x.positions, x.mask, TILE_I)
        box_xw = block_bounds(x.positions, x.mask, TILE_W)
        box_yh = block_bounds(y.positions, y.mask, TILE_W)
    hops = []
    for hop in range(nsp):
        src = (ax.index - hop) % nsp
        xb, yb = _block(fixed, src, nsp), _block(moving, src, nsp)
        ci = _masked_ci(p, x, yb) if p.color_mode == "linear" else None
        tiles = (None, None)
        if p.tile_skip and adaptive:
            tiles = tuple(tile_order(aabb_min_d2(*box, *block_bounds(
                c.positions, c.mask, TILE_W)))
                for box, c in ((box_xw, xb), (box_yh, yb)))
        hops.append((ci, tiles))
    return _RingPre(_centered(x, ax), bounds, tuple(hops))


def _ring_kernel_body(p, ax, adaptive):
    """The ring's kernel body, body(state, x, y, pre), `pre` a
    `_RingPre`: ONE sweep an iteration.  The visiting y block carries its
    moment block Mom_b = A[:, b]^T Phi(x') around the ring, each rank
    adding its resident rows' part (`fused_moments`, the color
    recomputed in the kernel: no [N/sp, M] cache) and, for acvo, the
    self-sweep partials of its rows against the visiting x block and of
    its home y block against the visiting y block (`fused_wsq`).  After
    a full cycle each block is home with its whole moments, and flow and
    line search are its epilogues and two packed psums."""

    def body(state, x, y, pre):
        xp, xf, xm = x
        yp0, yf, ym = y
        c0, x_c, phi = pre.moments
        tf_R, tf_T = se3.se3_inv(state.R, state.T)
        tf = se3.make_se3(tf_R, tf_T)
        yp_home = transform_cloud(tf_R, tf_T, yp0)
        mom = torch.zeros((yp0.shape[0], NUM_MONO), dtype=torch.float32,
                          device=yp0.device)
        payload = ((*x,) if adaptive else ()) + (yp0, yf, ym, mom)
        # (sxx, syy, nxx, nyy, nxy): the order of the psum below
        carry = [torch.zeros((), device=yp0.device) for _ in range(5)]
        for hop in range(ax.size):
            xb = PointCloud(*payload[:3]) if adaptive else None
            yb = PointCloud(*payload[-4:-1])
            ypb = transform_cloud(tf_R, tf_T, yb.positions)
            ck, tiles = pre.hops[hop]
            md = None
            if pre.bounds is not None:
                md = aabb_min_d2(*pre.bounds,
                                 *block_bounds(ypb, yb.mask, TILE_J))
            contrib, nnz = fused_moments(
                x_c, xf, xm, ypb - c0, yb.features, yb.mask, phi,
                state.ell, ck, md, p=p)
            mom = payload[-1] + contrib
            if adaptive:
                w, nz = fused_wsq_sweeps([
                    Sweep(tuple(x), tuple(xb), None, tiles[0]),
                    Sweep((yp_home, yf, ym), (ypb, yb.features, yb.mask),
                          None, tiles[1]),
                ], state.ell, p=p)
                carry = [carry[0] + w[0], carry[1] + w[1],
                         carry[2] + nz[0], carry[3] + nz[1],
                         carry[4] + nnz]
            payload = ppermute(payload[:-1] + (mom,), ax)
        mom_home = payload[-1]
        om_l, v_l, wsq_l, _ = flow_from_moments(mom_home, yp_home, c0,
                                                c=p.c, d=p.d)
        dl = None
        if adaptive:
            omega, v, sxy, sxx, syy, nxx, nyy, nxy = psum(
                (om_l, v_l, wsq_l, *carry), ax)
            numer = (syy - 2.0 * sxy + sxx) / state.ell ** 3
            denom = nxx + nyy - 2.0 * nxy
            dl = numer / torch.where(denom == 0, 1.0, denom)
        else:
            omega, v = psum((om_l, v_l), ax)
        B, C, D, E = psum(step_from_moments(mom_home, yp_home, c0, omega, v,
                                            state.ell), ax)
        step = _step_from_coeffs(p, B, C, D, E)
        return integrate(p, adaptive, state, tf, omega, v, step, dl)

    return body


def _ring_dense_pre(ax, adaptive, x):
    """The ring dense body's per-align precompute: for acvo, the valid
    fixed points (one psum) and the home block's global rows, for
    yy_quirk's row gate (adaptive_cvo.cpp:190/256); else None."""
    if not adaptive:
        return None
    n = x.positions.shape[0]
    return (psum(torch.sum(x.mask), ax),
            ax.index * n + torch.arange(n, device=x.positions.device))


def _ring_dense_body(p, ax, adaptive):
    """The ring's dense body, body(state, x, y, pre), `pre` from
    `_ring_dense_pre`: three sweeps an iteration.  Sweep 1 rotates the
    moving blocks for the flow partials (and the cross pair's dl
    partials); for acvo, sweep 1b rotates fixed and moving blocks
    together past the resident blocks for the self-pairs' partials
    (adaptive_cvo.cpp:222-271); sweep 2, once omega and v are known,
    rotates the moving blocks again for the line search."""

    def sweep(payload, fn, carry):
        for _ in range(ax.size):
            carry = fn(carry, payload)
            payload = ppermute(payload, ax)
        return carry

    def body(state, x, y, pre):
        xp, xf, xm = x
        yp0, yf, ym = y
        dev = xp.device
        tf_R, tf_T = se3.se3_inv(state.R, state.T)
        tf = se3.make_se3(tf_R, tf_T)

        def gram(blk):
            ypb = transform_cloud(tf_R, tf_T, blk[0])
            return ypb, _se_gram(p, xp, xf, xm, ypb, blk[1], blk[2],
                                 state.ell)

        def flow_blk(carry, blk):
            om, vv, sxy, nxy = carry
            ypb, A = gram(blk)
            o_l, v_l = flow_mod.flow(A, xp, ypb, c=p.c, d=p.d)
            if adaptive:
                sxy = sxy + flow_mod.weighted_sqdist_sum(A, xp, ypb)
                nxy = nxy + flow_mod.nnz(A)
            return om + o_l, vv + v_l, sxy, nxy

        zero = torch.zeros((), device=dev)
        izero = torch.zeros((), dtype=torch.int64, device=dev)
        om, vv, sxy, nxy = sweep((yp0, yf, ym), flow_blk,
                                 (torch.zeros(3, device=dev),
                                  torch.zeros(3, device=dev), zero, izero))
        dl = None
        if adaptive:
            num_fixed, rows = pre
            yp_rows = transform_cloud(tf_R, tf_T, yp0)

            def adapt_blk(carry, blk):
                sxx, nxx, syy, nyy = carry
                xpb, xfb, xmb, ypb0, yfb, ymb = blk
                Axx = _se_gram(p, xp, xf, xm, xpb, xfb, xmb, state.ell)
                ypb = transform_cloud(tf_R, tf_T, ypb0)
                Ayy = _se_gram(p, yp_rows, yf, ym, ypb, yfb, ymb,
                               state.ell)
                if p.yy_quirk:
                    Ayy_eff = Ayy * (rows >= num_fixed).to(Ayy.dtype)[:, None]
                else:
                    Ayy_eff = Ayy
                return (sxx + flow_mod.weighted_sqdist_sum(Axx, xp, xpb),
                        nxx + flow_mod.nnz(Axx),
                        syy + flow_mod.weighted_sqdist_sum(Ayy_eff, yp_rows,
                                                           ypb),
                        nyy + flow_mod.nnz(Ayy))

            sxx, nxx, syy, nyy = sweep((xp, xf, xm, yp0, yf, ym), adapt_blk,
                                       (zero, izero, zero, izero))
            # omega and v are first needed by sweep 2: they ride one psum
            # with dl's partials
            omega, v, sxy, sxx, syy, nxx, nyy, nxy = psum(
                (om, vv, sxy, sxx, syy, nxx, nyy, nxy), ax)
            numer = (syy - 2.0 * sxy + sxx) / state.ell ** 3
            denom = nxx + nyy - 2 * nxy
            dl = numer / torch.where(denom == 0, 1, denom).to(numer.dtype)
        else:
            omega, v = psum((om, vv), ax)

        def step_blk(carry, blk):
            ypb, A = gram(blk)
            return tuple(a + b for a, b in zip(carry, step_coefficients_factored(
                A, xp, ypb, omega, v, state.ell)))

        B, C, D, E = psum(sweep((yp0, yf, ym), step_blk, (zero,) * 4), ax)
        step = _step_from_coeffs(p, B, C, D, E)
        return integrate(p, adaptive, state, tf, omega, v, step, dl)

    return body


def align_ring(p, mesh, fixed: PointCloud, moving: PointCloud,
               axis: str = "sp", device=None) -> AlignResult:
    """Register `moving` onto `fixed` with both clouds sharded over
    `axis` of `mesh` and their blocks riding the ring; the largest block
    a rank evaluates is [N/sp, M/sp].  Every rank calls it with the same
    clouds and gets the same result, on `device` (the rank's card unless
    `device="cpu"`).  Both capacities must divide by the ring size.

    With the kernel body the iteration is one sweep of the ring
    (`_ring_kernel_body`), else three (`_ring_dense_body`).  The loop is
    compiled (`core.compiled.run_mesh`), every hop's per-align
    precompute made before it."""
    return _align_ring(p, mesh, fixed, moving, axis, device, run_mesh)


def _align_ring(p, mesh, fixed, moving, axis, device, run):
    _check(p)
    adaptive = isinstance(p, AcvoParams)
    dev = rank_device(device)
    pin_fp32()
    ax = mesh.axis(axis)
    nsp = ax.size
    if fixed.capacity % nsp or moving.capacity % nsp:
        raise ValueError("cloud capacities must divide the ring size")
    fixed, moving = _on((fixed, moving), dev)
    fixed, moving = _maybe_kd_sort(p, adaptive, fixed, moving, nsp,
                                   both=True)
    use_kernel = _sharded_kernel_eligible(p, adaptive, fixed.capacity // nsp,
                                          moving.capacity // nsp)
    x, y = _block(fixed, ax.index, nsp), _block(moving, ax.index, nsp)
    if use_kernel:
        pre = _ring_kernel_pre(p, ax, adaptive, fixed, moving)
        body = _ring_kernel_body(p, ax, adaptive)
    else:
        pre = _ring_dense_pre(ax, adaptive, x)
        body = _ring_dense_body(p, ax, adaptive)
    return run(f"align_ring's {'kernel' if use_kernel else 'dense'} body",
               p, ax, body, x, y, pre, init_state(p, dev))


# ---------------------------------------------------------------------------
# Batch data parallelism over frame pairs
# ---------------------------------------------------------------------------

def align_batched(p, fixed_batch: PointCloud, moving_batch: PointCloud,
                  mesh=None, dp_axis: str = "dp", R0=None, T0=None,
                  ell0=None, device=None) -> AlignResult:
    """Register B pairs stacked on a leading lane axis
    (`core.cloud.stack_clouds`); returns a batched AlignResult.

    Each lane stops on its own and a converged lane freezes, so a lane's
    result does not depend on the lanes beside it.  `R0` [B,3,3] / `T0`
    [B,3] / `ell0` [B] warm-start each lane (see
    core.registration.align); all three are given together or not at
    all.

    - `backend="fused"`: the batch is kd-sorted lane by lane in one call
      and registered by ONE launch of the whole-align kernel
      (`ops/align_fused.align_fused_batched`), every lane running its own
      loop, as vmap makes the Pallas kernel a grid dimension.  A problem
      the kernel cannot run is routed as `align` routes one pair.
    - `backend="kernel"` and `"dense"`: the counterpart of JAX's
      jit(vmap(align)).  The batch is routed once (`route`: the feature
      padding, and on "kernel" the kd-sort, lane by lane in one call),
      the kernel backend's color caches are built for all the lanes in
      one `color_gram` launch a cache (`prepare_batch`; three for exact
      and cheb acvo, whose Chebyshev tables of every lane are one
      `fused_wsq` launch).  The dense backend and the kernel backend's
      moment step then run the batch as ONE compiled loop
      (`core/compiled.run_compiled` on the stacked state,
      `registration.make_batched_step`) until the slowest lane
      converges: on "kernel" one `fused_moments` launch an iteration
      sweeps every lane that has not converged (and exact acvo's
      self-sweeps one `fused_wsq` launch), on "dense" the Grams are
      [B, N, M].  The kernel backend's direct step runs the lanes one
      after another through the compiled align loop, every lane of a
      key through one compiled align.  Either way each lane's result is
      the bits of `align` on its pair.

    With a `mesh`, the lanes shard over its `dp_axis` (B must divide by
    its size): each dp rank registers its B/dp lanes as above, on its
    `device` (the rank's card unless `device="cpu"`), and the ranks
    gather every lane, so each holds the whole result, a lane's bits
    those of the unsharded call.  Every rank of the mesh calls it with
    the same batch.  Without a mesh it runs on `device` (the card unless
    `device="cpu"`)."""
    warm = (R0, T0, ell0)
    if any(w is not None for w in warm) and any(w is None for w in warm):
        raise ValueError("pass R0, T0 and ell0 together")
    check_supported(p)
    if mesh is not None:
        ax = mesh.axis(dp_axis)
        B = fixed_batch.positions.shape[0]
        if B % ax.size:
            raise ValueError(f"batch {B} must divide {dp_axis}={ax.size}")
        per = B // ax.size
        sl = slice(ax.index * per, (ax.index + 1) * per)
        R0, T0, ell0 = (None if w is None else w[sl] for w in warm)
        local = align_batched(
            p, PointCloud(*(t[sl] for t in fixed_batch)),
            PointCloud(*(t[sl] for t in moving_batch)), R0=R0, T0=T0,
            ell0=ell0, device=rank_device(device))
        return _gather_lanes(local, ax)
    dev = resolve_device(device)
    pin_fp32()
    p, fixed, moving = route(p, fixed_batch.to(dev), moving_batch.to(dev))
    if p.backend == "fused":
        return align_fused_batched(p, fixed, moving, *warm)
    B = fixed.positions.shape[0]
    pre = prepare_batch(p, fixed, moving,
                        [None if ell0 is None else ell0[i] for i in range(B)])
    if batched_loop(p):
        return run_compiled(p, fixed, moving, pre,
                            init_state(p, dev, R0, T0, ell0, lanes=B))
    R0, T0, ell0 = ([None if w is None else w[i] for i in range(B)]
                    for w in warm)
    lanes = [
        run_compiled(p, fixed.lane(i), moving.lane(i), lane_pre(pre, i),
                     init_state(p, dev, R0[i], T0[i], ell0[i]))
        for i in range(B)
    ]
    return AlignResult(*(torch.stack(field) for field in zip(*lanes)))
