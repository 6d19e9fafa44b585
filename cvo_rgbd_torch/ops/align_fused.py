"""The whole align loop in one kernel launch.

`align_fused` replaces the JAX package's `ops/pallas_align.py:align_fused`
and both of its TPU kernels: `_make_kernel` (the clouds resident, mode
"resident") and `_make_tiled_kernel` (the Gram swept in tiles every
iteration, mode "tiled").  Every iteration of cvo.cpp:361-420 (and of
adaptive_cvo.cpp:490-555 for acvo) runs on the card: the Gram sweep, the
flow, the line-search coefficients, the cubic, the SE(3) update, both
stops and the length-scale update, with no host round trip and one
launch per align.

`align_fused_batched` registers B pairs stacked on a leading lane axis
(`core.cloud.stack_clouds`) in ONE launch of the same kernel, as the JAX
package's vmap of align_fused does (its bench.py headline path): every
lane runs its own loop, stops on its own and freezes once converged, and
each lane's results are the bits of its pair's single-pair launch.  The
single-pair wrapper is the batched launch with one lane.

On a CUDA tensor the wrapper launches `csrc/align_fused.cu` (or raises);
on a CPU tensor it runs `align_fused_plain` (lane by lane), a Python loop over
iterations on dense [N, M] tensors that follows the kernel's algebra for
each mode:

- resident: the flow in difference form from full rows of A,
  r_i = sum_j A_ij y_j - (sum_j A_ij) x_i (pallas_align.py:507-528), and
  acvo's self sums over the untransformed clouds (:430-505);
- tiled: the flow from the moment matrix (core/moments.py, as
  pallas_align.py:915-945), acvo's self sums with the moving cloud
  transformed (:947-1054), and the exact AABB tile skip when
  `p.tile_skip` is on.

Both modes take the line-search coefficients from the moment matrix
Mom = A^T Phi(x - c0) (:556-605, 1056-1119).  In MATLAB's linear color
mode (cvo only, 3 color features in the kernel's 5 planes, the rest
zero) A = ci * k with ci = color_scale * (xf . yf) formed per pair and
the gate k >= sp_thres (:413-415, 477-479, 811-816).  The color kernel is
recomputed in the kernel and the self sums are always swept exactly, so
`ck_cache` and `self_mode` do not apply here.
"""

from __future__ import annotations

import functools
import math

import torch

from cvo_rgbd_torch import se3
from cvo_rgbd_torch.core.cloud import PointCloud, aabb_min_d2, block_bounds
from cvo_rgbd_torch.core.cubic import cubic_roots, min_positive_root
from cvo_rgbd_torch.core.gram import pairwise_sqdist
from cvo_rgbd_torch.core.moments import flow_from_moments, step_from_moments
from cvo_rgbd_torch.core.numerics import exp_neg
from cvo_rgbd_torch.core.step_factored import (
    M_INDEX,
    MONOMIALS,
    NUM_MONO,
    monomial_features,
)
from cvo_rgbd_torch.ops import _build
from cvo_rgbd_torch.ops.gram import NFEAT, check_inputs
from cvo_rgbd_torch.ops.moments import (
    SKIP_MARGIN,
    TILE_I,
    TILE_J,
    sweep_scratch,
)
from cvo_rgbd_torch.ops.wsq import TILE_W
from cvo_rgbd_torch.params import AcvoParams

# rows of a resident row item and of the kernel's padding
# (csrc/align_fused.cu ROWS)
ROWS = 128
# the kernel's result row: tf 12 | R 9 | T 3 | k | conv | ell | omega 3 | v 3
OUT_LEN = 33
# per-align constants (csrc/align_fused.cu enum Const)
(C_S2, C_CS2, C_INV2CL2, C_D2_C_THRES, C_THRES_C, C_SP_THRES, C_INV_C,
 C_INV_D, C_EPS, C_EPS_2, C_MIN_STEP, C_MAX_STEP, C_MAX_ITER, C_DL_STEP,
 C_ELL_MIN, C_ELL_SHRINK, C_ELL_MAX_INIT, C_COLOR_SCALE, C_LINEAR,
 N_CONST) = range(20)


def _shift_table():
    """[35, 4] int32: the index of monomial e times (1, x0, x1, x2), -1
    where the product's degree exceeds 4.  The kernel contracts the
    line-search polynomials through it, so it and the plain version
    share the monomial order of core/step_factored.py:M_INDEX."""
    units = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))
    rows = []
    for e in MONOMIALS:
        row = []
        for u in units:
            s = (e[0] + u[0], e[1] + u[1], e[2] + u[2])
            row.append(M_INDEX[s] if sum(s) <= 4 else -1)
        rows.append(row)
    return torch.tensor(rows, dtype=torch.int32)


SHIFT_TABLE = _shift_table()


def fused_mode(p, fixed: PointCloud, moving: PointCloud):
    """None (not eligible), "resident" or "tiled", with the thresholds
    of the JAX package's `_fused_mode` (pallas_align.py:1201-1234) but
    its feature count, which `fused_eligible` checks on the clouds align
    is given (it pads them before the launch).  Stacked clouds are
    judged by their lanes' shapes."""
    n, m = fixed.positions.shape[-2], moving.positions.shape[-2]
    adaptive = isinstance(p, AcvoParams)
    if adaptive and (p.yy_quirk or p.color_mode != "se"):
        return None
    if adaptive:
        if n % 128 == 0 and m % 128 == 0 and (
            n * m + n * n + m * m
        ) <= (3 << 20):
            return "resident"
    elif n % 8 == 0 and m % 128 == 0 and n * m <= (1 << 20):
        return "resident"
    if n % 128 == 0 and m % 128 == 0 and n <= 4096 and m <= 4096:
        return "tiled"
    return None


def fused_eligible(p, fixed: PointCloud, moving: PointCloud) -> bool:
    """True when `align_fused` can run this problem (see `fused_mode`).
    In linear color mode the clouds must carry the 3 colors the kernel
    forms the CI from, as in the JAX package's `_fused_mode`."""
    if p.color_mode == "linear" and fixed.features.shape[-1] != 3:
        return False
    return fused_mode(p, fixed, moving) is not None


def constants(p) -> list:
    """Per-align constants as Python floats, computed in the JAX
    package's order (pallas_align.py:362-386).  The ell-dependent
    thresholds 1/(2 ell^2) and thres_c ell^2 are formed every iteration
    from the current ell, in the kernel as in the plain version.  cvo's
    ell schedule, of any length, goes to the kernel as its own array.
    Linear color mode sets C_LINEAR and C_COLOR_SCALE."""
    adaptive = isinstance(p, AcvoParams)
    s2 = float(p.sigma) ** 2
    cs2 = float(p.c_sigma) ** 2
    c = [0.0] * N_CONST
    c[C_S2], c[C_CS2] = s2, cs2
    c[C_INV2CL2] = 1.0 / (2.0 * float(p.c_ell) ** 2)
    c[C_D2_C_THRES] = -2.0 * float(p.c_ell) ** 2 * math.log(
        float(p.c_sp_thres) / cs2)
    c[C_THRES_C] = -2.0 * math.log(float(p.sp_thres) / s2)
    c[C_SP_THRES] = float(p.sp_thres)
    c[C_INV_C], c[C_INV_D] = 1.0 / float(p.c), 1.0 / float(p.d)
    c[C_EPS], c[C_EPS_2] = float(p.eps), float(p.eps_2)
    c[C_MIN_STEP], c[C_MAX_STEP] = float(p.min_step), float(p.max_step)
    c[C_MAX_ITER] = float(p.max_iter)
    if adaptive:
        c[C_DL_STEP], c[C_ELL_MIN] = float(p.dl_step), float(p.ell_min)
        c[C_ELL_SHRINK] = float(p.ell_shrink)
        c[C_ELL_MAX_INIT] = float(p.ell_max_init)
    else:
        c[C_ELL_MAX_INIT] = 1e9
    if p.color_mode == "linear":
        c[C_COLOR_SCALE], c[C_LINEAR] = float(p.color_scale), 1.0
    return c


def _exp_neg(z):
    """The kernel's exp(-z) in float32; the exact one for a float64
    reference."""
    return exp_neg(z) if z.dtype == torch.float32 else torch.exp(-z)


def _gated(k, xp, xf, xm, yp, yf, ym, ell):
    """(A, d2) of the gated Gram at `ell` (pallas_align.py:805-824)."""
    d2 = pairwise_sqdist(xp, yp)
    if k[C_LINEAR]:
        ci = k[C_COLOR_SCALE] * (xf[:, None, 0] * yf[None, :, 0]
                                 + xf[:, None, 1] * yf[None, :, 1]
                                 + xf[:, None, 2] * yf[None, :, 2])
        kmat = k[C_S2] * _exp_neg(d2 * (1.0 / (2.0 * ell * ell)))
        gate = ((kmat >= k[C_SP_THRES]) & (xm[:, None] > 0)
                & (ym[None, :] > 0))
        return torch.where(gate, ci * kmat, 0.0), d2
    d2c = pairwise_sqdist(xf, yf)
    ck = k[C_CS2] * _exp_neg(d2c * k[C_INV2CL2])
    a = k[C_S2] * _exp_neg(d2 * (1.0 / (2.0 * ell * ell))) * ck
    gate = ((d2 < k[C_THRES_C] * ell * ell) & (d2c < k[C_D2_C_THRES])
            & (a > k[C_SP_THRES]) & (xm[:, None] > 0) & (ym[None, :] > 0))
    return torch.where(gate, a, 0.0), d2


def _keep(md, ell, k, ti, tj):
    """Dense mask of the tiles the exact AABB skip keeps."""
    keep = md <= k[C_THRES_C] * ell * ell + SKIP_MARGIN
    return keep.repeat_interleave(ti, 0).repeat_interleave(tj, 1)


def _self_sums(k, cloud, pos, ell, md, counts=None):
    """(sum A d2, nnz) of a self-Gram, the skip applied when md is set."""
    A, d2 = _gated(k, pos, cloud.features, cloud.mask, pos, cloud.features,
                   cloud.mask, ell)
    if md is not None:
        A = torch.where(_keep(md, ell, k, TILE_W, TILE_W), A, 0.0)
    if counts is not None:
        nb = pos.shape[0] // TILE_W
        upper = torch.triu(torch.ones(nb, nb, dtype=torch.bool,
                                      device=pos.device))
        kept = upper if md is None else upper & (
            md <= k[C_THRES_C] * ell * ell + SKIP_MARGIN)
        per_tile = (A > 0).reshape(nb, TILE_W, nb, TILE_W).sum(dim=(1, 3))
        _add(counts, "self_pairs", int(kept.sum()) * TILE_W * TILE_W)
        _add(counts, "self_gated", int(per_tile[kept].sum()))
    return torch.sum(A * d2), (A > 0).sum().to(A.dtype)


def _add(counts, key, value):
    counts[key] = counts.get(key, 0) + value


def _self_bounds(cloud):
    lo, hi = block_bounds(cloud.positions, cloud.mask, TILE_W)
    return aabb_min_d2(lo, hi, lo, hi)


def _pairwise_sum(t):
    """Sum over dim -2 by halving, in an order fixed by the length alone:
    a lane's sum is the same bits whatever the lanes beside it (a torch
    reduction may split its order by the size of the whole tensor)."""
    while t.shape[-2] > 1:
        if t.shape[-2] % 2:
            t = torch.cat([t, torch.zeros_like(t[..., :1, :])], dim=-2)
        half = t.shape[-2] // 2
        t = t[..., :half, :] + t[..., half:, :]
    return t[..., 0, :]


def moments_center(fixed: PointCloud):
    """(c0 [..., 3], Phi(x - c0) [..., N, 35]): the masked centroid of
    the fixed cloud centers the moment basis (pallas_align.py:1286-1294);
    a leading lane axis passes through."""
    w = fixed.mask
    c0 = _pairwise_sum(fixed.positions * w[..., None]) / torch.clamp_min(
        torch.sum(w, dim=-1, keepdim=True), 1.0)
    return c0, monomial_features(fixed.positions - c0[..., None, :])


def _transform(R, T, pos):
    """tf * y with tf = [R', -R'T], per coordinate in the JAX order
    (pallas_align.py:460-471)."""
    Rt = R.T
    tT = Rt[:, 0] * T[0] + Rt[:, 1] * T[1] + Rt[:, 2] * T[2]
    ty = torch.stack([
        Rt[r, 0] * pos[:, 0] + Rt[r, 1] * pos[:, 1] + Rt[r, 2] * pos[:, 2]
        - tT[r] for r in range(3)
    ], dim=1)
    return Rt, -tT, ty


def _initial(p, dev, R0, T0, ell0, dtype):
    """(R, T, ell) at iteration 0, as core.registration.init_state."""
    from cvo_rgbd_torch.core.registration import init_state

    s = init_state(p, dev, R0, T0, ell0)
    return (s.R.reshape(3, 3).to(dtype), s.T.reshape(3).to(dtype),
            s.ell.to(dtype))


def align_fused_plain(p, fixed: PointCloud, moving: PointCloud, R0=None,
                      T0=None, ell0=None, mode=None, counts=None,
                      dtype=torch.float32):
    """Plain torch version of the kernel; returns the [33] result row
    (tf 12 | R 9 | T 3 | k | conv | ell | omega 3 | v 3).

    `counts`, a dict, if given, gathers over the iterations the pairs
    the function needs: "pairs" and "gated" of the moment sweep (kept
    tiles only), and "self_pairs" and "self_gated" of acvo's
    upper-triangle self sweeps.  Resident mode's row sweep evaluates
    the moment sweep's pairs a second time; they are not counted.

    `dtype=torch.float64` (CPU only) runs the same algebra on the clouds
    cast to float64, with the exact exp: a reference that tells which
    of two float32 results drifted."""
    mode = mode or fused_mode(p, fixed, moving)
    adaptive = isinstance(p, AcvoParams)
    k = constants(p)
    dev = fixed.positions.device
    if dtype != torch.float32:
        if dtype != torch.float64 or dev.type != "cpu":
            raise ValueError("align_fused_plain: float64 runs on the CPU "
                             f"only; got {dtype} on {dev}")
        fixed, moving = (PointCloud(*(t.to(dtype) for t in c))
                         for c in (fixed, moving))
    x, y0 = fixed.positions, moving.positions
    c0, phi = moments_center(fixed)
    R, T, ell = _initial(p, dev, R0, T0, ell0, dtype)
    ell_max = torch.tensor(k[C_ELL_MAX_INIT], dtype=dtype, device=dev)
    tf = torch.eye(4, dtype=dtype, device=dev)[:3].clone()
    om = torch.zeros(3, dtype=dtype, device=dev)
    vv = torch.zeros(3, dtype=dtype, device=dev)
    conv = False
    it = 0
    skip = mode == "tiled" and p.tile_skip
    if skip:
        lo_x, hi_x = block_bounds(x, fixed.mask, TILE_I)
        md_xx = _self_bounds(fixed) if adaptive else None
        md_yy = _self_bounds(moving) if adaptive else None
    else:
        md_xx = md_yy = None
    # a self sum over an untransformed cloud depends on ell alone, and
    # acvo's ell rests on its floor for most of an align: the sums (and
    # their pair counts) are kept per ell value, the same bits
    memo = {}

    def self_sums(name, cloud, pos, md):
        key = (name, float(ell))
        if key not in memo:
            tally = None if counts is None else {}
            memo[key] = (*_self_sums(k, cloud, pos, ell, md, tally), tally)
        s_w, n_w, tally = memo[key]
        for kk, v in (tally or {}).items():
            _add(counts, kk, v)
        return s_w, n_w

    while it < p.max_iter and not conv:
        Rt, t_inv, ty = _transform(R, T, y0)
        tf = torch.cat([Rt, t_inv[:, None]], dim=1)
        A, d2 = _gated(k, x, fixed.features, fixed.mask, ty,
                       moving.features, moving.mask, ell)
        kept = A.numel()
        if skip:
            lo_y, hi_y = block_bounds(ty, moving.mask, TILE_J)
            md = aabb_min_d2(lo_x, hi_x, lo_y, hi_y)
            keep = _keep(md, ell, k, TILE_I, TILE_J)
            A = torch.where(keep, A, 0.0)
            kept = int(keep.sum())
        if counts is not None:
            _add(counts, "pairs", kept)
            _add(counts, "gated", int((A > 0).sum()))
        Mom = A.T @ phi
        if mode == "resident":
            rowA = torch.sum(A, dim=1)
            r = A @ ty - rowA[:, None] * x
            om = torch.sum(torch.linalg.cross(x, r, dim=-1), dim=0) * k[C_INV_C]
            vv = torch.sum(r, dim=0) * k[C_INV_D]
            s_xy = torch.sum(A * d2)
        else:
            om, vv, s_xy, _ = flow_from_moments(Mom, ty, c0, c=p.c, d=p.d)
        if adaptive:
            n_xy = (A > 0).sum().to(dtype)
            s_xx, n_xx = self_sums("x", fixed, x, md_xx)
            if mode == "resident":
                s_yy, n_yy = self_sums("y", moving, y0, md_yy)
            else:
                s_yy, n_yy = _self_sums(k, moving, ty, ell, md_yy, counts)
            denom = n_xx + n_yy - 2.0 * n_xy
            denom = torch.where(denom == 0, 1.0, denom)
            dl = (s_yy - 2.0 * s_xy + s_xx) / (ell * ell * ell) / denom
        B, C, D, E = step_from_moments(Mom, ty, c0, om, vv, ell)
        roots, valid = cubic_roots(4.0 * E, 3.0 * D, 2.0 * C, B, dtype)
        step = min_positive_root(roots, valid, p.min_step, p.max_step)

        stop1 = bool((torch.linalg.norm(om) < p.eps)
                     & (torch.linalg.norm(vv) < p.eps))
        dR, dT = se3.exp_sek3(om, vv, step)
        if not stop1:
            R, T = R @ dR, R @ dT + T
        conv = stop1 or bool(se3.dist_se3(dR, dT) < p.eps_2)
        if not conv:
            if adaptive:
                ell_new = ell + p.dl_step * dl
                if bool(ell_new >= ell_max):
                    ell_max = ell_max * p.ell_shrink
                    ell_new = ell_max
                ell = torch.clamp_min(ell_new, p.ell_min)
            else:
                for thresh, val in p.ell_sched:
                    if it > thresh:
                        ell = torch.tensor(val, dtype=dtype, device=dev)
        it += 1
    return torch.cat([
        tf.reshape(12), R.reshape(9), T.reshape(3),
        torch.tensor([float(it), float(conv)], dtype=dtype, device=dev),
        ell.reshape(1), om.reshape(3), vv.reshape(3),
    ])


def result_from_row(row):
    """AlignResult from the [..., 33] rows (a leading lane axis passes
    through), with no host sync."""
    from cvo_rgbd_torch.core.registration import AlignResult

    lead = row.shape[:-1]
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=row.dtype,
                          device=row.device).expand(*lead, 1, 4)
    return AlignResult(
        tf=torch.cat([row[..., 0:12].reshape(*lead, 3, 4), bottom], dim=-2),
        R=row[..., 12:21].reshape(*lead, 3, 3),
        T=row[..., 21:24],
        iterations=row[..., 24].to(torch.int32) - 1,
        converged=row[..., 25] > 0,
        ell=row[..., 26],
        omega=row[..., 27:30],
        v=row[..., 30:33],
    )


def _check(name, p, fixed: PointCloud, moving: PointCloud):
    """The mode of an eligible problem with NFEAT feature planes."""
    mode = fused_mode(p, fixed, moving)
    if mode is None:
        raise ValueError(
            f"{name}: problem not eligible for the fused kernel "
            "(capacity alignment, pair budget, or yy_quirk); use "
            "backend='kernel' or 'dense'"
        )
    for c in (fixed, moving):
        if c.features.shape != c.positions.shape[:-1] + (NFEAT,):
            raise ValueError(f"{name}: features must be [..., N, {NFEAT}]")
    dev = fixed.positions.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return mode


def align_fused(p, fixed: PointCloud, moving: PointCloud, R0=None, T0=None,
                ell0=None):
    """Single-launch align of (already kd-sorted) clouds; returns an
    AlignResult (tf from the top of the last executed iteration,
    iterations = k - 1, cvo.cpp:413-415).  `R0`/`T0`/`ell0` seed the
    state as in core.registration.align."""
    mode = _check("align_fused", p, fixed, moving)
    if fixed.positions.device.type == "cpu":
        return result_from_row(
            align_fused_plain(p, fixed, moving, R0, T0, ell0, mode))
    return result_from_row(
        align_fused_cuda(p, fixed, moving, R0, T0, ell0, mode))


def align_fused_batched(p, fixed: PointCloud, moving: PointCloud, R0=None,
                        T0=None, ell0=None):
    """B aligns of (already kd-sorted) clouds stacked on a leading lane
    axis, in one launch; returns a batched AlignResult.  `R0` [B,3,3],
    `T0` [B,3] and `ell0` [B] seed each lane's state.  On the CPU the
    plain version runs lane by lane."""
    mode = _check("align_fused_batched", p, fixed, moving)
    if fixed.positions.device.type == "cuda":
        return result_from_row(
            align_fused_batched_cuda(p, fixed, moving, R0, T0, ell0, mode))
    rows = []
    for i in range(fixed.positions.shape[0]):
        warm = [None if w is None else w[i] for w in (R0, T0, ell0)]
        rows.append(align_fused_plain(p, fixed.lane(i), moving.lane(i),
                                      *warm, mode))
    return result_from_row(torch.stack(rows))


def _pad_rows(cloud: PointCloud, n: int) -> PointCloud:
    """Masked zero rows up to capacity n: they gate to A = 0."""
    ax = cloud.mask.dim() - 1
    extra = n - cloud.mask.shape[ax]
    if extra == 0:
        return cloud

    def pad(t):
        shape = list(t.shape)
        shape[ax] = extra
        return torch.cat([t, t.new_zeros(shape)], dim=ax)

    return PointCloud(*(pad(t) for t in cloud))


def _upload(values, dev):
    """A short host list as f32 on the card.  A copy from pageable host
    memory first waits for the stream; from pinned memory it is queued
    behind the work before it, so the wrapper does not stall."""
    host = torch.tensor(values, dtype=torch.float32).pin_memory()
    return host.to(dev, non_blocking=True)


@functools.lru_cache(maxsize=None)
def _shift_table_on(dev):
    return SHIFT_TABLE.to(dev)


def _init_rows(p, dev, b, R0, T0, ell0, c0):
    """[b, 16] init rows (R0 9 | T0 3 | c0 3 | ell0): identity and
    p.ell_init unless R0 [b,3,3] / T0 [b,3] / ell0 [b] (or one pair's,
    for every lane) say otherwise, as core.registration.init_state."""
    f32 = torch.float32

    def given(v, default):
        return (default if v is None
                else torch.as_tensor(v, dtype=f32).to(dev))

    R = given(R0, torch.eye(3, dtype=f32, device=dev)).expand(b, 3, 3)
    T = given(T0, torch.zeros(3, dtype=f32, device=dev)).expand(b, 3)
    ell = given(ell0, torch.full((), p.ell_init, dtype=f32, device=dev))
    return torch.cat([R.reshape(b, 9), T.reshape(b, 3), c0.reshape(b, 3),
                      ell.expand(b).reshape(b, 1)], dim=1).contiguous()


def lane_scratch(n: int, m: int, mode: str, adaptive: bool) -> dict:
    """{name: (shape, dtype)} of one lane's scratch and result row, in
    the kernel's argument order and at the strides of
    csrc/align_fused.cu:at_lane.  A
    moment item is one (i-tile, j-block) pair with its own partial slot
    and count (ops/moments.py:sweep_scratch); a j-block's ticket counts
    the moment items of its kept tiles, and acvo's last ticket a lane's
    column and self items.  Every shape follows from (n, m, mode, adaptive) alone: a
    batch allocates lanes x these, and no split depends on the grid."""
    f32, i32 = torch.float32, torch.int32
    sweep = sweep_scratch(n, m)
    nbj = m // TILE_J
    nbx, nby = n // TILE_W, m // TILE_W
    n_self = (nbx * (nbx + 1) // 2 + nby * (nby + 1) // 2) if adaptive else 0
    n_flow = n // ROWS if mode == "resident" else nbj
    return {
        "mom_part": (sweep["part"], f32),
        "cnt_part": (sweep["count"], i32),
        "cnt_col": ((nbj,), i32),
        "ticket": ((nbj + 1,), i32),
        "mom": ((NUM_MONO, m), f32),
        "flow_part": ((max(n_flow, 1), 8), f32),
        "self_w": ((max(n_self, 1),), f32),
        "self_c": ((max(n_self, 1),), i32),
        "red": ((8,), f32),
        "bcde_part": ((nbj, 4), f32),
        "out": ((OUT_LEN,), f32),
    }


def align_fused_cuda(p, fixed: PointCloud, moving: PointCloud, R0=None,
                     T0=None, ell0=None, mode=None, timed=False):
    """Launch csrc/align_fused.cu on one pair of CUDA tensors: the
    batched launch with one lane.  Returns the [33] result row."""
    one = [None if w is None else torch.as_tensor(w)[None]
           for w in (R0, T0, ell0)]
    return align_fused_batched_cuda(
        p, PointCloud(*(t[None] for t in fixed)),
        PointCloud(*(t[None] for t in moving)), *one, mode, timed)[0]


def align_fused_batched_cuda(p, fixed: PointCloud, moving: PointCloud,
                             R0=None, T0=None, ell0=None, mode=None,
                             timed=False):
    """Launch csrc/align_fused.cu once on B stacked pairs of CUDA tensors
    ([B, N, ...]); returns the [B, 33] result rows and counts one launch
    in `align_fused.launches`.  A refused cooperative launch raises.
    The per-align constants and the ell schedule are uploaded once for
    the batch; every other input and scratch has a leading lane axis.
    `timed` launches the timing tool's build of the kernel, whose
    per-phase timers `phase_ns` reads."""
    mode = mode or fused_mode(p, fixed, moving)
    adaptive = isinstance(p, AcvoParams)
    dev = fixed.positions.device
    resident = mode == "resident"
    b = fixed.positions.shape[0]
    # a resident fixed cloud whose capacity is a multiple of 8 only is
    # padded to whole row items; the padding rows are masked out
    n = -(-fixed.positions.shape[1] // ROWS) * ROWS
    fixed_k = _pad_rows(fixed, n)
    c0, phi = moments_center(fixed)
    phi = torch.cat([phi, phi.new_zeros((b, n - phi.shape[1], NUM_MONO))],
                    dim=1)
    init = _init_rows(p, dev, b, R0, T0, ell0, c0)
    consts = _upload(constants(p), dev)
    sched = () if adaptive else tuple(p.ell_sched)
    # (after k, ell) pairs; one unused slot when there are none
    sched_t = _upload([float(v) for step in sched for v in step] or [0.0],
                      dev)
    table = _shift_table_on(dev)
    m = moving.positions.shape[1]
    use_skip = (not resident) and p.tile_skip
    xb = yb = md_xx = md_yy = None
    if use_skip:
        lo, hi = block_bounds(fixed_k.positions, fixed_k.mask, TILE_I)
        xb = torch.cat([lo, hi], dim=-1).contiguous()
        lo, hi = block_bounds(moving.positions, moving.mask, TILE_J)
        yb = torch.cat([lo, hi], dim=-1).contiguous()
        if adaptive:
            md_xx = _self_bounds(fixed_k).contiguous()
            md_yy = _self_bounds(moving).contiguous()
    opt = tuple(t for t in (xb, yb, md_xx, md_yy) if t is not None)
    clouds = tuple(t.contiguous() for t in (*fixed_k, *moving))
    phi = phi.contiguous()
    check_inputs("align_fused",
                 clouds + (phi, init, consts, sched_t) + opt, dev)

    scratch = {k: torch.empty((b,) + shape, dtype=dtype, device=dev)
               for k, (shape, dtype) in lane_scratch(n, m, mode,
                                                     adaptive).items()}
    # each lane's tickets start at zero; the kernel resets them as it goes
    scratch["ticket"].zero_()
    name = "align_fused_resident" if resident else "align_fused_tiled"
    launch = _build.entry(name + ("_timed" if timed else ""))

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = launch(
        *(t.data_ptr() for t in clouds), phi.data_ptr(), table.data_ptr(),
        ptr(xb), ptr(yb), ptr(md_xx), ptr(md_yy), consts.data_ptr(),
        init.data_ptr(),
        sched_t.data_ptr(), *(t.data_ptr() for t in scratch.values()),
        n, m, len(sched), int(adaptive), b,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(name, err)
    align_fused.launches += 1
    return scratch["out"]


align_fused.launches = 0


def phase_ns(reset=True):
    """[phase 1, phase 2, phase 3, tail, iterations]: the timed build's
    per-phase device time in ns, summed over the iterations of its
    launches since the last reset (block 0's view: each span ends at a
    grid barrier), and the iterations counted; `reset` zeroes them."""
    import ctypes

    out = (ctypes.c_ulonglong * 5)()
    err = _build.entry("align_fused_phase_ns")(ctypes.addressof(out),
                                                int(reset))
    _build.check("align_fused_phase_ns", err)
    return list(out)


ITEM_KINDS = ("moment", "skipped", "column", "counts", "row", "self")


def item_ns(reset=True):
    """({kind: (ns, items)}, [busy ns of each block]): the timed build's
    phase-1 work by item kind over all blocks, and each block's time in
    items, summed since the last reset; `reset` zeroes them."""
    import ctypes

    n = len(ITEM_KINDS)
    out = (ctypes.c_ulonglong * (2 * n + 4096))()
    err = _build.entry("align_fused_item_ns")(ctypes.addressof(out),
                                               int(reset))
    _build.check("align_fused_item_ns", err)
    kinds = {k: (out[i], out[n + i]) for i, k in enumerate(ITEM_KINDS)}
    return kinds, list(out[2 * n:])
