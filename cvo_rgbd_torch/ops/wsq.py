"""The lean self-kernel sweep of adaptive CVO.

`fused_wsq` replaces the JAX package's `ops/pallas_moments.py:fused_wsq`:

    wsq = sum_ij A_ij |x_i - y_j|^2      nnz = #{A_ij > 0}

the only two quantities the adaptive length-scale step dl needs from the
self-kernels Axx and Ayy (adaptive_cvo.cpp:222-271).  On a CUDA tensor
the wrapper launches the hand-written kernel `csrc/fused_wsq.cu` (or
raises); on a CPU tensor it runs `fused_wsq_plain`, the same function in
plain torch.

`symmetric=True` (x and y the same cloud) evaluates only the upper
triangle of TILE_W-square tiles on the card, off-diagonal tiles counted
twice; A is then exactly symmetric, so the result equals the full sweep
up to fp32 summation order (the plain version always sweeps in full).
The AABB tile skip is exact, and its bound matrix is built at TILE_W on
both sides (`core/cloud.block_bounds`).  The kernel takes the bounds as
a `TileOrder`: the swept tiles' ids sorted by their bound, so that the
tiles kept at any ell are a prefix of it (`kept_prefix`).  An align
builds it once (`core/registration.build_skip_pre`): a self-pair's
bounds do not move with the transform.

`fused_wsq_sweeps` runs several sweeps in one launch (acvo's exact
iteration: Axx and Ayy; the Chebyshev tables: both self-pairs at every
node), each sweep the bits of its own `fused_wsq` call.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cvo_rgbd_torch.core.gram import pairwise_sqdist
from cvo_rgbd_torch.ops import _build
from cvo_rgbd_torch.ops.gram import (
    S_D2_THRES,
    check_cloud,
    check_inputs,
    scalars,
    stream_tickets,
)
from cvo_rgbd_torch.ops.moments import SKIP_MARGIN, pair_weights
from cvo_rgbd_torch.params import fast_exp

TILE_W = 64   # square tile of the self-sweep (csrc/fused_wsq.cu TW)
MAX_SWEEPS = 32   # sweeps a launch (csrc/fused_wsq.cu MAX_SWEEPS)
# the kernel's persistent grid: blocks an SM (at most one a tile); 2, 4
# and 8 measured within 1 us of each other (PERF.md §6)
BLOCKS_PER_SM = 2


class TileOrder(NamedTuple):
    """The bounds of one sweep's tiles, in the kernel's two orders."""

    md: torch.Tensor         # [n / TILE_W, m / TILE_W] the bound matrix
    by_id: torch.Tensor      # [tiles] the swept tiles' bounds by tile id
    order: torch.Tensor      # [tiles] int32 tile ids, bound ascending
    sorted: torch.Tensor     # [tiles] the bounds in that order


class Sweep(NamedTuple):
    """One sweep of `fused_wsq_sweeps`: the pair's clouds as (positions,
    features, mask), its color cache or None, its TileOrder or None (no
    skip), and whether it is a self-pair swept by its upper triangle."""

    x: tuple
    y: tuple
    ck: torch.Tensor | None
    tiles: TileOrder | None
    symmetric: bool = False


def tile_order(md, symmetric=False) -> TileOrder:
    """The TileOrder of a bound matrix: the swept tiles (the upper
    triangle row by row when `symmetric`, else every tile row-major)
    numbered as the kernel numbers them, then sorted by bound, stably,
    so that ties keep id order and the order follows from the data
    alone."""
    if symmetric:
        nb = md.shape[0]
        iu = torch.triu_indices(nb, nb, device=md.device)
        by_id = md[iu[0], iu[1]]
    else:
        by_id = md.reshape(-1)
    by_id = by_id.to(torch.float32).contiguous()
    srt, order = torch.sort(by_id, stable=True)
    return TileOrder(md, by_id, order.to(torch.int32), srt.contiguous())


def kept_prefix(srt, thr):
    """How many tiles of a TileOrder's `sorted` bounds are kept at the
    skip threshold `thr` (d2_thres + SKIP_MARGIN): the kernel's search,
    in plain torch.  The first bound of each of 32 segments, then the
    segment where the kept run ends."""
    n = srt.numel()
    seg = -(-n // 32)
    heads = srt[0:n:seg]
    p = int((heads <= thr).sum())
    if p == 0:
        return 0
    base = (p - 1) * seg
    return base + int((srt[base:min(base + seg, n)] <= thr).sum())


def kept_mask(tiles: TileOrder, thr):
    """[n / TILE_W, m / TILE_W] bool of the tiles a TileOrder keeps at
    `thr`, by its prefix; with a symmetric order the lower triangle
    mirrors the upper."""
    k = kept_prefix(tiles.sorted, thr)
    ids = tiles.order[:k].long()
    keep = torch.zeros(tiles.by_id.shape, dtype=torch.bool,
                       device=tiles.md.device)
    keep[ids] = True
    nb_i, nb_j = tiles.md.shape
    if tiles.by_id.numel() == nb_i * nb_j:
        return keep.reshape(nb_i, nb_j)
    iu = torch.triu_indices(nb_i, nb_j, device=keep.device)
    full = torch.zeros((nb_i, nb_j), dtype=torch.bool, device=keep.device)
    full[iu[0], iu[1]] = keep
    return full | full.T


def fused_wsq_plain(xp, xf, xm, yp, yf, ym, scal, ck=None, min_d2=None,
                    fast=False):
    """Plain torch version of the kernel: the dense gated A, tiles the
    bound rules out set to zero, then sum(A * d2) and the nonzero count,
    over the full [N, M] sweep.  `min_d2` a bound matrix or a
    TileOrder (whose prefix keeps the same tiles)."""
    A = pair_weights(xp, xf, xm, yp, yf, ym, scal, ck, fast=fast)
    if min_d2 is not None:
        thr = scal[S_D2_THRES] + SKIP_MARGIN
        if isinstance(min_d2, TileOrder):
            keep = kept_mask(min_d2, thr)
        else:
            keep = min_d2 <= thr
        keep = keep.repeat_interleave(TILE_W, 0).repeat_interleave(TILE_W, 1)
        A = torch.where(keep, A, 0.0)
    wsq = torch.sum(A * pairwise_sqdist(xp, yp))
    return wsq, (A > 0).sum().to(torch.float32)


def _check_sweep(x, y, ck, min_d2, symmetric):
    check_cloud("fused_wsq", *x)
    check_cloud("fused_wsq", *y)
    n, m = x[0].shape[0], y[0].shape[0]
    if n % TILE_W or m % TILE_W:
        raise ValueError(
            f"fused_wsq: capacities must be multiples of {TILE_W}, got {n} "
            f"and {m}"
        )
    if symmetric and n != m:
        raise ValueError("fused_wsq: symmetric sweep requires a self-pair "
                         f"(n == m), got {n} and {m}")
    if ck is not None and ck.shape != (n, m):
        raise ValueError(f"fused_wsq: ck must be [{n}, {m}]")
    md = min_d2.md if isinstance(min_d2, TileOrder) else min_d2
    if md is not None and md.shape != (n // TILE_W, m // TILE_W):
        raise ValueError(
            f"fused_wsq: min_d2 must be [{n // TILE_W}, {m // TILE_W}]"
        )
    dev = x[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_wsq: unsupported device {dev}")


def fused_wsq(xp, xf, xm, yp, yf, ym, ell, ck=None, min_d2=None, *, p,
              symmetric=False):
    """Returns (wsq, nnz), both 0-dim f32 on the inputs' device.

    `ell` a 0-dim f32 tensor; `ck` the color_gram cache of the pair or
    None (recompute); `min_d2` [N/TILE_W, M/TILE_W] tile bounds, their
    TileOrder, or None (no skip).  `symmetric` requires a self-pair
    (n == m)."""
    _check_sweep((xp, xf, xm), (yp, yf, ym), ck, min_d2, symmetric)
    scal = scalars(ell, p)
    if xp.device.type == "cpu":
        return fused_wsq_plain(xp, xf, xm, yp, yf, ym, scal, ck, min_d2,
                               fast_exp(p))
    return fused_wsq_cuda(xp, xf, xm, yp, yf, ym, scal, ck, min_d2,
                          symmetric=symmetric, fast=fast_exp(p))


def fused_wsq_sweeps(sweeps, ell, *, p):
    """(wsq [S], nnz [S]) of S sweeps in one launch on the card, each
    entry the bits of `fused_wsq` on that sweep alone.  `ell` a 0-dim
    tensor that every sweep takes, or one ell a sweep ([S])."""
    for sw in sweeps:
        _check_sweep(sw.x, sw.y, sw.ck, sw.tiles, sw.symmetric)
    scal = scalars(ell, p)
    if sweeps[0].x[0].device.type == "cpu":
        outs = [fused_wsq_plain(*sw.x, *sw.y, scal if scal.dim() == 1
                                else scal[k], sw.ck, sw.tiles, fast_exp(p))
                for k, sw in enumerate(sweeps)]
        return (torch.stack([w for w, _ in outs]),
                torch.stack([n for _, n in outs]))
    return fused_wsq_sweeps_cuda(sweeps, scal, fast_exp(p))


def fused_wsq_cuda(xp, xf, xm, yp, yf, ym, scal, ck=None, min_d2=None, *,
                   symmetric=False, fast=False):
    """Launch csrc/fused_wsq.cu on CUDA tensors (shapes checked by
    `fused_wsq`) for one sweep; `min_d2` a bound matrix (sorted here)
    or its TileOrder.  Counts one launch in `fused_wsq.launches`."""
    tiles = min_d2
    if min_d2 is not None and not isinstance(min_d2, TileOrder):
        tiles = tile_order(min_d2, symmetric)
    w, n = fused_wsq_sweeps_cuda(
        [Sweep((xp, xf, xm), (yp, yf, ym), ck, tiles, symmetric)], scal,
        fast)
    return w[0], n[0]


class _SweepArgs(ctypes.Structure):
    """csrc/fused_wsq.cu struct WsqSweep."""

    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "xp", "xf", "xm", "yp", "yf", "ym", "ck", "scal", "order",
        "md_sorted", "md_by_id", "out")]
        + [(k, ctypes.c_int) for k in (
            "n", "m", "symmetric", "n_tiles", "part0")])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _swept_tiles(sw):
    """The tiles a sweep launches: the upper triangle when symmetric."""
    nb_i, nb_j = sw.x[0].shape[0] // TILE_W, sw.y[0].shape[0] // TILE_W
    return nb_i * (nb_i + 1) // 2 if sw.symmetric else nb_i * nb_j


def fused_wsq_sweeps_cuda(sweeps, scal, fast=False):
    """Launch csrc/fused_wsq.cu on CUDA tensors for S sweeps (shapes
    checked by `fused_wsq_sweeps`): one launch for every MAX_SWEEPS of
    them, each counted in `fused_wsq.launches`.  `scal` one [8] row for
    every sweep or [S, 8].  Every sweep has a color cache, or none
    has.  `fast` launches the hardware-exp form (exp_mode="fast")."""
    dev = sweeps[0].x[0].device
    use_ck = sweeps[0].ck is not None
    if any((sw.ck is not None) != use_ck for sw in sweeps):
        raise ValueError("fused_wsq: every sweep of a launch has a color "
                         "cache, or none has")
    if scal.dim() == 2 and scal.shape[0] != len(sweeps):
        raise ValueError(f"fused_wsq: scal must be [8] or [{len(sweeps)}, 8]")
    for sw in sweeps:
        t = sw.tiles
        opt = () if t is None else (t.by_id, t.sorted)
        opt += () if sw.ck is None else (sw.ck,)
        check_inputs("fused_wsq", (*sw.x, *sw.y, scal) + opt, dev)
        if t is not None and (t.order.device != dev
                              or t.order.dtype != torch.int32):
            raise ValueError("fused_wsq: the tile order must be int32 on "
                             f"{dev}")
    tiles = [_swept_tiles(sw) for sw in sweeps]
    part = torch.empty((sum(tiles),), dtype=torch.float32, device=dev)
    cnt = torch.empty((sum(tiles),), dtype=torch.int32, device=dev)
    out = torch.empty((len(sweeps), 2), dtype=torch.float32, device=dev)
    tickets, stream = stream_tickets(dev, MAX_SWEEPS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launch = _build.entry("fused_wsq")
    part0 = 0
    for s0 in range(0, len(sweeps), MAX_SWEEPS):
        chunk = sweeps[s0:s0 + MAX_SWEEPS]
        args = (_SweepArgs * len(chunk))()
        for k, sw in enumerate(chunk):
            s = s0 + k
            order = sorted_md = by_id = None
            if sw.tiles is not None:
                order, sorted_md = sw.tiles.order, sw.tiles.sorted
                by_id = sw.tiles.by_id
            row = scal if scal.dim() == 1 else scal[s]
            args[k] = _SweepArgs(
                *(c.data_ptr() for c in (*sw.x, *sw.y)), _ptr(sw.ck),
                row.data_ptr(), _ptr(order), _ptr(sorted_md), _ptr(by_id),
                out[s].data_ptr(), sw.x[0].shape[0], sw.y[0].shape[0],
                int(sw.symmetric), tiles[s], part0)
            part0 += tiles[s]
        blocks = min(sum(tiles[s0:s0 + MAX_SWEEPS]), sms * BLOCKS_PER_SM)
        err = launch(ctypes.addressof(args), len(chunk), part.data_ptr(),
                     cnt.data_ptr(), tickets.data_ptr(), int(use_ck),
                     int(fast), blocks, stream)
        _build.check("fused_wsq", err)
        fused_wsq.launches += 1
    return out[:, 0], out[:, 1]


fused_wsq.launches = 0
