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
node), each sweep the bits of its own `fused_wsq` call.  Its sweeps may
carry a leading lane axis, the B pairs of the batched align loop
(`core/registration.make_batched_step`, JAX's vmap of the Pallas kernel
over `align_batched`'s lanes): every tensor of a sweep stacked [B, ...]
and one ell a lane (or a lane and a sweep), the S sweeps of the B lanes
in one launch, each (lane, sweep) the bits of the one-pair call, and a
lane that `live` marks False not swept (zeros).
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
# (lane, sweep) units a launch (csrc/fused_wsq.cu MAX_UNITS), and the
# int32 tickets a stream keeps for them
MAX_UNITS = 2048
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
    skip), and whether it is a self-pair swept by its upper triangle;
    on a lane axis every tensor stacked [B, ...]."""

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


def _check_sweep(x, y, ck, min_d2, symmetric, lead=()):
    """Raise unless the sweep is one pair's, or with `lead` = (B,) its B
    lanes' (that leading axis on every tensor)."""
    check_cloud("fused_wsq", *x, lanes=bool(lead))
    check_cloud("fused_wsq", *y, lanes=bool(lead))
    n, m = x[0].shape[-2], y[0].shape[-2]
    if x[0].shape[:-2] != lead or y[0].shape[:-2] != lead:
        raise ValueError(f"fused_wsq: every sweep's clouds take the lanes "
                         f"{tuple(lead)}, got {tuple(x[0].shape[:-2])} and "
                         f"{tuple(y[0].shape[:-2])}")
    if n % TILE_W or m % TILE_W:
        raise ValueError(
            f"fused_wsq: capacities must be multiples of {TILE_W}, got {n} "
            f"and {m}"
        )
    if symmetric and n != m:
        raise ValueError("fused_wsq: symmetric sweep requires a self-pair "
                         f"(n == m), got {n} and {m}")
    each = " a lane" if lead else ""
    if ck is not None and ck.shape != (*lead, n, m):
        raise ValueError(f"fused_wsq: ck must be [{n}, {m}]{each}")
    if isinstance(min_d2, TileOrder):
        md = min_d2.md
        if min_d2.order.shape[:-1] != lead:
            raise ValueError(f"fused_wsq: the tile order must be one{each}")
    else:
        md = min_d2
    if md is not None and md.shape != (*lead, n // TILE_W, m // TILE_W):
        raise ValueError(
            f"fused_wsq: min_d2 must be [{n // TILE_W}, {m // TILE_W}]{each}"
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


def lane_sweep(sw, b):
    """Lane `b` of a Sweep on a lane axis."""
    tiles = None if sw.tiles is None else TileOrder(*(t[b] for t in sw.tiles))
    return Sweep(tuple(t[b] for t in sw.x), tuple(t[b] for t in sw.y),
                 None if sw.ck is None else sw.ck[b], tiles, sw.symmetric)


def fused_wsq_sweeps_plain(sweeps, scal, fast=False, live=None):
    """The plain version of a launch of S sweeps: (wsq, nnz) [S] or, on a
    lane axis, [B, S], each (lane, sweep) `fused_wsq_plain` with its
    scalar row (`scal` [8] or [S, 8], a lane's [B, 8] or [B, S, 8]);
    zeros for a lane that `live` marks False."""
    lead = sweeps[0].x[0].shape[:-2]
    if lead:
        outs = []
        for b in range(lead[0]):
            if live is not None and not bool(live[b]):
                z = sweeps[0].x[0].new_zeros((len(sweeps),))
                outs.append((z, z))
            else:
                outs.append(fused_wsq_sweeps_plain(
                    [lane_sweep(sw, b) for sw in sweeps], scal[b], fast))
        return (torch.stack([w for w, _ in outs]),
                torch.stack([n for _, n in outs]))
    outs = [fused_wsq_plain(*sw.x, *sw.y, scal if scal.dim() == 1
                            else scal[k], sw.ck, sw.tiles, fast)
            for k, sw in enumerate(sweeps)]
    return (torch.stack([w for w, _ in outs]),
            torch.stack([n for _, n in outs]))


def fused_wsq_sweeps(sweeps, ell, *, p, live=None):
    """(wsq [S], nnz [S]) of S sweeps in one launch on the card, each
    entry the bits of `fused_wsq` on that sweep alone.  `ell` a 0-dim
    tensor that every sweep takes, or one ell a sweep ([S]).

    On a lane axis (every tensor of every sweep stacked [B, ...]) the
    B lanes' S sweeps in one launch: `ell` one a lane ([B]) or one a
    lane and a sweep ([B, S]), `live` an optional [B] bool (a False lane
    is not swept and gets zeros), and (wsq, nnz) [B, S]."""
    lead = sweeps[0].x[0].shape[:-2]
    for sw in sweeps:
        _check_sweep(sw.x, sw.y, sw.ck, sw.tiles, sw.symmetric, lead)
    if tuple(ell.shape) not in ((*lead,), (*lead, len(sweeps))):
        raise ValueError(f"fused_wsq: ell must be one a lane, or one a "
                         f"lane and a sweep, got {tuple(ell.shape)}")
    if live is not None and (not lead or live.shape != lead
                             or live.dtype != torch.bool):
        raise ValueError("fused_wsq: live must be a bool flag a lane")
    scal = scalars(ell, p)
    if sweeps[0].x[0].device.type == "cpu":
        return fused_wsq_sweeps_plain(sweeps, scal, fast_exp(p), live)
    return fused_wsq_sweeps_cuda(sweeps, scal, fast_exp(p), live)


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
        "md_sorted", "md_by_id")]
        + [(k, ctypes.c_int) for k in (
            "n", "m", "symmetric", "n_tiles", "part0")])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _swept_tiles(sw):
    """The tiles a sweep launches: the upper triangle when symmetric."""
    nb_i, nb_j = sw.x[0].shape[-2] // TILE_W, sw.y[0].shape[-2] // TILE_W
    return nb_i * (nb_i + 1) // 2 if sw.symmetric else nb_i * nb_j


def fused_wsq_sweeps_cuda(sweeps, scal, fast=False, live=None):
    """Launch csrc/fused_wsq.cu on CUDA tensors for S sweeps (shapes
    checked by `fused_wsq_sweeps`), of one pair or of B lanes: one
    launch for every MAX_SWEEPS sweeps of at most MAX_UNITS // S lanes,
    each counted in `fused_wsq.launches`.  `scal` one [8] row for every
    sweep or [S, 8], on a lane axis [B, 8] or [B, S, 8]; `live` [B] bool
    or None (every lane swept).  Every sweep has a color cache, or none
    has.  `fast` launches the hardware-exp form (exp_mode="fast")."""
    dev = sweeps[0].x[0].device
    lead = sweeps[0].x[0].shape[:-2]
    b = lead[0] if lead else 1
    s_all = len(sweeps)
    use_ck = sweeps[0].ck is not None
    if any((sw.ck is not None) != use_ck for sw in sweeps):
        raise ValueError("fused_wsq: every sweep of a launch has a color "
                         "cache, or none has")
    per_sweep = scal.dim() == len(lead) + 2
    if scal.shape != (*lead, *((s_all,) if per_sweep else ()), 8):
        raise ValueError(f"fused_wsq: scal must be [8] or [{s_all}, 8]"
                         f"{' a lane' if lead else ''}")
    if live is not None and (live.device != dev or live.dtype != torch.bool
                             or live.shape != (b,)
                             or not live.is_contiguous()):
        raise ValueError(f"fused_wsq: live must be a contiguous [{b}] bool "
                         f"tensor on {dev}")
    check_inputs("fused_wsq", (scal,), dev)
    for sw in sweeps:
        t = sw.tiles
        opt = () if t is None else (t.by_id, t.sorted)
        opt += () if sw.ck is None else (sw.ck,)
        check_inputs("fused_wsq", (*sw.x, *sw.y) + opt, dev)
        if t is not None and (t.order.device != dev
                              or t.order.dtype != torch.int32
                              or not t.order.is_contiguous()):
            raise ValueError("fused_wsq: the tile order must be contiguous "
                             f"int32 on {dev}")
    tiles = [_swept_tiles(sw) for sw in sweeps]
    part_ls = sum(tiles)
    part = torch.empty((b, part_ls), dtype=torch.float32, device=dev)
    cnt = torch.empty((b, part_ls), dtype=torch.int32, device=dev)
    out = torch.empty((b, s_all, 2), dtype=torch.float32, device=dev)
    tickets, stream = stream_tickets(dev, MAX_UNITS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launch = _build.entry("fused_wsq")
    # one pair: a lane axis of one
    scal = scal.reshape(b, -1)
    scal_ls = scal.shape[1]
    part0 = [sum(tiles[:s]) for s in range(s_all)]
    for s0 in range(0, s_all, MAX_SWEEPS):
        chunk = range(s0, min(s0 + MAX_SWEEPS, s_all))
        lanes_per = MAX_UNITS // len(chunk)
        for b0 in range(0, b, lanes_per):
            nb = min(lanes_per, b - b0)

            def at(t):
                """lane b0's slice of a sweep tensor (one pair: itself)."""
                return t[b0] if lead else t

            args = (_SweepArgs * len(chunk))()
            for k, s in enumerate(chunk):
                sw = sweeps[s]
                order = sorted_md = by_id = None
                if sw.tiles is not None:
                    order, sorted_md, by_id = (at(sw.tiles.order),
                                               at(sw.tiles.sorted),
                                               at(sw.tiles.by_id))
                row = scal[b0, 8 * s if per_sweep else 0:]
                args[k] = _SweepArgs(
                    *(at(c).data_ptr() for c in (*sw.x, *sw.y)),
                    _ptr(None if sw.ck is None else at(sw.ck)),
                    row.data_ptr(), _ptr(order), _ptr(sorted_md),
                    _ptr(by_id), sw.x[0].shape[-2], sw.y[0].shape[-2],
                    int(sw.symmetric), tiles[s], part0[s])
            blocks = min(nb * sum(tiles[s] for s in chunk),
                         sms * BLOCKS_PER_SM)
            err = launch(ctypes.addressof(args), len(chunk), nb,
                         _ptr(None if live is None else live[b0]), scal_ls,
                         part[b0].data_ptr(), cnt[b0].data_ptr(), part_ls,
                         tickets.data_ptr(), out[b0, s0].data_ptr(),
                         2 * s_all, int(use_ck), int(fast), blocks, stream)
            _build.check("fused_wsq", err)
            fused_wsq.launches += 1
    if not lead:
        out = out[0]
    return out[..., 0], out[..., 1]


fused_wsq.launches = 0
