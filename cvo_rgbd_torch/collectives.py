"""The collectives of the mesh paths: the port's `lax.psum`,
`lax.all_gather(tiled=True)` and `lax.ppermute` over one mesh axis
(`parallel.mesh.Axis`), and a broadcast from the axis's first rank.
Both `core` and `parallel` build on this module; it imports neither.

- `psum` sums a tuple of tensors in one `all_reduce` for each dtype
  among them: their flat concatenation, as JAX packs an iteration's
  partial sums into two psums (the JAX package's
  `parallel/sharded.py:296-309, 318-326`).
- `all_gather` concatenates the ranks' blocks in axis order.
- `ppermute` passes a tuple of tensors one step around the ring
  i -> i+1 of the axis, packed as `psum` packs them, with
  `batch_isend_irecv`.
- `broadcast` gives every rank of the axis its first rank's tuple,
  packed as `psum` packs them.

Every rank of the axis gets the same bits from a reduction.  gloo takes
CUDA tensors only for `all_reduce` and `broadcast`, and NCCL refuses two
ranks on one card; so on a gloo group a CUDA payload is staged through
pinned host memory, for every collective alike.  `STATS` counts the
calls and their host seconds (staging included) since `reset_stats`.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

STATS = {"calls": 0, "seconds": 0.0}


def reset_stats():
    STATS.update(calls=0, seconds=0.0)


def _staged(t, group) -> bool:
    return t.is_cuda and dist.get_backend(group) != "nccl"


def _host(t):
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    return out


def _pack(tensors):
    """{dtype: (flat buffer, [positions in `tensors`])}."""
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    return {dt: (torch.cat([tensors[i].reshape(-1) for i in idx]), idx)
            for dt, idx in by_dtype.items()}


def _unpack(packed, tensors):
    out = [None] * len(tensors)
    for flat, idx in packed.values():
        pieces = flat.split([tensors[i].numel() for i in idx])
        for i, piece in zip(idx, pieces):
            out[i] = piece.reshape(tensors[i].shape)
    return out


def _all_reduce(flat, group):
    def run():
        if not _staged(flat, group):
            dist.all_reduce(flat, group=group)
            return flat
        h = _host(flat)
        dist.all_reduce(h, group=group)
        return h.to(flat.device)
    return _timed(run)


def psum(tensors, axis):
    """Sum a tensor, or each of a tuple of tensors, over the ranks of
    `axis`; one all_reduce for each dtype among them."""
    single = isinstance(tensors, torch.Tensor)
    ts = (tensors,) if single else tuple(tensors)
    packed = {dt: (_all_reduce(flat, axis.group), idx)
              for dt, (flat, idx) in _pack(ts).items()}
    out = _unpack(packed, ts)
    return out[0] if single else tuple(out)


def all_gather(t, axis):
    """The ranks' `t` in axis order, concatenated on dim 0."""
    t = t.contiguous()

    def run():
        src = _host(t) if _staged(t, axis.group) else t
        bufs = [torch.empty_like(src) for _ in range(axis.size)]
        dist.all_gather(bufs, src, group=axis.group)
        return torch.cat(bufs).to(t.device)
    return _timed(run)


def ppermute(tensors, axis):
    """Each rank's tuple of tensors, sent one step on around the ring of
    `axis` (i -> i+1); returns the tuple received from the rank one step
    back.  The identity on an axis of one rank."""
    ts = tuple(tensors)
    if axis.size == 1:
        return ts
    dst = axis.ranks[(axis.index + 1) % axis.size]
    src = axis.ranks[(axis.index - 1) % axis.size]

    def run():
        got = {}
        for dt, (flat, idx) in _pack(ts).items():
            send = _host(flat) if _staged(flat, axis.group) else flat
            recv = torch.empty_like(send)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, dst, axis.group),
                dist.P2POp(dist.irecv, recv, src, axis.group)])
            for r in reqs:
                r.wait()
            got[dt] = (recv.to(flat.device), idx)
        return got
    return tuple(_unpack(_timed(run), ts))


def broadcast(tensors, axis):
    """The tuple of tensors of the axis's first rank, on every rank of
    it.  The identity on an axis of one rank."""
    ts = tuple(tensors)
    if axis.size == 1:
        return ts

    def run():
        got = {}
        for dt, (flat, idx) in _pack(ts).items():
            buf = _host(flat) if _staged(flat, axis.group) else flat
            dist.broadcast(buf, axis.ranks[0], group=axis.group)
            got[dt] = (buf.to(flat.device), idx)
        return got
    return tuple(_unpack(_timed(run), ts))
