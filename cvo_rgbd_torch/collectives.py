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
pinned host memory, for every collective alike.

Each collective call is one exchange (`exchange`): the flat buffers of
its payload, one a dtype, through the transport.  Under CUDA graph
capture the two transports differ (`core/compiled.py`):

- NCCL's calls are captured with the graph around them: a replay runs
  them on the card.
- gloo's staged calls cannot be captured.  A capture of a gloo mesh
  step runs it under `cutting(cut)`: each exchange hands its flat
  inputs to `cut`, which ends the graph segment that wrote them and
  returns static output buffers of the exchange's result, which the
  next segment is captured reading.  At replay `exchange(..., outs)`
  runs the transport between the segments, into those buffers.

`STATS` counts the transport's calls (one a flat buffer) and the
exchanges' host seconds (staging included) since `reset_stats`; a
captured NCCL call counts at each replay, as the kernel wrappers'
launches do.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

STATS = {"calls": 0, "seconds": 0.0}
# the cut of the segmented capture that is recording, if one is
_CUT = []


def reset_stats():
    STATS.update(calls=0, seconds=0.0)


def backend(axis) -> str:
    return dist.get_backend(axis.group)


def capturable(axis) -> bool:
    """Whether a CUDA graph can hold the collectives of `axis`: NCCL's
    calls on the card, not gloo's staged ones."""
    return backend(axis) == "nccl"


@contextlib.contextmanager
def cutting(cut):
    """Route every exchange made inside to `cut(kind, flats, axis) ->
    outs` (a segmented capture's cut) instead of the transport."""
    _CUT.append(cut)
    try:
        yield
    finally:
        _CUT.pop()


def _staged(t, group) -> bool:
    return t.is_cuda and dist.get_backend(group) != "nccl"


def _host(t):
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def result_like(kind, flat, axis):
    """An empty buffer for the result of exchange `kind` of `flat`."""
    n = flat.numel() * (axis.size if kind == "all_gather" else 1)
    return flat.new_empty((n,))


def _transport(kind, flat, axis, out):
    """One flat buffer through collective `kind`; the result, written
    into `out` when given."""
    group = axis.group
    src = _host(flat) if _staged(flat, group) else flat
    if kind == "psum":
        dist.all_reduce(src, group=group)
        got = src
    elif kind == "broadcast":
        dist.broadcast(src, axis.ranks[0], group=group)
        got = src
    elif kind == "all_gather" and backend(axis) == "nccl":
        # one flat output: no copies out of NCCL's buffer under capture
        got = src.new_empty((axis.size * src.numel(),))
        dist.all_gather_into_tensor(got, src, group=group)
    elif kind == "all_gather":
        bufs = [torch.empty_like(src) for _ in range(axis.size)]
        dist.all_gather(bufs, src, group=group)
        got = torch.cat(bufs)
    else:
        got = torch.empty_like(src)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src,
                       axis.ranks[(axis.index + 1) % axis.size], group),
            dist.P2POp(dist.irecv, got,
                       axis.ranks[(axis.index - 1) % axis.size], group)])
        for r in reqs:
            r.wait()
    if out is not None:
        return out.copy_(got)
    return got.to(flat.device)


def exchange(kind, flats, axis, outs=None):
    """Collective `kind` ("psum", "all_gather", "ppermute" or
    "broadcast") of the flat buffers `flats` over `axis`: their results,
    written into `outs` when given (a segmented capture's replay).
    Inside `cutting`, the cut's static buffers instead."""
    if _CUT and outs is None:
        return _CUT[-1](kind, flats, axis)
    t0 = time.perf_counter()
    got = [_transport(kind, f, axis, None if outs is None else o)
           for f, o in zip(flats, outs or [None] * len(flats))]
    STATS["calls"] += len(flats)
    STATS["seconds"] += time.perf_counter() - t0
    return got


def _pack(tensors):
    """([flat buffer a dtype], [[positions in `tensors`] a dtype])."""
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    idx = list(by_dtype.values())
    return [torch.cat([tensors[i].reshape(-1) for i in ix])
            for ix in idx], idx


def _unpack(flats, idx, tensors):
    out = [None] * len(tensors)
    for flat, ix in zip(flats, idx):
        pieces = flat.split([tensors[i].numel() for i in ix])
        for i, piece in zip(ix, pieces):
            out[i] = piece.reshape(tensors[i].shape)
    return out


def _packed(kind, tensors, axis):
    ts = tuple(tensors)
    flats, idx = _pack(ts)
    return tuple(_unpack(exchange(kind, flats, axis), idx, ts))


def psum(tensors, axis):
    """Sum a tensor, or each of a tuple of tensors, over the ranks of
    `axis`; one all_reduce for each dtype among them."""
    if isinstance(tensors, torch.Tensor):
        return _packed("psum", (tensors,), axis)[0]
    return _packed("psum", tensors, axis)


def all_gather(t, axis):
    """The ranks' `t` in axis order, concatenated on dim 0."""
    t = t.contiguous()
    (got,) = exchange("all_gather", [t.reshape(-1)], axis)
    return got.reshape((axis.size * t.shape[0],) + t.shape[1:])


def ppermute(tensors, axis):
    """Each rank's tuple of tensors, sent one step on around the ring of
    `axis` (i -> i+1); returns the tuple received from the rank one step
    back.  The identity on an axis of one rank."""
    if axis.size == 1:
        return tuple(tensors)
    return _packed("ppermute", tensors, axis)


def broadcast(tensors, axis):
    """The tuple of tensors of the axis's first rank, on every rank of
    it.  The identity on an axis of one rank."""
    if axis.size == 1:
        return tuple(tensors)
    return _packed("broadcast", tensors, axis)
