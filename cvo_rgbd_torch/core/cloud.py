"""PointCloud: static-capacity, mask-padded colored point clouds.

Port of the JAX package's `core/cloud.py` plus the tile-bound helpers of
the JAX package's `ops/pallas_gram.py:328-355`.  Clouds are padded to a
multiple of 128 points with an explicit validity mask; every kernel
treats `mask == 0` rows as nonexistent.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from cvo_rgbd_torch.device import resolve_device

NUM_FEATURES = 5  # [c0, c1, c2, dx, dy] (data_type.h:26)
LANE = 128        # capacities are multiples of this (kd_sort cells)


class PointCloud(NamedTuple):
    """positions [N,3] f32, features [N,F] f32, mask [N] f32 (1=valid)."""

    positions: torch.Tensor
    features: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.positions.shape[-2]

    def num_valid(self):
        return torch.sum(self.mask, dim=-1)

    def to(self, device) -> "PointCloud":
        return PointCloud(*(t.to(device) for t in self))

    def lane(self, i: int) -> "PointCloud":
        """Lane `i` of a stacked cloud."""
        return PointCloud(*(t[i] for t in self))


def round_up(n: int, m: int = LANE) -> int:
    return ((n + m - 1) // m) * m


def stack_clouds(clouds, repeat: int = 1) -> PointCloud:
    """Stack equal-capacity PointClouds into a leading lane axis,
    tiling the list `repeat` times: the input of
    `parallel.align_batched` (the JAX package's core/cloud.py:41-60)."""
    clouds = list(clouds) * repeat
    return PointCloud(*(torch.stack([getattr(c, f) for c in clouds])
                        for f in PointCloud._fields))


def pad_cloud(positions, features=None, capacity: int | None = None,
              device=None) -> PointCloud:
    """Build a mask-padded PointCloud from ragged host arrays, on the
    card unless `device` says otherwise."""
    dev = resolve_device(device)
    positions = np.asarray(positions, dtype=np.float32)
    n = positions.shape[0]
    if features is None:
        features = np.zeros((n, NUM_FEATURES), dtype=np.float32)
    features = np.asarray(features, dtype=np.float32)
    cap = capacity if capacity is not None else round_up(max(n, 1))
    if n > cap:
        raise ValueError(f"cloud with {n} points exceeds capacity {cap}")
    pos = np.zeros((cap, 3), np.float32)
    feat = np.zeros((cap, features.shape[1]), np.float32)
    mask = np.zeros((cap,), np.float32)
    pos[:n] = positions
    feat[:n] = features
    mask[:n] = 1.0
    return PointCloud(*(torch.from_numpy(a).to(dev) for a in (pos, feat, mask)))


def transform_cloud(R, t, positions):
    """Apply SE(3) to positions [N,3] (cvo.cpp:310-315), full fp32."""
    return positions @ R.transpose(-1, -2) + t[..., None, :]


def cloud_ok(cloud: PointCloud, min_valid: int = 64):
    """Input-sanity flag: enough valid points AND finite positions in the
    valid slots — the driver-level failure detector behind
    skip-and-mark (rgbddataset_rkhs.m:49-81).  A 0-dim bool tensor,
    computed where the cloud lives."""
    valid = cloud.mask > 0
    n = torch.sum(valid, dim=-1)
    fin = torch.all(
        torch.isfinite(cloud.positions) | ~valid[..., None], dim=-1
    ).all(dim=-1)
    return (n >= min_valid) & fin


@functools.lru_cache(maxsize=None)
def _kd_levels(n: int, cell: int, device: torch.device):
    """The median splits of `kd_sort` at capacity n, level by level: per
    level, the segment of each slot [n] and which segments split [nseg],
    on `device` (the segment layout depends on n alone, never on the
    points; kept on the device, so a sort uploads nothing)."""
    segs = [(0, n)]
    levels = []
    while any(size > cell for _, size in segs):
        seg_of = np.repeat(np.arange(len(segs)), [size for _, size in segs])
        splits = np.array([size > cell for _, size in segs])
        levels.append((torch.from_numpy(seg_of).to(device),
                       torch.from_numpy(splits).to(device)))
        new_segs = []
        for start, size in segs:
            if size <= cell:
                new_segs.append((start, size))
                continue
            ncells = size // cell
            left = (ncells // 2 + ncells % 2) * cell
            new_segs += [(start, left), (start + left, size - left)]
        segs = new_segs
    return levels


def kd_sort(cloud: PointCloud, cell: int = 128) -> PointCloud:
    """Reorder points by recursive median splits (balanced kd-cells).

    Gives the same permutation as the JAX package: each split sorts a
    segment along its widest valid extent (first maximum on ties) with a
    stable sort, invalid slots keyed +inf so they sort to the end, and
    divides it at a cell-aligned median.  The kernels' fp32 sums follow
    point order, and compact tiles are what the AABB skip prunes.

    A cloud with a leading lane axis ([B, N, ...], `stack_clouds`) is
    sorted lane by lane, each lane as the single-cloud call sorts it.
    Every segment of a level is split at once: the extents by a scatter
    over segment ids, then one stable sort by key and one stable sort by
    segment, which together order each segment by key and keep ties in
    their order.  A segment that does not split is keyed 0, so it keeps
    its order.  That is ~12 launches a level, whatever the lanes."""
    pos, feat, mask = cloud
    n = pos.shape[-2]
    if n % cell:
        raise ValueError(f"capacity {n} must be a multiple of {cell}")
    lead = pos.shape[:-2]
    dev = pos.device
    pos = pos.reshape(-1, n, 3)
    valid = mask.reshape(-1, n) > 0
    b = pos.shape[0]
    big = 3.4e38
    order = torch.arange(n, device=dev).expand(b, n)
    for seg, splits in _kd_levels(n, cell, dev):
        nseg = splits.shape[0]
        p = torch.gather(pos, 1, order[..., None].expand(b, n, 3))
        v = torch.gather(valid, 1, order)[..., None]
        idx = seg[None, :, None].expand(b, n, 3)
        lo = pos.new_full((b, nseg, 3), big).scatter_reduce(
            1, idx, torch.where(v, p, big), "amin")
        hi = pos.new_full((b, nseg, 3), -big).scatter_reduce(
            1, idx, torch.where(v, p, -big), "amax")
        dim = torch.argmax(hi - lo, dim=-1)
        key = torch.gather(p, 2, dim[:, seg, None])[..., 0]
        key = torch.where(v[..., 0], key, float("inf"))
        key = torch.where(splits[seg], key, 0.0)
        by_key = torch.argsort(key, dim=-1, stable=True)
        by_seg = torch.argsort(seg[by_key], dim=-1, stable=True)
        order = torch.gather(order, 1, torch.gather(by_key, 1, by_seg))
    return PointCloud(
        torch.gather(pos, 1, order[..., None].expand(b, n, 3)).reshape(
            *lead, n, 3),
        torch.gather(feat.reshape(b, n, -1), 1, order[..., None].expand(
            b, n, feat.shape[-1])).reshape(*lead, n, feat.shape[-1]),
        torch.gather(mask.reshape(b, n), 1, order).reshape(*lead, n),
    )


def block_bounds(pos, mask, tile: int):
    """Per-tile AABBs of the valid points: [..., nb, 3] lo and hi (a
    leading lane axis passes through).  An all-invalid tile gets
    lo=+inf / hi=-inf, so every bound against it is +inf and it is
    always skipped."""
    nb = pos.shape[-2] // tile
    p = pos.reshape(*pos.shape[:-2], nb, tile, 3)
    valid = (mask.reshape(*mask.shape[:-1], nb, tile) > 0)[..., None]
    lo = torch.where(valid, p, float("inf")).amin(dim=-2)
    hi = torch.where(valid, p, float("-inf")).amax(dim=-2)
    return lo, hi


def aabb_min_d2(lo_x, hi_x, lo_y, hi_y):
    """[..., nbx, nby] lower bounds on the squared distance between any
    point of x-tile i and any point of y-tile j.  min_d2[i, j] > d2_thres
    means every pair in the tile fails the position gate
    (cvo.cpp:119-125), so skipping the tile changes no computed bit."""
    gap1 = lo_y[..., None, :, :] - hi_x[..., :, None, :]
    gap2 = lo_x[..., :, None, :] - hi_y[..., None, :, :]
    gap = torch.clamp_min(torch.maximum(gap1, gap2), 0.0)
    return torch.sum(gap * gap, dim=-1)
