"""The host-side rules of the two sweeps on a lane axis, on the CPU.

`fused_wsq` (csrc/fused_wsq.cu) runs on a persistent grid whose size the
host picks (`ops.wsq.persistent_grid`) and whose blocks split the kept
tiles, laid end to end over the (lane, sweep) units, into contiguous
runs of ceil(kept / grid) on the card (`ops.wsq.block_runs` transcribes
the rule): a block takes a unit's ticket once a run, adding the run's
length, and the block that brings it to the unit's kept count sums the
unit's partials by tile id.  Each unit's kept count comes from a warp's
search of its sorted bounds in two rounds of loads (transcribed below);
`ops.wsq.kept_prefix` is its plain version, which the CPU tests hold
against JAX's skip rule (test_torch_batched_wsq.py).  The moment sweep
skips the weights of row groups beyond the gate (checked below on the
plain weights).  Both kernels' arithmetic is checked on the card
(test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from cvo_rgbd_torch.core import registration as treg
from cvo_rgbd_torch.core.cloud import stack_clouds
from cvo_rgbd_torch.ops import gram, moments, wsq
from cvo_rgbd_torch.params import AcvoParams

from test_torch_batched import _pair, _port

H100_SMS = 132


@pytest.mark.parametrize("swept,sms,want", [
    (2 * 1176, H100_SMS, H100_SMS * wsq.BLOCKS_PER_SM),   # one 3072 pair
    (126 * 21, H100_SMS, H100_SMS * wsq.BLOCKS_PER_SM),   # 63 x 384
    (3, H100_SMS, 3),                                      # a tiny launch
    (0, H100_SMS, 1),
    (10_000, 8, 8 * wsq.BLOCKS_PER_SM),
])
def test_persistent_grid(swept, sms, want):
    """A few blocks an SM, never more than the tiles swept, at least one."""
    assert wsq.persistent_grid(swept, sms) == want


def _flat_runs(kept, grid):
    """The split by its definition: every kept tile as (unit, k) in
    end-to-end order, cut into pieces of ceil(total / grid), each piece
    grouped into its units' runs."""
    flat = [(u, k) for u, n in enumerate(kept) for k in range(n)]
    per = -(-len(flat) // grid) if flat else 0
    out = []
    for b in range(grid):
        piece = flat[b * per:(b + 1) * per] if per else []
        runs = []
        for u, k in piece:
            if runs and runs[-1][0] == u:
                runs[-1][2] += 1
            else:
                runs.append([u, k, 1])
        out.append([tuple(r) for r in runs])
    return out


@pytest.mark.parametrize("kept,grid", [
    ([0, 0], 4),
    ([7, 0, 3], 528),             # one pair: a tile a block
    ([95, 101], 528),             # one pair's two sweeps at 3072
    ([110] * 18, 528),            # 9 lanes x 2 sweeps
    ([0, 5, 0, 900, 2], 7),       # a frozen lane, a long unit
    ([14] * 126, 528),            # 63 lanes at 384
    ([97, 120] * 108, 528),       # 9 lanes x 24 table sweeps
    ([3] * 2048, 100),            # MAX_UNITS units
])
def test_block_runs_is_the_end_to_end_split(kept, grid):
    """Every kept tile swept once, in its unit's order; a block's runs
    contiguous and ascending by unit; each unit's tickets adding up to
    its kept count, so that exactly one ticket closes it."""
    runs = wsq.block_runs(kept, grid)
    assert runs == _flat_runs(kept, grid)
    assert len(runs) == grid
    seen = {u: [] for u in range(len(kept))}
    for block in runs:
        units = [u for u, _, _ in block]
        assert units == sorted(set(units))
        for u, k0, n in block:
            assert n > 0
            seen[u].extend(range(k0, k0 + n))
    for u, n in enumerate(kept):
        assert seen[u] == list(range(n))
    total = sum(kept)
    per = -(-total // grid) if total else 0
    assert all(sum(n for _, _, n in block) <= per for block in runs)


def test_a_batch_splits_units_over_several_blocks():
    """At a batch's counts (9 lanes x 2 sweeps of ~110 kept tiles on the
    H100's grid) a unit's tiles fall in several blocks' runs, and a block
    sweeps the end of one unit and the start of the next: the ticket
    adds a run, not a tile."""
    kept = [110] * 18
    runs = wsq.block_runs(kept, wsq.persistent_grid(18 * 1176, H100_SMS))
    blocks_of = {}
    for b, block in enumerate(runs):
        for u, _, _ in block:
            blocks_of.setdefault(u, []).append(b)
    assert all(len(b) > 1 for b in blocks_of.values())
    assert any(len(block) > 1 for block in runs)
    # a ticket a run: fewer than one a tile
    tickets = sum(len(block) for block in runs)
    assert tickets < sum(kept)


def _kernel_search(srt, thr):
    """csrc/fused_wsq.cu kept_prefix, as a warp runs it: the first bound
    of each of 32 segments (one round of loads), then the bounds of the
    segment where the prefix ends (32 a round)."""
    n = srt.numel()
    seg = -(-n // 32)
    heads = [srt[lane * seg].item() if lane * seg < n else float("inf")
             for lane in range(32)]
    p = sum(h <= thr for h in heads)
    if p == 0:
        return 0
    base = (p - 1) * seg
    count = min(seg, n - base)
    k = base
    for t in range(count):
        k += int(srt[base + t].item() <= thr)
    return k


@pytest.mark.parametrize("n", [1, 21, 1176, 2080, 5000])
def test_the_kernels_search_is_the_plain_kept_prefix(n):
    """The kernel's search (segments past 32 bounds included: past 1024
    tiles) counts the sorted bounds at or below the threshold, as
    `wsq.kept_prefix` does, at every threshold from none kept to all."""
    rng = np.random.default_rng(n)
    srt = torch.tensor(np.sort(rng.random(n) * 4.0), dtype=torch.float32)
    srt[n - n // 7:] = float("inf")   # padding tiles: no bound
    for thr in [-1.0, *np.quantile(srt[torch.isfinite(srt)].numpy(),
                                   [0.0, 0.1, 0.5, 0.9, 1.0]), 5.0]:
        want = int((srt <= thr).sum())
        assert wsq.kept_prefix(srt, thr) == want
        assert _kernel_search(srt, float(thr)) == want


@pytest.mark.parametrize("ell", [0.1, 0.3])
def test_a_lane_batchs_units_and_grid(ell):
    """An exact acvo batch of 3 lanes at 1024 as the batched loop builds
    it: the kept counts the kernel finds (by each unit's search) are the
    plain version's tiles, the launch's grid the rule's, and the split
    covers them."""
    pairs = [_pair(70 + s, n=900, cap=1024) for s in range(3)]
    x = stack_clouds([_port(a) for a, _ in pairs])
    y = stack_clouds([_port(b) for _, b in pairs])
    p = AcvoParams()
    pre = treg.prepare_batch(p, x, y, [None] * 3)
    sweeps = treg._self_sweeps(x, tuple(y), pre.ck, pre.skip)
    scal = gram.scalars(torch.full((3,), ell), p)
    kept = []
    for b in range(3):
        thr = (scal[b, gram.S_D2_THRES] + moments.SKIP_MARGIN).item()
        for sw in sweeps:
            k = wsq.kept_prefix(sw.tiles.sorted[b], thr)
            assert k == _kernel_search(sw.tiles.sorted[b], thr)
            mask = wsq.kept_mask(wsq.TileOrder(*(t[b] for t in sw.tiles)),
                                 thr)
            assert k == int(torch.triu(mask).sum())
            kept.append(k)
    swept = 3 * sum(wsq._swept_tiles(sw) for sw in sweeps)
    grid = wsq.persistent_grid(swept, H100_SMS)
    assert grid == min(swept, H100_SMS * wsq.BLOCKS_PER_SM)
    runs = wsq.block_runs(kept, grid)
    assert sum(n for block in runs for _, _, n in block) == sum(kept) > 0


@pytest.mark.parametrize("mode", ["se ck", "se", "linear"])
@pytest.mark.parametrize("fast", [False, True])
def test_the_moment_sweeps_row_group_skip_is_exact(mode, fast):
    """csrc/fused_moments.cu skips the weights of a group of RG = 4 rows
    where every pair of the group and the warp's 32 j lies beyond the
    gate (d2 >= d2_thres; linear mode, which has no d2 gate, beyond
    d2_thres + SKIP_MARGIN, the tile skip's own margin): the plain
    weights there are all zero, in both exp forms, and the rule skips
    groups of kept tiles at the batches' ells."""
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.core.gram import pairwise_sqdist
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.params import MATLAB_PARAMS, CvoParams

    linear = mode == "linear"
    p = MATLAB_PARAMS if linear else CvoParams()
    a, b = _pair(90, n=900, cap=1024)
    x, y = kd_sort(_port(a)), kd_sort(_port(b))
    c0, xc, _ = build_moments_pre(x)
    yc = y.positions - c0
    rng = np.random.default_rng(3)
    ck = None
    if linear:
        ck = (torch.tensor(rng.random((1024, 1024)), dtype=torch.float32)
              * x.mask[:, None] * y.mask[None, :])
    elif mode == "se ck":
        ck = gram.color_gram(*x, *y, p=p)
    skipped = 0
    for ell in (0.15, 0.03):
        scal = gram.scalars(torch.tensor(ell), p)
        A = moments.pair_weights(xc, x.features, x.mask, yc, y.features,
                                 y.mask, scal, ck, linear, fast)
        d2 = pairwise_sqdist(xc, yc)
        thr = scal[gram.S_D2_THRES]
        near = d2 <= thr + moments.SKIP_MARGIN if linear else d2 < thr
        # groups of 4 rows x 32 j
        group_near = near.reshape(256, 4, 32, 32).any(dim=(1, 3))
        group_zero = (A != 0).reshape(256, 4, 32, 32).any(dim=(1, 3)) == 0
        assert bool(group_zero[~group_near].all())
        skipped += int((~group_near).sum())
    assert skipped > 0
