"""The self-sweep's launch shape: the once-per-align tile order, the
kept prefix, several sweeps a launch, and the acvo call sites that use
them (plain versions on the CPU; the kernel's bits are held on the card
in test_torch_cuda.py).

Clouds are the rendered acvo pair of `torch_scenes` (capacity 512) and
seeded random clouds, kd-sorted as the kernel backend sweeps them or in
their random order.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import cvo_rgbd_torch as ct
from cvo_rgbd_torch import pad_cloud
from cvo_rgbd_torch.convert import params_from_jax_dict
from cvo_rgbd_torch.core import cloud as tcloud
from cvo_rgbd_torch.core import registration as treg
from cvo_rgbd_torch.ops import gram, wsq
from cvo_rgbd_tpu.core import registration as jreg
from cvo_rgbd_tpu.core.cloud import PointCloud as JCloud
from cvo_rgbd_tpu.params import AcvoParams as JA

from torch_scenes import rendered_acvo_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def clouds():
    """The rendered acvo pair, kd-sorted, with each cloud's self-bounds."""
    out = []
    for c in map(tcloud.kd_sort, rendered_acvo_pair()):
        lo, hi = tcloud.block_bounds(c.positions, c.mask, wsq.TILE_W)
        out.append((c, tcloud.aabb_min_d2(lo, hi, lo, hi)))
    return out


def _random_cloud(seed, n=640, cap=768, sort=True):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)) * np.array([2.0, 1.5, 1.0]) + np.array(
        [-1.0, -0.7, 1.0])
    feat = rng.random((n, 5))
    c = pad_cloud(pos, feat, cap, device="cpu")
    return tcloud.kd_sort(c) if sort else c


def _thr(ell, p):
    scal = gram.scalars(torch.tensor(ell, dtype=torch.float32), p)
    return scal[gram.S_D2_THRES] + wsq.SKIP_MARGIN


@pytest.mark.parametrize("symmetric", [True, False])
def test_tile_order_covers_each_swept_tile_once(clouds, symmetric):
    (x, md), _ = clouds
    t = wsq.tile_order(md, symmetric)
    nb = md.shape[0]
    if symmetric:
        iu = torch.triu_indices(nb, nb)
        assert torch.equal(t.by_id, md[iu[0], iu[1]])
        assert t.by_id.numel() == nb * (nb + 1) // 2
    else:
        assert torch.equal(t.by_id, md.reshape(-1))
    assert t.order.dtype == torch.int32
    assert torch.equal(torch.sort(t.order.long()).values,
                       torch.arange(t.by_id.numel()))
    assert torch.equal(t.sorted, t.by_id[t.order.long()])
    assert bool((t.sorted[1:] >= t.sorted[:-1]).all())
    # ties in id order: the order follows from the data alone
    ties = t.sorted[1:] == t.sorted[:-1]
    assert bool((t.order[1:][ties] > t.order[:-1][ties]).all())
    assert int(ties.sum()) > 0   # the diagonal band: many zero bounds


@settings(max_examples=25, deadline=None, database=None)
@given(seed=st.integers(0, 2**16), ell=st.floats(0.005, 0.6),
       sort=st.booleans(), symmetric=st.booleans())
def test_kept_tiles_are_a_prefix_of_the_order(seed, ell, sort, symmetric):
    c = _random_cloud(seed, sort=sort)
    lo, hi = tcloud.block_bounds(c.positions, c.mask, wsq.TILE_W)
    md = tcloud.aabb_min_d2(lo, hi, lo, hi)
    t = wsq.tile_order(md, symmetric)
    thr = _thr(ell, ct.AcvoParams())
    rule = t.by_id <= thr
    k = wsq.kept_prefix(t.sorted, thr)
    assert k == int(rule.sum())
    assert bool(rule[t.order[:k].long()].all())
    assert torch.equal(wsq.kept_mask(t, thr), md <= thr)


def test_kept_prefix_at_the_extremes(clouds):
    (_, md), _ = clouds
    t = wsq.tile_order(md, True)
    n = t.by_id.numel()
    assert wsq.kept_prefix(t.sorted, torch.tensor(-1.0)) == 0
    # an all-invalid tile's bound is +inf: kept only at an infinite one
    assert wsq.kept_prefix(t.sorted, torch.tensor(float("inf"))) == n
    assert wsq.kept_prefix(t.sorted, torch.tensor(1e30)) == int(
        torch.isfinite(t.by_id).sum()) < n
    # every length from 0 to n, at thresholds between the sorted bounds
    for k in range(n + 1):
        thr = t.sorted[k - 1] if k else t.sorted[0] - 1.0
        assert wsq.kept_prefix(t.sorted, thr) == int((t.sorted <= thr).sum())


def test_scalar_rows_of_many_ells_are_each_ells_bits():
    p = ct.AcvoParams()
    ells = torch.tensor([0.0391, 0.05, 0.1, 0.15, 0.0723], dtype=torch.float32)
    rows = gram.scalars(ells, p)
    assert rows.shape == (5, 8)
    for k in range(5):
        assert torch.equal(rows[k], gram.scalars(ells[k], p))


@pytest.mark.parametrize("use_ck", [True, False])
@pytest.mark.parametrize("use_skip", [True, False])
def test_sweeps_return_each_sweeps_fused_wsq(clouds, use_ck, use_skip):
    p = ct.AcvoParams()
    sweeps, singles = [], []
    for c, md in clouds:
        ck = gram.color_gram(*c, *c, p=p) if use_ck else None
        tiles = wsq.tile_order(md, True) if use_skip else None
        sweeps.append(wsq.Sweep(tuple(c), tuple(c), ck, tiles, True))
        singles.append((c, ck, md if use_skip else None))
    # S = 2 at one ell, and both clouds at three ells, an ell a sweep
    ell = torch.tensor(p.ell_min)
    w, nz = wsq.fused_wsq_sweeps(sweeps, ell, p=p)
    for k, (c, ck, md) in enumerate(singles):
        w1, n1 = wsq.fused_wsq(*c, *c, ell, ck, md, p=p, symmetric=True)
        assert torch.equal(w[k], w1) and torch.equal(nz[k], n1)
        assert float(n1) > 0
    ells = torch.tensor([0.1, 0.1, 0.06, 0.06, 0.0391, 0.0391])
    w, nz = wsq.fused_wsq_sweeps(sweeps * 3, ells, p=p)
    for k in range(6):
        c, ck, md = singles[k % 2]
        w1, n1 = wsq.fused_wsq(*c, *c, ells[k], ck, md, p=p, symmetric=True)
        assert torch.equal(w[k], w1) and torch.equal(nz[k], n1)


def test_tile_order_and_bound_matrix_give_the_same_sweep(clouds):
    p = ct.AcvoParams()
    (c, md), _ = clouds
    for ell in (p.ell_init, p.ell_min):
        e = torch.tensor(ell)
        for sym in (True, False):
            a = wsq.fused_wsq(*c, *c, e, None, md, p=p, symmetric=sym)
            b = wsq.fused_wsq(*c, *c, e, None, wsq.tile_order(md, sym), p=p,
                              symmetric=sym)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_cheb_tables_are_the_per_node_sweeps(clouds):
    """The tables' one launch of 2K sweeps gives the bits of a pair of
    fused_wsq calls at each node."""
    p = ct.AcvoParams(self_mode="cheb", self_cheb_k=5)
    (x, _), (y, _) = clouds
    pre = treg.prepare(p, x, y)
    logv = pre.cheb[0]
    # the nodes as the tables place them, in float64
    lo = np.log(1.0 / (2.0 * p.ell_max_init ** 2))
    hi = np.log(1.0 / (2.0 * p.ell_min ** 2))
    xch = torch.cos(np.pi * (torch.arange(5, dtype=torch.float64) + 0.5) / 5)
    t_nodes = 0.5 * (lo + hi) + 0.5 * (hi - lo) * xch
    _, ck_xx, ck_yy = pre.ck
    _, _, t_xx, t_yy = pre.skip
    nodes = 1.0 / torch.sqrt(2.0 * torch.exp(t_nodes))
    for k, e in enumerate(nodes.tolist()):
        ell = torch.tensor(e, dtype=torch.float32)
        wxx, nxx = wsq.fused_wsq(*x, *x, ell, ck_xx, t_xx, p=p, symmetric=True)
        wyy, nyy = wsq.fused_wsq(*y, *y, ell, ck_yy, t_yy, p=p, symmetric=True)
        want = torch.log(torch.clamp_min(torch.stack([wxx, nxx, wyy, nyy]),
                                         1e-30))
        assert torch.equal(logv[:, k], want)


@pytest.mark.parametrize("self_mode", ["exact", "cheb"])
def test_acvo_align_through_the_sweeps_matches_jax(self_mode):
    """Three iterations of acvo on the kernel backend (both self-sweeps
    in one call, or the tables in one call) against the JAX package's
    Pallas backend, op by op: ell and tf."""
    tx, ty = rendered_acvo_pair()
    jx, jy = (JCloud(*(np.asarray(a) for a in c)) for c in (tx, ty))
    jp = JA(backend="pallas", self_mode=self_mode, max_iter=3)
    ref = jreg.align(jp, jx, jy)
    got = ct.align(params_from_jax_dict(dataclasses.asdict(jp)), tx, ty,
                   device="cpu")
    assert int(got.iterations) == int(ref.iterations) == 2
    np.testing.assert_allclose(float(got.ell), float(ref.ell), rtol=1e-4)
    np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf), atol=3e-4)
