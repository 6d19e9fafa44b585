"""`fused_wsq` on a lane axis on the CPU: adaptive CVO's self-sweeps of a
batch in one call, exact (both self-pairs of every lane an iteration) and
cheb (every lane's Chebyshev tables once a batch), and `align_batched` on
exact and cheb acvo through the batched loop.

JAX compiles `align_batched` on "pallas" as jit(vmap(align)): vmap gives
`fused_wsq` a lane dimension in its grid, so an exact acvo batch
iteration launches it once for the batch (cvo_rgbd_tpu/core/
registration.py:182-191) and the tables of a batch are one launch
(:454-463).  A lane must be the port's single-pair call, bit for bit;
against the JAX package the plain version is held at row 3's tolerance
(nnz exact, wsq within 1e-4: tile sums in another order) and the aligns
op by op, tf within the stop skew, never by iteration count (ROADMAP,
queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch.core import cloud as tcloud
from cvo_rgbd_torch.core import compiled
from cvo_rgbd_torch.core import registration as treg
from cvo_rgbd_torch.ops import wsq
from cvo_rgbd_torch.parallel import align_batched
from cvo_rgbd_tpu.core import registration as jreg
from cvo_rgbd_tpu.ops import fused_wsq as j_fused_wsq
from cvo_rgbd_tpu.ops.pallas_gram import aabb_min_d2, block_bounds
from cvo_rgbd_tpu.ops.pallas_gram import color_gram as j_color_gram
from cvo_rgbd_tpu.params import AcvoParams as JA

from test_torch_batched import _assert_same, _empty, _pair, _port

torch.set_num_threads(2)

# the MATLAB stops keep the aligns short on the CPU
FAST = dict(eps=5e-4, eps_2=1e-4, max_iter=40)
# the JAX suite's stop-skew tolerance (tests/test_parallel.py:217)
TF_TOL = 3e-4
CAP = 256
LANES = 3


def _lane(res, i):
    return type(res)(*(f[i] for f in res))


def _stacks(p, seeds, n=220):
    """(JAX pairs, port fixed and moving clouds, the routed stacks and
    their prepare_batch) of `_pair`s."""
    pairs = [_pair(s, n=n, cap=CAP) for s in seeds]
    xs, ys = [_port(x) for x, _ in pairs], [_port(y) for _, y in pairs]
    p, fixed, moving = treg.route(p, tcloud.stack_clouds(xs),
                                  tcloud.stack_clouds(ys))
    return pairs, xs, ys, fixed, moving, treg.prepare_batch(
        p, fixed, moving, [None] * len(seeds))


MODES = {
    "ck skip": ct.AcvoParams(),
    "no ck": ct.AcvoParams(ck_cache=False),
    "no skip": ct.AcvoParams(tile_skip=False),
    "fast": ct.AcvoParams(exp_mode="fast"),
}


def _iteration_sweeps(p, seeds=range(30, 30 + LANES)):
    """An exact acvo batch iteration's two self-sweeps of every lane, as
    the batched loop builds them (the moving clouds moved a little, the
    lanes at different ell)."""
    *_, fixed, moving, pre = _stacks(p, seeds)
    y_pos = moving.positions + torch.tensor([0.01, -0.004, 0.002])
    sweeps = treg._self_sweeps(fixed, (y_pos, moving.features, moving.mask),
                               pre.ck, pre.skip)
    ell = torch.tensor([0.15, 0.08, 0.0391][:len(seeds)])
    return sweeps, ell


@pytest.mark.parametrize("mode", list(MODES))
def test_lane_axis_plain_is_each_lanes_one_pair_call(mode):
    """One call on [B, ...] sweeps: [B, S] outputs, each (lane, sweep)
    the bits of the lane's one-pair call of the S sweeps and of that
    sweep's one-sweep `fused_wsq`; an ell a lane and a sweep ([B, S])
    as well; a frozen lane zeros, the others unchanged."""
    p = MODES[mode]
    sweeps, ell = _iteration_sweeps(p)
    w, nz = wsq.fused_wsq_sweeps(sweeps, ell, p=p)
    assert w.shape == nz.shape == (LANES, 2)
    for b in range(LANES):
        lane = [wsq.lane_sweep(sw, b) for sw in sweeps]
        w1, n1 = wsq.fused_wsq_sweeps(lane, ell[b], p=p)
        assert torch.equal(w[b], w1) and torch.equal(nz[b], n1)
        for k, sw in enumerate(lane):
            ws, ns = wsq.fused_wsq(*sw.x, *sw.y, ell[b], sw.ck, sw.tiles,
                                   p=p, symmetric=True)
            assert torch.equal(w[b, k], ws) and torch.equal(nz[b, k], ns)
            assert float(ns) > 0
    ells = torch.stack([ell, ell * 0.9], dim=-1)
    w2, n2 = wsq.fused_wsq_sweeps(sweeps, ells, p=p)
    for b in range(LANES):
        for k in range(2):
            sw = wsq.lane_sweep(sweeps[k], b)
            ws, ns = wsq.fused_wsq(*sw.x, *sw.y, ells[b, k], sw.ck, sw.tiles,
                                   p=p, symmetric=True)
            assert torch.equal(w2[b, k], ws) and torch.equal(n2[b, k], ns)
    live = torch.tensor([True, False, True])
    wl, nl = wsq.fused_wsq_sweeps(sweeps, ell, p=p, live=live)
    assert not wl[1].any() and not nl[1].any()
    assert torch.equal(wl[0::2], w[0::2]) and torch.equal(nl[0::2], nz[0::2])


def test_lane_axis_checks_its_lanes():
    p = ct.AcvoParams()
    sweeps, ell = _iteration_sweeps(p)
    with pytest.raises(ValueError, match="one a lane"):
        wsq.fused_wsq_sweeps(sweeps, ell[:2], p=p)
    with pytest.raises(ValueError, match="live"):
        wsq.fused_wsq_sweeps(sweeps, ell, p=p, live=torch.ones(LANES))
    short = sweeps[1]._replace(x=tuple(t[:2] for t in sweeps[1].x),
                               y=tuple(t[:2] for t in sweeps[1].y))
    with pytest.raises(ValueError, match="lanes"):
        wsq.fused_wsq_sweeps([sweeps[0], short], ell, p=p)
    lane = [wsq.lane_sweep(sw, 0) for sw in sweeps]
    with pytest.raises(ValueError, match="live"):
        wsq.fused_wsq_sweeps(lane, ell[0], p=p,
                             live=torch.ones((), dtype=torch.bool))


class _PlainSpy:
    """`fused_wsq_plain` counting its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return _REAL_PLAIN(*a, **kw)


_REAL_PLAIN = wsq.fused_wsq_plain


def test_a_frozen_lane_is_not_computed_on(monkeypatch):
    """The plain version sweeps no frozen lane: two of three lanes live,
    four one-sweep sums for S = 2; with no lane live, none."""
    p = ct.AcvoParams()
    sweeps, ell = _iteration_sweeps(p)
    spy = _PlainSpy()
    monkeypatch.setattr(wsq, "fused_wsq_plain", spy)
    wsq.fused_wsq_sweeps(sweeps, ell, p=p,
                         live=torch.tensor([True, False, True]))
    assert spy.calls == 4
    w, nz = wsq.fused_wsq_sweeps(sweeps, ell, p=p,
                                 live=torch.zeros(LANES, dtype=torch.bool))
    assert spy.calls == 4 and not w.any() and not nz.any()


# symmetric self-sweeps and cross sweeps, with and without ck and the skip
JAX_MODES = [(sym, ck, skip) for sym in (True, False) for ck in (True, False)
             for skip in (True, False)]


@pytest.mark.parametrize("symmetric,use_ck,use_skip", JAX_MODES)
def test_lane_axis_plain_matches_jax_vmap(symmetric, use_ck, use_skip):
    """JAX's vmap of the Pallas `fused_wsq` (interpret mode) over three
    lanes at their own ell: nnz exact, wsq within 1e-4 relative (row 3's
    tolerance: tile sums in another order); both take the same ck, each
    its skip at its own tiles (the skip is exact)."""
    jp = JA(backend="pallas")
    p = ct.AcvoParams()
    pairs = [_pair(40 + s, n=200, cap=CAP) for s in range(LANES)]
    jx = [x for x, _ in pairs]
    jy = [x if symmetric else y for x, y in pairs]
    xb = tcloud.stack_clouds([_port(c) for c in jx])
    yb = tcloud.stack_clouds([_port(c) for c in jy])
    ell = np.array([0.12, 0.09, 0.06], np.float32)
    ck = None
    if use_ck:
        ck = np.stack([np.asarray(j_color_gram(*a, *b, p=jp, interpret=True))
                       for a, b in zip(jx, jy)])
    tiles = md = None
    if use_skip:
        md = jnp.stack([aabb_min_d2(*block_bounds(a.positions, a.mask, 256),
                                    *block_bounds(b.positions, b.mask, 256))
                        for a, b in zip(jx, jy)])
        t_md = tcloud.aabb_min_d2(
            *tcloud.block_bounds(xb.positions, xb.mask, wsq.TILE_W),
            *tcloud.block_bounds(yb.positions, yb.mask, wsq.TILE_W))
        orders = [wsq.tile_order(m, symmetric) for m in t_md]
        tiles = wsq.TileOrder(*(torch.stack(f) for f in zip(*orders)))
    t_ck = None if ck is None else torch.from_numpy(ck)
    w, nz = wsq.fused_wsq_sweeps(
        [wsq.Sweep(tuple(xb), tuple(yb), t_ck, tiles, symmetric)],
        torch.from_numpy(ell), p=p)

    def one(xp, xf, xm, yp, yf, ym, e, *opt):
        k = opt[0] if use_ck else None
        m = opt[-1] if use_skip else None
        return j_fused_wsq(xp, xf, xm, yp, yf, ym, e, k, m, p=jp,
                           symmetric=symmetric, interpret=True)

    opt = (() if ck is None else (jnp.asarray(ck),)) + (
        () if md is None else (md,))
    args = [jnp.stack([jnp.asarray(getattr(c, f)) for c in cs])
            for cs in (jx, jy) for f in ("positions", "features", "mask")]
    ref_w, ref_n = jax.vmap(one)(*args, jnp.asarray(ell), *opt)
    np.testing.assert_array_equal(nz[:, 0].numpy(), np.asarray(ref_n))
    assert (nz > 0).all()
    np.testing.assert_allclose(w[:, 0].numpy(), np.asarray(ref_w), rtol=1e-4)


class _SweepSpy:
    """`fused_wsq_sweeps` in core/registration.py, counting its calls and
    the lanes of each."""

    def __init__(self):
        self.lanes = []

    def __call__(self, sweeps, ell, **kw):
        x = sweeps[0].x[0]
        self.lanes.append(x.shape[0] if x.dim() == 3 else None)
        return wsq.fused_wsq_sweeps(sweeps, ell, **kw)


def test_batched_cheb_tables_are_each_lanes_tables(monkeypatch):
    """prepare_batch on cheb acvo: every lane's 2K table sweeps in one
    call, each lane at its own span (a host ell0 widens it), and each
    lane's tables the bits of `prepare`'s on its pair."""
    p = ct.AcvoParams(self_mode="cheb")
    *_, fixed, moving, _ = _stacks(p, range(50, 50 + LANES))
    ell0 = [None, 0.3, torch.tensor(0.2)]
    spy = _SweepSpy()
    monkeypatch.setattr(treg, "fused_wsq_sweeps", spy)
    pre = treg.prepare_batch(p, fixed, moving, ell0)
    assert spy.lanes == [LANES]
    logv, span = pre.cheb
    assert logv.shape == (LANES, 4, p.self_cheb_k)
    assert span[0].shape == (LANES,) and span[2].shape == (LANES,
                                                           p.self_cheb_k)
    monkeypatch.undo()
    for i in range(LANES):
        one = treg.prepare(p, fixed.lane(i), moving.lane(i), ell0[i]).cheb
        lane = treg.lane_pre(pre, i).cheb
        assert torch.equal(lane[0], one[0])
        assert all(torch.equal(a, b) for a, b in zip(lane[1], one[1]))
    assert float(span[0][1]) < float(span[0][0])


CASES = {
    "exact": ct.AcvoParams(**FAST),
    "cheb": ct.AcvoParams(self_mode="cheb", **FAST),
    "exact fast": ct.AcvoParams(exp_mode="fast", **FAST),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batched_acvo_lanes_are_the_bits_of_align(case, monkeypatch):
    """Three pairs, one retired: exact acvo one self-sweep call an
    iteration for the whole batch (the CPU runs every iteration of a
    block), cheb one call a batch for its tables; every lane the bits
    of `align` on its pair."""
    p = CASES[case]
    pairs = [_pair(60 + s, n=220, cap=CAP) for s in range(LANES)]
    xs, ys = [_port(x) for x, _ in pairs], [_port(y) for _, y in pairs]
    ys[2] = _empty(CAP)
    compiled.align_jit.cache_clear()
    spy = _SweepSpy()
    monkeypatch.setattr(treg, "fused_wsq_sweeps", spy)
    replays = compiled.align_jit.replays
    res = align_batched(p, tcloud.stack_clouds(xs), tcloud.stack_clouds(ys),
                        device="cpu")
    blocks = compiled.align_jit.replays - replays
    iters = blocks * treg.CHECK_EVERY
    assert spy.lanes == [LANES] * (1 if p.self_mode == "cheb" else iters)
    monkeypatch.undo()
    for i in range(LANES):
        _assert_same(_lane(res, i), ct.align(p, xs[i], ys[i], device="cpu"))
    assert int(res.iterations[2]) == 0 and int(res.iterations[0]) > 0


@pytest.mark.parametrize("self_mode", ["exact", "cheb"])
def test_batched_acvo_lanes_match_jax_op_by_op(self_mode):
    """Each lane against the JAX package's Pallas `align` on its pair, op
    by op: both converged, tf within the stop skew 3e-4 and ell within
    1e-3 relative (test_torch_acvo.py's whole-align hold)."""
    p = ct.AcvoParams(self_mode=self_mode, eps=5e-4, eps_2=1e-4)
    jp = JA(backend="pallas", self_mode=self_mode, eps=5e-4, eps_2=1e-4)
    pairs = [_pair(70 + s, n=220, cap=CAP) for s in range(2)]
    res = align_batched(p, tcloud.stack_clouds([_port(x) for x, _ in pairs]),
                        tcloud.stack_clouds([_port(y) for _, y in pairs]),
                        device="cpu")
    for i, (x, y) in enumerate(pairs):
        ref = jreg.align(jp, x, y)
        got = _lane(res, i)
        assert bool(got.converged) and bool(ref.converged)
        np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf),
                                   atol=TF_TOL)
        np.testing.assert_allclose(float(got.ell), float(ref.ell),
                                   rtol=1e-3)


def test_compiled_batch_keys_hold_the_lanes():
    """Two batch sizes of the same capacity key two compiled loops; each
    lane of either the bits of `align` (the tickets and the graphs of
    one size never serve the other)."""
    p = dataclasses.replace(CASES["exact"], max_iter=16)
    pairs = [_pair(80 + s, n=200, cap=CAP) for s in range(LANES)]
    xs, ys = [_port(x) for x, _ in pairs], [_port(y) for _, y in pairs]
    compiled.align_jit.cache_clear()
    for b in (LANES, 2):
        res = align_batched(p, tcloud.stack_clouds(xs[:b]),
                            tcloud.stack_clouds(ys[:b]), device="cpu")
        for i in range(b):
            _assert_same(_lane(res, i), ct.align(p, xs[i], ys[i],
                                                 device="cpu"))
    assert sorted(k[-1] for k in compiled.CACHE) == [(2,), (LANES,)]
