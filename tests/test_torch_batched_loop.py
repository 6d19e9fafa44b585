"""The kernel backend's batched loop on the CPU: `fused_moments` on a lane
axis, the O(M) epilogue on [B, ...] tensors, and `align_batched` on
"kernel" as one compiled loop for the batch.

JAX compiles `align_batched` on "pallas" as jit(vmap(align)): vmap gives
`fused_moments` a lane dimension in its grid, one launch a batch an
iteration, and the while_loop runs until every lane has converged, a
converged lane frozen.  The port runs the batch the same way
(`core/registration.make_batched_step`, `core/compiled.run_compiled` on
the stacked state).  A lane must be the port's single-pair `align` on
its pair, bit for bit; against the JAX package the lanes are held as
`align` is, op by op (its jitted Pallas path kd-sorts with XLA:CPU,
which duplicates points: ROADMAP, queue 3).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch import se3 as tse3
from cvo_rgbd_torch.core import cloud as tcloud
from cvo_rgbd_torch.core import compiled
from cvo_rgbd_torch.core import registration as treg
from cvo_rgbd_torch.core.cubic import cubic_roots, min_positive_root
from cvo_rgbd_torch.core.lanes import lane_matmul
from cvo_rgbd_torch.core.moments import flow_from_moments, step_from_moments
from cvo_rgbd_torch.core.step_factored import monomial_features
from cvo_rgbd_torch.ops import moments as tmoments
from cvo_rgbd_torch.ops.gram import color_gram as t_color_gram
from cvo_rgbd_torch.ops.gram import pad_feat
from cvo_rgbd_torch.ops.moments import TILE_I, TILE_J
from cvo_rgbd_torch.parallel import align_batched
from cvo_rgbd_tpu.core import registration as jreg
from cvo_rgbd_tpu.core.moments import monomial_features_padded
from cvo_rgbd_tpu.ops import fused_moments as j_fused_moments
from cvo_rgbd_tpu.ops.pallas_gram import aabb_min_d2, block_bounds
from cvo_rgbd_tpu.params import MATLAB_PARAMS as J_MATLAB
from cvo_rgbd_tpu.params import AcvoParams as JA
from cvo_rgbd_tpu.params import CvoParams as JP

from test_torch_batched import _assert_same, _empty, _pair, _port

torch.set_num_threads(2)

# the MATLAB stops keep the aligns short on the CPU
FAST = dict(eps=5e-4, eps_2=1e-4, max_iter=40)
# the JAX suite's stop-skew tolerance (tests/test_parallel.py:217)
TF_TOL = 3e-4
CAP = 256


def _lane(res, i):
    return type(res)(*(f[i] for f in res))


def _clouds(seeds, nfeat=5, n=220, cap=CAP):
    """(JAX pairs, port fixed clouds, port moving clouds) of `_pair`s."""
    pairs = [_pair(s, n=n, cap=cap, nfeat=nfeat) for s in seeds]
    return (pairs, [_port(x) for x, _ in pairs],
            [_port(y) for _, y in pairs])


# --- fused_moments on a lane axis ----------------------------------------

MODES = {
    "ck": dict(ck=True, skip=False),
    "no ck": dict(ck=False, skip=False),
    "skip": dict(ck=True, skip=True),
    "linear": dict(ck=True, skip=True, linear=True),
    "fast": dict(ck=False, skip=True, fast=True),
}


def _sweep_inputs(mode, lanes=3, n=CAP):
    """The batched sweep's inputs on the CPU, as the batched loop builds
    them: kd-sorted stacks, centered on each lane's c0, the lanes at
    different ell, with the mode's ck (color_gram, or linear mode's masked
    CI) and tile bounds.  Returns (params, args, kwargs)."""
    opt = MODES[mode]
    linear = opt.get("linear", False)
    p = (dataclasses.replace(ct.MATLAB_PARAMS, max_iter=1) if linear
         else ct.CvoParams(exp_mode="fast" if opt.get("fast") else "precise"))
    _, xs, ys = _clouds(range(30, 30 + lanes), nfeat=3 if linear else 5, n=n)
    fixed, moving = (tcloud.kd_sort(tcloud.stack_clouds(c)) for c in (xs, ys))
    fixed, moving = (c._replace(features=pad_feat(c.features))
                     for c in (fixed, moving))
    pre = treg.prepare_batch(p, fixed, moving, [None] * lanes)
    c0, x_c, phi = pre.moments
    # a small motion of each moving cloud, as an iteration sees it
    y_pos = moving.positions + torch.tensor([0.01, -0.004, 0.002])
    ck = pre.ck[0] if opt["ck"] else None
    md = None
    if opt["skip"]:
        md = tcloud.aabb_min_d2(*pre.skip[:2], *tcloud.block_bounds(
            y_pos, moving.mask, TILE_J))
    ell = torch.tensor([0.2, 0.15, 0.1][:lanes], dtype=torch.float32)
    args = (x_c, fixed.features, fixed.mask, y_pos - c0[:, None, :],
            moving.features, moving.mask, phi, ell)
    return p, args, dict(ck=ck, min_d2=md)


def _one_lane(args, kw, i):
    return (tuple(a[i] for a in args),
            {k: None if v is None else v[i] for k, v in kw.items()})


@pytest.mark.parametrize("mode", list(MODES))
def test_batched_moments_plain_is_the_per_lane_call(mode):
    """(a) One call on [B, ...] inputs: each lane the bits of the
    one-pair call on it (and of `fused_moments_plain` with its scalar
    row), a dead lane zeros and the others unchanged."""
    p, args, kw = _sweep_inputs(mode)
    mom, nnz = tmoments.fused_moments(*args, **kw, p=p)
    assert mom.shape == (3, CAP, 35) and nnz.shape == (3,)
    for i in range(3):
        a, k = _one_lane(args, kw, i)
        one_mom, one_nnz = tmoments.fused_moments(*a, **k, p=p)
        assert torch.equal(mom[i], one_mom) and torch.equal(nnz[i], one_nnz)
        assert float(one_nnz) > 0
    live = torch.tensor([True, False, True])
    part, part_nnz = tmoments.fused_moments(*args, **kw, p=p, live=live)
    assert not part[1].any() and float(part_nnz[1]) == 0.0
    for i in (0, 2):
        assert torch.equal(part[i], mom[i]) and torch.equal(part_nnz[i],
                                                            nnz[i])


def test_batched_moments_check_their_lanes():
    p, args, kw = _sweep_inputs("ck")
    with pytest.raises(ValueError, match="one a lane"):
        tmoments.fused_moments(*args[:7], args[7][:2], **kw, p=p)
    with pytest.raises(ValueError, match="live"):
        tmoments.fused_moments(*args, **kw, p=p,
                               live=torch.ones(3, dtype=torch.float32))
    with pytest.raises(ValueError, match="lanes"):
        tmoments.fused_moments(*args[:3], *(a[:2] for a in args[3:6]),
                               *args[6:], **kw, p=p)
    a, k = _one_lane(args, kw, 0)
    with pytest.raises(ValueError, match="live"):
        tmoments.fused_moments(*a, **k, p=p, live=torch.ones(
            (), dtype=torch.bool))


@pytest.mark.parametrize("mode", ["skip", "linear"])
def test_batched_moments_plain_match_jax_vmap(mode):
    """(b) JAX's vmap of the Pallas kernel (interpret mode) on the same
    lanes: nnz exact, Mom within 1e-5 of each moment column's magnitude
    (test_torch_ops.py's one-pair tolerance: tile dot products against
    one matmul); both take the port's caches, the JAX skip at its own
    tiles (the skip is exact)."""
    linear = mode == "linear"
    jp = (dataclasses.replace(J_MATLAB, backend="pallas") if linear
          else JP(backend="pallas"))
    p = ct.MATLAB_PARAMS if linear else ct.CvoParams()
    pairs, xs, ys = _clouds(range(40, 43), nfeat=3 if linear else 5)
    xb, yb = (tcloud.stack_clouds(c) for c in (xs, ys))
    xb, yb = (c._replace(features=pad_feat(c.features)) for c in (xb, yb))
    c0 = torch.stack([treg.build_moments_pre(x)[0] for x in xs])
    xc = xb.positions - c0[:, None, :]
    yc = yb.positions - c0[:, None, :]
    ell = torch.tensor([0.12, 0.07, 0.04], dtype=torch.float32)
    if linear:
        ck = torch.stack([treg.prepare_ci(p, x, y) for x, y in zip(xs, ys)])
    else:
        ck = t_color_gram(*xb, *yb, p=p)
    md = tcloud.aabb_min_d2(*tcloud.block_bounds(xb.positions, xb.mask,
                                                 TILE_I),
                            *tcloud.block_bounds(yb.positions, yb.mask,
                                                 TILE_J))
    mom, nnz = tmoments.fused_moments(
        xc, xb.features, xb.mask, yc, yb.features, yb.mask,
        monomial_features(xc), ell, ck, md, p=p)

    def j_md(xp, xm, yp, ym):
        return aabb_min_d2(*block_bounds(xp, xm, 256),
                           *block_bounds(yp, ym, 256))

    jf = jax.vmap(lambda xp, xf, xm, yp, yf, ym, e, k: j_fused_moments(
        xp, xf, xm, yp, yf, ym, monomial_features_padded(xp), e, k,
        j_md(xp, xm, yp, ym), p=jp, interpret=True))
    np_ = [t.numpy() for t in (xc, xb.features, xb.mask, yc, yb.features,
                               yb.mask, ell, ck)]
    ref_mom, ref_nnz = jf(*(jnp.asarray(a) for a in np_))
    ref_mom = np.asarray(ref_mom)[..., :35]
    np.testing.assert_array_equal(nnz.numpy(), np.asarray(ref_nnz))
    assert (nnz > 0).all()
    scale = np.abs(ref_mom).max(axis=1, keepdims=True)
    assert (np.abs(mom.numpy() - ref_mom) <= 1e-5 * scale).all()


# --- the epilogue and the precompute on a lane axis -----------------------

def test_epilogue_lanes_are_the_one_pair_bits():
    """flow_from_moments, step_from_moments, the cubic, se3_inv,
    make_se3, exp_sek3, dist_se3, transform_cloud and block_bounds /
    aabb_min_d2 on [B, ...]: each lane the bits of the one-pair call."""
    rng = np.random.default_rng(5)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32)

    B, M = 3, 384
    Mom, y_pos, c0 = t(B, M, 35), t(B, M, 3), t(B, 3, scale=0.1)
    omega, v = t(B, 3, scale=1e-3), t(B, 3, scale=1e-3)
    ell = torch.tensor([0.1, 0.06, 0.03])
    flow = flow_from_moments(Mom, y_pos, c0, c=7.0, d=7.0)
    step = step_from_moments(Mom, y_pos, c0, omega, v, ell)
    coef = torch.stack(step, dim=-1)
    roots, valid = cubic_roots(4.0 * coef[:, 3], 3.0 * coef[:, 2],
                               2.0 * coef[:, 1], coef[:, 0])
    dt = min_positive_root(roots, valid, 0.1, 0.5)
    R = torch.stack([tse3.exp_so3(w) for w in t(B, 3, scale=0.1)])
    T = t(B, 3)
    inv = tse3.se3_inv(R, T, mm=lane_matmul)
    tf = tse3.make_se3(*inv)
    dR, dT = tse3.exp_sek3(omega, v, dt, mm=lane_matmul)
    dist = tse3.dist_se3(dR, dT, mm=lane_matmul)
    moved = tcloud.transform_cloud(R, T, y_pos, mm=lane_matmul)
    mask = (t(B, M) > -1.0).to(torch.float32)
    lo, hi = tcloud.block_bounds(moved, mask, TILE_J)
    md = tcloud.aabb_min_d2(lo, hi, lo, hi)
    for i in range(B):
        one = flow_from_moments(Mom[i], y_pos[i], c0[i], c=7.0, d=7.0)
        assert all(torch.equal(a[i], b) for a, b in zip(flow, one))
        one = step_from_moments(Mom[i], y_pos[i], c0[i], omega[i], v[i],
                                ell[i])
        assert all(torch.equal(a[i], b) for a, b in zip(step, one))
        r1, v1 = cubic_roots(4.0 * one[3], 3.0 * one[2], 2.0 * one[1],
                             one[0])
        assert torch.equal(roots[i], r1) and torch.equal(valid[i], v1)
        assert torch.equal(dt[i], min_positive_root(r1, v1, 0.1, 0.5))
        one_inv = tse3.se3_inv(R[i], T[i])
        assert all(torch.equal(a[i], b) for a, b in zip(inv, one_inv))
        assert torch.equal(tf[i], tse3.make_se3(*one_inv))
        one_d = tse3.exp_sek3(omega[i], v[i], dt[i])
        assert torch.equal(dR[i], one_d[0]) and torch.equal(dT[i], one_d[1])
        assert torch.equal(dist[i], tse3.dist_se3(*one_d))
        assert torch.equal(moved[i], tcloud.transform_cloud(R[i], T[i],
                                                            y_pos[i]))
        one_lo, one_hi = tcloud.block_bounds(moved[i], mask[i], TILE_J)
        assert torch.equal(lo[i], one_lo) and torch.equal(hi[i], one_hi)
        assert torch.equal(md[i], tcloud.aabb_min_d2(one_lo, one_hi, one_lo,
                                                     one_hi))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return []


@pytest.mark.parametrize("case", ["cvo", "acvo cheb", "linear"])
def test_batched_precompute_and_state(case):
    """prepare_batch: one stacked AlignPre whose lane i is `prepare`'s
    bits on pair i (the caches of the batch's own launch, not split);
    init_state(lanes=B) the one-pair state on every lane."""
    linear = case == "linear"
    p = {"cvo": ct.CvoParams(), "acvo cheb": ct.AcvoParams(self_mode="cheb"),
         "linear": ct.MATLAB_PARAMS}[case]
    _, xs, ys = _clouds(range(50, 52), nfeat=3 if linear else 5)
    p, fixed, moving = treg.route(p, tcloud.stack_clouds(xs),
                                  tcloud.stack_clouds(ys))
    ell0 = [None, 0.3]
    pre = treg.prepare_batch(p, fixed, moving, ell0)
    assert pre.moments[2].shape == (2, CAP, 35)
    assert pre.ck[0].shape == (2, CAP, CAP)
    for i in range(2):
        one = treg.prepare(p, fixed.lane(i), moving.lane(i), ell0[i])
        lane = treg.lane_pre(pre, i)
        flat, ref = _leaves(lane), _leaves(one)
        assert len(flat) == len(ref) > 0
        assert all(torch.equal(a, b) for a, b in zip(flat, ref))
    state = treg.init_state(p, "cpu", lanes=2)
    one = treg.init_state(p, "cpu")
    for a, b in zip(state, one):
        assert a.shape == (2, *b.shape) and torch.equal(a[1], b)


# --- align_batched through the batched loop ---------------------------

CASES = {
    "cvo": ct.CvoParams(**FAST),
    "acvo exact": ct.AcvoParams(**FAST),
    "acvo cheb": ct.AcvoParams(self_mode="cheb", **FAST),
    "linear": dataclasses.replace(ct.MATLAB_PARAMS, max_iter=40),
    "fast": ct.CvoParams(exp_mode="fast", **FAST),
}


class _MomentSpy:
    """`fused_moments` counting its calls and the lanes of each."""

    def __init__(self):
        self.lanes = []

    def __call__(self, *args, **kw):
        self.lanes.append(args[0].shape[0] if args[0].dim() == 3 else None)
        return tmoments.fused_moments(*args, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_batched_loop_lanes_are_the_bits_of_align(case, monkeypatch):
    """(c, g) Three pairs, one of them retired: one compiled loop for the
    batch (one cache entry), whose blocks are the slowest lane's; one
    `fused_moments` call an iteration for the batch, on its three lanes
    (the CPU runs every iteration of a block); and every lane the bits
    of the port's `align` on its pair."""
    p = CASES[case]
    linear = case == "linear"
    _, xs, ys = _clouds(range(60, 63), nfeat=3 if linear else 5)
    ys[2] = _empty(CAP, nfeat=3 if linear else 5)
    compiled.align_jit.cache_clear()
    spy = _MomentSpy()
    monkeypatch.setattr(treg, "fused_moments", spy)
    replays = compiled.align_jit.replays
    res = align_batched(p, tcloud.stack_clouds(xs), tcloud.stack_clouds(ys),
                        device="cpu")
    blocks = compiled.align_jit.replays - replays
    assert len(compiled.CACHE) == 1
    (key,) = compiled.CACHE
    assert key[-1] == (3,)
    slowest = int(res.iterations.max())
    assert blocks == math.ceil((slowest + 1) / treg.CHECK_EVERY)
    assert spy.lanes == [3] * blocks * treg.CHECK_EVERY
    monkeypatch.undo()
    for i in range(3):
        _assert_same(_lane(res, i), ct.align(p, xs[i], ys[i], device="cpu"))
    assert int(res.iterations[2]) == 0 and bool(res.converged[2])
    assert int(res.iterations[0]) > 0 and int(res.iterations[1]) > 0


def test_batched_loop_takes_the_max_iter_tail():
    """max_iter not a multiple of CHECK_EVERY: the blocks and the tail,
    then every lane stops at the cap as `align` stops."""
    p = ct.CvoParams(max_iter=treg.CHECK_EVERY + 3)
    _, xs, ys = _clouds(range(64, 66))
    res = align_batched(p, tcloud.stack_clouds(xs), tcloud.stack_clouds(ys),
                        device="cpu")
    assert (res.iterations == p.max_iter - 1).all()
    for i in range(2):
        _assert_same(_lane(res, i), ct.align(p, xs[i], ys[i], device="cpu"))


JAX_CASES = {
    "cvo": (ct.CvoParams(), JP(backend="pallas")),
    "acvo exact": (ct.AcvoParams(eps=5e-4, eps_2=1e-4),
                   JA(backend="pallas", eps=5e-4, eps_2=1e-4)),
    "linear": (ct.MATLAB_PARAMS,
               dataclasses.replace(J_MATLAB, backend="pallas")),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_batched_loop_lanes_match_jax_op_by_op(case):
    """(d) Each lane against the JAX package's Pallas `align` on its
    pair, op by op: the same `converged`, iterations within 2, tf within
    the stop skew 3e-4, acvo's ell within 1e-3 relative
    (test_torch_acvo.py's whole-align hold)."""
    p, jp = JAX_CASES[case]
    pairs, xs, ys = _clouds(range(70, 72), nfeat=3 if case == "linear"
                            else 5)
    res = align_batched(p, tcloud.stack_clouds(xs), tcloud.stack_clouds(ys),
                        device="cpu")
    for i, (x, y) in enumerate(pairs):
        ref = jreg.align(jp, x, y)
        got = _lane(res, i)
        assert bool(got.converged) and bool(ref.converged)
        assert abs(int(got.iterations) - int(ref.iterations)) <= 2
        np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf),
                                   atol=TF_TOL)
        np.testing.assert_allclose(float(got.ell), float(ref.ell),
                                   rtol=1e-3)


def test_a_converged_lane_stays_frozen_and_lanes_are_independent():
    """(e) An identical pair converges at iteration 0 and stays frozen
    (identity, its ell untouched) while the other lanes move; and lane i
    alone (a batch of one) is the bits of lane i in the batch of three."""
    p = ct.AcvoParams(**FAST)
    _, xs, ys = _clouds(range(80, 83))
    ys[1] = xs[1]
    res = align_batched(p, tcloud.stack_clouds(xs), tcloud.stack_clouds(ys),
                        device="cpu")
    assert int(res.iterations[1]) == 0 and bool(res.converged[1])
    assert torch.equal(res.tf[1], torch.eye(4))
    assert float(res.ell[1]) == float(np.float32(p.ell_init))
    assert int(res.iterations[0]) > 0 and int(res.iterations[2]) > 0
    for i in (0, 2):
        alone = align_batched(p, tcloud.stack_clouds([xs[i]]),
                              tcloud.stack_clouds([ys[i]]), device="cpu")
        _assert_same(_lane(alone, 0), _lane(res, i))


def test_a_transposed_warm_start_keys_its_own_batch():
    """(f) R0/T0/ell0 seed every lane; a transposed view of the same R0
    keys its own compiled batch (the key holds the inputs' strides), and
    each layout's lanes are `align`'s bits with that lane's view."""
    p = ct.CvoParams(**FAST)
    _, xs, ys = _clouds(range(90, 93))
    xb, yb = tcloud.stack_clouds(xs), tcloud.stack_clouds(ys)
    R = torch.stack([tse3.exp_so3(torch.tensor(w)) for w in (
        [0.004, 0.0, -0.003], [0.0, 0.002, 0.0], [-0.002, 0.001, 0.003])])
    T0 = torch.tensor([[0.01, 0.0, 0.005], [0.0, -0.01, 0.0],
                       [0.004, 0.003, -0.002]])
    ell0 = torch.tensor([0.03, 0.1, 0.06])
    transposed = R.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(transposed, R) and transposed.stride() == (9, 1, 3)
    compiled.align_jit.cache_clear()
    for R0 in (R, transposed):
        res = align_batched(p, xb, yb, R0=R0, T0=T0, ell0=ell0, device="cpu")
        for i in range(3):
            one = ct.align(p, xs[i], ys[i], R0[i], T0[i], ell0[i],
                           device="cpu")
            _assert_same(_lane(res, i), one)
    assert len(compiled.CACHE) == 2
    assert {k[-1] for k in compiled.CACHE} == {(3,)}


def test_the_direct_step_keeps_its_lanes(monkeypatch):
    """step_mode="direct" runs each lane through its one-pair compiled
    align (its sweeps have no lane axis: no JAX align path launches
    them); make_batched_step refuses it."""
    p = ct.CvoParams(step_mode="direct", **FAST)
    _, xs, ys = _clouds(range(94, 96))
    compiled.align_jit.cache_clear()
    res = align_batched(p, tcloud.stack_clouds(xs), tcloud.stack_clouds(ys),
                        device="cpu")
    assert {k[-1] for k in compiled.CACHE} == {()}
    for i in range(2):
        _assert_same(_lane(res, i), ct.align(p, xs[i], ys[i], device="cpu"))
    with pytest.raises(ValueError, match="moment step"):
        treg.make_batched_step(p)
