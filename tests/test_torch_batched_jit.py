"""`parallel.align_batched` on the kernel and dense backends through the
compiled align loop, and `color_gram` with a lane axis, on the CPU.

JAX compiles `align_batched` on "pallas" and "xla" as jit(vmap(align)):
vmap gives the color-cache kernel a lane axis, one launch a batch.  The
port routes the batch once, builds the color caches of all the lanes in
one `color_gram` call a cache (three for acvo), and runs the batch
through `core/compiled.py`'s loop (`run_compiled`), one loop for the
batch on both backends.  Each lane must be
the port's single-pair `align` on its pair, bit for bit; against the
JAX package the lanes are held as `align` is, op by op (its jitted
Pallas path kd-sorts with XLA:CPU, which duplicates points: ROADMAP,
queue 3).
"""

import functools
import math

import jax
import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch import odometry as todometry
from cvo_rgbd_torch import se3 as tse3
from cvo_rgbd_torch.core import cloud as tcloud
from cvo_rgbd_torch.core import compiled
from cvo_rgbd_torch.core import registration as treg
from cvo_rgbd_torch.io.tum import read_trajectory
from cvo_rgbd_torch.ops import gram
from cvo_rgbd_torch.parallel import align_batched
from cvo_rgbd_tpu.core.registration import align as j_align
from cvo_rgbd_tpu.ops.pallas_gram import color_gram as j_color_gram
from cvo_rgbd_tpu.params import CvoParams as JP

from test_torch_align import _check_same
from test_torch_batched import _assert_same, _empty, _pair, _port
from torch_scenes import make_parallax_folder

torch.set_num_threads(2)

# the MATLAB stops keep the aligns short on the CPU
FAST = dict(eps=5e-4, eps_2=1e-4, max_iter=60)


def _lanes(shapes, empty_lane=False):
    """(fixed, moving) stacks of `_pair`s: lane s has n_s valid points of
    capacity `cap`; `empty_lane` retires the last lane's moving cloud."""
    pairs = [_pair(s, n=n, cap=cap) for s, (n, cap) in enumerate(shapes)]
    xs = [_port(x) for x, _ in pairs]
    ys = [_port(y) for _, y in pairs]
    if empty_lane:
        ys[-1] = _empty(ys[-1].capacity)
    return xs, ys


def _lane(res, i):
    return type(res)(*(f[i] for f in res))


class _Spy:
    """`color_gram` counting its calls and the lanes of each."""

    def __init__(self):
        self.lanes = []

    def __call__(self, *cloud, p):
        self.lanes.append(cloud[0].shape[0] if cloud[0].dim() == 3 else None)
        return gram.color_gram(*cloud, p=p)


# --- color_gram with a lane axis ----------------------------------------

GRAM_SHAPES = {"square": (512, 512), "unequal": (256, 384)}


def _gram_batch(shape):
    """Three lanes of `shape` (N, M), the last lane's fixed cloud all
    masked, as lists of the port's CPU clouds."""
    n, m = shape
    rng = np.random.default_rng(7)
    fixed, moving = [], []
    for b in range(3):
        nv, mv = (0 if b == 2 else n - 40), m - 30
        feat = (rng.random((max(nv, mv), 5)) * np.array([255, 255, 255, 60,
                                                          60]))
        pos = rng.standard_normal((max(nv, mv), 3)) * 0.4
        fixed.append(ct.pad_cloud(pos[:nv], feat[:nv], capacity=n,
                                  device="cpu"))
        moving.append(ct.pad_cloud(pos[:mv] + 0.01, feat[:mv], capacity=m,
                                   device="cpu"))
    return fixed, moving


@pytest.mark.parametrize("shape", list(GRAM_SHAPES))
def test_batched_color_gram_plain_is_the_per_lane_call(shape):
    """(a) One call on [B,N,*] clouds: each lane the bits of the
    one-pair call, a one-lane batch the bits of the one-pair call, and
    an all-masked lane exactly zero."""
    fixed, moving = _gram_batch(GRAM_SHAPES[shape])
    p = ct.CvoParams()
    xs, ys = tcloud.stack_clouds(fixed), tcloud.stack_clouds(moving)
    got = gram.color_gram(*xs, *ys, p=p)
    assert got.shape == (3, *GRAM_SHAPES[shape])
    for i in range(3):
        one = gram.color_gram(*fixed[i], *moving[i], p=p)
        assert one.shape == GRAM_SHAPES[shape]
        assert torch.equal(got[i], one)
        single = gram.color_gram(*(t[None] for t in fixed[i]),
                                 *(t[None] for t in moving[i]), p=p)
        assert torch.equal(single[0], one)
    assert not got[2].any() and got[:2].any()


def test_batched_color_gram_checks_its_lanes():
    fixed, moving = _gram_batch(GRAM_SHAPES["square"])
    xs, ys = tcloud.stack_clouds(fixed), tcloud.stack_clouds(moving[:2])
    with pytest.raises(ValueError, match="lanes"):
        gram.color_gram(*xs, *ys, p=ct.CvoParams())
    with pytest.raises(ValueError, match="expected"):
        gram.color_gram(*xs, *ys._replace(mask=ys.mask[..., None]),
                        p=ct.CvoParams())


@pytest.mark.parametrize("shape", list(GRAM_SHAPES))
def test_batched_color_gram_plain_matches_jax_vmap(shape):
    """(b) JAX's vmap of the Pallas kernel (interpret mode) on the same
    batch: the tolerance of test_torch_ops.py's one-pair check."""
    fixed, moving = _gram_batch(GRAM_SHAPES[shape])
    xs, ys = tcloud.stack_clouds(fixed), tcloud.stack_clouds(moving)
    vf = jax.vmap(functools.partial(j_color_gram, p=JP(), interpret=True))
    ref = np.asarray(vf(*(t.numpy() for t in xs), *(t.numpy() for t in ys)))
    got = gram.color_gram(*xs, *ys, p=ct.CvoParams()).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# --- align_batched through the compiled loop ----------------------------

CASES = {
    "kernel cvo": ct.CvoParams(**FAST),
    "kernel acvo exact": ct.AcvoParams(**FAST),
    "kernel acvo cheb": ct.AcvoParams(self_mode="cheb", **FAST),
    "dense cvo": ct.CvoParams(backend="dense", **FAST),
    "dense acvo": ct.AcvoParams(backend="dense", **FAST),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compiled_lanes_are_the_bits_of_align(case, monkeypatch):
    """(c) Lanes of different pairs (one retired): every lane `align`'s
    bits on its pair; all lanes through one compiled align, one block a
    CHECK_EVERY iterations started (one loop for the batch on both
    backends, its blocks those of the slowest lane); on the kernel
    backend one `color_gram` call a batch for cvo, three for acvo, each
    on the lane axis, and none on the dense one."""
    p = CASES[case]
    xs, ys = _lanes([(200, 256), (256, 256), (150, 256)], empty_lane=True)
    compiled.align_jit.cache_clear()
    spy = _Spy()
    monkeypatch.setattr(treg, "color_gram", spy)
    replays = compiled.align_jit.replays
    res = align_batched(p, tcloud.stack_clouds(xs), tcloud.stack_clouds(ys),
                        device="cpu")
    blocks = compiled.align_jit.replays - replays
    kernel = p.backend == "kernel"
    acvo = isinstance(p, ct.AcvoParams)
    assert spy.lanes == ([3] * (3 if acvo else 1) if kernel else [])
    assert len(compiled.CACHE) == 1
    lane_blocks = [math.ceil((int(k) + 1) / treg.CHECK_EVERY)
                   for k in res.iterations]
    assert blocks == max(lane_blocks)
    for i in range(3):
        _assert_same(_lane(res, i), ct.align(p, xs[i], ys[i], device="cpu"))
    assert int(res.iterations[0]) > 0 and int(res.iterations[2]) == 0


def test_compiled_kernel_lanes_match_jax_op_by_op():
    """The kernel lanes against the JAX package's Pallas align op by op,
    with test_torch_align.py's tolerances."""
    pairs = [_pair(50 + s, n=220, cap=256) for s in range(2)]
    res = align_batched(ct.CvoParams(),
                        tcloud.stack_clouds([_port(x) for x, _ in pairs]),
                        tcloud.stack_clouds([_port(y) for _, y in pairs]),
                        device="cpu")
    for i, (x, y) in enumerate(pairs):
        _check_same(_lane(res, i), j_align(JP(backend="pallas"), x, y))


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_warm_start_lanes_with_a_transposed_r0(backend):
    """(d) R0/T0/ell0 seed each lane as `align` seeds its pair, from a
    contiguous R0 and from a transposed view of the same values: each
    layout the bits of `align` with that lane's view, and a compiled
    align of its own (eager torch rounds the layouts differently)."""
    p = ct.CvoParams(backend=backend, **FAST)
    xs, ys = _lanes([(220, 256), (180, 256), (240, 256)])
    xb, yb = tcloud.stack_clouds(xs), tcloud.stack_clouds(ys)
    R = torch.stack([tse3.exp_so3(torch.tensor(w)) for w in (
        [0.004, 0.0, -0.003], [0.0, 0.002, 0.0], [-0.002, 0.001, 0.003])])
    T0 = torch.tensor([[0.01, 0.0, 0.005], [0.0, -0.01, 0.0],
                       [0.004, 0.003, -0.002]])
    ell0 = torch.tensor([0.03, 0.1, 0.06])
    transposed = R.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(transposed, R) and transposed[1].stride() == (1, 3)
    compiled.align_jit.cache_clear()
    for R0 in (R, transposed):
        res = align_batched(p, xb, yb, R0=R0, T0=T0, ell0=ell0, device="cpu")
        for i in range(3):
            one = ct.align(p, xs[i], ys[i], R0[i], T0[i], ell0[i],
                           device="cpu")
            _assert_same(_lane(res, i), one)
    assert len(compiled.CACHE) == 2


def test_odometry_batched_runs_through_the_compiled_loop(tmp_path):
    """(e) run_odometry_batched on the kernel backend: every chunk, the
    repeat-padded last one included, one batched loop, one block a
    CHECK_EVERY iterations of its slowest lane started, and the
    trajectory the cold sequential driver's (its pairs through
    `align_jit`, the bits of `align`), line for line."""
    (tmp_path / "tum").mkdir()
    folder = make_parallax_folder(tmp_path / "tum")
    p = ct.CvoParams(**FAST)
    kw = dict(params=p, num_want=512, use_native=False, log=lambda *a: None,
              device="cpu")
    replays = compiled.align_jit.replays
    recs = todometry.run_odometry_batched(
        str(folder), 1, output=str(tmp_path / "batched.txt"), batch=2, **kw)
    blocks = compiled.align_jit.replays - replays
    iters = [r.iterations for r in recs]
    assert len(recs) == 5 and not any(r.failed for r in recs)
    # chunks (0, 1), (2, 3), (4, 4): the last pair runs twice
    assert blocks == sum(math.ceil((max(iters[c:c + 2]) + 1)
                                   / treg.CHECK_EVERY) for c in (0, 2, 4))
    todometry.run_odometry(str(folder), 1, output=str(tmp_path / "seq.txt"),
                           warm_start=False, **kw)
    seq = read_trajectory(tmp_path / "seq.txt")
    batched = read_trajectory(tmp_path / "batched.txt")
    assert set(batched) == set(seq)
    for t in seq:
        np.testing.assert_array_equal(batched[t], seq[t])


def test_fused_lanes_take_the_shared_route(monkeypatch):
    """The fused backend goes through `route` with the others; a batch
    it cannot run (yy_quirk acvo) is routed to the dense lanes."""
    calls = []
    real = treg.route

    def spy(p, fixed, moving):
        calls.append((p.backend, fixed.positions.dim()))
        return real(p, fixed, moving)

    from cvo_rgbd_torch.parallel import sharded

    monkeypatch.setattr(sharded, "route", spy)
    xs, ys = _lanes([(200, 256), (220, 256)])
    xb, yb = tcloud.stack_clouds(xs), tcloud.stack_clouds(ys)
    p = ct.CvoParams(backend="fused", **FAST)
    res = align_batched(p, xb, yb, device="cpu")
    for i in range(2):
        _assert_same(_lane(res, i), ct.align(p, xs[i], ys[i], device="cpu"))
    q = ct.AcvoParams(backend="fused", yy_quirk=True, **FAST)
    replays = compiled.align_jit.replays
    res = align_batched(q, xb, yb, device="cpu")
    assert compiled.align_jit.replays > replays
    for i in range(2):
        _assert_same(_lane(res, i), ct.align(q, xs[i], ys[i], device="cpu"))
    assert calls == [("fused", 3), ("fused", 3)]
