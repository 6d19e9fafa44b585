"""`align_jit` (cvo_rgbd_torch/core/compiled.py) on the CPU.

The compiled align runs the very block its CUDA graphs capture, on its
static tensors, uncaptured: it must give `align`'s bits (tf, R, T,
iterations, converged, ell, omega, v) on every backend it compiles,
with one block run (a graph replay on the card) every CHECK_EVERY
iterations and a tail block where `max_iter` is not a multiple of it.
Against the JAX package it is held as `align` is: the JAX Pallas
backend op by op (tests/test_torch_align.py explains why not its
`align_jit`), the JAX `align_jit` on "xla" for the dense backend.  The
drivers that JAX runs through its compiled align call the port's, and
give the bits they gave through `align`.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch import batch as tbatch
from cvo_rgbd_torch import odometry as todometry
from cvo_rgbd_torch import se3 as tse3
from cvo_rgbd_torch import slam as tslam
from cvo_rgbd_torch.convert import params_from_jax_dict
from cvo_rgbd_torch.core import compiled
from cvo_rgbd_torch.core import registration as treg
from cvo_rgbd_torch.keyframes import KeyframePolicy
from cvo_rgbd_tpu import align_jit as j_align_jit
from cvo_rgbd_tpu.core.cloud import PointCloud as JCloud
from cvo_rgbd_tpu.core.registration import align as j_align
from cvo_rgbd_tpu.params import CvoParams as JP

from test_slam import make_world, observe, square_loop_poses
from test_torch_align import _check_same, _pair, _port
from test_torch_linear import _pair as _linear_pair
from torch_scenes import make_parallax_folder, rendered_acvo_pair

torch.set_num_threads(2)

MATLAB_STOPS = dict(eps=5e-4, eps_2=1e-4)
FIELDS = ("tf", "R", "T", "iterations", "converged", "ell", "omega", "v")


@pytest.fixture(scope="module")
def clouds():
    """The port's CPU clouds: a random cvo pair (capacity 512), the
    rendered acvo pair (512) and a linear-color pair (384)."""
    return {"cvo": tuple(_port(c) for c in _pair(0, 400, 512)),
            "acvo": rendered_acvo_pair(),
            "linear": tuple(_port(c) for c in _linear_pair(1, 300, 384))}


def _same_bits(got, ref):
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def _jit(p, x, y, *warm):
    """align_jit's result and the blocks it ran, which must be one
    every CHECK_EVERY iterations started, the tail's included."""
    before = compiled.align_jit.replays
    res = ct.align_jit(p, x, y, *warm, device="cpu")
    blocks = compiled.align_jit.replays - before
    assert blocks == math.ceil((int(res.iterations) + 1) / treg.CHECK_EVERY)
    return res


WARM = (tse3.exp_so3(torch.tensor([0.004, 0.0, -0.003])),
        torch.tensor([0.01, 0.0, 0.005]), torch.tensor(0.06))

CASES = {
    "cvo se": ("cvo", ct.CvoParams(max_iter=60), ()),
    "cvo linear": ("linear", dataclasses.replace(ct.MATLAB_PARAMS,
                                                 max_iter=60), ()),
    "acvo exact": ("acvo", ct.AcvoParams(max_iter=60, **MATLAB_STOPS), ()),
    "acvo cheb": ("acvo", ct.AcvoParams(max_iter=60, self_mode="cheb",
                                        **MATLAB_STOPS), ()),
    "direct": ("cvo", ct.CvoParams(max_iter=60, step_mode="direct"), ()),
    "dense": ("cvo", ct.CvoParams(max_iter=60, backend="dense"), ()),
    "dense acvo": ("acvo", ct.AcvoParams(max_iter=20, backend="dense"), ()),
    "warm start": ("cvo", ct.CvoParams(max_iter=60), WARM),
}


@pytest.mark.parametrize("case", list(CASES))
def test_align_jit_gives_the_bits_of_align(clouds, case):
    pair, p, warm = CASES[case]
    x, y = clouds[pair]
    _same_bits(_jit(p, x, y, *warm), ct.align(p, x, y, *warm, device="cpu"))


def test_unconverged_tail_runs_exactly_max_iter(clouds):
    """13 iterations that cannot stop (eps = eps_2 = 0): one block of 8,
    then the tail of 5, and not one iteration more."""
    x, y = clouds["cvo"]
    p = ct.CvoParams(max_iter=13, eps=0.0, eps_2=0.0)
    got = _jit(p, x, y)
    assert int(got.iterations) == 12 and not bool(got.converged)
    _same_bits(got, ct.align(p, x, y, device="cpu"))
    longer = ct.align(dataclasses.replace(p, max_iter=16), x, y,
                      device="cpu")
    assert not torch.equal(longer.R, got.R)


def test_three_pairs_through_one_compiled_align(clouds):
    """Every result is a fresh tensor: the first pair's is unchanged
    after the object has registered two more pairs."""
    compiled.align_jit.cache_clear()
    p = ct.CvoParams(max_iter=40)
    pairs = [tuple(_port(c) for c in _pair(s, 300, 384)) for s in (5, 6, 7)]
    results = [ct.align_jit(p, *pr, device="cpu") for pr in pairs[:1]]
    first = [getattr(results[0], f).clone() for f in FIELDS]
    results += [ct.align_jit(p, *pr, device="cpu") for pr in pairs[1:]]
    assert len(compiled.CACHE) == 1
    for f, before in zip(FIELDS, first):
        assert torch.equal(getattr(results[0], f), before), f
    for res, pr in zip(results, pairs):
        _same_bits(res, ct.align(p, *pr, device="cpu"))
    assert not torch.equal(results[0].tf, results[1].tf)


def test_one_compiled_align_per_params_and_capacity(clouds):
    compiled.align_jit.cache_clear()
    p = ct.CvoParams(max_iter=8)
    x, y = clouds["cvo"]
    ct.align_jit(p, x, y, device="cpu")
    (obj,) = compiled.CACHE.values()
    ct.align_jit(p, y, x, device="cpu")
    assert list(compiled.CACHE.values()) == [obj]
    small = [_port(c) for c in _pair(8, 200, 256)]
    ct.align_jit(p, *small, device="cpu")
    ct.align_jit(p, x, small[1], device="cpu")
    ct.align_jit(dataclasses.replace(p, max_iter=9), x, y, device="cpu")
    keys = {(k[1], k[2], k[0].max_iter) for k in compiled.CACHE}
    assert keys == {(512, 512, 8), (256, 256, 8), (512, 256, 8),
                    (512, 512, 9)}
    assert [v for k, v in compiled.CACHE.items()
            if k[:3] == (p, 512, 512)] == [obj]


def test_a_transposed_warm_start_gets_its_own_compiled_align(clouds):
    """KeyframeSlam's loop closure passes R0 = prior[:3, :3].T, a
    transposed layout, which eager torch multiplies in another order on
    the first iteration: the compiled align keeps each layout's bits."""
    compiled.align_jit.cache_clear()
    x, y = clouds["cvo"]
    p = ct.CvoParams(max_iter=24, **MATLAB_STOPS)
    R0 = WARM[0].T.contiguous().T
    assert R0.stride() == (1, 3)
    got = [_jit(p, x, y, R, *WARM[1:]) for R in (R0, WARM[0], R0)]
    assert len(compiled.CACHE) == 2
    for res, R in zip(got, (R0, WARM[0], R0)):
        _same_bits(res, ct.align(p, x, y, R, *WARM[1:], device="cpu"))


def test_compiled_align_refuses_another_cloud_type(clouds):
    x, y = clouds["cvo"]
    p = ct.CvoParams(max_iter=8)
    ct.align_jit(p, x, y, device="cpu")
    (obj,) = [v for k, v in compiled.CACHE.items() if k[:3] == (p, 512, 512)]
    pre = treg.prepare(p, *treg.route(p, x, y)[1:])
    state = treg.init_state(p, torch.device("cpu"))
    with pytest.raises(ValueError, match="compiled for"):
        obj(x._replace(positions=x.positions.double()), y, pre, state)


def test_fused_backend_takes_the_route_of_align(clouds):
    x, y = clouds["linear"]
    p = dataclasses.replace(ct.MATLAB_PARAMS, backend="fused", max_iter=30)
    before = compiled.align_jit.replays
    _same_bits(ct.align_jit(p, x, y, device="cpu"),
               ct.align(p, x, y, device="cpu"))
    assert compiled.align_jit.replays == before


def test_align_jit_matches_jax_pallas():
    x, y = _pair(1, 300, 384)
    jp = JP(backend="pallas")
    _check_same(ct.align_jit(params_from_jax_dict(dataclasses.asdict(jp)),
                             _port(x), _port(y), device="cpu"),
                j_align(jp, x, y))


def test_dense_align_jit_matches_jax_align_jit_xla():
    jx, jy = (JCloud(*(t.numpy() for t in c)) for c in rendered_acvo_pair())
    jp = JP(backend="xla", **MATLAB_STOPS)
    ref = j_align_jit(jp, jx, jy)
    p = params_from_jax_dict(dataclasses.asdict(jp))
    assert p.backend == "dense"
    got = ct.align_jit(p, *rendered_acvo_pair(), device="cpu")
    assert bool(got.converged)
    _check_same(got, ref)


# ---- the drivers --------------------------------------------------------


def _twice(monkeypatch, module, run):
    """run() through align_jit, counting its calls, then through the
    eager align in its place (the driver before it was compiled)."""
    before = compiled.align_jit.calls
    got = run()
    calls = compiled.align_jit.calls - before
    with monkeypatch.context() as m:
        m.setattr(module, "align_jit", treg.align)
        ref = run()
    assert compiled.align_jit.calls == before + calls
    return got, ref, calls


def test_odometry_runs_through_align_jit(tmp_path, monkeypatch):
    (tmp_path / "tum").mkdir()
    folder = make_parallax_folder(tmp_path / "tum")

    def run():
        out = tmp_path / "traj.txt"
        recs = todometry.run_odometry(
            str(folder), 1, params=ct.CvoParams(**MATLAB_STOPS),
            num_want=512, output=str(out), use_native=False,
            log=lambda *a: None, device="cpu")
        return out.read_text(), [(r.iterations, r.converged) for r in recs]

    got, ref, calls = _twice(monkeypatch, todometry, run)
    assert calls == 5 and got == ref


def test_cli_batch_and_stitch_run_through_align_jit(tmp_path, monkeypatch,
                                                    capsys):
    from cvo_rgbd_torch import cli
    from cvo_rgbd_torch.io.export import write_pcd

    rng = np.random.default_rng(10)
    base = rng.standard_normal((300, 3)).astype(np.float32)
    base = base / np.linalg.norm(base, axis=1, keepdims=True) * (
        1.0 + rng.random(300).astype(np.float32)[:, None] * 2.0)
    col = rng.integers(0, 256, (300, 3)).astype(np.float32)
    for i in range(3):
        write_pcd(tmp_path / f"f{i}.pcd",
                  base + np.array([0.005 * i, 0, 0], np.float32), col)

    def run():
        npz, ply = tmp_path / "b.npz", tmp_path / "s.ply"
        cli.main(["batch", str(tmp_path), "--grid", "0.02", "--output",
                  str(npz), "--device", "cpu"])
        cli.main(["stitch", str(tmp_path), "--grid", "0.02", "--output",
                  str(ply), "--device", "cpu"])
        return np.load(npz)["results"], ply.read_bytes()

    (res, ply), (ref_res, ref_ply), calls = _twice(monkeypatch, tbatch, run)
    capsys.readouterr()
    assert calls == 4
    np.testing.assert_array_equal(res, ref_res)
    assert np.isfinite(res).all() and ply == ref_ply


def test_keyframe_slam_runs_through_align_jit(monkeypatch):
    """`process` (with its loop-closure aligns) and `process_batch`
    (through `_slam_step`) on tests/test_slam.py's square loop."""
    world, feat = make_world(np.random.default_rng(0), n=120)
    frames = [_port(observe(world, feat, T, cap=128))
              for T in square_loop_poses(2)]
    cfg = ct.SlamConfig(keyframe=KeyframePolicy(threshold=0.995, max_span=2))
    p = ct.CvoParams(max_iter=150, **MATLAB_STOPS)

    def run():
        one = ct.KeyframeSlam(p, cfg, device="cpu")
        for i, c in enumerate(frames):
            one.process(i, c)
        grouped = ct.KeyframeSlam(p, cfg, device="cpu")
        for s in range(0, len(frames), 4):
            grouped.process_batch([(i, frames[i])
                                   for i in range(s, min(s + 4, len(frames)))])
        return [(np.stack(s.frame_poses), [k.index for k in s.keyframes],
                 [(i, j, np.asarray(r)) for i, j, r, _ in s.loop_edges])
                for s in (one, grouped)]

    got, ref, calls = _twice(monkeypatch, tslam, run)
    assert calls >= 2 * (len(frames) - 1)
    assert len(got[0][2]) >= 1     # `process` closed a loop
    for (poses, kfs, loops), (rposes, rkfs, rloops) in zip(got, ref):
        np.testing.assert_array_equal(poses, rposes)
        assert kfs == rkfs and len(loops) == len(rloops)
        for (i, j, r), (ri, rj, rr) in zip(loops, rloops):
            assert (i, j) == (ri, rj)
            np.testing.assert_array_equal(r, rr)
