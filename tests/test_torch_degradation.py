"""The port on degraded input, against the JAX package.

`synth.Degradation` (noisy quantized depth, blob holes, a texture-starved
frame, a frame of total depth dropout) must write the JAX package's
bytes, and the port's failure machinery must fire where JAX's does, at
the sizes of tests/test_degradation.py: the frontend's block refill on
the low-texture frame, skip-and-mark in `run_odometry`,
`run_odometry_batched` (both `motion_prior` settings) and on a
NaN-poisoned cloud, the per-lane reset of `run_multiseq`, and
`KeyframeSlam`'s deferred seeding.

JAX runs its default backend "xla", the port its default kernel backend
on the plain versions (`device="cpu"`).  The failed sets, the carried
poses and the keyframes are held exactly.  The two align at the MATLAB
stops, where float32 rounding can move a stop by an iteration: on this
sequence the sequential driver's first three pairs stop alike and agree
within 7e-6; from pair 4 on, 7 of the 21 aligned pairs stop one or two
iterations apart (up to 9e-4 in tf), and the warm start carries that
into the next pairs, whose equal stops agree within 2.4e-4; the ATEs
part by 4.9e-4 m.  So the transforms are held to JAX's at equal stops,
and the trajectory by its ATE, beside JAX's and against the ground
truth.
"""

import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

from cvo_rgbd_torch.evaluation import ate_rmse, nan_cloud
from cvo_rgbd_torch.frontend import make_frontend
from cvo_rgbd_torch.io.tum import load_assoc, read_trajectory
from cvo_rgbd_torch.odometry import load_image_pair
from cvo_rgbd_torch.params import CvoParams
from cvo_rgbd_torch.synth import Degradation, make_tum_dataset, revisit_path

torch.set_num_threads(2)

N_FRAMES = 24
NUM_WANT = 512
DROP = 10            # total sensor dropout at this frame
LOW_TEX = 6          # texture contrast crushed at this frame
NAN_FRAME = 3
# a NaN pair runs to max_iter (2000 in both packages, ~25 s a pair on the
# port's plain versions); the NaN run caps it, as chip_smoke.py's does
NAN_MAX_ITER = 100
DEGRADE = dict(depth_noise=2e-3, dropout=0.08, low_texture_frames=(LOW_TEX,),
               drop_frames=(DROP,), seed=3)
P = dict(eps=5e-4, eps_2=1e-4)
CPU = "cpu"
# per-pair tf against JAX's: before the first stop that parts (the same
# inputs) and at every later pair of equal stops (behind a warm start the
# skew moved, as tests/test_torch_orbit.py); the ATEs' difference, m
SAME_INPUT_TOL, EQUAL_STOP_TOL, ATE_TOL = 2e-5, 3e-4, 1e-3


def _jax_params():
    from cvo_rgbd_tpu.params import CvoParams as JaxCvoParams

    return JaxCvoParams(**P)


def _quiet(*a):
    pass


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """The degraded sequence written by each package."""
    from cvo_rgbd_tpu import synth as jsynth

    root = tmp_path_factory.mktemp("deg_torch")
    make_tum_dataset(root, revisit_path(N_FRAMES, period=33),
                     degrade=Degradation(**DEGRADE))
    jroot = tmp_path_factory.mktemp("deg_jax")
    jsynth.make_tum_dataset(jroot, jsynth.revisit_path(N_FRAMES, period=33),
                            degrade=jsynth.Degradation(**DEGRADE))
    return root, jroot


@pytest.fixture(scope="module")
def root(folders):
    return folders[0]


def _entries(root):
    return load_assoc(os.path.join(root, "assoc.txt"))


def _failed(records):
    return {r.index for r in records if r.failed}


def _hashes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha1(
                    fh.read()).hexdigest()
    return out


def test_degraded_dataset_is_the_jax_bytes(folders):
    root, jroot = folders
    got, want = _hashes(root), _hashes(jroot)
    assert len(got) == 2 * N_FRAMES + 2
    assert got == want
    # the effects are there: total dropout, crushed contrast
    entries = _entries(root)
    _, dep_drop = load_image_pair(root, entries[DROP])
    assert (dep_drop == 0).all()
    rgb_low, _ = load_image_pair(root, entries[LOW_TEX])
    rgb_ok, _ = load_image_pair(root, entries[1])
    assert np.std(rgb_low) < 0.15 * np.std(rgb_ok)


def test_low_texture_frame_refill_matches_jax(root):
    """The refill takes at most one pixel an 8x8 block, 192 on 96x128:
    most of that budget must be realized, JAX's count exactly."""
    from cvo_rgbd_tpu.frontend import make_frontend as jax_frontend

    rgb, dep = load_image_pair(root, _entries(root)[LOW_TEX])
    n_valid = int(make_frontend(1, NUM_WANT, 1, device=CPU)(rgb, dep)
                  .mask.sum())
    n_jax = int(np.asarray(jax_frontend(1, NUM_WANT, 1)(rgb, dep).mask).sum())
    assert n_valid == n_jax
    assert n_valid > 0.6 * (96 // 8) * (128 // 8) and n_valid >= 64


def _pair_tfs(traj):
    ts = sorted(traj)
    return [np.linalg.inv(traj[a]) @ traj[b] for a, b in zip(ts, ts[1:])]


def _carried(out, root, first=DROP):
    """The two frames of the failed pairs carry frame first-1's pose."""
    est = read_trajectory(out)
    names = [float(e.name) for e in _entries(root)]
    np.testing.assert_allclose(est[names[first]], est[names[first - 1]])
    np.testing.assert_allclose(est[names[first + 1]], est[names[first - 1]])
    return est


def test_odometry_failed_pairs_match_jax(root, tmp_path):
    from cvo_rgbd_tpu.odometry import run_odometry as jax_run

    from cvo_rgbd_torch.odometry import run_odometry

    out, jout = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    recs = run_odometry(str(root), 1, params=CvoParams(**P),
                        num_want=NUM_WANT, output=out, use_native=False,
                        log=_quiet, device=CPU)
    jrecs = jax_run(str(root), 1, params=_jax_params(), num_want=NUM_WANT,
                    output=jout, use_native=False, log=_quiet)
    assert _failed(recs) == _failed(jrecs) == {DROP, DROP + 1}
    est = _carried(out, root)
    jest = _carried(jout, root)
    its = [(r.iterations, j.iterations) for r, j in zip(recs, jrecs)]
    split = next(k for k, (a, b) in enumerate(its) if a != b)
    assert split > 0
    for k, (got, want) in enumerate(zip(_pair_tfs(est), _pair_tfs(jest))):
        if k < split:
            np.testing.assert_allclose(got, want, rtol=0, atol=SAME_INPUT_TOL)
        elif its[k][0] == its[k][1]:
            np.testing.assert_allclose(got, want, rtol=0, atol=EQUAL_STOP_TOL)
    gt = read_trajectory(os.path.join(root, "groundtruth.txt"))
    ate, jate = ate_rmse(gt, est)["rmse"], ate_rmse(gt, jest)["rmse"]
    assert abs(ate - jate) < ATE_TOL and ate < 0.08


@pytest.mark.parametrize("prior", [False, True])
def test_batched_odometry_failed_pairs_match_jax(root, tmp_path, prior):
    from cvo_rgbd_tpu.odometry import run_odometry_batched as jax_batched

    from cvo_rgbd_torch.odometry import run_odometry_batched

    out, jout = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    recs = run_odometry_batched(str(root), 1, params=CvoParams(**P),
                                num_want=NUM_WANT, batch=4, output=out,
                                motion_prior=prior, use_native=False,
                                log=_quiet, device=CPU)
    jrecs = jax_batched(str(root), 1, params=_jax_params(),
                        num_want=NUM_WANT, batch=4, output=jout,
                        motion_prior=prior, use_native=False, log=_quiet)
    assert _failed(recs) == _failed(jrecs) == {DROP, DROP + 1}
    _carried(out, root)
    _carried(jout, root)


def test_nan_injection_matches_jax(root, tmp_path):
    """A cloud with a finite mask and NaN positions (the align loop alone
    would converge to identity on it) fails exactly its two pairs."""
    import jax.numpy as jnp

    import cvo_rgbd_torch.odometry as odom
    import cvo_rgbd_tpu.odometry as jodom

    kw = dict(num_want=NUM_WANT, max_frames=7, use_native=False, log=_quiet)
    with nan_cloud(odom, NAN_FRAME), nan_cloud(
            jodom, NAN_FRAME, lambda x: jnp.full_like(x, jnp.nan)):
        recs = odom.run_odometry(
            str(root), 1, params=CvoParams(**P, max_iter=NAN_MAX_ITER),
            output=str(tmp_path / "t.txt"), device=CPU, **kw)
        jrecs = jodom.run_odometry(
            str(root), 1, params=dataclasses.replace(_jax_params(),
                                                     max_iter=NAN_MAX_ITER),
            output=str(tmp_path / "j.txt"), **kw)
    assert _failed(recs) == _failed(jrecs) == {NAN_FRAME, NAN_FRAME + 1}
    later = [r for r in recs if r.index > NAN_FRAME + 1]
    assert later and all(not r.failed for r in later)
    _carried(str(tmp_path / "t.txt"), root, NAN_FRAME)


def test_multiseq_isolates_the_failed_lane(root, tmp_path):
    """One lane's dropped frame fails only that lane: the same skip
    lines as JAX's, every pose finite."""
    from cvo_rgbd_tpu.multiseq import run_multiseq as jax_multiseq

    from cvo_rgbd_torch.multiseq import run_multiseq

    clean = str(tmp_path / "clean")
    make_tum_dataset(clean, revisit_path(8, period=33))
    folders = [str(root), clean]
    lines = {}
    for name, fn, params, kw in (
            ("torch", run_multiseq, CvoParams(**P), {"device": CPU}),
            ("jax", jax_multiseq, _jax_params(), {})):
        msgs = []
        outs = fn(folders, 1, params=params, num_want=NUM_WANT,
                  max_frames=12,
                  log=lambda *a: msgs.append(" ".join(map(str, a))), **kw)
        lines[name] = [m for m in msgs if "skipping" in m]
        t_deg, t_clean = (read_trajectory(outs[f]) for f in folders)
        assert len(t_deg) == 12 and len(t_clean) == 8
        for tr in (t_deg, t_clean):
            assert all(np.isfinite(v).all() for v in tr.values())
    assert lines["torch"] == lines["jax"]
    assert lines["torch"] and all(str(root) in m for m in lines["torch"])


def _slam_runs(root, order):
    """KeyframeSlam of both packages fed the frames of `order`."""
    from cvo_rgbd_tpu.frontend import make_frontend as jax_frontend
    from cvo_rgbd_tpu.keyframes import KeyframePolicy as JaxPolicy
    from cvo_rgbd_tpu.slam import KeyframeSlam as JaxSlam
    from cvo_rgbd_tpu.slam import SlamConfig as JaxConfig

    from cvo_rgbd_torch.keyframes import KeyframePolicy
    from cvo_rgbd_torch.slam import KeyframeSlam, SlamConfig

    entries = _entries(root)
    slam = KeyframeSlam(CvoParams(**P),
                        SlamConfig(keyframe=KeyframePolicy(max_span=6)),
                        device=CPU)
    jslam = JaxSlam(_jax_params(), JaxConfig(keyframe=JaxPolicy(max_span=6)))
    fe, jfe = make_frontend(1, NUM_WANT, 1, device=CPU), jax_frontend(
        1, NUM_WANT, 1)
    for i, j in enumerate(order):
        frame = load_image_pair(root, entries[j])
        slam.process(i, fe(*frame))
        jslam.process(i, jfe(*frame))
    return slam, jslam


def _keyframes(slam):
    return [k.index for k in slam.keyframes]


def test_slam_defers_seeding_past_a_dropped_first_frame(root):
    slam, jslam = _slam_runs(root, [DROP, 1, 2, 3])
    assert _keyframes(slam) == _keyframes(jslam)
    assert slam.keyframes[0].index == 1
    np.testing.assert_allclose(slam.frame_poses[0], np.eye(4))
    assert slam.keyframes[0].self_fip > 0
    assert np.isfinite(slam.frame_poses[-1]).all()
    poses, _ = slam.solve()
    assert len(poses) == 4


def test_slam_promotes_no_dropped_frame(root):
    slam, jslam = _slam_runs(root, range(DROP + 4))
    assert _keyframes(slam) == _keyframes(jslam)
    assert DROP not in _keyframes(slam)
    np.testing.assert_allclose(slam.frame_poses[DROP],
                               slam.frame_poses[DROP - 1])
    assert np.isfinite(slam.frame_poses[-1]).all()
