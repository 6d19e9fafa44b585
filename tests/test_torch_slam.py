"""Keyframe SLAM in the port against the JAX package, on the CPU.

`KeyframeSlam` (`process`, `process_batch`, skip-and-mark of degenerate
frames, `solve`) on the square-loop world of tests/test_slam.py, and
`cli slam` on a small rendered .pcd folder whose path comes back to its
start; each package on the same numpy clouds.  The pose graph and the
keyframe scores are held in tests/test_torch_posegraph.py.

The JAX aligns run on its "xla" backend (its default, and the one its
`cli slam` takes); the port's on its default "kernel" backend, whose
plain versions sum in another order, so poses are held within POSE_TOL
at the MATLAB stops (each align within 3e-4, chained over frames) and
keyframes and loop edges exactly: promotion scores do not depend on the
poses, and the loop gates are far wider than the skew.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch import keyframes as tkf
from cvo_rgbd_torch.convert import cloud_from_numpy, slam_config_from_jax_dict
from cvo_rgbd_torch.slam import KeyframeSlam as TSlam
from cvo_rgbd_tpu import CvoParams as JC
from cvo_rgbd_tpu import keyframes as jkf
from cvo_rgbd_tpu import pad_cloud
from cvo_rgbd_tpu.slam import KeyframeSlam as JSlam
from cvo_rgbd_tpu.slam import SlamConfig as JConfig

from test_slam import make_world, observe, square_loop_poses

torch.set_num_threads(2)

MATLAB_STOPS = dict(eps=5e-4, eps_2=1e-4)
# a frame's pose: the aligns' 3e-4 stop skew, chained over a few frames
POSE_TOL = 2e-3


def _port(cloud):
    return cloud_from_numpy(*(np.asarray(a) for a in cloud), device="cpu")


# ---- KeyframeSlam on the square-loop world ---------------------------------


def _config(**kw):
    cfg = JConfig(keyframe=jkf.KeyframePolicy(threshold=0.995, max_span=2),
                  loop_min_separation=3, loop_score_threshold=0.5, **kw)
    return cfg, slam_config_from_jax_dict(dataclasses.asdict(cfg))


def _check_slams(js, ts):
    assert [k.index for k in ts.keyframes] == [k.index for k in js.keyframes]
    assert ([(i, j) for i, j, _, _ in ts.loop_edges]
            == [(i, j) for i, j, _, _ in js.loop_edges])
    assert len(ts.loop_edges) >= 1
    for a, b in zip(ts.loop_edges, js.loop_edges):
        np.testing.assert_allclose(a[2], np.asarray(b[2]), atol=POSE_TOL)
    np.testing.assert_allclose(np.stack(ts.frame_poses),
                               np.stack(js.frame_poses), atol=POSE_TOL)
    t_poses, t_nodes = ts.solve()
    j_poses, j_nodes = js.solve()
    np.testing.assert_allclose(np.stack(t_poses), np.stack(j_poses),
                               atol=POSE_TOL)
    np.testing.assert_allclose(t_nodes, np.asarray(j_nodes), atol=POSE_TOL)


def test_slam_config_converts():
    cfg, tcfg = _config(optimize_iters=7)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert isinstance(tcfg.keyframe, tkf.KeyframePolicy)


def test_keyframe_slam_matches_jax():
    world, feat = make_world(np.random.default_rng(0), n=250)
    clouds = [observe(world, feat, T, cap=256) for T in square_loop_poses()]
    cfg, tcfg = _config()
    js = JSlam(JC(max_iter=150, **MATLAB_STOPS), cfg)
    ts = TSlam(ct.CvoParams(max_iter=150, **MATLAB_STOPS), tcfg,
               device="cpu")
    for i, c in enumerate(clouds):
        jpose = js.process(i, c)
        tpose = ts.process(i, _port(c))
        np.testing.assert_allclose(tpose, jpose, atol=POSE_TOL)
    _check_slams(js, ts)


def test_keyframe_slam_process_batch_matches_jax():
    world, feat = make_world(np.random.default_rng(1), n=250)
    clouds = [observe(world, feat, T, cap=256) for T in square_loop_poses()]
    cfg, tcfg = _config()
    js = JSlam(JC(max_iter=150, **MATLAB_STOPS), cfg)
    ts = TSlam(ct.CvoParams(max_iter=150, **MATLAB_STOPS), tcfg,
               device="cpu")
    for s in range(0, len(clouds), 4):
        group = range(s, min(s + 4, len(clouds)))
        jout = js.process_batch([(i, clouds[i]) for i in group])
        tout = ts.process_batch([(i, _port(clouds[i])) for i in group])
        np.testing.assert_allclose(np.stack(tout), np.stack(jout),
                                   atol=POSE_TOL)
    _check_slams(js, ts)


def test_degenerate_frames_are_skipped_and_marked():
    """A frame with too few points is never a keyframe: the first seeds
    nothing, a later one carries the previous frame's pose."""
    world, feat = make_world(np.random.default_rng(2), n=200)
    good = [observe(world, feat, T, cap=256) for T in square_loop_poses(1)]
    empty = pad_cloud(np.zeros((10, 3), np.float32), capacity=256)
    frames = [empty, good[0], good[1], empty, good[2]]
    cfg, tcfg = _config()
    js = JSlam(JC(max_iter=100, **MATLAB_STOPS), cfg)
    ts = TSlam(ct.CvoParams(max_iter=100, **MATLAB_STOPS), tcfg,
               device="cpu")
    for i, c in enumerate(frames):
        js.process(i, c)
        ts.process(i, _port(c))
    assert [k.index for k in ts.keyframes] == [k.index for k in js.keyframes]
    assert 0 not in [k.index for k in ts.keyframes]
    np.testing.assert_allclose(ts.frame_poses[3], ts.frame_poses[2])
    np.testing.assert_allclose(np.stack(ts.frame_poses),
                               np.stack(js.frame_poses), atol=POSE_TOL)


def test_refine_map_is_not_ported():
    ts = TSlam(ct.CvoParams(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 5"):
        ts.refine_map()


# ---- cli slam --------------------------------------------------------------


@pytest.fixture(scope="module")
def loop_dir(tmp_path_factory):
    """A .pcd folder of a path that moves along the optical axis and
    comes back: with the default SlamConfig, JAX's `cli slam` promotes 6
    keyframes and closes 2 loops on it."""
    from cvo_rgbd_torch.io.export import depth_to_cloud, write_pcd
    from cvo_rgbd_torch.synth import BandScene, depth_loop_path, render_frames

    root = tmp_path_factory.mktemp("slam_pcd")
    scene = BandScene(120, 160)
    path = depth_loop_path(36, period=24, depth_amp_m=0.25)
    for _, name, rgb, dep, _ in render_frames(path, scene):
        write_pcd(root / f"{name}.pcd", *depth_to_cloud(rgb, dep, scene.cam))
    return root


def test_cli_slam_matches_jax(loop_dir, tmp_path, capsys):
    from cvo_rgbd_torch import cli as tcli
    from cvo_rgbd_torch.io.tum import read_trajectory
    from cvo_rgbd_tpu import cli as jcli

    jout, tout = tmp_path / "jax.txt", tmp_path / "port.txt"
    jcli.main(["slam", str(loop_dir), "--output", str(jout)])
    jline = capsys.readouterr().out.splitlines()[0]
    tcli.main(["slam", str(loop_dir), "--output", str(tout), "--device",
               "cpu"])
    tline = capsys.readouterr().out.splitlines()[0]
    assert tline == jline == "36 frames, 6 keyframes, 2 loop closures"
    jt, tt = read_trajectory(jout), read_trajectory(tout)
    assert list(tt) == list(jt) and len(tt) == 36
    for k in jt:
        np.testing.assert_allclose(tt[k], jt[k], atol=POSE_TOL)
    with pytest.raises(SystemExit, match="ROADMAP queue 1, item 5"):
        tcli.main(["slam", str(loop_dir), "--refine", "--device", "cpu"])
