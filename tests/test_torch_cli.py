"""The rest of `cli run` and `cli slam` in the port, on the CPU.

`cli run --no-native-io` (PIL) and the native prefetch loader must write
the same trajectory, `--profile-dir` must write a trace, and `cli slam
--refine` must print the JAX package's lines.  The SLAM poses of the two
packages differ by their align backends (tests/test_torch_slam.py:
within 2e-3), and BA moves its costs with them (1.8% on the folder
below), so the port's BA costs are held against JAX's `refine_map` run
from the port's own keyframe poses, on the same keyframe clouds: the
same problem for both solvers, whose results agree within
tests/test_torch_ba.py's tolerances.
"""

import json
import re

import numpy as np
import pytest
import torch

from cvo_rgbd_torch.cli import main as t_cli
from cvo_rgbd_torch.io.tum import read_trajectory

from torch_scenes import make_parallax_folder

torch.set_num_threads(2)

NUM_WANT = 512
REFINE = re.compile(r"refine: BA cost (\S+) -> (\S+), (\d+) landmarks")
# BA tolerances of tests/test_torch_ba.py; a printed cost has 4
# significant digits, 5e-4 relative
POSE_TOL, COST_RTOL = 1e-4, 1e-3
# a prefix of tests/test_torch_slam.py's loop path: 2 keyframes
SLAM_FRAMES = 12


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_parallax_folder(tmp_path_factory.mktemp("cli_parallax"))


@pytest.mark.parametrize("batch", [1, 2])
def test_run_native_and_pil_write_the_same_trajectory(dataset, tmp_path,
                                                      batch):
    outs = []
    for flag in ([], ["--no-native-io"]):
        out = tmp_path / f"traj{len(outs)}.txt"
        t_cli(["run", str(dataset), "1", "--device", "cpu", "--num-want",
               str(NUM_WANT), "--max-frames", "3", "--batch", str(batch),
               "--output", str(out), *flag])
        outs.append(out.read_text())
    assert outs[0] == outs[1]
    assert len(outs[0].splitlines()) == 3


def test_run_profile_dir_writes_a_trace(dataset, tmp_path):
    """A Chrome trace of the run's CPU ops (on the CPU there is no
    device activity to require), and the run's own trajectory."""
    prof = tmp_path / "prof"
    out = tmp_path / "traj.txt"
    t_cli(["run", str(dataset), "1", "--device", "cpu", "--num-want", "256",
           "--max-frames", "2", "--output", str(out), "--profile-dir",
           str(prof)])
    files = list(prof.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert "aten::mm" in ops or "aten::matmul" in ops
    assert len(out.read_text().splitlines()) == 2


@pytest.fixture(scope="module")
def loop_prefix(tmp_path_factory):
    from cvo_rgbd_torch.io.export import depth_to_cloud, write_pcd
    from cvo_rgbd_torch.synth import BandScene, depth_loop_path, render_frames

    root = tmp_path_factory.mktemp("slam_prefix")
    scene = BandScene(120, 160)
    path = depth_loop_path(36, period=24, depth_amp_m=0.25)
    for i, (_, name, rgb, dep, _) in enumerate(render_frames(path, scene)):
        if i == SLAM_FRAMES:
            break
        write_pcd(root / f"{name}.pcd", *depth_to_cloud(rgb, dep, scene.cam))
    return root


def test_slam_refine_matches_jax(loop_prefix, tmp_path, capsys):
    from cvo_rgbd_torch.batch import load_pcd_dir, pad_clouds
    from cvo_rgbd_torch.params import MATLAB_PARAMS
    from cvo_rgbd_torch.slam import KeyframeSlam, SlamConfig
    from cvo_rgbd_tpu import MATLAB_PARAMS as J_MATLAB
    from cvo_rgbd_tpu import cli as jcli
    from cvo_rgbd_tpu import pad_cloud as j_pad_cloud
    from cvo_rgbd_tpu.batch import load_pcd_dir as j_load_pcd_dir
    from cvo_rgbd_tpu.core.cloud import round_up
    from cvo_rgbd_tpu.slam import KeyframeSlam as JSlam
    from cvo_rgbd_tpu.slam import SlamConfig as JConfig

    tout, jout = tmp_path / "port.txt", tmp_path / "jax.txt"
    t_cli(["slam", str(loop_prefix), "--refine", "--output", str(tout),
           "--device", "cpu"])
    tlines = capsys.readouterr().out.splitlines()
    jcli.main(["slam", str(loop_prefix), "--refine", "--output", str(jout)])
    jlines = capsys.readouterr().out.splitlines()
    assert tlines[0] == jlines[0] == (f"{SLAM_FRAMES} frames, 2 keyframes, "
                                      "0 loop closures")
    tm, jm = REFINE.fullmatch(tlines[1]), REFINE.fullmatch(jlines[1])
    assert tm and jm and tm[3] == jm[3]
    assert float(tm[2]) < float(tm[1])

    # the CLI's run, again through the API: the same nodes on the CPU
    clouds = load_pcd_dir(str(loop_prefix))
    ts = KeyframeSlam(MATLAB_PARAMS, SlamConfig(), device="cpu")
    for i, c in enumerate(pad_clouds(clouds, torch.device("cpu"))):
        ts.process(i, c)
    poses, nodes = ts.solve()
    kf_ba, lms, costs = (t.numpy() for t in ts.refine_map(kf_poses=nodes))
    assert tm[1] == f"{costs[0]:.3e}" and tm[2] == f"{costs[-1]:.3e}"
    assert int(tm[3]) == lms.shape[0]

    # JAX's refine_map on the same keyframe clouds and poses
    jclouds = j_load_pcd_dir(str(loop_prefix))
    cap = round_up(max(p.shape[0] for _, p, _ in jclouds))
    js = JSlam(J_MATLAB, JConfig())
    for i, (_, p_, c_) in enumerate(jclouds):
        js.process(i, j_pad_cloud(p_, c_, capacity=cap))
    assert [k.index for k in js.keyframes] == [k.index for k in ts.keyframes]
    ref = [np.asarray(a) for a in js.refine_map(
        kf_poses=nodes.astype(np.float32))]
    np.testing.assert_allclose(kf_ba, ref[0], rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(lms, ref[1], rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(costs, ref[2], rtol=COST_RTOL)

    # every frame follows its keyframe's correction, as JAX's CLI does it
    corr = {k.index: kf_ba[i] @ np.linalg.inv(nodes[i])
            for i, k in enumerate(ts.keyframes)}
    want = [corr[ts.keyframes[ts.frame_keyframe[i]].index] @ pose
            for i, pose in enumerate(poses)]
    got = read_trajectory(tout)
    assert len(got) == SLAM_FRAMES
    for g, w in zip((got[k] for k in sorted(got)), want):
        np.testing.assert_allclose(g, w, atol=1e-6)
