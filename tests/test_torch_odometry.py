"""The port's odometry driver and CLI against the JAX package's.

The 6-frame lateral-parallax folder of tests/test_odometry.py, run
through `python -m cvo_rgbd_torch.cli run --device cpu`.  The JAX side
runs its default dense backend: under jit, its Pallas path kd-sorts
with XLA:CPU, which duplicates points (ROADMAP, queue 3), so the dense
path is the sound reference on the CPU, within 1e-3.
"""

import io

import numpy as np
import pytest
import torch

from cvo_rgbd_torch import synth as tsynth
from cvo_rgbd_torch.cli import main as t_cli
from cvo_rgbd_torch.evaluation import ate_rmse
from cvo_rgbd_torch.io.tum import parse_trajectory, read_trajectory
from cvo_rgbd_torch.odometry import run_odometry, run_odometry_frames
from cvo_rgbd_tpu.odometry import run_odometry as j_run_odometry

from torch_scenes import H, N_FRAMES, W, make_parallax_folder

torch.set_num_threads(2)

NUM_WANT = 1024


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_parallax_folder(tmp_path_factory.mktemp("torch_tumsynth"))


@pytest.fixture(scope="module")
def port_run(dataset):
    out = dataset / "torch_poses.txt"
    t_cli(["run", str(dataset), "1", "--device", "cpu",
           "--num-want", str(NUM_WANT), "--output", str(out)])
    return read_trajectory(out)


def _pair_tfs(traj):
    keys = sorted(traj)
    return [np.linalg.inv(traj[a]) @ traj[b] for a, b in zip(keys, keys[1:])]


def test_cli_run_matches_jax(dataset, port_run, tmp_path):
    ref_out = tmp_path / "jax.txt"
    j_run_odometry(str(dataset), 1, num_want=NUM_WANT, output=str(ref_out),
                   log=lambda *a: None)
    ref = read_trajectory(ref_out)
    assert set(port_run) == set(ref) and len(ref) == N_FRAMES
    for got, want in zip(_pair_tfs(port_run), _pair_tfs(ref)):
        np.testing.assert_allclose(got, want, atol=1e-3)
    gt = read_trajectory(dataset / "groundtruth.txt")
    # the JAX suite's bound for this folder (tests/test_odometry.py)
    assert ate_rmse(gt, port_run)["rmse"] < 0.012


def test_jax_checkpoint_resumes_in_the_port(dataset, port_run, tmp_path):
    out = tmp_path / "resumed.txt"
    ckpt = tmp_path / "ckpt.json"
    j_run_odometry(str(dataset), 1, num_want=NUM_WANT, output=str(out),
                   checkpoint=str(ckpt), max_frames=3, log=lambda *a: None)
    records = run_odometry(str(dataset), 1, num_want=NUM_WANT,
                           output=str(out), checkpoint=str(ckpt),
                           log=lambda *a: None, device="cpu")
    assert [r.index for r in records] == list(range(3, N_FRAMES))
    resumed = read_trajectory(out)
    assert set(resumed) == set(port_run)
    # the first pairs and the warm state came from the JAX dense run
    for t in port_run:
        np.testing.assert_allclose(resumed[t], port_run[t], atol=1e-3)


def test_in_memory_frames_match_png_folder(tmp_path):
    """`synth.render_frames` yields exactly what `make_tum_dataset`
    writes, and the trajectory does not depend on the fetch cadence."""
    path = tsynth.revisit_path(4, period=33)
    scene = tsynth.BandScene(h=H, w=W)
    tsynth.make_tum_dataset(tmp_path, path, scene)
    out = tmp_path / "png.txt"
    rec_png = run_odometry(str(tmp_path), 1, num_want=512, output=str(out),
                           fetch_every=3, log=lambda *a: None, device="cpu")
    traj = io.StringIO()
    frames = ((i, n, rgb, dep)
              for i, n, rgb, dep, _ in tsynth.render_frames(path, scene))
    rec_mem = run_odometry_frames(frames, 1, traj=traj, num_want=512,
                                  fetch_every=1, log=lambda *a: None,
                                  device="cpu")
    assert [r.iterations for r in rec_mem] == [r.iterations for r in rec_png]
    mem = parse_trajectory(traj.getvalue().splitlines())
    png = read_trajectory(out)
    assert set(mem) == set(png)
    for t in png:
        np.testing.assert_array_equal(mem[t], png[t])
