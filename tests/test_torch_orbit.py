"""Rotation-rich odometry on the orbit path, the port against JAX.

`synth.linear_orbit_path` yaws and pitches every frame about a pivot,
so every pair carries rotation (tests/test_odometry_rotation.py).  The
port's path must be JAX's, and its trajectory, on the default kernel
backend's plain versions, must keep JAX's per-pair transforms within
3e-4 (the stop skew at the C++ stops) and the rotation test's bounds:
ATE < 0.015 m / < 0.02 m and the largest rotation error < 25 / 30 mrad
for cvo / acvo.
"""

import numpy as np
import pytest
import torch

from cvo_rgbd_torch.cli import main as t_cli
from cvo_rgbd_torch.evaluation import ate_rmse, rotation_errors_mrad
from cvo_rgbd_torch.io.tum import read_trajectory
from cvo_rgbd_torch.odometry import run_odometry
from cvo_rgbd_torch.synth import BandScene, linear_orbit_path, make_tum_dataset

torch.set_num_threads(2)

N_FRAMES = 6
NUM_WANT = 1024
TF_TOL = 3e-4
# (ATE m, rotation mrad) bounds of tests/test_odometry_rotation.py
BOUNDS = {False: (0.015, 25.0), True: (0.02, 30.0)}


@pytest.fixture(scope="module")
def orbit(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbit")
    make_tum_dataset(root, linear_orbit_path(N_FRAMES, 0.8, 0.15),
                     BandScene(u_pad=80, v_pad=16))
    return root


def test_orbit_path_is_jax_path():
    from cvo_rgbd_tpu.synth import linear_orbit_path as jax_orbit

    got, want = linear_orbit_path(9, 1.3, -0.4), jax_orbit(9, 1.3, -0.4)
    for f in ("yaw", "pitch", "offset"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def _pair_tfs(traj):
    ts = sorted(traj)
    return [np.linalg.inv(traj[a]) @ traj[b] for a, b in zip(ts, ts[1:])]


@pytest.mark.parametrize("adaptive", [False, True], ids=["cvo", "acvo"])
def test_orbit_odometry_matches_jax(orbit, tmp_path, capsys, adaptive):
    from cvo_rgbd_tpu.odometry import run_odometry as jax_run

    out, jout = tmp_path / "t.txt", tmp_path / "j.txt"
    recs = run_odometry(str(orbit), 1, adaptive=adaptive, num_want=NUM_WANT,
                        output=str(out), use_native=False,
                        log=lambda *a: None, device="cpu")
    jax_run(str(orbit), 1, adaptive=adaptive, num_want=NUM_WANT,
            output=str(jout), use_native=False, log=lambda *a: None)
    assert len(recs) == N_FRAMES - 1 and not any(r.failed for r in recs)
    est, jest = read_trajectory(out), read_trajectory(jout)
    assert len(est) == N_FRAMES
    for got, want in zip(_pair_tfs(est), _pair_tfs(jest)):
        np.testing.assert_allclose(got, want, rtol=0, atol=TF_TOL)

    gt = read_trajectory(orbit / "groundtruth.txt")
    ate_bound, rot_bound = BOUNDS[adaptive]
    rmse = ate_rmse(gt, est)["rmse"]
    assert rmse < ate_bound
    assert max(rotation_errors_mrad(gt, est)) < rot_bound
    # the quaternion writer round-trips through the evaluate-ate CLI
    capsys.readouterr()
    t_cli(["evaluate-ate", str(orbit / "groundtruth.txt"), str(out)])
    np.testing.assert_allclose(float(capsys.readouterr().out), rmse,
                               rtol=1e-4)
