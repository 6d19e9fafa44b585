"""`cvo_rgbd_torch.stop_skew`, which replays bench.py's degraded
sequence pair by pair, must run `run_odometry`'s loop: on the CPU's
plain versions its pair rows chain into the trajectory `run_odometry`
writes (to the file's 6 decimals) at the same iterations, and its report
reads a replay on the same device as no skew at all."""

import os

import numpy as np
import pytest
import torch

from cvo_rgbd_torch.io.tum import load_assoc, read_trajectory
from cvo_rgbd_torch.odometry import run_odometry
from cvo_rgbd_torch.params import CvoParams
from cvo_rgbd_torch.stop_skew import (
    chain,
    compare,
    frontend_clouds,
    make_sequence,
    odometry_loop,
)

torch.set_num_threads(2)

N_FRAMES = 6


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("stop_skew")
    make_sequence(root, N_FRAMES)
    return root


def test_loop_is_run_odometry(folder, tmp_path):
    p = CvoParams(eps=5e-4, eps_2=1e-4, backend="fused")
    entries = load_assoc(os.path.join(folder, "assoc.txt"))
    rows, replays = odometry_loop(p, frontend_clouds(folder, entries, "cpu"),
                                  "cpu")
    assert replays is None and rows.shape == (N_FRAMES - 1, 19)
    out = str(tmp_path / "t.txt")
    recs = run_odometry(str(folder), 1, params=p, num_want=1024, output=out,
                        use_native=False, log=lambda *a: None, device="cpu")
    assert [int(r[16]) for r in rows] == [r.iterations for r in recs]
    got = chain(rows, [float(e.name) for e in entries])
    want = read_trajectory(out)
    assert sorted(got) == sorted(want)
    for t in want:
        np.testing.assert_allclose(got[t], want[t], rtol=0, atol=5e-6)


def test_replay_on_the_same_device_reads_no_skew(folder):
    s = compare(folder, 4, card="cpu", log=lambda *a: None)["summary"]
    assert s["frames"] == 4 and s["frontend"]["masks_equal"] == 4
    assert s["loops"]["first_pair_whose_stops_part"] is None
    assert s["replay"]["equal_stops"] == 3
    assert s["replay"]["equal_stops_tf_diff"] == 0.0
    assert len(set(s["ate"].values())) == 1
