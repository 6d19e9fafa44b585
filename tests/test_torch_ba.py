"""Bundle adjustment in the port against the JAX package, on the CPU.

`make_ba_problem` and `ba_from_keyframes` must give the JAX package's
arrays (indices exactly, floats within 1e-6), and `ba_cost` and the
single-device `ba_solve` its values on the synthetic problems of
tests/test_ba.py (clean, noisy, partial observations): both solvers take
one problem, passed as numpy arrays (`convert.ba_problem_from_numpy`).

Tolerances: poses and landmarks within 1e-4, costs within 1e-3
relative (with an absolute floor of 1e-7 for the clean problem, whose
last costs are float32 noise around zero).  The scatter-adds sum in
another order in each package, so the float32 solves part in the last
bits; Gauss-Newton contracts that, and the float64 solve of the port
(below) lies within the same bound of both.
"""

import numpy as np
import pytest
import torch

from cvo_rgbd_torch import parallel as tpar
from cvo_rgbd_torch.convert import ba_problem_from_numpy, cloud_from_numpy
from cvo_rgbd_torch.parallel import ba as tba
from cvo_rgbd_tpu import pad_cloud
from cvo_rgbd_tpu import se3 as jse3
from cvo_rgbd_tpu.parallel import ba as jba

from test_ba import _synthetic

torch.set_num_threads(2)

POSE_TOL = 1e-4
COST_RTOL = 1e-3
COST_ATOL = 1e-7


def _np(problem):
    return [np.asarray(f) for f in problem]


def _port(problem):
    return ba_problem_from_numpy(*_np(problem), device="cpu")


def _problem(rng, kind):
    if kind == "clean":
        problem, _, _ = _synthetic(rng)
    elif kind == "noisy":
        problem, _, _ = _synthetic(rng, noise=0.005)
    else:  # partial: landmark 7 unobserved
        problem, _, _ = _synthetic(rng, k=4, m=30)
        w = np.asarray(problem.obs_w).copy()
        w[np.asarray(problem.obs_lm) == 7] = 0.0
        problem = problem._replace(obs_w=w.astype(np.float32))
    return problem


def _same_arrays(port, jax_problem):
    for name, a, b in zip(tba.BAProblem._fields, port, _np(jax_problem)):
        a = a.cpu().numpy()
        assert a.shape == b.shape, name
        if name in tba._INDEX_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("pad", [None, (97, 41)])
def test_make_ba_problem_gives_jax_arrays(rng, pad):
    """Duplicate (pose, landmark) observations merge into one edge; the
    padding of observations and landmarks is the JAX package's."""
    k, m, o = 5, 37, 90
    poses = np.stack([np.asarray(jse3.exp_se3(
        rng.normal(0, 0.2, 6).astype(np.float32))) for _ in range(k)])
    lms = rng.normal(0, 1, (m, 3)).astype(np.float32)
    obs_pose = rng.integers(0, k, o)
    obs_lm = rng.integers(0, m, o)
    obs_z = rng.normal(0, 1, (o, 3)).astype(np.float32)
    obs_w = rng.uniform(0.5, 1.5, o).astype(np.float32)
    kw = {} if pad is None else dict(pad_to=pad[0], pad_landmarks_to=pad[1])
    args = (poses, lms, obs_pose, obs_lm, obs_z, obs_w)
    ref = jba.make_ba_problem(*args, **kw)
    assert np.asarray(ref.edge_pose).shape[0] < o
    _same_arrays(tba.make_ba_problem(*args, **kw, device="cpu"), ref)


@pytest.mark.parametrize("feature_weight", [2.0, 0.0])
def test_ba_from_keyframes_gives_jax_arrays(rng, feature_weight):
    """Keyframe clouds along a trajectory (tests/test_ba.py's harvest
    scene, with textured features): the same landmarks, observations
    and edges."""
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32) + [0, 0, 2.5]
    feat = rng.uniform(0, 255, (200, 5)).astype(np.float32)
    poses, jclouds, tclouds = [], [], []
    for _ in range(4):
        xi = np.concatenate([rng.normal(0, 0.05, 3),
                             rng.normal(0, 0.2, 3)]).astype(np.float32)
        T = np.asarray(jse3.exp_se3(xi))
        poses.append(T)
        local = ((pts - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
        c = pad_cloud(local, feat, capacity=256)
        jclouds.append(c)
        tclouds.append(cloud_from_numpy(*(np.asarray(f) for f in c),
                                        device="cpu"))
    poses = np.stack(poses)
    kw = dict(grid=0.3, radius=0.25, feature_weight=feature_weight)
    ref = jba.ba_from_keyframes(jclouds, poses, **kw)
    got = tba.ba_from_keyframes(tclouds, poses, **kw, device="cpu")
    assert ref is not None and got is not None
    _same_arrays(got, ref)


def test_ba_from_keyframes_without_observations_is_none():
    """Keyframes that share no landmark give no problem."""
    far = np.eye(4, dtype=np.float32)
    far[0, 3] = 100.0
    pos = np.random.default_rng(0).uniform(-1, 1, (50, 3)) + [0, 0, 3]
    c = cloud_from_numpy(*(np.asarray(f) for f in pad_cloud(
        pos.astype(np.float32), np.zeros((50, 5), np.float32),
        capacity=128)), device="cpu")
    assert tba.ba_from_keyframes([c, c], np.stack([np.eye(4), far]),
                                 grid=0.3, radius=0.05,
                                 device="cpu") is None


@pytest.mark.parametrize("kind", ["clean", "noisy", "partial"])
def test_ba_cost_matches_jax(rng, kind):
    problem = _problem(rng, kind)
    ref = float(jba.ba_cost(problem))
    got = float(tba.ba_cost(_port(problem), device="cpu"))
    assert got == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("kind", ["clean", "noisy", "partial"])
def test_ba_solve_matches_jax(rng, kind):
    problem = _problem(rng, kind)
    rp, rl, rc = (np.asarray(a) for a in jba.ba_solve(problem, iters=8))
    tp, tl, tc = (a.numpy() for a in tpar.ba_solve(_port(problem), iters=8,
                                                    device="cpu"))
    np.testing.assert_allclose(tp, rp, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(tl, rl, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(tc, rc, rtol=COST_RTOL, atol=COST_ATOL)
    assert tc[-1] <= tc[0]
    if kind == "partial":
        # an unobserved landmark has no constraint: it must not move
        np.testing.assert_allclose(tl[7], np.asarray(problem.landmarks)[7],
                                   atol=1e-5)


def test_ba_solve_float32_stays_by_a_float64_solve(rng):
    """The float32 solve on the noisy problem lies within POSE_TOL of
    the same solve in float64: the bound the JAX comparison uses is not
    float32 noise of either side."""
    problem = _port(_problem(rng, "noisy"))
    p64 = tba.BAProblem(*(t.double() if t.is_floating_point() else t
                          for t in problem))
    a = tba.ba_solve(problem, iters=8, device="cpu")
    b = tba.ba_solve(p64, iters=8, device="cpu")
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                   atol=POSE_TOL)


def test_ba_solve_recovers_ground_truth(rng):
    """tests/test_ba.py::test_ba_recovers_ground_truth on the port."""
    problem, gt_poses, gt_lms = _synthetic(rng)
    poses, lms, costs = tba.ba_solve(_port(problem), iters=12, device="cpu")
    np.testing.assert_allclose(poses.numpy(), gt_poses, atol=1e-3)
    np.testing.assert_allclose(lms.numpy(), gt_lms, atol=1e-3)
    assert float(costs[-1]) < 1e-8


def test_ba_solve_over_a_mesh_raises(rng):
    problem = _port(_problem(rng, "clean"))
    with pytest.raises(NotImplementedError, match="Multi-device"):
        tba.ba_solve(problem, mesh=object(), device="cpu")
