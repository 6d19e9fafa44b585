"""The pose graph and the keyframe scores of the port's SLAM against the
JAX package, on the CPU.

`core.posegraph` (`from_odometry`, `graph_cost`, `optimize` with the
dense and PCG solvers, exact and robust) on the graphs of
tests/test_posegraph.py, and `keyframes` (scores, batched scores, the
post-align inner product, the selector) on the clouds of
tests/test_keyframes.py, each package on one graph or one set of clouds
built from the same numpy arrays.  tests/test_torch_slam.py holds
`KeyframeSlam` and `cli slam`.
"""

import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch import keyframes as tkf
from cvo_rgbd_torch.convert import cloud_from_numpy, posegraph_from_numpy
from cvo_rgbd_torch.core import posegraph as tpg
from cvo_rgbd_tpu import AcvoParams as JA
from cvo_rgbd_tpu import MATLAB_PARAMS as J_MATLAB
from cvo_rgbd_tpu import keyframes as jkf
from cvo_rgbd_tpu.core import posegraph as jpg

from test_keyframes import _cloud
from test_posegraph import _drifted_square_graph, _se3

torch.set_num_threads(2)


def _port(cloud):
    return cloud_from_numpy(*(np.asarray(a) for a in cloud), device="cpu")


def _graph(g):
    return posegraph_from_numpy(*(np.asarray(a) for a in g), device="cpu")


def _bad_edge_graph():
    """The robust-kernel fixture of tests/test_posegraph.py: a clean
    chain, three good loop edges and one wrong one."""
    gt = [np.eye(4, dtype=np.float32)]
    step = _se3([0, 0, 0.02], [0.25, 0, 0])
    for _ in range(12):
        gt.append(gt[-1] @ step)
    gt = np.stack(gt)
    good = [(0, 6, np.linalg.inv(gt[0]) @ gt[6], 5.0),
            (3, 9, np.linalg.inv(gt[3]) @ gt[9], 5.0),
            (0, 12, np.linalg.inv(gt[0]) @ gt[12], 5.0)]
    bad = [(0, 11, _se3([0, 0, 0.4], [0.5, 0.3, 0]), 5.0)]
    return jpg.from_odometry(gt, loop_edges=good + bad)


# ---- the pose graph --------------------------------------------------------


def test_from_odometry_and_graph_cost_match_jax():
    _, jg = _drifted_square_graph()
    nodes = np.asarray(jg.nodes)
    loops = [(0, 8, np.asarray(jg.edge_z)[-1], 10.0)]
    tg = tpg.from_odometry(nodes, loop_edges=loops, device="cpu")
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(float(tpg.graph_cost(tg)),
                               float(jpg.graph_cost(jg)), rtol=1e-5)


@pytest.mark.parametrize("graph,robust", [
    ("drifted_square", dict()),
    ("bad_edge", dict(huber_delta=0.15, robust="cauchy")),
    ("bad_edge", dict(huber_delta=0.3, robust="huber")),
    ("bad_edge", dict(huber_delta=0.3, robust="cauchy", robust_warmup=5)),
], ids=["exact", "cauchy", "huber", "graduated"])
@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_optimize_matches_jax(graph, solver, robust):
    jg = (_drifted_square_graph()[1] if graph == "drifted_square"
          else _bad_edge_graph())
    kw = dict(iters=10, solver=solver, **robust)
    if solver == "pcg":
        kw["cg_iters"] = 96
    j_nodes, j_costs = jpg.optimize(jg, **kw)
    t_nodes, t_costs = tpg.optimize(_graph(jg), **kw)
    # float32 Gauss-Newton in both; tests/test_posegraph.py holds pcg to
    # dense within 2e-4 (nodes) and 1e-3 (costs)
    np.testing.assert_allclose(t_nodes.numpy(), np.asarray(j_nodes),
                               atol=2e-4)
    np.testing.assert_allclose(t_costs.numpy(), np.asarray(j_costs),
                               rtol=1e-3, atol=1e-6)


# ---- keyframe scores -------------------------------------------------------


@pytest.mark.parametrize("jp", [JA(), J_MATLAB], ids=["acvo", "matlab"])
def test_keyframe_scores_match_jax(jp):
    tp = ct.AcvoParams() if isinstance(jp, JA) else ct.MATLAB_PARAMS
    rng = np.random.default_rng(3)
    clouds = [_cloud(np.random.default_rng(3), offset=off)
              for off in (0.0, 0.05, 0.2)]
    if jp is J_MATLAB:   # MATLAB colors are 0..255, 3 features
        clouds = [c._replace(features=np.asarray(c.features)[:, :3] * 255.0)
                  for c in clouds]
    ports = [_port(c) for c in clouds]
    for c, t in zip(clouds[1:], ports[1:]):
        np.testing.assert_allclose(
            tkf.keyframe_score(tp, ports[0], t),
            jkf.keyframe_score(jp, clouds[0], c), rtol=1e-5)
    selfs = [jkf.self_inner_product(jp, c) for c in clouds]
    np.testing.assert_allclose(
        [tkf.self_inner_product(tp, t) for t in ports], selfs, rtol=1e-5)
    np.testing.assert_allclose(
        tkf.keyframe_scores_batched(tp, ports[1:], ports[0], selfs[1:],
                                    selfs[0]),
        jkf.keyframe_scores_batched(jp, clouds[1:], clouds[0], selfs[1:],
                                    selfs[0]), rtol=1e-5)
    # the post-align inner product under K transforms
    tfs = [np.eye(4, dtype=np.float32) for _ in range(3)]
    tfs[1][:3, 3] = [0.05, 0.0, 0.0]
    tfs[2][:3, :3] = np.asarray(ct.se3.exp_so3(torch.tensor(
        [0.02, -0.01, 0.015])))
    tfs[2][:3, 3] = rng.normal(0.0, 0.02, 3)
    np.testing.assert_allclose(
        tkf.aligned_fip(tp, ports[0], ports[1], [torch.from_numpy(t)
                                                 for t in tfs]).numpy(),
        np.asarray(jkf.aligned_fip(jp, clouds[0], clouds[1], tfs)),
        rtol=1e-5)


def test_selector_matches_jax():
    rng = np.random.default_rng(5)
    clouds = [_cloud(rng, offset=off) for off in
              (0.0, 0.0, 1.0, 1.0, 0.02, 0.04, 0.06, 0.08)]
    policy = dict(threshold=0.9, max_span=3)
    js = jkf.KeyframeSelector(JA(), jkf.KeyframePolicy(**policy))
    ts = tkf.KeyframeSelector(ct.AcvoParams(), tkf.KeyframePolicy(**policy))
    for i, c in enumerate(clouds):
        jnew, jscore = js.update(i, c)
        tnew, tscore = ts.update(i, _port(c))
        assert jnew == tnew and ts.key_index == js.key_index, i
        np.testing.assert_allclose(tscore, jscore, rtol=1e-5)
