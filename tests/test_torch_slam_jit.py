"""The compiled forms of `cli slam`'s work outside align, on the CPU.

The JAX package jits its keyframe inner products (`_compiled_fip`,
`_compiled_fip_batched`, `_compiled_aligned_fip`), `_compiled_cloud_ok`,
`_compiled_slam_step`, the pose-graph solves (`_optimize_dense`,
`_optimize_pcg`), `_ba_single` and multiseq's `_compiled_lane_post`.  The
port runs each as a captured program (`core.compiled.program_for`) or a
captured Gauss-Newton iteration (`core.compiled.CapturedLoop`); on the
CPU the same functions run uncaptured on the same static tensors.  Each
JAX function runs here on numpy inputs made from a seed, against its
port counterpart on `device="cpu"`, at the tolerances of
tests/test_torch_posegraph.py, tests/test_torch_ba.py and
tests/test_torch_slam.py; and the port's compiled forms against the
eager loops they replace, bit for bit, with their keying.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch import keyframes as tkf
from cvo_rgbd_torch import multiseq as tms
from cvo_rgbd_torch import slam as tslam
from cvo_rgbd_torch.convert import (
    ba_problem_from_numpy,
    cloud_from_numpy,
    posegraph_from_numpy,
)
from cvo_rgbd_torch.core import compiled
from cvo_rgbd_torch.core import posegraph as tpg
from cvo_rgbd_torch.core.cloud import stack_clouds as t_stack
from cvo_rgbd_torch.parallel import ba as tba
from cvo_rgbd_tpu import AcvoParams as JA
from cvo_rgbd_tpu import CvoParams as JC
from cvo_rgbd_tpu import MATLAB_PARAMS as J_MATLAB
from cvo_rgbd_tpu import keyframes as jkf
from cvo_rgbd_tpu import multiseq as jms
from cvo_rgbd_tpu import pad_cloud
from cvo_rgbd_tpu import slam as jslam
from cvo_rgbd_tpu.core import posegraph as jpg
from cvo_rgbd_tpu.core.cloud import stack_clouds as j_stack
from cvo_rgbd_tpu.parallel import ba as jba

from test_ba import _synthetic
from test_slam import make_world, observe, square_loop_poses
from test_torch_posegraph import _bad_edge_graph

torch.set_num_threads(2)

MATLAB_STOPS = dict(eps=5e-4, eps_2=1e-4)
SLAM_POSE_TOL = 2e-3      # tests/test_torch_slam.py
FIP_RTOL = 1e-5           # tests/test_torch_posegraph.py
GRAPH_TOL, GRAPH_COST_RTOL = 2e-4, 1e-3
BA_TOL, BA_COST_RTOL, BA_COST_ATOL = 1e-4, 1e-3, 1e-7   # test_torch_ba.py


def _port(cloud):
    return cloud_from_numpy(*(np.asarray(a) for a in cloud), device="cpu")


def _clouds(mode, cap, k, seed=3):
    """k clouds of 200 points at capacity `cap`, each a shifted copy of
    one random cloud: se features (5, in [0, 0.5]) or MATLAB's linear
    ones (3, 0..255)."""
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((200, 3)).astype(np.float32) * 0.4
    feat = rng.random((200, 5)).astype(np.float32) * 0.5
    if mode == "linear":
        feat = feat[:, :3] * 510.0
    out = []
    for q in range(k):
        shift = np.array([0.03 * q, -0.01 * q, 0.02 * q], np.float32)
        out.append(pad_cloud(pos + shift, feat, capacity=cap))
    return out


def _params(mode):
    return (J_MATLAB, ct.MATLAB_PARAMS) if mode == "linear" else (
        JA(), ct.AcvoParams())


def _programs(name):
    return {k: v for k, v in compiled.PROGRAMS.items() if k[0] == name}


def _runs(name):
    return sum(p.runs for p in _programs(name).values())


# ---- the keyframe inner products --------------------------------------------


@pytest.mark.parametrize("cap", [256, 384])
@pytest.mark.parametrize("mode", ["se", "linear"])
def test_compiled_fip_matches_jax(mode, cap):
    jp, tp = _params(mode)
    a, b = _clouds(mode, cap, 2)
    ta, tb = _port(a), _port(b)
    fip = jkf._compiled_fip(jp)
    for (ja, jb), (xa, xb) in (((a, b), (ta, tb)), ((a, a), (ta, ta)),
                               ((b, a), (tb, ta))):
        got = tkf.inner_product_async(tp, xa, xb)
        assert got.dim() == 0
        np.testing.assert_allclose(float(got), float(fip(ja, jb)),
                                   rtol=FIP_RTOL)
    assert tkf.self_inner_product(tp, ta) == pytest.approx(
        float(fip(a, a)), rel=FIP_RTOL)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("mode", ["se", "linear"])
def test_scores_replay_one_pair_program_as_jax_vmaps(mode, k):
    """`keyframe_scores_batched`: K replays of the one-pair program
    against JAX's vmapped program (padded to 32 lanes), the raw cross
    products and the scores."""
    jp, tp = _params(mode)
    clouds = _clouds(mode, 256, k + 1, seed=4)
    cands, cloud = clouds[1:], clouds[0]
    ports = [_port(c) for c in clouds]
    ref = np.asarray(jkf._compiled_fip_batched(jp)(j_stack(cands), cloud))
    got = [float(tkf.inner_product_async(tp, c, ports[0]))
           for c in ports[1:]]
    np.testing.assert_allclose(got, ref, rtol=FIP_RTOL)
    selfs = [float(jkf._compiled_fip(jp)(c, c)) for c in clouds]
    runs = _runs("the cross inner product")
    scores = tkf.keyframe_scores_batched(tp, ports[1:], ports[0], selfs[1:],
                                         selfs[0])
    assert _runs("the cross inner product") == runs + k
    assert scores.shape == (k,) and scores.dtype == np.float32
    np.testing.assert_allclose(
        scores, jkf.keyframe_scores_batched(jp, cands, cloud, selfs[1:],
                                            selfs[0]), rtol=FIP_RTOL)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("mode", ["se", "linear"])
def test_aligned_fip_matches_jax(mode, k):
    jp, tp = _params(mode)
    a, b = _clouds(mode, 384, 2, seed=5)
    rng = np.random.default_rng(k)
    tfs = np.stack([np.eye(4, dtype=np.float32)] * k)
    for q in range(1, k):
        tfs[q, :3, :3] = ct.se3.exp_so3(torch.tensor(
            rng.normal(0.0, 0.02, 3), dtype=torch.float32)).numpy()
        tfs[q, :3, 3] = rng.normal(0.0, 0.03, 3)
    ref = np.asarray(jkf._compiled_aligned_fip(jp)(a, b, jnp.asarray(tfs)))
    runs = _runs("the moved inner product")
    got = tkf.aligned_fip(tp, _port(a), _port(b), torch.from_numpy(tfs))
    assert _runs("the moved inner product") == runs + k
    np.testing.assert_allclose(got.numpy(), ref, rtol=FIP_RTOL)
    # a sequence of [4,4] gives the stacked call's bits
    seq = tkf.aligned_fip(tp, _port(a), _port(b), list(tfs))
    assert torch.equal(seq, got)


def test_inner_product_programs_have_the_bits_of_the_eager_ops():
    """The programs run the very ops of `function_inner_product`."""
    from cvo_rgbd_torch.core.registration import function_inner_product

    tp = ct.MATLAB_PARAMS
    a, b = (_port(c) for c in _clouds("linear", 256, 2, seed=6))
    for x, y in ((a, b), (a, a)):
        assert torch.equal(tkf.inner_product_async(tp, x, y),
                           function_inner_product(tp, x, y))
    tf = torch.eye(4)
    tf[:3, 3] = torch.tensor([0.02, 0.0, -0.01])
    moved = b._replace(positions=b.positions @ tf[:3, :3].T + tf[:3, 3])
    assert torch.equal(tkf.aligned_fip(tp, a, b, [tf])[0],
                       function_inner_product(tp, a, moved))


def test_inner_product_programs_are_keyed_by_capacity_and_params():
    """A second call of a key builds nothing; another capacity, params
    or form builds its own program; a run counts; a program refuses
    inputs of another shape."""
    tp = ct.AcvoParams(ell_init=0.21)
    a, b = (_port(c) for c in _clouds("se", 256, 2, seed=7))
    c, d = (_port(c) for c in _clouds("se", 384, 2, seed=7))
    before = len(compiled.PROGRAMS)
    tkf.inner_product_async(tp, a, b)
    assert len(compiled.PROGRAMS) == before + 1
    program = list(compiled.PROGRAMS.values())[-1]
    assert program.runs == 1
    tkf.inner_product_async(tp, b, a)
    assert len(compiled.PROGRAMS) == before + 1 and program.runs == 2
    tkf.inner_product_async(tp, c, d)
    tkf.inner_product_async(tp, a, a)
    tkf.inner_product_async(dataclasses.replace(tp, ell_init=0.2), a, b)
    assert len(compiled.PROGRAMS) == before + 4
    with pytest.raises(ValueError, match=r"compiled for .*\(256, 3\)"):
        program(*c, *d)


# ---- cloud_ok and the SLAM step ---------------------------------------------


def test_compiled_cloud_ok_matches_jax():
    rng = np.random.default_rng(8)
    pos = rng.standard_normal((120, 3)).astype(np.float32)
    nan_valid = pos.copy()
    nan_valid[5] = np.nan
    cases = {
        "good": pad_cloud(pos, capacity=256),
        "few points": pad_cloud(pos[:40], capacity=256),
        "NaN in a valid slot": pad_cloud(nan_valid, capacity=256),
        "empty": pad_cloud(np.zeros((0, 3), np.float32), capacity=256),
    }
    # a NaN in a padding slot does not count
    good = cases["good"]
    cases["NaN in padding"] = good._replace(
        positions=jnp.asarray(good.positions).at[200].set(jnp.nan))
    want = {"good": True, "few points": False, "NaN in a valid slot": False,
            "empty": False, "NaN in padding": True}
    for name, cloud in cases.items():
        ref = bool(jslam._compiled_cloud_ok(64)(cloud))
        got = tslam._compiled_cloud_ok(_port(cloud), 64)
        assert got.dtype == torch.bool and got.dim() == 0
        assert bool(got) == ref == want[name], name
    assert not bool(tslam._compiled_cloud_ok(_port(good), 121))


@pytest.fixture(scope="module")
def loop_pair():
    """Two frames of tests/test_slam.py's square loop, a keyframe and a
    frame two steps on."""
    world, feat = make_world(np.random.default_rng(0), n=250)
    poses = square_loop_poses()
    return [observe(world, feat, poses[i], cap=256) for i in (0, 2)]


def test_slam_step_matches_jax(loop_pair):
    """`_slam_step` (align_jit, then one captured program) against JAX's
    `_compiled_slam_step` from a cold start."""
    key, cloud = loop_pair
    jp = JC(max_iter=150, **MATLAB_STOPS)
    tp = ct.CvoParams(max_iter=150, **MATLAB_STOPS)
    jstep = jslam._compiled_slam_step(jp, False, 64)
    warm_j = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
              np.float32(jp.ell_init))
    warm_t = tuple(torch.from_numpy(np.asarray(w)) for w in warm_j)
    ref = [np.asarray(v) for v in jstep(key, cloud, *warm_j)]
    runs = _runs("the SLAM step")
    got = tslam._slam_step(tp, _port(key), _port(cloud), warm_t, 64, "cpu")
    assert _runs("the SLAM step") == runs + 1
    got = [v.numpy() for v in got]
    for q in (0, 2, 3):      # tf, warm R, warm T
        np.testing.assert_allclose(got[q], ref[q], atol=SLAM_POSE_TOL)
    assert bool(got[1]) == bool(ref[1]) is True
    assert got[4] == ref[4]
    for q in (5, 6):         # <f,f>, <f_key,f>
        np.testing.assert_allclose(got[q], ref[q], rtol=FIP_RTOL)


def test_slam_step_program_has_the_bits_of_the_eager_ops(loop_pair):
    """The step's program is `_step_post` op by op; a degenerate frame
    resets the warm state to cold (a few iterations suffice here)."""
    tp = ct.CvoParams(max_iter=6, **MATLAB_STOPS)
    key, cloud = (_port(c) for c in loop_pair)
    warm = (torch.eye(3), torch.zeros(3), torch.tensor(tp.ell_init))
    for frame in (cloud, cloud._replace(mask=torch.zeros_like(cloud.mask))):
        res = tslam.align_jit(tp, key, frame, *warm, device="cpu")
        got = tslam._slam_step(tp, key, frame, warm, 64, "cpu")
        ref = tslam._step_post(tp, 64, res.tf, res.R, res.T, *key, *frame)
        assert torch.equal(got[0], res.tf)
        for a, b in zip(got[1:], ref):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert not bool(got[1]) and torch.equal(got[2], torch.eye(3))


# ---- the pose-graph solve ---------------------------------------------------


GRAPH_CASES = {
    "huber": dict(huber_delta=0.3, robust="huber", warmup=0),
    "cauchy": dict(huber_delta=0.15, robust="cauchy", warmup=0),
    "graduated": dict(huber_delta=0.3, robust="cauchy", warmup=5),
}


@pytest.mark.parametrize("solver,case", [
    ("dense", "huber"), ("dense", "graduated"), ("pcg", "cauchy"),
    ("pcg", "graduated")])
def test_optimize_matches_jax_compiled_solves(solver, case):
    kw = GRAPH_CASES[case]
    jg = _bad_edge_graph()
    if solver == "dense":
        j_nodes, j_costs = jpg._optimize_dense(
            jg, 8, 1e-6, kw["huber_delta"], kw["robust"], kw["warmup"])
    else:
        j_nodes, j_costs = jpg._optimize_pcg(
            jg, 8, 1e-6, 96, kw["huber_delta"], kw["robust"], kw["warmup"])
    graph = posegraph_from_numpy(*(np.asarray(a) for a in jg), device="cpu")
    t_nodes, t_costs = tpg.optimize(
        graph, iters=8, solver=solver, cg_iters=96,
        huber_delta=kw["huber_delta"], robust=kw["robust"],
        robust_warmup=kw["warmup"])
    np.testing.assert_allclose(t_nodes.numpy(), np.asarray(j_nodes),
                               atol=GRAPH_TOL)
    np.testing.assert_allclose(t_costs.numpy(), np.asarray(j_costs),
                               rtol=GRAPH_COST_RTOL, atol=1e-6)


def _eager_optimize(graph, solver, iters, cg_iters, huber_delta, robust,
                    warmup, damping=1e-6):
    """The Gauss-Newton loop op by op, as `optimize` ran it before its
    iteration was captured."""
    nodes, costs = graph.nodes, []
    for k in range(iters):
        if solver == "dense":
            nodes, cost = tpg._gn_step_dense(graph, nodes, damping,
                                             huber_delta, robust, k, warmup)
        else:
            nodes, cost = tpg._gn_step_pcg(graph, nodes, damping, cg_iters,
                                           huber_delta, robust, k, warmup)
        costs.append(cost)
    return nodes, torch.stack(costs)


@pytest.mark.parametrize("case", list(GRAPH_CASES))
@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_optimize_iterations_have_the_bits_of_the_eager_loop(solver, case):
    kw = GRAPH_CASES[case]
    graph = posegraph_from_numpy(*(np.asarray(a) for a in _bad_edge_graph()),
                                 device="cpu")
    got = tpg.optimize(graph, iters=7, solver=solver, cg_iters=64,
                       huber_delta=kw["huber_delta"], robust=kw["robust"],
                       robust_warmup=kw["warmup"])
    ref = _eager_optimize(graph, solver, 7, 64, kw["huber_delta"],
                          kw["robust"], kw["warmup"])
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_optimize_loops_are_keyed_and_count_their_iterations():
    """One loop a key; the graduated kernel is two captured iterations
    run warmup and iters - warmup times; a graph of another size keys
    its own; the result is fresh each call, the input graph untouched."""
    jg = _bad_edge_graph()
    graph = posegraph_from_numpy(*(np.asarray(a) for a in jg), device="cpu")
    nodes0 = graph.nodes.clone()
    kw = dict(iters=6, solver="dense", huber_delta=0.3, robust="cauchy",
              robust_warmup=4, damping=2e-6)
    before = dict(tpg.CACHE)
    first = tpg.optimize(graph, **kw)
    new = [v for k, v in tpg.CACHE.items() if k not in before]
    assert len(new) == 1
    loop = new[0]
    assert set(loop.steps) == {"huber", "cauchy"} and loop.runs == 6
    again = tpg.optimize(graph, **kw)
    assert len(tpg.CACHE) == len(before) + 1 and loop.runs == 12
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert first[0].data_ptr() != again[0].data_ptr()
    assert torch.equal(graph.nodes, nodes0)
    # warmup past iters: every iteration runs Huber
    tpg.optimize(graph, **{**kw, "iters": 3, "robust_warmup": 5})
    tpg.optimize(_chain_graph(8), **kw)
    assert len(tpg.CACHE) == len(before) + 3


def _chain_graph(n):
    """An odometry chain of n nodes with one loop edge."""
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        step = np.eye(4, dtype=np.float32)
        step[:3, 3] = [0.2, 0.0, 0.01]
        poses.append(poses[-1] @ step)
    return tpg.from_odometry(np.stack(poses), loop_edges=[
        (0, n - 1, np.linalg.inv(poses[0]) @ poses[-1], 5.0)], device="cpu")


# ---- bundle adjustment -----------------------------------------------------


@pytest.mark.parametrize("kind", ["clean", "noisy"])
def test_ba_solve_matches_jax_ba_single(rng, kind):
    problem, _, _ = _synthetic(rng, noise=0.005 if kind == "noisy" else 0.0)
    rp, rl, rc = (np.asarray(a) for a in jba._ba_single(problem, 8, 1e-4,
                                                        48))
    port = ba_problem_from_numpy(*(np.asarray(f) for f in problem),
                                 device="cpu")
    tp, tl, tc = (a.numpy() for a in tba.ba_solve(port, iters=8,
                                                  device="cpu"))
    np.testing.assert_allclose(tp, rp, rtol=0, atol=BA_TOL)
    np.testing.assert_allclose(tl, rl, rtol=0, atol=BA_TOL)
    np.testing.assert_allclose(tc, rc, rtol=BA_COST_RTOL, atol=BA_COST_ATOL)


def test_ba_iterations_have_the_bits_of_the_eager_loop(rng):
    """The captured iteration is `_solve_local`'s op by op; a second
    call replays the key's loop, another size keys its own."""
    problem, _, _ = _synthetic(rng, noise=0.005)
    port = ba_problem_from_numpy(*(np.asarray(f) for f in problem),
                                 device="cpu")
    before = dict(tba.CACHE)
    got = tba.ba_solve(port, iters=5, device="cpu")
    ref = tba._solve_local(port, 5, 1e-4, 48)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    new = [v for k, v in tba.CACHE.items() if k not in before]
    assert len(new) == 1 and new[0].runs == 5
    again = tba.ba_solve(port, iters=5, device="cpu")
    assert new[0].runs == 10 and len(tba.CACHE) == len(before) + 1
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    small, _, _ = _synthetic(rng, k=4, m=30)
    tba.ba_solve(ba_problem_from_numpy(*(np.asarray(f) for f in small),
                                       device="cpu"), iters=5, device="cpu")
    assert len(tba.CACHE) == len(before) + 2


# ---- multiseq's lane post ---------------------------------------------------


@pytest.mark.parametrize("adaptive", [False, True])
def test_lane_post_matches_jax(adaptive):
    """Four lanes: two good, one with a NaN transform, one whose moving
    cloud is degenerate."""
    rng = np.random.default_rng(9)
    clouds = [pad_cloud(rng.standard_normal((n, 3)).astype(np.float32),
                        capacity=128) for n in (100, 100, 100, 100, 100, 20,
                                                100, 100)]
    fixed, moving = j_stack(clouds[:4]), j_stack(clouds[4:])
    R = np.stack([ct.se3.exp_so3(torch.tensor(rng.normal(0, 0.1, 3),
                                              dtype=torch.float32)).numpy()
                  for _ in range(4)])
    T = rng.normal(0, 0.1, (4, 3)).astype(np.float32)
    tf = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    tf[:, :3, :3], tf[:, :3, 3] = R, T
    tf[2, 0, 3] = np.nan
    ell = np.array([0.05, 0.08, 0.07, 0.06], np.float32)
    ref = jms._compiled_lane_post(adaptive, 0.1, 64)(
        jnp.asarray(tf), jnp.asarray(R), jnp.asarray(T), jnp.asarray(ell),
        fixed, moving)
    res = types.SimpleNamespace(tf=torch.from_numpy(tf),
                                R=torch.from_numpy(R), T=torch.from_numpy(T),
                                ell=torch.from_numpy(ell))
    runs = _runs("multiseq's lane post")
    got = tms.lane_post(res, t_stack([_port(c) for c in clouds[:4]]),
                        t_stack([_port(c) for c in clouds[4:]]), adaptive,
                        0.1, 64)
    assert _runs("multiseq's lane post") == runs + 1
    assert got[0].tolist() == [True, False, False, True]
    assert got[0].tolist() == np.asarray(ref[0]).tolist()
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
