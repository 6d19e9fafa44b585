"""The rest of the port's mesh paths on 4 gloo ranks on the CPU, against
the JAX package on the same mesh and against the port on one device.

- `train_step_2d` over dp=2 x sp=2: each pair as the single-device
  `align` gives it, and as JAX's `train_step_2d` ("pallas") gives it, tf
  within 3e-4 (tests/test_parallel.py:test_train_step_2d_pallas).
- `align_batched(mesh=)` with the lanes over dp=2 on the kernel, dense
  and fused backends, cold and warm-started: every lane has the bits of
  the unsharded call.
- `run_multiseq(mesh=)` over the parallax folder and a 2-frame prefix of
  it (ragged lanes): rank 0 writes the same trajectory files as the
  unsharded run.
- `core.posegraph.optimize(mesh=)` on tests/test_posegraph.py's drifted
  square (9 edges padded to 12 over sp=4) and `ba_solve(mesh=)` on
  tests/test_ba.py's odd-sized problem (5 poses, 33 landmarks): against
  JAX's sharded solves and the port's single-device solves, poses and
  landmarks within 1e-4 and costs within 1e-3 (tests/test_torch_ba.py's
  rule).

One launch of 4 ranks (`torch_ranks.jobs`) runs all of it, in a thread
while the JAX side and the single-device references run here.
"""

import concurrent.futures
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch.convert import ba_problem_from_numpy, posegraph_from_numpy
from cvo_rgbd_torch.core import posegraph as tpg
from cvo_rgbd_torch.multiseq import run_multiseq
from cvo_rgbd_torch.parallel import align_batched, ba_solve
from cvo_rgbd_torch.parallel import mesh as tmesh
from cvo_rgbd_tpu import CvoParams as JC
from cvo_rgbd_tpu.core import posegraph as jpg
from cvo_rgbd_tpu.parallel import ba as jba
from cvo_rgbd_tpu.parallel import make_mesh as j_make_mesh
from cvo_rgbd_tpu.parallel import sharded as jsharded

import torch_ranks
from test_ba import _synthetic
from test_posegraph import _drifted_square_graph
from test_torch_sharded import _pair, jax_body_jitted, jax_cloud
from torch_scenes import make_parallax_folder

torch.set_num_threads(2)

AXES = {"dp": 2, "sp": 2}
P2D = ct.CvoParams(max_iter=30)
BACKENDS = ("kernel", "dense", "fused")
# four lanes of tests/test_parallel.py's small pairs; the MATLAB stops
# keep the plain aligns short
FAST = dict(eps=5e-4, eps_2=1e-4, max_iter=60)
NUM_WANT = 512
OPT = dict(iters=10, cg_iters=96)
BA = dict(iters=8)


def _stack(pairs, k):
    return tuple(np.stack([p[k][f] for p in pairs]) for f in range(3))


def _warm(b):
    rng = np.random.default_rng(5)
    R0 = np.stack([ct.se3.exp_so3(torch.tensor(
        rng.normal(0, 0.01, 3), dtype=torch.float32)).numpy()
        for _ in range(b)])
    return dict(R0=torch.from_numpy(R0),
                T0=torch.from_numpy(rng.normal(0, 0.01, (b, 3)).astype(
                    np.float32)),
                ell0=torch.full((b,), 0.12))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pairs2d = [_pair(30 + i, n=400 + 40 * i, cap=512) for i in range(2)]
    lanes = [_pair(40 + i, n=96, cap=256) for i in range(4)]
    clouds = {"2d": (_stack(pairs2d, 0), _stack(pairs2d, 1)),
              "lanes": (_stack(lanes, 0), _stack(lanes, 1))}
    batched = [(b, False) for b in BACKENDS] + [("kernel", True)]

    def lane_params(b):
        return ct.CvoParams(backend=b, **FAST)

    cases = [(AXES, "train_step_2d", P2D, "2d", {})]
    cases += [(AXES, "batched", lane_params(b), "lanes",
               _warm(4) if warm else {}) for b, warm in batched]
    _, jgraph = _drifted_square_graph()
    graph = [np.asarray(a) for a in jgraph]
    problem, _, _ = _synthetic(np.random.default_rng(7), k=5, m=33,
                               noise=0.002)
    problem = [np.asarray(a) for a in problem]
    root = tmp_path_factory.mktemp("torch_parallel")
    (root / "long").mkdir()
    folder = make_parallax_folder(root / "long")
    short = root / "short"
    short.mkdir()
    for d in ("rgb", "depth"):
        (short / d).symlink_to(folder / d)
    entries = (folder / "assoc.txt").read_text().splitlines()
    (short / "assoc.txt").write_text("\n".join(entries[:2]) + "\n")
    folders = [str(folder), str(short)]
    msp = lane_params("fused")
    todo = [("aligns", (cases, clouds)),
            ("solvers", ({"sp": 4}, graph, problem, OPT, BA)),
            ("multiseq", (AXES, folders, msp, NUM_WANT))]
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(tmesh.launch, torch_ranks.jobs, 4, (todo,),
                        device="cpu", threads=1)
        # references: JAX on the same meshes, the port on one device
        with jax_body_jitted():
            jres = jsharded.train_step_2d(
                dataclasses.replace(JC(max_iter=30), backend="pallas"),
                j_make_mesh(AXES), *(jax_cloud(c) for c in clouds["2d"]))
        j_mesh4 = j_make_mesh({"sp": 4})
        j_opt = jpg.optimize(jgraph, mesh=j_mesh4, **OPT)
        j_ba = jba.ba_solve(jba.BAProblem(*problem), mesh=j_mesh4, **BA)
        single2d = [torch_ranks.result(ct.align(
            P2D, *(torch_ranks.cloud(c) for c in p), device="cpu"))
            for p in pairs2d]
        fb, mb = (torch_ranks.cloud(a) for a in clouds["lanes"])
        unsharded = [torch_ranks.result(align_batched(
            lane_params(b), fb, mb, device="cpu", **(_warm(4) if warm else {})))
            for b, warm in batched]
        t_opt = tpg.optimize(posegraph_from_numpy(*graph, device="cpu"),
                             solver="pcg", **OPT)
        t_ba = ba_solve(ba_problem_from_numpy(*problem, device="cpu"),
                        device="cpu", **BA)
        solo = root / "solo"
        shutil.copytree(folder, solo / "long", symlinks=True)
        shutil.copytree(short, solo / "short", symlinks=True)
        solo_folders = [str(solo / "long"), str(solo / "short")]
        solo_outs = run_multiseq(solo_folders, 1, params=msp,
                                 num_want=NUM_WANT, warm_start=False,
                                 device="cpu", log=lambda *a: None)
        ranks = fut.result()
    return {"ranks": ranks, "jax2d": np.asarray(jres.tf),
            "single2d": single2d, "unsharded": unsharded,
            "j_opt": j_opt, "j_ba": j_ba, "t_opt": t_opt, "t_ba": t_ba,
            "solo": [solo_outs[f] for f in solo_folders],
            "folders": folders}


def test_train_step_2d_matches_single_aligns_and_jax(runs):
    got = runs["ranks"][0][0][0]
    for i, ref in enumerate(runs["single2d"]):
        np.testing.assert_allclose(got["tf"][i], ref["tf"], atol=3e-4)
        assert bool(got["converged"][i])
        np.testing.assert_allclose(got["tf"][i], runs["jax2d"][i],
                                   atol=3e-4)


@pytest.mark.parametrize("case", range(4),
                         ids=[*BACKENDS, "kernel-warm"])
def test_align_batched_over_dp_has_the_unsharded_bits(runs, case):
    ref = runs["unsharded"][case]
    for rank in runs["ranks"]:
        got = rank[0][1 + case]
        for f in ref:
            np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


def test_every_rank_holds_the_whole_batch(runs):
    first = runs["ranks"][0][0]
    for rank in runs["ranks"][1:]:
        for a, b in zip(first, rank[0]):
            for f in a:
                np.testing.assert_array_equal(a[f], b[f])


def _solver_refs(runs):
    j_nodes, j_costs = (np.asarray(a) for a in runs["j_opt"])
    t_nodes, t_costs = (a.numpy() for a in runs["t_opt"])
    jp, jl, jc = (np.asarray(a) for a in runs["j_ba"])
    tp, tl, tc = (a.numpy() for a in runs["t_ba"])
    return ((j_nodes, j_costs, jp, jl, jc), (t_nodes, t_costs, tp, tl, tc))


@pytest.mark.parametrize("ref", ["jax", "single"])
def test_optimize_over_a_mesh(runs, ref):
    want = _solver_refs(runs)[ref == "single"]
    for rank in runs["ranks"]:
        nodes, costs = rank[1][:2]
        np.testing.assert_allclose(nodes, want[0], atol=1e-4)
        np.testing.assert_allclose(costs, want[1], rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("ref", ["jax", "single"])
def test_ba_solve_over_a_mesh(runs, ref):
    want = _solver_refs(runs)[ref == "single"]
    for rank in runs["ranks"]:
        poses, lms, costs = rank[1][2:]
        assert lms.shape == want[3].shape == (33, 3)
        np.testing.assert_allclose(poses, want[2], atol=1e-4)
        np.testing.assert_allclose(lms, want[3], atol=1e-4)
        np.testing.assert_allclose(costs, want[4], rtol=1e-3, atol=1e-7)


def test_solvers_give_every_rank_the_same_bits(runs):
    """optimize's replicated PCG reads only psum'd sums; ba_solve's
    replicated Schur step is the first rank's, broadcast each GN step."""
    first = runs["ranks"][0][1]
    for rank in runs["ranks"][1:]:
        for a, b in zip(first, rank[1]):
            np.testing.assert_array_equal(a, b)


def test_run_multiseq_over_a_mesh_writes_the_unsharded_files(runs):
    outs = [r[2][0] for r in runs["ranks"]]
    assert all(o == outs[0] for o in outs)
    for folder, solo in zip(runs["folders"], runs["solo"]):
        got = open(outs[0][folder]).read()
        assert got == open(solo).read() and got.count("\n") > 1
