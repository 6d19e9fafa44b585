"""The compiled mesh paths against their eager loops, on gloo ranks on
the CPU.

`align_sharded`, `train_step_2d` and `align_ring` run their loops as
`core.compiled.run_mesh` runs them, and `optimize(mesh=)` and
`ba_solve(mesh=)` their Gauss-Newton iterations as a `CapturedLoop`: on
the CPU the same step on the same static tensors, uncaptured, where the
card replays CUDA graphs.  Each is held here to its eager loop on the
same ranks (`sharded._run_eager`, `posegraph._mesh_eager`,
`ba._solve_local`), bit for bit: the CPU's sums are one order every run.

The pairs are tests/test_parallel.py's `_big_pair` (900 points at
capacity 1024) at sp=2, so the row and ring blocks of 512 tile: cvo and
acvo, on the kernel and the dense bodies, after 10 iterations (a block
of 8 and a tail of 2) and at the C++ stops eps=5e-5, eps_2=1e-5 with
max_iter=15 (a block, then a tail of 7 in which the pair converges).
A second pair through the same key (`train_step_2d`'s two pairs on one
rank, and one more align of each entry point) must give that pair's
eager bits: a stale per-align precompute would show there.  A mesh
built again, with new process groups, must not grow the caches.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest

import cvo_rgbd_torch as ct
from cvo_rgbd_torch.parallel import mesh as tmesh

import torch_ranks
from torch_ranks import BA, OPT
from test_torch_sharded import _pair

STOPS = {"it10": dict(max_iter=10, eps=0.0, eps_2=0.0),
         "stops": dict(max_iter=15, eps=5e-5, eps_2=1e-5)}
KINDS = {"cvo": ct.CvoParams(), "acvo": ct.AcvoParams()}
ENTRIES = {"sharded": {"sp": 2}, "ring": {"sp": 2},
           "train_step_2d": {"dp": 1, "sp": 2}}
CASES = [(e, k, b, s) for e in ENTRIES for k in KINDS
         for b in ("kernel", "dense") for s in STOPS]
# a 2-D mesh whose "sp" groups are new process groups on every build
REMESH = {"dp": 2, "sp": 1}
# one more pair through a key of each entry point: the kernel bodies
# hold the most per-align state (acvo's tile orders, per hop on the ring)
AGAIN = [(e, "acvo", "kernel", "it10", "again") for e in ("sharded", "ring")]


def _params(kind, body, stop):
    return dataclasses.replace(KINDS[kind], backend=body, **STOPS[stop])


def _stacked(pairs):
    return tuple(tuple(np.stack([p[c][f] for p in pairs]) for f in range(3))
                 for c in range(2))


@pytest.fixture(scope="module")
def runs():
    pairs = [_pair(11), _pair(12)]
    clouds = {"big": pairs[0], "big2": pairs[1], "both": _stacked(pairs)}

    def cases(entry):
        todo = [(ENTRIES[entry], entry, _params(*c[1:]),
                 "both" if entry == "train_step_2d" else "big")
                for c in CASES if c[0] == entry]
        return todo + [(ENTRIES[entry], entry, _params(*c[1:4]), "big2")
                       for c in AGAIN if c[0] == entry]

    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = {e: ex.submit(
            tmesh.launch, torch_ranks.jobs, 2,
            ([("compiled_and_eager", (cases(e), clouds))]
             + ([("solvers_compiled_and_eager",
                  ({"sp": 2}, torch_ranks.mesh_graph(),
                   torch_ranks.mesh_problem(), OPT, BA))]
                if e == "sharded" else [])
             + ([("mesh_again", (REMESH, e, dataclasses.replace(
                 _params("cvo", "kernel", "it10"), max_iter=8), "both",
                 clouds))]
                if e == "train_step_2d" else []),),
            device="cpu", threads=2 if e == "train_step_2d" else 1)
            for e in ENTRIES}
        ranks = {e: f.result() for e, f in futs.items()}
    out = {}
    for e, got in ranks.items():
        n = sum(1 for c in CASES if c[0] == e)
        named = [c for c in CASES if c[0] == e] + [c for c in AGAIN
                                                  if c[0] == e]
        out[e] = [dict(zip(named, r[0])) for r in got]
        assert len(got[0][0]) == n + sum(1 for c in AGAIN if c[0] == e)
    out["solvers"] = [r[1] for r in ranks["sharded"]]
    out["again"] = [r[1] for r in ranks["train_step_2d"]]
    return out


def _same(got, ref):
    for f in ref:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_compiled_mesh_loop_has_the_eager_bits(runs, case):
    """Every rank's compiled result is its eager loop's, in blocks of 8
    and the tail, and every rank's is the same."""
    for rank in runs[case[0]]:
        got, ref, _, replays, _ = rank[case]
        _same(got, ref)
        _same(got, runs[case[0]][0][case][0])
        if case[3] == "it10":
            assert replays == 2 * (2 if case[0] == "train_step_2d" else 1)
        else:
            assert np.all(got["converged"]) and replays >= 2


@pytest.mark.parametrize("case", AGAIN, ids=["-".join(c) for c in AGAIN])
def test_a_second_pair_through_the_key_has_its_eager_bits(runs, case):
    """Another pair through the compiled loop of a key: that pair's eager
    bits (its own precompute copied in), no new compiled loop, and a
    result other than the first pair's."""
    first = case[:4]
    for rank in runs[case[0]]:
        got, ref, loops, _, _ = rank[case]
        _same(got, ref)
        assert loops == max(rank[c][2] for c in CASES if c[0] == case[0])
        assert not np.array_equal(got["tf"], rank[first][0]["tf"])


def test_train_step_2d_runs_its_pairs_through_one_loop(runs):
    """train_step_2d's two pairs on one dp rank: one compiled loop a key,
    each pair its own eager bits (above), the two results apart."""
    for rank in runs["train_step_2d"]:
        loops = [rank[c][2] for c in CASES if c[0] == "train_step_2d"]
        assert loops == list(range(1, len(loops) + 1))
        got = rank[("train_step_2d", "acvo", "kernel", "it10")][0]
        assert not np.array_equal(got["tf"][0], got["tf"][1])


def test_a_mesh_built_again_keeps_one_compiled_loop_a_key(runs):
    """train_step_2d and optimize(mesh=) on a dp=2 x sp=1 mesh, then on
    that mesh built again, whose "sp" group is another process group: the
    key's compiled loop and compiled solve are built again in place of
    the old ones (the caches do not grow), with the same bits."""
    for got, new_group, loops, solves in runs["again"]:
        assert new_group
        _same(got[1], got[0])
        assert loops[1] == loops[0] and solves[1] == solves[0]


@pytest.mark.parametrize("solver", ["optimize", "ba_solve"])
def test_compiled_mesh_solves_meet_the_eager_loop(runs, solver):
    """optimize(mesh=) (the graduated Cauchy kernel: two captured
    iterations) and ba_solve(mesh=) against their eager mesh loops on
    the same ranks: within 2e-4 (1e-4 for BA) on the poses and 1e-3 on
    the costs, bit for bit on the CPU, the same on every rank."""
    part = slice(0, 2) if solver == "optimize" else slice(2, 5)
    tol = 2e-4 if solver == "optimize" else 1e-4
    for got, ref in runs["solvers"]:
        for a, b in zip(got[part][:-1], ref[part][:-1]):
            np.testing.assert_allclose(a, b, atol=tol)
        np.testing.assert_allclose(got[part][-1], ref[part][-1], rtol=1e-3)
        for a, b in zip(got[part], ref[part]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got[part], runs["solvers"][0][0][part]):
            np.testing.assert_array_equal(a, b)
    got = runs["solvers"][0][0][part]
    assert all(np.isfinite(a).all() for a in got)
    assert got[-1][-1] < got[-1][0]
