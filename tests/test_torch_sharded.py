"""`parallel.align_sharded` of the port on gloo ranks on the CPU, against
the JAX package's `align_sharded` on the same sp and the port's
single-device `align`.

The pair is tests/test_parallel.py's `_big_pair` (900 points at
capacity 1024), so sp=2 gives 512-row blocks that the moment kernel
tiles.  cvo, acvo and MATLAB_PARAMS (linear color), each on the kernel
backend (held against JAX "pallas") and the dense one (against "xla"),
after exactly 1 and 10 iterations (tf within 1e-5 and 1e-4) and at the
C++ stops eps=5e-5, eps_2=1e-5 (tf within 3e-4, both converged, acvo's
final ell within 5%): JAX's own gates (tests/test_parallel.py).  Linear
mode meets JAX at the stops only (each JAX case is a compile).  Rows
that do not tile (capacity 256 over sp=8) take the dense body, as in JAX.

The JAX side runs its `align_sharded` with the shard_map'ed body under
jit and the kd-sort before it op by op: `jit(kd_sort)` duplicates
points on XLA:CPU (ROADMAP queue 3), and the body runs eagerly an order
slower.  The port's ranks run in a thread meanwhile.
"""

import concurrent.futures
import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch.parallel import mesh as tmesh
from cvo_rgbd_tpu import AcvoParams as JA
from cvo_rgbd_tpu import CvoParams as JC
from cvo_rgbd_tpu import MATLAB_PARAMS as J_MATLAB
from cvo_rgbd_tpu import pad_cloud, se3
from cvo_rgbd_tpu.parallel import make_mesh as j_make_mesh
from cvo_rgbd_tpu.parallel import sharded as jsharded

import torch_ranks

torch.set_num_threads(2)

SP = 2
STOPS = {"it1": dict(max_iter=1, eps=0.0, eps_2=0.0),
         "it10": dict(max_iter=10, eps=0.0, eps_2=0.0),
         "stops": dict(eps=5e-5, eps_2=1e-5)}
TF_TOL = {"it1": 1e-5, "it10": 1e-4, "stops": 3e-4}
KINDS = {"cvo": (ct.CvoParams(), JC()), "acvo": (ct.AcvoParams(), JA()),
         "linear": (ct.MATLAB_PARAMS, J_MATLAB)}
JAX_BACKEND = {"kernel": "pallas", "dense": "xla"}
CASES = [(k, b, s) for k in KINDS for b in JAX_BACKEND for s in STOPS]
# each JAX case is a compile of ~4 s on the CPU: linear mode is held
# against JAX at the stops, after 1 and 10 iterations against the port's
# single align alone
JAX_CASES = [c for c in CASES if c[0] != "linear" or c[2] == "stops"]


def _pair(seed, n=900, cap=1024):
    """tests/test_parallel.py:_pair, as numpy (positions, features, mask)
    for each cloud."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n + 30, 3)).astype(np.float32) * 0.4
    feat = (rng.random((n + 30, 5))
            * np.array([255, 255, 255, 60, 60])).astype(np.float32)
    R = np.asarray(se3.exp_so3(np.array([0.01, -0.012, 0.008], np.float32)))
    t = np.array([0.02, -0.01, 0.015], np.float32)
    yp = (base[20:20 + n] @ R.T + t).astype(np.float32)
    return tuple(tuple(np.asarray(a) for a in c) for c in (
        pad_cloud(base[:n], feat[:n], capacity=cap),
        pad_cloud(yp, feat[20:20 + n], capacity=cap)))


def params(kind, backend, stop):
    tp, jp = KINDS[kind]
    kw = STOPS[stop]
    return (dataclasses.replace(tp, backend=backend, **kw),
            dataclasses.replace(jp, backend=JAX_BACKEND[backend], **kw))


@contextlib.contextmanager
def jax_body_jitted():
    """JAX's mesh entry points with their shard_map'ed body under jit and
    what comes before it (the kd-sort) op by op."""
    orig = jsharded.shard_map
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsharded, "shard_map",
                   lambda *a, **k: jax.jit(orig(*a, **k)))
        yield


def jax_cloud(arrays):
    from cvo_rgbd_tpu.core.cloud import PointCloud

    return PointCloud(*(jax.numpy.asarray(a) for a in arrays))


def port_cloud(arrays):
    return ct.PointCloud(*(torch.from_numpy(np.array(a)) for a in arrays))


@pytest.fixture(scope="module")
def runs():
    pair = _pair(11)
    small = _pair(12, n=96, cap=256)
    cases = [({"sp": SP}, "sharded", params(*c)[0], "big", {})
             for c in CASES]
    # rows that do not tile: 32 a rank; the kernel body is asked for
    unaligned = [({"sp": 8}, "sharded",
                  ct.CvoParams(max_iter=40, backend=b), "small", {})
                 for b in ("kernel", "dense")]
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        fut = ex.submit(tmesh.launch, torch_ranks.aligns, SP,
                        (cases, {"big": pair}), device="cpu", threads=2)
        fut8 = ex.submit(tmesh.launch, torch_ranks.aligns, 8,
                         (unaligned, {"small": small}), device="cpu",
                         threads=1)
        mesh = j_make_mesh({"sp": SP})
        jx, jy = (jax_cloud(a) for a in pair)
        ref = {}
        with jax_body_jitted():
            for c in JAX_CASES:
                ref[c] = {k: np.asarray(v) for k, v in zip(
                    jsharded.AlignResult._fields,
                    jsharded.align_sharded(params(*c)[1], mesh, jx, jy))}
        x, y = (port_cloud(a) for a in pair)
        single = {c: torch_ranks.result(ct.align(params(*c)[0], x, y,
                                                 device="cpu"))
                  for c in CASES}
        sx, sy = (port_cloud(a) for a in small)
        small_single = torch_ranks.result(ct.align(
            ct.CvoParams(max_iter=40, backend="dense"), sx, sy,
            device="cpu"))
        ranks, ranks8 = fut.result(), fut8.result()
    return {"port": dict(zip(CASES, ranks[0])), "ranks": ranks,
            "jax": ref, "single": single, "ranks8": ranks8,
            "small_single": small_single}


def _hold(got, ref, stop, kind):
    np.testing.assert_allclose(got["tf"], ref["tf"], atol=TF_TOL[stop])
    if stop == "stops":
        assert bool(got["converged"]) and bool(ref["converged"])
        if kind == "acvo":
            np.testing.assert_allclose(got["ell"], ref["ell"], rtol=0.05)
    else:
        assert int(got["iterations"]) == int(ref["iterations"])
        np.testing.assert_allclose(got["ell"], ref["ell"], rtol=1e-5)


@pytest.mark.parametrize("case", JAX_CASES,
                         ids=["-".join(c) for c in JAX_CASES])
def test_align_sharded_matches_jax(runs, case):
    _hold(runs["port"][case], runs["jax"][case], case[2], case[0])


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_align_sharded_matches_single_align(runs, case):
    _hold(runs["port"][case], runs["single"][case], case[2], case[0])


def test_every_rank_returns_the_same_bits(runs):
    for a, b in zip(*runs["ranks"]):
        for f in a:
            np.testing.assert_array_equal(a[f], b[f])
    for r in runs["ranks8"][1:]:
        for a, b in zip(runs["ranks8"][0], r):
            for f in a:
                np.testing.assert_array_equal(a[f], b[f])


def test_unaligned_rows_take_the_dense_body(runs):
    """tests/test_parallel.py::test_align_sharded_pallas_fallback_unaligned:
    32-row blocks cannot tile, so the kernel backend runs the dense body
    (the same bits as asking for it) and lands within 2e-5 of the
    single-device align."""
    kernel, dense = runs["ranks8"][0]
    for f in kernel:
        np.testing.assert_array_equal(kernel[f], dense[f])
    np.testing.assert_allclose(kernel["tf"], runs["small_single"]["tf"],
                               atol=2e-5)
