"""The port's mesh, process group, collectives and local launcher
(`cvo_rgbd_torch/parallel/mesh.py`, `cvo_rgbd_torch/collectives.py`) on
gloo ranks on the CPU.

One launch of 4 ranks (`torch_ranks.mesh_probe`) serves the mesh and
collective tests: `make_mesh` keeps the JAX package's reading (a default
"sp" axis over every rank, -1 for the rest, ValueError past the world's
ranks), each axis gives a rank its index and its group's ranks in axis
order, `psum` packs a tuple into one all_reduce a dtype, `all_gather`
concatenates in axis order, `ppermute` moves a tuple one step around the
ring, `broadcast` gives every rank the axis's first rank's tuple.
"""

import socket

import numpy as np
import pytest

from cvo_rgbd_torch.parallel import mesh as tmesh

import torch_ranks


@pytest.fixture(scope="module")
def probe():
    return tmesh.launch(torch_ranks.mesh_probe, 4, device="cpu", threads=1)


def test_multihost_initialize_repeat_is_benign(probe):
    """A second call in an initialized rank, even with other arguments,
    returns without touching the group."""
    for r in probe:
        assert r["repeat"] == (4, 4)


def test_make_mesh_default_and_rest(probe):
    for r in probe:
        assert r["default"] == {"sp": 4}
        assert r["part"] == {"sp": 2}
        assert r["shape"] == {"dp": 2, "sp": 2}


def test_make_mesh_needs_the_ranks(probe):
    for r in probe:
        assert r["too_many"] == "mesh {'sp': 8} needs 8 devices, have 4"


def test_axis_index_and_ranks(probe):
    # row-major over (dp, sp), as jax's Mesh lays devices out
    for r in probe:
        dp, sp = divmod(r["rank"], 2)
        assert r["sp"] == (2, sp, (2 * dp, 2 * dp + 1))
        assert r["dp"] == (2, dp, (sp, sp + 2))


def test_psum_packs_each_dtype_once(probe):
    for r in probe:
        f, i, calls = r["psum"]
        dp = r["rank"] // 2
        np.testing.assert_array_equal(f, np.full((2, 3), 4.0 * dp + 1))
        np.testing.assert_array_equal(i, [4 * dp + 1, 2])
        assert f.dtype == np.float32 and i.dtype == np.int64
        assert calls == 2


def test_all_gather_in_axis_order(probe):
    for r in probe:
        base = 2 * (r["rank"] // 2)
        np.testing.assert_array_equal(r["gather"],
                                      [[base, base], [base + 1, base + 1]])


def test_ppermute_is_one_step_around_the_ring(probe):
    for r in probe:
        rank = r["rank"]
        prev = rank ^ 1          # the other rank of a 2-rank sp line
        a, b = r["ppermute"]
        np.testing.assert_array_equal(a, [float(prev)])
        np.testing.assert_array_equal(b, [10 * prev])


def test_broadcast_is_the_first_ranks(probe):
    for r in probe:
        first = 2 * (r["rank"] // 2)     # rank 0 of the rank's sp line
        g, h = r["broadcast"]
        np.testing.assert_array_equal(g, [float(first), 0.5])
        np.testing.assert_array_equal(h, [first])
        assert g.dtype == np.float32 and h.dtype == np.int64


def test_a_rank_error_stops_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        tmesh.launch(torch_ranks.fail_on, 2, (1,), device="cpu", threads=1,
                     timeout=120)


def test_multihost_initialize_bad_address_raises():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    # in a process of its own: a failed init must leave no group behind,
    # and the pytest process must not hold one
    ctx = __import__("multiprocessing").get_context("spawn")
    with ctx.Pool(1) as pool:
        raised, name, seconds = pool.apply(torch_ranks.bad_address_raises,
                                           (port,))
    assert raised, name
    assert seconds < 60


def test_nccl_asked_for_and_missing_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card: NCCL may be present")
    with pytest.raises(RuntimeError, match="NCCL"):
        tmesh.multihost_initialize(backend="nccl", init_method="file:///x",
                                   world_size=1, rank=0)


def test_make_mesh_without_a_group_raises():
    with pytest.raises(RuntimeError, match="multihost_initialize"):
        tmesh.make_mesh({"sp": 1})
