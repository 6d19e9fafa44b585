"""Rank functions of the port's multi-rank CPU tests.

Each runs on every rank of a `cvo_rgbd_torch.parallel.mesh.launch` (gloo,
on the CPU) and returns plain data: numpy arrays, numbers, strings.  This
module imports torch and the port only, never jax: the spawned ranks
import it by name.
"""

import datetime

import numpy as np
import torch
import torch.distributed as dist

from cvo_rgbd_torch.core.cloud import PointCloud
from cvo_rgbd_torch.convert import posegraph_from_numpy
from cvo_rgbd_torch.core.posegraph import optimize
from cvo_rgbd_torch.parallel import (
    align_batched,
    align_ring,
    align_sharded,
    ba_solve,
    make_mesh,
    multihost_initialize,
    train_step_2d,
)
from cvo_rgbd_torch import collectives
from cvo_rgbd_torch.parallel.ba import problem_on

ENTRIES = {"sharded": align_sharded, "ring": align_ring,
           "train_step_2d": train_step_2d}


def cloud(arrays):
    """A CPU PointCloud from (positions, features, mask) arrays."""
    return PointCloud(*(torch.from_numpy(np.array(a)) for a in arrays))


def result(res):
    """An AlignResult as {field: numpy array}."""
    return {f: t.cpu().numpy() for f, t in zip(res._fields, res)}


def aligns(cases, clouds, device="cpu"):
    """Run `cases`, each (axes, entry, params, key, kwargs): on a mesh of
    `axes`, entry a name of ENTRIES or "batched" (`align_batched` over the
    mesh), `clouds[key]` the (fixed, moving) arrays, on `device` (None:
    the rank's card).  Returns each case's result."""
    meshes = {}
    out = []
    for axes, entry, p, key, kw in cases:
        name = tuple(axes.items())
        if name not in meshes:
            meshes[name] = make_mesh(axes)
        mesh = meshes[name]
        fixed, moving = (cloud(a) for a in clouds[key])
        if entry == "batched":
            res = align_batched(p, fixed, moving, mesh=mesh, device=device,
                                **kw)
        else:
            res = ENTRIES[entry](p, mesh, fixed, moving, device=device,
                                 **kw)
        out.append(result(res))
    return out


def jobs(todo):
    """Run the named functions of this module in turn: each (name, args);
    returns their results.  One launch then serves a test module."""
    return [globals()[name](*args) for name, args in todo]


def mesh_probe():
    """The mesh and collective layer on 4 ranks: make_mesh's shapes and
    errors, each axis's index and ranks, psum/all_gather/ppermute, and a
    repeated multihost_initialize."""
    world = dist.get_world_size()
    multihost_initialize(backend="gloo", init_method="file:///nonexistent",
                         world_size=world + 1, rank=0)
    rank = dist.get_rank()
    out = {"repeat": (dist.get_world_size(), world),
           "default": make_mesh().shape,
           "part": make_mesh({"sp": 2}, devices=[0, 1]).shape}
    mesh = make_mesh({"dp": 2, "sp": -1})
    out["shape"] = mesh.shape
    for name in ("dp", "sp"):
        ax = mesh.axis(name)
        out[name] = (ax.size, ax.index, ax.ranks)
    try:
        make_mesh({"sp": 8})
        out["too_many"] = None
    except ValueError as e:
        out["too_many"] = str(e)
    sp = mesh.axis("sp")
    collectives.reset_stats()
    f, i = collectives.psum((torch.full((2, 3), float(rank)),
                             torch.tensor([rank, 1], dtype=torch.int64)), sp)
    out["psum"] = (f.numpy(), i.numpy(), collectives.STATS["calls"])
    out["gather"] = collectives.all_gather(
        torch.tensor([[rank, rank]]), sp).numpy()
    g, h = collectives.broadcast((torch.tensor([float(rank), 0.5]),
                                  torch.tensor([rank])), sp)
    out["broadcast"] = (g.numpy(), h.numpy())
    a, b = collectives.ppermute((torch.tensor([float(rank)]),
                                 torch.tensor([10 * rank])), sp)
    out["ppermute"] = (a.numpy(), b.numpy())
    out["rank"] = rank
    return out


def fail_on(rank_to_fail):
    """Raise on one rank; the others wait in a collective."""
    if dist.get_rank() == rank_to_fail:
        raise RuntimeError(f"rank {rank_to_fail} fails on purpose")
    dist.barrier()


def bad_address_raises(port):
    """multihost_initialize against a port nobody listens on, in a
    process of its own: (raised, exception name, seconds)."""
    import time

    t0 = time.perf_counter()
    try:
        multihost_initialize(backend="gloo",
                             init_method=f"tcp://127.0.0.1:{port}",
                             world_size=2, rank=1,
                             timeout=datetime.timedelta(seconds=2))
    except Exception as e:
        return True, type(e).__name__, time.perf_counter() - t0
    return False, "", time.perf_counter() - t0


def solvers(axes, graph, problem, opt_kw, ba_kw):
    """optimize(mesh=) on `graph` and ba_solve(mesh=) on `problem` (numpy
    fields), on a mesh of `axes`."""
    mesh = make_mesh(axes)
    g = posegraph_from_numpy(*graph, device="cpu")
    nodes, costs = optimize(g, mesh=mesh, **opt_kw)
    poses, lms, bcosts = ba_solve(problem_on(problem, "cpu"), mesh=mesh,
                                  device="cpu", **ba_kw)
    return [a.numpy() for a in (nodes, costs, poses, lms, bcosts)]


def multiseq(axes, folders, params, num_want):
    """run_multiseq(mesh=) over `folders` on a mesh of `axes`: rank 0
    writes the trajectory files.  Returns the paths and this rank."""
    from cvo_rgbd_torch.multiseq import run_multiseq

    outs = run_multiseq(folders, 1, params=params, num_want=num_want,
                        mesh=make_mesh(axes), warm_start=False, device="cpu",
                        log=lambda *a: None)
    return outs, dist.get_rank()
