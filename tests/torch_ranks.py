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

from cvo_rgbd_torch.core import compiled
from cvo_rgbd_torch.core import posegraph as tpg
from cvo_rgbd_torch.core.cloud import PointCloud
from cvo_rgbd_torch.convert import posegraph_from_numpy
from cvo_rgbd_torch.core.posegraph import from_odometry, optimize
from cvo_rgbd_torch.parallel import (
    align_batched,
    align_ring,
    align_sharded,
    ba_solve,
    make_ba_problem,
    make_mesh,
    multihost_initialize,
    train_step_2d,
)
from cvo_rgbd_torch import collectives
from cvo_rgbd_torch.parallel import ba as tba
from cvo_rgbd_torch.parallel import sharded
from cvo_rgbd_torch.parallel.ba import problem_on
from cvo_rgbd_torch.parallel.mesh import rank_device

ENTRIES = {"sharded": align_sharded, "ring": align_ring,
           "train_step_2d": train_step_2d}


# the solver arguments of the compiled-against-eager mesh solves
OPT = dict(iters=6, damping=1e-6, cg_iters=32, huber_delta=0.5,
           robust="cauchy", robust_warmup=2)
BA = dict(iters=4, damping=1e-4, cg_iters=24)


def _se3(yaw, t):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = t
    return T


def mesh_graph():
    """A square driven with drift and closed by one loop edge (the
    shape of tests/test_posegraph.py's fixture): 9 nodes, 9 edges, padded
    to 10 over sp=2."""
    poses = [np.eye(4)]
    for k in range(8):
        step = _se3(np.pi / 2 if k % 2 else 0.0, [1.0, 0.0, 0.0])
        poses.append(poses[-1] @ step @ _se3(0.02, [0.03, 0.01, 0.0]))
    g = from_odometry(np.stack(poses), loop_edges=[(0, 8, np.eye(4), 10.0)],
                      device="cpu")
    return [t.numpy() for t in g]


def mesh_problem():
    """5 poses observing 33 landmarks with noise, perturbed (the shape of
    tests/test_ba.py's odd-sized problem, padded over sp=2)."""
    rng = np.random.default_rng(7)
    k, m = 5, 33
    lms = rng.uniform(-1, 1, (m, 3)) + [0.0, 0.0, 3.0]
    poses = np.stack([_se3(rng.normal(0, 0.1), rng.normal(0, 0.3, 3))
                      for _ in range(k)])
    z = [(lms - T[:3, 3]) @ T[:3, :3] + rng.normal(0, 0.002, (m, 3))
         for T in poses]
    init = poses.copy()
    for i in range(1, k):
        init[i] = init[i] @ _se3(rng.normal(0, 0.05), rng.normal(0, 0.05, 3))
    prob = make_ba_problem(init, lms + rng.normal(0, 0.05, lms.shape),
                           np.repeat(np.arange(k), m), np.tile(np.arange(m), k),
                           np.concatenate(z), device="cpu")
    return [t.numpy() for t in prob]


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


def eager(entry, p, mesh, fixed, moving, device="cpu"):
    """The mesh entry point `entry` (a name of ENTRIES) with its loop op
    by op (`sharded._run_eager`), the reference of its compiled loop."""
    run = sharded._run_eager
    if entry == "sharded":
        return sharded._align_sharded(p, mesh, fixed, moving, "sp", device,
                                      run)
    if entry == "ring":
        return sharded._align_ring(p, mesh, fixed, moving, "sp", device, run)
    return sharded._train_step_2d(p, mesh, fixed, moving, "dp", "sp", device,
                                  run)


def compiled_and_eager(cases, clouds, device="cpu"):
    """Each case (axes, entry, params, key) through the entry point, whose
    loop is compiled, then through its eager loop, on `device` (None: the
    rank's card): [(compiled result, eager result, the compiled mesh
    loops of the process, the compiled call's block replays, its loop's
    graph segments by block length)]."""
    meshes = {}
    out = []
    for axes, entry, p, key in cases:
        name = tuple(axes.items())
        if name not in meshes:
            meshes[name] = make_mesh(axes)
        mesh = meshes[name]
        fixed, moving = (cloud(a) for a in clouds[key])
        replays = compiled.run_mesh.replays
        got = result(ENTRIES[entry](p, mesh, fixed, moving, device=device))
        replays = compiled.run_mesh.replays - replays
        loop = [v for k, v in compiled.MESH.items() if k[1] == p][-1]
        segments = {n: c["segments"] for n, c in loop.captures.items()}
        ref = result(eager(entry, p, mesh, fixed, moving, device))
        out.append((got, ref, len(compiled.MESH), replays, segments))
    return out


def solvers_compiled_and_eager(axes, graph, problem, opt_kw, ba_kw,
                               device="cpu"):
    """optimize(mesh=) and ba_solve(mesh=) (`opt_kw` and `ba_kw` give
    every argument), then their eager loops, on a mesh of `axes` on
    `device` (None: the rank's card): the compiled and the eager
    results."""
    mesh = make_mesh(axes)
    ax = mesh.axis("sp")
    dev = rank_device(device)
    g = posegraph_from_numpy(*graph, device=dev)
    prob = problem_on(problem, dev)
    got = optimize(g, mesh=mesh, **opt_kw)
    ref = tpg._mesh_eager(tpg._edge_shard(g, ax), ax, opt_kw["iters"],
                          opt_kw["damping"], opt_kw["cg_iters"],
                          opt_kw["huber_delta"], opt_kw["robust"],
                          opt_kw["robust_warmup"])
    got += ba_solve(prob, mesh=mesh, device=dev, **ba_kw)
    shard, m = tba._mesh_shard(prob, ax, dev)
    poses, lms, costs = tba._solve_local(shard, ba_kw["iters"],
                                         ba_kw["damping"], ba_kw["cg_iters"],
                                         ax)
    ref += (poses, lms[:m], costs)
    return [a.cpu().numpy() for a in got], [a.cpu().numpy() for a in ref]


def mesh_again(axes, entry, p, key, clouds, device="cpu"):
    """The entry point on a mesh of `axes`, then on that mesh built again,
    and optimize(mesh=) on each: (the two results, whether the second
    mesh's "sp" group is another object than the first's, the compiled
    mesh loops after each align, the compiled solves after each
    optimize)."""
    fixed, moving = (cloud(a) for a in clouds[key])
    got, groups, loops, solves = [], [], [], []
    g = posegraph_from_numpy(*mesh_graph(), device=rank_device(device))
    for _ in range(2):
        mesh = make_mesh(axes)
        groups.append(mesh.axis("sp").group)
        got.append(result(ENTRIES[entry](p, mesh, fixed, moving,
                                         device=device)))
        loops.append(len(compiled.MESH))
        optimize(g, mesh=mesh, **OPT)
        solves.append(len(tpg.CACHE))
    return got, groups[0] is not groups[1], loops, solves


def capture_fails(axes, p, clouds):
    """align_sharded with a host read in its kernel body, whose capture
    must raise: (the error, the block replays run, the warm-up
    iterations run), on the rank's card."""
    real = sharded._sharded_kernel_body

    def with_host_read(*args):
        body = real(*args)

        def reads(state, *inputs):
            float(state.ell.item())
            return body(state, *inputs)
        return reads

    sharded._sharded_kernel_body = with_host_read
    replays, warmups = compiled.run_mesh.replays, compiled.run_mesh.warmups
    try:
        align_sharded(p, make_mesh(axes), *(cloud(a) for a in clouds))
        err = None
    except RuntimeError as e:
        err = str(e)
    finally:
        sharded._sharded_kernel_body = real
    torch.cuda.synchronize()
    return (err, compiled.run_mesh.replays - replays,
            compiled.run_mesh.warmups - warmups)


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
