"""Device meshes over torch.distributed ranks (the JAX package's
`parallel/mesh.py`), and a local launcher that starts the ranks.

JAX lays one process's devices out as a `Mesh`; here each device of the
mesh is a rank of the initialized process group, one process each, and
`make_mesh` lays the ranks out as a `torch.distributed` `DeviceMesh` with
named axes.  The port is SPMD: every rank calls the same entry point with
the same arguments, takes its own block by its index on an axis, and
gets the same replicated result, as one process gets it from JAX's
`shard_map`.

A rank's device is the card unless the caller asks for the CPU:
`cuda:(local_rank % device_count)`, `local_rank` from the `LOCAL_RANK`
variable (set by `torchrun` and by `launch`).

    python -m torch.distributed.run --nproc-per-node 2 my_script.py

starts ranks that call `multihost_initialize(backend="nccl")` (one card
each) and then `make_mesh`; `launch` starts them on one host from Python,
which is how the tests (gloo, on the CPU) and `chip_smoke.py` (two or
four ranks sharing one card over gloo, or one rank over NCCL) run them.
"""

from __future__ import annotations

import datetime
import logging
import os
import tempfile
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from cvo_rgbd_torch.device import resolve_device

# every process group gets one: a collective that never completes raises
# after it instead of hanging its rank
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


class Axis(NamedTuple):
    """One axis of a mesh as this rank sees it."""

    name: str
    size: int
    index: int           # this rank's position on the axis
    group: object        # the process group of this rank's line on it
    ranks: tuple         # that group's global ranks, in axis order


class Mesh:
    """A `DeviceMesh` over the ranks with JAX's reading: `shape` is
    {axis: size}, and `axis(name)` gives this rank's index and process
    group on an axis."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        names = device_mesh.mesh_dim_names
        self.shape = dict(zip(names, device_mesh.mesh.shape))
        self._axes = {}

    def axis(self, name: str) -> Axis:
        if name not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {name!r}")
        if name not in self._axes:
            group = self.device_mesh.get_group(name)
            size = self.shape[name]
            self._axes[name] = Axis(
                name, size, self.device_mesh.get_local_rank(name), group,
                tuple(dist.get_global_rank(group, i) for i in range(size)))
        return self._axes[name]


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a mesh from `axes` = {name: size} over `devices` (global
    ranks; default every rank of the initialized world); -1 means "the
    rest".  Default: all ranks on one "sp" axis.  Every rank of the world
    calls it with the same arguments.  Raises ValueError when the mesh
    needs more ranks than there are."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: "
                           "call multihost_initialize first")
    devices = list(range(dist.get_world_size()) if devices is None
                   else devices)
    n = len(devices)
    if axes is None:
        axes = {"sp": n}
    names = list(axes)
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {axes} needs {total} devices, have {n}")
    ranks = torch.tensor(devices[:total], dtype=torch.int).reshape(sizes)
    # the mesh's groups take the world's backend: a gloo world stays gloo
    # (CUDA payloads are staged through host memory, collectives.py)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(DeviceMesh(kind, ranks, mesh_dim_names=tuple(names)))


def multihost_initialize(**kwargs):
    """Initialize torch.distributed (`init_process_group(**kwargs)`)
    with loud failure semantics: a repeated call in the same process is
    benign (so a caller may call it unconditionally), and any real failure
    (a bad address, an unreachable peer, a size mismatch, NCCL asked for
    and missing) is logged and re-raised.  A `timeout` is always set
    (DEFAULT_TIMEOUT unless given), so a hung collective raises.

    One process per rank:
        multihost_initialize(backend="nccl", init_method="tcp://host0:29500",
                             world_size=W, rank=r)
    or, under torchrun, `multihost_initialize(backend="nccl")`."""
    if dist.is_initialized():
        return
    kwargs.setdefault("timeout", DEFAULT_TIMEOUT)
    log = logging.getLogger(__name__)
    try:
        if kwargs.get("backend") == "nccl" and not (
                dist.is_nccl_available() and torch.cuda.is_available()):
            raise RuntimeError("NCCL was asked for and this torch or host "
                               "has none")
        dist.init_process_group(**kwargs)
    except Exception as e:
        if "already" in str(e).lower() and dist.is_initialized():
            return
        log.error("torch.distributed.init_process_group(%s) failed: %s",
                  kwargs, e)
        raise


def rank_device(device=None) -> torch.device:
    """A rank's device: `device` when given, else the card
    `cuda:(local_rank % device_count)`; raises without one."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", int(local) % torch.cuda.device_count())


def _rank_main(fn, args, rank, world, backend, device, init, out, timeout,
               threads):
    """One rank of `launch`: initialize, run, save the result or the
    traceback to `out`."""
    os.environ["LOCAL_RANK"] = str(rank)
    if threads:
        torch.set_num_threads(threads)
    try:
        if device is None or torch.device(device).type == "cuda":
            torch.cuda.set_device(rank_device(device))
        multihost_initialize(backend=backend, init_method=init,
                             world_size=world, rank=rank,
                             timeout=datetime.timedelta(seconds=timeout))
        result = fn(*args)
        dist.barrier()
        dist.destroy_process_group()
        _save({"result": result}, out)
    except Exception:
        _save({"error": traceback.format_exc()}, out)
        os._exit(1)


def _save(obj, out):
    """Write a rank's outcome under its final name only once it is whole:
    `launch` kills the other ranks when one fails, and must never read a
    file cut off mid-write."""
    torch.save(obj, out + ".part")
    os.replace(out + ".part", out)


def launch(fn, world: int, args=(), *, backend: str = "gloo", device=None,
           timeout: float = 600.0, threads: int | None = None):
    """Run `fn(*args)` on `world` ranks started on this host (spawned
    processes), each with the process group initialized
    (`multihost_initialize`, a `file://` store in a temporary directory,
    so concurrent launches share no port); returns the ranks' results in
    rank order, each loaded to the CPU.

    `fn` must be importable by name (a module's top-level function).
    `device` is every rank's device (None: the card, `rank_device`);
    `threads` caps each rank's CPU threads.  A rank that raises, or a
    run past `timeout` seconds, stops every rank and raises here with
    the ranks' tracebacks."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, tuple(args), r, world, backend, device, init, outs[r],
            timeout, threads)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = False
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    failed = True
                    break
                if time.monotonic() > deadline:
                    failed = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        saved = [torch.load(o, map_location="cpu", weights_only=False)
                 if os.path.exists(o) else None for o in outs]
        errors = [f"rank {r}:\n{s['error']}" for r, s in enumerate(saved)
                  if s is not None and "error" in s]
        if errors or failed or any(p.exitcode for p in procs):
            why = "\n".join(errors) or (
                f"ranks exited {[p.exitcode for p in procs]} "
                f"(timeout {timeout} s)")
            raise RuntimeError(f"launch of {fn.__name__} on {world} ranks "
                               f"failed:\n{why}")
        return [s["result"] for s in saved]
