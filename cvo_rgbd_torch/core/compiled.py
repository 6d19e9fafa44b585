"""The compiled align loop: the JAX package's `align_jit` on the card.

JAX compiles the whole align, a `lax.while_loop` around its kernels,
once per (params, capacity).  Here the kernel and dense backends' loop
is captured once per (params, fixed capacity, moving capacity, device)
as CUDA graphs: a block of CHECK_EVERY iterations of `make_align_step`'s
body, run in place on a static state, and, when `max_iter` is not a
multiple of CHECK_EVERY, a tail of the last `max_iter % CHECK_EVERY`
iterations (past `max_iter` an unconverged state would move on).  A
call replays the block until `converged` reads true, one `.item()` a
replay, as `align` reads it every CHECK_EVERY iterations, so the host
launches one graph where `align` launches ~1250 kernels an iteration.

What is per align stays outside the graphs and runs as `align` runs
it: the routing, the feature padding, the kd-sorts and `prepare`
(`color_gram`, the moment precompute, the tile orders, acvo's
Chebyshev tables, whose span depends on a host ell0).  Each call copies
the pair, its `prepare` output and the warm state into the compiled
object's static tensors; the graphs read only those.

`parallel.align_batched` routes and prepares a batch of pairs at once
(`prepare_batch`: one `color_gram` launch a cache for all the lanes,
one `fused_wsq` launch for acvo's Chebyshev tables).  On the dense
backend and the kernel backend's moment step the whole batch is one
compiled loop here, the clouds, `pre` and the state on a leading lane
axis (`registration.make_batched_step`): on the kernel backend one
`fused_moments` launch an iteration for the batch (and exact acvo's one
`fused_wsq` launch), the graphs captured once per (params, lanes,
capacities, device, layout), a replay read for `converged.all()`, so
the batch runs until its slowest lane converges and a converged lane
stays frozen.  The kernel backend's direct step runs each lane through
its one-pair compiled align, every lane of one key through one compiled
align.

The result is `align`'s bits: the graphs hold the same launches in the
same order, and the kernels take no float atomics.  On the CPU
(`device="cpu"`) the very same block function runs on the same static
tensors, uncaptured.  The fused backend's loop is one launch already:
`align_jit` takes `align`'s route for it.

Capture on the card never falls back: a block that cannot be captured
raises.  Before capture, one eager warm-up block on the capture stream
loads the kernels' libraries and modules (and creates NCCL's
communicators), and the stream's kernel tickets
(`ops.gram.stream_tickets`) exist, zeroed, outside the graph's memory
pool.  The wrappers' launch counters, and the collectives' calls, count
at capture, not at replay: each graph records its counts, adds them on
every replay, and `align_jit.replays` counts the replays (on the CPU,
the blocks run; `run_mesh.replays` for the mesh paths).  The warm-up
block's launches are counted as they run, and `align_jit.warmups`
counts its iterations.

`CapturedProgram` is the same design for a function of a few tensors
that runs once a call: the frontend (`frontend.pipeline.Frontend`, the
JAX package's `jax.jit` of `_process`) and the odometry step's
bookkeeping after align (`odometry._odom_step`, the rest of JAX's
jitted step), one graph each, a replay a call; `program_for` keeps one
per (name, static arguments, input key) for `cli slam`'s inner
products, `cloud_ok`, its SLAM step and multiseq's lane post.
`CapturedLoop` is its in-place iteration form, JAX's `lax.scan` of a
step: one captured step on a static state, replayed n times a call
(`posegraph.optimize` and `ba_solve`, with a mesh or without).

The mesh paths (`parallel/sharded.py`: `align_sharded`, `train_step_2d`,
`align_ring`; JAX jits each as a `shard_map` of its loop) run through
`run_mesh`: the path's per-align precompute (its psums and gathers
included) runs eagerly, then its step, a function of the state, its
blocks and that precompute, goes through a `CompiledAlign` keyed also
by the mesh axis and its backend, blocks and tail as above.  A step's
collectives (`collectives.py`) shape its capture: on an NCCL axis a
block is one graph, the all_reduces inside it; gloo stages CUDA
payloads through host memory, which no graph can hold, so on a gloo
axis a block is graph segments cut at each collective, the staged
transports run between them at replay (`_Segments`).  The eager loops
stay as the references the tests hold these to (`sharded._run_eager`,
`posegraph._mesh_eager`, `ba._solve_local`).
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

from cvo_rgbd_torch import collectives, ops
from cvo_rgbd_torch.core.registration import (
    CHECK_EVERY,
    AlignResult,
    check_supported,
    init_state,
    make_align_step,
    make_batched_step,
    prepare,
    route,
)
from cvo_rgbd_torch.device import pin_fp32, resolve_device
from cvo_rgbd_torch.ops.align_fused import align_fused
from cvo_rgbd_torch.ops.gram import stream_tickets
from cvo_rgbd_torch.ops.wsq import MAX_UNITS

# the wrappers (and kernel forms) whose launches a graph holds
COUNTED = (ops.color_gram, ops.fused_moments, ops.fused_moments.lanes,
           ops.fused_wsq, ops.fused_flow, ops.fused_step_coeffs)

# the compiled aligns, one per (params, fixed capacity, moving capacity,
# device, layout, lanes), kept for the life of the process as JAX keeps its
# compiled aligns; `align_jit.cache_clear()` drops them
CACHE: dict = {}
# the compiled mesh loops of `run_mesh`, kept likewise
MESH: dict = {}
# the captured programs of `program_for` (the keyframe inner products,
# `cloud_ok`, the SLAM step, multiseq's lane post), kept likewise
PROGRAMS: dict = {}


def _strides(x) -> tuple:
    """The strides of the tensors of `x` (nested tuples of tensors): a
    compiled align keeps its first inputs' layout, and eager torch may
    round another layout otherwise (a transposed R0 takes another
    matmul path on the first iteration)."""
    if isinstance(x, torch.Tensor):
        return (x.stride(),)
    return sum((_strides(v) for v in x if v is not None), ())


def _static(x):
    """A copy of `x` (a tensor, None or a tuple of them, nested), each
    tensor with its own storage of the same shape, type and strides."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        items = [_static(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _copy_in(dst, src, non_blocking=False):
    """Copy `src` into the static `dst` of the same structure; raises
    where a tensor's shape or type differs from the compiled one.
    `non_blocking` for a source in pinned host memory."""
    if isinstance(dst, torch.Tensor):
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(
                f"compiled for {dst.dtype} {tuple(dst.shape)}, got "
                f"{src.dtype} {tuple(src.shape)}")
        dst.copy_(src, non_blocking=non_blocking)
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src, strict=True):
            _copy_in(d, s, non_blocking)
    elif src is not None:
        raise ValueError("an input the compiled program lacks")


def _fresh(out):
    """A copy of `out` (a tensor or a tuple of them), each tensor with
    storage of its own."""
    if isinstance(out, tuple):
        return tuple(t.clone() for t in out)
    return out.clone()


class _Segments:
    """A block captured on a gloo axis: CUDA graph segments cut at its
    collectives, each exchange between two segments reading the static
    buffers the segment before it wrote and writing those the segment
    after it was captured reading (`collectives.cutting`).  A replay runs
    them in turn, each exchange's staged transport on the host."""

    def __init__(self):
        self.graphs, self.exchanges = [], []

    def replay(self):
        for graph, ex in zip(self.graphs, self.exchanges + [None]):
            graph.replay()
            if ex is not None:
                collectives.exchange(*ex)


class _Capture:
    """The CUDA graphs of one compiled object, captured on one side
    stream into one memory pool, each after one eager warm-up run there
    (which loads the kernels' modules, creates NCCL's communicators and
    leaves the stream's kernel tickets, `ops.gram.stream_tickets`,
    zeroed outside the pool), with the wrappers' launch counts and the
    collectives' calls moved from the capture to each replay and the
    capture's seconds, pool bytes and segments recorded (`captures`).
    With a mesh `axis` whose collectives a graph can hold (NCCL) a
    capture is one graph, collectives included; on a gloo axis it is
    graph segments cut at each collective (`_Segments`).  Capture never
    falls back: a body that cannot be captured (a host sync, a
    host-to-card copy) raises, naming what was captured."""

    def __init__(self, device, what, axis=None):
        self.device, self.what, self.axis = device, what, axis
        self.captures = {}   # name -> capture seconds, bytes, segments
        self.counts = {}     # name -> ([(wrapper, launches)], calls)
        self.stream = self.pool = None

    def _segmented(self, body):
        """`body` captured as `_Segments`, and its output."""
        segs = _Segments()
        cur = [torch.cuda.CUDAGraph()]

        def cut(kind, flats, axis):
            cur[0].capture_end()
            segs.graphs.append(cur[0])
            outs = [collectives.result_like(kind, f, axis) for f in flats]
            segs.exchanges.append((kind, flats, axis, outs))
            cur[0] = torch.cuda.CUDAGraph()
            cur[0].capture_begin(pool=self.pool)
            return outs

        with torch.cuda.stream(self.stream):
            cur[0].capture_begin(pool=self.pool)
            try:
                with collectives.cutting(cut):
                    out = body()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    cur[0].capture_end()
                raise
            cur[0].capture_end()
        segs.graphs.append(cur[0])
        return segs, out

    def capture(self, name, body, keep=(), label=None, warmed=None):
        """Run `body` eagerly on the capture stream and put back the
        tensors of `keep` (what the warm-up moved), call `warmed()`, then
        capture `body` there; returns the graph (or `_Segments`) and
        `body`'s output.  `label` names the capture in an error (default
        `what`)."""
        dev = self.device
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
            self.pool = torch.cuda.graph_pool_handle()
            with torch.cuda.stream(self.stream):
                self.tickets, _ = stream_tickets(dev, MAX_UNITS)
        saved = [t.clone() for t in keep]
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            body()
            for dst, src in zip(keep, saved):
                dst.copy_(src)
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        if warmed is not None:
            warmed()
        before = [w.launches for w in COUNTED]
        stats = dict(collectives.STATS)
        # what torch.cuda.graph frees on entry, freed first, so that the
        # reserved bytes' growth is the graph's pool
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        mem0 = (torch.cuda.memory_allocated(dev),
                torch.cuda.memory_reserved(dev))
        t0 = time.perf_counter()
        try:
            if self.axis is not None and not collectives.capturable(
                    self.axis):
                graph, out = self._segmented(body)
            else:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self.pool,
                                      stream=self.stream):
                    out = body()
        except Exception as e:
            raise RuntimeError(
                f"capturing {label or self.what} failed: {e}") from e
        finally:
            counts = [(w, w.launches - b) for w, b in zip(COUNTED, before)]
            for w, b in zip(COUNTED, before):
                w.launches = b
            calls = collectives.STATS["calls"] - stats["calls"]
            collectives.STATS.update(stats)
        self.captures[name] = {
            "seconds": time.perf_counter() - t0,
            "allocated_bytes": torch.cuda.memory_allocated(dev) - mem0[0],
            "reserved_bytes": torch.cuda.memory_reserved(dev) - mem0[1],
            "segments": len(getattr(graph, "graphs", (graph,)))}
        self.counts[name] = ([(w, k) for w, k in counts if k], calls)
        return graph, out

    def replayed(self, name, graph, n=1):
        for _ in range(n):
            graph.replay()
        launches, calls = self.counts[name]
        for wrapper, k in launches:
            wrapper.launches += k * n
        collectives.STATS["calls"] += calls * n


class CapturedProgram:
    """`fn` (tensors -> a tensor or a tuple of tensors) on static inputs:
    one CUDA graph on the card, captured on the first run after one
    eager warm-up run on the capture stream, replayed on every run; on
    the CPU `fn` itself on the same static inputs.  Built from an example
    of the inputs (their shapes, types and strides); `what` names the
    program in a capture's error.  A run returns a fresh copy of each
    output (a replay overwrites the static ones), one launch.  `runs`
    counts the runs (on the card, the replays); `captures` holds the
    capture's seconds and pool bytes.  The frontend
    (`frontend.pipeline.Frontend`), the odometry step's bookkeeping
    (`odometry._odom_step`), the keyframe inner products
    (`keyframes.py`), the SLAM step and `cloud_ok` (`slam.py`) and
    multiseq's lane post run as these."""

    def __init__(self, fn, example, what):
        self.fn, self.what = fn, what
        self.inputs = _static(example)
        self.device = self.inputs[0].device
        self.graph = self.output = None
        self.runs = 0
        self._cap = _Capture(self.device, what)
        self.captures = self._cap.captures

    def load(self, inputs, non_blocking=False):
        """Copy `inputs` into the static inputs (`non_blocking` for
        sources in pinned host memory)."""
        _copy_in(self.inputs, tuple(inputs), non_blocking)

    def run(self):
        """Run on the static inputs; a copy of the output."""
        if self.device.type != "cuda":
            self.output = self.fn(*self.inputs)
        elif self.graph is None:
            self.graph, self.output = self._cap.capture(
                "run", lambda: self.fn(*self.inputs))
            self._cap.replayed("run", self.graph)
        else:
            self._cap.replayed("run", self.graph)
        self.runs += 1
        return _fresh(self.output)

    def __call__(self, *inputs):
        self.load(inputs)
        return self.run()


def program_for(name, fn, static, inputs):
    """The captured program of `fn(*static, *inputs)`, one per (name,
    `static` (hashable), device, the inputs' shapes, types and strides)
    in `PROGRAMS`, built on the key's first call."""
    dev = inputs[0].device
    key = (name, static, dev, tuple((t.shape, t.dtype) for t in inputs),
           _strides(inputs))
    program = PROGRAMS.get(key)
    if program is None:
        program = PROGRAMS[key] = CapturedProgram(
            functools.partial(fn, *static), inputs,
            f"{name} of {static} on {dev} for inputs "
            + ", ".join(f"{t.dtype} {tuple(t.shape)}" for t in inputs))
    return program


class CapturedLoop:
    """The in-place iteration form of `CapturedProgram`, the JAX
    package's `lax.scan` of a step: each `step` of `steps` ({name: fn})
    updates the static `state` (a tuple of tensors the caller owns and
    loads) in place and returns nothing; a call `run(name, n)` runs step
    `name` `n` times.  On the card each step is one CUDA graph, captured
    on its first run after one eager warm-up run whose effect on the
    state is undone before the capture, and replayed `n` times (a step
    with the collectives of a gloo mesh `axis`: graph segments cut at
    them, `_Capture`); on the CPU the step itself runs `n` times on the
    same state.  `runs` counts the iterations run (on the card, the
    replays); `captures` holds each step's capture seconds, pool bytes
    and segments.  `posegraph.optimize` and `parallel.ba.ba_solve` run
    their Gauss-Newton loops as these, with a mesh or without."""

    def __init__(self, steps, state, what, axis=None):
        self.steps, self.state, self.what = steps, state, what
        self.device = state[0].device
        self.graphs = {}
        self.runs = 0
        self.axis = axis
        self._cap = _Capture(self.device, what, axis)
        self.captures = self._cap.captures

    def run(self, name, n):
        if n <= 0:
            return
        step = self.steps[name]
        if self.device.type != "cuda":
            for _ in range(n):
                step(*self.state)
        else:
            graph = self.graphs.get(name)
            if graph is None:
                graph, _ = self._cap.capture(
                    name, lambda: step(*self.state), keep=self.state)
                self.graphs[name] = graph
            self._cap.replayed(name, graph, n)
        self.runs += n


class CompiledAlign:
    """The align loop of one cache key on static tensors: `align_jit`'s
    (params, lanes, capacities, device, layout), built from the first
    call's inputs after `route` and `prepare` (one pair), or
    `prepare_batch` for B pairs on a lane axis (the batched loop,
    `make_batched_step`); or a mesh path's (`run_mesh`), whose `body`
    and per-align `pre` are its own and whose collectives run over
    `axis`.  `counter` (`align_jit` or `run_mesh`) counts its replays
    and warm-up iterations.  `captures` records, per graph length, the
    capture's seconds, the growth of the card's allocated and reserved
    bytes across it (the graph's pool: the blocks its launches write,
    which stay reserved for its replays) and its graph segments."""

    def __init__(self, p, fixed, moving, pre, state, body=None, axis=None,
                 counter=None, what=None):
        self.p = p
        self.fixed, self.moving = _static(fixed), _static(moving)
        self.pre, self.state = _static(pre), _static(state)
        lanes = state.converged.dim() == 1
        self.body = body or (make_batched_step(p) if lanes
                             else make_align_step(p))
        self.counter = counter or align_jit
        self.device = state.R.device
        self.graphs = {}     # length -> CUDAGraph or _Segments
        self.axis = axis
        self._cap = _Capture(self.device,
                             what or f"align_jit's {p.backend} backend",
                             axis)
        self.captures = self._cap.captures

    def block(self, n):
        """`n` iterations of the body on the static state, in place."""
        state = self.state
        for _ in range(n):
            state = self.body(state, self.fixed, self.moving, self.pre)
        for dst, src in zip(self.state, state):
            dst.copy_(src)

    def run(self, n):
        """One block of `n` iterations: a graph replay on the card (the
        graph captured on first use, after an eager warm-up block), the
        block itself on the CPU."""
        if self.device.type != "cuda":
            self.block(n)
        else:
            graph = self.graphs.get(n)
            if graph is None:
                def warmed():
                    self.counter.warmups += n

                graph, _ = self._cap.capture(
                    n, lambda: self.block(n), keep=self.state,
                    label=f"{n} iterations of {self._cap.what}",
                    warmed=warmed)
                self.graphs[n] = graph
            self._cap.replayed(n, graph)
        self.counter.replays += 1

    def __call__(self, fixed, moving, pre, state) -> AlignResult:
        for dst, src in ((self.fixed, fixed), (self.moving, moving),
                         (self.pre, pre), (self.state, state)):
            _copy_in(dst, src)
        full, tail = divmod(self.p.max_iter, CHECK_EVERY)
        for _ in range(full):
            self.run(CHECK_EVERY)
            if bool(self.state.converged.all().item()):
                break
        else:
            if tail:
                self.run(tail)
        s = self.state
        # fresh tensors: the next call overwrites the static state
        return AlignResult(
            tf=s.tf.clone(), R=s.R.clone(), T=s.T.clone(),
            iterations=s.k - 1, converged=s.converged.clone(),
            ell=s.ell.clone(), omega=s.omega.clone(), v=s.v.clone())


def run_compiled(p, fixed, moving, pre, state) -> AlignResult:
    """The compiled loop of this key on a pair as `align` runs it:
    clouds already routed, `pre` their `prepare` output, `state` from
    `init_state`; or on B pairs at once, the clouds stacked on a lane
    axis, `pre` from `prepare_batch` and `state` from `init_state(...,
    lanes=B)` (the dense backend and the kernel backend's moment step).
    The compiled align is built on the key's first call.  The lanes of
    the kernel backend's direct step come here one by one: a lane view
    of a contiguous stack has the strides of a fresh tensor of its
    shape, and another layout keys its own compiled align."""
    dev = fixed.positions.device
    key = (p, fixed.capacity, moving.capacity, dev,
           _strides((fixed, moving, state)),
           tuple(fixed.positions.shape[:-2]))
    compiled = CACHE.get(key)
    if compiled is None:
        compiled = CACHE[key] = CompiledAlign(p, fixed, moving, pre, state)
    return compiled(fixed, moving, pre, state)


def axis_key(axis) -> tuple:
    """A mesh axis in a cache key: what its process group stands for (the
    axis's name and size, this rank's index, the group's ranks and
    backend), not the group object, which a mesh built again may make
    anew (`DeviceMesh` makes a 2-D mesh's subgroups on every build)."""
    return (axis.name, axis.size, axis.index, axis.ranks,
            collectives.backend(axis))


def cached(cache, key, axis, build):
    """`cache[key]`, built by `build()` on the key's first call, and built
    again in its place when the mesh `axis` (or None) holds another
    process group than the entry's: a graph holds the collectives of the
    group it was captured on, and the old entry's graphs and pool go with
    it."""
    entry = cache.get(key)
    if entry is None or (axis is not None
                         and entry.axis.group is not axis.group):
        entry = cache[key] = build()
    return entry


def run_mesh(entry, p, axis, body, x, y, pre, state) -> AlignResult:
    """The compiled loop of a mesh path on this rank, run as `align_jit`
    runs its loop: `body(state, x, y, pre) -> state` is the path's
    iteration (`parallel/sharded.py`) on this rank's blocks `x` and `y`,
    reading what is per align only from `pre` (the path's precompute,
    run eagerly before, its collectives included) and the state from
    `init_state`; blocks of CHECK_EVERY iterations and the tail of
    `max_iter % CHECK_EVERY`, `converged` read once a block (every rank
    reads the same bits, so every rank stops together).  One compiled
    loop per (entry point, params, block capacities, the axis (its size,
    index, ranks and backend: `axis_key`), device, layout) in `MESH`,
    built on the key's first call and again when the axis's process
    group is another (`cached`); on the card a block is one graph on an
    NCCL axis, its collectives inside, and graph segments with the
    staged collectives between them on a gloo axis."""
    dev = state.R.device
    key = (entry, p, x.capacity, y.capacity, axis_key(axis), dev,
           _strides((x, y, pre, state)))
    compiled = cached(MESH, key, axis, lambda: CompiledAlign(
        p, x, y, pre, state, body=body, axis=axis, counter=run_mesh,
        what=f"{entry} on {axis.name}={axis.size} (index {axis.index}, "
             f"{collectives.backend(axis)}) on {dev}"))
    return compiled(x, y, pre, state)


run_mesh.replays = 0
run_mesh.warmups = 0


def align_jit(p, fixed, moving, R0=None, T0=None, ell0=None,
              device=None) -> AlignResult:
    """`align` (core/registration.py) with its loop compiled once per
    (params, fixed capacity, moving capacity, device) and layout of the
    clouds and the warm state: the same arguments, the same result
    bits, in fresh tensors.  The fused backend takes `align`'s route."""
    check_supported(p)
    dev = resolve_device(device)
    pin_fp32()
    p, fixed, moving = route(p, fixed.to(dev), moving.to(dev))
    align_jit.calls += 1
    if p.backend == "fused":
        return align_fused(p, fixed, moving, R0, T0, ell0)
    dev = fixed.positions.device
    state = init_state(p, dev, R0, T0, ell0)
    pre = prepare(p, fixed, moving, ell0)
    return run_compiled(p, fixed, moving, pre, state)


align_jit.calls = 0
align_jit.replays = 0
align_jit.warmups = 0
align_jit.cache_clear = CACHE.clear
