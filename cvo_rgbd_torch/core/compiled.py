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
loads the kernels' libraries and modules, and the stream's kernel
tickets (`ops.gram.stream_tickets`) exist, zeroed, outside the graph's
memory pool.  The wrappers' launch counters count at capture, not at
replay: each graph records its counts, adds them on every replay, and
`align_jit.replays` counts the replays (on the CPU, the blocks run).
The warm-up block's launches are counted as they run, and
`align_jit.warmups` counts its iterations.

`CapturedProgram` is the same design for a function of a few tensors
that runs once a call: the frontend (`frontend.pipeline.Frontend`, the
JAX package's `jax.jit` of `_process`) and the odometry step's
bookkeeping after align (`odometry._odom_step`, the rest of JAX's
jitted step), one graph each, a replay a call; `program_for` keeps one
per (name, static arguments, input key) for `cli slam`'s inner
products, `cloud_ok`, its SLAM step and multiseq's lane post.
`CapturedLoop` is its in-place iteration form, JAX's `lax.scan` of a
step: one captured step on a static state, replayed n times a call
(`posegraph.optimize` and `ba_solve` without a mesh).
"""

from __future__ import annotations

import functools
import time

import torch

from cvo_rgbd_torch import ops
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


class _Capture:
    """A CUDA graph's capture on a side stream after one eager warm-up
    run there, with the wrappers' launch counts moved from the capture to
    each replay and the capture's seconds and pool bytes recorded
    (`captures`, as `CompiledAlign` records them).  Capture never falls
    back: a body that cannot be captured (a host sync, a host-to-card
    copy) raises with `what`."""

    def __init__(self, device, what):
        self.device, self.what = device, what
        self.captures = {}   # name -> capture seconds and bytes
        self.counts = {}     # name -> [(wrapper, launches)]

    def capture(self, name, body, warm_up=None):
        """Run `warm_up` (default `body`) eagerly on a side stream, then
        capture `body` there; returns the graph and `body`'s output."""
        dev = self.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            (warm_up or body)()
        torch.cuda.current_stream(dev).wait_stream(stream)
        before = [w.launches for w in COUNTED]
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        mem0 = (torch.cuda.memory_allocated(dev),
                torch.cuda.memory_reserved(dev))
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream):
                out = body()
        except Exception as e:
            raise RuntimeError(f"capturing {self.what} failed: {e}") from e
        finally:
            counts = [(w, w.launches - b) for w, b in zip(COUNTED, before)]
            for w, b in zip(COUNTED, before):
                w.launches = b
        self.captures[name] = {
            "seconds": time.perf_counter() - t0,
            "allocated_bytes": torch.cuda.memory_allocated(dev) - mem0[0],
            "reserved_bytes": torch.cuda.memory_reserved(dev) - mem0[1]}
        self.counts[name] = [(w, k) for w, k in counts if k]
        return graph, out

    def replayed(self, name, graph, n=1):
        for _ in range(n):
            graph.replay()
        for wrapper, k in self.counts[name]:
            wrapper.launches += k * n


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
    state is undone before the capture, and replayed `n` times; on the
    CPU the step itself runs `n` times on the same state.  `runs` counts
    the iterations run (on the card, the replays); `captures` holds each
    step's capture seconds and pool bytes.  `posegraph.optimize` and
    `parallel.ba.ba_solve` without a mesh run their Gauss-Newton loops
    as these."""

    def __init__(self, steps, state, what):
        self.steps, self.state, self.what = steps, state, what
        self.device = state[0].device
        self.graphs = {}
        self.runs = 0
        self._cap = _Capture(self.device, what)
        self.captures = self._cap.captures

    def _capture(self, name):
        step = self.steps[name]
        saved = [t.clone() for t in self.state]

        def warm_up():
            # an eager step, undone; the capture itself runs nothing
            step(*self.state)
            for dst, src in zip(self.state, saved):
                dst.copy_(src)

        graph, _ = self._cap.capture(name, lambda: step(*self.state),
                                     warm_up)
        self.graphs[name] = graph
        return graph

    def run(self, name, n):
        if n <= 0:
            return
        if self.device.type != "cuda":
            for _ in range(n):
                self.steps[name](*self.state)
        else:
            graph = self.graphs.get(name) or self._capture(name)
            self._cap.replayed(name, graph, n)
        self.runs += n


class CompiledAlign:
    """The align loop of one cache key (params, lanes, capacities,
    device, layout) on static tensors; built from the first call's
    inputs, after `route` and `prepare` (one pair), or `prepare_batch`
    for B pairs on a lane axis (the batched loop, `make_batched_step`).  `captures` records, per graph length, the
    capture's seconds and the growth of the card's allocated and
    reserved bytes across it (the graph's pool: the blocks its launches
    write, which stay reserved for its replays)."""

    def __init__(self, p, fixed, moving, pre, state):
        self.p = p
        self.fixed, self.moving = _static(fixed), _static(moving)
        self.pre, self.state = _static(pre), _static(state)
        lanes = state.converged.dim() == 1
        self.body = make_batched_step(p) if lanes else make_align_step(p)
        self.device = state.R.device
        self.graphs = {}     # length -> (CUDAGraph, [(wrapper, launches)])
        self.captures = {}   # length -> capture seconds and bytes
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()
            # the capture stream's tickets, zero, held for the graphs
            with torch.cuda.stream(self.stream):
                self.tickets, _ = stream_tickets(self.device, MAX_UNITS)

    def block(self, n):
        """`n` iterations of the body on the static state, in place."""
        state = self.state
        for _ in range(n):
            state = self.body(state, self.fixed, self.moving, self.pre)
        for dst, src in zip(self.state, state):
            dst.copy_(src)

    def _capture(self, n):
        """Warm up, then capture, the block of `n` iterations; the static
        state is left as it was."""
        dev = self.device
        saved = [t.clone() for t in self.state]
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            self.block(n)
        align_jit.warmups += n
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        before = [w.launches for w in COUNTED]
        # what torch.cuda.graph frees on entry, freed first, so that the
        # reserved bytes' growth is the graph's pool
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        mem0 = (torch.cuda.memory_allocated(dev),
                torch.cuda.memory_reserved(dev))
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                self.block(n)
        except Exception as e:
            raise RuntimeError(
                f"align_jit: capturing {n} iterations of the {self.p.backend} "
                f"backend failed: {e}") from e
        finally:
            counts = [(w, w.launches - b) for w, b in zip(COUNTED, before)]
            for w, b in zip(COUNTED, before):
                w.launches = b
        self.captures[n] = {
            "seconds": time.perf_counter() - t0,
            "allocated_bytes": torch.cuda.memory_allocated(dev) - mem0[0],
            "reserved_bytes": torch.cuda.memory_reserved(dev) - mem0[1]}
        for dst, src in zip(self.state, saved):
            dst.copy_(src)
        self.graphs[n] = (graph, [(w, k) for w, k in counts if k])
        return self.graphs[n]

    def run(self, n):
        """One block of `n` iterations: a graph replay on the card (the
        graph captured on first use), the block itself on the CPU."""
        if self.device.type != "cuda":
            self.block(n)
        else:
            graph, counts = self.graphs.get(n) or self._capture(n)
            graph.replay()
            for wrapper, k in counts:
                wrapper.launches += k
        align_jit.replays += 1

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
