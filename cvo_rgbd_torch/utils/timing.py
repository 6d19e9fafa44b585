"""Phase timers and a device trace of a run.

Port of the JAX package's `utils/timing.py`: `PhaseTimer` waits on
tensors with `torch.cuda.synchronize` where the JAX one blocks on
arrays, and `profiler_trace` records a `torch.profiler` trace (CPU and
CUDA activities) where the JAX one records a `jax.profiler` trace.
"""

from __future__ import annotations

import contextlib
import os
import re
import socket
import time
from collections import Counter, defaultdict

import torch

# the device-side event categories of a Kineto Chrome trace
_DEVICE_EVENT = re.compile(rb'"cat":\s*"(kernel|gpu_memcpy|gpu_memset)",'
                           rb'\s*"name":\s*"((?:[^"\\]|\\.)*)"')
_CHUNK = 1 << 26


def _wait(value):
    """Wait until every CUDA tensor in `value` (a tensor, or lists,
    tuples and dicts of them) is computed; returns `value`.  A CPU
    tensor needs no wait."""
    devices = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                devices.add(v.device)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    walk(value)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return value


class PhaseTimer:
    """Accumulating wall-clock timer keyed by phase name.

    Use `timer.phase("frontend")` as a context manager; pass tensors to
    `sync=` to wait for the device to compute them before the clock
    stops.
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _wait(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def sync_point(self, name, value):
        """Wait on `value` and charge the wait to `name`."""
        t0 = time.perf_counter()
        _wait(value)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return value

    def report(self):
        return {
            name: {
                "total_s": round(self.totals[name], 6),
                "count": self.counts[name],
                "mean_ms": round(
                    1e3 * self.totals[name] / max(self.counts[name], 1), 3
                ),
            }
            for name in sorted(self.totals)
        }


def device_events(path) -> Counter:
    """Device events of a Chrome trace file by name: its kernels, copies
    and sets.  Reads the file in chunks, so a trace of many hundred MB
    needs no JSON parse."""
    names = Counter()
    tail = b""
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(_CHUNK)
            data = tail + chunk
            end = 0
            for m in _DEVICE_EVENT.finditer(data):
                names[m.group(2).decode("utf-8", "replace")] += 1
                end = m.end()
            if not chunk:
                return names
            # a match cut by the chunk's end is found again in the next
            tail = data[max(end, len(data) - 4096):]


@contextlib.contextmanager
def profiler_trace(logdir, device=None):
    """Record a `torch.profiler` trace of the block and write it into
    `logdir` as `<host>_<pid>.<ms>.pt.trace.json` when the block ends
    (open it in Perfetto, ui.perfetto.dev, or chrome://tracing).

    `device` is the run's device, the card unless `device="cpu"`.  On
    the card the trace records CPU and CUDA activities, and it raises
    when the file holds no device event: it never passes a CPU-only
    trace off as a device trace."""
    from torch.profiler import ProfilerActivity, profile

    from cvo_rgbd_torch.device import resolve_device

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}."
        f"{time.time_ns() // 1_000_000}.pt.trace.json")
    with profile(activities=activities) as prof:
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)
    if dev.type == "cuda" and not device_events(path):
        raise RuntimeError(
            f"profiler_trace: the trace {path} holds no CUDA activity")
