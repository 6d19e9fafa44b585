"""Time the one-pair fused align on the card: the kernel apart from the
wrapper's precompute.

    python -m cvo_rgbd_torch.time_fused
    PYTHONPATH=<checkout> python cvo_rgbd_torch/time_fused.py

The second form times the `cvo_rgbd_torch` package of another checkout
(an earlier commit unpacked with `git archive`), so that two versions
are compared in one run on one card.  It uses only entry points that
every version of the fused backend has.

The cases are the pairs of `chip_smoke.py`'s phase 3c: cvo and acvo
resident at N=M=1024 (the 96x128 render) and tiled at N=M=3072 (the
240x320 render).  For each it prints one JSON line: the median CUDA-event
time of exactly 10 and of 60 iterations (eps = eps_2 = 0; a device spin
ahead of the first event hides the host's enqueue), the slope between
them, and from torch.profiler over REPEATS calls of 10 iterations the
align kernel's device time, the other device time (the precompute) and
the kernel launches, each per call.  The card's name and power limit
come first.  It needs a card.

    python -m cvo_rgbd_torch.time_fused --sass [LIBRARY]

prints instead, for the resident cvo kernel of a built library (by
default this package's `_build/libalign_fused.so`), each innermost loop
of its machine code (`cuobjdump -sass`) with its instruction count and
its shared-memory loads: the Gram sweeps' cost a pair.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

RUNS, WARMUP, REPEATS = 30, 5, 10
# ~10 ms of device cycles ahead of the first event: longer than the
# wrapper's host work
SPIN_CYCLES = 20_000_000


def time_ms(fn):
    """Median over RUNS calls of fn between CUDA events, after WARMUP."""
    import torch

    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(RUNS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def profiled(fn):
    """(align kernel ms, other device ms, launches), each per call of fn,
    over REPEATS calls under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPEATS):
            fn()
        torch.cuda.synchronize()
    gpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not gpu:
        raise RuntimeError("the profiler recorded no device activity")
    kern = sum(e.time_range.elapsed_us() for e in gpu
               if "align_kernel" in e.name) / 1e3
    other = sum(e.time_range.elapsed_us() for e in gpu
                if "align_kernel" not in e.name) / 1e3
    launches = sum(e.count for e in prof.key_averages()
                   if e.key.startswith("cudaLaunch"))
    return kern / REPEATS, other / REPEATS, launches / REPEATS


def sass_loops(lib, kernel="align_kernelILb1ELb0E"):
    """[(start, end, instructions, shared loads)] of each innermost loop
    (a backward branch enclosing no other) of `kernel` in `lib`."""
    from cvo_rgbd_torch.ops import _build

    # beside nvcc in the toolkit
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, cur = collections.defaultdict(list), None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and cur is not None:
            funcs[cur].append((int(m.group(1), 16), m.group(2)))
    (ins,) = [v for k, v in funcs.items() if kernel in k]
    index = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (a, txt) in enumerate(ins):
        m = re.search(r"BRA\b.*?0x([0-9a-f]+)", txt)
        if m and int(m.group(1), 16) <= a and int(m.group(1), 16) in index:
            loops.append((index[int(m.group(1), 16)], i))
    out = []
    for s, e in loops:
        if any(s <= s2 and e2 <= e and (s2, e2) != (s, e) for s2, e2 in loops):
            continue
        body = [txt for _, txt in ins[s:e + 1]]
        out.append((ins[s][0], ins[e][0], len(body),
                    sum("LDS" in t for t in body)))
    return sorted(out)


def main(argv=None):
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--sass"]:
        from cvo_rgbd_torch.ops import _build

        lib = argv[1] if len(argv) > 1 else str(_build.BUILD
                                                / "libalign_fused.so")
        for start, end, n, lds in sass_loops(lib):
            print(json.dumps({"loop": f"{start:#x}-{end:#x}",
                              "instructions": n, "shared_loads": lds}))
        return 0
    if not torch.cuda.is_available():
        print("time_fused: no CUDA device", file=sys.stderr)
        return 2
    import cvo_rgbd_torch
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.device import pin_fp32
    from cvo_rgbd_torch.frontend import make_frontend
    from cvo_rgbd_torch.ops import _build
    from cvo_rgbd_torch.ops.align_fused import align_fused_cuda
    from cvo_rgbd_torch.params import AcvoParams, CvoParams
    from cvo_rgbd_torch.synth import BandScene, render_frames, revisit_path

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    pin_fp32()
    _build.build()

    def pair(size, num_want, rgb):
        fe = make_frontend(1, num_want, rgb)
        frames = list(render_frames(revisit_path(2, period=33),
                                    BandScene(*size)))
        return [kd_sort(fe(f[2], f[3])) for f in frames]

    cases = [("resident", CvoParams(), pair((96, 128), 1024, 1)),
             ("resident", AcvoParams(), pair((96, 128), 1024, 0)),
             ("tiled", CvoParams(), pair((240, 320), 3000, 1))]
    for mode, base, (x, y) in cases:
        t = {}
        for it in (10, 60):
            q = dataclasses.replace(base, backend="fused", max_iter=it,
                                    eps=0.0, eps_2=0.0)
            t[it] = time_ms(lambda: align_fused_cuda(q, x, y))
        q = dataclasses.replace(base, backend="fused", max_iter=10, eps=0.0,
                                eps_2=0.0)
        kern, other, launches = profiled(lambda: align_fused_cuda(q, x, y))
        print(json.dumps({
            "package": cvo_rgbd_torch.__file__, "mode": mode,
            "params": type(base).__name__, "n": x.capacity,
            "ms_10": t[10], "ms_60": t[60], "slope_ms": (t[60] - t[10]) / 50,
            "kernel_ms_10": kern, "other_device_ms_10": other,
            "launches_per_call": launches,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
