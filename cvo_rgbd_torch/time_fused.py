"""Time the fused align and the moment sweep on the card, and read the
align kernel's per-phase split.

    python -m cvo_rgbd_torch.time_fused [--phases]
    PYTHONPATH=<checkout> python cvo_rgbd_torch/time_fused.py [--phases]

The second form times the `cvo_rgbd_torch` package of another checkout
(an earlier commit unpacked with `git archive`), so that two versions
are compared in one run on one card.  It uses only entry points that
every version since the fused backend's lane axis has.

The align cases are the pairs of `chip_smoke.py`'s phase 3c: cvo and
acvo resident at N=M=1024 (the 96x128 render) and tiled at N=M=3072
(the 240x320 render).  For each it prints one JSON line: the median
CUDA-event time of exactly 10 and of 60 iterations (eps = eps_2 = 0; a
device spin ahead of the first event hides the host's enqueue), the
slope between them, and from torch.profiler over REPEATS calls of 10
iterations the align kernel's device time, the other device time (the
precompute) and the kernel launches, each per call.  With `--phases`
(a version with the timed build of the kernel) it adds the kernel's
per-phase split in us an iteration: block 0's time from the top of an
iteration to the first grid barrier ("phase1"), to the second
("phase2"), the third ("phase3") and to the end of the scalar tail
("tail"), over REPEATS launches of 60 iterations.  A version whose
phase 2 runs inside phase 1 (no barrier between them) reports 0 for
it.  Then: `fused_moments` at the shapes of chip_smoke's phase 3 (the
first 3072 pair, ck cache and tile skip, ell = 0.03); the 63-lane
batched launch of chip_smoke's phase 8 at the 0.015 m grid (9 pcd pairs
x 7, N=M=2816, linear color, exactly 10 iterations); and fused
odometry over the 10-frame render (phase 5c: cvo and acvo at 3072),
frames/s on the host clock, two runs each.  The card's name and power
limit come first.  It needs a card.

    python -m cvo_rgbd_torch.time_fused --drift

runs the phase-8 pairs at 2816 (linear) and phase 3c's tiled 3072 render
pair (cvo, acvo) for exactly 1, 3 and 10 iterations on the card and
through the plain version in float32 on the card and in float64 on the
CPU, and prints for each pair how far the card and the float32 plain
version each are from the float64 run: which side a drift comes from.

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


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def render(n_frames, size):
    from cvo_rgbd_torch.synth import BandScene, render_frames, revisit_path

    scene = BandScene(*size)
    return scene, list(render_frames(revisit_path(n_frames, period=33),
                                     scene))


def pair(size, num_want, rgb):
    """The kd-sorted frontend clouds of the first rendered pair."""
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.frontend import make_frontend

    fe = make_frontend(1, num_want, rgb)
    return [kd_sort(fe(f[2], f[3])) for f in render(2, size)[1]]


def pcd_lanes(grid=0.015, repeat=1, device="cuda"):
    """chip_smoke's phase-8 lanes: the 9 pairs of the 10-frame render
    written as .pcd, loaded at `grid`, padded to one capacity, stacked
    `repeat` times and kd-sorted with the features padded to 5 planes."""
    import tempfile

    import torch

    from cvo_rgbd_torch.batch import load_pcd_dir, pad_clouds
    from cvo_rgbd_torch.core.cloud import kd_sort, stack_clouds
    from cvo_rgbd_torch.io.export import depth_to_cloud, write_pcd
    from cvo_rgbd_torch.ops.gram import pad_feat

    scene, frames = render(10, (240, 320))
    with tempfile.TemporaryDirectory() as root:
        for _, nm, rgb, dep, _ in frames:
            write_pcd(os.path.join(root, f"{nm}.pcd"),
                      *depth_to_cloud(rgb, dep, scene.cam))
        clouds = load_pcd_dir(root, grid=grid)
    padded = pad_clouds(clouds, torch.device(device))
    fixed = stack_clouds(padded[:-1], repeat=repeat)
    moving = stack_clouds(padded[1:], repeat=repeat)
    return tuple(kd_sort(c._replace(features=pad_feat(c.features)))
                 for c in (fixed, moving))


def phases(launch):
    """us an iteration of each phase of the timed build, over REPEATS
    calls of launch(timed=True)."""
    import importlib

    import torch

    af = importlib.import_module("cvo_rgbd_torch.ops.align_fused")
    items = hasattr(af, "item_ns")
    launch(timed=True)
    torch.cuda.synchronize()
    af.phase_ns(reset=True)
    if items:
        af.item_ns(reset=True)
    for _ in range(REPEATS):
        launch(timed=True)
    torch.cuda.synchronize()
    *ns, iters = af.phase_ns(reset=True)
    out = {k: v / iters / 1e3 for k, v in zip(
        ("phase1_us", "phase2_us", "phase3_us", "tail_us"), ns)}
    if items:
        # phase 1 by item kind: items an iteration and us an item; the
        # busiest block's and the mean block's us an iteration in items
        kinds, busy = af.item_ns(reset=True)
        out["items"] = {k: [c / iters, t / max(c, 1) / 1e3]
                        for k, (t, c) in kinds.items() if c}
        used = [b for b in busy if b]
        out["block_busy_us"] = [max(used) / iters / 1e3,
                                sum(used) / len(used) / iters / 1e3]
    return out


def time_aligns(with_phases):
    import cvo_rgbd_torch
    from cvo_rgbd_torch.ops.align_fused import align_fused_cuda
    from cvo_rgbd_torch.params import AcvoParams, CvoParams

    small = (96, 128)
    big = pair((240, 320), 3000, 1)
    cases = [("resident", CvoParams(), pair(small, 1024, 1)),
             ("resident", AcvoParams(), pair(small, 1024, 0)),
             ("tiled", CvoParams(), big),
             ("tiled", AcvoParams(), pair((240, 320), 3000, 0))]
    for mode, base, (x, y) in cases:
        t = {}
        for it in (10, 60):
            q = dataclasses.replace(base, backend="fused", max_iter=it,
                                    eps=0.0, eps_2=0.0)
            t[it] = time_ms(lambda: align_fused_cuda(q, x, y))
        split = phases(lambda **kw: align_fused_cuda(q, x, y, **kw)
                       ) if with_phases else {}
        q = dataclasses.replace(base, backend="fused", max_iter=10, eps=0.0,
                                eps_2=0.0)
        kern, other, launches = profiled(lambda: align_fused_cuda(q, x, y))
        print(json.dumps({
            "package": cvo_rgbd_torch.__file__, "mode": mode,
            "params": type(base).__name__, "n": x.capacity,
            "ms_10": t[10], "ms_60": t[60], "slope_ms": (t[60] - t[10]) / 50,
            "kernel_ms_10": kern, "other_device_ms_10": other,
            "launches_per_call": launches, **split,
        }), flush=True)
    return big


def time_moments(x, y):
    """fused_moments at chip_smoke's phase-3 shapes: ck, skip, ell 0.03."""
    import torch

    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import gram, moments
    from cvo_rgbd_torch.params import CvoParams

    p = CvoParams()
    dev = x.positions.device
    ck = gram.color_gram_cuda(x.features, x.mask, y.features, y.mask,
                              gram.scalars(torch.full((), p.ell_init,
                                                      device=dev), p))
    c0, xc, phi = build_moments_pre(x)
    md = aabb_min_d2(*block_bounds(x.positions, x.mask, moments.TILE_I),
                     *block_bounds(y.positions, y.mask, moments.TILE_J))
    scal = gram.scalars(torch.full((), 0.03, device=dev), p)
    args = (xc, x.features, x.mask, y.positions - c0, y.features, y.mask,
            phi, scal, ck, md)
    ms = time_ms(lambda: moments.fused_moments_cuda(*args))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPEATS):
            moments.fused_moments_cuda(*args)
        torch.cuda.synchronize()
    by_kernel = {e.key[:40]: e.device_time_total / REPEATS / 1e3
                 for e in prof.key_averages() if e.device_time_total > 0}
    print(json.dumps({"kernel": "fused_moments", "n": x.capacity,
                      "ell": 0.03, "ck": True, "skip": True, "ms": ms,
                      "device_ms_by_kernel": by_kernel}), flush=True)


def time_batched(with_phases):
    """chip_smoke's row 4b: 63 lanes at 2816, exactly 10 iterations."""
    from cvo_rgbd_torch.ops.align_fused import align_fused_batched_cuda
    from cvo_rgbd_torch.params import MATLAB_PARAMS

    xs, ys = pcd_lanes(repeat=7)
    q = dataclasses.replace(MATLAB_PARAMS, backend="fused", max_iter=10,
                            eps=0.0, eps_2=0.0)
    ms = time_ms(lambda: align_fused_batched_cuda(q, xs, ys))
    split = phases(lambda **kw: align_fused_batched_cuda(q, xs, ys, **kw)
                   ) if with_phases else {}
    print(json.dumps({"batched": "tiled linear", "lanes": xs.mask.shape[0],
                      "n": xs.mask.shape[1], "iterations": 10, "ms": ms,
                      **split}), flush=True)


def time_odometry():
    """Phase 5c: fused odometry over the 10-frame render at 3072."""
    import io
    import time

    import torch

    from cvo_rgbd_torch.odometry import run_odometry_frames
    from cvo_rgbd_torch.params import AcvoParams, CvoParams

    frames = render(10, (240, 320))[1]
    for adaptive, p in ((False, CvoParams(backend="fused")),
                        (True, AcvoParams(backend="fused"))):
        rates = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs = run_odometry_frames(
                ((i, nm, rgb, dep) for i, nm, rgb, dep, _ in frames), 1,
                adaptive=adaptive, params=p, traj=io.StringIO(),
                num_want=3000, log=lambda *a: None)
            torch.cuda.synchronize()
            rates.append(len(recs) / (time.perf_counter() - t0))
        print(json.dumps({"odometry": "acvo" if adaptive else "cvo",
                          "backend": "fused", "n": 3072,
                          "frames_per_s": rates,
                          "iterations": [r.iterations for r in recs]}),
              flush=True)


def drift():
    """Card and float32 plain version against float64, pair by pair,
    after 1, 3 and 10 iterations from the same start: phase 8's pcd lanes
    at 2816 (linear) and phase 3c's tiled 3072 render pair (cvo, acvo);
    then, per case and field, each side's mean error over the pairs."""
    import torch

    from cvo_rgbd_torch.core.cloud import stack_clouds
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_batched_cuda,
        align_fused_plain,
    )
    from cvo_rgbd_torch.params import MATLAB_PARAMS, AcvoParams, CvoParams

    def one(c):
        return stack_clouds([c])

    cases = [("pcd 2816 linear", MATLAB_PARAMS, *pcd_lanes())]
    for base, rgb in ((CvoParams(), 1), (AcvoParams(), 0)):
        x, y = pair((240, 320), 3000, rgb)
        cases.append((f"render 3072 {type(base).__name__}", base, one(x),
                      one(y)))
    cols = {"R": slice(12, 21), "T": slice(21, 24), "ell": slice(26, 27),
            "omega": slice(27, 30), "v": slice(30, 33)}
    for name, base, xs, ys in cases:
        for it in (1, 3, 10):
            q = dataclasses.replace(base, backend="fused", max_iter=it,
                                    eps=0.0, eps_2=0.0)
            card = align_fused_batched_cuda(q, xs, ys).cpu().double()
            mean = {"card": dict.fromkeys(cols, 0.0),
                    "plain32": dict.fromkeys(cols, 0.0)}
            lanes = xs.mask.shape[0]
            for k in range(lanes):
                x, y = xs.lane(k), ys.lane(k)
                plain = align_fused_plain(q, x, y).cpu().double()
                ref = align_fused_plain(q, x.to("cpu"), y.to("cpu"),
                                        dtype=torch.float64)
                out = {"case": name, "iterations": it, "lane": k}
                for side, got in (("card", card[k]), ("plain32", plain)):
                    e = (got - ref).abs()
                    out[side] = {f: e[c].max().item() for f, c in cols.items()}
                    for f in cols:
                        mean[side][f] += out[side][f] / lanes
                out["omega64"] = ref[27:30].tolist()
                print(json.dumps(out), flush=True)
            print(json.dumps({"case": name, "iterations": it,
                              "mean_over_lanes": mean}), flush=True)


def main(argv=None):
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--sass"]:
        from cvo_rgbd_torch.ops import _build

        lib = argv[1] if len(argv) > 1 else str(_build.BUILD
                                                / "libalign_fused.so")
        kernel = argv[2] if len(argv) > 2 else "align_kernelILb1ELb0E"
        for start, end, n, lds in sass_loops(lib, kernel):
            print(json.dumps({"loop": f"{start:#x}-{end:#x}",
                              "instructions": n, "shared_loads": lds}))
        return 0
    if not torch.cuda.is_available():
        print("time_fused: no CUDA device", file=sys.stderr)
        return 2
    from cvo_rgbd_torch.device import pin_fp32
    from cvo_rgbd_torch.ops import _build

    print(card_line(), flush=True)
    pin_fp32()
    _build.build()
    if argv[:1] == ["--drift"]:
        drift()
        return 0
    x, y = time_aligns("--phases" in argv)
    time_moments(x, y)
    time_batched("--phases" in argv)
    time_odometry()
    return 0


if __name__ == "__main__":
    sys.exit(main())
