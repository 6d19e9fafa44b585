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
slope between them, the SHA-1 of the 10-iteration result row, and
from torch.profiler over REPEATS calls of 10 iterations the align
kernel's device time, the other device time (the
precompute) and the kernel launches, each per call.  With `--phases`
(a version with the timed build of the kernel) it adds the kernel's
per-phase split in us an iteration: block 0's time from the top of an
iteration to the first grid barrier ("phase1"), to the second
("phase2"), the third ("phase3") and to the end of the scalar tail
("tail"), over REPEATS launches of 60 iterations.  A version whose
phase 2 runs inside phase 1 (no barrier between them) reports 0 for
it.  Then: `fused_moments` at the shapes of chip_smoke's phase 3 (the
first 3072 pair, ck cache and tile skip, ell = 0.03; with the SHA-1 of
its outputs); the 63-lane
batched launch of chip_smoke's phase 8 at the 0.015 m grid (9 pcd pairs
x 7, N=M=2816, linear color, exactly 10 iterations, with the SHA-1 of
its rows); and fused
odometry over the 10-frame render (phase 5c: cvo and acvo at 3072),
frames/s on the host clock, two runs each.  The card's name and power
limit come first.  It needs a card.

    python -m cvo_rgbd_torch.time_fused --drift

runs the phase-8 pairs at 2816 (linear) and phase 3c's tiled 3072 render
pair (cvo, acvo) for exactly 1, 3 and 10 iterations on the card and
through the plain version in float32 on the card and in float64 on the
CPU, and prints for each pair how far the card and the float32 plain
version each are from the float64 run: which side a drift comes from.

    python -m cvo_rgbd_torch.time_fused --resident [--phases]

runs instead the resident aligns of chip_smoke.py (cvo and acvo on phase
3c's 1024 render pairs, linear on the first pcd pair at 384 and the
first SLAM pair at 512, and phase 8's 63-lane batch at 384), precise and
fast: the SHA-1 of the result rows after exactly 1, 3, 10 and 60
iterations, the 10- and 60-iteration times and the slope, launches a
call and, with `--phases`, the timed build's split with phase 1's
items by kind; then fused odometry over the 10-frame render at
num_want=1024 (phase 5c, frames/s, three runs) and fused SLAM over
phase 9's 40 frames at 512 (s/frame, two runs), the main paths that
run resident.  In the PYTHONPATH form, parent and change print their
bits side by side.

    python -m cvo_rgbd_torch.time_fused --flow

times instead the two sweeps of the kernel backend's direct step,
`fused_flow_cuda` and `fused_step_coeffs_cuda` (median of 30 CUDA-event
runs, launches a call from torch.profiler), at chip_smoke's phase-3d
inputs: the first 3072 render pair in se mode with and without the
color cache at ell 0.1 and 0.03, and the first pcd pair at 2816 and 384
in linear mode at ell 0.03.  Each line gives the share of (128, 32)
tiles the AABB skip keeps; a version with the in-kernel skip runs each
case with it on and off, and with it on adds one launch of the timed
build (a library of its own, `-DFLOW_PHASE_TIMERS`) split by its
per-block marks: the skip test, a kept item's copies and sweep, the
ticket, the last block's sum.  The PYTHONPATH form runs it against an
earlier checkout's package as well.

    python -m cvo_rgbd_torch.time_fused --wsq --gram

prints the launch floor (a one-element PyTorch kernel on CUDA events,
alone and back to back), then with `--wsq` the ell trajectory of the
kernel backend's exact acvo align on the first acvo render pair at 3072
and `fused_wsq_cuda` on that pair's two self-pairs (symmetric, tile
skip on, ck on and off) at ell_init, at the ell of the trajectory
nearest the geometric mean of ell_init and ell_min, and at ell_min: the upper-triangle tiles kept, wsq and nnz as float hex, the
device ms, launches a call and device ms by kernel; then an
iteration's two sweeps (two calls, or one `fused_wsq_sweeps_cuda` call
where the package has it).  With `--gram`, `color_gram_cuda` on the
first cvo pair (3072 x 3072), an acvo self-pair and a ragged (1000,
130) slice: device ms, launches a call and the SHA-1 of the output.
The PYTHONPATH form runs it against an earlier checkout's package, so
that the two print their bits and times in one call.

    python -m cvo_rgbd_torch.time_fused --sass [LIBRARY]

prints instead, for the resident cvo kernel of a built library (by
default this package's `_build/libalign_fused.so`), each innermost loop
of its machine code (`cuobjdump -sass`) with its instruction count, its
shared-memory loads and its FRND and MUFU.EX2 instructions (the
exponentials of a pair weight): the Gram sweeps' cost a pair.

    python -m cvo_rgbd_torch.time_fused --resources [NAME ...]

builds the named libraries of `csrc/` (by default the four with an
exp_mode="fast" form) and prints one JSON line per kernel function:
its template arguments, registers, stack frame, SASS instructions,
MUFU.EX2 count and innermost loop sizes, so that a kernel's precise and
fast instantiations can be read side by side.  It needs no card, only
the CUDA toolkit.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
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


def _cuobjdump():
    from cvo_rgbd_torch.ops import _build

    # beside nvcc in the toolkit
    return shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")


def sass_functions(lib):
    """{mangled function name: [(address, instruction)]} of `lib`'s
    machine code."""
    text = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
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
    return funcs


def innermost_loops(ins):
    """[(start, end, instructions, shared loads, FRND, MUFU.EX2)] of each
    innermost loop (a backward branch enclosing no other) of one
    function's `ins`: exp_neg rounds with FRND (rintf), `__expf` is
    MUFU.EX2, so a loop with either evaluates pair weights."""
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
                    sum("LDS" in t for t in body),
                    sum("FRND" in t for t in body),
                    sum("MUFU.EX2" in t for t in body)))
    return sorted(out)


def sass_loops(lib, kernel="align_kernelILb1ELb0ELb0E"):
    """innermost_loops of the one function of `lib` whose mangled name
    holds `kernel`."""
    (ins,) = [v for k, v in sass_functions(lib).items() if kernel in k]
    return innermost_loops(ins)


def resources(libs):
    """One JSON line per kernel function of each library: its template
    arguments (demangled), registers and stack frame (`cuobjdump
    --dump-resource-usage`), SASS instructions, MUFU.EX2 (the SFU
    exponential `__expf` compiles to) and its innermost loops' sizes.  A
    kernel's precise and fast forms are its instantiations with FAST
    false and true."""
    for lib in libs:
        usage = subprocess.run([_cuobjdump(), "--dump-resource-usage", lib],
                               capture_output=True, text=True, check=True,
                               timeout=300).stdout
        regs = {name: (int(reg), int(stack)) for name, reg, stack in
                re.findall(r"Function ([^\s:]+):\s+REG:(\d+)\s+STACK:(\d+)",
                           usage)}
        funcs = sass_functions(lib)
        names = sorted(funcs)
        filt = shutil.which("cu++filt") or os.path.join(
            os.path.dirname(_cuobjdump()), "cu++filt")
        pretty = subprocess.run([filt], input="\n".join(names),
                                capture_output=True, text=True, check=True,
                                timeout=60).stdout.splitlines()
        for name, shown in zip(names, pretty):
            ins = funcs[name]
            reg, stack = regs.get(name, (None, None))
            print(json.dumps({
                "library": os.path.basename(lib),
                # the name and template arguments, not the parameters
                "function": shown[:shown.rindex(">(") + 1] if ">(" in shown
                else shown.split("(")[0], "registers": reg,
                "stack_bytes": stack, "instructions": len(ins),
                "mufu_ex2": sum("MUFU.EX2" in t for _, t in ins),
                "innermost_loops": [loop[2] for loop in
                                    innermost_loops(ins)]}), flush=True)


def sha1(t):
    """SHA-1 of a tensor's bytes: the bits two versions must share."""
    import hashlib

    return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()


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


def pcd_clouds(grids):
    """{grid: the 10-frame render written as .pcd and loaded at grid}, as
    the MATLAB batch runner loads them."""
    import tempfile

    from cvo_rgbd_torch.batch import load_pcd_dir
    from cvo_rgbd_torch.io.export import depth_to_cloud, write_pcd

    scene, frames = render(10, (240, 320))
    with tempfile.TemporaryDirectory() as root:
        for _, nm, rgb, dep, _ in frames:
            write_pcd(os.path.join(root, f"{nm}.pcd"),
                      *depth_to_cloud(rgb, dep, scene.cam))
        return {g: load_pcd_dir(root, grid=g) for g in grids}


def pcd_lanes(grid=0.015, repeat=1, device="cuda"):
    """chip_smoke's phase-8 lanes: the 9 pairs of the 10-frame render
    written as .pcd, loaded at `grid`, padded to one capacity, stacked
    `repeat` times and kd-sorted with the features padded to 5 planes."""
    import torch

    from cvo_rgbd_torch.batch import pad_clouds
    from cvo_rgbd_torch.core.cloud import kd_sort, stack_clouds
    from cvo_rgbd_torch.ops.gram import pad_feat

    padded = pad_clouds(pcd_clouds((grid,))[grid], torch.device(device))
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
            "sha1_10": sha1(align_fused_cuda(q, x, y)),
            "ms_10": t[10], "ms_60": t[60], "slope_ms": (t[60] - t[10]) / 50,
            "kernel_ms_10": kern, "other_device_ms_10": other,
            "launches_per_call": launches, **split,
        }), flush=True)
    return big


def slam_clouds(grid=0.05):
    """chip_smoke's phase-9 clouds at `grid`: 40 frames of
    `depth_loop_path` written as .pcd, loaded and padded to one capacity
    (512 at 0.05 m), on the card."""
    import tempfile

    import torch

    from cvo_rgbd_torch.batch import load_pcd_dir, pad_clouds
    from cvo_rgbd_torch.io.export import depth_to_cloud, write_pcd
    from cvo_rgbd_torch.synth import BandScene, depth_loop_path, render_frames

    scene = BandScene(240, 320)
    with tempfile.TemporaryDirectory() as root:
        for _, nm, rgb, dep, _ in render_frames(depth_loop_path(40, period=30),
                                                scene):
            write_pcd(os.path.join(root, f"{nm}.pcd"),
                      *depth_to_cloud(rgb, dep, scene.cam))
        return pad_clouds(load_pcd_dir(root, grid=grid), torch.device("cuda"))


def slam_pair(clouds):
    """The first pair of slam_clouds() kd-sorted, with 5 feature planes."""
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.ops.gram import pad_feat

    return tuple(kd_sort(c._replace(features=pad_feat(c.features)))
                 for c in clouds[:2])


def resident_cases(slam):
    """(label, params, fixed, moving) of the resident aligns of
    chip_smoke.py, every cloud stacked on a lane axis: cvo and acvo on
    phase 3c's 1024 render pairs (se), the first pcd pair at 384 (phases
    6 and 8, linear), the first SLAM pair at 512 (phase 9, linear), and
    phase 8's 63-lane batch at 384.  `slam`: slam_clouds()."""
    from cvo_rgbd_torch.core.cloud import stack_clouds
    from cvo_rgbd_torch.params import MATLAB_PARAMS, AcvoParams, CvoParams

    def one(pair_):
        return tuple(stack_clouds([c]) for c in pair_)

    small = (96, 128)
    xs, ys = pcd_lanes(grid=0.05, repeat=7)
    return [("cvo se 1024", CvoParams(), *one(pair(small, 1024, 1))),
            ("acvo se 1024", AcvoParams(), *one(pair(small, 1024, 0))),
            ("linear 384", MATLAB_PARAMS, *one((xs.lane(0), ys.lane(0)))),
            ("linear 512", MATLAB_PARAMS, *one(slam_pair(slam))),
            ("linear 384 x63", MATLAB_PARAMS, xs, ys)]


def time_resident(with_phases):
    """The resident aligns of resident_cases(), precise and fast: per
    case one JSON line with the SHA-1 of the [lanes, 33] result rows
    after exactly 1, 3, 10 and 60 iterations (eps = eps_2 = 0), the
    median CUDA-event time of 10 and 60 iterations and the slope, the
    kernel launches a call and, with `--phases`, the timed build's
    per-phase split with phase 1's items by kind.  Then the main paths
    that run resident: phase 5c's fused odometry at num_want=1024 and
    phase 9's fused SLAM at 512."""
    import cvo_rgbd_torch
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_batched_cuda,
        fused_mode,
    )

    slam = slam_clouds()
    for label, base, xs, ys in resident_cases(slam):
        for exp_mode in ("precise", "fast"):
            def run(it):
                return dataclasses.replace(base, backend="fused", max_iter=it,
                                           eps=0.0, eps_2=0.0,
                                           exp_mode=exp_mode)

            if fused_mode(run(1), xs, ys) != "resident":
                raise RuntimeError(f"{label}: not resident")
            sha = {it: sha1(align_fused_batched_cuda(run(it), xs, ys))
                   for it in (1, 3, 10, 60)}
            t = {it: time_ms(lambda q=run(it): align_fused_batched_cuda(
                q, xs, ys)) for it in (10, 60)}
            q = run(60)
            split = phases(lambda **kw: align_fused_batched_cuda(
                q, xs, ys, **kw)) if with_phases else {}
            print(json.dumps({
                "package": cvo_rgbd_torch.__file__, "resident": label,
                "exp_mode": exp_mode, "params": type(base).__name__,
                "lanes": xs.mask.shape[0], "n": xs.mask.shape[1],
                "m": ys.mask.shape[1], "sha1": sha, "ms_10": t[10],
                "ms_60": t[60], "slope_ms": (t[60] - t[10]) / 50,
                "launches_per_call": launches_per_call(
                    lambda: align_fused_batched_cuda(run(10), xs, ys)),
                **split}), flush=True)
    time_odometry(num_want=1024, runs=3)
    time_slam(slam)


def time_slam(clouds, runs=2):
    """Phase 9's fused SLAM (MATLAB_PARAMS, default SlamConfig) over
    slam_clouds(), s/frame on the host clock, `runs` runs."""
    import time

    import torch

    from cvo_rgbd_torch.params import MATLAB_PARAMS
    from cvo_rgbd_torch.slam import KeyframeSlam, SlamConfig

    p = dataclasses.replace(MATLAB_PARAMS, backend="fused")
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slam = KeyframeSlam(p, SlamConfig())
        for i, cloud in enumerate(clouds):
            slam.process(i, cloud)
        slam.solve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / len(clouds))
    print(json.dumps({"slam": "fused", "n": clouds[0].capacity,
                      "s_per_frame": times,
                      "keyframes": [k.index for k in slam.keyframes],
                      "loop_closures": len(slam.loop_edges)}), flush=True)


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
    mom, nnz = moments.fused_moments_cuda(*args)
    print(json.dumps({"kernel": "fused_moments", "n": x.capacity,
                      "ell": 0.03, "ck": True, "skip": True, "ms": ms,
                      "sha1": sha1(torch.cat([mom.reshape(-1),
                                              nnz.reshape(1)])),
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
                      "sha1": sha1(align_fused_batched_cuda(q, xs, ys)),
                      **split}), flush=True)


def time_odometry(num_want=3000, runs=2):
    """Phase 5c: fused odometry over the 10-frame render at `num_want`
    points (3072 tiled, 1024 resident), `runs` runs."""
    import io
    import time

    import torch

    from cvo_rgbd_torch.odometry import run_odometry_frames
    from cvo_rgbd_torch.params import AcvoParams, CvoParams

    frames = render(10, (240, 320))[1]
    for adaptive, p in ((False, CvoParams(backend="fused")),
                        (True, AcvoParams(backend="fused"))):
        rates = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs = run_odometry_frames(
                ((i, nm, rgb, dep) for i, nm, rgb, dep, _ in frames), 1,
                adaptive=adaptive, params=p, traj=io.StringIO(),
                num_want=num_want, log=lambda *a: None)
            torch.cuda.synchronize()
            rates.append(len(recs) / (time.perf_counter() - t0))
        print(json.dumps({"odometry": "acvo" if adaptive else "cvo",
                          "backend": "fused",
                          "n": -(-num_want // 128) * 128,
                          "frames_per_s": rates,
                          "iterations": [r.iterations for r in recs]}),
              flush=True)


def flow_cases():
    """chip_smoke's phase-3d inputs: (label, params, fixed, moving, ck,
    ell) for the first 3072 render pair (cvo, kd-sorted, with and without
    the color cache, ell 0.1 and 0.03) and the first pcd pair padded with
    its set at 2816 and 384 (MATLAB's linear mode, its masked CI, ell
    0.03)."""
    import torch

    from cvo_rgbd_torch.batch import pad_clouds
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.core.registration import prepare_ci
    from cvo_rgbd_torch.ops import gram
    from cvo_rgbd_torch.params import MATLAB_PARAMS, CvoParams

    p = CvoParams()
    x, y = pair((240, 320), 3000, 1)
    ck = gram.color_gram(*x, *y, p=p)
    cases = [(f"cvo ck={c is not None}", p, x, y, c, ell)
             for ell in (0.1, 0.03) for c in (ck, None)]
    for grid, clouds in pcd_clouds((0.015, 0.05)).items():
        lx, ly = (kd_sort(c) for c in pad_clouds(clouds,
                                                 torch.device("cuda"))[:2])
        ci = prepare_ci(MATLAB_PARAMS, lx, ly)
        lx, ly = (c._replace(features=gram.pad_feat(c.features))
                  for c in (lx, ly))
        cases.append((f"linear grid={grid}", MATLAB_PARAMS, lx, ly, ci,
                      0.03))
    return cases


def kept_fraction(x, y, scal, rows=128, cols=32):
    """Share of the (rows, cols) tiles the AABB skip keeps, by the rule of
    ops/moments.py (bound <= d2_thres + SKIP_MARGIN), from the tile boxes
    of the valid points: ops/flow.tile_keep, written here from what
    packages older than it have too."""
    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
    from cvo_rgbd_torch.ops.gram import S_D2_THRES
    from cvo_rgbd_torch.ops.moments import SKIP_MARGIN

    md = aabb_min_d2(*block_bounds(x.positions, x.mask, rows),
                     *block_bounds(y.positions, y.mask, cols))
    return (md <= scal[S_D2_THRES] + SKIP_MARGIN).float().mean().item()


def launches_per_call(fn):
    """Kernel launches a call of fn, over REPEATS calls under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPEATS):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("cudaLaunch")) / REPEATS


def flow_split(marks):
    """The timed build's per-block marks (`flow.flow_marks`) in us from
    the first block's start: the median skip test, the median and
    largest copy and sweep of a kept item, the median ticket, the last
    block's sum, when the last kept item was swept and the last block
    started, and the whole span."""
    import torch

    t = marks[:, :5].double()
    kept = marks[:, 5] > 0
    rel = (t - t[:, 0].min()) / 1e3
    sweep = (rel[:, 2] - rel[:, 1])[kept]
    tail = rel[:, 4] - rel[:, 3]
    ticket = rel[:, 3] - torch.where(kept, rel[:, 2], rel[:, 1])
    return {
        "test_us": (rel[:, 1] - rel[:, 0]).median().item(),
        "sweep_us": [sweep.median().item(), sweep.max().item()],
        "ticket_us": ticket.median().item(),
        "last_sum_us": tail.max().item(),
        "last_kept_swept_at_us": rel[kept, 2].max().item(),
        "last_start_us": rel[:, 0].max().item(),
        "span_us": rel[:, 4].max().item(),
    }


def time_flow():
    """fused_flow_cuda and fused_step_coeffs_cuda on flow_cases(): one
    JSON line a sweep, case and skip setting.  A version whose wrappers
    take no `skip` argument (before the in-kernel skip) runs once a case,
    as "skip": null.  A version with the timed build adds, with the skip
    on, the split of one launch by its per-block marks (flow_split)."""
    import inspect

    import cvo_rgbd_torch
    import torch

    from cvo_rgbd_torch.ops import flow, gram

    params = inspect.signature(flow.fused_flow_cuda).parameters
    has_skip, has_timed = "skip" in params, "timed" in params
    for label, p, x, y, ck, ell in flow_cases():
        linear = p.color_mode == "linear"
        scal = gram.scalars(torch.full((), ell, device="cuda"), p)
        args = (*x, *y, scal)
        kept = kept_fraction(x, y, scal)
        for skip in ((True, False) if has_skip else (None,)):
            kw = {} if skip is None else {"skip": skip}
            out = flow.fused_flow_cuda(*args, ck, linear, **kw)
            wv = torch.cat([out[0:3] / p.c, out[3:6] / p.d])
            for sweep, fn in (
                ("fused_flow",
                 lambda **t: flow.fused_flow_cuda(*args, ck, linear, **kw,
                                                  **t)),
                ("fused_step_coeffs",
                 lambda **t: flow.fused_step_coeffs_cuda(
                     *args, wv, ck, linear, **kw, **t))):
                split = {}
                if skip and has_timed:
                    for _ in range(2):
                        fn(timed=True)
                    torch.cuda.synchronize()
                    split = flow_split(flow.flow_marks(
                        (x.capacity // 128) * (y.capacity // 32)))
                print(json.dumps({
                    "package": cvo_rgbd_torch.__file__, "sweep": sweep,
                    "case": label, "n": x.capacity, "m": y.capacity,
                    "ell": ell, "skip": skip, "kept_tiles": kept,
                    "nnz": out[8].item(), "ms": time_ms(fn),
                    "launches_per_call": launches_per_call(fn), **split,
                }), flush=True)


def launch_floor():
    """The launch floor on CUDA events: one one-element PyTorch kernel
    between its own events, and the time a launch of 100 back to back."""
    import torch

    t = torch.zeros(1, device="cuda")
    one = time_ms(lambda: t.add_(1.0))

    def burst():
        for _ in range(100):
            t.add_(1.0)

    print(json.dumps({"launch_floor": "one-element add_",
                      "one_launch_ms": one,
                      "back_to_back_ms": time_ms(burst) / 100}), flush=True)


def device_ms_by_kernel(fn):
    """{kernel name: device ms a call of fn}, over REPEATS calls under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPEATS):
            fn()
        torch.cuda.synchronize()
    return {e.key[:40]: e.device_time_total / REPEATS / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def ell_trajectory(p, x, y):
    """The ell of each iteration of the kernel backend's acvo align on
    kd-sorted (x, y), to convergence, as a CPU tensor."""
    import torch

    from cvo_rgbd_torch.core import registration as reg

    state = reg.init_state(p, x.positions.device)
    pre = reg.prepare(p, x, y)
    body = reg.make_align_step(p)
    ells = []
    for it in range(p.max_iter):
        state = body(state, x, y, pre)
        ells.append(state.ell)
        if (it + 1) % 8 == 0 and bool(state.converged.item()):
            break
    return torch.stack(ells).cpu()


def _hex(t):
    return float(t).hex()


def time_wsq():
    """fused_wsq_cuda on the first acvo render pair's two self-pairs at
    3072 (kd-sorted, symmetric, tile skip on), ck on and off, at
    ell_init, at an ell the kernel backend's exact acvo align on this
    pair passes through (the one nearest the geometric mean of ell_init
    and ell_min), and at ell_min: one JSON line a case with the
    upper-triangle tiles kept, the outputs' bits, the device ms, the
    launches a call and the device ms by kernel.  Then, per ell and ck
    setting, the iteration's two sweeps: two calls, or one call of
    `fused_wsq_sweeps_cuda` where the package has it.  A package with
    `wsq.tile_order` gets the once-per-align tile order in place of the
    bound matrix, as its align passes it."""
    import cvo_rgbd_torch
    import torch

    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
    from cvo_rgbd_torch.ops import gram, wsq
    from cvo_rgbd_torch.params import AcvoParams

    p = AcvoParams()
    x, y = pair((240, 320), 3000, 0)
    traj = ell_trajectory(p, x, y)
    # the ell the iterations pass through nearest the geometric mean of
    # ell_init and ell_min (the median is the floor, where most sit)
    mid = traj[(traj.log() - 0.5 * math.log(p.ell_init * p.ell_min)
                ).abs().argmin()].item()
    print(json.dumps({"package": cvo_rgbd_torch.__file__,
                      "ell_trajectory": {"iterations": len(traj),
                                         "max": traj.max().item(),
                                         "mid": mid,
                                         "final": traj[-1].item(),
                                         "bits": [_hex(v) for v in traj]}}),
          flush=True)
    dev = x.positions.device
    has_order = hasattr(wsq, "tile_order")
    has_sweeps = hasattr(wsq, "fused_wsq_sweeps_cuda")
    tw = wsq.TILE_W
    scal0 = gram.scalars(torch.full((), p.ell_init, device=dev), p)
    clouds = {}
    for label, c in (("fixed", x), ("moving", y)):
        lo, hi = block_bounds(c.positions, c.mask, tw)
        md = aabb_min_d2(lo, hi, lo, hi)
        ck = gram.color_gram_cuda(c.features, c.mask, c.features, c.mask,
                                  scal0)
        tiles = wsq.tile_order(md, True) if has_order else md
        clouds[label] = (c, ck, md, tiles)
    for ell in (p.ell_init, mid, p.ell_min):
        scal = gram.scalars(torch.full((), ell, device=dev), p)
        thr = (scal[gram.S_D2_THRES] + wsq.SKIP_MARGIN).item()
        for use_ck in (True, False):
            calls = []
            for label, (c, ck, md, tiles) in clouds.items():
                ck_in = ck if use_ck else None

                def fn(c=c, ck_in=ck_in, tiles=tiles):
                    return wsq.fused_wsq_cuda(*c, *c, scal, ck_in, tiles,
                                              symmetric=True)

                calls.append(fn)
                w, nz = fn()
                upper = torch.triu(torch.ones_like(md, dtype=torch.bool))
                print(json.dumps({
                    "package": cvo_rgbd_torch.__file__, "kernel": "fused_wsq",
                    "cloud": label, "n": c.capacity, "ell": ell,
                    "ck": use_ck, "skip": True, "symmetric": True,
                    "tiles_kept": int(((md <= thr) & upper).sum().item()),
                    "tiles": int(upper.sum().item()),
                    "wsq": _hex(w), "nnz": _hex(nz), "ms": time_ms(fn),
                    "launches_per_call": launches_per_call(fn),
                    "device_ms_by_kernel": device_ms_by_kernel(fn),
                }), flush=True)
            if has_sweeps:
                sweeps = [wsq.Sweep(c, c, ck if use_ck else None, tiles, True)
                          for c, ck, _, tiles in clouds.values()]

                def both():
                    return wsq.fused_wsq_sweeps_cuda(sweeps, scal)

                w, nz = both()
                bits = [[_hex(w[k]), _hex(nz[k])] for k in range(2)]
            else:
                def both():
                    return [f() for f in calls]

                bits = [[_hex(w), _hex(nz)] for w, nz in both()]
            print(json.dumps({
                "package": cvo_rgbd_torch.__file__,
                "kernel": "fused_wsq iteration (fixed, moving)", "ell": ell,
                "ck": use_ck, "sweeps_call": has_sweeps, "bits": bits,
                "ms": time_ms(both),
                "launches_per_call": launches_per_call(both),
            }), flush=True)


def time_gram():
    """color_gram_cuda on the first cvo render pair (3072 x 3072), the
    first acvo cloud's self-pair and a ragged (1000, 130) slice of the
    cvo pair: device ms, launches a call, the time of one `fill_` of
    the output (the store rate the card reaches on it) and the SHA-1 of
    the output's bytes."""
    import cvo_rgbd_torch
    import torch

    from cvo_rgbd_torch.ops import gram
    from cvo_rgbd_torch.params import AcvoParams, CvoParams

    x, y = pair((240, 320), 3000, 1)
    a, _ = pair((240, 320), 3000, 0)
    cases = [("cvo pair", CvoParams(), x, y), ("acvo self-pair",
                                                AcvoParams(), a, a),
             ("ragged slice", CvoParams(),
              *(c._replace(positions=c.positions[:k].contiguous(),
                           features=c.features[:k].contiguous(),
                           mask=c.mask[:k].contiguous())
                for c, k in ((x, 1000), (y, 130))))]
    for label, p, u, v in cases:
        scal = gram.scalars(torch.full((), p.ell_init, device="cuda"), p)
        args = (u.features, u.mask, v.features, v.mask, scal)

        def fn():
            return gram.color_gram_cuda(*args)

        out = fn()
        torch.cuda.synchronize()
        print(json.dumps({
            "package": cvo_rgbd_torch.__file__, "kernel": "color_gram",
            "case": label, "n": u.features.shape[0],
            "m": v.features.shape[0], "ms": time_ms(fn),
            "launches_per_call": launches_per_call(fn),
            # the store rate the card reaches on this output: one fill_
            "fill_ms": time_ms(lambda: out.fill_(1.0)),
            "sha1": sha1(fn()),
        }), flush=True)


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
    if argv[:1] == ["--resources"]:
        from cvo_rgbd_torch.ops import _build

        names = argv[1:] or ["fused_moments", "fused_wsq", "fused_flow",
                             "align_fused"]
        _build.build(names)
        resources([str(_build.BUILD / f"lib{n}.so") for n in names])
        return 0
    if argv[:1] == ["--sass"]:
        from cvo_rgbd_torch.ops import _build

        lib = argv[1] if len(argv) > 1 else str(_build.BUILD
                                                / "libalign_fused.so")
        kernel = argv[2] if len(argv) > 2 else "align_kernelILb1ELb0ELb0E"
        for start, end, n, lds, frnd, ex2 in sass_loops(lib, kernel):
            print(json.dumps({"loop": f"{start:#x}-{end:#x}",
                              "instructions": n, "shared_loads": lds,
                              "frnd": frnd, "mufu_ex2": ex2}))
        return 0
    if not torch.cuda.is_available():
        print("time_fused: no CUDA device", file=sys.stderr)
        return 2
    from cvo_rgbd_torch.device import pin_fp32
    from cvo_rgbd_torch.ops import _build

    print(card_line(), flush=True)
    pin_fp32()
    if "--wsq" in argv or "--gram" in argv:
        _build.build(("color_gram", "fused_wsq"))
        launch_floor()
        if "--wsq" in argv:
            time_wsq()
        if "--gram" in argv:
            time_gram()
        return 0
    if argv[:1] == ["--flow"]:
        _build.build(("color_gram", "fused_flow"))
        if "fused_flow_timed" in getattr(_build, "VARIANTS", {}):
            _build.build(("fused_flow_timed",))
        time_flow()
        return 0
    _build.build()
    if argv[:1] == ["--drift"]:
        drift()
        return 0
    if argv[:1] == ["--resident"]:
        time_resident("--phases" in argv)
        return 0
    x, y = time_aligns("--phases" in argv)
    time_moments(x, y)
    time_batched("--phases" in argv)
    time_odometry()
    return 0


if __name__ == "__main__":
    sys.exit(main())
