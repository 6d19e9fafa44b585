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

    python -m cvo_rgbd_torch.time_fused --profiler

counts the one-kernel torch.profiler windows that lose their kernel (its
launch recorded, no device event in the results), alone and each after a
throwaway window, in turns (`profiler_misses`).

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

    python -m cvo_rgbd_torch.time_fused --lanes

times instead the two sweeps on a lane axis at the shapes of
chip_smoke's phases 8d and 8f, and their one-pair launches.  Rows 2b
and 2/2f (`fused_moments_cuda`): the render's 9 pairs at 3072 with the
color cache and the tile skip, each lane at its own ell from ell_init
(0.15) to 0.03, precise and fast; the same at ell 0.1 and at 0.3 on
every lane (more tiles kept); the coarse pcd pairs x7 (63 lanes at 384)
in linear mode; the first render pair alone at ell 0.03, precise and
fast.  Rows 3b and 3/3f (`fused_wsq_sweeps_cuda`): exact acvo's two
self-sweeps of the acvo render's 9 pairs at 3072, each lane at its own
ell from ell_init to ell_min, precise and fast; the same at ell 0.1 and
0.3 on every lane; the 63 pcd lanes at 384; the Chebyshev tables of the
9 lanes (24 sweeps a lane); then the first pair's sweeps alone (each
with and without the color cache, and both in one launch), precise and
fast.  One JSON line a case: the share of tiles kept, the median of 30
CUDA-event runs, the launches a call, the device ms by kernel, the
SHA-1 of each lane's outputs and, for the wsq batches, the launch with
no lane live (its fixed cost).  The PYTHONPATH form runs it against an
earlier checkout's package.

    python -m cvo_rgbd_torch.time_fused --probes

prints the launch floor, then for each toy case of
`csrc/construct_probe.cu` (row 8) on the scripts' inputs one JSON line:
the median of 30 CUDA-event runs, the device ms by kernel and launches
a call (torch.profiler), and the SHA-1 of its output on the scripts'
inputs, on the seeded inputs of seeds 0 and 1 and, for d and e, with
the guard off; then the one-call library counterparts of e (one of its
three products, `torch.matmul(a[:, 0:8].T, b)`) and h
(`torch.sum(x[256:512])`).  The PYTHONPATH form runs it against an
earlier checkout's package (one without `probes.seeded_inputs` takes
this file's sibling `probes.py`'s), so that parent and change print
their bits and times in turns in one call.

    python -m cvo_rgbd_torch.time_fused --sass [LIBRARY [KERNEL]]

prints instead, for the resident cvo kernel of a built library (by
default this package's `_build/libalign_fused.so`), or the one kernel
whose mangled name holds KERNEL, each innermost loop of its machine code
(`cuobjdump -sass`) with its instruction count, its shared-memory loads
and its FRND and MUFU.EX2 instructions (the exponentials of a pair
weight), and its mix: shared loads by width (32, 64, 128 bits), FFMA,
global loads and the rest: the Gram sweeps' cost a pair.

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
import time

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
    holds `kernel`, each with its loop_mix."""
    (ins,) = [v for k, v in sass_functions(lib).items() if kernel in k]
    index = {a: i for i, (a, _) in enumerate(ins)}
    return [(loop, loop_mix(t for _, t in
                            ins[index[loop[0]]:index[loop[1]] + 1]))
            for loop in innermost_loops(ins)]


def loop_mix(body):
    """{class: count} of a loop's instructions: shared loads by width
    (`LDS` 32 bits, `LDS.64`, `LDS.128`), FFMA, global loads (LDG) and
    the rest."""
    mix = collections.Counter()
    for t in body:
        op = t.split()[0] if not t.startswith("@") else t.split()[1]
        if op.startswith("LDS"):
            width = re.search(r"\.(64|128)\b", op)
            mix[f"LDS.{width.group(1) if width else 32}"] += 1
        elif op.startswith("FFMA"):
            mix["FFMA"] += 1
        elif op.startswith("LDG"):
            mix["LDG"] += 1
        else:
            mix["other"] += 1
    return dict(mix)


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


# host sleep at each end of a 'padded' profiler window
PAD_S = 0.002


def _one_kernel_window(fn, variant):
    """One torch.profiler window around a one-launch call, as
    tests/test_torch_cuda.py::test_flow_sweeps_are_one_launch_a_call
    opens it ('plain'); 'warm': a throwaway window with a device sync
    opens and closes just before; 'padded': the window holds PAD_S of
    host sleep before the launch and after the sync.  Returns (device
    kernels in the window's results, its launch count, the kernel's
    start from the trace's start and the sync's end from the kernel's
    end in us, the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    pad = variant == "padded"
    if variant == "warm":
        with profile(activities=acts):
            torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        if pad:
            time.sleep(PAD_S)
        fn()
        torch.cuda.synchronize()
        if pad:
            time.sleep(PAD_S)
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    syncs = [e for e in events if "Synchronize" in e.name]
    launches = sum(e.count for e in prof.key_averages()
                   if e.key.startswith("cudaLaunch"))
    margins = None
    if kernels and syncs:
        margins = (kernels[0].time_range.start,
                   syncs[-1].time_range.end - kernels[0].time_range.end)
    return len(kernels), launches, margins, prof


def profiler_misses(blocks=40, per_case=10,
                    variants=("plain", "warm", "padded")):
    """How often a one-kernel profiler window loses its kernel.  Over
    `blocks` blocks, each variant of `_one_kernel_window` in turns (the
    order rotating), on three of `flow_cases()` (se 3072 with and without
    the color cache, linear 384), `per_case` windows of one
    `fused_flow_cuda` launch each, the first of them exported to a Chrome
    trace (an export came just before the windows that lost their kernel
    in the first runs).  Prints one JSON line a variant: windows, windows
    whose launch was recorded but whose results hold no device kernel,
    their positions after the export, and over the windows that kept it
    the least and the median kernel start from the trace's start and
    sync end from the kernel's end, in us."""
    import tempfile

    import numpy as np
    import torch

    from cvo_rgbd_torch.ops import flow, gram

    want = (("cvo ck=True", 0.1), ("cvo ck=False", 0.1),
            ("linear grid=0.05", 0.03))
    cases = [c for c in flow_cases() if (c[0], c[5]) in want]
    calls = []
    for _, p, x, y, ck, ell in cases:
        scal = gram.scalars(torch.full((), ell, device="cuda"), p)
        linear = p.color_mode == "linear"
        calls.append(lambda x=x, y=y, scal=scal, ck=ck, linear=linear:
                     flow.fused_flow_cuda(*x, *y, scal, ck, linear))
    stats = {v: {"windows": 0, "missed": 0, "after_export": []}
             for v in variants}
    margins = {v: [] for v in variants}
    with tempfile.TemporaryDirectory() as tmp:
        for b in range(blocks):
            k0 = b % len(variants)
            for variant in variants[k0:] + variants[:k0]:
                for fn in calls:
                    fn()
                    torch.cuda.synchronize()
                    for i in range(per_case):
                        k, n, m, prof = _one_kernel_window(fn, variant)
                        if i == 0:
                            prof.export_chrome_trace(f"{tmp}/t.json")
                        st = stats[variant]
                        st["windows"] += 1
                        if n == 1 and k == 0:
                            st["missed"] += 1
                            st["after_export"].append(i)
                        if m is not None:
                            margins[variant].append(m)
    for variant, st in stats.items():
        ms = np.array(margins[variant]).reshape(-1, 2)
        spread = {name: [float(col.min()), float(np.median(col))]
                  for name, col in (("kernel_start_us", ms[:, 0]),
                                    ("sync_after_kernel_us", ms[:, 1]))
                  if col.size}
        print(json.dumps({"profiler_windows": variant, **st, **spread}),
              flush=True)


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


def lane_batches():
    """The batches of chip_smoke's 8d and 8f: the render's 10 frames
    through the cvo (RGB) and the acvo (HSV) frontends at 3000 points,
    their 9 consecutive pairs, and the coarse pcd pairs (grid 0.05) x7,
    as lists of fixed and moving clouds."""
    import torch

    from cvo_rgbd_torch.batch import pad_clouds
    from cvo_rgbd_torch.frontend import make_frontend

    _, frames = render(10, (240, 320))
    fe, fe_a = make_frontend(1, 3000, 1), make_frontend(1, 3000, 0)
    cvo = [fe(f[2], f[3]) for f in frames]
    acvo = [fe_a(f[2], f[3]) for f in frames]
    pcd = pad_clouds(pcd_clouds((0.05,))[0.05], torch.device("cuda"))
    return {"cvo": (cvo[:-1], cvo[1:]), "acvo": (acvo[:-1], acvo[1:]),
            "pcd": (pcd[:-1] * 7, pcd[1:] * 7)}


def lane_sha1s(*outs):
    """The SHA-1 of each lane's outputs (the lane axis leading)."""
    import torch

    return [sha1(torch.cat([o[i].reshape(-1) for o in outs]))
            for i in range(outs[0].shape[0])]


def time_lane_case(kernel, case, fn, lanes=True, none=None, kept=None):
    """One JSON line for a launch `fn` of a lane-axis row (or, with
    `lanes` False, a one-pair row): its median time, launches a call,
    device ms by kernel and each lane's SHA-1; `none`, a launch with no
    lane live, timed beside it; `kept` the share of tiles kept."""
    import cvo_rgbd_torch

    outs = fn()
    line = {"package": cvo_rgbd_torch.__file__, "kernel": kernel,
            "case": case, "tiles_kept": kept, "ms": time_ms(fn),
            "launches_per_call": launches_per_call(fn),
            "device_ms_by_kernel": device_ms_by_kernel(fn)}
    if none is not None:
        line["no_lane_live_ms"] = time_ms(none)
    if lanes:
        line["lane_sha1"] = lane_sha1s(*outs)
    else:
        line["sha1"] = lane_sha1s(*(o.reshape(1, -1) for o in outs))[0]
    print(json.dumps(line), flush=True)


# the moving clouds of 8d and 8f, moved a little as an iteration sees
# them
LANE_SHIFT = (0.004, -0.002, 0.003)


def _fast(q):
    return dataclasses.replace(q, exp_mode="fast")


def time_lanes():
    """Rows 2b and 3b at 8d's and 8f's shapes, then their one-pair
    launches (rows 2, 2f, 3, 3f) on the first render pair; see the
    module docstring."""
    batches = lane_batches()
    time_lane_moments(batches)
    time_lane_wsq(batches)


def time_lane_moments(batches):
    """Rows 2b and 2/2f of `time_lanes`."""
    import torch

    from cvo_rgbd_torch.core.cloud import (
        aabb_min_d2,
        block_bounds,
        stack_clouds,
    )
    from cvo_rgbd_torch.core.registration import prepare_batch, route
    from cvo_rgbd_torch.ops import gram, moments
    from cvo_rgbd_torch.params import MATLAB_PARAMS, CvoParams

    p = CvoParams()
    dev = batches["cvo"][0][0].positions.device
    shift = torch.tensor(LANE_SHIFT, device=dev)
    fast = _fast
    # (case, params, batch, ell of the first and last lane)
    for name, q, key, ells in (
            ("render 9x3072 ck skip ell 0.15-0.03", p, "cvo",
             (p.ell_init, 0.03)),
            ("render 9x3072 ck skip ell 0.15-0.03 fast", fast(p), "cvo",
             (p.ell_init, 0.03)),
            ("render 9x3072 ck skip ell 0.1", p, "cvo", (0.1, 0.1)),
            ("render 9x3072 ck skip ell 0.3", p, "cvo", (0.3, 0.3)),
            ("pcd 63x384 linear ell 0.15-0.03", MATLAB_PARAMS, "pcd",
             (MATLAB_PARAMS.ell_init, 0.03))):
        xs, ys = batches[key]
        q, x, y = route(q, stack_clouds(xs), stack_clouds(ys))
        b = x.positions.shape[0]
        pre = prepare_batch(q, x, y, [None] * b)
        c0, x_c, phi = pre.moments
        y_pos = y.positions + shift
        md = aabb_min_d2(*pre.skip[:2],
                         *block_bounds(y_pos, y.mask, moments.TILE_J))
        scal = gram.scalars(torch.linspace(*ells, b, device=dev), q)
        args = (x_c, x.features, x.mask, y_pos - c0[:, None, :],
                y.features, y.mask, phi, scal, pre.ck[0], md)
        linear, fst = q.color_mode == "linear", q.exp_mode == "fast"
        keep = md <= scal[:, gram.S_D2_THRES, None, None] + \
            moments.SKIP_MARGIN
        time_lane_case("fused_moments lanes", name, lambda: (
            moments.fused_moments_cuda(*args, linear, fst)),
            kept=keep.float().mean().item())
        if key == "cvo" and ells[0] != ells[1]:
            # the one-pair launch at phase 3's shape: lane 0 (the first
            # render pair) at ell 0.03
            one = [a[0] for a in args]
            one[7] = gram.scalars(torch.full((), 0.03, device=dev), q)
            time_lane_case(
                "fused_moments", "render pair 3072 ck skip ell 0.03"
                + " fast" * fst, lambda: moments.fused_moments_cuda(
                    *one, linear, fst), lanes=False)


def time_lane_wsq(batches):
    """Rows 3b and 3/3f of `time_lanes`, then the Chebyshev tables."""
    import torch

    from cvo_rgbd_torch.core.cloud import stack_clouds
    from cvo_rgbd_torch.core.registration import (
        _cheb_span,
        _self_sweeps,
        prepare_batch,
        route,
    )
    from cvo_rgbd_torch.ops import gram, wsq
    from cvo_rgbd_torch.params import AcvoParams

    pa = AcvoParams()
    dev = batches["acvo"][0][0].positions.device
    shift = torch.tensor(LANE_SHIFT, device=dev)
    fast = _fast
    for name, q, key, ells in (
            ("acvo render 9x3072 ell 0.1-0.0391", pa, "acvo",
             (pa.ell_init, pa.ell_min)),
            ("acvo render 9x3072 ell 0.1-0.0391 fast", fast(pa), "acvo",
             (pa.ell_init, pa.ell_min)),
            ("acvo render 9x3072 ell 0.1", pa, "acvo", (0.1, 0.1)),
            ("acvo render 9x3072 ell 0.3", pa, "acvo", (0.3, 0.3)),
            ("pcd 63x384 ell 0.1-0.0391", pa, "pcd",
             (pa.ell_init, pa.ell_min))):
        xs, ys = batches[key]
        q, x, y = route(q, stack_clouds(xs), stack_clouds(ys))
        b = x.positions.shape[0]
        pre = prepare_batch(q, x, y, [None] * b)
        sweeps = _self_sweeps(x, (y.positions + shift, y.features, y.mask),
                              pre.ck, pre.skip)
        scal = gram.scalars(torch.linspace(*ells, b, device=dev), q)
        fst = q.exp_mode == "fast"
        nobody = torch.zeros(b, dtype=torch.bool, device=dev)
        time_lane_case(
            "fused_wsq lanes", name,
            lambda: wsq.fused_wsq_sweeps_cuda(sweeps, scal, fst),
            none=lambda: wsq.fused_wsq_sweeps_cuda(sweeps, scal, fst,
                                                   nobody),
            kept=wsq_kept(sweeps, scal))
        if key == "acvo" and ells[0] != ells[1]:
            lane0 = [wsq.lane_sweep(sw, 0) for sw in sweeps]
            for e in (pa.ell_init, pa.ell_min):
                s1 = gram.scalars(torch.full((), e, device=dev), q)
                for sw, label in zip(lane0, ("fixed", "moving")):
                    for use_ck in (True, False):
                        one = [sw._replace(ck=sw.ck if use_ck else None)]
                        time_lane_case(
                            "fused_wsq", f"acvo pair 3072 {label} ell {e} "
                            f"ck={use_ck}" + " fast" * fst,
                            lambda one=one, s1=s1: wsq.fused_wsq_sweeps_cuda(
                                one, s1, fst), lanes=False)
                time_lane_case(
                    "fused_wsq", f"acvo pair 3072 both sweeps ell {e} ck"
                    + " fast" * fst, lambda s1=s1: wsq.fused_wsq_sweeps_cuda(
                        lane0, s1, fst), lanes=False)
    # the Chebyshev tables of the 9 acvo lanes: 2K sweeps a lane, each
    # lane at its own nodes, one launch
    qc = dataclasses.replace(pa, self_mode="cheb")
    qc, x, y = route(qc, *(stack_clouds(c) for c in batches["acvo"]))
    b = x.positions.shape[0]
    pre = prepare_batch(qc, x, y, [None] * b)
    ells = torch.tensor([_cheb_span(qc, None)[4]] * b, dtype=torch.float32,
                        device=dev).repeat_interleave(2, dim=-1)
    sweeps = _self_sweeps(x, y, pre.ck, pre.skip) * int(qc.self_cheb_k)
    scal = gram.scalars(ells, qc)
    nobody = torch.zeros(b, dtype=torch.bool, device=dev)
    time_lane_case(
        "fused_wsq lanes", f"acvo cheb tables 9x{len(sweeps)} sweeps x3072",
        lambda: wsq.fused_wsq_sweeps_cuda(sweeps, scal),
        none=lambda: wsq.fused_wsq_sweeps_cuda(sweeps, scal, False, nobody),
        kept=wsq_kept(sweeps, scal))


def wsq_kept(sweeps, scal):
    """The share of the swept tiles that the (lane, sweep) units of a
    lane-axis launch keep; `scal` [B, 8] or [B, S, 8]."""
    from cvo_rgbd_torch.ops import gram, wsq

    kept = total = 0
    for i in range(scal.shape[0]):
        for k, sw in enumerate(sweeps):
            row = scal[i] if scal.dim() == 2 else scal[i, k]
            thr = (row[gram.S_D2_THRES] + wsq.SKIP_MARGIN).item()
            kept += wsq.kept_prefix(sw.tiles.sorted[i], thr)
            total += sw.tiles.sorted.shape[-1]
    return kept / total


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


# the seeds of the probes' seeded inputs
PROBE_SEEDS = (0, 1)


def seeded_probes():
    """The `probes` module of the package under test or, for a package
    from before `probes.seeded_inputs`, this file's sibling
    `probes.py`: the source of the seeded inputs."""
    import importlib.util

    from cvo_rgbd_torch import probes

    if hasattr(probes, "seeded_inputs"):
        return probes
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "probes.py")
    spec = importlib.util.spec_from_file_location("_sibling_probes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_probes():
    """Row 8's toy cases and their library counterparts; see the module
    docstring."""
    import torch

    import cvo_rgbd_torch
    from cvo_rgbd_torch import probes

    sp = seeded_probes()
    dev = torch.device("cuda")
    launch_floor()
    for case in probes.CASES:
        ins = probes.inputs(case, dev)

        def fn():
            return probes.construct_probe_cuda(case, *ins)

        bits = {"scripts": sha1(fn())}
        for seed in PROBE_SEEDS:
            bits[f"seed{seed}"] = sha1(probes.construct_probe_cuda(
                case, *sp.seeded_inputs(case, dev, seed)))
        if case in sp.GUARDED:
            bits["guard_off"] = sha1(probes.construct_probe_cuda(
                case, *sp.seeded_inputs(case, dev, 0, sp.GUARD_OFF)))
        print(json.dumps({
            "package": cvo_rgbd_torch.__file__, "case": case,
            "ms": time_ms(fn), "launches_per_call": launches_per_call(fn),
            "device_ms_by_kernel": device_ms_by_kernel(fn), "sha1": bits,
        }), flush=True)
    a, b = probes.inputs("e", dev)[1:]
    x = probes.inputs("h", dev)[0]
    for case, call, fn in (
            ("e", "torch.matmul(a[:, 0:8].T, b)",
             lambda: torch.matmul(a[:, 0:8].T, b)),
            ("h", "torch.sum(x[256:512])", lambda: torch.sum(x[256:512]))):
        print(json.dumps({"library": call, "case": case, "ms": time_ms(fn),
                          "launches_per_call": launches_per_call(fn)}),
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
        for (start, end, n, lds, frnd, ex2), mix in sass_loops(lib, kernel):
            print(json.dumps({"loop": f"{start:#x}-{end:#x}",
                              "instructions": n, "shared_loads": lds,
                              "frnd": frnd, "mufu_ex2": ex2, "mix": mix}))
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
    if argv[:1] == ["--lanes"]:
        _build.build(("color_gram", "fused_moments", "fused_wsq"))
        time_lanes()
        return 0
    if argv[:1] == ["--probes"]:
        _build.build(("construct_probe",))
        time_probes()
        return 0
    if argv[:1] == ["--profiler"]:
        _build.build(("color_gram", "fused_flow"))
        profiler_misses()
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
