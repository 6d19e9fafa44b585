#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. environment: card name and power limit, pinned fp32 precision, the
   CUDA kernels built from `cvo_rgbd_torch/csrc/` with nvcc;
2. data: a 10-frame `revisit_path` sequence rendered in memory at
   240x320 (`cvo_rgbd_torch.synth`), frontend at num_want=3000
   (capacity 3072), cvo features (RGB) and acvo features (HSV); 2b. the
   same frames backprojected whole (`depth_to_cloud`), written as .pcd
   files and loaded as the MATLAB batch runner loads them (range filter
   [0.8, 4] m, then a 0.05 m grid: capacity 384, resident on the fused
   backend), and on a 0.015 m grid (capacity 2816, tiled);
3. kernels vs their plain torch versions on the card, on the first pair
   at N=M=3072, with CUDA-event timings: `color_gram` and
   `fused_moments` on the cvo clouds; 3b. `fused_wsq` on the acvo
   clouds' two self-pairs, then both in one launch (an exact acvo
   iteration), each sweep the bits of its one-sweep call; 3c. the whole-align kernel `align_fused`
   after 1, 3 and 10 iterations, tiled on the first cvo and acvo pairs
   (N=M=3072) and resident on two small pairs (N=M=1024); 3d. the
   two-pass sweeps `fused_flow` and `fused_step_coeffs` on the first cvo
   pair at ell 0.1 and 0.03, with and without the color cache, then in
   MATLAB's linear mode with the CI on the first pcd pairs, each with
   the tile skip on and off and twice (the same bits each time), with
   the share of tiles kept; 3e. the linear branches of `fused_moments`
   and `align_fused` (tiled on the 0.015 m pair, resident on the 0.05 m
   pair); 3f. phases 3-3e again on the same inputs for the
   exp_mode="fast" form of every kernel but `color_gram` (`__expf`,
   against the fast plain versions on `torch.exp`): the two exps round
   differently, so each output is held to the precise check's tolerance
   of its magnitude, a nnz may be off by at most the pairs whose gate
   value lies within 1e-5 of sp_thres (`near_gate_pairs`, counted on the
   plain side), the tile skip on and off and two runs give the same
   bits, and `align_fused`'s fast launch must not give the precise
   launch's bits; ahead of them a probe of one pair whose exp argument
   lies where `__expf` and `exp_neg` part by up to tens of ulps, on which
   every fast instantiation of the sweeps must give other bits than its
   precise twin (`phase_exp_forms`); each fast kernel is timed in turns
   with its precise form (`time_forms`);
4. one reference-scale cvo align at the C++ stops (eps=5e-5,
   eps_2=1e-5) on the kernel backend, a small pair registered on the
   card and on the CPU (plain versions), which must agree, and a
   profile of one iteration, with the moment sweep and with the direct
   step's two sweeps (one launch each an iteration); 4b. the same for
   acvo (`self_mode="exact"`, both self-sweeps one launch an iteration;
   then one align with `"cheb"`, its tables one launch); 4c. the
   same aligns on the fused backend, each run twice (the iterations must
   repeat), ms/iteration by slope (10 against 60 iterations) and a
   profile of one align;
5. the main paths: `run_odometry_frames` over the rendered sequence for
   cvo, 5b. then for acvo (`adaptive=True`), 5c. then for both on the
   fused backend at capacity 3072 (tiled) and 1024 (resident), 5d. then
   for both on the kernel backend with `step_mode="direct"` (`fused_flow`
   and `fused_step_coeffs` in place of `fused_moments`), each with every
   kernel's launch count set to 0 just before and read just after, and
   the trajectory scored (ATE) against the exact ground truth.  The
   fused runs must launch `align_fused` once a pair and none of the
   per-iteration kernels;
6. the MATLAB path on the pcd files at both grids: `cli batch` (kernel
   backend: `fused_moments`, never `color_gram`), `run_batch` on the
   fused backend (`align_fused` once a pair) and with
   `step_mode="direct"` (`fused_flow` and `fused_step_coeffs` each
   iteration), each scored against the exact relative ground truth; one
   small linear pair on the card and on the CPU; `cli stitch`.  3d and
   3e take the linear pairs at the batch's capacity for the grid;
7. the construct probes: `python -m cvo_rgbd_torch.probes` (its `main`)
   with the launch counts read around it, then each toy case of
   `csrc/construct_probe.cu` against its plain version (exact; e within
   1e-6 relative) and its closed form, each timed, and the four tiled
   aligns against `align_fused_plain(mode="tiled")` (equal iterations, tf
   within 1e-5);
8. batched fused registration: the 9 pcd pairs of 6 stacked 7 times (63
   lanes) at both grids through `parallel.align_batched`: exactly one
   `align_fused` launch a batch, every lane the bits of `align` on its
   pair alone, pairs/s batched against the same 63 aligns one by one,
   device busy share and launches from a profile of one batch, and the
   batched launch against the plain version lane by lane (after 1
   iteration every output within 1e-5; after 10 R, T and ell within
   1e-4, and the 10th iteration's tf, R, T, omega and v within 1e-5 of
   one plain step from the kernel's state after 9); then all of it
   again with exp_mode="fast" (its launch timed in turns with the
   precise one), whose rows are logged and not in the kernel line;
   8b. `run_odometry_batched(batch=9)` over the render on
   the fused backend (cvo and acvo, 3072, tiled) and on the kernel
   backend (cvo), each against `run_odometry_frames(warm_start=False)`
   in the same run, and `run_multiseq` over the render written as a TUM
   folder and a 2-frame prefix of it (ragged lanes), each lane against
   its solo run;
9. keyframe SLAM over a 40-frame path along the optical axis and back
   (`synth.depth_loop_path`), written as .pcd: `python -m
   cvo_rgbd_torch.cli slam` (MATLAB_PARAMS, kernel backend) with its
   frames, keyframes, loop closures, s/frame and ATE against the exact
   ground truth; then `KeyframeSlam` with exp_mode="fast" on the kernel
   backend (moment and direct step) and on the fused one at both grids,
   and fast acvo on a 10-frame prefix (its self-sweeps), each beside its
   precise twin (`cli slam`'s poses for the moment step; KeyframeSlam
   runs for the others) with the odometry and SLAM ATE, the keyframe and
   loop lists, and its largest translation from the twin, which must be
   within FAST_POSE_TOL.  Every run needs a loop closure (the prefix
   excepted), finite poses and the launches of its route: these are the
   fast kernels' main path.  Last, the fast kernels checked and timed in
   turns with their precise forms at the shapes of these launches (the
   linear sweeps at the coarse grid's capacity, acvo's moment sweep and
   self-sweeps at 1024).

The line before last is a JSON object with each kernel's launches on
the main paths together, its error against the plain version, its
time, the plain version's time and its bound (the batched rows of
`align_fused`: a 63-lane launch of exactly 10 iterations, and their
launches those of phases 8 and 8b; the "<kernel>/fast" rows: phase 3f,
each max_abs_err the worst of every case it checks, their launches
those of phase 9's fast runs); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 outside the
# tensor cores; both kernels run scalar fp32 arithmetic
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# fp32 operations per evaluated pair, counted from csrc/pair_tile.cuh:
# exp_neg ~24 (min, scale, round, 4 for the reduction, 14 for the
# degree-7 Horner, the exponent scale); the color kernel adds 14 for
# d2c, 2 scalings and 4 compares/selects; a pair of the moment sweep
# costs 8 for d2, 2 scalings and 3 compares/selects besides exp_neg, and
# 70 more (35 FMAs) where it passes the gate
OPS_COLOR = 24 + 14 + 2 + 4
OPS_PAIR = 24 + 8 + 2 + 3
# exp_mode="fast": __expf is a multiply by log2(e) and the SFU's ex2, two
# operations in place of exp_neg's 24
EXP_OPS, EXP_FAST_OPS = 24, 2
OPS_GATED = 70
# a pair of the self-sweep that passes the gate: the a*d2 FMA (2) and
# the count
OPS_WSQ_GATED = 3
# csrc/fused_flow.cu, where A is nonzero: the flow sweep's sum A, three
# FMAs into sum A y, the A d2 FMA and the count; the step sweep's four
# dot fields (6 each), beta..epsilon (9), and B..E with their sums (~27);
# per column of the step sweep, the fields xi z .. xi^4 z and their dots
OPS_FLOW_GATED = 10
OPS_STEP_GATED = 60
OPS_STEP_COLUMN = 80
# the per-iteration kernels of the odometry paths, then the two sweeps of
# the kernel backend's step_mode="direct"
PER_ITER = ("color_gram", "fused_moments", "fused_wsq")
KERNELS = PER_ITER + ("fused_flow", "fused_step_coeffs")
FUSED = ("align_fused_tiled", "align_fused_resident")
PROBE = "construct_probe"
# the batched launches of the fused kernel, one row each in the kernel line
BATCHED = ("align_fused_tiled_batched", "align_fused_resident_batched")
# the exp_mode="fast" forms, one row each (color_gram has none)
FAST = tuple(f"{k}/fast" for k in KERNELS[1:] + FUSED)
FUSED_ITERS = (1, 3, 10)
# capacity of the resident-mode odometry run: N = M = 1024 is within
# both resident budgets (cvo N*M <= 2^20, acvo N*M + N^2 + M^2 <= 3*2^20)
RESIDENT_NUM_WANT = 1024
# the cell: a 10-frame sequence rendered at 240x320, 3000 points a frame
# (capacity 3072); the small pair of the card-vs-CPU checks, 96x128
FRAMES, SIZE, NUM_WANT = 10, (240, 320), 3000
SMALL_SIZE, SMALL_NUM_WANT = (96, 128), 1024
RUNS = 30
WARMUP = 5
# a whole plain align of 10 iterations takes 0.1-0.3 s: fewer runs
PLAIN_ALIGN_RUNS, PLAIN_ALIGN_WARMUP = 5, 1
# ~0.5 ms of device clock cycles, longer than a wrapper's host overhead
SPIN_CYCLES = 1_000_000
# ~10 ms: align_fused's wrapper enqueues its per-align precompute (the
# moment basis, tile bounds, a few copies) before the launch
ALIGN_SPIN_CYCLES = 20_000_000
# the MATLAB batch runner's grid (rgbddataset_rkhs.m:40-47), and a finer
# one whose clouds run tiled on the fused backend
BATCH_GRID, FINE_GRID = 0.05, 0.015
# phase 8: the 9 pcd pairs stacked 7 times, 63 lanes
LANE_REPEAT = 7
# phase 8b: pairs per batched call (the render's 9 pairs in one batch)
ODOM_BATCH = 9
# phase 9: keyframe SLAM over a path along the optical axis and back, a
# period and a third; the fast acvo run takes a prefix at a smaller
# capacity (its self-sweeps)
SLAM_FRAMES, SLAM_PERIOD = 40, 30
SLAM_ACVO_FRAMES, SLAM_ACVO_NUM_WANT = 10, 1024
# the largest translation (m) a fast run may land from its precise twin:
# the JAX package's own fast-vs-precise bound (tests/test_core.py)
FAST_POSE_TOL = 2e-3
# 3f's form probe: the position exp's arguments z of its one pair, where
# __expf is up to tens of ulps off and exp_neg one (phase_exp_forms)
FORM_Z = tuple(float(z) for z in range(42, 74, 2))
# phase 10: frames of the profiled kernel-backend cli run (1238 launches
# an iteration: a trace of the whole render would run to millions of
# events), and passes of the prefetch loader over the folder
PROFILED_FRAMES = 3
LOADER_PASSES = 5
# fp32 operations of each toy probe case (csrc/construct_probe.cu): e's
# 3 x [8, 128] dots of depth 256 (an FMA is 2), j's 256 x 256
# difference, square and sum (4 with the scaling), one or two for the rest
PROBE_OPS = {"e": 3 * 8 * 128 * 256 * 2, "j": 256 * 256 * 4}
# the parts of its inputs each probe's [8, 128] result depends on (the
# plain versions of probes.py), as (input, (rows, columns)): what the
# function must read, whatever the kernel reads besides
_ALL, _ROW0 = slice(None), slice(0, 1)
_OUT_BLOCK = (0, (slice(0, 8), slice(0, 128)))
PROBE_READS = {
    "a": (_OUT_BLOCK,), "b": (_OUT_BLOCK,), "b2": (_OUT_BLOCK,),
    "c": ((0, (_ROW0, _ROW0)), (0, (_ROW0, slice(159, 160)))),
    "d": ((0, (_ROW0, _ROW0)),),
    "e": ((0, (_ROW0, _ROW0)), (1, (_ALL, slice(0, 8))),
          (2, (_ALL, slice(0, 128)))),
    "h": ((0, (slice(256, 512), _ALL)),),
    "i": ((0, (_ALL, slice(256, 512))),),
    "j": ((0, (slice(256, 512), _ALL)), (1, (_ALL, slice(256, 512)))),
    "k": (),
}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _timed(fn, spin):
    """fn's time between two CUDA events, a device-side spin ahead of the
    first."""
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


def median(times):
    return sorted(times)[len(times) // 2]


def time_ms(fn, runs=RUNS, warmup=WARMUP, spin=SPIN_CYCLES):
    """Median over `runs` calls of fn, each between its own CUDA events,
    after `warmup` untimed calls.  A short device-side spin ahead of the
    first event lets the host enqueue fn's launches before the clock
    starts, so a kernel's time is its device time, not the wrapper's
    Python overhead (a plain version that synchronizes still pays it)."""
    for _ in range(warmup):
        fn()
    return median([_timed(fn, spin) for _ in range(runs)])


def time_forms(launch, fast, runs=RUNS, warmup=WARMUP, spin=SPIN_CYCLES):
    """(ms, precise ms) of launch(fast), each as time_ms.  In fast mode
    the precise form, launch(False), is timed in turns with the fast one
    on the same inputs, the fast form first on even runs and the precise
    one first on odd runs, so that neither the order nor a drift of the
    card's clock favours one form; else the precise ms is None."""
    if not fast:
        return time_ms(lambda: launch(False), runs, warmup, spin), None
    for _ in range(warmup):
        launch(True)
        launch(False)
    times = {True: [], False: []}
    for r in range(runs):
        for f in (True, False) if r % 2 == 0 else (False, True):
            times[f].append(_timed(lambda: launch(f), spin))
    return median(times[True]), median(times[False])


def forms_note(ms, ms_p):
    """The log's note of the precise form's time beside the fast one's."""
    if ms_p is None:
        return ""
    return (f" (precise {ms_p:.4f} ms, timed in turns; fast/precise "
            f"{ms / ms_p:.3f})")


def pair_ops(color, fast=False):
    """fp32 operations of one pair's weight: the position kernel, and the
    color kernel when it is recomputed (`color`), each exponential two
    operations under exp_mode="fast"."""
    ops = OPS_PAIR + (OPS_COLOR if color else 0)
    return ops - (1 + bool(color)) * (EXP_OPS - EXP_FAST_OPS) * bool(fast)


def bound(nbytes, nops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def png_bytes(img):
    """A PNG file's bytes for an 8-bit RGB [H,W,3] uint8 or a 16-bit gray
    [H,W] uint16 image, with the standard library alone (zlib, struct):
    phase 10 writes its TUM folder without PIL.  Every row takes filter
    type 0 (none)."""
    import struct
    import zlib

    import numpy as np

    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, color_type, raw = 8, 2, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        depth, color_type, raw = 16, 0, img.astype(">u2")
    else:
        raise ValueError(f"png_bytes: {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(raw).reshape(h, -1).view(np.uint8)
    data = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(data.tobytes(), 6))
            + chunk(b"IEND", b""))


def form_probe_clouds(dev, n_valid):
    """A cloud of capacity 128 whose first `n_valid` points (at most 2)
    are valid, 1 apart along y; the rest masked, 10 apart from each
    other and 100 from the first; the same features everywhere, so that
    a color exp takes 0 and only the position exp tells the forms
    apart.  The moving cloud is the fixed one moved 1 along x."""
    import torch

    from cvo_rgbd_torch.core.cloud import PointCloud

    cap = 128
    pos = torch.zeros(cap, 3, device=dev)
    pos[:, 0] = 100.0 + 10.0 * torch.arange(cap, device=dev)
    pos[:2] = torch.tensor([[0.3, -0.2, 1.5], [0.3, 0.8, 1.5]], device=dev)
    mask = (torch.arange(cap, device=dev) < n_valid).float()
    feat = torch.full((cap, 5), 0.5, device=dev)
    fixed = PointCloud(pos, feat, mask)
    moving = PointCloud(pos + torch.tensor([1.0, 0.0, 0.0], device=dev),
                        feat, mask)
    return fixed, moving


def phase_exp_forms():
    """3f: which exp each fast kernel instantiation takes.  On real
    clouds a sweep's one-float sum may round to the same bits under both
    exps (where the gate passes, exp_neg and __expf mostly agree to an
    ulp), so each kernel runs here, precise and fast, on one valid pair
    (two points of one cloud for the self-sweep) whose position exp
    takes z in FORM_Z, with the gate opened (d2_thres 2, sp_thres 0):
    there __expf, ex2.approx of z log2(e) rounded to float, is off by up
    to tens of ulps and exp_neg by one.  Every instantiation (fused_moments
    and the two sweeps se, se with the cache, linear; fused_wsq with and
    without the cache) must give other bits fast than precise for at
    least one z: the FAST flag reached it.  align_fused is held per case
    in 3c, where its iterations carry any difference into the pose."""
    import torch

    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import flow, gram, moments, wsq
    from cvo_rgbd_torch.params import MATLAB_PARAMS, CvoParams

    dev = torch.device("cuda")
    x, y = form_probe_clouds(dev, 1)
    pair2, _ = form_probe_clouds(dev, 2)
    one = torch.zeros(128, 128, device=dev)
    one[0, 0] = 1.0
    self_ck = torch.zeros(128, 128, device=dev)
    self_ck[:2, :2] = 1.0
    c0, xc, phi = build_moments_pre(x)
    yc = y.positions - c0
    wv = torch.tensor([0.1, -0.2, 0.3, 0.05, 0.1, -0.1], device=dev)

    def rows(p):
        base = gram.scalars(torch.full((), 0.1, device=dev), p)
        out = []
        for z in FORM_Z:
            r = base.clone()
            r[gram.S_INV_2L2], r[gram.S_D2_THRES] = z, 2.0
            r[gram.S_SP_THRES] = 0.0
            out.append(r)
        return out

    cases = []
    for mode, p, ck in (("se", CvoParams(), None), ("se ck", CvoParams(), one),
                        ("linear", MATLAB_PARAMS, one)):
        lin = mode == "linear"
        cases += [
            (f"fused_moments {mode}", rows(p), lambda r, f, ck=ck, lin=lin:
             moments.fused_moments_cuda(xc, x.features, x.mask, yc,
                                        y.features, y.mask, phi, r, ck,
                                        None, lin, fast=f)),
            (f"fused_flow {mode}", rows(p), lambda r, f, ck=ck, lin=lin:
             (flow.fused_flow_cuda(*x, *y, r, ck, lin, skip=False,
                                   fast=f),)),
            (f"fused_step_coeffs {mode}", rows(p),
             lambda r, f, ck=ck, lin=lin: (flow.fused_step_coeffs_cuda(
                 *x, *y, r, wv, ck, lin, skip=False, fast=f),))]
    for mode, ck in (("ck", self_ck), ("no ck", None)):
        cases.append((f"fused_wsq {mode}", rows(CvoParams()),
                      lambda r, f, ck=ck: wsq.fused_wsq_cuda(
                          *pair2, *pair2, r, ck, None, symmetric=True,
                          fast=f)))
    for label, scal_rows, launch in cases:
        differ = 0
        for r in scal_rows:
            a, b = launch(r, True), launch(r, False)
            check(all(torch.isfinite(t).all() for t in a + b)
                  and bool(b[0].abs().max() > 0),
                  f"form probe {label}: the pair did not pass the gate")
            differ += not all(torch.equal(bits(u), bits(v))
                              for u, v in zip(a, b))
        log(f"form probe {label}: fast and precise bits differ at "
            f"{differ}/{len(scal_rows)} z in [{FORM_Z[0]:g}, "
            f"{FORM_Z[-1]:g}]")
        check(differ > 0, f"form probe {label}: the fast launch gave the "
              "precise launch's bits at every z: FAST did not reach it")


def phase_kernels(fixed, moving, p, fast=False, ells=None):
    """Each kernel against its plain version on the first pair:
    `color_gram` (precise only: it has no fast form, and its cache feeds
    the fast sweeps as it is), then `fused_moments` at `ells` (ell_init
    and the schedule's last by default), ck on and off, skip on and off.
    `fast`: the exp_mode="fast" form, held as phase 3f of the module
    docstring says, and timed in turns with the precise form."""
    import torch

    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds, kd_sort
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import gram, moments

    fixed, moving = kd_sort(fixed), kd_sort(moving)
    dev = fixed.positions.device
    n, m = fixed.capacity, moving.capacity
    ells = ells or (p.ell_init, p.ell_sched[-1][1])
    tag = "/fast" if fast else ""
    out = {}

    # --- color_gram ---
    scal_c = gram.scalars(torch.full((), p.ell_init, device=dev), p)
    args_c = (fixed.features, fixed.mask, moving.features, moving.mask,
              scal_c)
    ck = gram.color_gram_cuda(*args_c)
    if not fast:
        ck_plain = gram.color_gram_plain(*args_c)
        torch.cuda.synchronize()
        err = (ck - ck_plain).abs().max().item()
        log(f"color_gram N={n} M={m}: max_abs_err={err:.3e} (tolerance "
            "1e-6)")
        check(err <= 1e-6,
              f"color_gram disagrees with its plain version: {err}")
        ms = time_ms(lambda: gram.color_gram_cuda(*args_c))
        plain_ms = time_ms(lambda: gram.color_gram_plain(*args_c))
        nbytes = (n + m) * 6 * 4 + 8 * 4 + n * m * 4
        b_ms, b_by = bound(nbytes, n * m * OPS_COLOR)
        log(f"color_gram: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        out["color_gram"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by)

    # --- fused_moments: with and without ck, skip on and off ---
    c0, x_c, phi = build_moments_pre(fixed)
    y_c = moving.positions - c0
    cloud = (x_c, fixed.features, fixed.mask, y_c, moving.features,
             moving.mask)
    lo_x, hi_x = block_bounds(fixed.positions, fixed.mask, moments.TILE_I)
    lo_y, hi_y = block_bounds(moving.positions, moving.mask, moments.TILE_J)
    md = aabb_min_d2(lo_x, hi_x, lo_y, hi_y)
    err_all = 0.0
    for ell_v in ells:
        scal = gram.scalars(torch.full((), ell_v, device=dev), p)
        keep = md <= scal[gram.S_D2_THRES] + moments.SKIP_MARGIN
        for use_ck in (True, False):
            ck_in = ck if use_ck else None
            ref, ref_nnz = moments.fused_moments_plain(
                *cloud, phi, scal, ck_in, None, fast=fast)
            near = (moments.near_gate_pairs(*cloud, scal, ck_in) if fast
                    else None)
            got = {}
            for skip in (False, True):
                args = (*cloud, phi, scal, ck_in, md if skip else None)
                mom, nnz = moments.fused_moments_cuda(*args, fast=fast)
                torch.cuda.synchronize()
                got[skip] = (mom.clone(), nnz.item())
                colmax = ref.abs().amax(dim=0).clamp_min(1e-30)
                rel = ((mom - ref).abs() / colmax).max().item()
                err_all = max(err_all, (mom - ref).abs().max().item())
                log(f"fused_moments{tag} ell={ell_v} ck={use_ck} skip={skip}"
                    f": Mom err/max|col|={rel:.3e} (tolerance 1e-4), nnz "
                    f"{nnz.item():.0f} vs {ref_nnz.item():.0f}"
                    + (f", near-gate pairs {near} (the tolerance)" if fast
                       else ""))
                check(rel <= 1e-4, f"fused_moments{tag} Mom disagrees: {rel}")
                if fast:
                    check(abs(nnz.item() - ref_nnz.item()) <= near
                          and nnz.item() > 0, f"fused_moments/fast nnz "
                          f"{nnz.item()} vs {ref_nnz.item()}")
                else:
                    check(abs(nnz.item() - ref_nnz.item()) <= 1e-4 * max(
                        ref_nnz.item(), 1.0), f"fused_moments nnz disagrees:"
                          f" {nnz.item()} vs {ref_nnz.item()}")
            check(torch.equal(got[False][0], got[True][0])
                  and got[False][1] == got[True][1],
                  f"fused_moments{tag}: tile skip on and off differ")
            args = (*cloud, phi, scal, ck_in, md)
            ms, ms_p = time_forms(
                lambda f: moments.fused_moments_cuda(*args, fast=f), fast)
            plain_ms = time_ms(lambda: moments.fused_moments_plain(
                *args, fast=fast))
            pairs = int(keep.sum().item()) * moments.TILE_I * moments.TILE_J
            nnz_v = got[True][1]
            nbytes = (n * (3 + moments.NUM_MONO) + m * 3 + m * moments.NUM_MONO
                      + md.numel() + 8 + 1) * 4
            nbytes += pairs * 4 if use_ck else (n + m) * 6 * 4
            b_ms, b_by = bound(nbytes, pairs * pair_ops(not use_ck, fast)
                               + nnz_v * OPS_GATED)
            log(f"fused_moments{tag} N={n} ell={ell_v} ck={use_ck} skip=True:"
                f" {ms:.4f} ms{forms_note(ms, ms_p)}, plain {plain_ms:.4f} "
                f"ms, bound {b_ms:.4f} ms ({b_by}); tiles kept "
                f"{keep.float().mean().item():.3f}, nnz {nnz_v:.0f}")
            if use_ck and ell_v == ells[-1]:
                out["fused_moments" + tag] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    ell=ell_v)
    out["fused_moments" + tag]["max_abs_err"] = err_all
    return out


def phase_wsq(fixed, moving, p, fast=False):
    """fused_wsq against its plain version on both self-pairs of the
    first acvo pair: ell_init and ell_min, ck on and off, skip on and
    off, symmetric and full; then an exact acvo iteration's one launch
    of both sweeps (S = 2), each sweep the bits of its one-sweep call.
    `fast`: the exp_mode="fast" form (phase 3f of the module docstring)."""
    import torch

    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds, kd_sort
    from cvo_rgbd_torch.ops import gram, moments, wsq
    from cvo_rgbd_torch.ops.moments import SKIP_MARGIN, pair_weights

    tw = wsq.TILE_W
    tag = "/fast" if fast else ""
    out = {}
    singles = {}
    err_all = 0.0
    for label, cloud in (("fixed", fixed), ("moving", moving)):
        x = kd_sort(cloud)
        dev = x.positions.device
        n = x.capacity
        ck = gram.color_gram_cuda(x.features, x.mask, x.features, x.mask,
                                  gram.scalars(torch.full((), p.ell_init,
                                                          device=dev), p))
        check(torch.equal(ck, ck.T), "color_gram of a self-pair is not "
              "exactly symmetric")
        lo, hi = block_bounds(x.positions, x.mask, tw)
        md = aabb_min_d2(lo, hi, lo, hi)
        tiles = wsq.tile_order(md, True)
        nb = n // tw
        upper = torch.triu(torch.ones(nb, nb, dtype=torch.bool, device=dev))
        for ell_v in (p.ell_init, p.ell_min):
            scal = gram.scalars(torch.full((), ell_v, device=dev), p)
            keep = (md <= scal[gram.S_D2_THRES] + SKIP_MARGIN) & upper
            for use_ck in (True, False):
                ck_in = ck if use_ck else None
                ref_w, ref_n = wsq.fused_wsq_plain(*x, *x, scal, ck_in,
                                                   fast=fast)
                ref_w, ref_n = ref_w.item(), ref_n.item()
                # precise: nnz exact
                near = moments.near_gate_pairs(*x, *x, scal, ck_in) if fast \
                    else 0
                got = {}
                for sym in (False, True):
                    for skip in (False, True):
                        w, nz = wsq.fused_wsq_cuda(
                            *x, *x, scal, ck_in, md if skip else None,
                            symmetric=sym, fast=fast)
                        torch.cuda.synchronize()
                        got[sym, skip] = (w.item(), nz.item())
                err = max(abs(w - ref_w) for w, _ in got.values())
                err_all = max(err_all, err)
                log(f"fused_wsq{tag} {label} N={n} ell={ell_v} ck={use_ck}: "
                    f"wsq {ref_w:.6e}, max |err| {err:.3e} (tolerance 1e-4 "
                    f"relative), nnz {ref_n:.0f}; kernel nnz "
                    f"{sorted({nz for _, nz in got.values()})}"
                    + (f", near-gate pairs {near} (the tolerance)" if fast
                       else ""))
                check(err <= 1e-4 * abs(ref_w),
                      f"fused_wsq{tag} disagrees with its plain version: "
                      f"{err}")
                check(all(abs(nz - ref_n) <= near for _, nz in got.values())
                      and ref_n > 0, f"fused_wsq{tag} nnz differs from the "
                      "plain version's")
                check(all(got[sym, False] == got[sym, True]
                          for sym in (False, True)),
                      f"fused_wsq{tag}: tile skip on and off differ")
                singles[label, ell_v, use_ck] = (x, ck_in, tiles,
                                                 got[True, True])
                if not (label == "fixed" and use_ck and ell_v == p.ell_min):
                    continue
                # the main path's configuration: symmetric, ck, the tile
                # order an align builds once
                args = (*x, *x, scal, ck_in, tiles)
                ms, ms_p = time_forms(lambda f: wsq.fused_wsq_cuda(
                    *args, symmetric=True, fast=f), fast)
                plain_ms = time_ms(lambda: wsq.fused_wsq_plain(*args,
                                                               fast=fast))
                kept = int(keep.sum().item())
                pairs = kept * tw * tw
                # gated pairs the upper-triangle sweep evaluates
                per_tile = (pair_weights(*x, *x, scal, ck_in, fast=fast)
                            > 0).reshape(nb, tw, nb, tw).sum(dim=(1, 3))
                gated = int(per_tile[upper].sum().item())
                nbytes = (n * 3 + pairs + int(upper.sum().item()) + 8 + 2) * 4
                b_ms, b_by = bound(nbytes, pairs * pair_ops(False, fast)
                                   + gated * OPS_WSQ_GATED)
                log(f"fused_wsq{tag} {label} ell={ell_v} ck=True skip=True "
                    f"symmetric: {ms:.4f} ms{forms_note(ms, ms_p)}, plain "
                    f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
                    f"upper-triangle tiles kept {kept}/"
                    f"{int(upper.sum().item())}, gated pairs {gated}")
                out["fused_wsq" + tag] = dict(ms=ms, plain_ms=plain_ms,
                                              bound_ms=b_ms, bound_by=b_by,
                                              ell=ell_v)
    out["fused_wsq" + tag]["max_abs_err"] = err_all
    # an exact acvo iteration: both self-sweeps in one launch
    for ell_v in (p.ell_init, p.ell_min):
        scal = gram.scalars(torch.full((), ell_v, device=dev), p)
        for use_ck in (True, False):
            pair = [singles[label, ell_v, use_ck]
                    for label in ("fixed", "moving")]
            sweeps = [wsq.Sweep(tuple(x), tuple(x), ck_in, tiles, True)
                      for x, ck_in, tiles, _ in pair]
            before = wsq.fused_wsq.launches
            w, nz = wsq.fused_wsq_sweeps_cuda(sweeps, scal, fast=fast)
            torch.cuda.synchronize()
            check(wsq.fused_wsq.launches == before + 1,
                  f"fused_wsq{tag}: two sweeps took more than one launch")
            got = [(w[k].item(), nz[k].item()) for k in range(2)]
            check(got == [one for _, _, _, one in pair],
                  f"fused_wsq{tag}: a sweep of the S = 2 launch is not its "
                  f"one-sweep call's bits: {got}")
            ms = time_ms(lambda: wsq.fused_wsq_sweeps_cuda(sweeps, scal,
                                                           fast=fast))
            log(f"fused_wsq{tag} S=2 (fixed, moving) ell={ell_v} ck={use_ck}"
                f": each sweep its one-sweep bits, one launch, {ms:.4f} ms")
    return out


def fused_bound(counts, x, y, lanes=1, fast=False):
    """(bound ms, bound_by) of align_fused over the pairs its plain
    version counted (over every lane): each pair of a kept tile, once an
    iteration (the flow and the line search both come from the same
    weights), its color kernel recomputed; each lane's clouds and result
    moved once.  Resident mode's read-back of its stored weights for the
    row flow is the kernel's cost, not the function's, and is not
    counted."""
    from cvo_rgbd_torch.ops.align_fused import OUT_LEN
    from cvo_rgbd_torch.ops.moments import NUM_MONO

    per_pair = pair_ops(True, fast)
    nops = (counts["pairs"] * per_pair + counts["gated"] * OPS_GATED
            + counts.get("self_pairs", 0) * per_pair
            + counts.get("self_gated", 0) * OPS_WSQ_GATED)
    n, m = x.capacity, y.capacity
    nbytes = ((n + m) * 9 + n * NUM_MONO + OUT_LEN) * 4 * lanes
    return bound(nbytes, nops)


def phase_fused_kernels(cases, fast=False):
    """The whole-align kernel against its plain version on the card after
    1, 3 and 10 iterations (eps = eps_2 = 0, so each align runs exactly
    max_iter iterations): R, T, ell, omega and v within 1e-5 after 1 and
    3 iterations and 1e-4 after 10.  Each 10-iteration align is timed
    against the plain version and its bound; the kernel line takes the
    first case of each mode, its max_abs_err the worst of every case of
    that mode.  A case is (mode, params, fixed, moving).  `fast`: the
    exp_mode="fast" form, whose launch must not give the precise launch's
    bits at any iteration count; the two forms timed in turns."""
    import torch

    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_cuda,
        align_fused_plain,
        fused_mode,
    )
    tag = "/fast" if fast else ""
    out = {}
    for mode, base, fixed, moving in cases:
        x, y = kd_sort(fixed), kd_sort(moving)
        label = (f"align_fused{tag} {mode} {type(base).__name__} "
                 f"color_mode={base.color_mode} N=M={x.capacity}")
        err = 0.0
        for it in FUSED_ITERS:
            forms = {f: dataclasses.replace(
                base, backend="fused", max_iter=it, eps=0.0, eps_2=0.0,
                exp_mode="fast" if f else "precise") for f in (True, False)}
            p = forms[fast]
            check(fused_mode(p, x, y) == mode, f"{label}: not {mode}")
            row = align_fused_cuda(p, x, y)
            counts = {}
            ref = align_fused_plain(p, x, y, counts=counts)
            e = (row - ref).abs()
            worst = max(e[12:24].max().item(), e[26:33].max().item())
            tol = 1e-5 if it <= 3 else 1e-4
            log(f"{label} iterations={it}: max |err| R {e[12:21].max():.2e} "
                f"T {e[21:24].max():.2e} ell {e[26]:.2e} omega "
                f"{e[27:30].max():.2e} v {e[30:33].max():.2e} (tolerance "
                f"{tol:g}); k {row[24].item():.0f} vs {ref[24].item():.0f}")
            check(worst <= tol, f"{label}: kernel and plain version disagree "
                  f"after {it} iterations: {worst}")
            check(row[24].item() == ref[24].item() == it,
                  f"{label}: iteration counts differ")
            if fast:
                check(not torch.equal(bits(row), bits(align_fused_cuda(
                    forms[False], x, y))), f"{label}: the fast launch gave "
                      f"the precise launch's bits after {it} iterations")
            err = max(err, worst)
        ms, ms_p = time_forms(lambda f: align_fused_cuda(forms[f], x, y),
                              fast, spin=ALIGN_SPIN_CYCLES)
        plain_ms = time_ms(lambda: align_fused_plain(p, x, y),
                           PLAIN_ALIGN_RUNS, PLAIN_ALIGN_WARMUP)
        b_ms, b_by = fused_bound(counts, x, y, fast=fast)
        log(f"{label} {FUSED_ITERS[-1]} iterations: {ms:.4f} ms"
            f"{forms_note(ms, ms_p)}, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}); pairs {counts['pairs']}, gated "
            f"{counts['gated']}, self pairs {counts.get('self_pairs', 0)}")
        name = f"align_fused_{mode}{tag}"
        if name not in out:
            out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by)
        else:
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    return out


def pcd_sets(frames, root, cam):
    """2b: the frames backprojected whole and written as .pcd files under
    `root`, loaded as the MATLAB batch runner loads them at BATCH_GRID and
    FINE_GRID.  Returns {grid: [(name, positions, colors)]}."""
    from cvo_rgbd_torch.batch import load_pcd_dir
    from cvo_rgbd_torch.core.cloud import round_up
    from cvo_rgbd_torch.io.export import depth_to_cloud, write_pcd

    t0 = time.perf_counter()
    for _, nm, rgb, dep, _ in frames:
        pos, col = depth_to_cloud(rgb, dep, cam)
        write_pcd(os.path.join(root, f"{nm}.pcd"), pos, col)
    log(f"wrote {len(frames)} .pcd files of {pos.shape[0]} points in "
        f"{time.perf_counter() - t0:.2f} s")
    sets = {}
    for grid in (BATCH_GRID, FINE_GRID):
        clouds = load_pcd_dir(root, grid=grid)
        cap = round_up(max(c[1].shape[0] for c in clouds))
        log(f"pcd grid={grid}: N per frame {[c[1].shape[0] for c in clouds]}"
            f", capacity {cap}")
        sets[grid] = clouds
    caps = {g: round_up(max(c[1].shape[0] for c in sets[g])) for g in sets}
    check(caps[BATCH_GRID] <= 1024 < caps[FINE_GRID] <= 4096,
          f"pcd capacities {caps}: want a resident and a tiled fused pair")
    return sets


def linear_pair(clouds, dev):
    """The first pcd pair as the batch gives it to the kernels: the whole
    set padded to one capacity (`run_batch`), kd-sorted on `dev`, its
    masked CI, and the features zero-padded to NFEAT (`align`)."""
    from cvo_rgbd_torch.batch import pad_clouds
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.core.registration import prepare_ci
    from cvo_rgbd_torch.ops.gram import pad_feat
    from cvo_rgbd_torch.params import MATLAB_PARAMS

    x, y = (kd_sort(c) for c in pad_clouds(clouds, dev)[:2])
    ci = prepare_ci(MATLAB_PARAMS, x, y)
    x, y = (c._replace(features=pad_feat(c.features)) for c in (x, y))
    return x, y, ci


def rel_close(got, ref, tol=1e-4):
    """|got - ref| / |ref| (the norm for a vector) and whether it is
    within tol."""
    rel = (got - ref).norm().item() / max(ref.norm().item(), 1e-30)
    return rel, rel <= tol


def flow_bound(n, m, nnz, use_ck, per_gated, column_ops=0, pairs=None,
               fast=False):
    """(bound ms, bound_by) of one sweep of csrc/fused_flow.cu over
    `pairs` pairs (every pair of the N x M sweep by default; the pairs of
    the kept tiles with the skip): each pair's weight (its color kernel
    when there is no cache) and its cache entry, the gated pairs' terms;
    each plane and the results moved once."""
    from cvo_rgbd_torch.ops.gram import NFEAT

    pairs = n * m if pairs is None else pairs
    nbytes = ((n + m) * (3 + NFEAT + 1) + 8 + 9 + 6) * 4
    nbytes += pairs * 4 if use_ck else 0
    nops = pairs * pair_ops(not use_ck, fast)
    return bound(nbytes, nops + nnz * per_gated + m * column_ops)


def bits(t):
    """The float32 tensor's bits, for exact comparisons (-0 != +0)."""
    import torch

    return t.contiguous().view(torch.int32)


def phase_flow(cases, fast=False):
    """3d: fused_flow and fused_step_coeffs against their plain versions:
    nnz exact, each other output (omega*c, v*d, sum A d2, sum A, and B,
    C, D, E) within 1e-4 of its magnitude; the tile skip on and off the
    same bits, and two runs the same bits.  A case is (label, params,
    fixed, moving, ck, ell, timed); the kernel line takes the last timed
    case, the main path's (the linear sweep of the finer pcd pair), its
    bound over the kept tiles' pairs (the all-pairs bound logged
    beside), and its max_abs_err the worst of every case.  `fast`: the
    exp_mode="fast" form (phase 3f of the module docstring)."""
    import torch

    from cvo_rgbd_torch.ops import flow, gram, moments

    tag = "/fast" if fast else ""
    out = {}
    err = err_s = 0.0
    for label, p, x, y, ck, ell, timed in cases:
        dev = x.positions.device
        linear = p.color_mode == "linear"
        scal = gram.scalars(torch.full((), ell, device=dev), p)
        args = (*x, *y, scal)
        runs = {skip: flow.fused_flow_cuda(*args, ck, linear, skip=skip,
                                           fast=fast)
                for skip in (True, False)}
        got = runs[True]
        again = flow.fused_flow_cuda(*args, ck, linear, fast=fast)
        ref = flow.fused_flow_plain(*args, ck, linear, fast=fast)
        wv = torch.cat([got[0:3] / p.c, got[3:6] / p.d])
        runs_s = {skip: flow.fused_step_coeffs_cuda(*args, wv, ck, linear,
                                                    skip=skip, fast=fast)
                  for skip in (True, False)}
        got_s = runs_s[True]
        again_s = flow.fused_step_coeffs_cuda(*args, wv, ck, linear,
                                              fast=fast)
        ref_s = flow.fused_step_coeffs_plain(*args, wv, ck, linear,
                                             fast=fast)
        # precise: nnz exact
        near = moments.near_gate_pairs(*args, ck, linear) if fast else 0
        torch.cuda.synchronize()
        nnz, ref_nnz = got[8].item(), ref[8].item()
        rels = {name: rel_close(got[sl], ref[sl]) for name, sl in (
            ("omega*c", slice(0, 3)), ("v*d", slice(3, 6)),
            ("wsq", slice(6, 7)), ("sum_A", slice(7, 8)))}
        rels.update({name: rel_close(got_s[q], ref_s[q])
                     for q, name in enumerate("BCDE")})
        n, m = x.capacity, y.capacity
        keep = flow.tile_keep(x.positions, x.mask, y.positions, y.mask, scal)
        kept = int(keep.sum().item())
        log(f"fused_flow/fused_step_coeffs{tag} {label} N={n} M={m} ell="
            f"{ell}: nnz {nnz:.0f} vs {ref_nnz:.0f} ("
            + (f"near-gate pairs {near}, the tolerance" if fast else "exact")
            + "), relative errors "
            + ", ".join(f"{k} {v[0]:.2e}" for k, v in rels.items())
            + " (tolerance 1e-4 of each output's magnitude); tiles kept "
            f"{kept}/{keep.numel()} ({kept / keep.numel():.4f})")
        check(abs(nnz - ref_nnz) <= near and nnz > 0,
              f"fused_flow{tag} {label}: nnz differs")
        check(all(ok for _, ok in rels.values()),
              f"fused_flow/fused_step_coeffs{tag} {label} disagree: {rels}")
        check(torch.equal(bits(runs[True]), bits(runs[False]))
              and torch.equal(bits(runs_s[True]), bits(runs_s[False])),
              f"fused_flow/fused_step_coeffs{tag} {label}: tile skip on and "
              f"off differ: {runs} {runs_s}")
        check(torch.equal(bits(got), bits(again))
              and torch.equal(bits(got_s), bits(again_s)),
              f"fused_flow/fused_step_coeffs{tag} {label}: two runs differ")
        err = max(err, (got[:8] - ref[:8]).abs().max().item())
        err_s = max(err_s, (got_s - ref_s).abs().max().item())
        if not timed:
            continue
        ms, ms_p = time_forms(
            lambda f: flow.fused_flow_cuda(*args, ck, linear, fast=f), fast)
        plain_ms = time_ms(lambda: flow.fused_flow_plain(*args, ck, linear,
                                                         fast=fast))
        ms_s, ms_sp = time_forms(lambda f: flow.fused_step_coeffs_cuda(
            *args, wv, ck, linear, fast=f), fast)
        plain_s = time_ms(lambda: flow.fused_step_coeffs_plain(
            *args, wv, ck, linear, fast=fast))
        use_ck = ck is not None
        pairs = kept * flow.ROWS * flow.TILE_J
        b = flow_bound(n, m, nnz, use_ck, OPS_FLOW_GATED, pairs=pairs,
                       fast=fast)
        b_s = flow_bound(n, m, nnz, use_ck, OPS_STEP_GATED, OPS_STEP_COLUMN,
                         pairs=pairs, fast=fast)
        b_all = flow_bound(n, m, nnz, use_ck, OPS_FLOW_GATED, fast=fast)
        b_all_s = flow_bound(n, m, nnz, use_ck, OPS_STEP_GATED,
                             OPS_STEP_COLUMN, fast=fast)
        log(f"fused_flow{tag} {label} ell={ell}: {ms:.4f} ms"
            f"{forms_note(ms, ms_p)}, plain {plain_ms:.4f} ms, bound "
            f"{b[0]:.4f} ms ({b[1]}; all pairs {b_all[0]:.4f}, {b_all[1]}); "
            f"fused_step_coeffs{tag}: {ms_s:.4f} ms{forms_note(ms_s, ms_sp)}"
            f", plain {plain_s:.4f} ms, bound {b_s[0]:.4f} ms ({b_s[1]}; all"
            f" pairs {b_all_s[0]:.4f}, {b_all_s[1]})")
        out["fused_flow" + tag] = dict(ms=ms, plain_ms=plain_ms,
                                       bound_ms=b[0], bound_by=b[1])
        out["fused_step_coeffs" + tag] = dict(ms=ms_s, plain_ms=plain_s,
                                              bound_ms=b_s[0],
                                              bound_by=b_s[1])
    for name, e in (("fused_flow", err), ("fused_step_coeffs", err_s)):
        if name + tag in out:
            out[name + tag]["max_abs_err"] = e
    return out


def phase_linear_moments(x, y, ci, fast=False):
    """3e: the linear branch of fused_moments against its plain version
    on a pcd pair: Mom within 1e-4 of each column, nnz exact, tile skip
    on and off the same bits.  `fast`: the exp_mode="fast" form (phase
    3f of the module docstring), timed in turns with the precise form."""
    import torch

    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import gram, moments
    from cvo_rgbd_torch.params import MATLAB_PARAMS

    tag = "/fast" if fast else ""
    dev = x.positions.device
    c0, xc, phi = build_moments_pre(x)
    yc = y.positions - c0
    md = aabb_min_d2(*block_bounds(x.positions, x.mask, moments.TILE_I),
                     *block_bounds(y.positions, y.mask, moments.TILE_J))
    for ell in (0.1, 0.03):
        scal = gram.scalars(torch.full((), ell, device=dev), MATLAB_PARAMS)
        cloud = (xc, x.features, x.mask, yc, y.features, y.mask)
        args = (*cloud, phi, scal, ci)
        ref, ref_nnz = moments.fused_moments_plain(*args, None, True,
                                                   fast=fast)
        # precise: nnz exact
        near = moments.near_gate_pairs(*cloud, scal, ci, True) if fast else 0
        got = [moments.fused_moments_cuda(*args, skip, True, fast=fast)
               for skip in (None, md)]
        torch.cuda.synchronize()
        colmax = ref.abs().amax(dim=0).clamp_min(1e-30)
        rel = max(((mom - ref).abs() / colmax).max().item()
                  for mom, _ in got)
        nnz = [n.item() for _, n in got]
        ms, ms_p = time_forms(lambda f: moments.fused_moments_cuda(
            *args, md, True, fast=f), fast)
        log(f"fused_moments{tag} linear N={x.capacity} ell={ell}: Mom "
            f"err/max|col|={rel:.3e} (tolerance 1e-4), nnz {nnz} vs "
            f"{ref_nnz.item():.0f} ("
            + (f"near-gate pairs {near}, the tolerance" if fast else "exact")
            + f"); {ms:.4f} ms with the skip{forms_note(ms, ms_p)}")
        check(rel <= 1e-4, f"linear fused_moments{tag} Mom disagrees: {rel}")
        check(all(abs(v - ref_nnz.item()) <= near for v in nnz),
              f"linear fused_moments{tag} nnz differs")
        check(torch.equal(got[0][0], got[1][0]),
              f"linear fused_moments{tag}: tile skip on and off differ")


def relative_gt(frames):
    """The exact relative poses inv(P[i-1]) P[i] of the rendered frames:
    each maps frame i's points into frame i-1, as a batch result does."""
    import numpy as np

    poses = [np.asarray(f[4], dtype=np.float64) for f in frames]
    return [np.linalg.inv(a) @ b for a, b in zip(poses, poses[1:])]


def phase_batch(root, grid, label, gt, params=None):
    """6: one MATLAB batch run over the pcd files, through `cli batch`
    (params None: MATLAB_PARAMS on the kernel backend) or `run_batch`,
    with every launch count set to 0 just before and read just after.
    Every pair must be finite and converged; the translation error
    against the exact relative ground truth must beat identity's."""
    import numpy as np
    import torch

    from cvo_rgbd_torch import cli
    from cvo_rgbd_torch.batch import run_batch

    out = os.path.join(root, f"batch_{label}_{grid}.npz")
    lines = []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    if params is None:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["batch", root, "--grid", str(grid), "--output", out])
        lines = buf.getvalue().splitlines()
    else:
        run_batch(root, params=params, grid=grid, output=out,
                  log=lines.append)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    res = np.load(out)["results"]
    pairs = [ln for ln in lines if ln.startswith("pair ")]
    iters = [int(ln.split("iters=")[1].split()[0]) for ln in pairs
             if "iters=" in ln]
    err = [float(np.linalg.norm(r[:3, 3] - g[:3, 3]))
           for r, g in zip(res[1:], gt)]
    motion = [float(np.linalg.norm(g[:3, 3])) for g in gt]
    log(f"batch {label} grid={grid}: {len(pairs)} pairs, "
        f"{len(pairs) / dt:.3f} pairs/s ({dt:.3f} s with loading), "
        f"iterations {iters}, translation error against the exact relative "
        f"ground truth mean {np.mean(err):.5f} m max {np.max(err):.5f} m "
        f"(identity: mean {np.mean(motion):.5f} m), launches {launches}")
    check(len(iters) == len(pairs) == len(gt) and np.isfinite(res).all()
          and not any("not converged" in ln for ln in pairs),
          f"batch {label}: a pair failed or did not converge: {pairs}")
    check(np.mean(err) < np.mean(motion),
          f"batch {label}: no better than identity")
    return launches


def phase_matlab(root, frames):
    """6: the MATLAB path at both grids on the three routes, then one small
    linear pair card vs CPU, then `cli stitch`.  Returns the launches."""
    import torch

    from cvo_rgbd_torch import align, cli
    from cvo_rgbd_torch.batch import load_pcd_dir, pad_clouds
    from cvo_rgbd_torch.params import MATLAB_PARAMS

    gt = relative_gt(frames)
    n = len(gt)
    total = {k: 0 for k in KERNELS + FUSED + (PROBE,)}
    routes = (
        ("kernel", None),
        ("fused", dataclasses.replace(MATLAB_PARAMS, backend="fused")),
        ("direct", dataclasses.replace(MATLAB_PARAMS, step_mode="direct")),
    )
    for grid in (BATCH_GRID, FINE_GRID):
        for label, params in routes:
            # the capacity picks the fused kernel's mode for every pair
            got = fused_by_mode(phase_batch(root, grid, label, gt, params),
                                "tiled" if grid == FINE_GRID else "resident")
            if label == "kernel":
                check(got["fused_moments"] > 0 and got["color_gram"] == 0
                      and not any(got[k] for k in FUSED), f"cli batch "
                      f"launched {got}")
            elif label == "fused":
                check(sum(got[k] for k in FUSED) == n
                      and not any(got[k] for k in KERNELS),
                      f"fused batch: align_fused not once a pair: {got}")
            else:
                check(got["fused_flow"] > 0
                      and got["fused_flow"] == got["fused_step_coeffs"]
                      and got["fused_moments"] == got["color_gram"] == 0,
                      f"direct batch launched {got}")
            for k, v in got.items():
                total[k] += v

    # one small linear pair on the card and on the CPU (plain versions)
    clouds = load_pcd_dir(root, grid=BATCH_GRID)[:2]
    x, y = pad_clouds(clouds, torch.device("cuda"))
    for label, params in routes:
        p = params or MATLAB_PARAMS
        gpu = align(p, x, y)
        cpu = align(p, x.to("cpu"), y.to("cpu"), device="cpu")
        dtf = (gpu.tf.cpu() - cpu.tf).abs().max().item()
        it_g, it_c = int(gpu.iterations.item()), int(cpu.iterations.item())
        log(f"MATLAB align {label} N=M={x.capacity} card vs CPU: dtf="
            f"{dtf:.3e} (tolerance 3e-4), iterations {it_g} vs {it_c}")
        check(dtf <= 3e-4 and bool(gpu.converged.item())
              and bool(cpu.converged.item()),
              f"MATLAB align {label}: card and CPU disagree")

    ply = os.path.join(root, "scene.ply")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["stitch", root, "--output", ply])
    with open(ply) as f:
        head = f.read().split("end_header")[0]
    n_pts = int(head.split("element vertex ")[1].split()[0])
    log(f"cli stitch: {buf.getvalue().strip()}; the PLY holds {n_pts} points")
    check(n_pts > 0, "cli stitch wrote an empty PLY")
    return total


def fused_by_mode(launches, mode):
    """The counts with align_fused's under align_fused_<mode>."""
    n_fused = launches.pop("align_fused")
    launches.update({k: 0 for k in FUSED})
    launches[f"align_fused_{mode}"] = n_fused
    return launches


def reset_launches():
    from cvo_rgbd_torch import ops, probes

    for name in KERNELS + ("align_fused",):
        getattr(ops, name).launches = 0
    probes.construct_probe.launches = 0


def read_launches():
    from cvo_rgbd_torch import ops, probes

    out = {name: getattr(ops, name).launches
           for name in KERNELS + ("align_fused",)}
    out["construct_probe"] = probes.construct_probe.launches
    return out


def phase_align(fixed, moving, p, small=None, skew=0.1):
    """A reference-scale align on the kernels, then (given a small pair)
    the small pair on the card and on the CPU (plain versions), which
    must agree: tf within 3e-4 and stopping iterations within `skew` of
    each other.  Returns the reference-scale align's host ms/iteration."""
    import torch

    from cvo_rgbd_torch import align

    fused = p.backend == "fused"
    name = type(p).__name__ + (
        f"(self_mode={p.self_mode!r})"
        if hasattr(p, "self_mode") and not fused else "") + (
        f" backend={p.backend}")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = align(p, fixed, moving)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    it = int(res.iterations.item())
    conv = bool(res.converged.item())
    ms_iter = dt * 1e3 / max(it + 1, 1)
    log(f"align {name} N=M={fixed.capacity}: iterations={it} "
        f"converged={conv} final ell={res.ell.item():.6f} "
        f"{ms_iter:.3f} ms/iteration, launches {launches}")
    check(conv, "reference-scale align did not converge")
    check(torch.isfinite(res.tf).all().item(), "non-finite tf")
    if fused:
        # one launch of the tiled kernel and nothing of the kernel backend
        from cvo_rgbd_torch.ops.align_fused import fused_mode

        check(fused_mode(p, fixed, moving) == "tiled"
              and launches["align_fused"] == 1
              and not any(launches[k] for k in KERNELS),
              f"fused align launches {launches}")
        again = align(p, fixed, moving)
        check(int(again.iterations.item()) == it
              and torch.equal(again.tf, res.tf),
              "the same fused align did not repeat bit for bit")
    else:
        used = ("color_gram", "fused_moments") + (
            ("fused_wsq",) if hasattr(p, "self_mode") else ())
        check(all(launches[k] > 0 for k in used),
              "align did not launch its kernels")
        if getattr(p, "self_mode", None) == "cheb":
            # the tables' 2K sweeps are the align's only fused_wsq launch
            log(f"align {name}: cheb table launches {launches['fused_wsq']}")
            check(launches["fused_wsq"] == 1,
                  "the Chebyshev tables took more than one launch")
    if small is None:
        return ms_iter

    fx, mv = small
    gpu = align(p, fx, mv)
    cpu = align(p, fx.to("cpu"), mv.to("cpu"), device="cpu")
    dtf = (gpu.tf.cpu() - cpu.tf).abs().max().item()
    it_g, it_c = int(gpu.iterations.item()), int(cpu.iterations.item())
    log(f"align {name} N=M={fx.capacity} card vs CPU: dtf={dtf:.3e} "
        f"(tolerance 3e-4), iterations {it_g} vs {it_c}, ell "
        f"{gpu.ell.item():.6f} vs {cpu.ell.item():.6f}")
    # the stop-skew tolerance of the JAX suite; at the C++ stops the last
    # iterations contract slowly, so the kernel's fp32 sums (FMAs, chunked
    # order) move the stopping iteration by a few percent
    check(dtf <= 3e-4 and bool(gpu.converged.item())
          and bool(cpu.converged.item())
          and abs(it_g - it_c) <= max(2, skew * it_c),
          "card and CPU align disagree")
    return ms_iter


def phase_profile(fixed, moving, p, n_iter=5):
    """Where an align iteration's time goes: host time, device time and
    kernel launches per iteration, from torch.profiler, at the smallest
    length-scale of the run (cvo's last scheduled ell, acvo's floor)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cvo_rgbd_torch.core import registration as reg
    from cvo_rgbd_torch.core.cloud import kd_sort

    fixed, moving = kd_sort(fixed), kd_sort(moving)
    dev = fixed.positions.device
    adaptive = hasattr(p, "self_mode")
    ell = p.ell_min if adaptive else p.ell_sched[-1][1]
    state = reg.init_state(p, dev, ell0=ell)
    body = reg.make_align_step(p)
    pre = reg.prepare(p, fixed, moving)
    body(state, fixed, moving, pre)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_iter):
            body(state, fixed, moving, pre)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n_iter
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    # device-side events only (kernels, copies): each is counted once
    gpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    check(gpu, "the profiler recorded no device activity")
    dev_us = sum(e.time_range.elapsed_us() for e in gpu) / n_iter

    def kernel_ms(tag):
        return sum(e.time_range.elapsed_us() for e in gpu
                   if tag in e.name) / n_iter / 1e3

    if p.step_mode == "direct":
        # each sweep one launch an iteration, its reduction folded in
        per_iter = {tag: sum(tag in e.name for e in gpu) / n_iter
                    for tag in ("flow_kernel", "step_kernel")}
        check(per_iter == {"flow_kernel": 1, "step_kernel": 1},
              f"direct step: sweep launches per iteration {per_iter}")
    wsq_launches = sum("wsq_kernel" in e.name for e in gpu) / n_iter
    if adaptive:
        # both exact self-sweeps in one launch, the reduction folded in
        check(wsq_launches == 1,
              f"acvo: fused_wsq launches per iteration {wsq_launches}")

    log(f"profile {type(p).__name__} step_mode={p.step_mode} "
        f"N=M={fixed.capacity} ell={ell}: {host_ms:.3f} ms/iteration on the "
        f"host clock, device busy {dev_us / 1e3:.3f} ms/iteration "
        f"({dev_us / 10 / host_ms:.1f}%), of which fused_moments "
        f"{kernel_ms('moments_'):.3f} ms, fused_wsq {kernel_ms('wsq_'):.3f} "
        f"ms, fused_flow {kernel_ms('flow_kernel'):.3f} ms, "
        f"fused_step_coeffs {kernel_ms('step_kernel'):.3f} ms; "
        f"{launches / n_iter:.0f} kernel launches per iteration "
        f"({wsq_launches:.0f} of fused_wsq)")


def phase_fused_timing(fixed, moving, p, kernel_ms_iter):
    """The fused backend's ms/iteration by slope (eps = eps_2 = 0, 10
    against 60 iterations, CUDA events around the launch), next to the
    kernel backend's host ms/iteration; then one whole align (kd-sort
    and precompute included) on CUDA events and under torch.profiler:
    launches per align and the device's busy share."""
    from cvo_rgbd_torch import align
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.ops.align_fused import align_fused_cuda

    x, y = kd_sort(fixed), kd_sort(moving)
    t = {}
    for it in (10, 60):
        q = dataclasses.replace(p, max_iter=it, eps=0.0, eps_2=0.0)
        t[it] = time_ms(lambda: align_fused_cuda(q, x, y),
                        spin=ALIGN_SPIN_CYCLES)
    slope = (t[60] - t[10]) / 50
    whole_ms = time_ms(lambda: align(p, fixed, moving))
    res = []
    host_ms, dev_ms, launches, kern_ms = profile_share(
        lambda: res.append(align(p, fixed, moving)), "align_kernel")
    its = int(res[-1].iterations.item()) + 1
    log(f"fused {type(p).__name__} N=M={fixed.capacity}: {t[10]:.4f} ms at "
        f"10 iterations, {t[60]:.4f} ms at 60, slope {slope:.4f} "
        f"ms/iteration (kernel backend: {kernel_ms_iter:.3f} ms/iteration, "
        f"host clock); whole align {whole_ms:.4f} ms on CUDA events, "
        f"{its} iterations; profiled: {host_ms:.3f} ms host, device busy "
        f"{dev_ms:.3f} ms ({100 * dev_ms / host_ms:.1f}%), of which "
        f"align_fused {kern_ms:.3f} ms; {launches} kernel launches per "
        "align")
    check(slope > 0, "fused ms/iteration by slope is not positive")


def phase_odometry(frames, p, adaptive, num_want=NUM_WANT):
    """A main path, with the launch counts read around it.  Returns
    (launches by kernel line row, the run: its trajectory text, ATE and
    frames/s)."""
    import numpy as np
    import torch

    from cvo_rgbd_torch.evaluation import ate_rmse
    from cvo_rgbd_torch.io.tum import parse_trajectory
    from cvo_rgbd_torch.odometry import run_odometry_frames

    direct = p.step_mode == "direct"
    name = ("acvo" if adaptive else "cvo") + (
        f" fused num_want={num_want}" if p.backend == "fused" else "") + (
        " step_mode=direct" if direct else "")
    traj = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    recs = run_odometry_frames(
        ((i, nm, rgb, dep) for i, nm, rgb, dep, _ in frames), 1,
        adaptive=adaptive, params=p, traj=traj, num_want=num_want,
        log=lambda *a: None,
    )
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    est = parse_trajectory(traj.getvalue().splitlines())
    gt = {float(nm): pose for _, nm, _, _, pose in frames}
    ate = ate_rmse(gt, est)["rmse"]
    failed = sum(r.failed for r in recs)
    iters = [r.iterations for r in recs]
    log(f"odometry {name}: {len(recs)} pairs, {failed} failed, "
        f"{len(recs) / dt:.3f} frames/s, iterations {iters}, "
        f"all converged {all(r.converged for r in recs)}, ATE {ate:.5f} m, "
        f"launches {launches}")
    check(len(recs) == len(frames) - 1 and failed == 0,
          f"{name} odometry pairs failed")
    check(all(r.converged for r in recs), f"{name} odometry: a pair did "
          "not converge")
    check(all(np.isfinite(m).all() for m in est.values()), "non-finite pose")
    check(ate < 0.02, f"{name} odometry ATE {ate} m against the exact "
          "ground truth")
    run = {"traj": traj.getvalue(), "ate": ate, "fps": len(recs) / dt}
    # the capacity picks the fused kernel's mode for every pair of a run
    mode = "tiled" if num_want > RESIDENT_NUM_WANT else "resident"
    launches = fused_by_mode(launches, mode)
    n_fused = launches[f"align_fused_{mode}"]
    if p.backend == "fused":
        # one whole-align launch a pair and no per-iteration kernel: no
        # silent fallback
        check(n_fused == len(recs),
              f"the {name} main path did not launch align_fused {mode} "
              f"once a pair: {launches}")
        check(not any(launches[k] for k in KERNELS),
              f"the {name} main path launched another kernel: {launches}")
        return launches, run
    # the direct step's two sweeps take the place of the moment sweep
    step = ("fused_flow", "fused_step_coeffs") if direct else (
        "fused_moments",)
    used = ("color_gram",) + step + (("fused_wsq",) if adaptive else ())
    for k in used:
        check(launches[k] > 0, f"the {name} main path never launched {k}")
    check(not any(launches[k] for k in KERNELS if k not in used),
          f"the {name} main path launched another kernel: {launches}")
    check(n_fused == 0, f"the {name} main path launched align_fused")
    return launches, run


def phase_probes():
    """7: the probes' entry point as a user runs it, with the launch
    counts read around it; then each toy case against its plain version
    and its closed form, timed, and the tiled aligns against the plain
    version.  Returns (the probe kernel's row, the entry point's
    launches)."""
    import torch

    from cvo_rgbd_torch import probes
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_cuda,
        align_fused_plain,
    )

    dev = torch.device("cuda")
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = probes.main([])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    lines = buf.getvalue().splitlines()
    recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
    log(f"python -m cvo_rgbd_torch.probes: rc {rc}, {dt:.3f} s, "
        + " ".join(f"{r['case']}={r['val']:g}" for r in recs)
        + f"; launches {launches}")
    check(rc == 0 and lines[-1] == "DONE" and all(r["ok"] for r in recs)
          and len(recs) == len(probes.CASES) + len(probes.ALIGNS),
          f"the probes' entry point failed: {lines}")
    check(launches[PROBE] == len(probes.CASES)
          and launches["align_fused"] == len(probes.ALIGNS)
          and not any(launches[k] for k in KERNELS),
          f"the probes launched {launches}")

    err = ms_sum = plain_sum = bound_sum = 0.0
    by = {"bytes": 0.0, "operations": 0.0}
    for case in probes.CASES:
        ins = probes.inputs(case, dev)
        got = probes.construct_probe_cuda(case, *ins)
        ref = probes.construct_probe_plain(case, *ins)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        val = got[0, 0].item()
        if case == "e":
            # fp32 sums of 256 products in another order: 1e-6 relative
            check(e <= 1e-6 * probes.CLOSED["e"],
                  f"probe e: kernel and plain version differ by {e}")
        else:
            check(torch.equal(got, ref), f"probe {case}: kernel and plain "
                  f"version differ by {e}")
        check(probes.closed_form_ok(case, val),
              f"probe {case}: {val}, closed form {probes.CLOSED[case]}")
        ms = time_ms(lambda: probes.construct_probe_cuda(case, *ins))
        plain_ms = time_ms(lambda: probes.construct_probe_plain(case, *ins))
        nbytes = (sum(ins[i][s].numel() for i, s in PROBE_READS[case])
                  + got.numel()) * 4
        b_ms, b_by = bound(nbytes, PROBE_OPS.get(case, 2 * got.numel()))
        log(f"probe {case}: {val!r} (closed form {probes.CLOSED[case]!r}), "
            f"max |kernel - plain| {e:.3e}; {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        err = max(err, e)
        ms_sum, plain_sum, bound_sum = (ms_sum + ms, plain_sum + plain_ms,
                                        bound_sum + b_ms)
        by[b_by] += b_ms
    for case in probes.ALIGNS:
        p, x, y = probes.tiled_problem(case, dev)
        row = align_fused_cuda(p, x, y, mode="tiled")
        ref = align_fused_plain(p, x, y, mode="tiled")
        dtf = (row[:12] - ref[:12]).abs().max().item()
        ms = time_ms(lambda: align_fused_cuda(p, x, y, mode="tiled"),
                     spin=ALIGN_SPIN_CYCLES)
        log(f"probe {case} tiled N={x.capacity} M={y.capacity}: iterations "
            f"{row[24].item() - 1:.0f} vs {ref[24].item() - 1:.0f}, max |dtf| "
            f"{dtf:.3e} (tolerance 1e-5); {ms:.4f} ms")
        check(row[24].item() == ref[24].item(),
              f"probe {case}: iteration counts differ")
        check(dtf <= 1e-5, f"probe {case}: tf differs by {dtf}")
    log(f"construct_probe, the ten cases together: {ms_sum:.4f} ms, plain "
        f"{plain_sum:.4f} ms, bound {bound_sum:.6f} ms")
    row = dict(max_abs_err=err, ms=ms_sum, plain_ms=plain_sum,
               bound_ms=bound_sum, bound_by=max(by, key=by.get))
    return row, launches


def profile_share(fn, kernel=None):
    """(host ms, device busy ms, launches) of one fn() under
    torch.profiler, after one untimed call; given `kernel`, also the
    device ms of the kernels whose name holds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    launches = sum(e.count for e in prof.key_averages()
                   if e.key.startswith("cudaLaunch"))
    gpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    check(gpu, "the profiler recorded no device activity")
    dev_ms = sum(e.time_range.elapsed_us() for e in gpu) / 1e3
    if kernel is None:
        return host_ms, dev_ms, launches
    kern_ms = sum(e.time_range.elapsed_us() for e in gpu
                  if kernel in e.name) / 1e3
    return host_ms, dev_ms, launches, kern_ms


def phase_batched_fused(sets, fast=False):
    """8: the 9 pcd pairs at each grid, stacked LANE_REPEAT times, on the
    fused backend through align_batched.  Returns (the batched rows of the
    kernel line, launches by row).  `fast`: exp_mode="fast", its launch
    timed in turns with the precise one (rows named "<row>/fast")."""
    import torch

    from cvo_rgbd_torch import align
    from cvo_rgbd_torch.batch import pad_clouds
    from cvo_rgbd_torch.core.cloud import kd_sort, stack_clouds
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_batched_cuda,
        align_fused_plain,
        fused_mode,
    )
    from cvo_rgbd_torch.ops.gram import pad_feat
    from cvo_rgbd_torch.parallel import align_batched
    from cvo_rgbd_torch.params import MATLAB_PARAMS

    dev = torch.device("cuda")
    p = dataclasses.replace(MATLAB_PARAMS, backend="fused",
                            exp_mode="fast" if fast else "precise")
    tag = "/fast" if fast else ""
    rows, launches = {}, {k: 0 for k in BATCHED}
    for grid in (BATCH_GRID, FINE_GRID):
        padded = pad_clouds(sets[grid], dev)
        n_pairs = len(padded) - 1
        fixed = stack_clouds(padded[:-1], repeat=LANE_REPEAT)
        moving = stack_clouds(padded[1:], repeat=LANE_REPEAT)
        lanes = fixed.positions.shape[0]
        mode = fused_mode(p, fixed, moving)
        label = (f"batched fused{tag} {mode} grid={grid} "
                 f"N={fixed.capacity}")
        torch.cuda.synchronize()
        reset_launches()
        res = align_batched(p, fixed, moving)
        torch.cuda.synchronize()
        got = read_launches()
        check(got["align_fused"] == 1
              and not any(got[k] for k in KERNELS + (PROBE,)),
              f"{label}: not one align_fused launch a batch: {got}")
        launches[f"align_fused_{mode}_batched"] += 1
        singles = [align(p, padded[i], padded[i + 1]) for i in range(n_pairs)]
        same = [all(torch.equal(getattr(res, f)[k], getattr(
            singles[k % n_pairs], f)) for f in res._fields)
            for k in range(lanes)]
        its = res.iterations.tolist()
        log(f"{label}: {lanes} lanes, one launch, iterations {its[:n_pairs]}"
            f" (x{LANE_REPEAT}); lanes bit-identical to align on their pair "
            f"alone: {sum(same)}/{lanes}")
        check(all(same), f"{label}: lanes differ from their single-pair "
              f"align: {[k for k, v in enumerate(same) if not v]}")
        check(bool(res.converged.all()) and bool(torch.isfinite(res.tf).all()),
              f"{label}: a lane did not converge")

        def batched():
            align_batched(p, fixed, moving)
            torch.cuda.synchronize()

        def sequential():
            for k in range(lanes):
                i = k % n_pairs
                align(p, padded[i], padded[i + 1])
            torch.cuda.synchronize()

        # in turns: sequential, batched, batched, sequential
        t = {"sequential": [], "batched": []}
        for name in ("sequential", "batched", "batched", "sequential"):
            t0 = time.perf_counter()
            {"sequential": sequential, "batched": batched}[name]()
            t[name].append(time.perf_counter() - t0)
        pps = {k: lanes / min(v) for k, v in t.items()}
        host_ms, dev_ms, n_launch = profile_share(batched)
        log(f"{label}: {pps['batched']:.3f} pairs/s batched against "
            f"{pps['sequential']:.3f} one align at a time (host clock, best "
            f"of 2, {pps['batched'] / pps['sequential']:.2f}x); profiled "
            f"batch {host_ms:.3f} ms host, device busy {dev_ms:.3f} ms "
            f"({100 * dev_ms / host_ms:.1f}%), {n_launch} kernel launches a "
            f"batch ({n_launch / lanes:.2f} a pair)")

        # the batched launch against the plain version lane by lane; the
        # 10-iteration launch timed, with its bound.  The lanes repeat the
        # 9 pairs (and repeat their bits, checked above), so the errors and
        # the pair counts come from the first 9 lanes.  Absolute errors,
        # the tolerances of phase 3c:
        # - 1 iteration from the same start: every output within 1e-5;
        # - 10 iterations: the state R, T, ell within 1e-4 of the plain
        #   version's own 10 iterations; omega and v there are the flow
        #   at a state that already differs (the linear sums cancel: 1e-5
        #   in T moved omega 1.75e-4 on one lane in an earlier run), so
        #   they are logged, and the 10th iteration is held instead as
        #   one step of the plain version from the kernel's own state
        #   after 9 (R, T, ell of a 9-iteration launch): omega, v, tf, R
        #   and T within 1e-5.
        xs, ys = (kd_sort(c._replace(features=pad_feat(c.features)))
                  for c in (fixed, moving))

        def run(it):
            return dataclasses.replace(p, max_iter=it, eps=0.0, eps_2=0.0)

        def errors(out, ref, fields):
            e = (out[:n_pairs] - ref).abs()
            cols = {"tf": slice(0, 12), "R": slice(12, 21),
                    "T": slice(21, 24), "ell": slice(26, 27),
                    "omega": slice(27, 30), "v": slice(30, 33)}
            return {f: e[:, cols[f]].max().item() for f in fields}

        def held(what, errs, gated, tol):
            log(f"{label} {what}: max |err| " + ", ".join(
                f"{k} {v:.2e}" for k, v in errs.items())
                + f" (tolerance {tol:g} on {', '.join(gated)})")
            check(max(errs[k] for k in gated) <= tol,
                  f"{label}: batched kernel and plain version differ, "
                  f"{what}: {errs}")
            return max(errs[k] for k in gated)

        flow = ["R", "T", "ell", "omega", "v"]
        out1 = align_fused_batched_cuda(run(1), xs, ys)
        ref1 = torch.stack([align_fused_plain(run(1), xs.lane(k), ys.lane(k))
                            for k in range(n_pairs)])
        err = held("1 iteration, kernel against the plain version lane by "
                   "lane", errors(out1, ref1, flow), flow, 1e-5)
        out9 = align_fused_batched_cuda(run(9), xs, ys)
        out10 = align_fused_batched_cuda(run(10), xs, ys)
        counts = {}
        ref10 = torch.stack([align_fused_plain(run(10), xs.lane(k),
                                               ys.lane(k), counts=counts)
                             for k in range(n_pairs)])
        err = max(err, held(
            "10 iterations, kernel against the plain version lane by lane "
            f"(omega, v magnitudes up to {ref10[:, 27:33].abs().max():.3e})",
            errors(out10, ref10, flow), ["R", "T", "ell"], 1e-4))
        step = torch.stack([align_fused_plain(
            run(1), xs.lane(k), ys.lane(k), R0=out9[k, 12:21].reshape(3, 3),
            T0=out9[k, 21:24], ell0=out9[k, 26]) for k in range(n_pairs)])
        err = max(err, held(
            "10th iteration, kernel against one plain step from the "
            "kernel's state after 9", errors(out10, step,
                                             ["tf", "R", "T", "omega", "v"]),
            ["tf", "R", "T", "omega", "v"], 1e-5))
        check(bool((out1[:, 24] == 1).all() & (out9[:, 24] == 9).all()
                   & (out10[:, 24] == 10).all()),
              f"{label}: the batched launch ran the wrong iteration count")
        q = run(10)
        counts = {k: v * LANE_REPEAT for k, v in counts.items()}
        forms = {f: dataclasses.replace(q, exp_mode="fast" if f else
                                        "precise") for f in (True, False)}
        ms, ms_p = time_forms(
            lambda f: align_fused_batched_cuda(forms[f], xs, ys), fast,
            spin=ALIGN_SPIN_CYCLES)
        t0 = time.perf_counter()
        for k in range(lanes):
            align_fused_plain(q, xs.lane(k), ys.lane(k))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        b_ms, b_by = fused_bound(counts, padded[0], padded[1], lanes,
                                 fast=fast)
        log(f"{label} 10 iterations: {ms:.4f} ms for {lanes} lanes "
            f"({ms / lanes:.4f} ms a lane){forms_note(ms, ms_p)}, plain "
            f"{plain_ms:.1f} ms (lane by lane, one run), bound {b_ms:.4f} "
            f"ms ({b_by})")
        rows[f"align_fused_{mode}_batched{tag}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by)
    return rows, launches


def phase_batched_odometry(frames, p, adaptive, root=None):
    """8b: run_odometry_batched over the render against
    run_odometry_frames(warm_start=False) in the same run; on the fused
    backend one launch a batch.  Given `root`, the render as a TUM folder
    and a 2-frame prefix of it also run through run_multiseq (ragged
    lanes), each lane against its solo cold run.  Returns the launches
    of the batched runs, by kernel."""
    import numpy as np
    import torch

    from cvo_rgbd_torch.evaluation import ate_rmse
    from cvo_rgbd_torch.io.tum import parse_trajectory, read_trajectory
    from cvo_rgbd_torch.multiseq import run_multiseq
    from cvo_rgbd_torch.odometry import (
        run_odometry_batched_frames,
        run_odometry_frames,
    )

    fused = p.backend == "fused"
    name = ("acvo" if adaptive else "cvo") + f" {p.backend}"
    gt = {float(nm): pose for _, nm, _, _, pose in frames}

    def drive(fn, **kw):
        traj = io.StringIO()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        recs = fn(((i, nm, rgb, dep) for i, nm, rgb, dep, _ in frames), 1,
                  adaptive=adaptive, params=p, traj=traj,
                  num_want=NUM_WANT, log=lambda *a: None, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        est = parse_trajectory(traj.getvalue().splitlines())
        return recs, est, dt, read_launches()

    recs, est, dt, launches = drive(run_odometry_batched_frames,
                                    batch=ODOM_BATCH)
    seq_recs, seq_est, seq_dt, _ = drive(run_odometry_frames,
                                         warm_start=False)
    ate, ate_seq = ate_rmse(gt, est)["rmse"], ate_rmse(gt, seq_est)["rmse"]
    n = len(recs)
    log(f"batched odometry {name} batch={ODOM_BATCH}: {n} pairs, "
        f"{sum(r.converged for r in recs)}/{n} converged, {n / dt:.3f} "
        f"frames/s (sequential cold {len(seq_recs) / seq_dt:.3f}), "
        f"iterations {[r.iterations for r in recs]} (sequential "
        f"{[r.iterations for r in seq_recs]}), ATE {ate:.5f} m (sequential "
        f"cold {ate_seq:.5f} m), launches {launches}")
    check(n == len(frames) - 1 and all(r.converged for r in recs)
          and not any(r.failed for r in recs),
          f"batched odometry {name}: a pair failed or did not converge")
    check(abs(ate - ate_seq) <= 0.002,
          f"batched odometry {name}: ATE {ate} against {ate_seq}")
    if fused:
        check(launches["align_fused"] == -(-n // ODOM_BATCH)
              and not any(launches[k] for k in KERNELS),
              f"batched odometry {name}: not one launch a batch: {launches}")
    else:
        check(launches["fused_moments"] > 0 and launches["align_fused"] == 0,
              f"batched odometry {name} launched {launches}")
    if root is None:
        return launches

    from cvo_rgbd_torch.synth import BandScene, make_tum_dataset, revisit_path

    full, short = os.path.join(root, "render"), os.path.join(root, "prefix")
    make_tum_dataset(full, revisit_path(FRAMES, period=33), BandScene(*SIZE))
    os.makedirs(short)
    for d in ("rgb", "depth"):
        os.symlink(os.path.join(full, d), os.path.join(short, d))
    with open(os.path.join(full, "assoc.txt")) as f:
        head = f.read().splitlines()[:2]
    with open(os.path.join(short, "assoc.txt"), "w") as f:
        f.write("\n".join(head) + "\n")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = run_multiseq([full, short], 1, adaptive=adaptive, params=p,
                        num_want=NUM_WANT, warm_start=False,
                        log=lambda *a: None)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ms_launches = read_launches()
    long_b, short_b = (read_trajectory(outs[d]) for d in (full, short))
    worst = max(float(np.abs(long_b[t] - seq_est[t]).max()) for t in seq_est)
    worst_s = max(float(np.abs(short_b[t] - seq_est[t]).max())
                  for t in short_b)
    log(f"multiseq {name}: lanes of {len(long_b)} and {len(short_b)} frames, "
        f"{(len(long_b) + len(short_b) - 2) / dt:.3f} pairs/s, max |pose - "
        f"solo| {worst:.2e} / {worst_s:.2e} (tolerance 5e-3), launches "
        f"{ms_launches}")
    check(set(long_b) == set(seq_est) and len(short_b) == 2,
          f"multiseq {name}: trajectories of the wrong length")
    check(worst <= 5e-3 and worst_s <= 5e-3,
          f"multiseq {name}: a lane is off its solo run")
    if fused:
        check(ms_launches["align_fused"] == FRAMES - 1,
              f"multiseq {name}: not one launch a step: {ms_launches}")
    return {k: v + ms_launches[k] for k, v in launches.items()}


def fast_params(p):
    return dataclasses.replace(p, exp_mode="fast")


def slam_render(scene):
    """9: a path along the optical axis and back (`synth.depth_loop_path`),
    one period and a third: over the banded world the overlap score falls
    with depth, so keyframes are promoted every ~0.15 m and the path
    comes back past its earlier keyframes (JAX `cli slam` on the CPU: 6
    keyframes, 2 loop closures on these frames)."""
    from cvo_rgbd_torch.synth import depth_loop_path, render_frames

    return list(render_frames(
        depth_loop_path(SLAM_FRAMES, period=SLAM_PERIOD), scene))


def run_slam(label, params, clouds, gt):
    """One KeyframeSlam run over `clouds` with the launch counts read
    around it.  Returns (slam, corrected poses, launches)."""
    import numpy as np
    import torch

    from cvo_rgbd_torch.evaluation import ate_rmse
    from cvo_rgbd_torch.slam import KeyframeSlam, SlamConfig

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    slam = KeyframeSlam(params, SlamConfig())
    for i, cloud in enumerate(clouds):
        slam.process(i, cloud)
    poses, _ = slam.solve()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    odo = {t: pose for t, pose in zip(gt, slam.frame_poses)}
    est = {t: pose for t, pose in zip(gt, poses)}
    log(f"slam {label}: {len(clouds)} frames, keyframes "
        f"{[k.index for k in slam.keyframes]}, loop closures "
        f"{[(i, j) for i, j, _, _ in slam.loop_edges]}, "
        f"{dt / len(clouds):.4f} s/frame; ATE SLAM "
        f"{ate_rmse(gt, est)['rmse']:.5f} m, odometry "
        f"{ate_rmse(gt, odo)['rmse']:.5f} m; launches {launches}")
    check(all(np.isfinite(q).all() for q in poses + slam.frame_poses),
          f"slam {label}: a non-finite pose")
    return slam, poses, launches


def pose_gap(a, b):
    """Largest translation and rotation-entry difference of two lists of
    poses."""
    import numpy as np

    return (max(float(np.linalg.norm(x[:3, 3] - y[:3, 3]))
                for x, y in zip(a, b)),
            max(float(np.abs(x[:3, :3] - y[:3, :3]).max())
                for x, y in zip(a, b)))


def phase_slam(scene, root):
    """9: keyframe SLAM.  `python -m cvo_rgbd_torch.cli slam` over the
    render written as .pcd (MATLAB_PARAMS, kernel backend), then
    KeyframeSlam on the same clouds with exp_mode="fast" on the kernel
    backend (moment step and direct step) and on the fused one (resident
    at BATCH_GRID, tiled at FINE_GRID), and fast acvo on a prefix of the
    frames through the acvo frontend (its self-sweeps), each beside its
    precise twin: within FAST_POSE_TOL of it in translation.  Each run
    needs at least one loop closure (the acvo prefix too short for one)
    and finite poses, and launches the kernels its route owns.  Then the
    fast kernels at the shapes of these launches, timed in turns with
    their precise forms.  Returns (precise launches, fast launches) by
    kernel line row, and the ground truth by timestamp."""
    import numpy as np
    import torch

    from cvo_rgbd_torch import cli
    from cvo_rgbd_torch.batch import load_pcd_dir, pad_clouds
    from cvo_rgbd_torch.evaluation import ate_rmse
    from cvo_rgbd_torch.frontend import make_frontend
    from cvo_rgbd_torch.io.export import depth_to_cloud, write_pcd
    from cvo_rgbd_torch.io.tum import read_trajectory
    from cvo_rgbd_torch.params import MATLAB_PARAMS, AcvoParams

    t0 = time.perf_counter()
    frames = slam_render(scene)
    for _, nm, rgb, dep, _ in frames:
        write_pcd(os.path.join(root, f"{nm}.pcd"),
                  *depth_to_cloud(rgb, dep, scene.cam))
    gt = {float(nm): pose for _, nm, _, _, pose in frames}
    log(f"slam: rendered and wrote {len(frames)} frames in "
        f"{time.perf_counter() - t0:.2f} s")
    precise = {k: 0 for k in KERNELS + FUSED}
    fast = {k: 0 for k in KERNELS + FUSED}

    # the user's path: cli slam, MATLAB_PARAMS on the kernel backend
    out = os.path.join(root, "slam_poses_qt.txt")
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["slam", root, "--output", out])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = fused_by_mode(read_launches(), "resident")
    head = buf.getvalue().splitlines()[0]
    n_frames, n_kf, n_loops = (int(head.split()[k]) for k in (0, 2, 4))
    cli_poses = read_trajectory(out)
    log(f"cli slam: {head}; {dt / n_frames:.4f} s/frame with loading; ATE "
        f"{ate_rmse(gt, cli_poses)['rmse']:.5f} m; launches {got}")
    check(n_frames == len(frames) and n_loops >= 1,
          f"cli slam closed no loop: {head}")
    check(all(np.isfinite(q).all() for q in cli_poses.values()),
          "cli slam: a non-finite pose")
    check(got["fused_moments"] > 0 and got["color_gram"] == 0
          and not any(got[k] for k in FUSED),
          f"cli slam launched {got}")
    for k, v in got.items():
        if k in precise:
            precise[k] += v

    dev = torch.device("cuda")
    coarse_sets = load_pcd_dir(root, grid=BATCH_GRID)
    coarse = pad_clouds(coarse_sets, dev)
    fine = pad_clouds(load_pcd_dir(root, grid=FINE_GRID), dev)
    pm = MATLAB_PARAMS
    pd = dataclasses.replace(pm, step_mode="direct")
    pf = dataclasses.replace(pm, backend="fused")
    # fast acvo on the acvo frontend's clouds: its self-sweeps
    fe = make_frontend(1, SLAM_ACVO_NUM_WANT, 0)
    acvo = [fe(f[2], f[3]) for f in frames[:SLAM_ACVO_FRAMES]]
    pa = AcvoParams(eps=5e-4, eps_2=1e-4)
    sub = {t: gt[t] for t in list(gt)[:SLAM_ACVO_FRAMES]}
    # (label, params, clouds, ground truth, fused mode, precise twin)
    runs = [("precise fused", pf, coarse, gt, "resident", None),
            ("fast kernel", fast_params(pm), coarse, gt, None, "cli"),
            ("precise kernel direct", pd, coarse, gt, None, None),
            ("fast kernel direct", fast_params(pd), coarse, gt, None,
             "precise kernel direct"),
            ("fast fused", fast_params(pf), coarse, gt, "resident",
             "precise fused"),
            ("precise fused fine", pf, fine, gt, "tiled", None),
            ("fast fused fine", fast_params(pf), fine, gt, "tiled",
             "precise fused fine"),
            ("precise acvo kernel", pa, acvo, sub, None, None),
            ("fast acvo kernel", fast_params(pa), acvo, sub, None,
             "precise acvo kernel")]
    # cli slam prints counts of keyframes and loop closures, not lists
    done = {"cli": (n_kf, n_loops, [cli_poses[t] for t in sorted(cli_poses)])}
    for label, params, clouds, truth, mode, against in runs:
        slam, poses, got = run_slam(f"{label} N={clouds[0].capacity}",
                                    params, clouds, truth)
        kf = [k.index for k in slam.keyframes]
        loops = [(i, j) for i, j, _, _ in slam.loop_edges]
        done[label] = (kf, loops, poses)
        acvo_run = clouds is acvo
        check(acvo_run or len(loops) >= 1, f"slam {label}: no loop closure")
        if mode is not None:
            got = fused_by_mode(got, mode)
            check(got[f"align_fused_{mode}"] > 0
                  and not any(got[k] for k in KERNELS),
                  f"slam {label} launched {got}")
        else:
            step = (("fused_flow", "fused_step_coeffs")
                    if params.step_mode == "direct" else ("fused_moments",))
            step += ("color_gram", "fused_wsq") if acvo_run else ()
            check(all(got[k] > 0 for k in step)
                  and not any(got[k] for k in KERNELS if k not in step)
                  and got["align_fused"] == 0, f"slam {label} launched {got}")
            got.pop("align_fused")
        counts = fast if params.exp_mode == "fast" else precise
        for k, v in got.items():
            if k in counts:
                counts[k] += v
        if against is None:
            continue
        base_kf, base_loops, base_poses = done[against]
        dt_max, dr_max = pose_gap(poses, base_poses)
        log(f"slam {label} against {against}: keyframes {kf} vs {base_kf}, "
            f"loop closures {loops} vs {base_loops}; pose difference: "
            f"translation {dt_max:.2e} m (tolerance {FAST_POSE_TOL:g}), "
            f"rotation entries {dr_max:.2e}")
        check(dt_max <= FAST_POSE_TOL, f"slam {label}: {dt_max} m from "
              f"{against}, beyond the fast-vs-precise bound")

    # the fast kernels at the shapes of the launches above, each timed in
    # turns with its precise form: the linear sweeps at the coarse grid's
    # capacity, acvo's moment sweep and self-sweeps at SLAM_ACVO_NUM_WANT
    x, y, ci = linear_pair(coarse_sets, dev)
    phase_linear_moments(x, y, ci, fast=True)
    phase_flow([(f"slam linear N={x.capacity}", pm, x, y, ci, ell, True)
                for ell in (0.1, 0.03)], fast=True)
    # (at ell_min no pair of these sparse clouds is within the radius)
    phase_kernels(*acvo[:2], pa, fast=True, ells=(pa.ell_init,))
    phase_wsq(*acvo[:2], pa, fast=True)
    return precise, fast, gt



def write_tum_folder(root, frames):
    """10a: the render as a TUM folder (rgb/, depth/, assoc.txt,
    groundtruth.txt), the PNGs written by `png_bytes`: 8-bit RGB and
    16-bit depth, the values `synth.render_frames` gives."""
    import numpy as np

    from cvo_rgbd_torch.io.tum import write_trajectory_line

    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(root, d))
    lines = []
    with open(os.path.join(root, "groundtruth.txt"), "w") as gt:
        gt.write("# ground truth\n")
        for _, nm, rgb, dep, pose in frames:
            for d, img, ref in (("rgb", rgb.astype(np.uint8), rgb),
                                ("depth", dep.astype(np.uint16), dep)):
                check(np.array_equal(img.astype(np.float32), ref),
                      f"frame {nm}: {d} is not integral")
                with open(os.path.join(root, d, f"{nm}.png"), "wb") as fh:
                    fh.write(png_bytes(img))
            lines.append(f"{nm} rgb/{nm}.png {nm} depth/{nm}.png")
            write_trajectory_line(gt, nm, pose)
    with open(os.path.join(root, "assoc.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def phase_loader(root, frames):
    """10a: write the render as a TUM folder, decode every PNG through
    the native loader (`cvo_rgbd_torch.native`, built here with g++)
    and require the render's bits; time the decoder and the prefetch
    loader over the folder.  Returns the loader's frames/s."""
    import numpy as np

    from cvo_rgbd_torch import native

    t0 = time.perf_counter()
    native.get_lib()
    t_build = time.perf_counter() - t0
    write_tum_folder(root, frames)
    paths = [(os.path.join(root, "rgb", f"{nm}.png"),
              os.path.join(root, "depth", f"{nm}.png"))
             for _, nm, _, _, _ in frames]
    t0 = time.perf_counter()
    for (rp, dp), (_, nm, rgb, dep, _) in zip(paths, frames):
        r, d = native.decode_png(rp), native.decode_png(dp)
        check(r.dtype == np.uint8 and d.dtype == np.uint16
              and np.array_equal(r.astype(np.float32), rgb)
              and np.array_equal(d.astype(np.float32), dep),
              f"the loader's decode of frame {nm} is not the render's bits")
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    h, w = frames[0][2].shape[:2]
    rates = []
    for _ in range(LOADER_PASSES):
        t0 = time.perf_counter()
        loader = native.PrefetchLoader([a for a, _ in paths],
                                       [b for _, b in paths], w, h)
        got = [i for i, _, _ in loader]
        loader.close()
        rates.append(len(got) / (time.perf_counter() - t0))
        check(got == list(range(len(frames))), f"loader order {got}")
    fps = median(rates)
    size = sum(os.path.getsize(f) for pair in paths for f in pair)
    log(f"loader: {len(frames)} frames of {h}x{w} as PNG ({size} bytes), "
        f"library built in {t_build:.3f} s, every decode the render's bits; "
        f"decode_png {decode_ms:.3f} ms a frame (rgb + depth); "
        f"PrefetchLoader {fps:.1f} frames/s (median of {LOADER_PASSES} "
        f"passes: {[round(r, 1) for r in rates]})")
    return fps


def phase_cli_run(root, frames, odometry, p, paf, loader_fps):
    """10b-c: `cli run` over the TUM folder through the native loader.
    (c) acvo on the fused backend at 1024 over all frames: phase 5c's
    trajectory and ATE; (b) the kernel backend on PROFILED_FRAMES frames
    with --profile-dir: the trajectory line for line phase 5's in-memory
    run, and the trace with CUDA kernel events of color_gram and
    fused_moments; then (c) once more, after the profiled run: the same
    trajectory, its frames/s logged beside the first.  Returns the
    launches by kernel line row."""
    import torch

    from cvo_rgbd_torch import cli
    from cvo_rgbd_torch.evaluation import ate_rmse
    from cvo_rgbd_torch.io.tum import read_trajectory
    from cvo_rgbd_torch.utils.timing import device_events

    launches = {k: 0 for k in KERNELS + FUSED}
    gt = {float(nm): pose for _, nm, _, _, pose in frames}

    def drive(args):
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["run", root, "1", *args])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, read_launches()

    def fused(when):
        """(c): acvo fused at 1024 over every frame."""
        out = os.path.join(root, "acvo_fused.txt")
        dt, got = drive(["--adaptive", "--backend", "fused", "--num-want",
                         str(RESIDENT_NUM_WANT), "--output", out])
        ref = odometry[paf, RESIDENT_NUM_WANT]
        with open(out) as fh:
            text = fh.read()
        ate = ate_rmse(gt, read_trajectory(out))["rmse"]
        fps = (len(frames) - 1) / dt
        log(f"cli run acvo fused {RESIDENT_NUM_WANT}, loader, {when}: "
            f"{fps:.3f} frames/s with start-up (phase 5c in memory "
            f"{ref['fps']:.3f}); ATE {ate!r} (phase 5c {ref['ate']!r}); "
            f"loader alone {loader_fps:.1f} frames/s, "
            f"{100.0 * fps / loader_fps:.2f}% of a frame's time at most; "
            f"launches {got}")
        check(text == ref["traj"] and ate == ref["ate"],
              f"cli run (fused, loader, {when}) is not phase 5c's run")
        check(got["align_fused"] == len(frames) - 1
              and not any(got[k] for k in KERNELS),
              f"cli run (fused) launched {got}")
        launches["align_fused_resident"] += got["align_fused"]

    fused("first")

    # (b) the kernel backend, profiled
    out = os.path.join(root, "cvo_profiled.txt")
    prof_dir = os.path.join(root, "profile")
    dt, got = drive(["--num-want", str(NUM_WANT), "--max-frames",
                     str(PROFILED_FRAMES), "--profile-dir", prof_dir,
                     "--output", out])
    with open(out) as fh:
        lines = fh.read().splitlines()
    ref = odometry[p, NUM_WANT]["traj"].splitlines()[:PROFILED_FRAMES]
    check(lines == ref, f"cli run (kernel, loader): {lines} is not phase "
          f"5's in-memory trajectory {ref}")
    traces = os.listdir(prof_dir)
    check(len(traces) == 1, f"--profile-dir wrote {traces}")
    trace = os.path.join(prof_dir, traces[0])
    t0 = time.perf_counter()
    events = device_events(trace)
    t_scan = time.perf_counter() - t0
    by_kernel = {k: sum(n for name, n in events.items() if tag in name)
                 for k, tag in (("color_gram", "color_gram_kernel"),
                                ("fused_moments", "moments_"))}
    log(f"cli run kernel backend, {PROFILED_FRAMES} frames, loader, "
        f"--profile-dir: {dt:.2f} s; trajectory = phase 5's first "
        f"{PROFILED_FRAMES} lines; trace {os.path.getsize(trace)} bytes, "
        f"{sum(events.values())} device events ({len(events)} names, "
        f"scanned in {t_scan:.2f} s), kernel events {by_kernel} for "
        f"wrapper launches {got}")
    check(all(by_kernel.values()),
          f"the trace holds no CUDA kernel event of {by_kernel}")
    check(got["color_gram"] > 0 and got["fused_moments"] > 0
          and got["align_fused"] == 0, f"cli run (kernel) launched {got}")
    for k in KERNELS:
        launches[k] += got[k]

    fused("after the profiled run")
    return launches


def phase_trace(cases):
    """10d: `core.trace.align_trace` on the kernel backend at the first
    3072 pair, cvo and acvo, for `align`'s iterations + 5: the record
    freezes at align's stopping iteration, the final state is align's
    bits, and acvo's ell moves as align's does.  Returns the launches by
    kernel line row."""
    import torch

    from cvo_rgbd_torch import align
    from cvo_rgbd_torch.core.trace import align_trace

    launches = {k: 0 for k in KERNELS + FUSED}
    for p, x, y in cases:
        adaptive = hasattr(p, "self_mode")
        name = "acvo" if adaptive else "cvo"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = align(p, x, y)
        k = int(res.iterations)
        t_align = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        final, rec = align_trace(p, x, y, k + 5)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = read_launches()
        conv = rec.converged.cpu()
        ell = rec.ell.cpu()
        log(f"align_trace {name} N={x.capacity}: {k + 5} iterations in "
            f"{dt:.2f} s (align: {k + 1} in {t_align:.2f} s), converged from {int(conv.int().argmax())} (align "
            f"stopped at {k}), ell {float(ell[0]):.5f} -> {float(ell[-1]):.5f}"
            f" ({len(set(ell.tolist()))} values), |omega| first/last "
            f"{float(rec.omega_norm[0]):.3e}/{float(rec.omega_norm[k]):.3e}; "
            f"launches {got}")
        check(bool(res.converged) and not conv[:k].any() and conv[k:].all(),
              f"align_trace {name}: the record does not freeze at {k}")
        check(all(torch.equal(a, b) for a, b in (
            (final.tf, res.tf), (final.R, res.R), (final.T, res.T),
            (final.ell, res.ell))), f"align_trace {name}: not align's bits")
        check(not adaptive or len(set(ell[:k + 1].tolist())) > 1,
              f"align_trace {name}: ell never moved")
        used = ("color_gram", "fused_moments") + (
            ("fused_wsq",) if adaptive else ())
        check(all(got[u] > 0 for u in used) and got["align_fused"] == 0,
              f"align_trace {name} launched {got}")
        for u in KERNELS:
            launches[u] += got[u]
    return launches


def phase_slam_refine(root, gt):
    """10e: `cli slam --refine` over phase 9's .pcd folder (MATLAB_PARAMS,
    kernel backend): a lower BA cost and finite poses; the card's
    `ba_solve` on that problem against the CPU's (poses and landmarks
    within 1e-4, costs 1e-3 relative, tests/test_torch_ba.py), a rerun
    on the card beside it (atomic scatter-adds: logged, not gated), the
    BA time, and the keyframe ATE before and after.  Returns the
    launches by kernel line row."""
    import numpy as np
    import torch

    from cvo_rgbd_torch import cli, parallel
    from cvo_rgbd_torch.evaluation import ate_rmse
    from cvo_rgbd_torch.io.tum import read_trajectory
    from cvo_rgbd_torch.slam import KeyframeSlam

    # spies on the CLI's own calls: the slam, its BA problem and result
    seen = {}
    refine_map, ba_solve = KeyframeSlam.refine_map, parallel.ba_solve

    def refine_spy(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = refine_map(self, *a, **kw)
        torch.cuda.synchronize()
        seen.update(slam=self, kf_poses=kw["kf_poses"], out=out,
                    ms=(time.perf_counter() - t0) * 1e3)
        return out

    def solve_spy(problem, **kw):
        seen.update(problem=problem, kw=kw)
        return ba_solve(problem, **kw)

    out = os.path.join(root, "slam_refined.txt")
    buf = io.StringIO()
    KeyframeSlam.refine_map, parallel.ba_solve = refine_spy, solve_spy
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["slam", root, "--refine", "--output", out])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        KeyframeSlam.refine_map, parallel.ba_solve = refine_map, ba_solve
    got = fused_by_mode(read_launches(), "resident")
    head, line = buf.getvalue().splitlines()[:2]
    m = re.fullmatch(r"refine: BA cost (\S+) -> (\S+), (\d+) landmarks",
                     line)
    poses = read_trajectory(out)
    check(m is not None and float(m[2]) < float(m[1]),
          f"cli slam --refine: {line!r}")
    check(len(poses) == len(gt)
          and all(np.isfinite(q).all() for q in poses.values()),
          "cli slam --refine: a missing or non-finite pose")
    check(got["fused_moments"] > 0 and not any(got[k] for k in FUSED),
          f"cli slam --refine launched {got}")

    problem, kw, card = seen["problem"], seen["kw"], seen["out"]
    cpu = parallel.ba_solve(problem.to("cpu"), **{**kw, "device": "cpu"})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = parallel.ba_solve(problem, **kw)
    torch.cuda.synchronize()
    ba_ms = (time.perf_counter() - t0) * 1e3
    gaps = [float((a.cpu() - b).abs().max()) for a, b in zip(card[:2], cpu)]
    cost_gap = float(((card[2].cpu() - cpu[2]).abs() / cpu[2].abs()).max())
    rerun = [float((a - b).abs().max()) for a, b in zip(card, again)]
    ts = sorted(gt)
    kf_t = [ts[k.index] for k in seen["slam"].keyframes]
    kf_gt = {t: gt[t] for t in kf_t}
    before = ate_rmse(kf_gt, dict(zip(kf_t, np.asarray(seen["kf_poses"]))))
    after = ate_rmse(kf_gt, dict(zip(kf_t, card[0].cpu().numpy())))
    n_obs = int((problem.obs_w > 0).sum())
    log(f"cli slam --refine: {head}; {line}; {dt:.2f} s; refine_map "
        f"{seen['ms']:.1f} ms with the harvest, ba_solve {ba_ms:.1f} ms "
        f"({kw}, {problem.poses.shape[0]} poses, {problem.landmarks.shape[0]}"
        f" landmarks, {n_obs} observations, {problem.edge_pose.shape[0]} "
        f"edges); card vs CPU: poses {gaps[0]:.2e}, landmarks "
        f"{gaps[1]:.2e}, costs {cost_gap:.2e} relative; card rerun "
        f"{rerun}; keyframe ATE {before['rmse']:.5f} m before, "
        f"{after['rmse']:.5f} m after (not gated); launches {got}")
    check(gaps[0] <= 1e-4 and gaps[1] <= 1e-4 and cost_gap <= 1e-3,
          "the card's ba_solve is off the CPU's")
    return got


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    start = time.perf_counter()

    def mark(phase):
        log(f"-- {phase} done at {time.perf_counter() - start:.1f} s")

    from cvo_rgbd_torch.device import pin_fp32
    from cvo_rgbd_torch.frontend import make_frontend
    from cvo_rgbd_torch.ops import _build
    from cvo_rgbd_torch.params import MATLAB_PARAMS, AcvoParams, CvoParams
    from cvo_rgbd_torch.synth import BandScene, render_frames, revisit_path

    # 1. environment
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}")
    pin_fp32()
    log("precision pinned: matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} float32_matmul_precision="
        f"{torch.get_float32_matmul_precision()}")
    t0 = time.perf_counter()
    _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")

    # 2. data: the cvo frontend (RGB features) and the acvo one (HSV)
    t0 = time.perf_counter()
    scene = BandScene(*SIZE)
    frames = list(render_frames(revisit_path(FRAMES, period=33), scene))
    tmp = tempfile.TemporaryDirectory()
    fe, fe_a = make_frontend(1, NUM_WANT, 1), make_frontend(1, NUM_WANT, 0)
    c0 = fe(frames[0][2], frames[0][3])
    c1 = fe(frames[1][2], frames[1][3])
    a0 = fe_a(frames[0][2], frames[0][3])
    a1 = fe_a(frames[1][2], frames[1][3])
    log(f"rendered {len(frames)} frames at {SIZE[0]}x{SIZE[1]} in "
        f"{time.perf_counter() - t0:.2f} s; clouds capacity {c0.capacity}, "
        f"valid {int(c0.mask.sum().item())}/{int(c1.mask.sum().item())}")
    cap = -(-NUM_WANT // 128) * 128
    check(c0.capacity == cap and a0.capacity == cap,
          f"expected capacity {cap}")

    p = CvoParams()   # kernel backend, C++ stops eps=5e-5 / eps_2=1e-5
    pa = AcvoParams()
    mark("1-2 (build, data)")

    # 2b. the frames as .pcd files, for the MATLAB path
    root = tmp.name
    sets = pcd_sets(frames, root, scene.cam)
    dev = c0.positions.device
    lin = {g: linear_pair(sets[g], dev) for g in sets}
    mark("2b (pcd)")

    small_scene = BandScene(*SMALL_SIZE)
    small = [make_frontend(1, SMALL_NUM_WANT, 1)(f[2], f[3])
             for f in render_frames(revisit_path(2, period=33), small_scene)]
    small_a = [make_frontend(1, SMALL_NUM_WANT, 0)(f[2], f[3])
               for f in render_frames(revisit_path(2, period=33),
                                      small_scene)]
    # 3d's two-pass sweeps: se on the first cvo pair, then linear on the
    # pcd pairs; the kernel line's timing is the finer linear pair's
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.ops import gram

    x0, x1 = kd_sort(c0), kd_sort(c1)
    ck = gram.color_gram(*x0, *x1, p=p)
    flow_cases = [(f"cvo ck={ck_in is not None}", p, x0, x1, ck_in, ell,
                   ck_in is not None and ell == 0.03)
                  for ell in (0.1, 0.03) for ck_in in (ck, None)]
    flow_cases += [(f"linear grid={g}", MATLAB_PARAMS, *lin[g], ell,
                    g == FINE_GRID and ell == 0.03)
                   for g in (BATCH_GRID, FINE_GRID) for ell in (0.1, 0.03)]

    def kernel_phases(fast):
        """3-3e in one exp mode; 3f is the fast run, after the probe of
        which exp each fast instantiation takes."""
        if fast:
            phase_exp_forms()
        rows = phase_kernels(c0, c1, p, fast)
        rows.update(phase_wsq(a0, a1, pa, fast))
        mark("3-3b" + "/fast" * fast)
        rows.update(phase_fused_kernels([
            ("tiled", p, c0, c1), ("tiled", pa, a0, a1),
            ("resident", p, *small), ("resident", pa, *small_a),
        ], fast))
        mark("3c" + "/fast" * fast)
        rows.update(phase_flow(flow_cases, fast))
        mark("3d" + "/fast" * fast)
        # 3e. the linear branches of fused_moments and align_fused: the
        # align_fused rows take the worst error of these cases too
        phase_linear_moments(*lin[FINE_GRID], fast)
        for name, row in phase_fused_kernels([
            ("tiled", MATLAB_PARAMS, *lin[FINE_GRID][:2]),
            ("resident", MATLAB_PARAMS, *lin[BATCH_GRID][:2]),
        ], fast).items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            row["max_abs_err"])
        mark("3e" + "/fast" * fast)
        return rows

    kernels = kernel_phases(False)
    # 3f. the exp_mode="fast" form of rows 2-7: 3-3e again
    fast_rows = kernel_phases(True)

    ms_iter = phase_align(c0, c1, p, small)
    phase_profile(c0, c1, p)
    phase_profile(c0, c1, dataclasses.replace(p, step_mode="direct"))
    mark("4")

    # acvo's tail at the C++ stops is slower still: on this pair the
    # plain versions stopped at 146 and at 170 iterations under two CPU
    # builds of torch, tf within 1e-4 of each other
    ms_iter_a = phase_align(a0, a1, pa, small_a, skew=0.25)
    phase_align(a0, a1, dataclasses.replace(pa, self_mode="cheb"))
    phase_profile(a0, a1, pa)
    phase_profile(a0, a1, dataclasses.replace(pa, step_mode="direct"))
    mark("4b")

    # 4c. the fused backend at the same stops
    pf = dataclasses.replace(p, backend="fused")
    paf = dataclasses.replace(pa, backend="fused")
    phase_align(c0, c1, pf, small)
    phase_fused_timing(c0, c1, pf, ms_iter)
    phase_align(a0, a1, paf, small_a, skew=0.25)
    phase_fused_timing(a0, a1, paf, ms_iter_a)
    mark("4c")

    launches = {k: 0 for k in KERNELS + FUSED + BATCHED + (PROBE,)}
    runs = [(p, False, NUM_WANT), (pa, True, NUM_WANT)]
    runs += [(q, adaptive, nw) for nw in (NUM_WANT, RESIDENT_NUM_WANT)
             for q, adaptive in ((pf, False), (paf, True))]
    # 5d. the kernel backend's two-sweep step on the cells of 5 and 5b
    runs += [(dataclasses.replace(q, step_mode="direct"), adaptive, NUM_WANT)
             for q, adaptive in ((p, False), (pa, True))]
    odometry = {}
    for params, adaptive, nw in runs:
        got, odometry[params, nw] = phase_odometry(frames, params, adaptive,
                                                   nw)
        for k, v in got.items():
            launches[k] += v
        mark(f"5 ({params.backend}, {params.step_mode}, "
             f"{type(params).__name__}, {nw})")

    # 6. the MATLAB path
    for k, v in phase_matlab(root, frames).items():
        launches[k] += v
    tmp.cleanup()
    mark("6 (MATLAB batch)")

    # 7. the construct probes; their tiled aligns are row 4's launches
    kernels[PROBE], got = phase_probes()
    launches[PROBE] += got[PROBE]
    launches["align_fused_tiled"] += got["align_fused"]
    mark("7 (probes)")

    # 8. batched fused registration of the pcd pairs, 63 lanes a launch;
    # then with exp_mode="fast" (its rows logged, not in the kernel line)
    rows, got = phase_batched_fused(sets)
    kernels.update(rows)
    for k, v in got.items():
        launches[k] += v
    phase_batched_fused(sets, fast=True)
    mark("8 (batched fused)")

    # 8b. batched odometry and multiseq over the render; the fused runs
    # are tiled (3072)
    tmp8 = tempfile.TemporaryDirectory()
    for q, adaptive, root in ((pf, False, tmp8.name), (paf, True, None),
                              (p, False, None)):
        got = phase_batched_odometry(frames, q, adaptive, root)
        launches["align_fused_tiled_batched"] += got.pop("align_fused")
        for k in KERNELS:
            launches[k] += got[k]
    tmp8.cleanup()
    mark("8b (batched odometry)")

    # 9. keyframe SLAM: cli slam, then the fast kernels' main path
    tmp9 = tempfile.TemporaryDirectory()
    got, got_fast, slam_gt = phase_slam(scene, tmp9.name)
    for k, v in got.items():
        launches[k] += v
    for k, v in got_fast.items():
        launches[f"{k}/fast"] = v
    kernels.update(fast_rows)
    mark("9 (slam)")

    # 10. the rest of cli run and cli slam: the loader, --profile-dir,
    # align_trace, slam --refine
    tmp10 = tempfile.TemporaryDirectory()
    folder = os.path.join(tmp10.name, "tum")
    loader_fps = phase_loader(folder, frames)
    mark("10a (loader)")
    for k, v in phase_cli_run(folder, frames, odometry, p, paf,
                              loader_fps).items():
        launches[k] += v
    tmp10.cleanup()
    mark("10b-c (cli run)")
    for k, v in phase_trace([(p, c0, c1), (pa, a0, a1)]).items():
        launches[k] += v
    mark("10d (align_trace)")
    for k, v in phase_slam_refine(tmp9.name, slam_gt).items():
        launches[k] += v
    tmp9.cleanup()
    mark("10e (slam --refine)")

    sources = {
        "color_gram": ("cvo_rgbd_torch/csrc/color_gram.cu",
                       "cvo_rgbd_tpu/ops/pallas_gram.py:401"),
        "fused_moments": ("cvo_rgbd_torch/csrc/fused_moments.cu",
                          "cvo_rgbd_tpu/ops/pallas_moments.py:199"),
        "fused_wsq": ("cvo_rgbd_torch/csrc/fused_wsq.cu",
                      "cvo_rgbd_tpu/ops/pallas_moments.py:320"),
        "align_fused_tiled": ("cvo_rgbd_torch/csrc/align_fused.cu",
                              "cvo_rgbd_tpu/ops/pallas_align.py:1351"),
        "align_fused_resident": ("cvo_rgbd_torch/csrc/align_fused.cu",
                                 "cvo_rgbd_tpu/ops/pallas_align.py:1379"),
        "fused_flow": ("cvo_rgbd_torch/csrc/fused_flow.cu",
                       "cvo_rgbd_tpu/ops/pallas_gram.py:437"),
        "fused_step_coeffs": ("cvo_rgbd_torch/csrc/fused_flow.cu",
                              "cvo_rgbd_tpu/ops/pallas_gram.py:470"),
        "align_fused_tiled_batched": ("cvo_rgbd_torch/csrc/align_fused.cu",
                                      "cvo_rgbd_tpu/ops/pallas_align.py:1351"),
        "align_fused_resident_batched": (
            "cvo_rgbd_torch/csrc/align_fused.cu",
            "cvo_rgbd_tpu/ops/pallas_align.py:1379"),
        PROBE: ("cvo_rgbd_torch/csrc/construct_probe.cu",
                "scripts/tpu_construct_probe.py:24"),
    }
    missing = [k for k in KERNELS + FUSED + BATCHED + (PROBE,) + FAST
               if not launches[k]]
    check(not missing, f"kernels never launched on a main path: {missing}")
    rows = []
    for name in KERNELS + FUSED + BATCHED + (PROBE,) + FAST:
        k = kernels[name]
        src, rep = sources[name.removesuffix("/fast")]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None,
        })
    log(f"all phases passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
