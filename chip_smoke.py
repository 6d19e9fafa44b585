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
   clouds' two self-pairs; 3c. the whole-align kernel `align_fused`
   after 1, 3 and 10 iterations, tiled on the first cvo and acvo pairs
   (N=M=3072) and resident on two small pairs (N=M=1024); 3d. the
   two-pass sweeps `fused_flow` and `fused_step_coeffs` on the first cvo
   pair at ell 0.1 and 0.03, with and without the color cache, then in
   MATLAB's linear mode with the CI on the first pcd pairs; 3e. the
   linear branches of `fused_moments` and `align_fused` (tiled on the
   0.015 m pair, resident on the 0.05 m pair);
4. one reference-scale cvo align at the C++ stops (eps=5e-5,
   eps_2=1e-5) on the kernel backend, a small pair registered on the
   card and on the CPU (plain versions), which must agree, and a
   profile of one iteration, with the moment sweep and with the direct
   step's two sweeps; 4b. the same for acvo (`self_mode="exact"`,
   then one align with `"cheb"`); 4c. the same aligns on the fused
   backend, each run twice (the iterations must repeat), ms/iteration
   by slope (10 against 60 iterations) and a profile of one align;
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
   one plain step from the kernel's state after 9);
   8b. `run_odometry_batched(batch=9)` over the render on
   the fused backend (cvo and acvo, 3072, tiled) and on the kernel
   backend (cvo), each against `run_odometry_frames(warm_start=False)`
   in the same run, and `run_multiseq` over the render written as a TUM
   folder and a 2-frame prefix of it (ragged lanes), each lane against
   its solo run.

The line before last is a JSON object with each kernel's launches on
the main paths together, its error against the plain version, its
time, the plain version's time and its bound (the batched rows of
`align_fused`: a 63-lane launch of exactly 10 iterations, and their
launches those of phases 8 and 8b); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
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


def time_ms(fn, runs=RUNS, warmup=WARMUP, spin=SPIN_CYCLES):
    """Median over `runs` calls of fn, each between its own CUDA events,
    after `warmup` untimed calls.  A short device-side spin ahead of the
    first event lets the host enqueue fn's launches before the clock
    starts, so a kernel's time is its device time, not the wrapper's
    Python overhead (a plain version that synchronizes still pays it)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes, nops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_kernels(fixed, moving, p):
    """Each kernel against its plain version on the first pair."""
    import torch

    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds, kd_sort
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import gram, moments

    fixed, moving = kd_sort(fixed), kd_sort(moving)
    dev = fixed.positions.device
    n, m = fixed.capacity, moving.capacity
    out = {}

    # --- color_gram ---
    scal_c = gram.scalars(torch.full((), p.ell_init, device=dev), p)
    args_c = (fixed.features, fixed.mask, moving.features, moving.mask,
              scal_c)
    ck = gram.color_gram_cuda(*args_c)
    ck_plain = gram.color_gram_plain(*args_c)
    torch.cuda.synchronize()
    err = (ck - ck_plain).abs().max().item()
    log(f"color_gram N={n} M={m}: max_abs_err={err:.3e} (tolerance 1e-6)")
    check(err <= 1e-6, f"color_gram disagrees with its plain version: {err}")
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
    lo_x, hi_x = block_bounds(fixed.positions, fixed.mask, moments.TILE_I)
    lo_y, hi_y = block_bounds(moving.positions, moving.mask, moments.TILE_J)
    md = aabb_min_d2(lo_x, hi_x, lo_y, hi_y)
    for ell_v in (p.ell_init, p.ell_sched[-1][1]):
        scal = gram.scalars(torch.full((), ell_v, device=dev), p)
        keep = md <= scal[gram.S_D2_THRES] + moments.SKIP_MARGIN
        for use_ck in (True, False):
            ck_in = ck if use_ck else None
            ref, ref_nnz = moments.fused_moments_plain(
                x_c, fixed.features, fixed.mask, y_c, moving.features,
                moving.mask, phi, scal, ck_in, None)
            got = {}
            for skip in (False, True):
                args = (x_c, fixed.features, fixed.mask, y_c,
                        moving.features, moving.mask, phi, scal, ck_in,
                        md if skip else None)
                mom, nnz = moments.fused_moments_cuda(*args)
                torch.cuda.synchronize()
                got[skip] = (mom.clone(), nnz.item())
                colmax = ref.abs().amax(dim=0).clamp_min(1e-30)
                rel = ((mom - ref).abs() / colmax).max().item()
                nnz_rel = abs(nnz.item() - ref_nnz.item()) / max(
                    ref_nnz.item(), 1.0)
                log(f"fused_moments ell={ell_v} ck={use_ck} skip={skip}: "
                    f"Mom err/max|col|={rel:.3e} (tolerance 1e-4), nnz "
                    f"{nnz.item():.0f} vs {ref_nnz.item():.0f}")
                check(rel <= 1e-4, f"fused_moments Mom disagrees: {rel}")
                check(nnz_rel <= 1e-4, f"fused_moments nnz disagrees: "
                      f"{nnz.item()} vs {ref_nnz.item()}")
            check(torch.equal(got[False][0], got[True][0])
                  and got[False][1] == got[True][1],
                  "fused_moments: tile skip on and off differ")
            args = (x_c, fixed.features, fixed.mask, y_c, moving.features,
                    moving.mask, phi, scal, ck_in, md)
            ms = time_ms(lambda: moments.fused_moments_cuda(*args))
            plain_ms = time_ms(lambda: moments.fused_moments_plain(*args))
            pairs = int(keep.sum().item()) * moments.TILE_I * moments.TILE_J
            nnz_v = got[True][1]
            nbytes = (n * (3 + moments.NUM_MONO) + m * 3 + m * moments.NUM_MONO
                      + md.numel() + 8 + 1) * 4
            nbytes += pairs * 4 if use_ck else (n + m) * 6 * 4
            b_ms, b_by = bound(nbytes, pairs * (OPS_PAIR + (
                0 if use_ck else OPS_COLOR)) + nnz_v * OPS_GATED)
            log(f"fused_moments ell={ell_v} ck={use_ck} skip=True: {ms:.4f} "
                f"ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
                f"tiles kept {keep.float().mean().item():.3f}, nnz {nnz_v:.0f}")
            if use_ck and ell_v == p.ell_sched[-1][1]:
                err = max(((got[s][0] - ref).abs()).max().item()
                          for s in (False, True))
                out["fused_moments"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, ell=ell_v)
    return out


def phase_wsq(fixed, moving, p):
    """fused_wsq against its plain version on both self-pairs of the
    first acvo pair: ell_init and ell_min, ck on and off, skip on and
    off, symmetric and full."""
    import torch

    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds, kd_sort
    from cvo_rgbd_torch.ops import gram, wsq
    from cvo_rgbd_torch.ops.moments import SKIP_MARGIN, pair_weights

    tw = wsq.TILE_W
    out = {}
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
        nb = n // tw
        upper = torch.triu(torch.ones(nb, nb, dtype=torch.bool, device=dev))
        for ell_v in (p.ell_init, p.ell_min):
            scal = gram.scalars(torch.full((), ell_v, device=dev), p)
            keep = (md <= scal[gram.S_D2_THRES] + SKIP_MARGIN) & upper
            for use_ck in (True, False):
                ck_in = ck if use_ck else None
                ref_w, ref_n = wsq.fused_wsq_plain(*x, *x, scal, ck_in)
                ref_w, ref_n = ref_w.item(), ref_n.item()
                got = {}
                for sym in (False, True):
                    for skip in (False, True):
                        w, nz = wsq.fused_wsq_cuda(
                            *x, *x, scal, ck_in, md if skip else None,
                            symmetric=sym)
                        torch.cuda.synchronize()
                        got[sym, skip] = (w.item(), nz.item())
                err = max(abs(w - ref_w) for w, _ in got.values())
                log(f"fused_wsq {label} ell={ell_v} ck={use_ck}: wsq "
                    f"{ref_w:.6e}, max |err| {err:.3e} (tolerance 1e-4 "
                    f"relative), nnz {ref_n:.0f}; kernel nnz "
                    f"{sorted({nz for _, nz in got.values()})}")
                check(err <= 1e-4 * abs(ref_w),
                      f"fused_wsq disagrees with its plain version: {err}")
                check(all(nz == ref_n for _, nz in got.values()),
                      "fused_wsq nnz differs from the plain version's")
                check(all(got[sym, False] == got[sym, True]
                          for sym in (False, True)),
                      "fused_wsq: tile skip on and off differ")
                if not (label == "fixed" and use_ck and ell_v == p.ell_min):
                    continue
                # the main path's configuration: symmetric, ck, skip
                args = (*x, *x, scal, ck_in, md)
                ms = time_ms(lambda: wsq.fused_wsq_cuda(*args,
                                                        symmetric=True))
                plain_ms = time_ms(lambda: wsq.fused_wsq_plain(*args))
                kept = int(keep.sum().item())
                pairs = kept * tw * tw
                # gated pairs the upper-triangle sweep evaluates
                per_tile = (pair_weights(*x, *x, scal, ck_in) > 0).reshape(
                    nb, tw, nb, tw).sum(dim=(1, 3))
                gated = int(per_tile[upper].sum().item())
                nbytes = (n * 3 + pairs + int(upper.sum().item()) + 8 + 2) * 4
                b_ms, b_by = bound(nbytes, pairs * OPS_PAIR
                                   + gated * OPS_WSQ_GATED)
                log(f"fused_wsq {label} ell={ell_v} ck=True skip=True "
                    f"symmetric: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {b_ms:.4f} ms ({b_by}); upper-triangle tiles "
                    f"kept {kept}/{int(upper.sum().item())}, gated pairs "
                    f"{gated}")
                out["fused_wsq"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, bound_ms=b_ms,
                                        bound_by=b_by, ell=ell_v)
    return out


def fused_bound(counts, x, y, lanes=1):
    """(bound ms, bound_by) of align_fused over the pairs its plain
    version counted (over every lane): each pair the function needs, once
    an iteration (the flow and the line search both come from momT), its
    color kernel recomputed; each lane's clouds and result moved once.
    Resident mode's second sweep over the same pairs is the kernel's
    cost, not the function's, and is not counted."""
    from cvo_rgbd_torch.ops.align_fused import OUT_LEN
    from cvo_rgbd_torch.ops.moments import NUM_MONO

    per_pair = OPS_PAIR + OPS_COLOR
    nops = (counts["pairs"] * per_pair + counts["gated"] * OPS_GATED
            + counts.get("self_pairs", 0) * per_pair
            + counts.get("self_gated", 0) * OPS_WSQ_GATED)
    n, m = x.capacity, y.capacity
    nbytes = ((n + m) * 9 + n * NUM_MONO + OUT_LEN) * 4 * lanes
    return bound(nbytes, nops)


def phase_fused_kernels(cases):
    """The whole-align kernel against its plain version on the card after
    1, 3 and 10 iterations (eps = eps_2 = 0, so each align runs exactly
    max_iter iterations): R, T, ell, omega and v within 1e-5 after 1 and
    3 iterations and 1e-4 after 10.  Each 10-iteration align is timed
    against the plain version and its bound; the kernel line takes the
    first case of each mode.  A case is (mode, params, fixed, moving)."""
    import torch

    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_cuda,
        align_fused_plain,
        fused_mode,
    )
    out = {}
    for mode, base, fixed, moving in cases:
        x, y = kd_sort(fixed), kd_sort(moving)
        label = (f"align_fused {mode} {type(base).__name__} "
                 f"color_mode={base.color_mode} N=M={x.capacity}")
        err = 0.0
        for it in FUSED_ITERS:
            p = dataclasses.replace(base, backend="fused", max_iter=it,
                                    eps=0.0, eps_2=0.0)
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
            err = max(err, worst)
        ms = time_ms(lambda: align_fused_cuda(p, x, y),
                     spin=ALIGN_SPIN_CYCLES)
        plain_ms = time_ms(lambda: align_fused_plain(p, x, y),
                           PLAIN_ALIGN_RUNS, PLAIN_ALIGN_WARMUP)
        b_ms, b_by = fused_bound(counts, x, y)
        log(f"{label} {FUSED_ITERS[-1]} iterations: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); pairs "
            f"{counts['pairs']}, gated {counts['gated']}, self pairs "
            f"{counts.get('self_pairs', 0)}")
        name = f"align_fused_{mode}"
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


def flow_bound(n, m, nnz, use_ck, per_gated, column_ops=0):
    """(bound ms, bound_by) of one sweep of csrc/fused_flow.cu: every
    pair's weight (its color kernel when there is no cache), the gated
    pairs' terms; each plane, the cache and the results moved once."""
    from cvo_rgbd_torch.ops.gram import NFEAT

    nbytes = ((n + m) * (3 + NFEAT + 1) + 8 + 9 + 6) * 4
    nbytes += n * m * 4 if use_ck else 0
    nops = n * m * (OPS_PAIR + (0 if use_ck else OPS_COLOR))
    return bound(nbytes, nops + nnz * per_gated + m * column_ops)


def phase_flow(cases):
    """3d: fused_flow and fused_step_coeffs against their plain versions:
    nnz exact, each other output (omega*c, v*d, sum A d2, sum A, and B,
    C, D, E) within 1e-4 of its magnitude.  A case is (label, params,
    fixed, moving, ck, ell, timed); the kernel line takes the last timed
    case, the main path's (the linear sweep of the finer pcd pair)."""
    import torch

    from cvo_rgbd_torch.ops import flow, gram

    out = {}
    for label, p, x, y, ck, ell, timed in cases:
        dev = x.positions.device
        linear = p.color_mode == "linear"
        scal = gram.scalars(torch.full((), ell, device=dev), p)
        args = (*x, *y, scal)
        got = flow.fused_flow_cuda(*args, ck, linear)
        ref = flow.fused_flow_plain(*args, ck, linear)
        wv = torch.cat([got[0:3] / p.c, got[3:6] / p.d])
        got_s = flow.fused_step_coeffs_cuda(*args, wv, ck, linear)
        ref_s = flow.fused_step_coeffs_plain(*args, wv, ck, linear)
        torch.cuda.synchronize()
        nnz, ref_nnz = got[8].item(), ref[8].item()
        rels = {name: rel_close(got[sl], ref[sl]) for name, sl in (
            ("omega*c", slice(0, 3)), ("v*d", slice(3, 6)),
            ("wsq", slice(6, 7)), ("sum_A", slice(7, 8)))}
        rels.update({name: rel_close(got_s[q], ref_s[q])
                     for q, name in enumerate("BCDE")})
        n, m = x.capacity, y.capacity
        log(f"fused_flow/fused_step_coeffs {label} N={n} M={m} ell={ell}: "
            f"nnz {nnz:.0f} vs {ref_nnz:.0f} (exact), relative errors "
            + ", ".join(f"{k} {v[0]:.2e}" for k, v in rels.items())
            + " (tolerance 1e-4 of each output's magnitude)")
        check(nnz == ref_nnz > 0, f"fused_flow {label}: nnz differs")
        check(all(ok for _, ok in rels.values()),
              f"fused_flow/fused_step_coeffs {label} disagree: {rels}")
        if not timed:
            continue
        ms = time_ms(lambda: flow.fused_flow_cuda(*args, ck, linear))
        plain_ms = time_ms(lambda: flow.fused_flow_plain(*args, ck, linear))
        ms_s = time_ms(lambda: flow.fused_step_coeffs_cuda(*args, wv, ck,
                                                           linear))
        plain_s = time_ms(lambda: flow.fused_step_coeffs_plain(
            *args, wv, ck, linear))
        use_ck = ck is not None
        b = flow_bound(n, m, nnz, use_ck, OPS_FLOW_GATED)
        b_s = flow_bound(n, m, nnz, use_ck, OPS_STEP_GATED, OPS_STEP_COLUMN)
        log(f"fused_flow {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b[0]:.4f} ms ({b[1]}); fused_step_coeffs: {ms_s:.4f} "
            f"ms, plain {plain_s:.4f} ms, bound {b_s[0]:.4f} ms ({b_s[1]})")
        err = (got[:8] - ref[:8]).abs().max().item()
        err_s = (got_s - ref_s).abs().max().item()
        out["fused_flow"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b[0], bound_by=b[1])
        out["fused_step_coeffs"] = dict(max_abs_err=err_s, ms=ms_s,
                                        plain_ms=plain_s, bound_ms=b_s[0],
                                        bound_by=b_s[1])
    return out


def phase_linear_moments(x, y, ci):
    """3e: the linear branch of fused_moments against its plain version
    on a pcd pair: Mom within 1e-4 of each column, nnz exact, tile skip
    on and off the same bits."""
    import torch

    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import gram, moments
    from cvo_rgbd_torch.params import MATLAB_PARAMS

    dev = x.positions.device
    c0, xc, phi = build_moments_pre(x)
    yc = y.positions - c0
    md = aabb_min_d2(*block_bounds(x.positions, x.mask, moments.TILE_I),
                     *block_bounds(y.positions, y.mask, moments.TILE_J))
    for ell in (0.1, 0.03):
        scal = gram.scalars(torch.full((), ell, device=dev), MATLAB_PARAMS)
        args = (xc, x.features, x.mask, yc, y.features, y.mask, phi, scal,
                ci)
        ref, ref_nnz = moments.fused_moments_plain(*args, None, True)
        got = [moments.fused_moments_cuda(*args, skip, True)
               for skip in (None, md)]
        torch.cuda.synchronize()
        colmax = ref.abs().amax(dim=0).clamp_min(1e-30)
        rel = max(((mom - ref).abs() / colmax).max().item()
                  for mom, _ in got)
        nnz = [n.item() for _, n in got]
        ms = time_ms(lambda: moments.fused_moments_cuda(*args, md, True))
        log(f"fused_moments linear N={x.capacity} ell={ell}: Mom err/max|col|"
            f"={rel:.3e} (tolerance 1e-4), nnz {nnz} vs {ref_nnz.item():.0f} "
            f"(exact); {ms:.4f} ms with the skip")
        check(rel <= 1e-4, f"linear fused_moments Mom disagrees: {rel}")
        check(all(v == ref_nnz.item() for v in nnz),
              "linear fused_moments nnz differs")
        check(torch.equal(got[0][0], got[1][0]),
              "linear fused_moments: tile skip on and off differ")


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

    log(f"profile {type(p).__name__} step_mode={p.step_mode} "
        f"N=M={fixed.capacity} ell={ell}: {host_ms:.3f} ms/iteration on the "
        f"host clock, device busy {dev_us / 1e3:.3f} ms/iteration "
        f"({dev_us / 10 / host_ms:.1f}%), of which fused_moments "
        f"{kernel_ms('moments_'):.3f} ms, fused_wsq {kernel_ms('wsq_'):.3f} "
        f"ms, fused_flow {kernel_ms('flow_kernel'):.3f} ms, "
        f"fused_step_coeffs {kernel_ms('step_kernel'):.3f} ms; "
        f"{launches / n_iter:.0f} kernel launches per iteration")


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
    """A main path, with the launch counts read around it."""
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
        return launches
    # the direct step's two sweeps take the place of the moment sweep
    step = ("fused_flow", "fused_step_coeffs") if direct else (
        "fused_moments",)
    used = ("color_gram",) + step + (("fused_wsq",) if adaptive else ())
    for k in used:
        check(launches[k] > 0, f"the {name} main path never launched {k}")
    check(not any(launches[k] for k in KERNELS if k not in used),
          f"the {name} main path launched another kernel: {launches}")
    check(n_fused == 0, f"the {name} main path launched align_fused")
    return launches


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


def phase_batched_fused(sets):
    """8: the 9 pcd pairs at each grid, stacked LANE_REPEAT times, on the
    fused backend through align_batched.  Returns (the batched rows of the
    kernel line, launches by row)."""
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
    p = dataclasses.replace(MATLAB_PARAMS, backend="fused")
    rows, launches = {}, {k: 0 for k in BATCHED}
    for grid in (BATCH_GRID, FINE_GRID):
        padded = pad_clouds(sets[grid], dev)
        n_pairs = len(padded) - 1
        fixed = stack_clouds(padded[:-1], repeat=LANE_REPEAT)
        moving = stack_clouds(padded[1:], repeat=LANE_REPEAT)
        lanes = fixed.positions.shape[0]
        mode = fused_mode(p, fixed, moving)
        label = f"batched fused {mode} grid={grid} N={fixed.capacity}"
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
        ms = time_ms(lambda: align_fused_batched_cuda(q, xs, ys),
                     spin=ALIGN_SPIN_CYCLES)
        t0 = time.perf_counter()
        for k in range(lanes):
            align_fused_plain(q, xs.lane(k), ys.lane(k))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        b_ms, b_by = fused_bound(counts, padded[0], padded[1], lanes)
        log(f"{label} 10 iterations: {ms:.4f} ms for {lanes} lanes "
            f"({ms / lanes:.4f} ms a lane), plain {plain_ms:.1f} ms (lane by "
            f"lane, one run), bound {b_ms:.4f} ms ({b_by})")
        rows[f"align_fused_{mode}_batched"] = dict(
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

    kernels = phase_kernels(c0, c1, p)
    kernels.update(phase_wsq(a0, a1, pa))
    mark("3-3b")

    small_scene = BandScene(*SMALL_SIZE)
    small = [make_frontend(1, SMALL_NUM_WANT, 1)(f[2], f[3])
             for f in render_frames(revisit_path(2, period=33), small_scene)]
    small_a = [make_frontend(1, SMALL_NUM_WANT, 0)(f[2], f[3])
               for f in render_frames(revisit_path(2, period=33),
                                      small_scene)]
    kernels.update(phase_fused_kernels([
        ("tiled", p, c0, c1), ("tiled", pa, a0, a1),
        ("resident", p, *small), ("resident", pa, *small_a),
    ]))
    mark("3c")

    # 3d. the two-pass sweeps: se on the first cvo pair, then linear on the
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
    kernels.update(phase_flow(flow_cases))
    mark("3d")

    # 3e. the linear branches of fused_moments and align_fused
    phase_linear_moments(*lin[FINE_GRID])
    phase_fused_kernels([
        ("tiled", MATLAB_PARAMS, *lin[FINE_GRID][:2]),
        ("resident", MATLAB_PARAMS, *lin[BATCH_GRID][:2]),
    ])
    mark("3e")

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
    for params, adaptive, nw in runs:
        for k, v in phase_odometry(frames, params, adaptive, nw).items():
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

    # 8. batched fused registration of the pcd pairs, 63 lanes a launch
    rows, got = phase_batched_fused(sets)
    kernels.update(rows)
    for k, v in got.items():
        launches[k] += v
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
    rows = []
    for name in KERNELS + FUSED + BATCHED + (PROBE,):
        k = kernels[name]
        src, rep = sources[name]
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
