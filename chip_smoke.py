#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. environment: card name and power limit, pinned fp32 precision, the
   CUDA kernels built from `cvo_rgbd_torch/csrc/` with nvcc;
2. data: a 10-frame `revisit_path` sequence rendered in memory at
   240x320 (`cvo_rgbd_torch.synth`), frontend at num_want=3000
   (capacity 3072), cvo features (RGB) and acvo features (HSV);
3. kernels vs their plain torch versions on the card, on the first pair
   at N=M=3072, with CUDA-event timings: `color_gram` and
   `fused_moments` on the cvo clouds; 3b. `fused_wsq` on the acvo
   clouds' two self-pairs;
4. one reference-scale cvo align at the C++ stops (eps=5e-5,
   eps_2=1e-5) on the kernel backend, a small pair registered on the
   card and on the CPU (plain versions), which must agree, and a
   profile of one iteration; 4b. the same for acvo (`self_mode="exact"`,
   then one align with `"cheb"`);
5. the main paths: `run_odometry_frames` over the rendered sequence for
   cvo, 5b. then for acvo (`adaptive=True`), each with every kernel's
   launch count set to 0 just before and read just after, and the
   trajectory scored (ATE) against the exact ground truth.

The line before last is a JSON object with each kernel's launches on
the two main paths together, its error against the plain version, its
time, the plain version's time and its bound; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import io
import json
import subprocess
import sys
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
KERNELS = ("color_gram", "fused_moments", "fused_wsq")
# the cell: a 10-frame sequence rendered at 240x320, 3000 points a frame
# (capacity 3072); the small pair of the card-vs-CPU checks, 96x128
FRAMES, SIZE, NUM_WANT = 10, (240, 320), 3000
SMALL_SIZE, SMALL_NUM_WANT = (96, 128), 1024
RUNS = 30
WARMUP = 5
# ~0.5 ms of device clock cycles, longer than a wrapper's host overhead
SPIN_CYCLES = 1_000_000


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn):
    """Median over RUNS calls of fn, each between its own CUDA events,
    after WARMUP untimed calls.  A short device-side spin ahead of the
    first event lets the host enqueue fn's launches before the clock
    starts, so a kernel's time is its device time, not the wrapper's
    Python overhead (a plain version that synchronizes still pays it)."""
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


def reset_launches():
    from cvo_rgbd_torch import ops

    for name in KERNELS:
        getattr(ops, name).launches = 0


def read_launches():
    from cvo_rgbd_torch import ops

    return {name: getattr(ops, name).launches for name in KERNELS}


def phase_align(fixed, moving, p, small=None, skew=0.1):
    """A reference-scale align on the kernels, then (given a small pair)
    the small pair on the card and on the CPU (plain versions), which
    must agree: tf within 3e-4 and stopping iterations within `skew` of
    each other.  Returns the launches of the reference-scale align."""
    import torch

    from cvo_rgbd_torch import align

    name = type(p).__name__ + (
        f"(self_mode={p.self_mode!r})" if hasattr(p, "self_mode") else "")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = align(p, fixed, moving)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    it = int(res.iterations.item())
    conv = bool(res.converged.item())
    log(f"align {name} N=M={fixed.capacity}: iterations={it} "
        f"converged={conv} final ell={res.ell.item():.6f} "
        f"{dt * 1e3 / max(it + 1, 1):.3f} ms/iteration, launches {launches}")
    check(conv, "reference-scale align did not converge")
    check(torch.isfinite(res.tf).all().item(), "non-finite tf")
    used = ("color_gram", "fused_moments") + (
        ("fused_wsq",) if hasattr(p, "self_mode") else ())
    check(all(launches[k] > 0 for k in used),
          "align did not launch its kernels")
    if small is None:
        return launches

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
    return launches


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

    log(f"profile {type(p).__name__} N=M={fixed.capacity} ell={ell}: "
        f"{host_ms:.3f} ms/iteration on the host clock, device busy "
        f"{dev_us / 1e3:.3f} ms/iteration ({dev_us / 10 / host_ms:.1f}%), "
        f"of which fused_moments {kernel_ms('moments_'):.3f} ms, fused_wsq "
        f"{kernel_ms('wsq_'):.3f} ms; {launches / n_iter:.0f} kernel "
        f"launches per iteration")


def phase_odometry(frames, p, adaptive):
    """A main path, with the launch counts read around it."""
    import numpy as np
    import torch

    from cvo_rgbd_torch.evaluation import ate_rmse
    from cvo_rgbd_torch.io.tum import parse_trajectory
    from cvo_rgbd_torch.odometry import run_odometry_frames

    name = "acvo" if adaptive else "cvo"
    traj = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    recs = run_odometry_frames(
        ((i, nm, rgb, dep) for i, nm, rgb, dep, _ in frames), 1,
        adaptive=adaptive, params=p, traj=traj, num_want=NUM_WANT,
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
    used = KERNELS if adaptive else KERNELS[:2]
    for k in used:
        check(launches[k] > 0, f"the {name} main path never launched {k}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from cvo_rgbd_torch.device import pin_fp32
    from cvo_rgbd_torch.frontend import make_frontend
    from cvo_rgbd_torch.ops import _build
    from cvo_rgbd_torch.params import AcvoParams, CvoParams
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
    frames = list(render_frames(revisit_path(FRAMES, period=33),
                                BandScene(*SIZE)))
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
    kernels = phase_kernels(c0, c1, p)
    kernels.update(phase_wsq(a0, a1, pa))

    small_scene = BandScene(*SMALL_SIZE)
    small = [make_frontend(1, SMALL_NUM_WANT, 1)(f[2], f[3])
             for f in render_frames(revisit_path(2, period=33), small_scene)]
    phase_align(c0, c1, p, small)
    phase_profile(c0, c1, p)

    small_a = [make_frontend(1, SMALL_NUM_WANT, 0)(f[2], f[3])
               for f in render_frames(revisit_path(2, period=33),
                                      small_scene)]
    # acvo's tail at the C++ stops is slower still: on this pair the
    # plain versions stopped at 146 and at 170 iterations under two CPU
    # builds of torch, tf within 1e-4 of each other
    phase_align(a0, a1, pa, small_a, skew=0.25)
    phase_align(a0, a1, dataclasses.replace(pa, self_mode="cheb"))
    phase_profile(a0, a1, pa)

    launches = {k: 0 for k in KERNELS}
    for params, adaptive in ((p, False), (pa, True)):
        for k, v in phase_odometry(frames, params, adaptive).items():
            launches[k] += v

    sources = {
        "color_gram": ("cvo_rgbd_torch/csrc/color_gram.cu",
                       "cvo_rgbd_tpu/ops/pallas_gram.py:401"),
        "fused_moments": ("cvo_rgbd_torch/csrc/fused_moments.cu",
                          "cvo_rgbd_tpu/ops/pallas_moments.py:199"),
        "fused_wsq": ("cvo_rgbd_torch/csrc/fused_wsq.cu",
                      "cvo_rgbd_tpu/ops/pallas_moments.py:320"),
    }
    rows = []
    for name in KERNELS:
        k = kernels[name]
        src, rep = sources[name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
