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
   profile of one align; 4d. `align_jit` (the kernel backend's loop
   captured as CUDA graphs of 8 iterations, `core/compiled.py`) against
   `align` on cvo, acvo exact and cheb and the direct step at 3072 and
   linear at 2816: every field the eager bits, one replay a block of 8
   iterations started, the eager launches, host ms an iteration of
   both, the captures' seconds and bytes; three pairs through one
   compiled align, a 100-iteration cap (the tail graph of 4) and the
   device busy share of one replayed align;
5. the main paths: `run_odometry_frames` over the rendered sequence for
   cvo, 5b. then for acvo (`adaptive=True`), 5c. then for both on the
   fused backend at capacity 3072 (tiled) and 1024 (resident), 5d. then
   for both on the kernel backend with `step_mode="direct"` (`fused_flow`
   and `fused_step_coeffs` in place of `fused_moments`), each with every
   kernel's launch count set to 0 just before and read just after, and
   the trajectory scored (ATE) against the exact ground truth.  Every
   pair goes through `align_jit` (graph replays on the kernel backend).
   The fused runs must launch `align_fused` once a pair and none of the
   per-iteration kernels; 5e. `cli run`'s per-frame work outside align
   at TUM's 480x640 (FRONTEND_FRAMES frames as the PNG loader gives
   them, num_want 3000): the drivers' frontend (one captured program, a
   graph replay a frame) against `_process` op by op, every frame's
   SHA-1, ms and host launches a frame of both; the odometry step's
   bookkeeping compiled against its eager ops, bits and ms a pair; and
   `run_odometry_frames` cvo and acvo on the kernel and the fused
   backend, one frontend replay a frame and one bookkeeping replay a
   pair, frames/s, the trajectory that of the same run with the
   frontend op by op;
6. the MATLAB path on the pcd files at both grids: `cli batch` (kernel
   backend: `fused_moments`, never `color_gram`), `run_batch` on the
   fused backend (`align_fused` once a pair) and with
   `step_mode="direct"` (`fused_flow` and `fused_step_coeffs` each
   iteration), each pair through `align_jit`, each scored against the
   exact relative ground truth; one
   small linear pair on the card and on the CPU; `cli stitch`.  3d and
   3e take the linear pairs at the batch's capacity for the grid;
7. the construct probes: `python -m cvo_rgbd_torch.probes` (its `main`)
   with the launch counts read around it, then each toy case of
   `csrc/construct_probe.cu` against its plain version (exact; e within
   1e-6 relative) and its closed form on the scripts' inputs, each
   timed, and on the seeded inputs of seeds 0 and 1 (and d and e with
   the guard off: zeros): a, b, b2, c, d, k exact, e, h, i, j within
   `probes.tolerance`; the library calls of e and h timed beside; and
   the four tiled aligns against `align_fused_plain(mode="tiled")`
   (equal iterations, tf within 1e-5);
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
   backend (cvo and acvo: one `color_gram` launch a batch, three for
   acvo, the batch as one compiled loop with one `fused_moments` launch
   a batch iteration and, for acvo, one `fused_wsq` launch a batch
   iteration, the trajectory the cold sequential run's, pose for pose),
   each against `run_odometry_frames(warm_start=False)` in the same run,
   and `run_multiseq` over the render written as a TUM folder and a
   2-frame prefix of it (ragged lanes), each lane against its solo run;
   8c. `color_gram` with a lane axis at 8b's batch (9 x 3072) and at 8's
   (63 x 384): one launch against its plain version and every lane the
   bits of the one-pair launch, timed beside the B one-pair launches;
   8d. `fused_moments` with a lane axis at the same two batches (8's
   lanes in MATLAB's linear mode), in the fast form at 8b's and at 8b's
   with ell 0.1 on every lane (the most tiles kept): one
   launch against its plain version lane by lane, every lane the bits of
   the one-pair launch, a frozen lane not swept, timed beside the B
   one-pair launches; 8f. `fused_wsq` with a lane axis (row 3b): exact
   acvo's two self-sweeps of every lane at 8b's batch (precise, fast,
   and at ell 0.1 on every lane) and at 8's (63 x 384), and 8b's
   Chebyshev tables (9 lanes x 24
   sweeps): one launch against its plain version, every lane the bits
   of its one-pair launch, a frozen lane not swept, timed beside the B
   one-pair launches, with the 63-lane launch's fixed cost (no lane
   live, one lane live); 8e. `align_batched` as one compiled loop a
   batch, at 8b's batch (kernel cvo, exact and cheb acvo, fast cvo;
   dense cvo and exact acvo at the MATLAB stops) and at 8's (linear on
   the kernel and the dense backend): one `fused_moments` launch a batch
   iteration, exact acvo one `fused_wsq` launch a batch iteration (cheb
   one a batch), the dense runs none, every lane the bits of
   `align_jit` on its pair, pairs/s against the pairs one by one, the
   dense batches' peak device memory;
9. keyframe SLAM over a 40-frame path along the optical axis and back
   (`synth.depth_loop_path`), written as .pcd: `python -m
   cvo_rgbd_torch.cli slam` (MATLAB_PARAMS, kernel backend, its aligns
   through `align_jit`) with its
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
   9b. `cli slam`'s work outside align as captured programs (the JAX
   package's jitted forms; `core.compiled`), on phase 9's clouds at the
   0.05 m grid: a KeyframeSlam run on the kernel backend records every
   align; for each, the self and cross inner products, `cloud_ok` and
   the SLAM step's program have the SHA-1 of their functions op by op;
   `process` over the frames with the aligns answered from the record,
   compiled and op by op: the same keyframes, loop closures, poses and
   self products, host ms and launches a frame of each; each
   loop-closure search's scores and post-align inner products the op
   by op bits; `posegraph.optimize` dense and PCG on the keyframe graph
   against the eager loop (2e-4, costs 1e-3; the bits where every
   scatter-add sum is order-free), first call (capture included), later
   call and eager ms; multiseq's lane post on a 4-lane batch the eager
   bits; the slam s/frame through the compiled path on the kernel and
   fused backends;

10. the rest of `cli run` and `cli slam`: the native PNG loader,
   `--profile-dir`, `align_trace`, `cli slam --refine` (its `ba_solve`
   one captured GN iteration replayed, against the CPU's solve and
   against the eager loop on the card, ms at its first call, a later
   call and eager);
11. the mesh paths (`cvo_rgbd_torch.parallel`): 11a. `color_gram`
   [N/2, M], `fused_moments` [N/2, M] with the cache and [N/2, M/2]
   without, `fused_wsq` cross [N/2, N] and [N/2, N/2] on the first
   render pair at 3072, each against its plain version and timed, the
   row blocks' moments and self-sweeps summed against the whole cloud's
   launch; 11b. two ranks on the one card over gloo (`parallel.mesh.
   launch`): `align_sharded` and `align_ring`, cvo and acvo, at the C++
   stops and after 10 iterations, against the single-device `align` on
   the card, and `align_sharded` with MATLAB_PARAMS on the 2816 pcd pair;
   11c. four ranks, dp=2 x sp=2: `train_step_2d` on two render pairs,
   `align_batched(mesh=)` on the pcd pairs at both grids (every lane the
   unsharded launch's bits), `run_multiseq(mesh=)` on the render and a
   2-frame prefix (the unsharded run's files), `optimize(mesh=)` and
   `ba_solve(mesh=)` over 4 ranks on phase 10e's SLAM problem; 11d. one
   rank over NCCL, `align_sharded` at sp=1.  Every mesh path runs
   compiled (`core.compiled.run_mesh`, `CapturedLoop`); 11e holds the
   compiled forms to their eager loops on the same ranks: on the filled
   render over 2 gloo ranks sharded cvo and acvo and ring cvo (the
   SHA-1 of tf, iterations and ell; host ms an iteration, graph
   segments, replays and collective calls an iteration, both forms), at
   4 ranks `optimize(mesh=)` and `ba_solve(mesh=)` (2e-4 / 1e-4, costs
   1e-3, optimize's bits where every shard's scatter-adds are
   order-free; ms first call, later, eager), on 1 NCCL rank sharded cvo
   as one graph a block beside its eager loop and `align_jit`, and on 2
   NCCL ranks a card each where the host has two cards.  Every rank
   must launch the kernels of its path; their launches join the kernel
   line;
12. degraded input and the rotation orbit (`synth.Degradation`,
   `synth.linear_orbit_path`): 12a. tests/test_degradation.py's
   sequence on the kernel backend: `run_odometry` over 13 frames fails
   exactly the two pairs of the dropped frame and carries frame 9's
   pose, the low-texture frame keeps the refill's quota, a cloud
   poisoned with NaN fails its two pairs (this run caps max_iter at
   100: a NaN pair runs to the cap) and the pairs after it converge,
   `run_odometry_batched(batch=4)` on the fused backend fails the same
   pairs with and without `motion_prior`, `run_multiseq` over the
   degraded and a clean folder logs skips for the degraded lane alone,
   and `KeyframeSlam` fed the dropped frame first seeds on the next;
   12b. bench.py's degraded sequence (100 frames) on the fused backend,
   resident: failed pairs {50, 51}, ATE < 0.08 m, frames/s logged, and
   its first 25 frames' pairs replayed on the card from the CPU's plain
   loop (`cvo_rgbd_torch.stop_skew`): equal stops agree in tf; 12c.
   tests/test_odometry_rotation.py's orbit, cvo and acvo on the kernel
   backend at the C++ stops, within that test's ATE and rotation
   bounds; 12d. `cli generate-pointclouds`, `registered-cloud` along
   12b's estimated trajectory, `plot-trajectory` and `associate` on
   12b's folder, their files and lines checked.

The line before last is a JSON object with each kernel's launches on
the main paths together, its error against the plain version, its
time, the plain version's time and its bound (the batched rows of
`align_fused`: a 63-lane launch of exactly 10 iterations, and their
launches those of phases 8 and 8b; `color_gram_batched`: 8c's 9 x 3072
batch, its launches those of the kernel backend's batched drivers in 8b,
8e and 12a; `fused_moments_batched`: 8d's 9 x 3072 batch, its launches
those of the same runs, one a batch iteration, which `fused_moments`'s
row no longer counts; `fused_wsq_batched`: 8f's 9 x 3072 batch, its
launches those of the kernel backend's acvo batches in 8b and 8e, which
`fused_wsq`'s row no longer counts; the "<kernel>/fast" rows: phase 3f,
each max_abs_err the worst of every case it checks, their launches
those of phase 9's fast runs); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
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
# color_gram on a lane axis (align_batched's kernel lanes, one launch a
# cache a batch): its row's launches are those of phases 8b and 12a
LANE_GRAM = "color_gram_batched"
# fused_moments on a lane axis (the kernel backend's batched loop, one
# launch a batch an iteration): its launches are counted apart from the
# one-pair launches (`fused_moments.lanes`), those of phases 8b and 12a
LANE_MOM = "fused_moments_batched"
# fused_wsq on a lane axis (exact acvo's self-sweeps of a batch an
# iteration, a batch's Chebyshev tables): its launches are those of the
# kernel backend's acvo batches, which count in `fused_wsq.launches`
LANE_WSQ = "fused_wsq_batched"
# 8e's dense batches run at the MATLAB stops: at the C++ stops exact
# acvo's three [9, 3072, 3072] Grams an iteration take the script's time
DENSE_STOPS = dict(eps=5e-4, eps_2=1e-4)
# the exp_mode="fast" forms, one row each (color_gram has none)
FAST = tuple(f"{k}/fast" for k in KERNELS[1:] + FUSED)
FUSED_ITERS = (1, 3, 10)
# capacity of the resident-mode odometry run: N = M = 1024 is within
# both resident budgets (cvo N*M <= 2^20, acvo N*M + N^2 + M^2 <= 3*2^20)
RESIDENT_NUM_WANT = 1024
# the cell: a 10-frame sequence rendered at 240x320, 3000 points a frame
# (capacity 3072); the small pair of the card-vs-CPU checks, 96x128
FRAMES, SIZE, NUM_WANT = 10, (240, 320), 3000
# phase 5e: `cli run` at TUM's image shape (camera 1 is fr1's)
FRONTEND_FRAMES, FRONTEND_SIZE = 6, (480, 640)
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
# phase 11: the mesh paths' sp (rows per block N/sp of the render pair)
MESH_SP = 2
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
# phase 7's seeded inputs of the probes: (label, seed, guard off), the
# guard off only for the cases that have one
PROBE_SEEDED = (("seed 0", 0, False), ("seed 1", 1, False),
                ("guard off", 0, True))
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
# phase 12a: tests/test_degradation.py's sequence (24 frames of
# revisit_path, 512 points, MATLAB stops); the drivers' runs take the
# frames up to DEG_MAX_FRAMES, the NaN run up to DEG_NAN_FRAMES.  A NaN
# pair runs to max_iter (2000, the same in JAX): at the kernel backend's
# host launches that is minutes a pair, so the NaN run caps it
DEG_FRAMES, DEG_NUM_WANT, DEG_MAX_FRAMES = 24, 512, 13
DEG_DROP, DEG_LOW_TEXTURE, DEG_NAN, DEG_NAN_FRAMES = 10, 6, 3, 7
DEG_NAN_MAX_ITER = 100
DEG_BATCH = 4
# the selector's refill takes one pixel an 8x8 block: 192 on 96x128
DEG_REFILL_BLOCKS = (96 // 8) * (128 // 8)
# phase 12b: bench.py's bench_degraded (100 frames, low texture every 25
# from 12, total dropout at 50, 1024 points: resident on the fused
# backend)
BENCH_DEG_FRAMES, BENCH_DEG_DROP, BENCH_DEG_NUM_WANT = 100, 50, 1024
# its first frames replayed (`cvo_rgbd_torch.stop_skew`): the CPU's plain
# loop, each pair aligned again on the card from the CPU loop's inputs;
# of its aligned pairs at least REPLAY_EQUAL_SHARE stop alike, those
# within REPLAY_TF_TOL in tf (median REPLAY_TF_MEDIAN), and the card's
# transforms put in at every pair move the ATE by at most REPLAY_ATE_TOL
# m (over all 100 frames: 80 of 97 alike, 4.6e-4 at most, median 3.6e-7,
# ATE 1.3e-4 m; PERF.md)
REPLAY_FRAMES, REPLAY_EQUAL_SHARE = 25, 0.75
REPLAY_TF_TOL, REPLAY_TF_MEDIAN, REPLAY_ATE_TOL = 1e-3, 1e-5, 1e-3
# phase 12c: tests/test_odometry_rotation.py's orbit and its bounds,
# (ATE m, largest rotation error mrad) for cvo and for acvo
ORBIT_FRAMES, ORBIT_NUM_WANT = 6, 1024
ORBIT_BOUNDS = {False: (0.015, 25.0), True: (0.02, 30.0)}


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
    jit0 = jit_counts()
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
    calls, replays, _ = (b - a for a, b in zip(jit0, jit_counts()))
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
        f"(identity: mean {np.mean(motion):.5f} m), launches {launches}; "
        f"align_jit calls {calls}, replays {replays}")
    fused = params is not None and params.backend == "fused"
    check(calls == len(gt) and (replays == 0) == fused,
          f"batch {label}: align_jit calls {calls}, replays {replays}")
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
    total = {k: 0 for k in KERNELS + FUSED + (LANE_MOM, PROBE)}
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
    ops.fused_moments.lanes.launches = 0
    probes.construct_probe.launches = 0


def read_launches():
    from cvo_rgbd_torch import ops, probes

    out = {name: getattr(ops, name).launches
           for name in KERNELS + ("align_fused",)}
    out[LANE_MOM] = ops.fused_moments.lanes.launches
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


def jit_counts():
    """(calls, replays, warm-up iterations) of `align_jit` so far: its
    calls, its graph replays (host launches of the captured align
    blocks), and the iterations its captures ran eagerly first."""
    from cvo_rgbd_torch.core import compiled

    return (compiled.align_jit.calls, compiled.align_jit.replays,
            compiled.align_jit.warmups)


def compiled_for(p, fixed, moving):
    """The compiled align `align_jit` built last for `p` and these
    capacities."""
    from cvo_rgbd_torch.core import compiled

    objs = [v for k, v in compiled.CACHE.items()
            if k[0] == p and k[1:3] == (fixed.capacity, moving.capacity)]
    check(objs, f"no compiled align for {p.backend} {fixed.capacity}")
    return objs[-1]


def phase_align_jit(cases, pairs, p):
    """4d. `align_jit` (the align loop as CUDA graphs, one replay a block
    of 8 iterations) against `align` on the card.  Each case: an eager
    `align`, a first `align_jit` (capture included) and a second one,
    every field of both the eager bits, replays = ceil(iterations / 8),
    the second call's kernel launches those of the eager align; host ms
    an iteration of both, replays and kernel launches an iteration, the
    capture's seconds and the card's allocated and reserved bytes
    across it.  Then three pairs through one compiled align (the first
    result unchanged after the third), a 100-iteration cap on an align
    that cannot stop (the block 12 times, then the tail graph of 4), and
    the device busy share of one replayed align from a profile."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from cvo_rgbd_torch import align, align_jit
    from cvo_rgbd_torch.core import compiled

    def run(fn):
        torch.cuda.synchronize()
        reset_launches()
        r0 = jit_counts()[1]
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0, jit_counts()[1] - r0,
                read_launches())

    def same(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in a._fields)

    for name, q, x, y in cases:
        ref, dt_e, _, l_e = run(lambda: align(q, x, y))
        first, dt_1, _, _ = run(lambda: align_jit(q, x, y))
        got, dt_j, reps, l_j = run(lambda: align_jit(q, x, y))
        k = int(got.iterations) + 1
        caps = compiled_for(q, x, y).captures
        kern = sum(l_j[n] for n in KERNELS)
        log(f"align_jit {name} N={x.capacity} M={y.capacity}: {k} "
            f"iterations, the bits of align {same(got, ref)} (first call "
            f"{same(first, ref)}); host ms/iteration eager "
            f"{dt_e * 1e3 / k:.3f}, compiled {dt_j * 1e3 / k:.3f} (first "
            f"call with capture {dt_1:.3f} s); replays {reps} "
            f"({reps / k:.4f} an iteration), kernel launches "
            f"{kern / k:.3f} an iteration {l_j} (eager {l_e}); captures "
            f"{caps}")
        check(same(got, ref) and same(first, ref),
              f"align_jit {name}: not the bits of align")
        check(reps == math.ceil(k / 8),
              f"align_jit {name}: {reps} replays for {k} iterations")
        check(l_j == l_e, f"align_jit {name}: launches {l_j}, align {l_e}")

    # three pairs through one compiled align: fresh results
    q = dataclasses.replace(p, max_iter=48)
    refs = [align(q, *pr) for pr in pairs]
    got = [align_jit(q, *pairs[0])]
    kept = [t.clone() for t in got[0]]
    got += [align_jit(q, *pr) for pr in pairs[1:]]
    n_obj = sum(1 for k in compiled.CACHE if k[0] == q)
    alias = all(torch.equal(a, b) for a, b in zip(got[0], kept))
    log(f"align_jit: 3 pairs through {n_obj} compiled align, each the bits "
        f"of align {[same(a, b) for a, b in zip(got, refs)]}, the first "
        f"unchanged after the third {alias}")
    check(n_obj == 1 and alias and all(same(a, b) for a, b in zip(got, refs)),
          "align_jit: three pairs through one compiled align")

    # the cap: 100 iterations that cannot stop, 12 blocks and the tail
    q = dataclasses.replace(p, max_iter=100, eps=0.0, eps_2=0.0)
    x, y = pairs[0]
    ref = align(q, x, y)
    got, dt_1, reps, _ = run(lambda: align_jit(q, x, y))
    graphs = sorted(compiled_for(q, x, y).graphs)
    log(f"align_jit cap 100: iterations {int(got.iterations) + 1}, "
        f"converged {bool(got.converged)}, the bits of align "
        f"{same(got, ref)}, replays {reps}, graphs of {graphs} iterations, "
        f"{dt_1:.3f} s with both captures")
    check(int(got.iterations) == 99 and not bool(got.converged)
          and same(got, ref) and reps == 13 and graphs == [4, 8],
          "align_jit: the 100-iteration cap")

    # the device's busy share of one replayed align (graphs built)
    x, y = pairs[0]
    align_jit(p, x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = align_jit(p, x, y)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    gpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in gpu) / 1e3
    keys = {e.key: e.count for e in prof.key_averages()
            if e.key.startswith(("cudaGraphLaunch", "cudaLaunch"))}
    log(f"align_jit profile cvo N={x.capacity}: {int(res.iterations) + 1} "
        f"iterations, {host_ms:.3f} ms host, device busy {dev_ms:.3f} ms "
        f"({100 * dev_ms / host_ms:.1f}%) over {len(gpu)} device events; "
        f"host launch calls {keys}")


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
    jit0 = jit_counts()
    t0 = time.perf_counter()
    recs = run_odometry_frames(
        ((i, nm, rgb, dep) for i, nm, rgb, dep, _ in frames), 1,
        adaptive=adaptive, params=p, traj=traj, num_want=num_want,
        log=lambda *a: None,
    )
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    calls, replays, _ = (b - a for a, b in zip(jit0, jit_counts()))
    est = parse_trajectory(traj.getvalue().splitlines())
    gt = {float(nm): pose for _, nm, _, _, pose in frames}
    ate = ate_rmse(gt, est)["rmse"]
    failed = sum(r.failed for r in recs)
    iters = [r.iterations for r in recs]
    log(f"odometry {name}: {len(recs)} pairs, {failed} failed, "
        f"{len(recs) / dt:.3f} frames/s, iterations {iters}, "
        f"all converged {all(r.converged for r in recs)}, ATE {ate:.5f} m, "
        f"launches {launches}; align_jit calls {calls}, replays {replays}")
    # every pair through align_jit: graph replays on the kernel backend,
    # align's route on the fused one
    check(calls == len(recs) and (replays == 0) == (p.backend == "fused"),
          f"{name}: align_jit calls {calls}, replays {replays}")
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


def _eager_processor(feature_type, num_want=NUM_WANT):
    """The frontend op by op on the card: `_process` after a host-side
    float32 conversion and a pageable copy (the processor's form before
    it was one captured program)."""
    import torch

    from cvo_rgbd_torch.frontend.camera import get_camera
    from cvo_rgbd_torch.frontend.pipeline import _process

    def frontend(rgb, dep):
        f32 = torch.float32
        return _process(torch.as_tensor(rgb, dtype=f32).cuda(),
                        torch.as_tensor(dep, dtype=f32).cuda(),
                        cam=get_camera(1), num_want=num_want,
                        feature_type=feature_type, dep_thres=20000.0,
                        pot=3)

    return frontend


def _api_calls(fn):
    """The host's calls that put work on the card during fn (kernel and
    graph launches, copies), from a torch.profiler window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.key.startswith(("cudaLaunch", "cudaGraphLaunch",
                                 "cudaMemcpy", "cudaMemset"))}


def phase_frontend_jit(p, pa, pf, paf):
    """5e. `cli run`'s per-frame work outside align, compiled, at TUM's
    480x640 (`synth.BandScene`; camera 1 holds fr1's intrinsics):
    FRONTEND_FRAMES frames as the PNG loader gives them (uint8 RGB,
    uint16 depth), num_want 3000.  For cvo (feature type 1) and acvo
    (0) features: every frame's cloud from the drivers' processor has
    the SHA-1 of `_process` op by op; ms a frame (the call's return and,
    synchronized, its end; PhaseTimer) and the host's launches a frame
    of both forms, the compiled one a graph replay a frame.  Then the
    odometry step's bookkeeping on the first pair: the eager ops against
    the compiled `_odom_step` (`align_jit` answering at once), their
    bits and ms a pair.  Then `run_odometry_frames` over the frames,
    cvo and acvo on the kernel and the fused backend (3072, tiled): one
    frontend replay a frame and one bookkeeping replay a pair, frames/s,
    and the trajectory line for line that of the same run with the
    frontend op by op.  Returns the launches of the compiled runs by
    kernel line row."""
    import hashlib

    import numpy as np
    import torch

    from cvo_rgbd_torch import odometry
    from cvo_rgbd_torch.evaluation import ate_rmse
    from cvo_rgbd_torch.frontend import make_frontend
    from cvo_rgbd_torch.io.tum import parse_trajectory
    from cvo_rgbd_torch.synth import BandScene, render_frames, revisit_path
    from cvo_rgbd_torch.utils.timing import PhaseTimer

    t0 = time.perf_counter()
    frames = [(i, nm, rgb.astype(np.uint8), dep.astype(np.uint16), pose)
              for i, nm, rgb, dep, pose in render_frames(
                  revisit_path(FRONTEND_FRAMES, period=33),
                  BandScene(*FRONTEND_SIZE))]
    log(f"5e: rendered {len(frames)} frames at {FRONTEND_SIZE[0]}x"
        f"{FRONTEND_SIZE[1]} in {time.perf_counter() - t0:.2f} s")

    def sha1s(cloud):
        return [hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()
                for t in cloud]

    first = {}
    for ft in (1, 0):
        fe = make_frontend(1, NUM_WANT, ft, device="cuda")
        eager = _eager_processor(ft)
        for i, _, rgb, dep, _ in frames:
            got, ref = fe(rgb, dep), eager(rgb, dep)
            check(sha1s(got) == sha1s(ref), f"5e: frame {i}'s compiled "
                  f"cloud (feature type {ft}) is not _process's")
            first.setdefault(ft, []).append(got)
        timer = PhaseTimer()
        for _ in range(3):
            for name, fn in (("compiled", fe), ("eager", eager)):
                for _, _, rgb, dep, _ in frames:
                    torch.cuda.synchronize()
                    with timer.phase(f"{name} host"):
                        out = fn(rgb, dep)
                    timer.sync_point(f"{name} wait", out)
        times = {k: v["mean_ms"] for k, v in timer.report().items()}
        replays = fe.replays
        calls = {name: _api_calls(lambda fn=fn: [
            fn(f[2], f[3]) for f in frames])
            for name, fn in (("compiled", fe), ("eager", eager))}
        reps = fe.replays - replays
        per = {k: sum(v.values()) / len(frames) for k, v in calls.items()}
        host = {k: times[f"{k} host"] for k in ("compiled", "eager")}
        wall = {k: host[k] + times[f"{k} wait"] for k in host}
        log(f"5e frontend feature type {ft} at {FRONTEND_SIZE[0]}x"
            f"{FRONTEND_SIZE[1]}, {NUM_WANT} points: every frame the bits "
            f"of _process; ms a frame, host (to return) compiled "
            f"{host['compiled']:.4f}, eager {host['eager']:.4f}; to the end "
            f"of the frame compiled {wall['compiled']:.4f}, eager "
            f"{wall['eager']:.4f}; host launches a frame compiled "
            f"{per['compiled']:.2f} {calls['compiled']}, eager "
            f"{per['eager']:.2f} {calls['eager']}; replays {reps} for "
            f"{len(frames)} frames; programs {len(fe.programs)}")
        check(reps == len(frames) and calls["compiled"].get(
            "cudaGraphLaunch") == len(frames)
            and not calls["compiled"].get("cudaLaunchKernel"),
            f"5e: the compiled frontend is not one replay a frame: {reps} "
            f"replays, {calls['compiled']}")

    # the step's bookkeeping on the first pair
    x, y = first[1][:2]
    warm = (torch.eye(3, device="cuda"), torch.zeros(3, device="cuda"),
            torch.full((), p.ell_init, device="cuda"))
    res = odometry.align_jit(p, x, y, *warm)
    real = odometry.align_jit
    odometry.align_jit = lambda *a, **k: res
    try:
        def compiled_step():
            return odometry._odom_step(p, False, x, y, warm, 64, "cuda")

        def eager_step():
            return odometry._bookkeeping(
                p, False, 64, res.tf, res.R, res.T, res.ell,
                res.iterations, res.converged, x.positions, x.mask,
                y.positions, y.mask)

        packed, nxt = compiled_step()
        flat = eager_step()
        same = torch.equal(packed, flat[:19]) and all(
            torch.equal(a, b) for a, b in zip(
                nxt, (flat[32:41].view(3, 3), flat[48:51], flat[64])))
        step_ms = {}
        for name, fn in (("compiled", compiled_step), ("eager", eager_step)):
            step_ms[name] = time_host(fn)
        step_calls = {name: sum(_api_calls(fn).values())
                      for name, fn in (("compiled", compiled_step),
                                       ("eager", eager_step))}
    finally:
        odometry.align_jit = real
    log(f"5e step bookkeeping, cvo kernel pair: the eager bits {same}; ms "
        f"a pair compiled {step_ms['compiled']:.4f}, eager "
        f"{step_ms['eager']:.4f}; host launches compiled "
        f"{step_calls['compiled']}, eager {step_calls['eager']}")
    check(same, "5e: the compiled bookkeeping is not the eager bits")

    launches = {k: 0 for k in KERNELS + FUSED}
    gt = {float(nm): pose for _, nm, _, _, pose in frames}
    for q, adaptive in ((p, False), (pa, True), (pf, False), (paf, True)):
        name = ("acvo" if adaptive else "cvo") + f" {q.backend}"
        fe = make_frontend(1, NUM_WANT, 0 if adaptive else 1,
                           device="cuda")

        def run():
            traj = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs = odometry.run_odometry_frames(
                ((i, nm, rgb, dep) for i, nm, rgb, dep, _ in frames), 1,
                adaptive=adaptive, params=q, traj=traj, num_want=NUM_WANT,
                log=lambda *a: None)
            torch.cuda.synchronize()
            return traj.getvalue(), recs, time.perf_counter() - t0

        steps0 = sum(v.runs for v in odometry.STEP_CACHE.values())
        replays = fe.replays
        reset_launches()
        traj, recs, dt = run()
        got = read_launches()
        steps = sum(v.runs for v in odometry.STEP_CACHE.values()) - steps0
        replays = fe.replays - replays
        real = odometry.make_frontend
        odometry.make_frontend = lambda *a, **k: _eager_processor(
            0 if adaptive else 1)
        try:
            ref, _, dt_e = run()
        finally:
            odometry.make_frontend = real
        ate = ate_rmse(gt, parse_trajectory(traj.splitlines()))["rmse"]
        n = len(recs)
        log(f"5e odometry {name} at {FRONTEND_SIZE[0]}x{FRONTEND_SIZE[1]}: "
            f"{n} pairs, failed {sum(r.failed for r in recs)}, converged "
            f"{all(r.converged for r in recs)}, iterations "
            f"{[r.iterations for r in recs]}, {n / dt:.3f} frames/s "
            f"(frontend op by op {n / dt_e:.3f}), ATE {ate:.5f} m, the "
            f"eager frontend's trajectory {traj == ref}; frontend replays "
            f"{replays}, bookkeeping replays {steps}; launches {got}")
        check(traj == ref, f"5e {name}: the trajectory is not the eager "
              "frontend's")
        check(n == len(frames) - 1 and not any(r.failed for r in recs)
              and all(r.converged for r in recs),
              f"5e {name}: a pair failed or did not converge")
        check(replays == len(frames) and steps == n,
              f"5e {name}: frontend replays {replays}, bookkeeping "
              f"replays {steps}")
        if q.backend == "fused":
            check(got["align_fused"] == n, f"5e {name}: launches {got}")
            launches["align_fused_tiled"] += got["align_fused"]
        else:
            check(got["color_gram"] and got["fused_moments"],
                  f"5e {name}: launches {got}")
            for k in KERNELS:
                launches[k] += got[k]
    return launches


def time_host(fn, runs=RUNS):
    """Median ms of fn to its end (synchronized) on the host clock."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return median(times)


def phase_probes():
    """7: the probes' entry point as a user runs it, with the launch
    counts read around it; then each toy case against its plain version
    and its closed form, timed, and on seeded inputs against its plain
    version; the library calls of e and h; and the tiled aligns against
    the plain version.  The row's max_abs_err is the scripts' inputs'
    (the seeded errors are logged).  Returns (the probe kernel's row,
    the entry point's launches)."""
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
        seeded = []
        for label, seed, off in PROBE_SEEDED:
            if off and case not in probes.GUARDED:
                continue
            s_ins = probes.seeded_inputs(
                case, dev, seed, probes.GUARD_OFF if off else 0.0)
            s_got = probes.construct_probe_cuda(case, *s_ins)
            s_ref = probes.construct_probe_plain(case, *s_ins)
            torch.cuda.synchronize()
            s_err = (s_got - s_ref).abs().max().item()
            if case in probes.EXACT:
                check(torch.equal(s_got, s_ref), f"probe {case} {label}: "
                      f"kernel and plain version differ by {s_err}")
            else:
                check(probes.within_tolerance(case, s_got, s_ref, s_ins),
                      f"probe {case} {label}: kernel and plain version "
                      f"differ by {s_err}, past probes.tolerance")
            if off:
                check(not s_got.any(), f"probe {case} {label}: not zeros")
            seeded.append(f"{label} {s_err:.3e}")
        log(f"probe {case} seeded: max |kernel - plain| "
            + ", ".join(seeded) + (" (exact)" if case in probes.EXACT
                                   else " (within probes.tolerance)"))
        err = max(err, e)
        ms_sum, plain_sum, bound_sum = (ms_sum + ms, plain_sum + plain_ms,
                                        bound_sum + b_ms)
        by[b_by] += b_ms
    # one PyTorch call computing what e (one of its three products) and h
    # compute: the yardsticks of PERF.md's row 8
    a, b = probes.inputs("e", dev)[1:]
    x = probes.inputs("h", dev)[0]
    e_ms = time_ms(lambda: torch.matmul(a[:, 0:8].T, b))
    h_ms = time_ms(lambda: torch.sum(x[256:512]))
    log(f"probe library calls: e torch.matmul(a[:, 0:8].T, b) {e_ms:.4f} "
        f"ms, h torch.sum(x[256:512]) {h_ms:.4f} ms")
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
    backend one launch a batch; on the kernel backend one `color_gram`
    launch a batch (three for acvo), the lanes through the compiled
    loop, and the trajectory the sequential cold run's (its pairs through
    `align_jit`), pose for pose.  Given `root`, the render as a TUM folder
    and a 2-frame prefix of it also run through run_multiseq (ragged
    lanes), each lane against its solo cold run.  Returns the launches
    of the batched runs, by kernel."""
    import numpy as np
    import torch

    from cvo_rgbd_torch.core.registration import CHECK_EVERY
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

    _, r0, w0 = jit_counts()
    recs, est, dt, launches = drive(run_odometry_batched_frames,
                                    batch=ODOM_BATCH)
    _, r1, w1 = jit_counts()
    replays, warmups = r1 - r0, w1 - w0
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
    batches = -(-n // ODOM_BATCH)
    if fused:
        check(launches["align_fused"] == batches
              and not any(launches[k] for k in KERNELS),
              f"batched odometry {name}: not one launch a batch: {launches}")
    else:
        gap = max(float(np.abs(est[t] - seq_est[t]).max()) for t in seq_est)
        # one loop a batch: every replayed block is CHECK_EVERY
        # iterations of the batch (max_iter is far off), and so is the
        # eager warm-up ahead of the capture; each iteration one
        # fused_moments launch for all the lanes
        iters = replays * CHECK_EVERY + warmups
        per_iter = launches[LANE_MOM] / max(iters, 1)
        log(f"batched odometry {name}: {replays} graph replays and "
            f"{warmups} warm-up iterations ({iters} batch iterations; the "
            f"slowest pair "
            f"{max(r.iterations for r in recs) + 1}), fused_moments "
            f"launches a batch iteration {per_iter!r} (one-pair launches "
            f"{launches['fused_moments']}), fused_wsq launches "
            f"{launches['fused_wsq']}, color_gram launches "
            f"{launches['color_gram']} for {batches} batch(es), max |pose - "
            f"sequential cold| {gap!r}")
        check(launches["color_gram"] == batches * (3 if adaptive else 1)
              and launches[LANE_MOM] == iters and replays > 0
              and launches["fused_moments"] == 0
              and launches["align_fused"] == 0
              and launches["fused_wsq"] == (iters if adaptive else 0),
              f"batched odometry {name}: launched {launches}, {replays} "
              "replays")
        check(set(est) == set(seq_est) and gap == 0.0,
              f"batched odometry {name}: lanes are not the sequential cold "
              f"aligns' bits ({gap!r})")
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


def phase_color_gram_batched(clouds, sets, p):
    """8c. `color_gram` with a lane axis on align_batched's inputs (the
    kd-sorted stacks): the render's 9 pairs at 3072 (8b's batch) and the
    coarse pcd pairs x LANE_REPEAT (8's 63 lanes at 384, features padded
    to NFEAT).  One launch a batch against its plain version (1e-6) and
    every lane against the one-pair launch on its pair (the same bits);
    the batched launch, the B one-pair launches and the plain version
    timed, with the bound of the batch.  Returns the kernel line's row:
    the 9 x 3072 batch's numbers, the worst error of both."""
    import torch

    from cvo_rgbd_torch.batch import pad_clouds
    from cvo_rgbd_torch.core.cloud import kd_sort, stack_clouds
    from cvo_rgbd_torch.ops import gram

    dev = torch.device("cuda")
    pcd = [c._replace(features=gram.pad_feat(c.features))
           for c in pad_clouds(sets[BATCH_GRID], dev)]
    cases = [("render", clouds[:-1], clouds[1:], 1),
             (f"pcd grid={BATCH_GRID}", pcd[:-1], pcd[1:], LANE_REPEAT)]
    scal = gram.scalars(torch.full((), p.ell_init, device=dev), p)
    row, err_all = None, 0.0
    for name, xs, ys, repeat in cases:
        x = kd_sort(stack_clouds(xs, repeat=repeat))
        y = kd_sort(stack_clouds(ys, repeat=repeat))
        b, n, m = x.positions.shape[0], x.capacity, y.capacity
        args = (x.features, x.mask, y.features, y.mask, scal)
        lanes = [(x.features[i], x.mask[i], y.features[i], y.mask[i], scal)
                 for i in range(b)]
        before = gram.color_gram.launches
        ck = gram.color_gram_cuda(*args)
        torch.cuda.synchronize()
        one_launch = gram.color_gram.launches - before
        same = sum(torch.equal(ck[i], gram.color_gram_cuda(*a))
                   for i, a in enumerate(lanes))
        err = (ck - gram.color_gram_plain(*args)).abs().max().item()
        err_all = max(err_all, err)
        ms = time_ms(lambda: gram.color_gram_cuda(*args))
        # B host launches outlast SPIN_CYCLES at 63 lanes
        singles_ms = time_ms(
            lambda: [gram.color_gram_cuda(*a) for a in lanes],
            spin=ALIGN_SPIN_CYCLES)
        plain_ms = time_ms(lambda: gram.color_gram_plain(*args))
        nbytes = b * ((n + m) * 6 * 4 + n * m * 4) + 8 * 4
        b_ms, b_by = bound(nbytes, b * n * m * OPS_COLOR)
        torch.cuda.synchronize()
        log(f"8c color_gram {name}: {b} lanes x {n} x {m}, {one_launch} "
            f"launch(es), max_abs_err={err:.3e} (tolerance 1e-6), lanes the "
            f"one-pair launch's bits {same}/{b}; {ms:.4f} ms batched, "
            f"{singles_ms:.4f} ms as {b} one-pair launches, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); the card "
            f"holds {b * n * m * 4} bytes of caches")
        check(one_launch == 1, f"8c color_gram {name}: {one_launch} launches")
        check(err <= 1e-6, f"8c color_gram {name} disagrees with its plain "
              f"version: {err}")
        check(same == b, f"8c color_gram {name}: {b - same} lanes are not "
              "the one-pair launch's bits")
        if row is None:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    row["max_abs_err"] = err_all
    return row


def phase_moments_batched(clouds, sets, p):
    """8d. `fused_moments` with a lane axis (row 2b) at 8b's batch (the
    render's 9 pairs at 3072, the color cache and the tile skip) and at
    8's (the coarse pcd pairs x LANE_REPEAT, 63 lanes at 384, MATLAB's
    linear mode: its masked CI and the skip), then 8b's batch in its
    exp_mode="fast" form and at ell 0.1 on every lane (the most tiles
    kept, the regime of the batch's design).  The inputs are the batched
    loop's (`route` and `prepare_batch` on the stacks), each lane at its
    own ell, each moving cloud moved a little as an iteration sees it.  One
    launch against the plain version lane by lane (Mom within 1e-4 of
    each column's magnitude, nnz exact; fast: within the near-gate
    pairs), every lane the bits of the one-pair launch on it, a frozen
    lane zeros and the others unchanged; the batched launch timed beside
    the B one-pair launches and the plain version, with the bound of the
    batch.  Returns the kernel line's row: the 9 x 3072 batch's numbers,
    the worst error of the precise cases."""
    import torch

    from cvo_rgbd_torch.batch import pad_clouds
    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
    from cvo_rgbd_torch.core.cloud import stack_clouds
    from cvo_rgbd_torch.core.registration import prepare_batch, route
    from cvo_rgbd_torch.ops import gram, moments
    from cvo_rgbd_torch.params import MATLAB_PARAMS

    dev = torch.device("cuda")
    pcd = pad_clouds(sets[BATCH_GRID], dev)
    # (name, params, fixed, moving, repeat, ell of the first and last
    # lane); the last case keeps the most tiles: ell 0.1 on every lane
    cases = [("render", p, clouds[:-1], clouds[1:], 1, (p.ell_init, 0.03)),
             (f"pcd grid={BATCH_GRID} linear", MATLAB_PARAMS, pcd[:-1],
              pcd[1:], LANE_REPEAT, (MATLAB_PARAMS.ell_init, 0.03)),
             ("render/fast", fast_params(p), clouds[:-1], clouds[1:], 1,
              (p.ell_init, 0.03)),
             ("render ell 0.1", p, clouds[:-1], clouds[1:], 1, (0.1, 0.1))]
    row, err_all = None, 0.0
    for name, q, xs, ys, repeat, ells in cases:
        fast = q.exp_mode == "fast"
        linear = q.color_mode == "linear"
        q, x, y = route(q, stack_clouds(xs, repeat=repeat),
                        stack_clouds(ys, repeat=repeat))
        b, n, m = x.positions.shape[0], x.capacity, y.capacity
        pre = prepare_batch(q, x, y, [None] * b)
        c0, x_c, phi = pre.moments
        y_pos = y.positions + torch.tensor([0.004, -0.002, 0.003],
                                           device=dev)
        md = aabb_min_d2(*pre.skip[:2],
                         *block_bounds(y_pos, y.mask, moments.TILE_J))
        ell = torch.linspace(*ells, b, device=dev)
        scal = gram.scalars(ell, q)
        args = (x_c, x.features, x.mask, y_pos - c0[:, None, :],
                y.features, y.mask, phi, scal, pre.ck[0], md)
        lanes = [tuple(a[i] for a in args) for i in range(b)]

        def batched(live=None):
            return moments.fused_moments_cuda(*args, linear, fast, live)

        before = read_launches()
        mom, nnz = batched()
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in read_launches().items()}
        same = err = rel = worst_nnz = 0
        for i, lane in enumerate(lanes):
            one, one_nnz = moments.fused_moments_cuda(*lane, linear, fast)
            same += int(torch.equal(mom[i], one)
                        and float(nnz[i]) == float(one_nnz))
            ref, ref_nnz = moments.fused_moments_plain(*lane, linear, fast)
            scale = ref.abs().amax(dim=0).clamp_min(1e-30)
            rel = max(rel, ((mom[i] - ref).abs() / scale).max().item())
            err = max(err, (mom[i] - ref).abs().max().item())
            gate = (moments.near_gate_pairs(*lane[:6], lane[7], lane[8],
                                            linear) if fast else 0)
            worst_nnz = max(worst_nnz, abs(float(nnz[i]) - float(ref_nnz))
                            - gate)
        live = torch.ones(b, dtype=torch.bool, device=dev)
        live[1] = False
        part, part_nnz = batched(live)
        torch.cuda.synchronize()
        frozen = (not part[1].any().item() and float(part_nnz[1]) == 0.0
                  and torch.equal(part[0], mom[0])
                  and torch.equal(part_nnz[2:], nnz[2:]))
        ms = time_ms(batched)
        # B host launches outlast SPIN_CYCLES at 63 lanes
        singles_ms = time_ms(
            lambda: [moments.fused_moments_cuda(*a, linear, fast)
                     for a in lanes], spin=ALIGN_SPIN_CYCLES)
        plain_ms = time_ms(lambda: moments.fused_moments_plain_batched(
            *args, linear, fast))
        keep = md <= scal[:, gram.S_D2_THRES, None, None] + \
            moments.SKIP_MARGIN
        pairs = int(keep.sum().item()) * moments.TILE_I * moments.TILE_J
        nbytes = (b * (n * (3 + moments.NUM_MONO) + m * 3
                       + m * moments.NUM_MONO + 8 + 1) + md.numel()) * 4
        nbytes += pairs * 4
        b_ms, b_by = bound(nbytes, pairs * pair_ops(False, fast)
                           + float(nnz.sum().item()) * OPS_GATED)
        log(f"8d fused_moments {name}: {b} lanes x {n} x {m}, launches "
            f"{got}, Mom err/max|col|={rel:.3e} (tolerance 1e-4), "
            f"max_abs_err={err:.3e}, nnz beyond the tolerance {worst_nnz} "
            f"({'near-gate pairs' if fast else 'exact'}), lanes the one-pair "
            f"launch's bits {same}/{b}, a frozen lane zeros and the others "
            f"unchanged {frozen}; {ms:.4f} ms batched, {singles_ms:.4f} ms "
            f"as {b} one-pair launches, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}); tiles kept "
            f"{keep.float().mean().item():.3f}, nnz {nnz.tolist()}")
        check(got[LANE_MOM] == 1 and got["fused_moments"] == 0,
              f"8d fused_moments {name}: launches {got}")
        check(rel <= 1e-4 and worst_nnz <= 0 and bool((nnz > 0).all()),
              f"8d fused_moments {name} disagrees with its plain version: "
              f"{rel}, nnz {worst_nnz}")
        check(same == b, f"8d fused_moments {name}: {b - same} lanes are "
              "not the one-pair launch's bits")
        check(frozen, f"8d fused_moments {name}: a frozen lane was swept "
              "or moved the others")
        if not fast:
            err_all = max(err_all, err)
        if row is None:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    row["max_abs_err"] = err_all
    return row


def phase_wsq_batched(clouds_a, sets, pa):
    """8f. `fused_wsq` with a lane axis (row 3b) on the batched loop's
    inputs (`route` and `prepare_batch` on the stacks): exact acvo's two
    self-sweeps of every lane at 8b's batch (the acvo render's 9 pairs at
    3072, each lane at its own ell from ell_init to ell_min, the moving
    clouds moved a little), in the precise and the fast form, and at 8's
    (the coarse pcd pairs x LANE_REPEAT, 63 lanes at 384, features
    padded), and 8b's batch at ell 0.1 on every lane (the most tiles
    kept); then 8b's Chebyshev tables (9 lanes x 2K sweeps, each lane
    at its own nodes), as `prepare_batch` builds them.  One launch
    against the plain version (wsq within 1e-4 relative, nnz exact;
    fast: within the near-gate pairs), every lane the bits of its
    one-pair launch (the tables: of `prepare` on the lane), a frozen lane
    zeros and the others unchanged; the launch timed beside the B
    one-pair launches and the plain version, with the bound; at 63 lanes
    the fixed cost of the units' bookkeeping, the launch with no lane and
    with one lane live.  Returns the kernel line's row: the 9 x 3072
    precise batch's numbers, the worst error of the precise cases."""
    import torch

    from cvo_rgbd_torch.batch import pad_clouds
    from cvo_rgbd_torch.core.cloud import stack_clouds
    from cvo_rgbd_torch.core.registration import (
        _self_sweeps,
        lane_pre,
        prepare,
        prepare_batch,
        route,
    )
    from cvo_rgbd_torch.ops import gram, moments, wsq

    dev = torch.device("cuda")
    tw = wsq.TILE_W
    pcd = pad_clouds(sets[BATCH_GRID], dev)
    # (name, params, fixed, moving, repeat, ell of the first and last
    # lane); the last case keeps the most tiles: ell 0.1 on every lane
    span = (pa.ell_init, pa.ell_min)
    cases = [("render", pa, clouds_a[:-1], clouds_a[1:], 1, span),
             ("render/fast", fast_params(pa), clouds_a[:-1], clouds_a[1:], 1,
              span),
             (f"pcd grid={BATCH_GRID}", pa, pcd[:-1], pcd[1:], LANE_REPEAT,
              span),
             ("render ell 0.1", pa, clouds_a[:-1], clouds_a[1:], 1,
              (0.1, 0.1))]
    row, err_all = None, 0.0
    for name, q, xs, ys, repeat, ells in cases:
        fast = q.exp_mode == "fast"
        q, x, y = route(q, stack_clouds(xs, repeat=repeat),
                        stack_clouds(ys, repeat=repeat))
        b, n = x.positions.shape[0], x.capacity
        pre = prepare_batch(q, x, y, [None] * b)
        y_pos = y.positions + torch.tensor([0.004, -0.002, 0.003],
                                           device=dev)
        sweeps = _self_sweeps(x, (y_pos, y.features, y.mask), pre.ck,
                              pre.skip)
        ell = torch.linspace(*ells, b, device=dev)
        scal = gram.scalars(ell, q)
        lanes = [[wsq.lane_sweep(sw, i) for sw in sweeps] for i in range(b)]

        def batched(live=None):
            return wsq.fused_wsq_sweeps_cuda(sweeps, scal, fast, live)

        before = read_launches()
        w, nz = batched()
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in read_launches().items()}
        ref_w, ref_n = wsq.fused_wsq_sweeps_plain(sweeps, scal, fast)
        same = 0
        for i, lane in enumerate(lanes):
            w1, n1 = wsq.fused_wsq_sweeps_cuda(lane, scal[i], fast)
            same += int(torch.equal(w[i], w1) and torch.equal(nz[i], n1))
        err = (w - ref_w).abs().max().item()
        rel = ((w - ref_w).abs() / ref_w.abs().clamp_min(1e-30)).max().item()
        upper = torch.triu(torch.ones(n // tw, n // tw, dtype=torch.bool,
                                      device=dev))
        kept = gated = nbytes = worst_nnz = 0
        for i, lane in enumerate(lanes):
            thr = scal[i, gram.S_D2_THRES] + moments.SKIP_MARGIN
            for k, sw in enumerate(lane):
                kt = wsq.kept_prefix(sw.tiles.sorted, thr)
                A = moments.pair_weights(*sw.x, *sw.y, scal[i], sw.ck,
                                         fast=fast)
                per_tile = (A > 0).reshape(n // tw, tw, n // tw, tw).sum(
                    dim=(1, 3))
                gated += int(per_tile[upper].sum().item())
                kept += kt
                nbytes += (n * 3 + kt * tw * tw + int(upper.sum().item())
                           + 8 + 2) * 4
                near = (moments.near_gate_pairs(*sw.x, *sw.y, scal[i],
                                                sw.ck) if fast else 0)
                worst_nnz = max(worst_nnz, abs(float(nz[i, k])
                                               - float(ref_n[i, k])) - near)
        live = torch.ones(b, dtype=torch.bool, device=dev)
        live[1] = False
        wl, nl = batched(live)
        torch.cuda.synchronize()
        frozen = (not wl[1].any().item() and not nl[1].any().item()
                  and torch.equal(wl[0], w[0]) and torch.equal(nl[2:], nz[2:]))
        ms = time_ms(batched)
        # B host launches outlast SPIN_CYCLES at 63 lanes
        singles_ms = time_ms(
            lambda: [wsq.fused_wsq_sweeps_cuda(lane, scal[i], fast)
                     for i, lane in enumerate(lanes)], spin=ALIGN_SPIN_CYCLES)
        plain_ms = time_ms(
            lambda: wsq.fused_wsq_sweeps_plain(sweeps, scal, fast),
            runs=PLAIN_ALIGN_RUNS, warmup=PLAIN_ALIGN_WARMUP)
        pairs = kept * tw * tw
        b_ms, b_by = bound(nbytes, pairs * pair_ops(False, fast)
                           + gated * OPS_WSQ_GATED)
        fixed_note = ""
        if b > ODOM_BATCH:
            # the units' bookkeeping: no lane live (no loads, no tile);
            # every lane live under scalar rows whose gate keeps no tile
            # (each unit's kept-prefix search takes its first round of
            # loads and stops); one lane live, against that lane's
            # one-pair launch
            none = torch.zeros(b, dtype=torch.bool, device=dev)
            one = none.clone()
            one[0] = True
            shut = scal.clone()
            shut[:, gram.S_D2_THRES] = -1.0
            none_ms = time_ms(lambda: batched(none))
            search_ms = time_ms(
                lambda: wsq.fused_wsq_sweeps_cuda(sweeps, shut, fast))
            one_ms = time_ms(lambda: batched(one))
            pair_ms = time_ms(lambda: wsq.fused_wsq_sweeps_cuda(
                lanes[0], scal[0], fast))
            fixed_note = (f"; no lane live {none_ms:.4f} ms, every lane's "
                          f"search alone (one round of loads, no tile) "
                          f"{search_ms:.4f} ms, lane 0 alone live "
                          f"{one_ms:.4f} ms, its one-pair launch "
                          f"{pair_ms:.4f} ms")
        log(f"8f fused_wsq {name}: {b} lanes x 2 sweeps x {n}, launches "
            f"{got}, wsq err/|wsq| {rel:.3e} (tolerance 1e-4), max_abs_err="
            f"{err:.3e}, nnz beyond the tolerance {worst_nnz} "
            f"({'near-gate pairs' if fast else 'exact'}), lanes the one-pair "
            f"launch's bits {same}/{b}, a frozen lane zeros and the others "
            f"unchanged {frozen}; {ms:.4f} ms batched, {singles_ms:.4f} ms "
            f"as {b} one-pair launches, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}); tiles kept {kept} of "
            f"{2 * b * int(upper.sum().item())}, gated pairs {gated}"
            + fixed_note)
        check(got["fused_wsq"] == 1, f"8f fused_wsq {name}: launches {got}")
        check(rel <= 1e-4 and worst_nnz <= 0 and bool((nz > 0).all()),
              f"8f fused_wsq {name} disagrees with its plain version: "
              f"{rel}, nnz {worst_nnz}")
        check(same == b, f"8f fused_wsq {name}: {b - same} lanes are not "
              "the one-pair launch's bits")
        check(frozen, f"8f fused_wsq {name}: a frozen lane was swept or "
              "moved the others")
        if not fast:
            err_all = max(err_all, err)
        if row is None:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    # the Chebyshev tables of 8b's batch: one launch for every lane's 2K
    # sweeps, each lane's the bits of `prepare`'s on its pair
    qc = dataclasses.replace(pa, self_mode="cheb")
    qc, x, y = route(qc, stack_clouds(clouds_a[:-1]),
                     stack_clouds(clouds_a[1:]))
    b = x.positions.shape[0]
    before = read_launches()
    pre = prepare_batch(qc, x, y, [None] * b)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in read_launches().items()}
    same = 0
    for i in range(b):
        one = prepare(qc, x.lane(i), y.lane(i)).cheb
        lane = lane_pre(pre, i).cheb
        same += int(torch.equal(lane[0], one[0]) and all(
            torch.equal(u, v) for u, v in zip(lane[1], one[1])))
    ms = time_ms(lambda: prepare_batch(qc, x, y, [None] * b),
                 PLAIN_ALIGN_RUNS, PLAIN_ALIGN_WARMUP, ALIGN_SPIN_CYCLES)
    singles_ms = time_ms(lambda: [prepare(qc, x.lane(i), y.lane(i))
                                  for i in range(b)],
                         PLAIN_ALIGN_RUNS, PLAIN_ALIGN_WARMUP,
                         ALIGN_SPIN_CYCLES)
    log(f"8f cheb tables: {b} lanes x {2 * qc.self_cheb_k} sweeps x "
        f"{x.capacity}, launches {got}, lanes the bits of `prepare` "
        f"{same}/{b}; prepare_batch {ms:.4f} ms, {b} prepare calls "
        f"{singles_ms:.4f} ms")
    check(got["fused_wsq"] == 1 and got["color_gram"] == 3,
          f"8f cheb tables: launches {got}")
    check(same == b, f"8f cheb tables: {b - same} lanes are not the bits "
          "of `prepare`")
    row["max_abs_err"] = err_all
    return row


def phase_batched_loop(clouds, clouds_a, sets, p, pa):
    """8e. `align_batched` as one compiled loop, at 8b's batch (the
    render's 9 pairs at 3072: on the kernel backend cvo, exact acvo and
    cheb acvo on the acvo clouds, and cvo in exp_mode="fast"; on the
    dense backend cvo and exact acvo at DENSE_STOPS) and at 8's (the
    coarse pcd pairs x LANE_REPEAT, 63 lanes at 384, MATLAB_PARAMS on the
    kernel and the dense backend: linear color).  Each batch twice (the
    first call captures), with the launch counts read around the second:
    on the kernel backend one `fused_moments` launch a batch iteration
    (every replay a block of CHECK_EVERY iterations), no one-pair launch,
    for exact acvo one `fused_wsq` launch a batch iteration (cheb: one a
    batch for its tables); the dense backend no kernel; every lane the
    bits of `align_jit` on its pair (the pcd pairs each once, their
    repeats held against it); host ms a batch iteration and pairs/s
    against the pairs one by one through `align_jit` (graphs built); the
    dense batches' peak device memory over the first call (the capture)
    and the second.  Returns the launches of the batched runs."""
    import torch

    from cvo_rgbd_torch import align_jit
    from cvo_rgbd_torch.batch import pad_clouds
    from cvo_rgbd_torch.core.cloud import stack_clouds
    from cvo_rgbd_torch.core.registration import CHECK_EVERY
    from cvo_rgbd_torch.params import MATLAB_PARAMS
    from cvo_rgbd_torch.parallel import align_batched

    dev = torch.device("cuda")
    pcd = pad_clouds(sets[BATCH_GRID], dev)
    cases = [("cvo", p, clouds, 1), ("acvo exact", pa, clouds_a, 1),
             ("acvo cheb", dataclasses.replace(pa, self_mode="cheb"),
              clouds_a, 1),
             ("cvo fast", fast_params(p), clouds, 1),
             (f"linear pcd grid={BATCH_GRID}", MATLAB_PARAMS, pcd,
              LANE_REPEAT),
             ("dense cvo", dataclasses.replace(p, backend="dense",
                                               **DENSE_STOPS), clouds, 1),
             ("dense acvo exact", dataclasses.replace(
                 pa, backend="dense", **DENSE_STOPS), clouds_a, 1),
             (f"dense linear pcd grid={BATCH_GRID}", dataclasses.replace(
                 MATLAB_PARAMS, backend="dense"), pcd, LANE_REPEAT)]

    def run(fn):
        torch.cuda.synchronize()
        reset_launches()
        r0 = jit_counts()[1]
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0, jit_counts()[1] - r0,
                read_launches())

    total = {}
    for name, q, cl, repeat in cases:
        xb = stack_clouds(cl[:-1], repeat=repeat)
        yb = stack_clouds(cl[1:], repeat=repeat)
        b, pairs = xb.positions.shape[0], len(cl) - 1
        dense = q.backend == "dense"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, dt_1, _, _ = run(lambda: align_batched(q, xb, yb))
        peak_1 = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        res, dt, reps, got = run(lambda: align_batched(q, xb, yb))
        peak = torch.cuda.max_memory_allocated() - base
        refs, _, _, _ = run(lambda: [align_jit(q, cl[i], cl[i + 1])
                                     for i in range(pairs)])
        _, dt_seq, _, _ = run(lambda: [align_jit(q, cl[i], cl[i + 1])
                                       for i in range(pairs)])
        same = sum(all(torch.equal(getattr(res, f)[i],
                                   getattr(refs[i % pairs], f))
                       for f in res._fields) for i in range(b))
        iters = reps * CHECK_EVERY
        slowest = int(res.iterations.max()) + 1
        # exact acvo: both self-sweeps of every lane one launch an
        # iteration; cheb: every lane's tables one launch
        wsq = 0 if dense else {"exact": iters, "cheb": 1}.get(
            getattr(q, "self_mode", None), 0)
        log(f"8e batched loop {name}: {b} lanes x {xb.capacity}, "
            f"{reps} replays ({iters} batch iterations, the slowest lane "
            f"{slowest}), launches {got}, fused_moments launches a batch "
            f"iteration {got[LANE_MOM] / max(iters, 1)!r}; lanes the bits "
            f"of align_jit {same}/{b}; {dt * 1e3 / iters:.3f} host ms a "
            f"batch iteration, {b / dt:.3f} pairs/s batched (first call "
            f"with capture {dt_1:.3f} s) against {pairs / dt_seq:.3f} "
            f"pairs/s one by one through align_jit ({dt_seq:.3f} s for "
            f"{pairs} pairs)"
            + (f"; peak device memory above the inputs {peak_1} bytes over "
               f"the first call (the capture), {peak} over the second"
               if dense else ""))
        check(got[LANE_MOM] == (0 if dense else iters)
              and got["fused_moments"] == 0 and got["fused_wsq"] == wsq
              and not (dense and any(got.values())),
              f"8e batched loop {name}: launches {got} for {reps} replays")
        check(same == b, f"8e batched loop {name}: {b - same} lanes are not "
              "the bits of align_jit")
        check(bool(res.converged.all()), f"8e batched loop {name}: a lane "
              "did not converge")
        _added(total, got)
    return total


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
    precise = {k: 0 for k in KERNELS + FUSED + (LANE_MOM,)}
    fast = {k: 0 for k in KERNELS + FUSED + (LANE_MOM,)}

    # the user's path: cli slam, MATLAB_PARAMS on the kernel backend
    out = os.path.join(root, "slam_poses_qt.txt")
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    jit0 = jit_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["slam", root, "--output", out])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = fused_by_mode(read_launches(), "resident")
    calls, replays, _ = (b - a for a, b in zip(jit0, jit_counts()))
    head = buf.getvalue().splitlines()[0]
    n_frames, n_kf, n_loops = (int(head.split()[k]) for k in (0, 2, 4))
    cli_poses = read_trajectory(out)
    log(f"cli slam: {head}; {dt / n_frames:.4f} s/frame with loading; ATE "
        f"{ate_rmse(gt, cli_poses)['rmse']:.5f} m; launches {got}; "
        f"align_jit calls {calls}, replays {replays}")
    # a frame's align and each loop closure's two
    check(calls >= n_frames - 1 + 2 * n_loops and replays > 0,
          f"cli slam: align_jit calls {calls}, replays {replays}")
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



def sha1s(*ts):
    """SHA-1 of each tensor's bytes (NaN and -0 included)."""
    import hashlib

    return [hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes())
            .hexdigest() for t in ts]


@contextlib.contextmanager
def programs_op_by_op():
    """Within: every caller of `core.compiled.program_for` (the keyframe
    inner products, `cloud_ok`, the SLAM step, multiseq's lane post) runs
    its function op by op, uncaptured, on its own inputs."""
    import functools

    from cvo_rgbd_torch import keyframes, multiseq, slam

    def op_by_op(name, fn, static, inputs):
        return functools.partial(fn, *static)

    mods = (keyframes, slam, multiseq)
    real = [m.program_for for m in mods]
    for m in mods:
        m.program_for = op_by_op
    try:
        yield
    finally:
        for m, r in zip(mods, real):
            m.program_for = r


def scatters_order_free(graph):
    """Whether every scatter-add of a pose-graph GN iteration gives the
    same bits in any order: the node sums (`_gradient`, the block
    diagonal, the PCG matvec: the edges' i then their j) and the dense
    blocks (ii, jj, ij, ji in turn).  On the card these are atomic; a
    target's sum is order-free when it takes at most two terms onto a
    zero base, or one onto a base already written.  Two eager runs that
    agree show nothing: the order of atomics varies from run to run."""
    ei, ej = (t.tolist() for t in (graph.edge_i, graph.edge_j))

    def free(calls):
        written = set()
        for keys in calls:
            for key in set(keys):
                if keys.count(key) > (1 if key in written else 2):
                    return False
            written.update(keys)
        return True

    return free([ei, ej]) and free([list(zip(ei, ei)), list(zip(ej, ej)),
                                    list(zip(ei, ej)), list(zip(ej, ei))])


def eager_optimize(graph, solver, kw, cg_iters):
    """`posegraph.optimize`'s Gauss-Newton loop op by op (its form before
    the iteration was captured; the mesh path's form)."""
    import torch

    from cvo_rgbd_torch.core import posegraph

    nodes, costs = graph.nodes, []
    for k in range(kw["iters"]):
        args = (kw["huber_delta"], kw["robust"], k, kw["robust_warmup"])
        if solver == "dense":
            nodes, cost = posegraph._gn_step_dense(graph, nodes, 1e-6, *args)
        else:
            nodes, cost = posegraph._gn_step_pcg(graph, nodes, 1e-6,
                                                 cg_iters, *args)
        costs.append(cost)
    return nodes, torch.stack(costs)


def phase_slam_jit(root):
    """9b: `cli slam`'s work outside align, compiled, on phase 9's .pcd
    folder at BATCH_GRID (MATLAB_PARAMS; see the module docstring).
    Returns the launches by kernel line row."""
    import numpy as np
    import torch

    from cvo_rgbd_torch import multiseq
    from cvo_rgbd_torch import slam as slam_mod
    from cvo_rgbd_torch.batch import load_pcd_dir, pad_clouds
    from cvo_rgbd_torch.core import posegraph
    from cvo_rgbd_torch.core.cloud import cloud_ok, stack_clouds
    from cvo_rgbd_torch.core.registration import function_inner_product
    from cvo_rgbd_torch.keyframes import aligned_fip, inner_product_async
    from cvo_rgbd_torch.parallel import align_batched
    from cvo_rgbd_torch.params import MATLAB_PARAMS
    from cvo_rgbd_torch.slam import KeyframeSlam, SlamConfig

    dev = torch.device("cuda")
    p = MATLAB_PARAMS
    clouds = pad_clouds(load_pcd_dir(root, grid=BATCH_GRID), dev)
    n = len(clouds)
    names = ("align_jit", "keyframe_scores_batched", "aligned_fip")
    launches = {k: 0 for k in KERNELS + FUSED}

    # the compiled path's whole run, recording each align and search
    recs = {name: [] for name in names}
    reals = {name: getattr(slam_mod, name) for name in names}

    def spy(name):
        def call(*a, **kw):
            out = reals[name](*a, **kw)
            recs[name].append((a, kw, out))
            return out
        return call

    for name in names:
        setattr(slam_mod, name, spy(name))
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        slam = KeyframeSlam(p, SlamConfig())
        for i, c in enumerate(clouds):
            slam.process(i, c)
        slam.solve()
        torch.cuda.synchronize()
        per_frame = (time.perf_counter() - t0) / n
    finally:
        for name in names:
            setattr(slam_mod, name, reals[name])
    got = read_launches()
    for k in KERNELS:
        launches[k] += got[k]
    kf = [k.index for k in slam.keyframes]
    loops = [(i, j) for i, j, _, _ in slam.loop_edges]
    check(len(loops) >= 1 and got["fused_moments"] > 0,
          f"9b: the recorded slam closed {loops}, launched {got}")

    # every align of the run: the programs against their functions
    cold = (torch.eye(3, device=dev), torch.zeros(3, device=dev),
            torch.full((), p.ell_init, device=dev))
    mismatch = []
    for q, (a, _, res) in enumerate(recs["align_jit"]):
        key, c = a[1], a[2]
        pairs = [
            (inner_product_async(p, c, c), function_inner_product(p, c, c)),
            (inner_product_async(p, key, c),
             function_inner_product(p, key, c)),
            (slam_mod._compiled_cloud_ok(c, 64), cloud_ok(c, 64))]
        slam_mod.align_jit = lambda *a, **kw: res
        try:
            step = slam_mod._slam_step(p, key, c, cold, 64, dev)
        finally:
            slam_mod.align_jit = reals["align_jit"]
        pairs += list(zip(step[1:], slam_mod._step_post(
            p, 64, res.tf, res.R, res.T, *key, *c)))
        if any(sha1s(x) != sha1s(y) for x, y in pairs):
            mismatch.append(q)
    log(f"9b: {len(recs['align_jit'])} aligns of {n} frames (keyframes {kf},"
        f" loop closures {loops}): self and cross inner products, cloud_ok "
        f"and the SLAM step's program the op by op SHA-1 on "
        f"{len(recs['align_jit']) - len(mismatch)}")
    check(not mismatch, f"9b: programs off their functions at aligns "
          f"{mismatch}")

    # process outside align, compiled and op by op
    def outside(form, timed=None):
        results = iter([r for _, _, r in recs["align_jit"]])
        slam_mod.align_jit = lambda *a, **kw: next(results)
        ctx = programs_op_by_op() if form == "op by op" else (
            contextlib.nullcontext())
        try:
            with ctx:
                s = KeyframeSlam(p, SlamConfig())
                for i, c in enumerate(clouds):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    s.process(i, c)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    if timed is not None:
                        timed.append((t1 - t0, time.perf_counter() - t0))
        finally:
            slam_mod.align_jit = reals["align_jit"]
        return s

    runs = {}
    for form in ("compiled", "op by op"):
        outside(form)
        timed = []
        s = outside(form, timed)
        api = _api_calls(lambda form=form: outside(form))
        host, wall = (np.array(t) * 1e3 for t in zip(*timed))
        runs[form] = s
        log(f"9b: process outside align, {form}: host ms a frame mean "
            f"{host.mean():.4f} median {np.median(host):.4f}, to the "
            f"frame's end mean {wall.mean():.4f} median "
            f"{np.median(wall):.4f}; host launches a frame "
            f"{sum(api.values()) / n:.2f} ({api})")
    a, b = runs["compiled"], runs["op by op"]
    check([k.index for k in a.keyframes] == [k.index for k in b.keyframes]
          == kf and a.loop_edges.__len__() == len(loops)
          and all(x.self_fip == y.self_fip
                  for x, y in zip(a.keyframes, b.keyframes))
          and all(np.array_equal(x, y) for x, y in zip(a.frame_poses,
                                                        b.frame_poses)),
          "9b: the compiled process parts from the op by op one")

    # each loop-closure search: scores and post-align inner products
    for q, ((sa, skw, sout), (fa, fkw, fout)) in enumerate(zip(
            recs["keyframe_scores_batched"], recs["aligned_fip"])):
        with programs_op_by_op():
            s_ref = reals["keyframe_scores_batched"](*sa, **skw)
            f_ref = reals["aligned_fip"](*fa, **fkw)
        ms = time_host(lambda: reals["keyframe_scores_batched"](*sa, **skw),
                       runs=5)
        log(f"9b: loop search {q}: {len(sa[1])} candidates, scores "
            f"{sout.tolist()} ({ms:.4f} ms), aligned_fip {fout.tolist()}")
        check(np.array_equal(sout, s_ref) and sha1s(fout) == sha1s(f_ref),
              f"9b: loop search {q} off its op by op bits")

    # the keyframe graph's solves, compiled against the eager loop
    cfg = slam.config
    kw = dict(iters=cfg.optimize_iters, huber_delta=cfg.huber_delta,
              robust=cfg.robust_kernel, robust_warmup=cfg.robust_warmup_iters)
    graph = posegraph.from_odometry(np.stack([k.pose for k in
                                              slam.keyframes]),
                                    loop_edges=slam.loop_edges, device=dev)
    for solver in ("dense", "pcg"):
        cg = max(64, 2 * len(kf))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = posegraph.optimize(graph, solver=solver, **kw)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        later_ms = time_host(lambda: posegraph.optimize(graph, solver=solver,
                                                        **kw), runs=5)
        later = posegraph.optimize(graph, solver=solver, **kw)
        eager = [eager_optimize(graph, solver, kw, cg) for _ in range(2)]
        eager_ms = time_host(lambda: eager_optimize(graph, solver, kw, cg),
                             runs=3)
        rerun = max(float((x - y).abs().max()) for x, y in zip(*eager))
        gaps = [max(float((x - y).abs().max()) for x, y in zip(
            got[:1], eager[0][:1])) for got in (first, later)]
        cost_gap = max(float(((got[1] - eager[0][1]).abs()
                              / eager[0][1].abs().clamp_min(1e-30)).max())
                       for got in (first, later))
        loop = [v for k2, v in posegraph.CACHE.items()
                if k2[:3] == (solver, len(kf), graph.edge_i.shape[0])]
        log(f"9b: optimize {solver}, {len(kf)} nodes, "
            f"{graph.edge_i.shape[0]} edges, {kw}: ms first call "
            f"{first_ms:.3f} (this process's first of the key for pcg; "
            f"phase 9's cli slam made dense's), later {later_ms:.3f}, eager "
            f"{eager_ms:.3f}; captures {loop[-1].captures}; nodes from the "
            f"eager loop {gaps}, costs {cost_gap:.2e} relative, the eager "
            f"rerun {rerun:.2e}")
        exact = scatters_order_free(graph)
        same = all(sha1s(*got) == sha1s(*eager[0]) for got in (first, later))
        log(f"9b: optimize {solver}: the eager bits {same}; every scatter-add "
            f"sum order-free {exact}")
        check(same or not exact, f"9b: optimize {solver} off the eager bits")
        check(max(gaps) <= 2e-4 and cost_gap <= 1e-3,
              f"9b: optimize {solver} off the eager loop")

    # multiseq's lane post on a 4-lane batch of consecutive pairs
    fb, mb = stack_clouds(clouds[:4]), stack_clouds(clouds[1:5])
    res = align_batched(p, fb, mb, device=dev)
    for adaptive in (False, True):
        got = multiseq.lane_post(res, fb, mb, adaptive, p.ell_init, 64)
        ref = multiseq._lane_post(adaptive, p.ell_init, 64, res.tf, res.R,
                                  res.T, res.ell, fb.positions, fb.mask,
                                  mb.positions, mb.mask)
        check(sha1s(*got) == sha1s(*ref) and bool(got[0].all()),
              f"9b: lane post (adaptive {adaptive}) off its op by op bits")

    # the slam through the compiled path on the fused backend
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fused = KeyframeSlam(dataclasses.replace(p, backend="fused"), SlamConfig())
    for i, c in enumerate(clouds):
        fused.process(i, c)
    fused.solve()
    torch.cuda.synchronize()
    fused_s = (time.perf_counter() - t0) / n
    got = fused_by_mode(read_launches(), "resident")
    launches["align_fused_resident"] += got["align_fused_resident"]
    check(len(fused.loop_edges) >= 1 and got["align_fused_resident"] > 0,
          f"9b: the fused slam closed {len(fused.loop_edges)}, launched {got}")
    log(f"9b: slam s/frame through the compiled path (solve included): "
        f"kernel {per_frame:.4f}, fused {fused_s:.4f}")
    return launches


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

    launches = {k: 0 for k in KERNELS + FUSED + (LANE_MOM,)}
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

    launches = {k: 0 for k in KERNELS + FUSED + (LANE_MOM,)}
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
    captured solve against the eager loop on the card (the same gates,
    the eager rerun logged), the BA ms at the first call (its capture
    included), a later call and eager, and the keyframe ATE before and
    after.  Returns the
    launches by kernel line row, and the keyframe pose graph and BA
    problem (host arrays) with their solvers' arguments for phase 11."""
    import numpy as np
    import torch

    from cvo_rgbd_torch import cli, parallel
    from cvo_rgbd_torch.core.posegraph import from_odometry
    from cvo_rgbd_torch.parallel import ba as ba_mod
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ba_solve(problem, **kw)
        torch.cuda.synchronize()
        seen.update(problem=problem, kw=kw,
                    first_ms=(time.perf_counter() - t0) * 1e3)
        return out

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
    # the captured GN iteration against the eager loop on the card
    defaults = inspect.signature(parallel.ba_solve).parameters
    eager_args = (kw.get("iters", defaults["iters"].default),
                  kw.get("damping", defaults["damping"].default),
                  kw.get("cg_iters", defaults["cg_iters"].default))
    eager = [ba_mod._solve_local(problem, *eager_args) for _ in range(2)]
    eager_ms = time_host(lambda: ba_mod._solve_local(problem, *eager_args),
                         runs=3)
    loop = [v for k, v in ba_mod.CACHE.items()
            if k[:4] == (problem.poses.shape[0], problem.landmarks.shape[0],
                         problem.obs_pose.shape[0],
                         problem.edge_pose.shape[0])
            and k[7] == problem.poses.device][-1]
    to_eager = [max(float((a - b).abs().max()) for a, b in zip(
        got[:2], eager[0][:2])) for got in (card, again)]
    eager_cost = max(float(((got[2] - eager[0][2]).abs()
                            / eager[0][2].abs()).max())
                     for got in (card, again))
    eager_rerun = [float((a - b).abs().max())
                   for a, b in zip(*eager)]
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
    log(f"10e: ba_solve captured ({loop.runs} GN iterations replayed, "
        f"captures {loop.captures}): ms first call {seen['first_ms']:.2f} "
        f"(capture included), later call {ba_ms:.2f}, eager loop "
        f"{eager_ms:.2f}; poses and landmarks from the eager loop "
        f"{to_eager}, costs {eager_cost:.2e} relative; the eager rerun "
        f"{eager_rerun} (atomic scatter-adds)")
    check(gaps[0] <= 1e-4 and gaps[1] <= 1e-4 and cost_gap <= 1e-3,
          "the card's ba_solve is off the CPU's")
    check(max(to_eager) <= 1e-4 and eager_cost <= 1e-3 and loop.runs >= 16,
          "the captured ba_solve is off the eager loop on the card")
    # phase 11's SLAM problem: the keyframe pose graph and the BA problem
    slam = seen["slam"]
    graph = from_odometry(np.stack([k.pose for k in slam.keyframes]),
                          loop_edges=slam.loop_edges, device="cpu")
    cfg = slam.config
    # every argument given, so that 11e's eager loops take the same ones:
    # the SLAM run's own, and damping and cg_iters chosen here
    opt_kw = dict(iters=cfg.optimize_iters, damping=1e-6, cg_iters=64,
                  huber_delta=cfg.huber_delta, robust=cfg.robust_kernel,
                  robust_warmup=cfg.robust_warmup_iters)
    return got, {"graph": [t.numpy() for t in graph], "opt_kw": opt_kw,
                 "problem": [t.cpu().numpy() for t in problem],
                 "ba_kw": dict(iters=kw["iters"], damping=1e-4,
                               cg_iters=48)}


def block_rows(cloud, r, nblocks):
    """Row block `r` of `nblocks` of a cloud: rank r's block on an axis of
    that size."""
    from cvo_rgbd_torch.core.cloud import PointCloud

    n = cloud.capacity // nblocks
    return PointCloud(*(t[r * n:(r + 1) * n] for t in cloud))


def filled(clouds, blocks):
    """The clouds cut to one capacity, the largest multiple of 128 *
    `blocks` that the fewest valid points among them fill, every row
    valid: each of `blocks` row blocks of each cloud holds valid rows.
    kd_sort puts a cloud's padding last, so at capacity 3072 the render's
    1300-1700 valid points all fall in the first of 2 blocks."""
    import torch

    from cvo_rgbd_torch.core.cloud import PointCloud

    step = 128 * blocks
    cap = min(int(c.mask.sum().item()) for c in clouds) // step * step
    check(cap > 0, f"fewer than {step} valid points to fill {blocks} blocks")
    return [PointCloud(*(t[torch.nonzero(c.mask > 0)[:cap, 0]] for t in c))
            for c in clouds]


def phase_mesh_kernels(c0, c1, a0, p, pa, every_block=False):
    """11a: rows 1-3 at the mesh paths' block shapes, in this process, on
    a render pair at sp = MESH_SP: `color_gram` [N/sp, M] (align_sharded's
    ck_xy), `fused_moments` [N/sp, M] with the cache and the skip
    (align_sharded) and [N/sp, M/sp] recomputing color (align_ring's
    hops r -> r), `fused_wsq` as the cross sweep [N/sp, N] with the cache
    (acvo's Axx on a row block) and [N/sp, N/sp] without (the ring's),
    each against its plain version at PERF.md section 2's gates; the
    blocks' moments and self-sweeps summed against the whole cloud's
    launch.  Every block that holds valid rows must give pairs (a block
    past the valid points, which kd_sort puts last, has none and must
    give exactly 0); with `every_block`, every block must hold valid
    rows.  Returns {kernel: [(shape, ms, plain ms, bound ms, bound by,
    max_abs_err)]} and each kernel's worst error."""
    import torch

    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds, kd_sort
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import gram, moments, wsq

    sp = MESH_SP
    x, y, xa = kd_sort(c0), kd_sort(c1), kd_sort(a0)
    dev = x.positions.device
    n, m = x.capacity, y.capacity
    nb, mb = n // sp, m // sp
    rows = [slice(r * nb, (r + 1) * nb) for r in range(sp)]
    cols = [slice(r * mb, (r + 1) * mb) for r in range(sp)]
    # the blocks r where x's, y's and xa's block r all hold valid rows
    held = [r for r in range(sp) if all(
        c.mask[s].sum().item() > 0
        for c, s in ((x, rows[r]), (y, cols[r]), (xa, rows[r])))]
    log(f"11a at {n}x{m}: blocks {held} of {sp} hold valid rows "
        f"(x {int(x.mask.sum().item())}, y {int(y.mask.sum().item())})")
    check(held and (not every_block or len(held) == sp),
          f"11a at {n}x{m}: only blocks {held} of {sp} hold valid rows")
    out = {"color_gram": [], "fused_moments": [], "fused_wsq": []}
    errs = dict.fromkeys(out, 0.0)

    def record(name, shape, ms, plain_ms, nbytes, nops, err, note):
        b_ms, b_by = bound(nbytes, nops)
        errs[name] = max(errs[name], err)
        out[name].append(dict(shape=shape, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
        log(f"11a {name} {shape[0]}x{shape[1]}{note}: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"max_abs_err {err:.3e}")

    # --- color_gram: the row block's cache against the whole moving cloud
    scal_c = gram.scalars(torch.full((), p.ell_init, device=dev), p)
    xs = [block_rows(x, r, sp) for r in range(sp)]
    args = (xs[0].features, xs[0].mask, y.features, y.mask, scal_c)
    ck = gram.color_gram_cuda(*args)
    err = (ck - gram.color_gram_plain(*args)).abs().max().item()
    check(err <= 1e-6, f"11a color_gram [{nb}, {m}] off its plain version: "
          f"{err}")
    record("color_gram", [nb, m], time_ms(lambda: gram.color_gram_cuda(*args)),
           time_ms(lambda: gram.color_gram_plain(*args)),
           (nb + m) * 6 * 4 + 8 * 4 + nb * m * 4, nb * m * OPS_COLOR, err,
           " (tolerance 1e-6)")

    # --- fused_moments: the row blocks (ck, skip), summed; a ring hop
    c0_, x_c, phi = build_moments_pre(x)
    y_c = y.positions - c0_
    ell = p.ell_sched[-1][1]
    scal = gram.scalars(torch.full((), ell, device=dev), p)
    thr = scal[gram.S_D2_THRES] + moments.SKIP_MARGIN

    def moment_case(rows, cols, use_ck):
        """One launch of a block pair: its args, result and plain check."""
        xb = [t[rows] for t in (x_c, x.features, x.mask)]
        yb = [t[cols] for t in (y_c, y.features, y.mask)]
        ckb = (gram.color_gram_cuda(x.features[rows], x.mask[rows],
                                    yb[1], yb[2], scal_c) if use_ck else None)
        md = aabb_min_d2(*block_bounds(xb[0], xb[2], moments.TILE_I),
                         *block_bounds(yb[0], yb[2], moments.TILE_J))
        a = (*xb, *yb, phi[rows], scal, ckb, md)
        mom, nnz = moments.fused_moments_cuda(*a)
        ref, ref_nnz = moments.fused_moments_plain(*a)
        torch.cuda.synchronize()
        colmax = ref.abs().amax(dim=0).clamp_min(1e-30)
        rel = ((mom - ref).abs() / colmax).max().item()
        check(rel <= 1e-4 and abs(nnz.item() - ref_nnz.item())
              <= 1e-4 * max(ref_nnz.item(), 1.0),
              f"11a fused_moments {xb[0].shape[0]}x{yb[0].shape[0]} "
              f"ck={use_ck}: Mom {rel}, nnz {nnz.item()} vs "
              f"{ref_nnz.item()}")
        return a, mom, nnz.item(), (mom - ref).abs().max().item(), md

    def moment_bound(a, nnz, md, use_ck):
        nr, mr = a[0].shape[0], a[3].shape[0]
        keep = md <= thr
        pairs = int(keep.sum().item()) * moments.TILE_I * moments.TILE_J
        nbytes = (nr * (3 + moments.NUM_MONO) + mr * 3 + mr * moments.NUM_MONO
                  + md.numel() + 8 + 1) * 4
        nbytes += pairs * 4 if use_ck else (nr + mr) * 6 * 4
        return nbytes, pairs * pair_ops(not use_ck) + nnz * OPS_GATED

    whole = slice(None)
    parts = [moment_case(r, whole, True) for r in rows]
    check(all(parts[r][2] > 0 for r in held),
          f"11a fused_moments: a row block with valid rows has no pair: "
          f"{[pt[2] for pt in parts]}")
    a, _, nnz0, err, md = parts[0]
    record("fused_moments", [nb, m],
           time_ms(lambda: moments.fused_moments_cuda(*a)),
           time_ms(lambda: moments.fused_moments_plain(*a)),
           *moment_bound(a, nnz0, md, True),
           max(pt[3] for pt in parts), f" ck=True skip=True ell={ell}")
    _, mom_w, nnz_w, _, _ = moment_case(whole, whole, True)
    summed = sum(pt[1] for pt in parts)
    colmax = mom_w.abs().amax(dim=0).clamp_min(1e-30)
    rel = ((summed - mom_w).abs() / colmax).max().item()
    log(f"11a fused_moments: the {sp} row blocks summed vs the whole cloud's "
        f"launch: {rel:.3e} of each column (tolerance 1e-4), nnz "
        f"{sum(pt[2] for pt in parts):.0f} vs {nnz_w:.0f}")
    check(rel <= 1e-4 and sum(pt[2] for pt in parts) == nnz_w,
          f"11a: row-block moments do not sum to the whole: {rel}")
    hops = [moment_case(rows[r], cols[r], False) for r in held]
    check(all(h[2] > 0 for h in hops),
          f"11a fused_moments: a ring hop has no pair: "
          f"{[h[2] for h in hops]}")
    a, _, nnz_r, _, md = hops[0]
    record("fused_moments", [nb, mb],
           time_ms(lambda: moments.fused_moments_cuda(*a)),
           time_ms(lambda: moments.fused_moments_plain(*a)),
           *moment_bound(a, nnz_r, md, False), max(h[3] for h in hops),
           f" ck=None skip=True ell={ell} (ring hops {held})")

    # --- fused_wsq: acvo's Axx on a row block (cross, ck), summed against
    # the symmetric sweep; the ring's self-pair block (no ck)
    tw = wsq.TILE_W
    scal_a = gram.scalars(torch.full((), pa.ell_init, device=dev), pa)
    thr_a = scal_a[gram.S_D2_THRES] + moments.SKIP_MARGIN
    box = block_bounds(xa.positions, xa.mask, tw)
    xas = [block_rows(xa, r, sp) for r in range(sp)]

    def wsq_case(xb, yb, use_ck, symmetric=False):
        ckb = (gram.color_gram_cuda(xb.features, xb.mask, yb.features,
                                    yb.mask, scal_a) if use_ck else None)
        md = aabb_min_d2(*block_bounds(xb.positions, xb.mask, tw),
                         *block_bounds(yb.positions, yb.mask, tw))
        tiles = wsq.tile_order(md, symmetric)
        a = (*xb, *yb, scal_a, ckb, tiles)
        w, nz = wsq.fused_wsq_cuda(*a, symmetric=symmetric)
        ref_w, ref_n = wsq.fused_wsq_plain(*a)
        torch.cuda.synchronize()
        w, nz, ref_w, ref_n = (v.item() for v in (w, nz, ref_w, ref_n))
        # kd_sort puts the padding last: a block past the valid points
        # has no pair, and its sweep must give exactly 0 too
        check(abs(w - ref_w) <= 1e-4 * abs(ref_w) and nz == ref_n,
              f"11a fused_wsq {xb.capacity}x{yb.capacity} ck={use_ck}: "
              f"{w} vs {ref_w}, nnz {nz} vs {ref_n}")
        kept = int((md <= thr_a).sum().item())
        pairs = kept * tw * tw
        nbytes = ((xb.capacity + yb.capacity) * 3 + tiles.by_id.numel()
                  + 8 + 2) * 4
        nbytes += pairs * 4 if use_ck else (xb.capacity + yb.capacity) * 24
        nops = pairs * pair_ops(not use_ck) + nz * OPS_WSQ_GATED
        return a, w, nz, abs(w - ref_w), nbytes, nops

    parts = [wsq_case(xb, xa, True) for xb in xas]
    check(all(parts[r][2] > 0 for r in held),
          f"11a fused_wsq: a row block with valid rows has no pair: "
          f"{[pt[2] for pt in parts]}")
    a, _, _, err, nbytes, nops = parts[0]
    sym = dict(symmetric=False)
    record("fused_wsq", [nb, n],
           time_ms(lambda: wsq.fused_wsq_cuda(*a, **sym)),
           time_ms(lambda: wsq.fused_wsq_plain(*a)), nbytes, nops,
           max(pt[3] for pt in parts),
           f" cross ck=True skip=True ell={pa.ell_init}")
    _, w_full, n_full, _, _, _ = wsq_case(xa, xa, True, symmetric=True)
    w_sum, n_sum = sum(pt[1] for pt in parts), sum(pt[2] for pt in parts)
    log(f"11a fused_wsq: the {sp} cross row sweeps summed {w_sum:.6e} "
        f"(nnz {n_sum:.0f}) vs the symmetric sweep {w_full:.6e} (nnz "
        f"{n_full:.0f}); tolerance 1e-4 relative, nnz exact")
    check(abs(w_sum - w_full) <= 1e-4 * abs(w_full) and n_sum == n_full,
          "11a: the cross row sweeps do not sum to the symmetric sweep")
    hops = [wsq_case(xas[r], xas[r], False) for r in held]
    check(all(h[2] > 0 for h in hops),
          f"11a fused_wsq: a ring hop has no pair: {[h[2] for h in hops]}")
    a, _, _, _, nbytes, nops = hops[0]
    record("fused_wsq", [nb, nb],
           time_ms(lambda: wsq.fused_wsq_cuda(*a, **sym)),
           time_ms(lambda: wsq.fused_wsq_plain(*a)), nbytes, nops,
           max(h[3] for h in hops),
           f" ck=None skip=True ell={pa.ell_init} (ring hops {held})")
    return out, errs


def host_arrays(cloud):
    return tuple(t.cpu().numpy() for t in cloud)


def _mesh_run(label, fn):
    """(label, fn(), counts): fn's result with this rank's kernel launches
    and collective calls counted from 0 and its host seconds (the card
    synchronized around it)."""
    import torch

    from cvo_rgbd_torch import collectives

    torch.cuda.synchronize()
    reset_launches()
    collectives.reset_stats()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return label, res, {"s": time.perf_counter() - t0,
                        "launches": read_launches(),
                        "collectives": dict(collectives.STATS)}


def mesh_rank(job, data):
    """One rank of a phase 11 launch (`parallel.mesh.launch`; every rank
    on the card, `cuda:0` here): `job` names the runs, `data` holds their
    inputs as host arrays.  Returns [(label, result, counts)]."""
    import torch
    import torch.distributed as dist

    from cvo_rgbd_torch.convert import posegraph_from_numpy
    from cvo_rgbd_torch.core import posegraph
    from cvo_rgbd_torch.core.cloud import PointCloud, stack_clouds
    from cvo_rgbd_torch.core.compiled import axis_key
    from cvo_rgbd_torch.core.posegraph import optimize
    from cvo_rgbd_torch.multiseq import run_multiseq
    from cvo_rgbd_torch.parallel import (
        align_batched,
        align_ring,
        align_sharded,
        ba_solve,
        make_mesh,
        train_step_2d,
    )
    from cvo_rgbd_torch.parallel import ba as ba_mod
    from cvo_rgbd_torch.parallel.ba import problem_on

    dev = torch.device("cuda", torch.cuda.current_device())

    def cloud(arrays):
        return PointCloud(*(torch.from_numpy(a).to(dev) for a in arrays))

    def stacked(side):
        return stack_clouds([cloud(a) for a in side])

    def fields(r):
        return {f: t.cpu().numpy() for f, t in zip(r._fields, r)}

    if job == "sp":
        mesh = make_mesh({"sp": dist.get_world_size()})
        c = {k: cloud(v) for k, v in data["clouds"].items()}
        entries = {"sharded": align_sharded, "ring": align_ring}
        out = [_mesh_run(label, lambda: fields(entries[fn](
            p, mesh, c[pair[0]], c[pair[1]])))
            for label, fn, p, pair in data["cases"]]
        out += _jit_runs(mesh, c, data.get("jit", ()), fields)
        return out + [("backend", dist.get_backend(mesh.axis("sp").group),
                       {})]
    # dp=2 x sp=2, then sp over the four ranks for the solvers
    mesh = make_mesh({"dp": 2, "sp": 2})
    out = [_mesh_run(label, lambda: fields(train_step_2d(
        data["p"], mesh, *(stacked(s) for s in pairs))))
        for label, pairs in data["pairs_2d"].items()]
    for label, (fixed, moving) in data["lanes"].items():
        out.append(_mesh_run(label, lambda: fields(align_batched(
            data["pf_lin"], stacked(fixed), stacked(moving), mesh=mesh))))
    out.append(_mesh_run("run_multiseq", lambda: run_multiseq(
        data["folders"], 1, params=data["pf"], num_want=NUM_WANT,
        mesh=mesh, warm_start=False, log=lambda *a: None)))
    mesh4 = make_mesh({"sp": dist.get_world_size()})
    slam = data["slam"]
    graph = posegraph_from_numpy(*slam["graph"], device=dev)
    problem = problem_on(slam["problem"], dev)
    # the first call captures; 11e times a later call and the eager loop
    for tag in ("", " later"):
        out.append(_mesh_run(f"optimize{tag}", lambda: [
            t.cpu().numpy() for t in optimize(graph, mesh=mesh4,
                                              **slam["opt_kw"])]))
        out.append(_mesh_run(f"ba_solve{tag}", lambda: [
            t.cpu().numpy() for t in ba_solve(problem, mesh=mesh4,
                                              **slam["ba_kw"])]))
    ax4 = mesh4.axis("sp")
    for lb, _, cnt in out[-4:]:
        cache = (posegraph.CACHE if lb.startswith("optimize")
                 else ba_mod.CACHE)
        cnt["captures"] = [v.captures for k, v in cache.items()
                           if axis_key(ax4) in k]
    out += _eager_solves(mesh4, graph, problem, slam)
    return out


def _jit_runs(mesh, clouds, cases, fields):
    """11e on this rank: each case (label, entry, params, pair) through
    its compiled loop (a later call of its key: its graphs exist) and its
    eager loop (`sharded._run_eager`), each timed by `_mesh_run`; the
    compiled run's counts add its block replays and its loop's captures
    (seconds, pool bytes, graph segments by block length)."""
    from cvo_rgbd_torch.core import compiled
    from cvo_rgbd_torch.parallel import sharded

    fns = {"sharded": sharded._align_sharded, "ring": sharded._align_ring}
    out = []
    for label, entry, p, pair in cases:
        for form, run in (("compiled", compiled.run_mesh),
                          ("eager", sharded._run_eager)):
            replays = compiled.run_mesh.replays
            lb, res, cnt = _mesh_run(f"{label} {form}", lambda: fields(
                fns[entry](p, mesh, clouds[pair[0]], clouds[pair[1]], "sp",
                           None, run)))
            cnt["replays"] = compiled.run_mesh.replays - replays
            if form == "compiled":
                cnt["captures"] = [v.captures for k, v in compiled.MESH.items()
                                   if k[1] == p
                                   and k[0].startswith(f"align_{entry}")][-1]
            out.append((lb, res, cnt))
    return out


def _eager_solves(mesh, graph, problem, slam):
    """11e on this rank: optimize(mesh=)'s and ba_solve(mesh=)'s GN loops
    op by op on the same shards (`posegraph._mesh_eager`,
    `ba._solve_local`), with the arguments `slam["opt_kw"]` and
    `slam["ba_kw"]` give in full."""
    from cvo_rgbd_torch.core import posegraph
    from cvo_rgbd_torch.parallel import ba as ba_mod

    ax = mesh.axis("sp")
    opt, ba = slam["opt_kw"], slam["ba_kw"]
    shard, m = ba_mod._mesh_shard(problem, ax, problem.poses.device)

    def solve():
        poses, lms, costs = ba_mod._solve_local(
            shard, ba["iters"], ba["damping"], ba["cg_iters"], ax)
        return [t.cpu().numpy() for t in (poses, lms[:m], costs)]

    return [
        _mesh_run("optimize eager", lambda: [t.cpu().numpy() for t in
                                             posegraph._mesh_eager(
            posegraph._edge_shard(graph, ax), ax, opt["iters"],
            opt["damping"], opt["cg_iters"], opt["huber_delta"],
            opt["robust"], opt["robust_warmup"])]),
        _mesh_run("ba_solve eager", solve)]


def _same_on_every_rank(ranks, label):
    """The ranks' results of a launch, checked to be one result."""
    import numpy as np

    def flat(r):
        if isinstance(r, dict):
            return [r[k] for k in sorted(r)]
        if isinstance(r, (list, tuple)):
            return list(r)
        return [r]

    for other in ranks[1:]:
        for (lb, a, _), (_, b, _) in zip(ranks[0], other):
            check(all(np.array_equal(u, v) for u, v in zip(flat(a), flat(b))),
                  f"{label} {lb}: the ranks' results differ")
    return {lb: r for lb, r, _ in ranks[0]}


def _rank_counts(ranks, label):
    """Each run's counts on each rank: [{label: counts}] in rank order."""
    return [{lb: c for lb, _, c in r if c} for r in ranks]


def _close_align(label, got, ref, tol=3e-4, stops=True, acvo=False):
    import numpy as np

    gap = float(np.abs(got["tf"] - ref["tf"]).max())
    ell = float(abs(got["ell"] - ref["ell"]) / ref["ell"])
    log(f"11 {label}: |tf - single| {gap:.2e} (tolerance {tol:g}), "
        f"iterations {int(got['iterations'])} vs {int(ref['iterations'])}, "
        f"converged {bool(got['converged'])}/{bool(ref['converged'])}, ell "
        f"{float(got['ell']):.5f} vs {float(ref['ell']):.5f}")
    check(gap <= tol, f"11 {label}: tf off the single align by {gap}")
    if stops:
        check(bool(got["converged"]) and bool(ref["converged"]),
              f"11 {label}: did not converge")
        check(not acvo or ell <= 0.05, f"11 {label}: ell off by {ell}")


def phase_mesh(clouds, sets, slam_problem, root):
    """11b-d: the mesh paths in ranks launched on this host
    (`parallel.mesh.launch`), every rank on the one card: 2 ranks over
    gloo (align_sharded and align_ring), 4 over gloo (train_step_2d,
    align_batched over dp, run_multiseq over dp, optimize and ba_solve
    over sp=4), 1 over NCCL (align_sharded at sp=1), each against the
    single-device call on the card in this process.  The sharded, ring and
    train_step_2d runs take the render at capacity 3072, whose rank-1
    blocks are padding, and the `filled` render, whose every block holds
    valid rows.  Returns the kernel launches of every rank, by kernel line
    row."""
    import numpy as np
    import torch

    from cvo_rgbd_torch import align, align_jit
    from cvo_rgbd_torch.batch import pad_clouds
    from cvo_rgbd_torch.convert import posegraph_from_numpy
    from cvo_rgbd_torch.core.cloud import PointCloud, stack_clouds
    from cvo_rgbd_torch.core.posegraph import optimize
    from cvo_rgbd_torch.io.tum import read_trajectory
    from cvo_rgbd_torch.multiseq import run_multiseq
    from cvo_rgbd_torch.ops.align_fused import fused_mode
    from cvo_rgbd_torch.parallel import align_batched, ba_solve
    from cvo_rgbd_torch.parallel.ba import problem_on
    from cvo_rgbd_torch.parallel.mesh import launch
    from cvo_rgbd_torch.params import MATLAB_PARAMS, AcvoParams, CvoParams
    from cvo_rgbd_torch.synth import BandScene, make_tum_dataset, revisit_path

    dev = torch.device("cuda")
    p, pa = CvoParams(), AcvoParams()
    it10 = dict(max_iter=10, eps=0.0, eps_2=0.0)
    pm = dataclasses.replace(MATLAB_PARAMS, eps=5e-5, eps_2=1e-5)
    lin = pad_clouds(sets[FINE_GRID], "cpu")[:2]
    host = {k: host_arrays(v) for k, v in clouds.items()}
    host.update(l0=host_arrays(lin[0]), l1=host_arrays(lin[1]))
    cases = []
    for name, q, pair in (("cvo", p, ("c0", "c1")),
                          ("acvo", pa, ("a0", "a1"))):
        for fn in ("sharded", "ring"):
            # the 10-iteration run first: it takes the ranks' warm-up
            cases.append((f"{name} {fn} it10", fn,
                          dataclasses.replace(q, **it10), pair))
            cases.append((f"{name} {fn}", fn, q, pair))
    # the render's valid points (1300-1700 of 3072) all sort into rank
    # 0's block, so rank 1's partials are zeros there; the filled pairs
    # (`filled`) and the pcd pair (2586 and 2635 of 2816) give both ranks
    # valid rows
    cases += [(f"{name} {fn} filled", fn, q, pair)
              for name, q, pair in (("cvo", p, ("f0", "f1")),
                                    ("acvo", pa, ("fa0", "fa1")))
              for fn in ("sharded", "ring")]
    cases += [(f"linear {fn}", fn, pm, ("l0", "l1"))
              for fn in ("sharded", "ring")]
    launches = {k: 0 for k in PER_ITER + BATCHED}

    def add(counts, mode_of=lambda label: None):
        for c in counts:
            for label, cnt in c.items():
                for k in PER_ITER:
                    launches[k] += cnt["launches"][k]
                mode = mode_of(label)
                if mode:
                    launches[f"align_fused_{mode}_batched"] += \
                        cnt["launches"]["align_fused"]

    # the single-device references on the card, in this process
    def single(q, pair):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = align(q, *(clouds.get(k) or {"l0": lin[0], "l1": lin[1]}[k]
                       for k in pair))
        torch.cuda.synchronize()
        return ({f: t.cpu().numpy() for f, t in zip(r._fields, r)},
                time.perf_counter() - t0)

    # 11b: two ranks share the card over gloo
    log("11b: 2 ranks on cuda:0 over gloo, their CUDA payloads staged "
        "through pinned host memory (NCCL refuses two ranks on one card): "
        "a correctness run, not a scaling run")
    # 11e's cases: the filled render's, whose keys 11b's runs compiled
    jit = [(f"{name} {fn} filled", fn, q, pair)
           for name, fn, q, pair in (("cvo", "sharded", p, ("f0", "f1")),
                                     ("acvo", "sharded", pa, ("fa0", "fa1")),
                                     ("cvo", "ring", p, ("f0", "f1")))]
    t0 = time.perf_counter()
    ranks = launch(mesh_rank, 2, ("sp", {"clouds": host, "cases": cases,
                                         "jit": jit}), timeout=600)
    log(f"11b: launch of 2 ranks in {time.perf_counter() - t0:.1f} s")
    got = _same_on_every_rank(ranks, "11b")
    counts = _rank_counts(ranks, "11b")
    _jit_report("2 ranks over gloo", got, counts, jit, one_graph=False)
    check(got["backend"] == "gloo", f"11b ran on {got['backend']}")
    for label, fn, q, pair in cases:
        ref, ref_s = single(q, pair)
        stops = "it10" not in label
        _close_align(label, got[label], ref, 3e-4 if stops else 1e-4, stops,
                     label.startswith("acvo"))
        if fn == "ring" and stops:
            _close_align(f"{label} vs sharded", got[label],
                         got[label.replace("ring", "sharded")], 3e-4, True,
                         label.startswith("acvo"))
        iters = int(got[label]["iterations"]) + 1
        for r, c in enumerate(counts):
            cnt = c[label]
            kern = {k: cnt["launches"][k] for k in PER_ITER}
            log(f"11b {label} rank {r}: {cnt['s'] * 1e3 / iters:.3f} ms an "
                f"iteration on the host ({iters} iterations; the single "
                f"align {ref_s * 1e3 / (int(ref['iterations']) + 1):.3f}), "
                f"collectives {cnt['collectives']['calls']} calls, "
                f"{cnt['collectives']['seconds'] * 1e3 / iters:.3f} ms an "
                f"iteration; launches {kern}")
            # the ring recomputes color, linear mode reads its CI
            check(kern["fused_moments"] > 0
                  and ("ring" in label or label.startswith("linear")
                       or kern["color_gram"] > 0)
                  and (not label.startswith("acvo") or kern["fused_wsq"] > 0),
                  f"11b {label} rank {r}: a kernel of its path never "
                  f"launched: {kern}")
    add(counts)

    # 11c: four ranks, dp=2 x sp=2
    pf_lin = dataclasses.replace(MATLAB_PARAMS, backend="fused")
    pf = dataclasses.replace(p, backend="fused")
    lanes, modes = {}, {}
    for grid in (BATCH_GRID, FINE_GRID):
        padded = pad_clouds(sets[grid], "cpu")
        n_lanes = 2 * ((len(padded) - 1) // 2)   # divides by dp = 2
        side = (padded[:n_lanes], padded[1:n_lanes + 1])
        label = f"align_batched grid={grid}"
        lanes[label] = tuple([host_arrays(c) for c in s] for s in side)
        modes[label] = fused_mode(pf_lin, *(stack_clouds(s) for s in side))
    full, short = os.path.join(root, "render"), os.path.join(root, "prefix")
    make_tum_dataset(full, revisit_path(FRAMES, period=33), BandScene(*SIZE))
    os.makedirs(short)
    for d in ("rgb", "depth"):
        os.symlink(os.path.join(full, d), os.path.join(short, d))
    with open(os.path.join(full, "assoc.txt")) as f:
        head = f.read().splitlines()[:2]
    with open(os.path.join(short, "assoc.txt"), "w") as f:
        f.write("\n".join(head) + "\n")
    pairs_2d = {f"train_step_2d{tag}": ([host[f"{c}0"], host[f"{c}1"]],
                                        [host[f"{c}1"], host[f"{c}2"]])
                for tag, c in (("", "c"), (" filled", "f"))}
    data = {"p": p, "pairs_2d": pairs_2d, "lanes": lanes, "pf_lin": pf_lin,
            "pf": pf, "folders": [full, short], "slam": slam_problem}
    t0 = time.perf_counter()
    ranks = launch(mesh_rank, 4, ("dp x sp", data), timeout=900)
    log(f"11c: launch of 4 ranks (dp=2 x sp=2) in "
        f"{time.perf_counter() - t0:.1f} s")
    got = _same_on_every_rank(ranks, "11c")
    counts = _rank_counts(ranks, "11c")
    for label, c in (("train_step_2d", "c"), ("train_step_2d filled", "f")):
        for i in range(2):
            ref, _ = single(p, (f"{c}{i}", f"{c}{i + 1}"))
            _close_align(f"{label} pair {i}", {
                f: v[i] for f, v in got[label].items()}, ref)
    for label, (fixed, moving) in lanes.items():
        fb, mb = (stack_clouds([PointCloud(*(torch.from_numpy(a).to(dev)
                                             for a in c)) for c in side])
                  for side in (fixed, moving))
        ref = align_batched(pf_lin, fb, mb)
        same = all(np.array_equal(got[label][f], t.cpu().numpy())
                   for f, t in zip(ref._fields, ref))
        log(f"11c {label} ({modes[label]}, {fb.positions.shape[0]} lanes "
            f"over dp=2): every lane the bits of the unsharded launch: "
            f"{same}")
        check(same, f"11c {label}: a lane is not the unsharded bits")
    solo = os.path.join(root, "solo")
    solo_dirs = [os.path.join(solo, "render"), os.path.join(solo, "prefix")]
    for src, dst in zip((full, short), solo_dirs):
        os.makedirs(dst)
        for d in ("rgb", "depth", "assoc.txt"):
            os.symlink(os.path.realpath(os.path.join(src, d)),
                       os.path.join(dst, d))
    solo_outs = run_multiseq(solo_dirs, 1, params=pf, num_want=NUM_WANT,
                             warm_start=False, log=lambda *a: None)
    for src, dst in zip((full, short), solo_dirs):
        with open(got["run_multiseq"][src]) as f, open(solo_outs[dst]) as g:
            a, b = f.read(), g.read()
        log(f"11c run_multiseq {os.path.basename(src)}: "
            f"{a.count(chr(10))} poses, the file of the unsharded run: "
            f"{a == b}")
        check(a == b and len(read_trajectory(solo_outs[dst])) >= 2,
              f"11c run_multiseq: {src} differs from the unsharded run")
    slam = slam_problem
    nodes, costs = optimize(posegraph_from_numpy(*slam["graph"], device=dev),
                            solver="pcg", **slam["opt_kw"])
    g_nodes, g_costs = got["optimize"]
    gaps = (float(np.abs(g_nodes - nodes.cpu().numpy()).max()),
            float((np.abs(g_costs - costs.cpu().numpy())
                   / np.abs(costs.cpu().numpy())).max()))
    log(f"11c optimize over sp=4 ({len(slam['graph'][1])} edges, "
        f"{slam['graph'][0].shape[0]} nodes): poses {gaps[0]:.2e}, costs "
        f"{gaps[1]:.2e} relative of the single PCG solve on the card")
    check(gaps[0] <= 1e-4 and gaps[1] <= 1e-3, "11c optimize(mesh=) is off")
    ref = ba_solve(problem_on(slam["problem"], dev), **slam["ba_kw"])
    ref = [t.cpu().numpy() for t in ref]
    ba = got["ba_solve"]
    gaps = [float(np.abs(a - b).max()) for a, b in zip(ba[:2], ref[:2])]
    cost_gap = float((np.abs(ba[2] - ref[2]) / np.abs(ref[2])).max())
    log(f"11c ba_solve over sp=4 ({slam['problem'][0].shape[0]} poses, "
        f"{slam['problem'][1].shape[0]} landmarks), the same bits on every "
        f"rank: poses {gaps[0]:.2e}, landmarks {gaps[1]:.2e}, costs "
        f"{cost_gap:.2e} relative of the single solve on the card")
    check(gaps[0] <= 1e-4 and gaps[1] <= 1e-4 and cost_gap <= 1e-3,
          "11c ba_solve(mesh=) is off")
    _jit_solves(got, counts, slam)
    for r, c in enumerate(counts):
        log(f"11c rank {r}: " + "; ".join(
            f"{lb} {cnt['s']:.2f} s, launches "
            f"{ {k: v for k, v in cnt['launches'].items() if v} }"
            for lb, cnt in c.items()))
        check(all(c[lb]["launches"]["fused_moments"] > 0
                  and c[lb]["launches"]["color_gram"] > 0 for lb in pairs_2d)
              and all(c[lb]["launches"]["align_fused"] > 0
                      for lb in list(lanes) + ["run_multiseq"]),
              f"11c rank {r}: a kernel of its path never launched")
    add(counts, lambda label: modes.get(label) or (
        "tiled" if label == "run_multiseq" else None))

    # 11d: NCCL at one rank (10 iterations first, for the warm-up)
    t0 = time.perf_counter()
    label = "cvo sharded sp=1"
    jit = [(label, "sharded", p, ("c0", "c1"))]
    ranks = launch(mesh_rank, 1, ("sp", {"clouds": host, "cases": [
        (f"{label} it10", "sharded", dataclasses.replace(p, **it10),
         ("c0", "c1")), (label, "sharded", p, ("c0", "c1"))], "jit": jit}),
                   backend="nccl", timeout=300)
    got = _same_on_every_rank(ranks, "11d")
    log(f"11d: 1 rank over {got['backend']} in "
        f"{time.perf_counter() - t0:.1f} s")
    check(got["backend"] == "nccl", f"11d ran on {got['backend']}")
    ref, ref_s = single(p, ("c0", "c1"))
    _close_align(f"{label} (NCCL)", got[label], ref)
    counts = _rank_counts(ranks, "11d")
    cnt, iters = counts[0][label], int(got[label]["iterations"]) + 1
    ref_ms = ref_s * 1e3 / (int(ref["iterations"]) + 1)
    log(f"11d {label}: {cnt['s'] * 1e3 / iters:.3f} ms an iteration on the "
        f"host (the single align {ref_ms:.3f}), collectives "
        f"{cnt['collectives']['calls']} calls, "
        f"{cnt['collectives']['seconds'] * 1e3 / iters:.3f} ms an "
        f"iteration; launches { {k: cnt['launches'][k] for k in PER_ITER} }")
    check(cnt["launches"]["fused_moments"] > 0
          and cnt["launches"]["color_gram"] > 0,
          f"11d: a kernel of its path never launched: {cnt['launches']}")
    add(counts)
    # 11e: the same key's compiled loop, one graph a block, and the eager
    # loop, beside align_jit on the pair here (a later call of its key)
    jit_rows = _jit_report("1 rank over NCCL", got, counts, jit,
                           one_graph=True)
    align_jit(p, *(clouds[k] for k in ("c0", "c1")))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = align_jit(p, *(clouds[k] for k in ("c0", "c1")))
    torch.cuda.synchronize()
    jit_ms = (time.perf_counter() - t0) * 1e3 / (int(res.iterations) + 1)
    log(f"11e {label} over NCCL: host ms an iteration compiled "
        f"{jit_rows[label][0]:.3f}, eager {jit_rows[label][1]:.3f}, "
        f"align_jit on the pair here {jit_ms:.3f}, the single eager align "
        f"{ref_ms:.3f}")
    if torch.cuda.device_count() < 2:
        log("11e: 2 ranks over NCCL not run: this host has "
            f"{torch.cuda.device_count()} card")
        return launches
    # 11e: two cards over NCCL, a rank on each, the ring included
    both = [("cvo sharded filled", "sharded", p, ("f0", "f1")),
            ("cvo ring filled", "ring", p, ("f0", "f1"))]
    t0 = time.perf_counter()
    ranks = launch(mesh_rank, 2, ("sp", {"clouds": host, "cases": both,
                                         "jit": both}),
                   backend="nccl", timeout=300)
    log(f"11e: 2 ranks over NCCL, a card each, in "
        f"{time.perf_counter() - t0:.1f} s")
    got = _same_on_every_rank(ranks, "11e")
    check(got["backend"] == "nccl", f"11e ran on {got['backend']}")
    counts = _rank_counts(ranks, "11e")
    _jit_report("2 ranks over NCCL", got, counts, both, one_graph=True)
    add(counts)
    return launches


def _jit_solves(got, counts, slam):
    """11e at 4 ranks: optimize(mesh=) and ba_solve(mesh=), their first
    call (captures included) and a later one, against their eager mesh
    loops on the same ranks: poses within 2e-4 (BA 1e-4, landmarks too),
    costs 1e-3 relative, and optimize's bits where every rank's
    scatter-adds are order-free (`scatters_order_free` on its edge
    shard); logs each rank's ms of the three and the graph segments."""
    import numpy as np

    from cvo_rgbd_torch.convert import posegraph_from_numpy
    from cvo_rgbd_torch.core.posegraph import _edge_shard
    from cvo_rgbd_torch.parallel.mesh import Axis

    graph = posegraph_from_numpy(*slam["graph"], device="cpu")
    free = all(scatters_order_free(_edge_shard(
        graph, Axis("sp", len(counts), r, None, ())))
        for r in range(len(counts)))
    for name, tol in (("optimize", 2e-4), ("ba_solve", 1e-4)):
        eager = got[f"{name} eager"]
        for tag in ("", " later"):
            comp = got[name + tag]
            gap = max(float(np.abs(a - b).max())
                      for a, b in zip(comp[:-1], eager[:-1]))
            cost = float((np.abs(comp[-1] - eager[-1])
                          / np.abs(eager[-1])).max())
            same = all(np.array_equal(a, b) for a, b in zip(comp, eager))
            log(f"11e {name}{tag} over sp={len(counts)} against its eager "
                f"mesh loop: {gap:.2e} (tolerance {tol:g}), costs "
                f"{cost:.2e} relative, the same bits {same} (every "
                f"shard's scatter-adds order-free: {free})")
            check(gap <= tol and cost <= 1e-3
                  and (name != "optimize" or not free or same),
                  f"11e {name}{tag}(mesh=) is off its eager loop")
        for r, c in enumerate(counts):
            log(f"11e {name} rank {r}: ms first call "
                f"{c[name]['s'] * 1e3:.2f} (capture included), later "
                f"{c[name + ' later']['s'] * 1e3:.2f}, eager "
                f"{c[name + ' eager']['s'] * 1e3:.2f}; collective calls "
                f"later {c[name + ' later']['collectives']['calls']}, eager "
                f"{c[name + ' eager']['collectives']['calls']}; captures "
                f"{c[name + ' later']['captures']}")


def _jit_report(tag, got, counts, cases, one_graph):
    """11e: each case's compiled loop against its eager loop on the same
    ranks (`_jit_runs`): the SHA-1 of tf, iterations and ell must agree,
    and a block must be one graph on NCCL (`one_graph`) and graph
    segments on gloo; logs each rank's host ms an iteration, graph
    segments, replays and collective calls an iteration of both forms.
    Returns {label: (compiled ms, eager ms)} an iteration, rank 0's."""
    import numpy as np
    import torch

    rows = {}
    for label, *_ in cases:
        comp, eag = got[f"{label} compiled"], got[f"{label} eager"]
        sha = [sha1s(*(torch.from_numpy(np.asarray(r[f]))
                       for f in ("tf", "iterations", "ell")))
               for r in (comp, eag)]
        iters = int(comp["iterations"]) + 1
        for r, c in enumerate(counts):
            cc, ce = c[f"{label} compiled"], c[f"{label} eager"]
            segs = {n: v["segments"] for n, v in cc["captures"].items()}
            ms = (cc["s"] * 1e3 / iters, ce["s"] * 1e3 / iters)
            rows.setdefault(label, ms)
            log(f"11e {tag} {label} rank {r}: SHA-1 of tf, iterations and "
                f"ell compiled == eager {sha[0] == sha[1]} ({iters} "
                f"iterations); host ms an iteration compiled {ms[0]:.3f}, "
                f"eager {ms[1]:.3f}; graph segments by block length {segs}, "
                f"{cc['replays']} replays; collective calls an iteration "
                f"compiled {cc['collectives']['calls'] / iters:.2f}, eager "
                f"{ce['collectives']['calls'] / iters:.2f}, their host ms an "
                f"iteration {cc['collectives']['seconds'] * 1e3 / iters:.3f}"
                f", {ce['collectives']['seconds'] * 1e3 / iters:.3f}; "
                f"captures {cc['captures']}")
            check(all((n == 1) == one_graph for n in segs.values())
                  and cc["replays"] > 0,
                  f"11e {tag} {label}: graph segments {segs}, replays "
                  f"{cc['replays']}")
        check(sha[0] == sha[1],
              f"11e {tag} {label}: the compiled loop is off the eager bits")
    return rows


def _quiet(*a):
    pass


def _failed(recs):
    return {r.index for r in recs if r.failed}


def _check_carried(label, out, names, first):
    """The two frames of the pairs failed from `first` carry frame
    first-1's pose; every pose finite.  Returns the trajectory."""
    import numpy as np

    from cvo_rgbd_torch.io.tum import read_trajectory

    est = read_trajectory(out)
    keep = est[float(names[first - 1])]
    for k in (first, first + 1):
        check(np.array_equal(est[float(names[k])], keep),
              f"{label}: frame {k} does not carry frame {first - 1}'s pose")
    check(all(np.isfinite(v).all() for v in est.values()),
          f"{label}: a non-finite pose")
    return est


def _drive(fn, *a, **kw):
    """fn(*a, **kw) with the launch counts read around it: (its result,
    the seconds it took, the launches)."""
    import torch

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_launches()


def _added(total, got):
    """total plus the launches `got` of a run, whose align_fused launches
    the caller has moved to their kernel line row (or there are none)."""
    check(not got.pop("align_fused", 0),
          f"align_fused launched where no kernel line row takes it: {got}")
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_failure_paths(root):
    """12a: the failure paths on tests/test_degradation.py's sequence, on
    the kernel backend (the batched driver on the fused one).  Returns
    the launches by kernel line row."""
    import numpy as np

    from cvo_rgbd_torch import odometry
    from cvo_rgbd_torch.evaluation import nan_cloud
    from cvo_rgbd_torch.frontend import make_frontend
    from cvo_rgbd_torch.io.tum import load_assoc, read_trajectory
    from cvo_rgbd_torch.keyframes import KeyframePolicy
    from cvo_rgbd_torch.multiseq import run_multiseq
    from cvo_rgbd_torch.odometry import (
        load_image_pair,
        run_odometry,
        run_odometry_batched,
    )
    from cvo_rgbd_torch.params import CvoParams
    from cvo_rgbd_torch.slam import KeyframeSlam, SlamConfig
    from cvo_rgbd_torch.synth import (
        Degradation,
        make_tum_dataset,
        revisit_path,
    )

    folder = os.path.join(root, "degraded")
    make_tum_dataset(folder, revisit_path(DEG_FRAMES, period=33),
                     degrade=Degradation(
                         depth_noise=2e-3, dropout=0.08,
                         low_texture_frames=(DEG_LOW_TEXTURE,),
                         drop_frames=(DEG_DROP,), seed=3))
    entries = load_assoc(os.path.join(folder, "assoc.txt"))
    names = [e.name for e in entries]
    drop = {DEG_DROP, DEG_DROP + 1}
    p = CvoParams(eps=5e-4, eps_2=1e-4)
    launches = {}

    # the sequential driver: exactly the dropped frame's two pairs fail
    out = os.path.join(root, "deg_poses.txt")
    recs, dt, got = _drive(run_odometry, folder, 1, params=p,
                           num_want=DEG_NUM_WANT, max_frames=DEG_MAX_FRAMES,
                           output=out, log=_quiet)
    log(f"12a run_odometry (kernel): {len(recs)} pairs, failed "
        f"{sorted(_failed(recs))}, iterations "
        f"{[r.iterations for r in recs]}, {len(recs) / dt:.3f} frames/s, "
        f"launches {got}")
    check(_failed(recs) == drop, f"12a run_odometry failed {_failed(recs)}")
    _check_carried("12a run_odometry", out, names, DEG_DROP)
    check(got["color_gram"] and got["fused_moments"]
          and not got["align_fused"], f"12a run_odometry launched {got}")
    _added(launches, got)

    # the low-texture frame: the block refill fills the quota
    fe = make_frontend(1, DEG_NUM_WANT, 1)
    n_low = int(fe(*load_image_pair(folder, entries[DEG_LOW_TEXTURE]))
                .mask.sum().item())
    log(f"12a low-texture frame {DEG_LOW_TEXTURE}: {n_low} valid points "
        f"(refill budget {DEG_REFILL_BLOCKS})")
    check(n_low > 0.6 * DEG_REFILL_BLOCKS and n_low >= 64,
          f"12a the refill left {n_low} points on the low-texture frame")

    # a NaN-poisoned cloud: its two pairs fail, the later ones converge
    out = os.path.join(root, "nan_poses.txt")
    with nan_cloud(odometry, DEG_NAN):
        recs, _, got = _drive(
            run_odometry, folder, 1,
            params=dataclasses.replace(p, max_iter=DEG_NAN_MAX_ITER),
            num_want=DEG_NUM_WANT, max_frames=DEG_NAN_FRAMES, output=out,
            log=_quiet)
    later = [r for r in recs if r.index > DEG_NAN + 1]
    log(f"12a NaN cloud {DEG_NAN}: failed {sorted(_failed(recs))}, "
        f"iterations {[r.iterations for r in recs]}, launches {got}")
    check(_failed(recs) == {DEG_NAN, DEG_NAN + 1},
          f"12a NaN run failed {_failed(recs)}")
    check(later and all(r.converged and not r.failed for r in later),
          "12a a pair after the NaN cloud did not converge")
    _check_carried("12a NaN run", out, names, DEG_NAN)
    _added(launches, got)

    # the batched driver on the fused backend, one launch a batch, with
    # and without the motion prior
    pf = dataclasses.replace(p, backend="fused")
    n_pairs = DEG_MAX_FRAMES - 1
    for prior in (False, True):
        out = os.path.join(root, f"deg_batched_{int(prior)}.txt")
        recs, _, got = _drive(
            run_odometry_batched, folder, 1, params=pf,
            num_want=DEG_NUM_WANT, batch=DEG_BATCH,
            max_frames=DEG_MAX_FRAMES, output=out, motion_prior=prior,
            log=_quiet)
        log(f"12a run_odometry_batched (fused, batch={DEG_BATCH}, "
            f"motion_prior={prior}): failed {sorted(_failed(recs))}, "
            f"iterations {[r.iterations for r in recs]}, launches {got}")
        check(_failed(recs) == drop,
              f"12a batched (prior {prior}) failed {_failed(recs)}")
        _check_carried(f"12a batched (prior {prior})", out, names, DEG_DROP)
        check(got["align_fused"] == -(-n_pairs // DEG_BATCH)
              and not any(got[k] for k in KERNELS),
              f"12a batched: not one launch a batch: {got}")
        launches["align_fused_resident_batched"] = launches.get(
            "align_fused_resident_batched", 0) + got.pop("align_fused")
        _added(launches, got)

    # multiseq: only the degraded lane logs skips
    clean = os.path.join(root, "clean")
    make_tum_dataset(clean, revisit_path(8, period=33))
    msgs = []
    outs, _, got = _drive(
        run_multiseq, [folder, clean], 1, params=p, num_want=DEG_NUM_WANT,
        max_frames=DEG_MAX_FRAMES,
        log=lambda *a: msgs.append(" ".join(map(str, a))))
    skips = [m for m in msgs if "skipping" in m]
    t_deg, t_clean = (read_trajectory(outs[f]) for f in (folder, clean))
    log(f"12a run_multiseq (kernel): skips {skips}, launches {got}")
    check(len(skips) == 2 and all(m.startswith(folder + " ") for m in skips),
          f"12a multiseq skips {skips}")
    check(len(t_deg) == DEG_MAX_FRAMES and len(t_clean) == 8
          and all(np.isfinite(v).all() for t in (t_deg, t_clean)
                  for v in t.values()), "12a multiseq trajectories")
    check(got[LANE_MOM] > 0 and got["fused_moments"] == 0,
          f"12a multiseq launched {got}")
    got[LANE_GRAM] = got.pop("color_gram")
    _added(launches, got)

    # SLAM fed the dropped frame first seeds on the next frame
    def slam_run():
        slam = KeyframeSlam(p, SlamConfig(keyframe=KeyframePolicy(
            max_span=6)))
        for i, j in enumerate([DEG_DROP, 1, 2, 3]):
            slam.process(i, fe(*load_image_pair(folder, entries[j])))
        return slam

    slam, _, got = _drive(slam_run)
    kfs = [k.index for k in slam.keyframes]
    log(f"12a KeyframeSlam, frame {DEG_DROP} first: keyframes {kfs}, "
        f"launches {got}")
    check(kfs and kfs[0] == 1 and slam.keyframes[0].self_fip > 0,
          f"12a SLAM seeded on {kfs}")
    check(np.array_equal(slam.frame_poses[0], np.eye(4))
          and np.isfinite(slam.frame_poses[-1]).all(), "12a SLAM poses")
    return _added(launches, got)


def phase_degraded_sequence(root):
    """12b: bench.py's degraded sequence on the fused backend (resident
    at 1024).  Returns (launches by kernel line row, the folder)."""
    from cvo_rgbd_torch.evaluation import ate_rmse
    from cvo_rgbd_torch.io.tum import read_trajectory
    from cvo_rgbd_torch.odometry import run_odometry
    from cvo_rgbd_torch.params import CvoParams
    from cvo_rgbd_torch.stop_skew import compare, make_sequence

    folder = os.path.join(root, "bench_degraded")
    make_sequence(folder, BENCH_DEG_FRAMES, BENCH_DEG_DROP)
    p = CvoParams(eps=5e-4, eps_2=1e-4, backend="fused")
    recs, dt, got = _drive(run_odometry, folder, 1, params=p,
                           num_want=BENCH_DEG_NUM_WANT, log=_quiet)
    gt = read_trajectory(os.path.join(folder, "groundtruth.txt"))
    ate = ate_rmse(gt, read_trajectory(
        os.path.join(folder, "cvo_poses_qt.txt")))["rmse"]
    n = len(recs)
    mean_it = sum(r.iterations for r in recs) / n
    log(f"12b degraded sequence, fused num_want={BENCH_DEG_NUM_WANT}: {n} "
        f"pairs, failed {sorted(_failed(recs))}, {n / dt:.3f} frames/s, "
        f"mean iterations {mean_it:.1f}, ATE {ate:.5f} m, launches {got}")
    check(_failed(recs) == {BENCH_DEG_DROP, BENCH_DEG_DROP + 1},
          f"12b failed {_failed(recs)}")
    check(ate < 0.08, f"12b ATE {ate} m")
    check(got["align_fused"] == n and not any(got[k] for k in KERNELS),
          f"12b: not one align_fused launch a pair: {got}")

    # the resident kernel against the plain version on 12b's own pairs
    t0 = time.perf_counter()
    s = compare(folder, REPLAY_FRAMES, log=_quiet)["summary"]
    rep, aligned = s["replay"], s["frames"] - 1
    ate_gap = abs(s["ate"]["cpu_with_replay_everywhere"] - s["ate"]["cpu"])
    log(f"12b replay of the first {REPLAY_FRAMES} frames "
        f"({time.perf_counter() - t0:.1f} s): frontend masks equal on "
        f"{s['frontend']['masks_equal']}, positions "
        f"{s['frontend']['positions']:.2e}; {rep['equal_stops']} of "
        f"{aligned} pairs stop alike, tf within "
        f"{rep['equal_stops_tf_diff']:.2e} (median "
        f"{rep['equal_stops_tf_diff_median']:.2e}), differing "
        f"{rep['differing_pairs']} within "
        f"{rep['differing_stops_tf_diff']:.2e}; ATE CPU "
        f"{s['ate']['cpu']:.5f} m, with the card's transforms "
        f"{s['ate']['cpu_with_replay_everywhere']:.5f} m, the card's loop "
        f"{s['ate']['card']:.5f} m")
    check(s["frontend"]["masks_equal"] == REPLAY_FRAMES,
          f"12b replay: frontend masks differ: {s['frontend']}")
    check(rep["equal_stops"] >= REPLAY_EQUAL_SHARE * aligned
          and rep["equal_stops_tf_diff"] <= REPLAY_TF_TOL
          and rep["equal_stops_tf_diff_median"] <= REPLAY_TF_MEDIAN
          and ate_gap <= REPLAY_ATE_TOL, f"12b replay: {s}")
    return fused_by_mode(got, "resident"), folder


def phase_orbit(root):
    """12c: tests/test_odometry_rotation.py's orbit, cvo and acvo on the
    kernel backend at the C++ stops.  Returns the launches."""
    from cvo_rgbd_torch.evaluation import ate_rmse, rotation_errors_mrad
    from cvo_rgbd_torch.io.tum import read_trajectory
    from cvo_rgbd_torch.odometry import run_odometry
    from cvo_rgbd_torch.synth import (
        BandScene,
        linear_orbit_path,
        make_tum_dataset,
    )

    folder = os.path.join(root, "orbit")
    make_tum_dataset(folder, linear_orbit_path(ORBIT_FRAMES, 0.8, 0.15),
                     BandScene(u_pad=80, v_pad=16))
    gt = read_trajectory(os.path.join(folder, "groundtruth.txt"))
    launches = {}
    for adaptive in (False, True):
        name = "acvo" if adaptive else "cvo"
        out = os.path.join(root, f"orbit_{name}.txt")
        recs, dt, got = _drive(run_odometry, folder, 1, adaptive=adaptive,
                               num_want=ORBIT_NUM_WANT, output=out,
                               log=_quiet)
        est = read_trajectory(out)
        ate = ate_rmse(gt, est)["rmse"]
        rot = max(rotation_errors_mrad(gt, est))
        ate_bound, rot_bound = ORBIT_BOUNDS[adaptive]
        log(f"12c orbit {name} (kernel): {len(recs)} pairs, failed "
            f"{sorted(_failed(recs))}, iterations "
            f"{[r.iterations for r in recs]}, {len(recs) / dt:.3f} frames/s, "
            f"ATE {ate:.5f} m (bound {ate_bound}), largest rotation error "
            f"{rot:.3f} mrad (bound {rot_bound}), launches {got}")
        check(len(est) == ORBIT_FRAMES and not _failed(recs),
              f"12c {name}: a pair failed")
        check(ate < ate_bound and rot < rot_bound,
              f"12c {name}: ATE {ate} m, rotation {rot} mrad")
        used = ("color_gram", "fused_moments") + (
            ("fused_wsq",) if adaptive else ())
        check(all(got[k] for k in used) and not got["align_fused"],
              f"12c {name} launched {got}")
        _added(launches, got)
    return launches


def phase_tooling(folder, root):
    """12d: the file tools on 12b's folder, in process: generate-
    pointclouds, registered-cloud along 12b's estimated trajectory,
    plot-trajectory of it into frame 0, associate of rgb/depth lists."""
    from PIL import Image

    from cvo_rgbd_torch import cli
    from cvo_rgbd_torch.io import load_assoc, read_pcd

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        return buf.getvalue().splitlines()

    t0 = time.perf_counter()
    entries = load_assoc(os.path.join(folder, "assoc.txt"))
    n = len(entries)
    est = os.path.join(folder, "cvo_poses_qt.txt")

    clouds = os.path.join(root, "clouds")
    lines = run(["generate-pointclouds", folder, "1", "--out", clouds,
                 "--stride", "2"])
    files = sorted(os.listdir(clouds))
    first = read_pcd(os.path.join(clouds, files[0]))
    check(lines == [f"{n} clouds -> {clouds}"] and len(files) == n
          and files[0] == f"{entries[0].name}.pcd"
          and first["positions"].shape[0] > 0,
          f"12d generate-pointclouds: {lines}, {len(files)} files")

    ply = os.path.join(root, "registered.ply")
    lines = run(["registered-cloud", folder, "1", est, "--output", ply,
                 "--downsample", "0.01"])
    with open(ply) as f:
        text = f.read().split("end_header\n")
    n_vertex = int(text[0].split("element vertex ")[1].split()[0])
    check(n_vertex > 0 and len(text[1].splitlines()) == n_vertex
          and lines == [f"{n_vertex} points from {n} frames -> {ply}"],
          f"12d registered-cloud: {lines}")

    png = os.path.join(root, "trajectory.png")
    lines = run(["plot-trajectory", folder, "1", est, "--output", png])
    with Image.open(png) as img:
        size = img.size
    check(size == (128, 96) and lines == [
        f"frame {entries[0].name} + {n} poses -> {png}"],
        f"12d plot-trajectory: {lines}, {size}")

    lists = []
    for kind, dt in (("rgb", 0.0), ("depth", 0.01)):
        path = os.path.join(root, f"{kind}.txt")
        with open(path, "w") as f:
            f.write(f"# {kind}\n" + "".join(
                f"{float(e.name) + dt:.6f} {kind}/{e.name}.png\n"
                for e in entries))
        lists.append(path)
    lines = run(["associate", *lists])
    check(len(lines) == n and lines[0].split()[1] == entries[0].rgb_path,
          f"12d associate: {len(lines)} lines")
    log(f"12d tools: {n} clouds, a registered PLY of {n_vertex} vertices, "
        f"a {size[0]}x{size[1]} trajectory PNG, {len(lines)} associations "
        f"in {time.perf_counter() - t0:.2f} s")


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

    # 4d. align_jit, the loop as CUDA graphs, against align; frames 2-3
    # give the three pairs through one compiled align
    c2 = fe(frames[2][2], frames[2][3])
    c3 = fe(frames[3][2], frames[3][3])
    phase_align_jit([
        ("cvo", p, c0, c1), ("acvo exact", pa, a0, a1),
        ("acvo cheb", dataclasses.replace(pa, self_mode="cheb"), a0, a1),
        ("direct", dataclasses.replace(p, step_mode="direct"), c0, c1),
        ("linear", MATLAB_PARAMS, *lin[FINE_GRID][:2]),
    ], [(c0, c1), (c1, c2), (c2, c3)], p)
    mark("4d (align_jit)")

    launches = {k: 0 for k in KERNELS + FUSED + BATCHED
                + (LANE_GRAM, LANE_MOM, LANE_WSQ, PROBE)}
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
    # 5e. cli run's per-frame work outside align, compiled, at 480x640
    _added(launches, phase_frontend_jit(p, pa, pf, paf))
    mark("5e (the compiled frontend at 480x640)")

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
    # are tiled (3072); the kernel runs' color_gram launches are batched
    tmp8 = tempfile.TemporaryDirectory()
    for q, adaptive, root in ((pf, False, tmp8.name), (paf, True, None),
                              (p, False, None), (pa, True, None)):
        got = phase_batched_odometry(frames, q, adaptive, root)
        launches["align_fused_tiled_batched"] += got.pop("align_fused")
        launches[LANE_GRAM] += got.pop("color_gram")
        launches[LANE_WSQ] += got.pop("fused_wsq")
        for k in ("fused_moments", "fused_flow", "fused_step_coeffs",
                  LANE_MOM):
            launches[k] += got[k]
    tmp8.cleanup()
    mark("8b (batched odometry)")
    # 8c. color_gram's lane axis at 8b's batch (9 render pairs at 3072)
    # and at 8's (63 pcd lanes at the coarse grid)
    render = [fe(f[2], f[3]) for f in frames]
    kernels[LANE_GRAM] = phase_color_gram_batched(render, sets, p)
    mark("8c (color_gram lanes)")
    # 8d. fused_moments's lane axis at the same two batches
    kernels[LANE_MOM] = phase_moments_batched(render, sets, p)
    mark("8d (fused_moments lanes)")
    # 8f. fused_wsq's lane axis: exact acvo's self-sweeps at the same two
    # batches, and a batch's Chebyshev tables
    render_a = [fe_a(f[2], f[3]) for f in frames]
    kernels[LANE_WSQ] = phase_wsq_batched(render_a, sets, pa)
    mark("8f (fused_wsq lanes)")
    # 8e. the batched loop on every form it runs, lanes against align_jit
    got = phase_batched_loop(render, render_a, sets, p, pa)
    launches[LANE_GRAM] += got.pop("color_gram")
    launches[LANE_WSQ] += got.pop("fused_wsq")
    _added(launches, got)
    mark("8e (the batched loop)")

    # 9. keyframe SLAM: cli slam, then the fast kernels' main path
    tmp9 = tempfile.TemporaryDirectory()
    got, got_fast, slam_gt = phase_slam(scene, tmp9.name)
    for k, v in got.items():
        launches[k] += v
    for k, v in got_fast.items():
        launches[f"{k}/fast"] = v
    kernels.update(fast_rows)
    mark("9 (slam)")
    # 9b. the same work outside align as captured programs
    _added(launches, phase_slam_jit(tmp9.name))
    mark("9b (slam programs)")

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
    got, slam_problem = phase_slam_refine(tmp9.name, slam_gt)
    for k, v in got.items():
        launches[k] += v
    tmp9.cleanup()
    mark("10e (slam --refine)")

    # 11. the mesh paths: rows 1-3 at their block shapes here, then ranks
    # sharing the card; at capacity 3072, and cut to a capacity whose
    # every row block holds valid rows (`filled`)
    f0, f1, f2 = filled([c0, c1, c2], MESH_SP)
    fa0, fa1 = filled([a0, a1], MESH_SP)
    mesh_rows, mesh_errs = phase_mesh_kernels(c0, c1, a0, p, pa)
    rows_filled, errs_filled = phase_mesh_kernels(f0, f1, fa0, p, pa,
                                                  every_block=True)
    for k, e in mesh_errs.items():
        mesh_rows[k] += rows_filled[k]
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], e,
                                        errs_filled[k])
    mark("11a (kernels at the mesh block shapes)")
    tmp11 = tempfile.TemporaryDirectory()
    for k, v in phase_mesh({"c0": c0, "c1": c1, "c2": c2, "a0": a0,
                            "a1": a1, "f0": f0, "f1": f1, "f2": f2,
                            "fa0": fa0, "fa1": fa1}, sets, slam_problem,
                           tmp11.name).items():
        launches[k] += v
    tmp11.cleanup()
    mark("11b-d (mesh paths)")
    log("11a rows: " + json.dumps(mesh_rows))

    # 12. degraded input and the rotation orbit: the failure paths on
    # the kernel backend, bench_degraded's sequence on the fused one, the
    # orbit, then the file tools on 12b's folder and trajectory
    tmp12 = tempfile.TemporaryDirectory()
    for k, v in phase_failure_paths(tmp12.name).items():
        launches[k] += v
    mark("12a (failure paths)")
    got, folder = phase_degraded_sequence(tmp12.name)
    for k, v in got.items():
        launches[k] += v
    mark("12b (degraded sequence)")
    for k, v in phase_orbit(tmp12.name).items():
        launches[k] += v
    mark("12c (rotation orbit)")
    phase_tooling(folder, tmp12.name)
    tmp12.cleanup()
    mark("12d (file tools)")

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
        LANE_GRAM: ("cvo_rgbd_torch/csrc/color_gram.cu",
                    "cvo_rgbd_tpu/ops/pallas_gram.py:401"),
        LANE_MOM: ("cvo_rgbd_torch/csrc/fused_moments.cu",
                   "cvo_rgbd_tpu/ops/pallas_moments.py:199"),
        LANE_WSQ: ("cvo_rgbd_torch/csrc/fused_wsq.cu",
                   "cvo_rgbd_tpu/ops/pallas_moments.py:320"),
        PROBE: ("cvo_rgbd_torch/csrc/construct_probe.cu",
                "scripts/tpu_construct_probe.py:24"),
    }
    names = KERNELS + FUSED + BATCHED + (LANE_GRAM, LANE_MOM, LANE_WSQ,
                                         PROBE) + FAST
    missing = [k for k in names if not launches[k]]
    check(not missing, f"kernels never launched on a main path: {missing}")
    rows = []
    for name in names:
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
