"""Batch pairwise registration over a directory of point-cloud files.

Port of the JAX package's `batch.py`, the MATLAB batch runner
`rgbddataset_rkhs.m`: sequential pairwise registration over a `pcd_ds/`
directory with range filter [0.8, 4] m + grid downsample
(rgbddataset_rkhs.m:34-47), per-pair skip-and-mark storing NaN on failure
(rgbddataset_rkhs.m:49-81), results + per-pair registration_time saved to
a timestamped npz (rgbddataset_rkhs.m:87-88 saves a .mat).

Aligns run on the card unless `device="cpu"`, with MATLAB_PARAMS (linear
color mode, MATLAB stops) on the port's default backend, "kernel".
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np
import torch

from cvo_rgbd_torch.core.cloud import cloud_ok, pad_cloud, round_up
from cvo_rgbd_torch.core.compiled import align_jit
from cvo_rgbd_torch.device import resolve_device
from cvo_rgbd_torch.io.pcd import read_pcd
from cvo_rgbd_torch.params import MATLAB_PARAMS
from cvo_rgbd_torch.utils import grid_downsample, range_filter


def load_pcd_dir(directory, rmin=0.8, rmax=4.0, grid=0.05):
    """Load + preprocess all .pcd files, sorted by name (timestamp):
    [(name, positions [N,3], colors [N,3] in 0..255)]."""
    paths = sorted(glob.glob(os.path.join(directory, "*.pcd")))
    clouds = []
    for p in paths:
        d = read_pcd(p)
        pos, col = d["positions"], d.get("colors")
        if col is None:
            col = np.zeros_like(pos)
        pos, col = range_filter(pos, col, rmin, rmax)
        pos, col = grid_downsample(pos, col, grid)
        clouds.append((os.path.basename(p), pos, col * 255.0))
    return clouds


def pad_clouds(clouds, device):
    """The loaded clouds padded to one capacity on `device`."""
    cap = round_up(max(c[1].shape[0] for c in clouds))
    return [pad_cloud(p, c, capacity=cap, device=device) for _, p, c in clouds]


def align_pairs(params, padded, min_valid=None):
    """Align every consecutive pair, each a cold start, then read all the
    results back in ONE host transfer.  Returns ({i: (tf [4,4] numpy,
    iterations, converged)} for pair i-1 -> i, {i: error message},
    per-cloud `cloud_ok` flags or None).  A pair whose align raises is
    recorded in the errors (the MATLAB runner's try/catch,
    rgbddataset_rkhs.m:75-80)."""
    dev = padded[0].positions.device
    oks = None if min_valid is None else [cloud_ok(c, min_valid)
                                           for c in padded]
    handles, errors = {}, {}
    for i in range(1, len(padded)):
        try:
            res = align_jit(params, padded[i - 1], padded[i], device=dev)
            handles[i] = (res.tf, res.iterations, res.converged)
        except Exception as e:  # skip-and-mark (rgbddataset_rkhs.m:75-80)
            errors[i] = str(e)
    keys = sorted(handles)
    parts = [handles[i][0].reshape(16) for i in keys]
    parts += [torch.stack([handles[i][1].to(torch.float32),
                           handles[i][2].to(torch.float32)]) for i in keys]
    parts += [o.to(torch.float32).reshape(1) for o in oks or ()]
    flat = (torch.cat(parts).cpu().numpy().astype(np.float64) if parts
            else np.zeros(0))
    k16 = 16 * len(keys)
    tfs = flat[:k16].reshape(-1, 4, 4)
    its = flat[k16:k16 + 2 * len(keys)].reshape(-1, 2)
    done = {i: (tfs[k], int(its[k, 0]), bool(its[k, 1]))
            for k, i in enumerate(keys)}
    ok_flags = None if oks is None else [bool(v) for v in
                                         flat[k16 + 2 * len(keys):]]
    return done, errors, ok_flags


def run_batch(directory, params=None, rmin=0.8, rmax=4.0, grid=0.05,
              output=None, min_valid=64, log=print, device=None):
    """Pairwise registration over the directory.

    Returns (results [n,4,4] with NaN rows on failure,
    registration_time [n-1]).  results[0] is identity; results[i] is the
    relative transform frame i-1 -> frame i, matching the MATLAB runner's
    per-pair affine3d array.

    `min_valid`: clouds with fewer valid points (or any non-finite valid
    position) mark both their pairs failed (core.cloud.cloud_ok, checked
    once per cloud), the MATLAB try/catch-NaN analog for degenerate
    inputs."""
    params = params or MATLAB_PARAMS
    dev = resolve_device(device)
    clouds = load_pcd_dir(directory, rmin, rmax, grid)
    if len(clouds) < 2:
        raise ValueError(f"need >= 2 .pcd files in {directory}")
    padded = pad_clouds(clouds, dev)

    n = len(clouds)
    results = np.full((n, 4, 4), np.nan)
    results[0] = np.eye(4)
    times = np.zeros(n - 1)
    # every pair is an independent cold start, so all aligns run first
    # and one transfer drains the results
    t0 = time.perf_counter()
    done, errors, oks = align_pairs(params, padded, min_valid)
    per = (time.perf_counter() - t0) / max(n - 1, 1)
    times[:] = per
    for i in range(1, n):
        if i in errors:
            status = f"FAILED ({errors[i]})"
        else:
            tf, its, conv = done[i]
            if not (oks[i - 1] and oks[i] and np.isfinite(tf).all()):
                status = "FAILED (non-finite transform or degenerate cloud)"
            else:
                results[i] = tf
                status = f"iters={its}" + ("" if conv else " not converged")
        log(f"pair {i - 1}->{i} ({clouds[i][0]}): {status} "
            f"t_avg={per * 1e3:.1f}ms (batch amortized: align+drain "
            "time / pairs, not a per-pair measurement)")

    if output is None:
        stamp = time.strftime("%d-%b-%Y-%H-%M-%S")
        output = os.path.join(directory, f"cvo_batch_{stamp}.npz")
    np.savez(
        output,
        results=results,
        registration_time=times,
        names=[c[0] for c in clouds],
    )
    log(f"saved {output}")
    return results, times
