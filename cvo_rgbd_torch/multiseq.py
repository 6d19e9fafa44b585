"""Multi-sequence odometry: batch data parallelism over sequences.

Port of the JAX package's `multiseq.py`.  The reference processes one
sequence at a time (cvo_main.cpp:36-66); here S sequences advance in
lockstep, and each step registers S frame pairs, one per sequence, in
one `parallel.align_batched` call (on the fused backend, one kernel
launch).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from cvo_rgbd_torch.core.cloud import PointCloud, cloud_ok, stack_clouds
from cvo_rgbd_torch.core.registration import check_supported
from cvo_rgbd_torch.device import pin_fp32, resolve_device
from cvo_rgbd_torch.frontend import make_frontend
from cvo_rgbd_torch.io.tum import load_assoc, write_trajectory_line
from cvo_rgbd_torch.odometry import load_image_pair
from cvo_rgbd_torch.params import AcvoParams, CvoParams


def lane_post(res, fixed_b: PointCloud, moving_b: PointCloud, adaptive,
              ell_init, min_valid=64):
    """The per-lane warm-state update on the device (the JAX package's
    `_compiled_lane_post`, multiseq.py:28-59): (ok [S], R [S,3,3],
    T [S,3], ell [S]).  A failed lane, a non-finite transform or a
    degenerate cloud on either side, resets to cold (skip-and-mark, as
    `run_odometry`); a good lane carries its R/T and, for cvo, its ell
    (acvo resets ell per pair, adaptive_cvo.cpp:475).  A retired lane's
    all-masked cloud fails too, which is harmless: its results are never
    written.  Nothing here waits on the host, so the lockstep chain
    dispatches step k+1 before step k is read back."""
    ok = (torch.isfinite(res.tf).all(dim=-1).all(dim=-1)
          & cloud_ok(fixed_b, min_valid) & cloud_ok(moving_b, min_valid))
    f32 = torch.float32
    eye = torch.eye(3, dtype=f32, device=ok.device)
    R = torch.where(ok[:, None, None], res.R, eye)
    T = torch.where(ok[:, None], res.T, 0.0)
    if adaptive:
        ell = torch.full_like(res.ell, ell_init)
    else:
        ell = torch.where(ok, res.ell, ell_init)
    return ok, R, T, ell


def run_multiseq(
    folders,
    dataset_seq,
    adaptive=False,
    params=None,
    num_want=3000,
    max_frames=None,
    mesh=None,
    warm_start=True,
    fetch_every=4,
    min_valid=64,
    log=print,
    device=None,
):
    """Run odometry on several TUM folders in lockstep, on `device` (the
    card unless `device="cpu"`).  Returns {folder: trajectory_path}, each
    `<folder>/cvo_poses_qt_batch.txt` (acvo: `acvo_poses_qt_batch.txt`).

    A sequence shorter than the longest is retired once it ends: its lane
    gets an all-masked cloud, which converges at iteration 0, so a
    finished lane neither holds up the batch's iterations nor pays
    frontend or image work, and its trajectory stops growing.  `adaptive`
    picks acvo (HSV features, AcvoParams defaults), as `run_odometry`.

    `warm_start` (default True): each lane is its own sequence, so the
    reference's across-pair warm start (R/T/ell persistence,
    cvo.cpp:43-45, 398-399) applies per lane, on the device
    (`lane_post`).  `fetch_every`: lockstep steps between device->host
    reads; pose chaining and trajectory writes happen at each read, from
    the same per-pair transforms whatever the cadence.  `mesh` (lanes
    sharded over devices) is not ported."""
    params = params or (AcvoParams() if adaptive else CvoParams())
    check_supported(params)
    dev = resolve_device(device)
    pin_fp32()
    frontend = make_frontend(dataset_seq, num_want, 0 if adaptive else 1,
                             device=str(dev))
    from cvo_rgbd_torch.parallel import align_batched

    seqs = []
    for folder in folders:
        entries = load_assoc(os.path.join(folder, "assoc.txt"))
        if max_frames:
            entries = entries[:max_frames]
        seqs.append({"folder": folder, "entries": entries, "accum": np.eye(4)})
    n_steps = max(len(s["entries"]) for s in seqs)
    name = "acvo_poses_qt_batch.txt" if adaptive else "cvo_poses_qt_batch.txt"
    outs = {s["folder"]: os.path.join(s["folder"], name) for s in seqs}
    handles = [open(outs[s["folder"]], "w") for s in seqs]

    t0 = time.time()
    pairs_done = 0
    prev_clouds = None
    empty_cloud = None   # all-masked stand-in for a retired lane
    S = len(seqs)
    f32 = torch.float32
    # per-lane warm state: identity / ell_init = cold
    warm = (torch.eye(3, dtype=f32, device=dev).expand(S, 3, 3),
            torch.zeros((S, 3), dtype=f32, device=dev),
            torch.full((S,), params.ell_init, dtype=f32, device=dev))
    pending = []   # (step, [S, 17] tf 16 | ok on the device)

    def flush():
        nonlocal pairs_done
        if not pending:
            return
        # one device->host copy for the steps since the last read
        flat = torch.cat([rows for _, rows in pending]).cpu().numpy()
        for k, (step, _) in enumerate(pending):
            rows = flat[k * S:(k + 1) * S]
            for si, s in enumerate(seqs):
                if step >= len(s["entries"]):
                    continue
                if rows[si, 16]:
                    s["accum"] = s["accum"] @ rows[si, :16].reshape(4, 4)
                else:
                    # skip-and-mark (rgbddataset_rkhs.m:49-81): keep the
                    # previous accumulated pose
                    log(f"{s['folder']} step {step}: non-finite "
                        "transform, skipping")
                write_trajectory_line(handles[si], s["entries"][step].name,
                                      s["accum"])
                pairs_done += 1
        pending.clear()

    try:
        for step in range(n_steps):
            clouds = []
            for s in seqs:
                if step < len(s["entries"]):
                    rgb, dep = load_image_pair(s["folder"],
                                               s["entries"][step])
                    clouds.append(frontend(rgb, dep))
                else:
                    clouds.append(empty_cloud)
            if empty_cloud is None:
                empty_cloud = PointCloud(*(torch.zeros_like(t)
                                           for t in clouds[0]))
            if prev_clouds is not None:
                fb, mb = stack_clouds(prev_clouds), stack_clouds(clouds)
                kw = dict(zip(("R0", "T0", "ell0"), warm)) if warm_start \
                    else {}
                res = align_batched(params, fb, mb, mesh=mesh, device=dev,
                                    **kw)
                ok, R, T, ell = lane_post(res, fb, mb, adaptive,
                                          params.ell_init, min_valid)
                if warm_start:
                    warm = (R, T, warm[2] if adaptive else ell)
                pending.append((step, torch.cat(
                    [res.tf.reshape(S, 16), ok.to(f32)[:, None]], dim=1)))
                if len(pending) >= fetch_every:
                    flush()
            else:
                for si, s in enumerate(seqs):
                    write_trajectory_line(handles[si], s["entries"][0].name,
                                          s["accum"])
            prev_clouds = clouds
            if step % 10 == 0:
                log(f"step {step}/{n_steps}")
        flush()
    finally:
        for h in handles:
            h.close()
    dt = time.time() - t0
    if pairs_done:
        log(f"{pairs_done} pairs across {len(seqs)} sequences in {dt:.1f}s "
            f"({pairs_done / dt:.2f} pairs/s)")
    return outs
