"""Frame-to-frame odometry driver: the reference CLI loop, resumable.

Port of the JAX package's `odometry.py` (reference: cvo_main.cpp:8-73):
frontend -> align -> chain the accumulated pose, one TUM trajectory line
per frame, for cvo or adaptive cvo (adaptive_cvo_main.cpp), with
- an `OdometryState` checkpoint in the JAX package's JSON format, so a
  run of either package resumes in the other;
- skip-and-mark failures (rgbddataset_rkhs.m:49-81): a non-finite
  transform or a degenerate cloud marks the frame and keeps the
  previous pose.

The across-pair warm state (the reference's persistent R/T/ell members,
cvo.cpp:43-45, 398-399; acvo resets ell per pair, adaptive_cvo.cpp:475)
and its failure reset stay on the device, so
the host dispatches frame i+1 without waiting for frame i.  Results come
back every `fetch_every` frames in one `.cpu()` copy; pose chaining
happens on the host in float64 from those per-pair transforms.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from cvo_rgbd_torch.core.cloud import cloud_ok
from cvo_rgbd_torch.core.registration import align, check_supported
from cvo_rgbd_torch.device import pin_fp32, resolve_device
from cvo_rgbd_torch.frontend import make_frontend
from cvo_rgbd_torch.io.tum import load_assoc, write_trajectory_line
from cvo_rgbd_torch.params import AcvoParams, CvoParams


@dataclasses.dataclass
class FrameRecord:
    index: int
    name: str
    iterations: int
    converged: bool
    failed: bool
    seconds: float


@dataclasses.dataclass
class OdometryState:
    frame_index: int          # next frame to process
    accum: np.ndarray         # [4,4] accumulated transform
    # across-pair warm-start state: None = cold (identity / ell_init)
    warm_R: np.ndarray | None = None   # [3,3]
    warm_T: np.ndarray | None = None   # [3]
    warm_ell: float | None = None      # cvo only; acvo resets per pair

    def save(self, path):
        with open(path, "w") as f:
            json.dump(
                {
                    "frame_index": self.frame_index,
                    "accum": self.accum.tolist(),
                    "warm_R": None if self.warm_R is None
                    else np.asarray(self.warm_R).tolist(),
                    "warm_T": None if self.warm_T is None
                    else np.asarray(self.warm_T).tolist(),
                    "warm_ell": None if self.warm_ell is None
                    else float(self.warm_ell),
                },
                f,
            )

    @staticmethod
    def load(path) -> "OdometryState":
        with open(path) as f:
            d = json.load(f)

        def arr(v):
            return None if v is None else np.array(v, np.float32)

        return OdometryState(
            d["frame_index"], np.array(d["accum"]),
            warm_R=arr(d.get("warm_R")),
            warm_T=arr(d.get("warm_T")),
            warm_ell=d.get("warm_ell"),
        )


def _odom_step(params, adaptive, fixed, moving, warm, min_valid, device):
    """Align one pair and fold the warm-start bookkeeping on the device:
    returns (packed [19] = tf 16 | iterations | converged | finite,
    next warm (R, T, ell)).  Failure (non-finite tf or a degenerate
    cloud on either side) resets the warm state to cold; acvo's next ell
    is always ell_init (adaptive_cvo.cpp:475)."""
    R0, T0, ell0 = warm
    res = align(params, fixed, moving, R0, T0, ell0, device=device)
    finite = (
        torch.isfinite(res.tf).all()
        & cloud_ok(fixed, min_valid)
        & cloud_ok(moving, min_valid)
    )
    f32 = torch.float32
    Rw = torch.where(finite, res.R, torch.eye(3, dtype=f32, device=device))
    Tw = torch.where(finite, res.T, torch.zeros(3, dtype=f32, device=device))
    if adaptive:
        ellw = torch.full((), params.ell_init, dtype=f32, device=device)
    else:
        ellw = torch.where(finite, res.ell, params.ell_init)
    packed = torch.cat([
        res.tf.reshape(16),
        torch.stack([res.iterations.to(f32), res.converged.to(f32),
                     finite.to(f32)]),
    ])
    return packed, (Rw, Tw, ellw)


def run_odometry_frames(
    frames,
    dataset_seq,
    adaptive=False,
    params=None,
    traj=None,
    state: OdometryState | None = None,
    checkpoint=None,
    num_want=3000,
    warm_start=True,
    fetch_every=8,
    min_valid=64,
    log=print,
    device=None,
):
    """The odometry loop over `frames`, an iterable of
    (index, name, rgb [H,W,3], depth [H,W]) in sensor units.  Returns
    list[FrameRecord].

    `traj`: an open text file the TUM pose lines go to (None: none are
    written).  `state`: the resume state (frame_index, accum, warm
    R/T/ell), updated in place; frames before `state.frame_index - 1`
    must already be left out of `frames` by the caller.  `checkpoint`:
    path the state is saved to at every flush.

    `adaptive` picks acvo (HSV features, feature_type 0, and the
    adaptive ell, adaptive_cvo.cpp:451) over cvo (feature_type 1,
    cvo.cpp:340); `params` defaults to AcvoParams() or CvoParams().

    `warm_start` (default True = reference semantics): every pair after
    the first starts from the previous pair's converged relative
    transform and, for cvo, its final ell (acvo starts each pair at
    ell_init); a failed pair resets to identity/ell_init.  False starts
    every pair cold."""
    params = params or (AcvoParams() if adaptive else CvoParams())
    check_supported(params)
    dev = resolve_device(device)
    pin_fp32()
    frontend = make_frontend(dataset_seq, num_want, 0 if adaptive else 1,
                             device=str(dev))
    state = state or OdometryState(0, np.eye(4))

    f32 = torch.float32
    cold = (
        torch.eye(3, dtype=f32, device=dev),
        torch.zeros(3, dtype=f32, device=dev),
        torch.full((), params.ell_init, dtype=f32, device=dev),
    )
    warm = cold
    if warm_start and state.warm_R is not None:
        ell = (params.ell_init if adaptive or state.warm_ell is None
               else state.warm_ell)
        warm = (
            torch.as_tensor(state.warm_R, dtype=f32).to(dev),
            torch.as_tensor(state.warm_T, dtype=f32).to(dev),
            torch.full((), ell, dtype=f32, device=dev),
        )

    records: list[FrameRecord] = []
    pending: list[tuple] = []  # (index, name, packed [19] on device)
    chunk_t0 = time.time()

    def flush():
        nonlocal chunk_t0
        if not pending:
            return
        # ONE device->host copy for the chunk and the warm state
        flat = torch.cat(
            [p[2] for p in pending]
            + [warm[0].reshape(9), warm[1], warm[2].reshape(1)]
        ).cpu().numpy()
        per = (time.time() - chunk_t0) / len(pending)
        for k, (i, name, _) in enumerate(pending):
            row = flat[19 * k:19 * (k + 1)]
            tf = row[:16].reshape(4, 4)
            it, cv, fin = int(row[16]), bool(row[17]), bool(row[18])
            failed = not fin
            if failed:
                log(f"frame {i}: non-finite transform, skipping")
            else:
                state.accum = state.accum @ tf
            records.append(FrameRecord(
                index=i, name=name, iterations=it, converged=cv,
                failed=failed, seconds=per,
            ))
            if traj is not None:
                write_trajectory_line(traj, name, state.accum)
            state.frame_index = i + 1
            log(f"frame {i}: iters={it} conv={cv} t={per * 1000:.1f}ms")
        if traj is not None:
            traj.flush()
        if checkpoint:
            if warm_start:
                w = flat[19 * len(pending):]
                state.warm_R = w[:9].reshape(3, 3).astype(np.float32)
                state.warm_T = w[9:12].astype(np.float32)
                state.warm_ell = None if adaptive else float(w[12])
            state.save(checkpoint)
        pending.clear()
        chunk_t0 = time.time()

    fixed_cloud = None
    total_t0 = time.time()
    for i, name, rgb, dep in frames:
        cloud = frontend(rgb, dep)
        if fixed_cloud is None:
            # the first frame seeds the fixed cloud (cvo.cpp:326-334)
            fixed_cloud = cloud
            if i >= state.frame_index:
                if traj is not None:
                    write_trajectory_line(traj, name, state.accum)
                state.frame_index = i + 1
            continue
        packed, nxt = _odom_step(params, adaptive, fixed_cloud, cloud,
                                 warm if warm_start else cold, min_valid, dev)
        if warm_start:
            warm = nxt
        pending.append((i, name, packed))
        fixed_cloud = cloud
        if len(pending) >= fetch_every:
            flush()
    flush()

    n = len(records)
    if n:
        total = time.time() - total_t0
        log(f"processed {n} pairs in {total:.1f}s ({n / total:.2f} frames/s)")
    return records


def load_image_pair(folder, entry):
    """8-bit RGB + 16-bit depth PNGs (cvo_main.cpp:104-107)."""
    from PIL import Image

    rgb = np.asarray(
        Image.open(os.path.join(folder, entry.rgb_path)).convert("RGB"),
        dtype=np.float32,
    )
    dep = np.asarray(
        Image.open(os.path.join(folder, entry.depth_path)), dtype=np.float32
    )
    return rgb, dep


def run_odometry(
    folder,
    dataset_seq,
    adaptive=False,
    params=None,
    output=None,
    max_frames=None,
    checkpoint=None,
    num_want=3000,
    warm_start=True,
    fetch_every=8,
    min_valid=64,
    log=print,
    device=None,
):
    """Run odometry over a TUM-format folder (assoc.txt + PNGs) and write
    the trajectory to `output` (default <folder>/acvo_poses_qt.txt for
    acvo, else <folder>/cvo_poses_qt.txt).  Resumes from `checkpoint`
    when it exists.  Returns list[FrameRecord]."""
    params = params or (AcvoParams() if adaptive else CvoParams())
    check_supported(params)
    entries = load_assoc(os.path.join(folder, "assoc.txt"))
    if max_frames:
        entries = entries[:max_frames]
    if output is None:
        output = os.path.join(
            folder, "acvo_poses_qt.txt" if adaptive else "cvo_poses_qt.txt"
        )

    state = OdometryState(0, np.eye(4))
    mode = "w"
    if checkpoint and os.path.exists(checkpoint):
        state = OdometryState.load(checkpoint)
        mode = "a"
        log(f"resuming at frame {state.frame_index}")
    start = max(state.frame_index - 1, 0)

    def frames():
        for i in range(start, len(entries)):
            rgb, dep = load_image_pair(folder, entries[i])
            yield i, entries[i].name, rgb, dep

    with open(output, mode) as traj:
        return run_odometry_frames(
            frames(), dataset_seq, adaptive=adaptive, params=params,
            traj=traj, state=state,
            checkpoint=checkpoint, num_want=num_want, warm_start=warm_start,
            fetch_every=fetch_every, min_valid=min_valid, log=log,
            device=device,
        )
