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

`run_odometry_batched[_frames]` is the offline form (the JAX package's
`odometry.py:run_odometry_batched`): the frame pairs are independent,
so `batch` of them are registered per `parallel.align_batched` call (on
the fused backend, one kernel launch) and chained afterwards.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from cvo_rgbd_torch.core.cloud import cloud_ok, stack_clouds
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


def run_odometry_batched_frames(
    frames,
    dataset_seq,
    adaptive=False,
    params=None,
    traj=None,
    num_want=3000,
    batch=8,
    motion_prior=False,
    min_valid=64,
    log=print,
    device=None,
):
    """Offline odometry over `frames` (as `run_odometry_frames` takes
    them) with batched pair registration: `batch` pairs per
    `parallel.align_batched` call, the last chunk padded by repeating its
    last pair, then the poses chained on the host.  Every pair starts
    cold (identity, ell_init).  Returns list[FrameRecord]; the TUM lines
    go to `traj` (an open text file, or None).

    `motion_prior` (default False): warm-start every lane of chunk k+1
    with the last sane relative transform of chunk k, a constant-velocity
    stand-in for the reference's across-pair warm start (lane j's true
    predecessor is lane j-1 of the same chunk).  The optimum is the same
    within tolerance and the iterations drop on smooth sequences; off by
    default, so the result does not depend on the chunking.

    `min_valid`: a pair touching a degenerate cloud (core.cloud.cloud_ok)
    is marked failed, as in `run_odometry_frames`, and never seeds the
    prior.  Without `motion_prior` the chunks are independent, so their
    results are read back four chunks at a time, in one copy."""
    from cvo_rgbd_torch.parallel import align_batched

    params = params or (AcvoParams() if adaptive else CvoParams())
    check_supported(params)
    dev = resolve_device(device)
    pin_fp32()
    frontend = make_frontend(dataset_seq, num_want, 0 if adaptive else 1,
                             device=str(dev))
    total_t0 = time.time()
    names, clouds = [], []
    for _, name, rgb, dep in frames:
        names.append(name)
        clouds.append(frontend(rgb, dep))
    if len(clouds) < 2:
        raise ValueError("need at least 2 frames")
    n_pairs = len(clouds) - 1
    # one cloud_ok a cloud, read back in one copy; the AND on the host
    oks = torch.stack([cloud_ok(c, min_valid) for c in clouds]).cpu().numpy()
    pair_ok = oks[:-1] & oks[1:]

    rels, iters, conv, pair_secs = [], [], [], []
    prior = None          # (R0 [3,3], T0 [3], ell0) from the last chunk
    pending = []          # (pair indices, [B, 18] results on the device)
    flush_chunks = 4
    group_t0 = time.time()

    def packed(res):
        b = res.tf.shape[0]
        return torch.cat([res.tf.reshape(b, 16),
                          res.iterations.to(torch.float32)[:, None],
                          res.converged.to(torch.float32)[:, None]], dim=1)

    def collect(idxs, rows, secs):
        for k, _ in enumerate(idxs):
            rels.append(rows[k, :16].reshape(4, 4).astype(np.float64))
            iters.append(int(rows[k, 16]))
            conv.append(bool(rows[k, 17]))
            pair_secs.append(secs)
        log(f"pairs {idxs[0]}..{idxs[-1]} registered")

    def flush_pending():
        nonlocal group_t0
        if not pending:
            return
        flat = torch.cat([rows for _, rows in pending]).cpu().numpy()
        per = (time.time() - group_t0) / sum(len(i) for i, _ in pending)
        at = 0
        for idxs, rows in pending:
            collect(idxs, flat[at:at + rows.shape[0]], per)
            at += rows.shape[0]
        pending.clear()
        group_t0 = time.time()

    for start in range(0, n_pairs, batch):
        chunk_t0 = time.time()
        idxs = list(range(start, min(start + batch, n_pairs)))
        pad = idxs + [idxs[-1]] * (batch - len(idxs))
        fb = stack_clouds([clouds[i] for i in pad])
        mb = stack_clouds([clouds[i + 1] for i in pad])
        kw = {}
        if motion_prior and prior is not None:
            kw = dict(
                R0=np.broadcast_to(prior[0], (batch, 3, 3)).copy(),
                T0=np.broadcast_to(prior[1], (batch, 3)).copy(),
                ell0=np.full((batch,), prior[2], np.float32),
            )
        res = align_batched(params, fb, mb, device=dev, **kw)
        if not motion_prior:
            pending.append((idxs, packed(res)))
            if len(pending) >= flush_chunks:
                flush_pending()
            continue
        # the prior needs this chunk's transforms before the next dispatch
        b = len(pad)
        flat = torch.cat([packed(res), res.R.reshape(b, 9), res.T,
                          res.ell[:, None]], dim=1).cpu().numpy()
        # the seed must come from a lane whose inputs were sane, not one
        # whose transform is merely finite (a degenerate cloud converges
        # to a finite identity)
        fin = np.isfinite(flat[:, :16]).all(axis=1) & pair_ok[np.array(pad)]
        if fin.any():
            last = int(np.max(np.nonzero(fin)[0]))
            prior = (flat[last, 18:27].reshape(3, 3), flat[last, 27:30],
                     params.ell_init if adaptive else float(flat[last, 30]))
        else:
            prior = None
        collect(idxs, flat, (time.time() - chunk_t0) / len(idxs))
    flush_pending()

    records = []
    accum = np.eye(4)
    if traj is not None:
        write_trajectory_line(traj, names[0], accum)
    for i, rel in enumerate(rels):
        failed = not (bool(pair_ok[i]) and bool(np.isfinite(rel).all()))
        if not failed:
            accum = accum @ rel
        if traj is not None:
            write_trajectory_line(traj, names[i + 1], accum)
        records.append(FrameRecord(
            index=i + 1, name=names[i + 1], iterations=iters[i],
            converged=conv[i], failed=failed, seconds=pair_secs[i],
        ))
    total = time.time() - total_t0
    log(f"{n_pairs} pairs in {total:.1f}s ({n_pairs / total:.2f} pairs/s, "
        f"batch={batch})")
    return records


def run_odometry_batched(
    folder,
    dataset_seq,
    adaptive=False,
    params=None,
    output=None,
    max_frames=None,
    num_want=3000,
    batch=8,
    use_native=True,
    motion_prior=False,
    min_valid=64,
    log=print,
    device=None,
):
    """`run_odometry_batched_frames` over a TUM-format folder, the
    trajectory written to `output` (default as `run_odometry`), the
    frames read as `make_frame_source(use_native=...)` reads them.
    Returns list[FrameRecord]."""
    entries = load_assoc(os.path.join(folder, "assoc.txt"))
    if max_frames:
        entries = entries[:max_frames]
    if output is None:
        output = os.path.join(
            folder, "acvo_poses_qt.txt" if adaptive else "cvo_poses_qt.txt"
        )

    frames = ((i, entries[i].name, rgb, dep) for i, rgb, dep in
              make_frame_source(folder, entries, 0, use_native))
    with open(output, "w") as traj:
        return run_odometry_batched_frames(
            frames, dataset_seq, adaptive=adaptive, params=params,
            traj=traj, num_want=num_want, batch=batch,
            motion_prior=motion_prior, min_valid=min_valid, log=log,
            device=device,
        )


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


def make_frame_source(folder, entries, start, use_native=True):
    """Yield (index, rgb [H,W,3] f32, depth [H,W] f32) for `entries` from
    `start` (the JAX package's `odometry.make_frame_source`).

    `use_native=True` reads through the native threaded prefetch loader
    (`cvo_rgbd_torch.native`), which decodes upcoming frames while the
    device registers the current pair; `use_native=False` reads each
    frame through PIL (`load_image_pair`) when it is needed.  Unlike the
    JAX package, a loader that cannot be built or fails does not fall
    back to PIL: it raises, so a broken build is never hidden behind a
    slower path."""
    if not use_native:
        def gen_pil():
            for i in range(start, len(entries)):
                yield (i, *load_image_pair(folder, entries[i]))

        return gen_pil()

    from cvo_rgbd_torch import native

    todo = entries[start:]
    if not todo:
        return iter(())
    rgb_paths = [os.path.join(folder, e.rgb_path) for e in todo]
    dep_paths = [os.path.join(folder, e.depth_path) for e in todo]
    h, w = native.png_shape(rgb_paths[0])
    dh, dw = native.png_shape(dep_paths[0])
    loader = native.PrefetchLoader(rgb_paths, dep_paths, w, h, dw, dh,
                                   workers=2, ahead=8)

    def gen():
        try:
            for off, rgb, dep in loader:
                yield (start + off, rgb.astype(np.float32),
                       dep.astype(np.float32))
        finally:
            loader.close()

    return gen()


def run_odometry(
    folder,
    dataset_seq,
    adaptive=False,
    params=None,
    output=None,
    max_frames=None,
    checkpoint=None,
    num_want=3000,
    use_native=True,
    warm_start=True,
    fetch_every=8,
    min_valid=64,
    log=print,
    device=None,
):
    """Run odometry over a TUM-format folder (assoc.txt + PNGs) and write
    the trajectory to `output` (default <folder>/acvo_poses_qt.txt for
    acvo, else <folder>/cvo_poses_qt.txt).  Resumes from `checkpoint`
    when it exists.  The PNGs are read by the native prefetch loader, or
    by PIL with `use_native=False` (`make_frame_source`).  Returns
    list[FrameRecord]."""
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

    frames = ((i, entries[i].name, rgb, dep) for i, rgb, dep in
              make_frame_source(folder, entries, start, use_native))
    with open(output, mode) as traj:
        return run_odometry_frames(
            frames, dataset_seq, adaptive=adaptive, params=params,
            traj=traj, state=state,
            checkpoint=checkpoint, num_want=num_want, warm_start=warm_start,
            fetch_every=fetch_every, min_valid=min_valid, log=log,
            device=device,
        )
