"""Where the card's fused odometry parts from the CPU's plain version on
bench.py's degraded sequence (`chip_smoke.py`'s phase 12b).

    python -m cvo_rgbd_torch.stop_skew [--frames N] [--out PATH]

The sequence is bench.py's `bench_degraded`: N frames (100) of the
revisit path, 2e-3 depth noise, 8% dropout, low texture every 25 frames
from 12, total dropout at 50, seed 3.  It is registered as phase 12b
registers it: cvo on the fused backend (resident at num_want=1024), the
MATLAB stops (eps=5e-4, eps_2=1e-4), each pair warm-started from the
last.  The script runs

1. the frontend on the card and on the CPU, frame by frame: the masks'
   agreement and the largest position and feature difference;
2. the sequential loop of `run_odometry` twice, on the card and on the
   CPU's plain versions, each from its own clouds: per pair the
   iterations and the transform;
3. a replay: every pair aligned on the card again from the CPU loop's
   own inputs (its clouds and its warm state), so that the two sides
   differ in the align alone.

It prints the card's name and power limit, one JSON line a pair and a
last JSON line: the replay's pairs of equal and of differing stops, each
with its largest transform difference from the CPU (and the median at
equal stops), and the ATE of the CPU loop, of the card's loop, and of
the CPU loop with the replay's transforms put in at every pair, at the
pairs of equal stops only and at those of differing stops only.  `--out`
writes all of it as one JSON file too.  It needs a card.  `chip_smoke.py`
runs `compare` on the first frames of its phase 12b folder as a gate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

NUM_WANT = 1024
MIN_VALID = 64


def make_sequence(folder, n_frames, drop=50):
    """bench.py's `bench_degraded` folder, as phase 12b writes it."""
    from cvo_rgbd_torch.synth import Degradation, make_tum_dataset, revisit_path

    make_tum_dataset(folder, revisit_path(n_frames, period=33),
                     degrade=Degradation(
                         depth_noise=2e-3, dropout=0.08,
                         low_texture_frames=tuple(range(12, n_frames, 25)),
                         drop_frames=(drop,), seed=3))


def frontend_clouds(folder, entries, device):
    from cvo_rgbd_torch.frontend import make_frontend
    from cvo_rgbd_torch.odometry import load_image_pair

    fe = make_frontend(1, NUM_WANT, 1, device=device)
    return [fe(*load_image_pair(folder, e)) for e in entries]


def odometry_loop(params, clouds, device, replay_on=None):
    """`run_odometry_frames`' loop over `clouds` on `device`: one row a
    pair (tf 16 | iterations | converged | finite).  With `replay_on`,
    also each pair aligned on that device from this loop's own clouds and
    warm state.  Returns (rows, replay rows or None) as numpy arrays."""
    import torch

    from cvo_rgbd_torch.odometry import _odom_step

    f32 = torch.float32
    cold = (torch.eye(3, dtype=f32, device=device),
            torch.zeros(3, dtype=f32, device=device),
            torch.full((), params.ell_init, dtype=f32, device=device))
    warm, rows, replays = cold, [], []
    for k in range(1, len(clouds)):
        fixed, moving = clouds[k - 1], clouds[k]
        if replay_on is not None:
            row, _ = _odom_step(params, False, fixed.to(replay_on),
                                moving.to(replay_on),
                                tuple(w.to(replay_on) for w in warm),
                                MIN_VALID, replay_on)
            replays.append(row.cpu())
        row, warm = _odom_step(params, False, fixed, moving, warm,
                               MIN_VALID, device)
        rows.append(row.cpu())
    stack = torch.stack
    return (stack(rows).numpy(),
            stack(replays).numpy() if replay_on is not None else None)


def chain(rows, stamps):
    """The trajectory `run_odometry` writes from the pair rows: a failed
    pair (non-finite) carries the pose."""
    accum = np.eye(4)
    traj = {stamps[0]: accum}
    for row, t in zip(rows, stamps[1:]):
        if row[18]:
            accum = accum @ row[:16].reshape(4, 4)
        traj[t] = accum
    return traj


def compare(folder, n_frames=None, card="cuda", log=print):
    """The three comparisons on the first `n_frames` frames of `folder`
    (all of them by default); returns the report."""
    import torch

    from cvo_rgbd_torch.device import pin_fp32
    from cvo_rgbd_torch.evaluation import ate_rmse
    from cvo_rgbd_torch.io.tum import load_assoc, read_trajectory
    from cvo_rgbd_torch.params import CvoParams

    pin_fp32()
    params = CvoParams(eps=5e-4, eps_2=1e-4, backend="fused")
    entries = load_assoc(os.path.join(folder, "assoc.txt"))[:n_frames]
    gt = read_trajectory(os.path.join(folder, "groundtruth.txt"))
    on_card = frontend_clouds(folder, entries, card)
    on_cpu = frontend_clouds(folder, entries, "cpu")
    stamps = [float(e.name) for e in entries]

    frames = []
    for a, b in zip(on_card, on_cpu):
        a = a.to("cpu")
        frames.append({
            "mask_equal": bool(torch.equal(a.mask, b.mask)),
            "positions": (a.positions - b.positions).abs().max().item(),
            "features": (a.features - b.features).abs().max().item()})

    t0 = time.perf_counter()
    card_rows, _ = odometry_loop(params, on_card, card)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_rows, replay_rows = odometry_loop(params, on_cpu, "cpu",
                                          replay_on=card)
    t_cpu = time.perf_counter() - t0

    pairs, equal, differ = [], [], []
    for k, (c, g, r) in enumerate(zip(cpu_rows, card_rows, replay_rows)):
        p = {"pair": k + 1,
             "iterations": {"cpu": int(c[16]), "card": int(g[16]),
                            "replay": int(r[16])},
             "failed": {"cpu": not c[18], "card": not g[18],
                        "replay": not r[18]}}
        if c[18] and g[18] and r[18]:
            p["tf_diff"] = {
                "card": float(np.abs(g[:16] - c[:16]).max()),
                "replay": float(np.abs(r[:16] - c[:16]).max())}
            (equal if r[16] == c[16] else differ).append(k)
        pairs.append(p)
        log(json.dumps(p))

    def ate(rows):
        return ate_rmse(gt, chain(rows, stamps))["rmse"]

    def put_in(at):
        rows = cpu_rows.copy()
        rows[at] = replay_rows[at]
        return rows

    def diffs(ks):
        return [pairs[k]["tf_diff"]["replay"] for k in ks] or [0.0]

    split = next((p["pair"] for p in pairs
                  if p["iterations"]["card"] != p["iterations"]["cpu"]),
                 None)
    summary = {
        "frames": len(entries),
        "frontend": {
            "masks_equal": sum(f["mask_equal"] for f in frames),
            "positions": max(f["positions"] for f in frames),
            "features": max(f["features"] for f in frames)},
        "loops": {"first_pair_whose_stops_part": split,
                  "pairs_of_equal_stops": sum(
                      p["iterations"]["card"] == p["iterations"]["cpu"]
                      for p in pairs),
                  "card_seconds": t_card, "cpu_seconds": t_cpu},
        "replay": {"equal_stops": len(equal),
                   "equal_stops_tf_diff": max(diffs(equal)),
                   "equal_stops_tf_diff_median": float(
                       np.median(diffs(equal))),
                   "differing_stops": len(differ),
                   "differing_stops_tf_diff": max(diffs(differ)),
                   "differing_pairs": [k + 1 for k in differ]},
        "ate": {"cpu": ate(cpu_rows), "card": ate(card_rows),
                "cpu_with_replay_everywhere": ate(replay_rows),
                "cpu_with_replay_at_equal_stops": ate(put_in(equal)),
                "cpu_with_replay_at_differing_stops": ate(put_in(differ))},
    }
    return {"pairs": pairs, "frames": frames, "summary": summary}


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(prog="python -m cvo_rgbd_torch.stop_skew")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--out", default=None, help="write the report here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stop_skew: no CUDA device", file=sys.stderr)
        return 2
    from cvo_rgbd_torch.time_fused import card_line

    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory(prefix="stop_skew_") as folder:
        make_sequence(folder, args.frames)
        report = compare(folder)
    report["card"] = card_line()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
