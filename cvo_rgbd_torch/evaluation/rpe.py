"""Relative Pose Error over fixed deltas.

Re-implements evaluate_rpe.py:204-298 (`evaluate_trajectory`): pairs of
poses separated by a fixed delta in frames/seconds/meters/radians, with
translational and rotational error statistics.
"""

from __future__ import annotations

import numpy as np


def _distances_along_trajectory(traj):
    keys = sorted(traj.keys())
    motion = [
        np.linalg.inv(traj[keys[i]]) @ traj[keys[i + 1]]
        for i in range(len(keys) - 1)
    ]
    dist = [0.0]
    s = 0.0
    for t in motion:
        s += float(np.linalg.norm(t[:3, 3]))
        dist.append(s)
    return dist


def _rotations_along_trajectory(traj, scale=1.0):
    keys = sorted(traj.keys())
    motion = [
        np.linalg.inv(traj[keys[i]]) @ traj[keys[i + 1]]
        for i in range(len(keys) - 1)
    ]
    dist = [0.0]
    s = 0.0
    for t in motion:
        s += _rot_angle(t) * scale
        dist.append(s)
    return dist


def _rot_angle(T):
    return float(
        np.arccos(np.clip((np.trace(T[:3, :3]) - 1) / 2, -1, 1))
    )


def rpe(
    gt_traj,
    est_traj,
    delta=1.0,
    delta_unit="s",
    offset=0.0,
    max_pairs=10000,
    fixed_delta=True,
    seed=0,
):
    """RPE statistics.  Returns dict with trans_rmse (m), rot_rmse (rad),
    and per-stat breakdowns (evaluate_rpe.py:204-298)."""
    stamps_gt = sorted(gt_traj.keys())
    stamps_est = sorted(est_traj.keys())
    stamps_est_ret = [
        min(stamps_gt, key=lambda x, t=t: abs(x - (t + offset)))
        for t in stamps_est
    ]

    if delta_unit == "s":
        index_est = stamps_est
    elif delta_unit == "m":
        index_est = _distances_along_trajectory(
            {t: est_traj[t] for t in stamps_est}
        )
    elif delta_unit == "rad":
        index_est = _rotations_along_trajectory(
            {t: est_traj[t] for t in stamps_est}
        )
    elif delta_unit == "deg":
        index_est = _rotations_along_trajectory(
            {t: est_traj[t] for t in stamps_est}, 180.0 / np.pi
        )
    elif delta_unit == "f":
        index_est = list(range(len(stamps_est)))
    else:
        raise ValueError(f"unknown delta_unit {delta_unit!r}")

    if not fixed_delta:
        rng = np.random.default_rng(seed)  # evaluate_rpe.py:309 seeds too
        pairs = [
            (i, j)
            for i, j in zip(
                rng.integers(0, len(stamps_est), max_pairs),
                rng.integers(0, len(stamps_est), max_pairs),
            )
            if i != j
        ]
    else:
        pairs = []
        for i in range(len(index_est)):
            j = np.searchsorted(index_est, index_est[i] + delta)
            if j < len(stamps_est):
                pairs.append((i, j))
        if max_pairs and len(pairs) > max_pairs:
            rng = np.random.default_rng(seed)
            sel = rng.choice(len(pairs), max_pairs, replace=False)
            pairs = [pairs[k] for k in sel]

    t_err, r_err = [], []
    for i, j in pairs:
        gt_i = gt_traj[stamps_est_ret[i]]
        gt_j = gt_traj[stamps_est_ret[j]]
        est_i = est_traj[stamps_est[i]]
        est_j = est_traj[stamps_est[j]]
        error44 = np.linalg.inv(np.linalg.inv(gt_i) @ gt_j) @ (
            np.linalg.inv(est_i) @ est_j
        )
        t_err.append(float(np.linalg.norm(error44[:3, 3])))
        r_err.append(_rot_angle(error44))
    t_err = np.array(t_err)
    r_err = np.array(r_err)
    if len(t_err) == 0:
        raise ValueError("no RPE pairs found")
    return {
        "trans_rmse": float(np.sqrt(np.mean(t_err**2))),
        "trans_mean": float(np.mean(t_err)),
        "trans_median": float(np.median(t_err)),
        "rot_rmse": float(np.sqrt(np.mean(r_err**2))),
        "rot_mean": float(np.mean(r_err)),
        "pairs": len(t_err),
    }
