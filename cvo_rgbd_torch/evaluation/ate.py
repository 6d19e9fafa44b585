"""Absolute Trajectory Error — the headline acceptance metric.

Re-implements evaluate_ate.py: Horn closed-form SVD alignment of the
estimated trajectory against ground truth (evaluate_ate.py:47-79) and
the RMSE statistic (evaluate_ate.py:152-162).
"""

from __future__ import annotations

import numpy as np

from cvo_rgbd_torch.evaluation.associate import associate


def horn_align(model, data):
    """Align two [3,N] point sets (Horn 1987, evaluate_ate.py:47-79).

    Returns (rot [3,3], trans [3,1], trans_error [N]) such that
    rot @ model + trans ~= data.
    """
    model = np.asarray(model, dtype=np.float64)
    data = np.asarray(data, dtype=np.float64)
    model_zero = model - model.mean(1, keepdims=True)
    data_zero = data - data.mean(1, keepdims=True)
    W = model_zero @ data_zero.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    aligned = rot @ model + trans
    err = aligned - data
    trans_error = np.sqrt(np.sum(err * err, axis=0))
    return rot, trans, trans_error


def ate_rmse(gt_traj, est_traj, max_difference=0.02, offset=0.0):
    """ATE statistics between {t: [4,4]} trajectories.

    Association + Horn alignment + RMSE (evaluate_ate.py:129-162).
    Returns dict with rmse/mean/median/std/min/max/pairs.
    """
    gt_stamps = {t: m[:3, 3] for t, m in gt_traj.items()}
    est_stamps = {t: m[:3, 3] for t, m in est_traj.items()}
    matches = associate(gt_stamps, est_stamps, offset, max_difference)
    if len(matches) < 2:
        raise ValueError(
            f"only {len(matches)} matched pairs; check timestamps"
        )
    gt_xyz = np.array([gt_stamps[a] for a, _ in matches]).T
    est_xyz = np.array([est_stamps[b] for _, b in matches]).T
    _, _, trans_error = horn_align(est_xyz, gt_xyz)
    return {
        "rmse": float(np.sqrt(np.mean(trans_error**2))),
        "mean": float(np.mean(trans_error)),
        "median": float(np.median(trans_error)),
        "std": float(np.std(trans_error)),
        "min": float(np.min(trans_error)),
        "max": float(np.max(trans_error)),
        "pairs": len(matches),
    }
