"""Evaluation plots: per-frame error CDFs and 3-D trajectory overlays.

The MATLAB plot tooling (rgbddataset_cdf_plots.m:49-129,
rgbddataset_trajectory_plot.m) in matplotlib (Agg backend, imported at
the first plot): relative-pose-error CDFs for any number of methods
against ground truth, trajectory plots, and the reference's
`cv_rgbd_poses.csv` per-frame relative poses for the OpenCV-VO
comparison.  Host numpy.
"""

from __future__ import annotations

import numpy as np


def relative_errors(gt_traj, est_traj):
    """Per-consecutive-frame relative pose errors (m, rad) — the
    quantity the CDF plots bin (rgbddataset_cdf_plots.m:49-99)."""
    stamps = sorted(set(gt_traj) & set(est_traj))
    t_err, r_err = [], []
    for a, b in zip(stamps[:-1], stamps[1:]):
        rel_gt = np.linalg.inv(gt_traj[a]) @ gt_traj[b]
        rel_est = np.linalg.inv(est_traj[a]) @ est_traj[b]
        e = np.linalg.inv(rel_gt) @ rel_est
        t_err.append(float(np.linalg.norm(e[:3, 3])))
        r_err.append(
            float(np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)))
        )
    return np.array(t_err), np.array(r_err)


def load_relative_pose_csv(path):
    """Read the reference's cv_rgbd_poses.csv format: one relative
    [4,4] transform per row.

    The vendored file (data/rgbd_dataset/freiburg1_desk/
    cv_rgbd_poses.csv:1-3) has a header line and 14 columns:
    frame1, frame2, tx, ty, tz, r11..r33 (row-major R) — consumed at
    rgbddataset_cdf_plots.m:91 as
    `H = [reshape(row(6:end),3,3)', row(3:5)'; 0 0 0 1]` (the MATLAB
    column-major reshape + transpose IS a row-major read).  Rows with
    H == I mark frames where the OpenCV VO failed
    (rgbddataset_cdf_plots.m:93-99).  Headerless 16- and 12-column
    row-major layouts are also accepted.
    """
    raw = np.loadtxt(path, delimiter=",", skiprows=_n_header_rows(path))
    if raw.ndim == 1:
        raw = raw[None, :]
    if raw.shape[1] == 16:
        return raw.reshape(-1, 4, 4)
    if raw.shape[1] == 14:
        # cv_rgbd layout: frame1, frame2, tx, ty, tz, r11..r33
        raw = raw[:, 2:]
        out = np.tile(np.eye(4), (raw.shape[0], 1, 1))
        out[:, :3, 3] = raw[:, :3]
        out[:, :3, :3] = raw[:, 3:12].reshape(-1, 3, 3)
        return out
    if raw.shape[1] == 12:
        # flattened [R|t] rows: r11 r12 r13 tx r21 ... tz (the top
        # 3x4 of H, row-major — NOT the 14-column t-first order)
        out = np.tile(np.eye(4), (raw.shape[0], 1, 1))
        out[:, :3, :4] = raw.reshape(-1, 3, 4)
        return out
    raise ValueError(f"unsupported csv shape {raw.shape}")


def _n_header_rows(path):
    with open(path) as f:
        first = f.readline().split(",")[0].strip()
    try:
        float(first)
        return 0
    except ValueError:
        return 1


def chain_relative_poses(rels, stamps, invert=False):
    """Chain per-frame relative transforms into an absolute trajectory
    {t: [4,4]} anchored at identity.

    `rels` [F-1 or F, 4, 4]; a leading identity row (the batch runners'
    result{1} convention, rgbddataset_rkhs.m:49) is detected and
    skipped.  `invert=True` chains H^-1 — the cv_rgbd_poses.csv rows
    store the transform whose INVERSE is the forward frame-to-frame
    motion (rgbddataset_cdf_plots.m:91-92 applies tfinv before
    comparing to inv(T_gt[i-1]) @ T_gt[i]).  Non-finite rows (failed
    pairs) freeze the pose (skip-and-mark continuity).
    """
    rels = np.asarray(rels, np.float64)
    if rels.shape[0] == len(stamps) and np.allclose(rels[0], np.eye(4)):
        rels = rels[1:]
    if rels.shape[0] != len(stamps) - 1:
        raise ValueError(
            f"{rels.shape[0]} relative poses for {len(stamps)} stamps"
        )
    traj = {stamps[0]: np.eye(4)}
    accum = np.eye(4)
    for t, H in zip(stamps[1:], rels):
        if np.isfinite(H).all():
            accum = accum @ (np.linalg.inv(H) if invert else H)
        traj[t] = accum
    return traj


def plot_error_cdfs(methods, out_path, title="Relative pose error CDF"):
    """methods: {name: (trans_errors, rot_errors)} -> saves a 2-panel
    CDF figure (rgbddataset_cdf_plots.m:102-129)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    for name, (te, re) in methods.items():
        for ax, err, unit in ((ax1, te, "m"), (ax2, np.degrees(re), "deg")):
            x = np.sort(err)
            y = np.arange(1, len(x) + 1) / len(x)
            ax.plot(x, y, label=name)
    ax1.set_xlabel("translation error (m)")
    ax2.set_xlabel("rotation error (deg)")
    for ax in (ax1, ax2):
        ax.set_ylabel("CDF")
        ax.grid(True, alpha=0.3)
        ax.legend()
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_trajectories(trajs, out_path, title="Trajectories"):
    """trajs: {name: {t: [4,4]}} -> 3-D trajectory figure
    (rgbddataset_trajectory_plot.m)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    for name, traj in trajs.items():
        pts = np.array([traj[t][:3, 3] for t in sorted(traj)])
        ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], label=name)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_zlabel("z (m)")
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
