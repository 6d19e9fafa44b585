"""Mint the reference's in-tree accuracy baselines (fr1/desk).

The reference checkout ships two complete trajectory artifacts for
freiburg1_desk plus ground truth (SURVEY.md section 2.5):

- `cv_rgbd_poses.csv` — the OpenCV RGB-D VO comparison baseline, 572
  relative poses (rgbddataset_cdf_plots.m:4-8, 91-99);
- `freiburg1_desk_07-May-2019-02-35-00.mat` — a stored MATLAB CVO
  batch run, 572 pairwise affine3d transforms
  (rgbddataset_rkhs.m:87-88);
- `groundtruth.txt` — 2,338 GT poses.

The raw images are not vendored, so these are the reference's only
baselines that can be scored without its C++ build; this module turns
both into ATE RMSE numbers against ground truth with the reference's
association + Horn-alignment metric (evaluate_ate.py:129-162).
"""

from __future__ import annotations

import os

from cvo_rgbd_torch.evaluation.ate import ate_rmse
from cvo_rgbd_torch.evaluation.plots import (
    chain_relative_poses,
    load_relative_pose_csv,
)
from cvo_rgbd_torch.io.matlab import read_stored_run
from cvo_rgbd_torch.io.tum import load_assoc, read_trajectory

STORED_MATLAB_RUN = "freiburg1_desk_07-May-2019-02-35-00.mat"


def mint_fr1_desk_baselines(dataset_dir, max_difference=0.02):
    """ATE stats for the two vendored fr1/desk baseline trajectories.

    Returns {"opencv_vo": stats, "matlab_cvo": stats} where each stats
    dict is `ate_rmse`'s output (rmse/mean/median/... in meters).

    Conventions (validated by trying both chain directions — the wrong
    one degrades RMSE ~2x):
    - the CSV rows store the transform whose INVERSE is the forward
      frame-to-frame motion (rgbddataset_cdf_plots.m:91-92 applies
      tfinv before comparing with inv(T_gt[i-1]) @ T_gt[i]); identity
      rows are OpenCV failures and freeze the pose;
    - the stored MATLAB transforms chain directly
      (accum <- accum @ H, the same moving->fixed convention align()
      returns; io/matlab.py docstring).
    """
    entries = load_assoc(os.path.join(dataset_dir, "assoc.txt"))
    stamps = [float(e.name) for e in entries]
    gt = read_trajectory(os.path.join(dataset_dir, "groundtruth.txt"))

    rels_cv = load_relative_pose_csv(
        os.path.join(dataset_dir, "cv_rgbd_poses.csv")
    )
    traj_cv = chain_relative_poses(rels_cv, stamps, invert=True)

    run = read_stored_run(os.path.join(dataset_dir, STORED_MATLAB_RUN))
    traj_ml = chain_relative_poses(run.transforms, stamps)

    return {
        "opencv_vo": ate_rmse(gt, traj_cv, max_difference=max_difference),
        "matlab_cvo": ate_rmse(gt, traj_ml, max_difference=max_difference),
    }
