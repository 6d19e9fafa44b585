"""Trajectory metrics: ATE (Horn alignment + RMSE), rotation errors and
RPE; the reference's fr1/desk baselines; a NaN-cloud fault for the
odometry drivers' failure paths."""

from cvo_rgbd_torch.evaluation.associate import associate
from cvo_rgbd_torch.evaluation.ate import (
    ate_rmse,
    horn_align,
    rotation_errors_mrad,
)
from cvo_rgbd_torch.evaluation.baselines import mint_fr1_desk_baselines
from cvo_rgbd_torch.evaluation.faults import nan_cloud
from cvo_rgbd_torch.evaluation.rpe import rpe

__all__ = [
    "associate", "ate_rmse", "horn_align", "mint_fr1_desk_baselines",
    "nan_cloud", "rotation_errors_mrad", "rpe",
]
