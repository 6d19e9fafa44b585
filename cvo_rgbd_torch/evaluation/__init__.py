"""Trajectory metrics: ATE (Horn alignment + RMSE) and RPE."""

from cvo_rgbd_torch.evaluation.associate import associate
from cvo_rgbd_torch.evaluation.ate import ate_rmse, horn_align
from cvo_rgbd_torch.evaluation.rpe import rpe

__all__ = ["associate", "ate_rmse", "horn_align", "rpe"]
