"""File formats: TUM RGB-D text files, PCD clouds, PLY export, stored
MATLAB runs."""

from cvo_rgbd_torch.io.matlab import StoredRun, read_stored_run
from cvo_rgbd_torch.io.pcd import read_pcd
from cvo_rgbd_torch.io.tum import (
    load_assoc,
    read_trajectory,
    write_trajectory_line,
)

__all__ = [
    "read_pcd",
    "load_assoc",
    "read_trajectory",
    "write_trajectory_line",
    "StoredRun",
    "read_stored_run",
]
