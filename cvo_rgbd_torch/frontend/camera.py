"""Camera registry — pinhole intrinsics per dataset sequence.

Replaces the hard-coded switch on `dataset_seq` in the reference
frontend (pcd_generator.cpp:242-296) with a named registry; integer
keys keep CLI compatibility with the reference (`./cvo folder 1`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CameraInfo:
    """Pinhole + depth scaling (data_type.h:32-38)."""

    scaling_factor: float
    fx: float
    fy: float
    cx: float
    cy: float


CAMERAS: dict[object, CameraInfo] = {}


def _register(info, *keys):
    for k in keys:
        CAMERAS[k] = info


# values from pcd_generator.cpp:242-296
_register(CameraInfo(1000.0, 616.368, 616.745, 319.935, 243.639), 0, "realsense", "default")
_register(CameraInfo(5000.0, 517.3, 516.5, 318.6, 255.3), 1, "fr1")
_register(CameraInfo(5000.0, 520.9, 521.0, 325.1, 249.7), 2, "fr2")
_register(CameraInfo(5000.0, 535.4, 539.2, 320.1, 247.6), 3, "fr3")
_register(CameraInfo(2000.0, 718.856, 718.856, 607.1928, 185.2157), 4, "kitti15")
_register(CameraInfo(2000.0, 707.0912, 707.0912, 601.8873, 183.1104), 5, "kitti05")


def get_camera(key) -> CameraInfo:
    """Look up by int sequence id or name; unknown keys get the
    realsense default, like the reference's `default:` case."""
    return CAMERAS.get(key, CAMERAS["default"])
