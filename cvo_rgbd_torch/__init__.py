"""cvo_rgbd_torch — Continuous Visual Odometry for RGB-D on PyTorch + CUDA.

A port of the JAX package (which stays the reference) to
PyTorch, with the TPU kernels of the main path rewritten by hand in CUDA
C++ for Hopper (`cvo_rgbd_torch/csrc/`).  The module layout and names
follow the JAX package.  Entry points run on the CUDA device unless the
caller passes `device="cpu"`.
"""

from __future__ import annotations

from cvo_rgbd_torch.core.cloud import PointCloud, pad_cloud
from cvo_rgbd_torch.core.registration import AlignResult, align
from cvo_rgbd_torch.params import MATLAB_PARAMS, AcvoParams, CvoParams

__all__ = [
    "AlignResult",
    "PointCloud",
    "align",
    "pad_cloud",
    "CvoParams",
    "AcvoParams",
    "MATLAB_PARAMS",
]

__version__ = "0.1.0"
