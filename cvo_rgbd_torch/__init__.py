"""cvo_rgbd_torch — Continuous Visual Odometry for RGB-D on PyTorch + CUDA.

A port of the JAX package (which stays the reference) to
PyTorch, with the TPU kernels of the main path rewritten by hand in CUDA
C++ for Hopper (`cvo_rgbd_torch/csrc/`).  The module layout and names
follow the JAX package.  Entry points run on the CUDA device unless the
caller passes `device="cpu"`.  `align_jit`, as JAX's, compiles the
align loop once per (params, capacity): on the card, CUDA graphs of
its iterations, replayed (`core/compiled.py`); the drivers call it.
"""

from __future__ import annotations

from cvo_rgbd_torch.core.cloud import PointCloud, pad_cloud
from cvo_rgbd_torch.core.compiled import align_jit
from cvo_rgbd_torch.core.registration import (
    AlignResult,
    align,
    function_inner_product,
)
from cvo_rgbd_torch.params import MATLAB_PARAMS, AcvoParams, CvoParams
from cvo_rgbd_torch.slam import KeyframeSlam, SlamConfig

__all__ = [
    "AlignResult",
    "KeyframeSlam",
    "SlamConfig",
    "PointCloud",
    "align",
    "align_jit",
    "pad_cloud",
    "function_inner_product",
    "CvoParams",
    "AcvoParams",
    "MATLAB_PARAMS",
]

__version__ = "0.1.0"
