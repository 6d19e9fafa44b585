"""Carrying state across from the JAX package.

There are no learned weights: what crosses between the packages is the
hyperparameters, the clouds and the odometry checkpoint (whose JSON
format `odometry.OdometryState` reads as it is).
"""

from __future__ import annotations

import numpy as np
import torch

from cvo_rgbd_torch.core.cloud import PointCloud
from cvo_rgbd_torch.device import resolve_device
from cvo_rgbd_torch.params import AcvoParams, CvoParams

# the JAX package's backend names -> the port's
BACKEND_NAMES = {"xla": "dense", "pallas": "kernel", "fused": "fused"}


def params_from_jax_dict(d: dict):
    """The port's CvoParams/AcvoParams from `dataclasses.asdict` of a JAX
    params object (AcvoParams is recognized by its `ell_min` field)."""
    d = dict(d)
    if d["backend"] not in BACKEND_NAMES:
        raise ValueError(f"unknown JAX backend {d['backend']!r}")
    d["backend"] = BACKEND_NAMES[d["backend"]]
    if "ell_sched" in d:
        d["ell_sched"] = tuple(tuple(s) for s in d["ell_sched"])
    return (AcvoParams if "ell_min" in d else CvoParams)(**d)


def cloud_from_numpy(positions, features, mask, device=None) -> PointCloud:
    """A port PointCloud from a padded cloud's numpy arrays (e.g. the
    fields of a JAX PointCloud after `np.asarray`), on `device`."""
    dev = resolve_device(device)
    return PointCloud(*(
        torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
        for a in (positions, features, mask)
    ))
