"""Carrying state across from the JAX package.

There are no learned weights: what crosses between the packages is the
hyperparameters, the clouds, the odometry checkpoint (whose JSON format
`odometry.OdometryState` reads as it is), the SLAM configuration and
pose graphs and bundle-adjustment problems.
"""

from __future__ import annotations

import numpy as np
import torch

from cvo_rgbd_torch.core.cloud import PointCloud
from cvo_rgbd_torch.core.posegraph import PoseGraph
from cvo_rgbd_torch.device import resolve_device
from cvo_rgbd_torch.keyframes import KeyframePolicy
from cvo_rgbd_torch.parallel.ba import BAProblem, problem_on
from cvo_rgbd_torch.params import AcvoParams, CvoParams
from cvo_rgbd_torch.slam import SlamConfig

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


def slam_config_from_jax_dict(d: dict) -> SlamConfig:
    """The port's SlamConfig from `dataclasses.asdict` of a JAX
    SlamConfig, its nested KeyframePolicy included."""
    d = dict(d)
    d["keyframe"] = KeyframePolicy(**d["keyframe"])
    return SlamConfig(**d)


def ba_problem_from_numpy(poses, landmarks, obs_pose, obs_lm, obs_z, obs_w,
                          obs_edge, edge_pose, edge_lm,
                          device=None) -> BAProblem:
    """A port BAProblem from a problem's numpy arrays (e.g. the fields of
    a JAX BAProblem after `np.asarray`), on `device`: the same problem
    for both packages' solvers."""
    return problem_on((poses, landmarks, obs_pose, obs_lm, obs_z, obs_w,
                       obs_edge, edge_pose, edge_lm), device)


def posegraph_from_numpy(nodes, edge_i, edge_j, edge_z, edge_w,
                         device=None) -> PoseGraph:
    """A port PoseGraph from a graph's numpy arrays (e.g. the fields of a
    JAX PoseGraph after `np.asarray`), on `device`."""
    dev = resolve_device(device)

    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    def idx(a):
        return torch.from_numpy(np.array(a, dtype=np.int64)).to(dev)

    return PoseGraph(f32(nodes), idx(edge_i), idx(edge_j), f32(edge_z),
                     f32(edge_w))
