"""RGB-D frame -> padded PointCloud: the frontend.

Port of the JAX package's `frontend/pipeline.py` (reference:
pcd_generator::create_pointcloud, pcd_generator.cpp:398-420): pyramid,
selection, pinhole backprojection and 5-dim features, with static
shapes per (H, W, num_want, feature_type).

feature_type (pcd_generator.cpp:329-382):
- 0: HSV normalized to ~[0,1] plus gradients *2/255 (adaptive CVO);
- 1: raw RGB 0..255 plus raw gradients (CVO).
"""

from __future__ import annotations

import functools

import torch

from cvo_rgbd_torch.core.cloud import PointCloud, round_up
from cvo_rgbd_torch.device import resolve_device
from cvo_rgbd_torch.frontend import image as image_mod
from cvo_rgbd_torch.frontend import selector as selector_mod
from cvo_rgbd_torch.frontend.camera import get_camera


def _process(rgb, depth, *, cam, num_want, feature_type, dep_thres, pot,
             bgr_quirk=False):
    """rgb [H,W,3] f32 0..255, depth [H,W] f32 raw sensor units, both on
    the target device.  `bgr_quirk` flips the channels first, the
    reference's BGR-as-RGB convention (pcd_generator.cpp:390-391)."""
    h, w = depth.shape
    if bgr_quirk:
        rgb = rgb.flip(-1)
    gray = image_mod.rgb_to_gray(rgb)
    pyr = image_mod.make_pyramid(gray)
    idx, sel_valid = selector_mod.select_pixels(pyr, num_want, pot=pot)

    ys = idx // w
    xs = idx % w
    dep = depth.reshape(-1)[idx]
    # depth gates (pcd_generator.cpp:306-308, plus dep_thres, :23)
    dep_ok = (dep > 0) & torch.isfinite(dep) & (dep < dep_thres)
    valid = sel_valid & dep_ok

    z = dep / cam.scaling_factor
    x3 = (xs.to(torch.float32) - cam.cx) * z / cam.fx
    y3 = (ys.to(torch.float32) - cam.cy) * z / cam.fy
    positions = torch.stack([x3, y3, z], dim=-1)

    dx0 = pyr[0][1].reshape(-1)[idx]
    dy0 = pyr[0][2].reshape(-1)[idx]
    if feature_type == 0:
        hsv = image_mod.rgb_to_hsv_cv(rgb).reshape(-1, 3)[idx]
        feats = torch.stack(
            [
                hsv[:, 0] / 180.0,
                hsv[:, 1] / 255.0,
                hsv[:, 2] / 255.0,
                dx0 / 255.0 * 2.0,
                dy0 / 255.0 * 2.0,
            ],
            dim=-1,
        )
    else:
        c = rgb.reshape(-1, 3)[idx]
        feats = torch.stack([c[:, 0], c[:, 1], c[:, 2], dx0, dy0], dim=-1)

    vf = valid.to(torch.float32)
    pad = round_up(num_want) - num_want
    positions = torch.nn.functional.pad(positions * vf[:, None], (0, 0, 0, pad))
    feats = torch.nn.functional.pad(feats * vf[:, None], (0, 0, 0, pad))
    mask = torch.nn.functional.pad(vf, (0, pad))
    return PointCloud(positions, feats, mask)


@functools.lru_cache(maxsize=None)
def make_frontend(camera_key, num_want=3000, feature_type=1,
                  dep_thres=20000.0, pot=3, bgr_quirk=False, device=None):
    """The frame processor for a camera/config on `device` (the card
    unless told otherwise): call it with host or device arrays, the
    cloud comes back on the device.  Cached per argument set, as the JAX
    package caches one jitted program per config.  num_want=3000 and
    dep_thres=20000 match pcd_generator.cpp:22-23."""
    dev = resolve_device(device)
    cam = get_camera(camera_key)

    def frontend(rgb, depth) -> PointCloud:
        return _process(
            torch.as_tensor(rgb, dtype=torch.float32).to(dev),
            torch.as_tensor(depth, dtype=torch.float32).to(dev),
            cam=cam, num_want=num_want, feature_type=feature_type,
            dep_thres=dep_thres, pot=pot, bgr_quirk=bgr_quirk,
        )

    return frontend


def process_frame(rgb, depth, camera_key, num_want=3000, feature_type=1,
                  bgr_quirk=False, device=None):
    """One-shot frontend call: `make_frontend`'s processor for this
    config, applied to one frame (on the card unless `device="cpu"`)."""
    fn = make_frontend(camera_key, num_want, feature_type,
                       bgr_quirk=bgr_quirk, device=device)
    return fn(rgb, depth)
