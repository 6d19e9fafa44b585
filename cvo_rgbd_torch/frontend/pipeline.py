"""RGB-D frame -> padded PointCloud: the frontend.

Port of the JAX package's `frontend/pipeline.py` (reference:
pcd_generator::create_pointcloud, pcd_generator.cpp:398-420): pyramid,
selection, pinhole backprojection and 5-dim features, with static
shapes per (H, W, num_want, feature_type).

feature_type (pcd_generator.cpp:329-382):
- 0: HSV normalized to ~[0,1] plus gradients *2/255 (adaptive CVO);
- 1: raw RGB 0..255 plus raw gradients (CVO).

`make_frontend` returns a `Frontend`, which runs `_process` as one
captured program per input key (one CUDA graph on the card), where the
JAX package returns `jax.jit` of it.
"""

from __future__ import annotations

import functools

import torch

from cvo_rgbd_torch.core.cloud import PointCloud, round_up
from cvo_rgbd_torch.core.compiled import CapturedProgram, _strides
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


class Frontend:
    """The frame processor of one config on one device, `make_frontend`'s
    result: `frontend(rgb, depth)` -> a padded PointCloud on the device.

    The counterpart of the JAX package's `jax.jit(fn)`, which compiles
    `_process` once per config and per argument shape and type.  Here
    `_process` is one captured program (`core.compiled.CapturedProgram`,
    one CUDA graph on the card) per input key: each input's shape, type,
    device and strides.  The inputs go in as they come (uint8 RGB and
    uint16 depth from the PNG loader, or float arrays), through pinned
    host staging into the program's static inputs, and the float32
    conversion runs inside the program: uint8, uint16 and float32 convert
    exactly, so a cloud has the bits of `_process` on the converted
    frame.  Each call returns a cloud with storage of its own (one copy
    of the program's packed output, the three fields views of it), so a
    later frame never changes an earlier cloud.  On the CPU the same
    program runs uncaptured on the same static tensors.  The programs
    stay for the life of the processor; `replays` counts their runs (on
    the card, one graph replay a frame).  A capture that fails raises
    with the config and the input key: nothing falls back to op-by-op
    execution on the card."""

    def __init__(self, camera_key, cam, config, device):
        self.camera_key, self.cam, self.config = camera_key, cam, config
        self.device = device
        self.capacity = round_up(config["num_want"])
        self.programs = {}   # input key -> (CapturedProgram, staging)
        # the last frame's copies out of the pinned staging
        self.copied = (torch.cuda.Event() if device.type == "cuda"
                       else None)

    @property
    def replays(self) -> int:
        return sum(p.runs for p, _ in self.programs.values())

    def _packed(self, rgb, depth):
        """`_process` on the raw static inputs, its fields in one flat
        tensor: positions | features | mask."""
        cloud = _process(rgb.to(torch.float32), depth.to(torch.float32),
                         cam=self.cam, **self.config)
        return torch.cat([t.reshape(-1) for t in cloud])

    def _build(self, raw):
        dev = self.device
        what = (f"the frontend of camera {self.camera_key!r} "
                f"{self.config} on {dev} for inputs "
                + ", ".join(f"{x.dtype} {tuple(x.shape)} on {x.device} "
                            f"strides {x.stride()}" for x in raw))
        program = CapturedProgram(self._packed,
                                  tuple(x.to(dev) for x in raw), what)
        staging = tuple(
            torch.empty_strided(s.shape, s.stride(), dtype=s.dtype,
                                pin_memory=True)
            if dev.type == "cuda" and x.device.type == "cpu" else None
            for x, s in zip(raw, program.inputs))
        return program, staging

    def __call__(self, rgb, depth) -> PointCloud:
        raw = (torch.as_tensor(rgb), torch.as_tensor(depth))
        key = (tuple((x.shape, x.dtype, x.device) for x in raw),
               _strides(raw))
        entry = self.programs.get(key)
        if entry is None:
            entry = self.programs[key] = self._build(raw)
        program, staging = entry
        if self.copied is not None:
            self.copied.synchronize()
        program.load([x if s is None else s.copy_(x)
                      for x, s in zip(raw, staging)], non_blocking=True)
        if self.copied is not None:
            self.copied.record()
        flat = program.run()
        c = self.capacity
        return PointCloud(flat[:3 * c].view(c, 3),
                          flat[3 * c:8 * c].view(c, 5), flat[8 * c:])


@functools.lru_cache(maxsize=None)
def make_frontend(camera_key, num_want=3000, feature_type=1,
                  dep_thres=20000.0, pot=3, bgr_quirk=False,
                  device=None) -> Frontend:
    """The frame processor (`Frontend`) for a camera/config on `device`
    (the card unless told otherwise): call it with host or device
    arrays, the cloud comes back on the device.  Cached per argument
    set, as the JAX package caches one jitted program per config.
    num_want=3000 and dep_thres=20000 match pcd_generator.cpp:22-23."""
    return Frontend(camera_key, get_camera(camera_key), dict(
        num_want=num_want, feature_type=feature_type, dep_thres=dep_thres,
        pot=pot, bgr_quirk=bgr_quirk), resolve_device(device))


def process_frame(rgb, depth, camera_key, num_want=3000, feature_type=1,
                  bgr_quirk=False, device=None):
    """One-shot frontend call: `make_frontend`'s processor for this
    config, applied to one frame (on the card unless `device="cpu"`)."""
    fn = make_frontend(camera_key, num_want, feature_type,
                       bgr_quirk=bgr_quirk, device=device)
    return fn(rgb, depth)
