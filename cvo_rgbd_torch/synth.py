"""Synthetic ray-traced TUM-format RGB-D sequences with exact ground truth.

Port of the JAX package's `synth.py` (numpy/scipy only): six horizontal
depth bands with smooth per-channel textures, rendered by exact
per-pixel ray/plane intersection, along a camera path whose ground
truth is closed-form.

- `make_tum_dataset` writes the TUM folder layout (rgb/, depth/,
  assoc.txt, groundtruth.txt) and needs PIL;
- `render_frames` yields the same frames in memory, quantized exactly
  as the 8-bit/16-bit PNGs would store them, for machines without PIL;
- `Degradation` is the Kinect-like sensor model `make_tum_dataset`
  applies before it writes (`degrade=`).

Camera paths: `linear_orbit_path` (constant yaw+pitch a frame about the
pivot), `revisit_path` and `depth_loop_path` (periodic, so frames i and
i + period share a pose).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from cvo_rgbd_torch.frontend.camera import get_camera
from cvo_rgbd_torch.io.tum import write_trajectory_line


def smooth_field(seed, h, w):
    """Smooth random texture channel in [0, 1] (band-limited noise)."""
    from scipy.ndimage import gaussian_filter, zoom

    r = np.random.default_rng(seed)
    b = zoom(gaussian_filter(r.normal(0, 1, (h // 4 + 2, w // 4 + 2)), 1.2),
             4.05)
    b = b[:h, :w]
    return (b - b.min()) / (b.max() - b.min())


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


@dataclasses.dataclass
class CameraPath:
    """Per-frame camera-to-world pose parameters: yaw/pitch [n] about a
    pivot on the optical axis, offset [n,3] a world-frame displacement."""

    yaw: np.ndarray
    pitch: np.ndarray
    offset: np.ndarray

    @property
    def n_frames(self):
        return len(self.yaw)


def linear_orbit_path(n_frames, yaw_step_deg=0.8, pitch_step_deg=0.15):
    """Monotone orbit: frame i yaws i*yaw_step (and pitches
    i*pitch_step) about the pivot."""
    i = np.arange(n_frames)
    return CameraPath(
        yaw=np.deg2rad(yaw_step_deg) * i,
        pitch=np.deg2rad(pitch_step_deg) * i,
        offset=np.zeros((n_frames, 3)),
    )


def revisit_path(n_frames, period=40, yaw_amp_deg=3.0, pitch_amp_deg=0.5,
                 trans_amp_m=0.04):
    """Periodic path, pose(i + period) == pose(i): yaw, pitch and a
    lateral translation follow sinusoids of one period."""
    ph = 2 * np.pi * np.arange(n_frames) / period
    yaw = np.deg2rad(yaw_amp_deg) * np.sin(ph)
    pitch = np.deg2rad(pitch_amp_deg) * np.sin(ph + np.pi / 4)
    offset = trans_amp_m * np.stack(
        [np.sin(ph + np.pi / 3), 0.3 * np.sin(ph + 2 * np.pi / 3),
         0.2 * np.sin(ph)], axis=-1,
    )
    return CameraPath(yaw=yaw, pitch=pitch, offset=offset)


def depth_loop_path(n_frames, period=30, depth_amp_m=0.3, trans_amp_m=0.04,
                    yaw_amp_deg=2.0, pitch_amp_deg=0.5):
    """Periodic path that moves along the optical axis and back, pose(i +
    period) == pose(i).  Over the banded world a frame's overlap with a
    keyframe falls with the depth change (motion along the bands keeps
    it), so keyframe SLAM promotes keyframes every ~0.15 m of depth and
    closes loops where the path comes back."""
    ph = 2 * np.pi * np.arange(n_frames) / period
    yaw = np.deg2rad(yaw_amp_deg) * np.sin(ph)
    pitch = np.deg2rad(pitch_amp_deg) * np.sin(ph + np.pi / 4)
    offset = np.stack(
        [trans_amp_m * np.sin(ph + np.pi / 3),
         0.3 * trans_amp_m * np.sin(ph + 2 * np.pi / 3),
         depth_amp_m * np.sin(ph)], axis=-1,
    )
    return CameraPath(yaw=yaw, pitch=pitch, offset=offset)


class BandScene:
    """The banded-depth world + ray-traced renderer."""

    def __init__(self, h=96, w=128, seq=1, depths=(1.0, 2.0, 4.0),
                 band_rows=16, u_pad=96, v_pad=24, texture_seeds=(11, 12, 13)):
        self.h, self.w = h, w
        self.cam = get_camera(seq)
        self.depths = depths
        self.band_rows = band_rows
        self.u_pad, self.v_pad = u_pad, v_pad
        self.n_bands = h // band_rows
        self.texture = np.stack(
            [
                40 + 200 * smooth_field(s, h + 2 * v_pad, w + 2 * u_pad)
                for s in texture_seeds
            ],
            axis=-1,
        ).astype(np.float32)
        # pivot on the optical axis of the (off-axis) frustum at 2 m
        self.pivot = np.array([
            2.0 * (w / 2 - self.cam.cx) / self.cam.fx,
            2.0 * (h / 2 - self.cam.cy) / self.cam.fy,
            2.0,
        ])

    def pose(self, path: CameraPath, i):
        """Camera-to-world (R, c) for frame i of `path`."""
        R = _rot_y(path.yaw[i]) @ _rot_x(path.pitch[i])
        c = self.pivot - R @ self.pivot + path.offset[i]
        return R, c

    def render(self, R_cam, c_cam):
        """Ray-trace one frame from camera-to-world pose (R, c).
        Returns (rgb [H,W,3] f32 in 0..255, z-depth [H,W] meters)."""
        h, w = self.h, self.w
        cam = self.cam
        fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
        u, v = np.meshgrid(np.arange(w), np.arange(h))
        ray_c = np.stack(
            [(u - cx) / fx, (v - cy) / fy, np.ones_like(u, float)], axis=-1
        )
        ray_w = ray_c @ R_cam.T

        best_s = np.full((h, w), np.inf)
        rgb = np.zeros((h, w, 3), np.float32)
        tex = self.texture
        for b in range(self.n_bands):
            z_b = self.depths[b % len(self.depths)]
            s = (z_b - c_cam[2]) / ray_w[..., 2]
            X = c_cam[None, None, :] + s[..., None] * ray_w
            v0 = fy * X[..., 1] / z_b + cy       # frame-0 row of the hit
            u0 = fx * X[..., 0] / z_b + cx
            lo = b * self.band_rows - (self.v_pad if b == 0 else 0)
            hi = (b + 1) * self.band_rows + (
                self.v_pad if b == self.n_bands - 1 else 0
            )
            valid = (
                (s > 0) & (v0 >= lo) & (v0 < hi)
                & (u0 >= -self.u_pad) & (u0 < w + self.u_pad) & (s < best_s)
            )
            tv = np.clip(v0 + self.v_pad, 0, tex.shape[0] - 1.001)
            tu = np.clip(u0 + self.u_pad, 0, tex.shape[1] - 1.001)
            i0, j0 = tv.astype(int), tu.astype(int)
            av, au = (tv - i0)[..., None], (tu - j0)[..., None]
            samp = (
                tex[i0, j0] * (1 - av) * (1 - au)
                + tex[i0 + 1, j0] * av * (1 - au)
                + tex[i0, j0 + 1] * (1 - av) * au
                + tex[i0 + 1, j0 + 1] * av * au
            )
            rgb = np.where(valid[..., None], samp, rgb)
            best_s = np.where(valid, s, best_s)

        depth = np.where(np.isfinite(best_s), best_s, 0.0)
        return rgb, depth


@dataclasses.dataclass
class Degradation:
    """Kinect-like sensor degradation, deterministic per (seed, frame).

    Real sensor data has quantized noisy depth with holes and
    texture-poor frames, which the selector's block refill
    (pcd_generator.cpp:135-163) and the drivers' skip-and-mark
    (rgbddataset_rkhs.m:49-81) exist for; a noise-free render never
    reaches either.

    - `depth_noise`: Gaussian depth noise of sigma_z = depth_noise * z^2
      (Kinect-1 disparity quantization, ~1.4e-3 * z^2 m measured by
      Khoshelham & Elberink 2012);
    - `dropout`: fraction of depth pixels zeroed in smooth blobs (the
      `dropout` quantile of band-limited noise);
    - `low_texture_frames`: frames whose RGB contrast is scaled by
      `low_texture_scale` about 128;
    - `drop_frames`: frames whose depth is zeroed whole (total sensor
      dropout: an empty cloud).
    """

    depth_noise: float = 2e-3
    dropout: float = 0.0
    low_texture_frames: tuple = ()
    low_texture_scale: float = 0.04
    drop_frames: tuple = ()
    seed: int = 0

    def apply(self, i, rgb, depth):
        """Degrade frame i (returns new rgb, depth)."""
        r = np.random.default_rng(self.seed * 100003 + i)
        if i in self.low_texture_frames:
            rgb = 128.0 + (rgb - 128.0) * self.low_texture_scale
        if self.depth_noise > 0:
            valid = depth > 0
            depth = np.where(
                valid,
                depth + r.normal(size=depth.shape) * self.depth_noise
                * depth * depth,
                0.0,
            )
            depth = np.clip(depth, 0.0, None)  # negative = invalid (0)
        if self.dropout > 0:
            from scipy.ndimage import gaussian_filter

            field = gaussian_filter(
                r.normal(size=depth.shape), 3.0, mode="wrap"
            )
            depth = np.where(
                field < np.quantile(field, self.dropout), 0.0, depth
            )
        if i in self.drop_frames:
            depth = np.zeros_like(depth)
        return rgb, depth


def _frame(scene: BandScene, path: CameraPath, i, start_time, frame_dt,
           degrade: Degradation | None = None):
    """(name, rgb uint8 [H,W,3], depth uint16 [H,W], pose [4,4]) of frame
    i, degraded by `degrade` if given: the values the PNG files hold."""
    R, c = scene.pose(path, i)
    rgb, depth = scene.render(R, c)
    if degrade is not None:
        rgb, depth = degrade.apply(i, rgb, depth)
    pose = np.eye(4)
    pose[:3, :3] = R
    pose[:3, 3] = c
    return (
        f"{start_time + frame_dt * i:.6f}",
        rgb.astype(np.uint8),
        (depth * scene.cam.scaling_factor).astype(np.uint16),
        pose,
    )


def render_frames(path: CameraPath, scene: BandScene | None = None,
                  start_time=200.0, frame_dt=0.1):
    """Yield (index, name, rgb f32, depth f32, pose [4,4]) per frame,
    identical to reading back what `make_tum_dataset` writes."""
    scene = scene or BandScene()
    for i in range(path.n_frames):
        name, rgb, depth, pose = _frame(scene, path, i, start_time, frame_dt)
        yield i, name, rgb.astype(np.float32), depth.astype(np.float32), pose


def make_tum_dataset(root, path: CameraPath, scene: BandScene | None = None,
                     start_time=200.0, frame_dt=0.1,
                     degrade: Degradation | None = None):
    """Render `path` into a TUM-layout dataset folder at `root`, each
    frame degraded by `degrade` if given.  Returns (scene, poses) with
    poses [n,4,4] camera-to-world ground truth."""
    from PIL import Image

    scene = scene or BandScene()
    root = str(root)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)

    lines = []
    poses = []
    with open(os.path.join(root, "groundtruth.txt"), "w") as gt:
        gt.write("# ground truth\n")
        for i in range(path.n_frames):
            name, rgb, depth, pose = _frame(scene, path, i, start_time,
                                            frame_dt, degrade)
            Image.fromarray(rgb).save(os.path.join(root, "rgb", f"{name}.png"))
            Image.fromarray(depth).save(
                os.path.join(root, "depth", f"{name}.png")
            )
            lines.append(f"{name} rgb/{name}.png {name} depth/{name}.png")
            poses.append(pose)
            write_trajectory_line(gt, name, pose)
    with open(os.path.join(root, "assoc.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return scene, np.stack(poses)
