"""Visualization tools (host numpy).

Analogues of the reference's debug/analysis visualizations:
- `selected_pixels_image` — pcd_generator::visualize_selected_pixels
  (pcd_generator.cpp:166-231): depth-colored selected pixels over a
  dimmed grayscale frame.
- `draw_trajectory_into_image` — the TUM benchmark's
  plot_trajectory_into_image.py: project a trajectory into a camera
  frame.
- `export_registered_clouds` — generate_registered_pointcloud.py:
  backproject frames along a trajectory into one world-frame cloud.
"""

from __future__ import annotations

import numpy as np

from cvo_rgbd_torch.io.export import depth_to_cloud, transform_points


def selected_pixels_image(rgb, depth, idx, valid, colormap=None):
    """Render selected pixels colored by depth over a dimmed image.

    rgb [H,W,3] uint8, depth [H,W] raw, idx/valid from the selector.
    Returns [H,W,3] uint8.
    """
    rgb = np.asarray(rgb).astype(np.float32)
    h, w = rgb.shape[:2]
    gray = rgb.mean(-1, keepdims=True)
    out = np.repeat(gray, 3, axis=-1) * 0.6

    sel = np.asarray(idx)[np.asarray(valid) > 0]
    ys, xs = sel // w, sel % w
    d = np.asarray(depth)[ys, xs].astype(np.float32)
    dmax = max(float(d.max()), 1.0)
    t = np.clip(d / dmax, 0, 1)
    # simple jet-ish ramp (COLORMAP_JET analog, pcd_generator.cpp:193)
    color = np.stack(
        [
            np.clip(1.5 - np.abs(4 * t - 3), 0, 1),
            np.clip(1.5 - np.abs(4 * t - 2), 0, 1),
            np.clip(1.5 - np.abs(4 * t - 1), 0, 1),
        ],
        axis=-1,
    ) * 255.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            yy = np.clip(ys + dy, 0, h - 1)
            xx = np.clip(xs + dx, 0, w - 1)
            out[yy, xx] = color
    return np.clip(out, 0, 255).astype(np.uint8)


def draw_trajectory_into_image(rgb, cam, cam_pose, traj, radius=2):
    """Project trajectory positions into a frame's pixels.

    cam_pose: [4,4] world pose of the camera owning `rgb`;
    traj: {t: [4,4]} world poses to draw.  Returns [H,W,3] uint8.
    """
    out = np.asarray(rgb).astype(np.float32).copy()
    h, w = out.shape[:2]
    world = np.array([traj[t][:3, 3] for t in sorted(traj)])
    inv = np.linalg.inv(np.asarray(cam_pose))
    pts = transform_points(inv, world)
    z = pts[:, 2]
    ok = z > 1e-6
    u = (pts[ok, 0] / z[ok] * cam.fx + cam.cx).astype(int)
    v = (pts[ok, 1] / z[ok] * cam.fy + cam.cy).astype(int)
    inb = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    for uu, vv in zip(u[inb], v[inb]):
        y0, y1 = max(vv - radius, 0), min(vv + radius + 1, h)
        x0, x1 = max(uu - radius, 0), min(uu + radius + 1, w)
        out[y0:y1, x0:x1] = (255.0, 40.0, 40.0)
    return np.clip(out, 0, 255).astype(np.uint8)


def export_registered_clouds(frames, traj, cam, stride=4):
    """Backproject (t, rgb, depth) frames along trajectory poses into one
    world-frame colored cloud (generate_registered_pointcloud.py analog).

    frames: iterable of (timestamp, rgb, depth); traj: {t: [4,4]}.
    Returns (positions [N,3], colors [N,3]).
    """
    pos_all, col_all = [], []
    for t, rgb, depth in frames:
        if t not in traj:
            continue
        pos, col = depth_to_cloud(rgb, depth, cam, stride=stride)
        pos_all.append(transform_points(traj[t], pos))
        col_all.append(col)
    if not pos_all:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    return np.concatenate(pos_all), np.concatenate(col_all)
