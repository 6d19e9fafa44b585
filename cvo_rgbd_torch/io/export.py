"""Point-cloud export: PCD / PLY writers and RGB-D backprojection.

Covers the reference's dataset tooling:
- generate_pointcloud.py (TUM tool): RGB-D pair -> colored cloud file;
- util/generate_pointclouds.m: batch pcd generation with depth scale
  5000 and per-camera intrinsics (generate_pointclouds.m:1-47);
- acvo::write_pcl_point_cloud_to_disk (adaptive_cvo.cpp:379-383).

Host numpy, the port's own copy of the JAX package's writers.
"""

from __future__ import annotations

import numpy as np


def depth_to_cloud(rgb, depth, cam, stride=1):
    """Dense backprojection of an RGB-D pair.

    rgb [H,W,3] uint8/float, depth [H,W] raw sensor units; `cam` is a
    frontend.camera.CameraInfo.  Returns (positions [N,3] f32,
    colors [N,3] f32 in 0..255) for valid-depth pixels.
    """
    rgb = np.asarray(rgb)
    depth = np.asarray(depth, dtype=np.float32)
    h, w = depth.shape
    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    d = depth[ys, xs]
    valid = d > 0
    z = d[valid] / cam.scaling_factor
    u = xs[valid].astype(np.float32)
    v = ys[valid].astype(np.float32)
    x = (u - cam.cx) * z / cam.fx
    y = (v - cam.cy) * z / cam.fy
    pos = np.stack([x, y, z], axis=-1).astype(np.float32)
    col = rgb[ys, xs][valid][:, :3].astype(np.float32)
    return pos, col


def pack_rgb(colors):
    """[N,3] 0..255 -> PCL packed-float rgb column."""
    c = np.clip(np.asarray(colors), 0, 255).astype(np.uint32)
    packed = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
    return packed.view(np.float32)


def write_pcd(path, positions, colors=None, binary=True):
    """Write a .PCD v.7 file (ascii or binary) with optional packed rgb."""
    positions = np.asarray(positions, dtype=np.float32)
    n = positions.shape[0]
    fields = "x y z" + (" rgb" if colors is not None else "")
    sizes = "4 4 4" + (" 4" if colors is not None else "")
    types = "F F F" + (" F" if colors is not None else "")
    counts = "1 1 1" + (" 1" if colors is not None else "")
    header = (
        "# .PCD v.7 - Point Cloud Data file format\n"
        "VERSION .7\n"
        f"FIELDS {fields}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {counts}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA {'binary' if binary else 'ascii'}\n"
    )
    if colors is not None:
        data = np.column_stack([positions, pack_rgb(colors)])
    else:
        data = positions
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(np.ascontiguousarray(data, dtype=np.float32).tobytes())
        else:
            np.savetxt(f, data, fmt="%.9g")


def write_ply(path, positions, colors=None):
    """Write an ascii PLY (the TUM generate_pointcloud.py output format)."""
    positions = np.asarray(positions, dtype=np.float32)
    n = positions.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        if colors is not None:
            cols = np.clip(np.asarray(colors), 0, 255).astype(np.uint8)
            for p, c in zip(positions, cols):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in positions:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def transform_points(T, positions):
    """Apply a [4,4] transform to [N,3] points (host-side)."""
    T = np.asarray(T)
    return np.asarray(positions) @ T[:3, :3].T + T[:3, 3]


def merge_clouds(clouds, grid=0.01):
    """Concatenate + grid-downsample (the pcmerge analog,
    run_toy_example.m:51-80).  clouds: list of (positions, colors)."""
    from cvo_rgbd_torch.utils.downsample import grid_downsample

    pos = np.concatenate([c[0] for c in clouds])
    col = np.concatenate([c[1] for c in clouds])
    return grid_downsample(pos, col, grid)
