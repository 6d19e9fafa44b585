"""TUM RGB-D dataset IO: assoc manifests and quaternion trajectories.

Reproduces the reference driver's file formats:
- assoc.txt parsing (`load_file_name`, cvo_main.cpp:75-101)
- TUM trajectory lines `name tx ty tz qx qy qz qw` appended per frame
  (cvo_main.cpp:58-65)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class AssocEntry(NamedTuple):
    name: str       # rgb timestamp string (used as the pose name)
    rgb_path: str
    depth_path: str


def load_assoc(assoc_path) -> list[AssocEntry]:
    """Parse assoc.txt: `rgb_ts rgb_path depth_ts depth_path` per line."""
    entries = []
    with open(assoc_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                entries.append(AssocEntry(parts[0], parts[1], parts[3]))
    return entries


def rotation_to_quaternion(R):
    """[3,3] -> (qx, qy, qz, qw), w>=0 normalized like Eigen's
    Quaternionf used by the reference writer (cvo_main.cpp:61-64)."""
    R = np.asarray(R, dtype=np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    return qx, qy, qz, qw


def write_trajectory_line(fh, name, transform):
    """Append one TUM pose line from a [4,4] transform
    (cvo_main.cpp:58-65)."""
    T = np.asarray(transform)
    qx, qy, qz, qw = rotation_to_quaternion(T[:3, :3])
    fh.write(
        f"{name} {T[0, 3]:.6f} {T[1, 3]:.6f} {T[2, 3]:.6f} "
        f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n"
    )


def read_trajectory(path):
    """Read a TUM trajectory file -> dict {timestamp: [4,4] matrix}.

    Mirrors evaluate_ate.py's read_trajectory + transform44
    (evaluate_rpe.py:46-78).
    """
    with open(path) as f:
        return parse_trajectory(f)


def parse_trajectory(lines):
    """TUM trajectory lines -> dict {timestamp: [4,4] matrix}."""
    out = {}
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.replace(",", " ").split()
        if len(parts) < 8:
            continue
        t = float(parts[0])
        tx, ty, tz, qx, qy, qz, qw = (float(v) for v in parts[1:8])
        out[t] = quaternion_to_matrix44(tx, ty, tz, qx, qy, qz, qw)
    return out


def quaternion_to_matrix44(tx, ty, tz, qx, qy, qz, qw):
    """TUM pose -> [4,4] homogeneous matrix (evaluate_rpe.py:46-78)."""
    q = np.array([qx, qy, qz, qw], dtype=np.float64)
    nq = np.dot(q, q)
    T = np.eye(4)
    T[:3, 3] = (tx, ty, tz)
    if nq < 1e-10:
        return T
    q *= np.sqrt(2.0 / nq)
    q = np.outer(q, q)
    T[:3, :3] = np.array(
        [
            [1.0 - q[1, 1] - q[2, 2], q[0, 1] - q[2, 3], q[0, 2] + q[1, 3]],
            [q[0, 1] + q[2, 3], 1.0 - q[0, 0] - q[2, 2], q[1, 2] - q[0, 3]],
            [q[0, 2] - q[1, 3], q[1, 2] + q[0, 3], 1.0 - q[0, 0] - q[1, 1]],
        ]
    )
    return T
