"""Minimal PCD (Point Cloud Data) reader.

Parses .PCD v.7 ascii/binary files such as the MATLAB `pcwrite` outputs
of the reference dataset (data/rgbd_dataset/freiburg1_desk/pcd_ds/*.pcd).
The `rgb` field is PCL-style packed: the float's bit pattern holds
0x00RRGGBB.  Host numpy, the port's own copy of the JAX package's reader.
"""

from __future__ import annotations

import numpy as np


def _parse_header(lines):
    header = {}
    for ln in lines:
        if ln.startswith("#") or not ln.strip():
            continue
        key, _, rest = ln.partition(" ")
        header[key.upper()] = rest.strip()
        if key.upper() == "DATA":
            break
    return header


def unpack_rgb(rgb_float):
    """PCL packed-float RGB -> [N,3] float in [0,1] (r,g,b)."""
    bits = np.ascontiguousarray(rgb_float, dtype=np.float32).view(np.uint32)
    r = (bits >> 16) & 0xFF
    g = (bits >> 8) & 0xFF
    b = bits & 0xFF
    return np.stack([r, g, b], axis=-1).astype(np.float32) / 255.0


def read_pcd(path):
    """Read a PCD file -> dict with 'positions' [N,3] f32 and optional
    'colors' [N,3] f32 in [0,1]."""
    with open(path, "rb") as f:
        raw = f.read()
    # header is always ascii text up to the DATA line
    text_end = raw.find(b"DATA")
    newline = raw.find(b"\n", text_end)
    header = _parse_header(raw[: newline + 1].decode("ascii", "replace").splitlines())

    fields = header["FIELDS"].split()
    sizes = [int(s) for s in header["SIZE"].split()]
    types = header["TYPE"].split()
    counts = [int(c) for c in header.get("COUNT", " ".join(["1"] * len(fields))).split()]
    n = int(header["POINTS"])
    mode = header["DATA"].split()[0].lower()

    npmap = {("F", 4): "f4", ("F", 8): "f8", ("I", 4): "i4", ("I", 2): "i2",
             ("I", 1): "i1", ("U", 4): "u4", ("U", 2): "u2", ("U", 1): "u1"}

    if mode == "ascii":
        body = raw[newline + 1 :].decode("ascii")
        data = np.array(body.split(), dtype=np.float64)
        ncol = sum(counts)
        data = data[: n * ncol].reshape(n, ncol)
        cols = {}
        ci = 0
        for fname, cnt in zip(fields, counts):
            cols[fname] = data[:, ci : ci + cnt]
            ci += cnt
        positions = np.stack(
            [cols["x"][:, 0], cols["y"][:, 0], cols["z"][:, 0]], axis=-1
        ).astype(np.float32)
        out = {"positions": positions}
        if "rgb" in cols:
            out["colors"] = unpack_rgb(cols["rgb"][:, 0].astype(np.float32))
        return out

    if mode == "binary":
        dtype = np.dtype(
            [
                (fname, npmap[(t, s)], (cnt,))
                for fname, t, s, cnt in zip(fields, types, sizes, counts)
            ]
        )
        arr = np.frombuffer(raw[newline + 1 :], dtype=dtype, count=n)
        positions = np.stack(
            [arr["x"][:, 0], arr["y"][:, 0], arr["z"][:, 0]], axis=-1
        ).astype(np.float32)
        out = {"positions": positions}
        if "rgb" in fields:
            out["colors"] = unpack_rgb(arr["rgb"][:, 0].astype(np.float32))
        return out

    raise ValueError(f"unsupported PCD DATA mode: {mode}")
