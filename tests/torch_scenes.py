"""Scenes shared by the port's CPU tests: the 6-frame lateral-parallax
TUM folder of tests/test_odometry.py, and the first rendered pair of a
`synth.revisit_path` sequence through the acvo frontend."""

import numpy as np
from PIL import Image

H, W = 96, 128
FX = 517.3         # fr1 intrinsics (camera registry key 1)
N_FRAMES = 6
DEPTHS = [1.0, 2.0, 4.0]
DX_M = 4.0 / FX    # camera translation/frame: 4px@1m, 2px@2m, 1px@4m


def _smooth_field(seed, h, w):
    from scipy.ndimage import gaussian_filter, zoom

    r = np.random.default_rng(seed)
    b = zoom(gaussian_filter(r.normal(0, 1, (h // 4 + 2, w // 4 + 2)), 1.2),
             4.05)[:h, :w]
    return (b - b.min()) / (b.max() - b.min())


def make_parallax_folder(root):
    """Write the folder (assoc.txt, rgb/, depth/, groundtruth.txt) at
    `root`, a pathlib.Path, and return it."""
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    wb = W + 4 * N_FRAMES + 8
    big = np.stack([40 + 200 * _smooth_field(s, H, wb) for s in (1, 2, 3)],
                   axis=-1).astype(np.float32)
    lines, gt = [], ["# ground truth"]
    for i in range(N_FRAMES):
        name = f"{100.0 + 0.1 * i:.6f}"
        rgb = np.zeros((H, W, 3), np.float32)
        dep = np.zeros((H, W), np.float32)
        for b in range(6):
            z = DEPTHS[b % 3]
            s = int(round(FX * DX_M / z)) * i
            rows = slice(b * 16, (b + 1) * 16)
            rgb[rows] = big[rows, s:s + W]
            dep[rows] = z * 5000.0
        Image.fromarray(rgb.astype(np.uint8)).save(root / "rgb" / f"{name}.png")
        Image.fromarray(dep.astype(np.uint16)).save(
            root / "depth" / f"{name}.png")
        lines.append(f"{name} rgb/{name}.png {name} depth/{name}.png")
        gt.append(f"{name} {i * DX_M:.9f} 0 0 0 0 0 1")
    (root / "assoc.txt").write_text("\n".join(lines) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    return root


def rendered_acvo_pair():
    """The port's clouds (CPU) of frames 0 and 1 of revisit_path(2) at
    96x128 through the acvo frontend (HSV features), capacity 512: the
    self-Grams of acvo need neighbours inside the gate radius and colors
    that pass the color gate, which random clouds do not have."""
    from cvo_rgbd_torch import synth
    from cvo_rgbd_torch.frontend import make_frontend

    fe = make_frontend(1, 512, 0, device="cpu")
    frames = synth.render_frames(synth.revisit_path(2, period=33),
                                 synth.BandScene(h=96, w=128))
    return [fe(f[2], f[3]) for f in frames]
