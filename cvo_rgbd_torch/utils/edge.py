"""Edge-based point filtering: the util/ptcloud_edge_filter.m analog.

The MATLAB toy pipeline (run_toy_example.m:7-13) keeps the points of an
organized Kinect cloud whose pixel lies on a Canny edge of the color
image (ptcloud_edge_filter.m:6-14) before it downsamples and aligns.

Host numpy with scipy (one-time data preparation, like
`utils.downsample`): Gaussian smoothing, central-difference gradients,
non-maximum suppression along the quantized gradient direction, and
double-threshold hysteresis over 8-connected components.
"""

from __future__ import annotations

import numpy as np


def _gaussian_blur(img, sigma=1.0, radius=2):
    from scipy.ndimage import convolve1d

    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    out = convolve1d(np.asarray(img, np.float32), k, axis=1, mode="nearest")
    out = convolve1d(out, k, axis=0, mode="nearest")
    return out.astype(np.float32)


def canny_edges(gray, low=None, high=None, sigma=1.0):
    """Boolean edge map of a grayscale image [H,W] (values any scale).

    `low`/`high` default to 0.1/0.2 of the largest gradient magnitude,
    in the spirit of MATLAB's edge(...,'canny') auto threshold.
    """
    from scipy import ndimage

    g = _gaussian_blur(np.asarray(gray, np.float32), sigma=sigma)
    gx = np.zeros_like(g)
    gy = np.zeros_like(g)
    gx[:, 1:-1] = (g[:, 2:] - g[:, :-2]) * 0.5
    gy[1:-1, :] = (g[2:, :] - g[:-2, :]) * 0.5
    mag = np.hypot(gx, gy)
    if high is None:
        high = 0.2 * float(mag.max() or 1.0)
    if low is None:
        low = 0.5 * high

    # non-maximum suppression against the two neighbors along the
    # gradient direction, quantized to 0/45/90/135 degrees
    ang = np.rad2deg(np.arctan2(gy, gx)) % 180.0
    padm = np.pad(mag, 1, mode="constant")

    def shift(dy, dx):
        return padm[1 + dy : 1 + dy + mag.shape[0],
                    1 + dx : 1 + dx + mag.shape[1]]

    sectors = [
        ((ang < 22.5) | (ang >= 157.5), shift(0, 1), shift(0, -1)),     # 0
        ((ang >= 22.5) & (ang < 67.5), shift(1, 1), shift(-1, -1)),     # 45
        ((ang >= 67.5) & (ang < 112.5), shift(1, 0), shift(-1, 0)),     # 90
        ((ang >= 112.5) & (ang < 157.5), shift(1, -1), shift(-1, 1)),   # 135
    ]
    keep = np.zeros(mag.shape, bool)
    for sel, a, b in sectors:
        keep |= sel & (mag >= a) & (mag >= b)
    nms = np.where(keep, mag, 0.0)

    strong = nms >= high
    weak = (nms >= low) & ~strong
    # hysteresis: a weak pixel stays when it is 8-connected (through weak
    # or strong pixels) to a strong one, by one labelling pass
    labels, _ = ndimage.label(strong | weak, structure=np.ones((3, 3)))
    keep = np.unique(labels[strong])
    keep = keep[keep > 0]
    return np.isin(labels, keep) & (strong | weak)


def edge_filter(rgb, positions, colors=None, low=None, high=None,
                sigma=1.0):
    """Keep the organized cloud's points on color-image edges
    (ptcloud_edge_filter.m:6-14).

    rgb [H,W,3]; positions [H,W,3] (points with a NaN or all-zero
    position are dropped either way); colors optional [H,W,3].  Returns
    (positions [N,3], colors [N,3]), or positions alone.
    """
    rgb = np.asarray(rgb, np.float32)
    positions = np.asarray(positions, np.float32)
    gray = rgb @ np.array([0.299, 0.587, 0.114], np.float32)
    mask = canny_edges(gray, low=low, high=high, sigma=sigma)
    finite = np.isfinite(positions).all(-1) & (
        np.abs(positions).sum(-1) > 0
    )
    keep = mask & finite
    pos = positions[keep]
    if colors is None:
        return pos
    return pos, np.asarray(colors)[keep]
