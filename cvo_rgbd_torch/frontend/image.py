"""Image pipeline: color conversion, pyramid, gradients.

Port of the JAX package's `frontend/image.py` (reference:
pcd_generator.cpp:33-120, 384-396): 2x2-mean pyramid and
central-difference gradients on torch tensors.

The JAX package runs these under XLA, whose CPU compiler fuses
`a*b + c*d` into one fused multiply-add.  The pixel selector compares
gradients against thresholds and breaks ties by value, so a one-ulp
difference moves which pixels are chosen.  `_fma` reproduces the fused
rounding (exact fp32 products and sum in float64, one rounding to
fp32), so the port selects the same pixels as the reference on the CPU
and on the card alike.
"""

from __future__ import annotations

import torch

PYR_LEVELS = 3  # data_type.h:25


def _fma(a, b, c):
    """fp32 a*b + c with a single rounding, like a fused multiply-add."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def rgb_to_gray(rgb):
    """[H,W,3] float (0..255) -> [H,W] luma, OpenCV Y weights, evaluated
    as (0.299 r + 0.587 g) + 0.114 b with XLA's fused roundings."""
    c = rgb.new_tensor
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    rg = _fma(c(0.299), r, c(0.587) * g)
    return _fma(c(0.114), b, rg)


def rgb_to_hsv_cv(rgb):
    """[H,W,3] float 0..255 -> OpenCV 8-bit HSV ranges: H in 0..180,
    S,V in 0..255 (cv::COLOR_RGB2HSV on uint8 inputs)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    diff_safe = torch.where(diff == 0, 1.0, diff)
    s = torch.where(v == 0, 0.0, 255.0 * diff / torch.where(v == 0, 1.0, v))
    h = torch.where(
        v == r,
        60.0 * (g - b) / diff_safe,
        torch.where(
            v == g,
            120.0 + 60.0 * (b - r) / diff_safe,
            240.0 + 60.0 * (r - g) / diff_safe,
        ),
    )
    h = torch.where(diff == 0, 0.0, h)
    h = torch.where(h < 0, h + 360.0, h) / 2.0  # OpenCV stores H/2
    return torch.stack([h, s, v], dim=-1)


def downsample2(img):
    """2x2 mean pooling (pcd_generator.cpp:84-91), summed as
    (a + b) + (c + d) over the row pairs like the reference reduction."""
    h, w = img.shape
    q = img[: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2)
    s = (q[:, 0, :, 0] + q[:, 0, :, 1]) + (q[:, 1, :, 0] + q[:, 1, :, 1])
    return s / 4.0


def gradients(img):
    """Central differences, zero on all borders (the reference zeroes
    only the first/last rows, pcd_generator.cpp:96-106)."""
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    dx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    dy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    dx[0, :] = 0.0
    dx[-1, :] = 0.0
    return dx, dy


def make_pyramid(gray):
    """[H,W] intensity -> list of (intensity, dx, dy, abs_sq_grad) per
    level (pcd_generator.cpp:33-120)."""
    levels = []
    img = gray
    for _ in range(PYR_LEVELS):
        dx, dy = gradients(img)
        levels.append((img, dx, dy, _fma(dx, dx, dy * dy)))
        img = downsample2(img)
    return levels
