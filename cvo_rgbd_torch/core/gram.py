"""The masked dense Gram of the dense backend.

Port of the JAX package's `core/gram.py` (its "xla" backend).  The whole
[N,M] kernel matrix is evaluated as tensors, every gate of the reference
(cvo.cpp:99-161) as a mask:

    d2     < d2_thres     (the kd-tree radius test, cvo.cpp:119-125)
    d2_col < d2_c_thres   (color gate, cvo.cpp:148)
    a      > sp_thres     (final sparsity gate, cvo.cpp:152)
    valid_x, valid_y      (padding masks)

Plain torch in fp32, in the JAX package's operation order; the JAX
package runs these outside any Pallas kernel.  `fast_exp`
(params.exp_mode="fast") takes torch.exp(-z) in place of exp_neg, as the
JAX package takes jnp.exp(-z).
"""

from __future__ import annotations

import numbers

import torch

from cvo_rgbd_torch.core.numerics import gram_exp


def _lane_ell(ell, device):
    """`ell` (a number, a 0-dim tensor or one a lane, [B]) as an f32
    tensor on `device` that broadcasts against [B, N, M] Grams.  A number
    is filled on the device (no host copy, so a CUDA graph can capture
    it), rounded to float32 as a host tensor would be."""
    if isinstance(ell, numbers.Real):
        return torch.full((), float(ell), dtype=torch.float32, device=device)
    ell = torch.as_tensor(ell, dtype=torch.float32).to(device)
    return ell[..., None, None] if ell.dim() else ell


def _log32(v, device):
    """log of a host constant, taken in fp32 as jnp.log does.  The
    constant is filled on the device (no host copy, so a CUDA graph can
    capture it)."""
    return torch.log(torch.full((), v, dtype=torch.float32, device=device))


def pairwise_sqdist(x, y):
    """[N,d],[M,d] -> [N,M] squared distances in DIFFERENCE form, per
    component (x_k - y_k)^2, summed in order.  Never |x|^2+|y|^2-2x.y:
    its fp32 cancellation roughens the Gram and stalls the align flow
    above the C++ stop (the JAX package's numerics rule)."""
    d2 = None
    for k in range(x.shape[-1]):
        dk = x[..., :, None, k] - y[..., None, :, k]
        d2 = dk * dk if d2 is None else d2 + dk * dk
    return d2


def se_gram(x_pos, x_feat, x_mask, y_pos, y_feat, y_mask, ell, *, sigma,
            c_ell, c_sigma, sp_thres, c_sp_thres, fast_exp=False):
    """Masked dense A = (s^2 e^{-d2/2l^2}) * (cs^2 e^{-d2c/2cl^2}) with
    gated-out entries exactly 0 (cvo.cpp:99-161, adaptive_cvo.cpp:92-151).
    `ell` a number or 0-dim tensor; no host sync.  Clouds on a leading
    lane axis give the [B, N, M] Grams of the B pairs, `ell` one a lane
    ([B]); each lane is the bits of the one-pair call (elementwise ops
    only)."""
    dev = x_pos.device
    s2 = sigma * sigma
    cs2 = c_sigma * c_sigma
    ell = _lane_ell(ell, dev)
    d2_thres = -2.0 * ell * ell * _log32(sp_thres / s2, dev)
    d2_c_thres = -2.0 * c_ell * c_ell * _log32(c_sp_thres / cs2, dev)

    d2 = pairwise_sqdist(x_pos, y_pos)
    d2c = pairwise_sqdist(x_feat, y_feat)
    k = s2 * gram_exp(d2 / (2.0 * ell * ell), fast_exp)
    ck = cs2 * gram_exp(d2c / (2.0 * c_ell * c_ell), fast_exp)
    a = k * ck
    gate = (
        (d2 < d2_thres)
        & (d2c < d2_c_thres)
        & (a > sp_thres)
        & (x_mask[..., :, None] > 0)
        & (y_mask[..., None, :] > 0)
    )
    return torch.where(gate, a, 0.0)


def linear_color_gram(x_feat, y_feat, color_scale):
    """MATLAB-mode color weights CI = scale * Cx Cz^T, a linear color
    kernel computed once per pair (rkhs_se3_registration.m:40-53)."""
    return color_scale * (x_feat @ y_feat.T)


def matlab_gram(x_pos, x_mask, y_pos, y_mask, ci, ell, *, sigma, sp_thres,
                fast_exp=False):
    """MATLAB-mode A: K = se_kernel; K[K < sp] = 0; A = CI .* K
    (rkhs_se3_registration.m:125-127); on a lane axis as `se_gram`."""
    s2 = sigma * sigma
    ell = _lane_ell(ell, x_pos.device)
    d2 = pairwise_sqdist(x_pos, y_pos)
    k = s2 * gram_exp(d2 / (2.0 * ell * ell), fast_exp)
    gate = (
        (k >= sp_thres)
        & (x_mask[..., :, None] > 0)
        & (y_mask[..., None, :] > 0)
    )
    return torch.where(gate, ci * k, 0.0)
