"""Flow (twist) and adaptive length-scale step from a dense Gram.

Port of the JAX package's `core/flow.py`, the dense backend's reductions.
The reference accumulates, per nonzero A_ij, cross and difference terms
under a mutex (cvo.cpp:164-210); over the dense Gram they factor:

    sum_ij A_ij (x_i x y_j)  =  sum_i x_i x (A @ Y)_i
    sum_ij A_ij (y_j - x_i)  =  (1^T A) @ Y  -  (A @ 1) @ X

and for adaptive CVO (adaptive_cvo.cpp:154-272):

    sum_ij A_ij |x_i - y_j|^2
        = (A@1).|X|^2 + (1^T A).|Y|^2 - 2 sum_i x_i.(A @ Y)_i
"""

from __future__ import annotations

import torch


def flow(A, x_pos, y_pos, *, c, d):
    """omega, v from the dense masked A (cvo.cpp:164-210), in DIFFERENCE
    form: r_i = (A y)_i - (A 1)_i x_i = sum_j A_ij (y_j - x_i) cancels
    inside each row before the big reduction, which keeps the fp32 noise
    of the flow below the C++ stop eps=5e-5.  A y is taken as row
    reductions, as in the JAX package, and the cross term is centered
    on the x mean (exact for any center)."""
    row = torch.sum(A, dim=-1)
    Ay = torch.stack(
        [torch.sum(A * y_pos[..., None, :, k], dim=-1) for k in range(3)],
        dim=-1,
    )
    r = Ay - row[..., None] * x_pos
    r_sum = torch.sum(r, dim=-2)
    v = r_sum / d
    c0 = torch.mean(x_pos, dim=-2, keepdim=True)
    omega = (
        torch.sum(torch.linalg.cross(x_pos - c0, r, dim=-1), dim=-2)
        + torch.linalg.cross(c0.squeeze(-2), r_sum, dim=-1)
    ) / c
    return omega, v


def weighted_sqdist_sum(A, x_pos, y_pos):
    """sum_ij A_ij |x_i - y_j|^2, matmul-factored (fp32 pinned)."""
    Ay = A @ y_pos
    row = torch.sum(A, dim=-1)
    col = torch.sum(A, dim=-2)
    x2 = torch.sum(x_pos * x_pos, dim=-1)
    y2 = torch.sum(y_pos * y_pos, dim=-1)
    return torch.dot(row, x2) + torch.dot(col, y2) - 2.0 * torch.sum(
        x_pos * Ay)


def nnz(A):
    """Count of surviving (gated-in) kernel entries, int64."""
    return torch.sum(A > 0)


def adaptive_dl(A, Axx, Ayy, x_pos, y_pos, ell, *, num_fixed=None,
                yy_quirk=False):
    """Length-scale gradient dl (adaptive_cvo.cpp:222-271):

        dl = [sum Ayy|dyy|^2 - 2 sum Axy|dyx|^2 + sum Axx|dxx|^2] / ell^3
             / (nnz(Axx) + nnz(Ayy) - 2 nnz(A)),  a zero count -> 1.

    `yy_quirk` reproduces the reference bug where Ayy rows i < num_fixed
    read a zero |diff_yy|^2 buffer (adaptive_cvo.cpp:190, 256), so Ayy
    enters the numerator only through rows [num_fixed, M); `num_fixed`
    is then the valid fixed-point count."""
    ell3 = ell * ell * ell
    s_xy = weighted_sqdist_sum(A, x_pos, y_pos)
    s_xx = weighted_sqdist_sum(Axx, x_pos, x_pos)
    if yy_quirk:
        if num_fixed is None:
            raise ValueError("yy_quirk requires num_fixed")
        rows = torch.arange(y_pos.shape[-2], device=y_pos.device)
        keep = (rows >= num_fixed).to(Ayy.dtype)
        s_yy = weighted_sqdist_sum(Ayy * keep[:, None], y_pos, y_pos)
    else:
        s_yy = weighted_sqdist_sum(Ayy, y_pos, y_pos)
    numer = (s_yy - 2.0 * s_xy + s_xx) / ell3
    denom = nnz(Axx) + nnz(Ayy) - 2 * nnz(A)
    denom = torch.where(denom == 0, 1, denom).to(numer.dtype)
    return numer / denom
