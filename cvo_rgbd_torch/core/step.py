"""Line-search step size from a dense Gram: the direct quartic form.

Port of the JAX package's `core/step.py` (the dense backend's
`step_mode="direct"`).  The reference re-traverses nnz(A) computing
per-pair beta/gamma/delta/epsilon (cvo.cpp:213-308).  Each is affine in
x_i - y_j, so over the dense Gram the [N,M] fields factor as

    w_j . (x_i - y_j)  =  (X @ W^T)_ij - (w_j . y_j)_j

one [N,3]x[3,M] product per derivative order plus per-column terms.
"""

from __future__ import annotations

import torch

from cvo_rgbd_torch.core.cubic import cubic_roots, min_positive_root
from cvo_rgbd_torch.se3 import skew


def step_coefficients(A, x_pos, y_pos, omega, v, ell):
    """B, C, D, E of the quartic objective (cvo.cpp:213-289)."""
    w_hat = skew(omega)
    w2 = w_hat @ w_hat
    w3 = w2 @ w_hat
    w4 = w3 @ w_hat

    # per-j derivative fields [M,3] (cvo.cpp:226-238)
    xiz = torch.linalg.cross(omega.expand_as(y_pos), y_pos, dim=-1) + v
    xi2z = y_pos @ w2.T + (w_hat @ v[..., None])[..., 0]
    xi3z = y_pos @ w3.T + (w2 @ v[..., None])[..., 0]
    xi4z = y_pos @ w4.T + (w3 @ v[..., None])[..., 0]

    normxiz2 = torch.sum(xiz * xiz, dim=-1)
    xiz_dot_xi2z = -torch.sum(xiz * xi2z, dim=-1)
    epsil_const = torch.sum(xi2z * xi2z, dim=-1) + 2.0 * torch.sum(
        xiz * xi3z, dim=-1
    )

    def dotfield(w_field):
        """[N,M] matrix of w_j . (x_i - y_j)."""
        wy = torch.sum(w_field * y_pos, dim=-1)
        return x_pos @ w_field.T - wy[..., None, :]

    tc = 1.0 / (2.0 * ell * ell)
    beta = -2.0 * tc * dotfield(xiz)
    gamma = -tc * (normxiz2[..., None, :] + 2.0 * dotfield(xi2z))
    delta = 2.0 * tc * (xiz_dot_xi2z[..., None, :] - dotfield(xi3z))
    epsil = -tc * (epsil_const[..., None, :] + 2.0 * dotfield(xi4z))

    beta2 = beta * beta
    bg = beta * gamma
    B = torch.sum(A * beta)
    C = torch.sum(A * (gamma + 0.5 * beta2))
    D = torch.sum(A * (delta + bg + beta2 * beta / 6.0))
    E = torch.sum(
        A * (epsil + beta * delta + 0.5 * beta2 * gamma + 0.5 * gamma * gamma
             + beta2 * beta2 / 24.0)
    )
    return B, C, D, E


def step_size(A, x_pos, y_pos, omega, v, ell, *, min_step, max_step):
    """Integration step (cvo.cpp:291-307): min positive real root of
    4E t^3 + 3D t^2 + 2C t + B, else min_step, clamped to max_step."""
    B, C, D, E = step_coefficients(A, x_pos, y_pos, omega, v, ell)
    roots, valid = cubic_roots(4.0 * E, 3.0 * D, 2.0 * C, B)
    return min_positive_root(roots, valid, min_step, max_step)
