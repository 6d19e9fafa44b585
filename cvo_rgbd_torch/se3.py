"""Lie-group math for SO(3)/SE(3)/SE_K(3) on torch tensors, fp32-first.

Port of the JAX package's `se3.py` (reference: LieGroup.cpp:20-199).  Every
function works on a leading batch shape and takes the small-angle
branches with `torch.where`, as the JAX package does, so no value
leaves the device.  The 3x3 products run as fp32 matmuls; the align
entry points pin full fp32 (`device.pin_fp32`), since TF32 roughness in
the R @ dR chain stalls the loop above the C++ stops.  The functions of
the align loop take its matmul as `mm`: the batched loop passes
`core.lanes.lane_matmul`, which multiplies lane by lane.

One reference quirk is kept on purpose: `exp_sek3(v, dt)` with
theta < TOLERANCE uses Jl = I, not dt*I (LieGroup.cpp:168-170).
"""

from __future__ import annotations

import torch

# Small-angle guard, matches reference TOLERANCE (LieGroup.cpp:18).
TOLERANCE = 1e-6


def _eye(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix (LieGroup.cpp:20-27)."""
    z = torch.zeros_like(v[..., 0])
    rows = [
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def unskew(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] (LieGroup.cpp:29-33)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _safe_theta(w):
    """(theta, theta^2, small): theta is 1 where the angle is small, so
    the other `where` branch never divides by zero."""
    th2 = torch.sum(w * w, dim=-1)
    small = th2 < TOLERANCE * TOLERANCE
    th_s = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    return th_s, th2, small


def _safe(x, small):
    return torch.where(small, torch.ones_like(x), x)


def _col(c):
    return c[..., None, None]


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, [...,3] -> [...,3,3] (LieGroup.cpp:148-157)."""
    th_s, th2, small = _safe_theta(w)
    A = skew(w)
    A2 = A @ A
    s = torch.sin(th_s) / th_s
    c = (1.0 - torch.cos(th_s)) / (th_s * th_s)
    s = torch.where(small, 1.0 - th2 / 6.0, s)
    c = torch.where(small, 0.5 - th2 / 24.0, c)
    return _eye(w, A.shape) + _col(s) * A + _col(c) * A2


def left_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian (LieGroup.cpp:49-59)."""
    th_s, th2, small = _safe_theta(w)
    A = skew(w)
    A2 = A @ A
    a = (1.0 - torch.cos(th_s)) / (th_s * th_s)
    b = (th_s - torch.sin(th_s)) / (th_s**3)
    a = torch.where(small, 0.5 - th2 / 24.0, a)
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0, b)
    return _eye(w, A.shape) + _col(a) * A + _col(b) * A2


def left_jacobian_inv_so3(w: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """Inverse SO(3) left Jacobian (LieGroup.cpp:61-69)."""
    th_s, th2, small = _safe_theta(w)
    A = skew(w)
    A2 = mm(A, A)
    # 1/t^2 - (1+cos t)/(2 t sin t); Taylor -> 1/12 + t^2/720
    c = 1.0 / (th_s * th_s) - (1.0 + torch.cos(th_s)) / (
        2.0 * th_s * torch.sin(th_s)
    )
    c = torch.where(small, 1.0 / 12.0 + th2 / 720.0, c)
    return _eye(w, A.shape) - 0.5 * A + _col(c) * A2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) log, [...,3,3] -> [...,3] (LieGroup.cpp:120-126)."""
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_th = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    th = torch.acos(cos_th)
    small = th < TOLERANCE
    th_s = _safe(th, small)
    f = th_s / (2.0 * torch.sin(th_s))
    f = torch.where(small, 0.5 + th * th / 12.0, f)
    return f[..., None] * unskew(R - R.transpose(-1, -2))


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble [...,4,4] from [...,3,3] and [...,3]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bot = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    # fill_, not an assignment: no host scalar is copied in (a CUDA
    # graph captures the align loop's body, core/compiled.py)
    bot[..., 0, 3].fill_(1.0)
    return torch.cat([top, bot], dim=-2)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp, [...,6] (w first, u second) -> [...,4,4] (LieGroup.cpp:139-146)."""
    w, u = xi[..., :3], xi[..., 3:]
    t = (left_jacobian_so3(w) @ u[..., None])[..., 0]
    return make_se3(exp_so3(w), t)


def log_se3(X: torch.Tensor) -> torch.Tensor:
    """SE(3) log, [...,4,4] -> [...,6] (LieGroup.cpp:128-136)."""
    w = log_so3(X[..., :3, :3])
    u = (left_jacobian_inv_so3(w) @ X[..., :3, 3:4])[..., 0]
    return torch.cat([w, u], dim=-1)


def se3_inv(R: torch.Tensor, t: torch.Tensor, mm=torch.matmul):
    """[R', -R't] — the reference's `update_tf` (cvo.cpp:83-87)."""
    Rt = R.transpose(-1, -2)
    return Rt, -mm(Rt, t[..., None])[..., 0]


def exp_sek3(omega: torch.Tensor, v: torch.Tensor, dt: torch.Tensor,
             mm=torch.matmul):
    """Scaled SE(3) exponential — the flow integrator (LieGroup.cpp:159-186).

    Returns (dR, dT) with dR = exp(dt * skew(omega)) and
    dT = Jl(dt, omega) @ v; Jl = I below TOLERANCE (reference quirk)."""
    dt = torch.as_tensor(dt, dtype=omega.dtype, device=omega.device)
    th_s, _, small = _safe_theta(omega)
    A = skew(omega)
    A2 = mm(A, A)
    eye = _eye(omega, A.shape)
    th2 = th_s * th_s
    st = torch.sin(dt * th_s)
    ct = torch.cos(dt * th_s)
    one_m_ct = (1.0 - ct) / th2
    R = eye + _col(st / th_s) * A + _col(one_m_ct) * A2
    Jl = (
        _col(dt) * eye
        + _col(one_m_ct) * A
        + _col((dt * th_s - st) / (th2 * th_s)) * A2
    )
    R = torch.where(_col(small), eye, R)
    Jl = torch.where(_col(small), eye, Jl)
    return R, mm(Jl, v[..., None])[..., 0]


def dist_se3(R: torch.Tensor, t: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """Frobenius norm of the SE(3) matrix log (cvo.cpp:71-81):
    sqrt(2 |w|^2 + |u|^2), w = log_so3(R), u = Jl^{-1}(w) t."""
    w = log_so3(R)
    u = mm(left_jacobian_inv_so3(w, mm), t[..., None])[..., 0]
    return torch.sqrt(2.0 * torch.sum(w * w, dim=-1) + torch.sum(u * u, dim=-1))


def adjoint_se3(X: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint, [...,4,4] -> [...,6,6] (LieGroup.cpp:188-199, K=1)."""
    R = X[..., :3, :3]
    p = X[..., :3, 3]
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([skew(p) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def left_jacobian_se3(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) left Jacobian, [...,6] -> [...,6,6] (LieGroup.cpp:71-101),
    in the consistent [[J, 0], [Q, J]] layout for [w; u] ordering."""
    Phi, Rho = xi[..., :3], xi[..., 3:]
    phi_s, _, small = _safe_theta(Phi)
    Px = skew(Phi)
    Rx = skew(Rho)
    J = left_jacobian_so3(Phi)
    phi2 = phi_s * phi_s
    phi3 = phi2 * phi_s
    phi4 = phi3 * phi_s
    phi5 = phi4 * phi_s
    sp = torch.sin(phi_s)
    cp = torch.cos(phi_s)
    c1 = (phi_s - sp) / phi3
    c2 = (1.0 - 0.5 * phi2 - cp) / phi4
    c3 = 0.5 * (c2 - 3.0 * (phi_s - sp - phi3 / 6.0) / phi5)
    c1 = torch.where(small, 1.0 / 6.0, c1)
    c2 = torch.where(small, 1.0 / 24.0, c2)
    c3 = torch.where(small, 1.0 / 120.0, c3)
    Q = (
        0.5 * Rx
        + _col(c1) * (Px @ Rx + Rx @ Px + Px @ (Rx @ Px))
        - _col(c2) * (Px @ (Px @ Rx) + Rx @ (Px @ Px) - 3.0 * (Px @ (Rx @ Px)))
        - _col(c3) * (Px @ (Rx @ (Px @ Px)) + Px @ (Px @ (Rx @ Px)))
    )
    Q = torch.where(_col(small), 0.5 * Rx, Q)
    top = torch.cat([J, torch.zeros_like(J)], dim=-1)
    bot = torch.cat([Q, J], dim=-1)
    return torch.cat([top, bot], dim=-2)
