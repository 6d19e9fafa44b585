"""The two Gram sweeps of the two-pass align step: flow, then line search.

`fused_flow` replaces the JAX package's `ops/pallas_gram.py:fused_flow`:

    omega = sum_i x_i x r_i / c,   v = sum_i r_i / d,
    r_i   = sum_j A_ij y_j - (sum_j A_ij) x_i   (difference form),
    wsq   = sum_ij A_ij |x_i - y_j|^2,  nnz = #{A_ij > 0},  sum_A = sum A

and `fused_step_coeffs` its `fused_step_coeffs`: B, C, D, E of the quartic
line search (cvo.cpp:213-289) given omega and v.  A is the gated Gram of
`_pair_tile`: se color mode with the color kernel recomputed or read from
the `color_gram` cache `ck`, or MATLAB's linear mode with `ck` holding the
masked ci (required there).  Both kernels live in `csrc/fused_flow.cu`.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain torch version beside it.  The kernel backend
runs the two sweeps each iteration under `step_mode="direct"`
(core/registration.py); its default, "factored", takes both from one
moment sweep instead.
"""

from __future__ import annotations

import torch

from cvo_rgbd_torch.core.gram import pairwise_sqdist
from cvo_rgbd_torch.ops import _build
from cvo_rgbd_torch.ops.gram import (
    S_INV_2L2,
    check_cloud,
    check_inputs,
    linear_mode,
    scalars,
)
from cvo_rgbd_torch.ops.moments import pair_weights

ROWS = 128     # fixed-cloud rows per kernel block (csrc/fused_flow.cu RB)
TILE_J = 32    # moving-cloud columns per staged tile (csrc/fused_flow.cu TJ)
# blocks to aim for when splitting the moving cloud into chunks, from the
# shapes alone, so the summation order is the same on any card
TARGET_BLOCKS = 1024
# capacities the kernels take (the JAX package's _check)
ALIGN = 128


def chunking(n: int, m: int) -> tuple[int, int]:
    """(column tiles per chunk, number of chunks) of an [n, m] sweep."""
    nbi, nbj = n // ROWS, m // TILE_J
    want = max(1, min(nbj, -(-TARGET_BLOCKS // nbi)))
    per = -(-nbj // want)
    return per, -(-nbj // per)


def fused_flow_plain(xp, xf, xm, yp, yf, ym, scal, ck=None, linear=False):
    """Plain torch version of the flow kernel: the dense gated A, then
    the difference-form residual per row over all of y.  Returns the
    kernel's [9] row: omega*c 3, v*d 3, sum A d2, sum A, nnz."""
    A = pair_weights(xp, xf, xm, yp, yf, ym, scal, ck, linear)
    row = torch.sum(A, dim=1)
    r = torch.stack([torch.sum(A * yp[None, :, k], dim=1) - row * xp[:, k]
                     for k in range(3)], dim=1)
    x0, x1, x2 = xp.unbind(1)
    r0, r1, r2 = r.unbind(1)
    om = torch.stack([torch.sum(x1 * r2 - x2 * r1),
                      torch.sum(x2 * r0 - x0 * r2),
                      torch.sum(x0 * r1 - x1 * r0)])
    return torch.cat([
        om, torch.sum(r, dim=0),
        torch.stack([torch.sum(A * pairwise_sqdist(xp, yp)), torch.sum(row),
                     (A > 0).sum().to(torch.float32)]),
    ])


def _wcross(w, a):
    """omega x a for rows a [..., 3] (pallas_gram.py:215-216)."""
    return torch.stack([w[1] * a[..., 2] - w[2] * a[..., 1],
                        w[2] * a[..., 0] - w[0] * a[..., 2],
                        w[0] * a[..., 1] - w[1] * a[..., 0]], dim=-1)


def _vdot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def fused_step_coeffs_plain(xp, xf, xm, yp, yf, ym, scal, wv, ck=None,
                            linear=False):
    """Plain torch version of the step kernel on the dense gated A, the
    fields of each column and of each pair in the kernel's (the JAX
    kernel's) operation order.  `wv` is [omega 3, v 3]; returns [B, C,
    D, E]."""
    A = pair_weights(xp, xf, xm, yp, yf, ym, scal, ck, linear)
    w, v = wv[:3], wv[3:6]
    xiz = _wcross(w, yp) + v
    xi2z = _wcross(w, xiz)
    xi3z = _wcross(w, xi2z)
    xi4z = _wcross(w, xi3z)
    normxiz2 = _vdot(xiz, xiz)
    xiz_dot_xi2z = -_vdot(xiz, xi2z)
    epsil_const = _vdot(xi2z, xi2z) + 2.0 * _vdot(xiz, xi3z)

    def dotfield(f):
        s = (xp[:, None, 0] * f[None, :, 0] + xp[:, None, 1] * f[None, :, 1]
             + xp[:, None, 2] * f[None, :, 2])
        return s - _vdot(f, yp)[None, :]

    tc = scal[S_INV_2L2]
    beta = -2.0 * tc * dotfield(xiz)
    gamma = -tc * (normxiz2[None, :] + 2.0 * dotfield(xi2z))
    delta = 2.0 * tc * (xiz_dot_xi2z[None, :] - dotfield(xi3z))
    epsil = -tc * (epsil_const[None, :] + 2.0 * dotfield(xi4z))
    beta2 = beta * beta
    bg = beta * gamma
    return torch.stack([
        torch.sum(A * beta),
        torch.sum(A * (gamma + 0.5 * beta2)),
        torch.sum(A * (delta + bg + beta2 * beta / 6.0)),
        torch.sum(A * (epsil + beta * delta + 0.5 * beta2 * gamma
                       + 0.5 * gamma * gamma + beta2 * beta2 / 24.0)),
    ])


def _checked(name, xp, xf, xm, yp, yf, ym, ell, ck, p):
    """The scalar row and the linear flag, after the shape checks the JAX
    wrappers make."""
    linear = linear_mode(name, p, ck)
    check_cloud(name, xp, xf, xm)
    check_cloud(name, yp, yf, ym)
    n, m = xp.shape[0], yp.shape[0]
    if n % ALIGN or m % ALIGN:
        raise ValueError(f"{name}: cloud capacities must be multiples of "
                         f"{ALIGN}, got {n} and {m}")
    if ck is not None and ck.shape != (n, m):
        raise ValueError(f"{name}: ck must be [{n}, {m}]")
    dev = xp.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    ell = torch.as_tensor(ell, dtype=torch.float32).to(dev)
    return scalars(ell, p), linear


def fused_flow(xp, xf, xm, yp, yf, ym, ell, ck=None, *, p):
    """Returns (omega [3], v [3], wsq, nnz, sum_A) on the inputs' device,
    omega and v divided by p.c and p.d after the sums.  Positions as
    they are (not centered); `ell` a number or 0-dim tensor."""
    scal, linear = _checked("fused_flow", xp, xf, xm, yp, yf, ym, ell, ck,
                            p)
    if xp.device.type == "cpu":
        out = fused_flow_plain(xp, xf, xm, yp, yf, ym, scal, ck, linear)
    else:
        out = fused_flow_cuda(xp, xf, xm, yp, yf, ym, scal, ck, linear)
    return out[0:3] / p.c, out[3:6] / p.d, out[6], out[8], out[7]


def fused_step_coeffs(xp, xf, xm, yp, yf, ym, ell, omega, v, ck=None, *, p):
    """Returns (B, C, D, E), 0-dim tensors on the inputs' device."""
    scal, linear = _checked("fused_step_coeffs", xp, xf, xm, yp, yf, ym,
                            ell, ck, p)
    wv = torch.cat([omega.reshape(3), v.reshape(3)]).to(torch.float32)
    if xp.device.type == "cpu":
        out = fused_step_coeffs_plain(xp, xf, xm, yp, yf, ym, scal, wv, ck,
                                      linear)
    else:
        out = fused_step_coeffs_cuda(xp, xf, xm, yp, yf, ym, scal, wv, ck,
                                     linear)
    return out[0], out[1], out[2], out[3]


def _grid(name, tensors):
    """(device, n, m, column tiles per chunk, chunks) of a launch, after
    the inputs' device, type and layout are checked."""
    xp, yp = tensors[0], tensors[3]
    dev = xp.device
    check_inputs(name, tensors, dev)
    n, m = xp.shape[0], yp.shape[0]
    return (dev, n, m, *chunking(n, m))


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_flow_cuda(xp, xf, xm, yp, yf, ym, scal, ck=None, linear=False):
    """Launch the flow kernel on CUDA tensors (shapes checked by
    `fused_flow`); returns its [9] row and counts one launch in
    `fused_flow.launches`."""
    opt = (ck,) if ck is not None else ()
    dev, n, m, per, n_chunks = _grid(
        "fused_flow", (xp, xf, xm, yp, yf, ym, scal) + opt)
    parts = n_chunks * (n // ROWS)
    part = torch.empty((parts, 8), dtype=torch.float32, device=dev)
    cnt = torch.empty((parts,), dtype=torch.int32, device=dev)
    out = torch.empty((9,), dtype=torch.float32, device=dev)
    err = _build.entry("fused_flow")(
        xp.data_ptr(), xf.data_ptr(), xm.data_ptr(), yp.data_ptr(),
        yf.data_ptr(), ym.data_ptr(), _ptr(ck), scal.data_ptr(),
        part.data_ptr(), cnt.data_ptr(), out.data_ptr(), n, m, per,
        n_chunks, int(linear), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("fused_flow", err)
    fused_flow.launches += 1
    return out


def fused_step_coeffs_cuda(xp, xf, xm, yp, yf, ym, scal, wv, ck=None,
                           linear=False):
    """Launch the step kernel on CUDA tensors (shapes checked by
    `fused_step_coeffs`); returns [B, C, D, E] and counts one launch in
    `fused_step_coeffs.launches`."""
    opt = (ck,) if ck is not None else ()
    dev, n, m, per, n_chunks = _grid(
        "fused_step_coeffs", (xp, xf, xm, yp, yf, ym, scal, wv) + opt)
    part = torch.empty((n_chunks * (n // ROWS), 4), dtype=torch.float32,
                       device=dev)
    out = torch.empty((4,), dtype=torch.float32, device=dev)
    err = _build.entry("fused_step_coeffs")(
        xp.data_ptr(), xf.data_ptr(), xm.data_ptr(), yp.data_ptr(),
        yf.data_ptr(), ym.data_ptr(), _ptr(ck), scal.data_ptr(),
        wv.data_ptr(), part.data_ptr(), out.data_ptr(), n, m, per, n_chunks,
        int(linear), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("fused_step_coeffs", err)
    fused_step_coeffs.launches += 1
    return out


fused_flow.launches = 0
fused_step_coeffs.launches = 0
