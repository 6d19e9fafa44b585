"""The two Gram sweeps of the two-pass align step: flow, then line search.

`fused_flow` replaces the JAX package's `ops/pallas_gram.py:fused_flow`:

    omega = sum_i x_i x r_i / c,   v = sum_i r_i / d,
    r_i   = sum_j A_ij y_j - (sum_j A_ij) x_i   (difference form),
    wsq   = sum_ij A_ij |x_i - y_j|^2,  nnz = #{A_ij > 0},  sum_A = sum A

and `fused_step_coeffs` its `fused_step_coeffs`: B, C, D, E of the quartic
line search (cvo.cpp:213-289) given omega and v.  A is the gated Gram of
`_pair_tile`: se color mode with the color kernel recomputed or read from
the `color_gram` cache `ck`, or MATLAB's linear mode with `ck` holding the
masked ci (required there).  Both kernels live in `csrc/fused_flow.cu`:
one launch a call, one block a (ROWS, TILE_J) tile of the sweep, and
with `p.tile_skip` an exact AABB skip of the tiles that hold no pair
inside the gate (`tile_keep` is its rule).

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain torch version beside it.  The kernel backend
runs the two sweeps each iteration under `step_mode="direct"`
(core/registration.py); its default, "factored", takes both from one
moment sweep instead.
"""

from __future__ import annotations

import ctypes

import torch

from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
from cvo_rgbd_torch.core.gram import pairwise_sqdist
from cvo_rgbd_torch.ops import _build
from cvo_rgbd_torch.ops.gram import (
    S_D2_THRES,
    S_INV_2L2,
    check_cloud,
    check_inputs,
    linear_mode,
    scalars,
    stream_tickets,
)
from cvo_rgbd_torch.ops.moments import SKIP_MARGIN, pair_weights
from cvo_rgbd_torch.params import fast_exp

ROWS = 128     # fixed-cloud rows per work item (csrc/fused_flow.cu RB)
TILE_J = 32    # moving-cloud columns per work item (csrc/fused_flow.cu TJ)
# capacities the kernels take (the JAX package's _check)
ALIGN = 128


def tile_keep(xp, xm, yp, ym, scal):
    """[n / ROWS, m / TILE_J] bool: the work items the kernels' skip
    sweeps, by its rule: the squared gap between the boxes of the item's
    valid fixed rows and valid moving columns at most d2_thres +
    SKIP_MARGIN (ops/moments.py).  An all-invalid tile is never kept."""
    md = aabb_min_d2(*block_bounds(xp, xm, ROWS),
                     *block_bounds(yp, ym, TILE_J))
    return md <= scal[S_D2_THRES] + SKIP_MARGIN


def _gated(xp, xf, xm, yp, yf, ym, scal, ck, linear, keep, fast):
    """The dense gated A, the tiles `keep` drops set to zero."""
    A = pair_weights(xp, xf, xm, yp, yf, ym, scal, ck, linear, fast)
    if keep is None:
        return A
    keep = keep.repeat_interleave(ROWS, 0).repeat_interleave(TILE_J, 1)
    return torch.where(keep, A, 0.0)


def fused_flow_plain(xp, xf, xm, yp, yf, ym, scal, ck=None, linear=False,
                     keep=None, fast=False):
    """Plain torch version of the flow kernel: the dense gated A (the
    tiles `keep` drops, if given, zeroed), then the difference-form
    residual per row over all of y.  Returns the kernel's [9] row:
    omega*c 3, v*d 3, sum A d2, sum A, nnz.  `fast`: torch.exp in the
    Gram (exp_mode="fast")."""
    A = _gated(xp, xf, xm, yp, yf, ym, scal, ck, linear, keep, fast)
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
                            linear=False, keep=None, fast=False):
    """Plain torch version of the step kernel on the dense gated A (as
    `fused_flow_plain`), the fields of each column and of each pair in
    the kernel's (the JAX kernel's) operation order.  `wv` is [omega 3,
    v 3]; returns [B, C, D, E]."""
    A = _gated(xp, xf, xm, yp, yf, ym, scal, ck, linear, keep, fast)
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
        out = fused_flow_plain(xp, xf, xm, yp, yf, ym, scal, ck, linear,
                               fast=fast_exp(p))
    else:
        out = fused_flow_cuda(xp, xf, xm, yp, yf, ym, scal, ck, linear,
                              skip=p.tile_skip, fast=fast_exp(p))
    return out[0:3] / p.c, out[3:6] / p.d, out[6], out[8], out[7]


def fused_step_coeffs(xp, xf, xm, yp, yf, ym, ell, omega, v, ck=None, *, p):
    """Returns (B, C, D, E), 0-dim tensors on the inputs' device."""
    scal, linear = _checked("fused_step_coeffs", xp, xf, xm, yp, yf, ym,
                            ell, ck, p)
    wv = torch.cat([omega.reshape(3), v.reshape(3)]).to(torch.float32)
    if xp.device.type == "cpu":
        out = fused_step_coeffs_plain(xp, xf, xm, yp, yf, ym, scal, wv, ck,
                                      linear, fast=fast_exp(p))
    else:
        out = fused_step_coeffs_cuda(xp, xf, xm, yp, yf, ym, scal, wv, ck,
                                     linear, skip=p.tile_skip,
                                     fast=fast_exp(p))
    return out[0], out[1], out[2], out[3]


def _launch_scratch(name, tensors, ck, width):
    """(device, n, m, part, cnt, ticket, stream) of a launch, after the
    inputs' device, type, layout and the cache's alignment are checked:
    each work item's partial row of `width` floats and its int count
    (-1 where the skip drops it), and the stream's ticket."""
    xp, yp = tensors[0], tensors[3]
    dev = xp.device
    check_inputs(name, tensors, dev)
    # the kernels copy ck in 16-byte pieces
    if ck is not None and ck.data_ptr() % 16:
        raise ValueError(f"{name}: ck must be 16-byte aligned")
    n, m = xp.shape[0], yp.shape[0]
    ticket, stream = stream_tickets(dev, 1)
    items = (n // ROWS) * (m // TILE_J)
    part = torch.empty((items, width), dtype=torch.float32, device=dev)
    cnt = torch.empty((items,), dtype=torch.int32, device=dev)
    return dev, n, m, part, cnt, ticket, stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_flow_cuda(xp, xf, xm, yp, yf, ym, scal, ck=None, linear=False,
                    skip=True, timed=False, fast=False):
    """Launch the flow kernel on CUDA tensors (shapes checked by
    `fused_flow`), with the tile skip when `skip` and the hardware exp
    when `fast`; returns its [9] row
    and counts one launch in `fused_flow.launches`.  `timed` launches the
    timing tool's build, whose per-block marks `flow_marks` reads."""
    opt = (ck,) if ck is not None else ()
    dev, n, m, part, cnt, ticket, stream = _launch_scratch(
        "fused_flow", (xp, xf, xm, yp, yf, ym, scal) + opt, ck, 8)
    out = torch.empty((9,), dtype=torch.float32, device=dev)
    err = _build.entry("fused_flow" + ("_timed" if timed else ""))(
        xp.data_ptr(), xf.data_ptr(), xm.data_ptr(), yp.data_ptr(),
        yf.data_ptr(), ym.data_ptr(), _ptr(ck), scal.data_ptr(),
        part.data_ptr(), cnt.data_ptr(), ticket.data_ptr(), out.data_ptr(),
        n, m, int(skip), int(linear), int(fast), stream,
    )
    _build.check("fused_flow", err)
    fused_flow.launches += 1
    return out


def fused_step_coeffs_cuda(xp, xf, xm, yp, yf, ym, scal, wv, ck=None,
                           linear=False, skip=True, timed=False, fast=False):
    """Launch the step kernel on CUDA tensors (shapes checked by
    `fused_step_coeffs`), with the tile skip when `skip`; returns [B, C,
    D, E] and counts one launch in `fused_step_coeffs.launches`.  `timed`
    and `fast` as in `fused_flow_cuda`."""
    opt = (ck,) if ck is not None else ()
    dev, n, m, part, cnt, ticket, stream = _launch_scratch(
        "fused_step_coeffs", (xp, xf, xm, yp, yf, ym, scal, wv) + opt, ck, 4)
    out = torch.empty((4,), dtype=torch.float32, device=dev)
    err = _build.entry("fused_step_coeffs" + ("_timed" if timed else ""))(
        xp.data_ptr(), xf.data_ptr(), xm.data_ptr(), yp.data_ptr(),
        yf.data_ptr(), ym.data_ptr(), _ptr(ck), scal.data_ptr(),
        wv.data_ptr(), part.data_ptr(), cnt.data_ptr(), ticket.data_ptr(),
        out.data_ptr(), n, m, int(skip), int(linear), int(fast), stream,
    )
    _build.check("fused_step_coeffs", err)
    fused_step_coeffs.launches += 1
    return out


def flow_marks(blocks):
    """[blocks, 6] int64 of the timed build's last launch, a row a block
    (one a work item, in item order): %globaltimer ns at the block's
    start, after the skip test, after the sweep (kept items only), after
    the ticket and at its end, then the item's kept flag."""
    out = (ctypes.c_ulonglong * (6 * blocks))()
    err = _build.entry("fused_flow_marks")(ctypes.addressof(out), blocks)
    _build.check("fused_flow_marks", err)
    return torch.tensor(list(out), dtype=torch.int64).reshape(blocks, 6)


fused_flow.launches = 0
fused_step_coeffs.launches = 0
