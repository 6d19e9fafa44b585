"""The color-kernel cache of one pair, and the scalar row both kernels read.

`color_gram` replaces the JAX package's `ops/pallas_gram.py:color_gram`.  On
a CUDA tensor it launches the hand-written kernel `csrc/color_gram.cu`
(or raises); on a CPU tensor it runs `color_gram_plain`, the same
function in plain torch, which the tests hold against the JAX package
and `chip_smoke.py` holds the kernel against on the card.
"""

from __future__ import annotations

import torch

from cvo_rgbd_torch.core.numerics import exp_neg
from cvo_rgbd_torch.ops import _build

NFEAT = 5
# scalar row layout (csrc/pair_tile.cuh enum Scal)
(S_ELL, S_S2, S_CS2, S_INV_2L2, S_INV_2CL2, S_D2_THRES, S_D2_C_THRES,
 S_SP_THRES) = range(8)


def scalars(ell: torch.Tensor, p) -> torch.Tensor:
    """[8] f32 row: ell, s2, cs2, 1/2ell^2, 1/2c_ell^2, d2_thres,
    d2_c_thres, sp_thres — the JAX package's _scal_vector, in the same
    fp32 operation order.  `ell` is a 0-dim tensor on the kernels'
    device; constants are filled there, so no host copy (and no sync)
    happens per iteration."""
    dev = ell.device

    def const(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    s2 = p.sigma * p.sigma
    cs2 = p.c_sigma * p.c_sigma
    ell = ell.to(torch.float32)
    d2_thres = -2.0 * ell * ell * torch.log(const(p.sp_thres / s2))
    d2_c_thres = -2.0 * p.c_ell * p.c_ell * torch.log(const(p.c_sp_thres / cs2))
    return torch.stack([
        ell,
        const(s2),
        const(cs2),
        1.0 / (2.0 * ell * ell),
        const(1.0 / (2.0 * p.c_ell * p.c_ell)),
        d2_thres,
        d2_c_thres,
        const(p.sp_thres),
    ])


def color_terms(fx, fy, scal):
    """(cs2 * exp_neg(d2c / 2c_ell^2), d2c) of broadcastable feature rows
    [..., 5]: the color half of the reference Gram (cvo.cpp:143-153),
    features summed in order."""
    d2c = None
    for c in range(NFEAT):
        d = fx[..., c] - fy[..., c]
        d2c = d * d if d2c is None else d2c + d * d
    return scal[S_CS2] * exp_neg(d2c * scal[S_INV_2CL2]), d2c


def color_gram_plain(xf, xm, yf, ym, scal):
    """Plain torch version of the kernel: ck, zero where the color gate
    or a validity mask fails."""
    ck, d2c = color_terms(xf[:, None, :], yf[None, :, :], scal)
    gate = (d2c < scal[S_D2_C_THRES]) & (xm[:, None] > 0) & (ym[None, :] > 0)
    return torch.where(gate, ck, 0.0)


def check_inputs(name, tensors, device):
    for t in tensors:
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: every input must be a contiguous float32 tensor "
                f"on {device}, got {t.dtype} on {t.device}"
            )


def check_cloud(name, pos, feat, mask):
    n = pos.shape[0]
    if pos.shape != (n, 3) or feat.shape != (n, NFEAT) or mask.shape != (n,):
        raise ValueError(
            f"{name}: expected positions [N,3], features [N,{NFEAT}], "
            f"mask [N]; got {tuple(pos.shape)}, {tuple(feat.shape)}, "
            f"{tuple(mask.shape)}"
        )


def color_gram(xp, xf, xm, yp, yf, ym, *, p):
    """[N,M] masked color-kernel cache, loop-invariant across align
    iterations (features never transform, c_ell is fixed)."""
    check_cloud("color_gram", xp, xf, xm)
    check_cloud("color_gram", yp, yf, ym)
    dev = xf.device
    scal = scalars(
        torch.full((), p.ell_init, dtype=torch.float32, device=dev), p
    )
    if dev.type == "cpu":
        return color_gram_plain(xf, xm, yf, ym, scal)
    if dev.type != "cuda":
        raise ValueError(f"color_gram: unsupported device {dev}")
    return color_gram_cuda(xf, xm, yf, ym, scal)


def color_gram_cuda(xf, xm, yf, ym, scal):
    """Launch csrc/color_gram.cu on CUDA tensors (shapes checked by
    `color_gram`); counts one launch in `color_gram.launches`."""
    dev = xf.device
    check_inputs("color_gram", (xf, xm, yf, ym, scal), dev)
    n, m = xf.shape[0], yf.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    launch = _build.entry("color_gram")
    err = launch(
        xf.data_ptr(), xm.data_ptr(), yf.data_ptr(), ym.data_ptr(),
        scal.data_ptr(), out.data_ptr(), n, m,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("color_gram", err)
    color_gram.launches += 1
    return out


color_gram.launches = 0
