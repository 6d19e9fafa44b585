"""The color-kernel cache of one pair, and the scalar row both kernels read.

`color_gram` replaces the JAX package's `ops/pallas_gram.py:color_gram`.  On
a CUDA tensor it launches the hand-written kernel `csrc/color_gram.cu`
(or raises); on a CPU tensor it runs `color_gram_plain`, the same
function in plain torch, which the tests hold against the JAX package
and `chip_smoke.py` holds the kernel against on the card.
"""

from __future__ import annotations

import torch

from cvo_rgbd_torch.core.numerics import gram_exp
from cvo_rgbd_torch.ops import _build

NFEAT = 5
# scalar row layout (csrc/pair_tile.cuh enum Scal)
(S_ELL, S_S2, S_CS2, S_INV_2L2, S_INV_2CL2, S_D2_THRES, S_D2_C_THRES,
 S_SP_THRES) = range(8)


def scalars(ell: torch.Tensor, p) -> torch.Tensor:
    """[..., 8] f32 rows: ell, s2, cs2, 1/2ell^2, 1/2c_ell^2, d2_thres,
    d2_c_thres, sp_thres — the JAX package's _scal_vector, in the same
    fp32 operation order, one row for each entry of `ell` (a 0-dim
    tensor gives one [8] row).  `ell` is a tensor on the kernels'
    device; constants are filled there, so no host copy (and no sync)
    happens per iteration.  The logs are taken of 0-dim tensors, so a
    row's bits do not depend on how many rows are built together."""
    dev = ell.device

    def const(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    s2 = p.sigma * p.sigma
    cs2 = p.c_sigma * p.c_sigma
    ell = ell.to(torch.float32)
    d2_thres = -2.0 * ell * ell * torch.log(const(p.sp_thres / s2))
    d2_c_thres = -2.0 * p.c_ell * p.c_ell * torch.log(const(p.c_sp_thres / cs2))
    return torch.stack(torch.broadcast_tensors(
        ell,
        const(s2),
        const(cs2),
        1.0 / (2.0 * ell * ell),
        const(1.0 / (2.0 * p.c_ell * p.c_ell)),
        d2_thres,
        d2_c_thres,
        const(p.sp_thres),
    ), dim=-1)


def color_terms(fx, fy, scal, fast=False):
    """(cs2 * exp(-d2c / 2c_ell^2), d2c) of broadcastable feature rows
    [..., 5]: the color half of the reference Gram (cvo.cpp:143-153),
    features summed in order; exp_neg, or torch.exp when `fast`."""
    d2c = None
    for c in range(NFEAT):
        d = fx[..., c] - fy[..., c]
        d2c = d * d if d2c is None else d2c + d * d
    return scal[S_CS2] * gram_exp(d2c * scal[S_INV_2CL2], fast), d2c


def color_gram_plain(xf, xm, yf, ym, scal):
    """Plain torch version of the kernel: ck, zero where the color gate
    or a validity mask fails; [N,M], or [B,N,M] for clouds on a leading
    lane axis, each lane the bits of the one-pair call (elementwise ops
    broadcast over the lanes)."""
    ck, d2c = color_terms(xf[..., :, None, :], yf[..., None, :, :], scal)
    gate = ((d2c < scal[S_D2_C_THRES]) & (xm[..., :, None] > 0)
            & (ym[..., None, :] > 0))
    return torch.where(gate, ck, 0.0)


def pad_feat(feat):
    """Features zero-padded to the kernels' NFEAT planes (the JAX
    package's _pad_feat), once per align (`core.registration.align`):
    linear-mode clouds carry 3 color features."""
    k = feat.shape[-1]
    if k == NFEAT:
        return feat
    return torch.cat([feat, feat.new_zeros(feat.shape[:-1] + (NFEAT - k,))],
                     dim=-1)


def linear_mode(name, p, ck) -> bool:
    """True in MATLAB's linear color mode, which needs the ci cache."""
    linear = p.color_mode == "linear"
    if linear and ck is None:
        raise ValueError(f"{name}: linear color mode requires the ci cache")
    return linear


def check_inputs(name, tensors, device):
    for t in tensors:
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: every input must be a contiguous float32 tensor "
                f"on {device}, got {t.dtype} on {t.device}"
            )


# per (device, stream): int32 tickets, zeroed once; each launch leaves the
# ones it takes zero for the next launch on its stream, so a call needs
# no memset (a second launch)
_TICKETS = {}


def stream_tickets(dev, count):
    """(tickets, stream): at least `count` zero int32 tickets of the
    current stream of `dev`, for the kernels whose last block (by a
    ticket) folds their reduction into the sweep, and the stream's
    handle."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _TICKETS.get((dev, stream))
    if tickets is None or tickets.numel() < count:
        tickets = torch.zeros((count,), dtype=torch.int32, device=dev)
        _TICKETS[(dev, stream)] = tickets
    return tickets, stream


def check_cloud(name, pos, feat, mask, lanes=False):
    """Raise unless the cloud is positions [N,3], features [N,NFEAT] and
    mask [N], or, where `lanes`, the same with a leading lane axis too."""
    lead = pos.shape[:-2] if lanes and pos.dim() == 3 else ()
    n = pos.shape[-2] if pos.dim() >= 2 else -1
    if (pos.shape != (*lead, n, 3) or feat.shape != (*lead, n, NFEAT)
            or mask.shape != (*lead, n)):
        raise ValueError(
            f"{name}: expected positions [N,3], features [N,{NFEAT}], "
            f"mask [N]{' (or [B,...] each)' if lanes else ''}; got "
            f"{tuple(pos.shape)}, {tuple(feat.shape)}, {tuple(mask.shape)}"
        )


def color_gram(xp, xf, xm, yp, yf, ym, *, p):
    """[N,M] masked color-kernel cache, loop-invariant across align
    iterations (features never transform, c_ell is fixed).  Clouds on a
    leading lane axis ([B,N,*] and [B,M,*]) give the [B,N,M] caches of
    the B pairs in one launch, as JAX's vmap gives the Pallas kernel a
    lane axis; the scalars come from `p.ell_init`, shared by the lanes."""
    check_cloud("color_gram", xp, xf, xm, lanes=True)
    check_cloud("color_gram", yp, yf, ym, lanes=True)
    if xp.shape[:-2] != yp.shape[:-2]:
        raise ValueError(f"color_gram: lanes {tuple(xp.shape[:-2])} and "
                         f"{tuple(yp.shape[:-2])} differ")
    dev = xf.device
    scal = scalars(
        torch.full((), p.ell_init, dtype=torch.float32, device=dev), p
    )
    if dev.type == "cpu":
        return color_gram_plain(xf, xm, yf, ym, scal)
    if dev.type != "cuda":
        raise ValueError(f"color_gram: unsupported device {dev}")
    return color_gram_cuda(xf, xm, yf, ym, scal)


# grid z of csrc/color_gram.cu holds the lanes
MAX_LANES = 65535


def color_gram_cuda(xf, xm, yf, ym, scal):
    """Launch csrc/color_gram.cu on CUDA tensors (shapes checked by
    `color_gram`): one launch for [N,5] features ([N,M] out, one lane) or
    for [B,N,5] ([B,N,M], B lanes); counts one in `color_gram.launches`."""
    dev = xf.device
    check_inputs("color_gram", (xf, xm, yf, ym, scal), dev)
    lead = xf.shape[:-2]
    b = xf.shape[0] if lead else 1
    if b > MAX_LANES:
        raise ValueError(f"color_gram: {b} lanes, the kernel takes at most "
                         f"{MAX_LANES}")
    n, m = xf.shape[-2], yf.shape[-2]
    out = torch.empty((*lead, n, m), dtype=torch.float32, device=dev)
    launch = _build.entry("color_gram")
    err = launch(
        xf.data_ptr(), xm.data_ptr(), yf.data_ptr(), ym.data_ptr(),
        scal.data_ptr(), out.data_ptr(), b, n, m,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("color_gram", err)
    color_gram.launches += 1
    return out


color_gram.launches = 0
