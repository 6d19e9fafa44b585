"""The lean self-kernel sweep of adaptive CVO.

`fused_wsq` replaces the JAX package's `ops/pallas_moments.py:fused_wsq`:

    wsq = sum_ij A_ij |x_i - y_j|^2      nnz = #{A_ij > 0}

the only two quantities the adaptive length-scale step dl needs from the
self-kernels Axx and Ayy (adaptive_cvo.cpp:222-271).  On a CUDA tensor
the wrapper launches the hand-written kernel `csrc/fused_wsq.cu` (or
raises); on a CPU tensor it runs `fused_wsq_plain`, the same function in
plain torch.

`symmetric=True` (x and y the same cloud) evaluates only the upper
triangle of TILE_W-square tiles on the card, off-diagonal tiles counted
twice; A is then exactly symmetric, so the result equals the full sweep
up to fp32 summation order (the plain version always sweeps in full).
The AABB tile skip is exact, and its bound matrix is built at TILE_W on
both sides (`core/cloud.block_bounds`).
"""

from __future__ import annotations

import torch

from cvo_rgbd_torch.core.gram import pairwise_sqdist
from cvo_rgbd_torch.ops import _build
from cvo_rgbd_torch.ops.gram import (
    S_D2_THRES,
    check_cloud,
    check_inputs,
    scalars,
)
from cvo_rgbd_torch.ops.moments import SKIP_MARGIN, pair_weights

TILE_W = 64   # square tile of the self-sweep (csrc/fused_wsq.cu TW)


def fused_wsq_plain(xp, xf, xm, yp, yf, ym, scal, ck=None, min_d2=None):
    """Plain torch version of the kernel: the dense gated A, tiles the
    bound rules out set to zero, then sum(A * d2) and the nonzero count,
    over the full [N, M] sweep."""
    A = pair_weights(xp, xf, xm, yp, yf, ym, scal, ck)
    if min_d2 is not None:
        keep = min_d2 <= scal[S_D2_THRES] + SKIP_MARGIN
        keep = keep.repeat_interleave(TILE_W, 0).repeat_interleave(TILE_W, 1)
        A = torch.where(keep, A, 0.0)
    wsq = torch.sum(A * pairwise_sqdist(xp, yp))
    return wsq, (A > 0).sum().to(torch.float32)


def fused_wsq(xp, xf, xm, yp, yf, ym, ell, ck=None, min_d2=None, *, p,
              symmetric=False):
    """Returns (wsq, nnz), both 0-dim f32 on the inputs' device.

    `ell` a 0-dim f32 tensor; `ck` the color_gram cache of the pair or
    None (recompute); `min_d2` [N/TILE_W, M/TILE_W] tile bounds or None
    (no skip).  `symmetric` requires a self-pair (n == m)."""
    check_cloud("fused_wsq", xp, xf, xm)
    check_cloud("fused_wsq", yp, yf, ym)
    n, m = xp.shape[0], yp.shape[0]
    if n % TILE_W or m % TILE_W:
        raise ValueError(
            f"fused_wsq: capacities must be multiples of {TILE_W}, got {n} "
            f"and {m}"
        )
    if symmetric and n != m:
        raise ValueError("fused_wsq: symmetric sweep requires a self-pair "
                         f"(n == m), got {n} and {m}")
    if ck is not None and ck.shape != (n, m):
        raise ValueError(f"fused_wsq: ck must be [{n}, {m}]")
    if min_d2 is not None and min_d2.shape != (n // TILE_W, m // TILE_W):
        raise ValueError(
            f"fused_wsq: min_d2 must be [{n // TILE_W}, {m // TILE_W}]"
        )
    dev = xp.device
    scal = scalars(ell, p)
    if dev.type == "cpu":
        return fused_wsq_plain(xp, xf, xm, yp, yf, ym, scal, ck, min_d2)
    if dev.type != "cuda":
        raise ValueError(f"fused_wsq: unsupported device {dev}")
    return fused_wsq_cuda(xp, xf, xm, yp, yf, ym, scal, ck, min_d2,
                          symmetric=symmetric)


def fused_wsq_cuda(xp, xf, xm, yp, yf, ym, scal, ck=None, min_d2=None, *,
                   symmetric=False):
    """Launch csrc/fused_wsq.cu on CUDA tensors (shapes checked by
    `fused_wsq`); counts one launch in `fused_wsq.launches`."""
    dev = xp.device
    opt = tuple(t for t in (ck, min_d2) if t is not None)
    check_inputs("fused_wsq", (xp, xf, xm, yp, yf, ym, scal) + opt, dev)
    n, m = xp.shape[0], yp.shape[0]
    nb_i, nb_j = n // TILE_W, m // TILE_W
    n_parts = nb_i * (nb_i + 1) // 2 if symmetric else nb_i * nb_j
    wsq_part = torch.empty((n_parts,), dtype=torch.float32, device=dev)
    cnt_part = torch.empty((n_parts,), dtype=torch.int32, device=dev)
    out = torch.empty((2,), dtype=torch.float32, device=dev)
    launch = _build.entry("fused_wsq")
    err = launch(
        xp.data_ptr(), xf.data_ptr(), xm.data_ptr(),
        yp.data_ptr(), yf.data_ptr(), ym.data_ptr(),
        None if ck is None else ck.data_ptr(),
        None if min_d2 is None else min_d2.data_ptr(),
        scal.data_ptr(), wsq_part.data_ptr(), cnt_part.data_ptr(),
        out.data_ptr(), n, m, int(symmetric), n_parts,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("fused_wsq", err)
    fused_wsq.launches += 1
    return out[0], out[1]


fused_wsq.launches = 0
