"""One-sweep moment accumulation: the hot kernel of the align loop.

`fused_moments` replaces the JAX package's `ops/pallas_moments.py:fused_moments`:

    Mom[j, k] = sum_i A_ij Phi[i, k]     [M, 35]
    nnz       = #{A_ij > 0}

with A the gated Gram of the centered clouds (se color mode), or in
MATLAB's linear color mode A = ci * k gated on k >= sp_thres, with `ck`
holding the masked ci of the pair.  Every reduction of an
iteration (flow, line-search coefficients) is then an O(M) epilogue
(core/moments.py).  On a CUDA tensor the wrapper launches the
hand-written kernel `csrc/fused_moments.cu` (or raises); on a CPU tensor
it runs `fused_moments_plain`, the same function in plain torch.

The AABB tile skip is exact: a skipped tile holds only zeros.  Its bound
matrix must be built at the kernel's own tile sizes, TILE_I rows of the
fixed cloud by TILE_J rows of the moving one (`core/cloud.block_bounds`).
"""

from __future__ import annotations

import torch

from cvo_rgbd_torch.core.gram import pairwise_sqdist
from cvo_rgbd_torch.core.numerics import exp_neg
from cvo_rgbd_torch.core.step_factored import NUM_MONO
from cvo_rgbd_torch.ops import _build
from cvo_rgbd_torch.ops.gram import (
    S_D2_C_THRES,
    S_D2_THRES,
    S_INV_2L2,
    S_S2,
    S_SP_THRES,
    check_cloud,
    check_inputs,
    color_terms,
    linear_mode,
    scalars,
)

TILE_I = 64    # fixed-cloud rows per kernel tile (csrc/moment_tile.cuh TI)
TILE_J = 128   # moving-cloud rows per kernel block (csrc/moment_tile.cuh TJ)
# conservative slack on the skip compare: the AABB bound and the
# in-kernel d2 round differently; 1e-5 m^2 skips essentially nothing
# extra and keeps the skip exact (pallas_moments.py:58)
SKIP_MARGIN = 1e-5


def pair_weights(xp, xf, xm, yp, yf, ym, scal, ck=None, linear=False):
    """The gated [N,M] Gram A (port of pallas_gram.py:_pair_tile),
    per-component d2 in difference form.  The exponentials are taken
    only where the position gate can pass: every other entry is zero in
    any case, and the values kept are the same bits.  In linear mode (ck
    the masked ci) the gate is k >= sp_thres alone, which a pair a hair
    beyond d2_thres can pass in fp32, so k is taken out to d2_thres +
    SKIP_MARGIN, where it is far below sp_thres."""
    d2 = pairwise_sqdist(xp, yp)
    if linear:
        near = d2 <= scal[S_D2_THRES] + SKIP_MARGIN
    else:
        near = d2 < scal[S_D2_THRES]
    ii, jj = near.nonzero(as_tuple=True)
    d2n = d2[ii, jj]
    k = scal[S_S2] * exp_neg(d2n * scal[S_INV_2L2])
    if linear:
        a = ck[ii, jj] * k
        gate = k >= scal[S_SP_THRES]
    elif ck is not None:
        a = k * ck[ii, jj]
        gate = a > scal[S_SP_THRES]
    else:
        ckv, d2c = color_terms(xf[ii], yf[jj], scal)
        a = k * ckv
        gate = (
            (d2c < scal[S_D2_C_THRES])
            & (a > scal[S_SP_THRES])
            & (xm[ii] > 0)
            & (ym[jj] > 0)
        )
    A = torch.zeros_like(d2)
    A[ii, jj] = torch.where(gate, a, 0.0)
    return A


def fused_moments_plain(xp, xf, xm, yp, yf, ym, phi, scal, ck=None,
                        min_d2=None, linear=False):
    """Plain torch version of the kernel: the dense gated A, tiles the
    bound rules out set to zero, then A^T Phi and the nonzero count."""
    A = pair_weights(xp, xf, xm, yp, yf, ym, scal, ck, linear)
    if min_d2 is not None:
        keep = min_d2 <= scal[S_D2_THRES] + SKIP_MARGIN
        keep = keep.repeat_interleave(TILE_I, 0).repeat_interleave(TILE_J, 1)
        A = torch.where(keep, A, 0.0)
    return A.T @ phi, (A > 0).sum().to(torch.float32)


def sweep_scratch(n: int, m: int) -> dict:
    """Shapes of the moment sweep's scratch for an [n, m] sweep, the same
    in `fused_moments` and in each lane of `align_fused`: one work item
    per (i-tile, j-block) pair, each with its own slice of a partial
    slot [35, m] per i-tile and its own int count.  A column sums its kept tiles' slots in i-tile order,
    so the split, and every result bit, depends on the shapes alone: not
    on the grid, the card or the lanes beside a pair."""
    nbi = n // TILE_I
    return {"part": (nbi, NUM_MONO, m), "count": (nbi, m // TILE_J)}


def fused_moments(xp, xf, xm, yp, yf, ym, phi, ell, ck=None, min_d2=None,
                  *, p):
    """Returns (Mom [M, 35] f32, nnz 0-dim f32).

    `xp`/`yp` are the CENTERED positions (x - c0, y - c0); `phi` is
    core.step_factored.monomial_features(x - c0) [N, 35]; `ell` a 0-dim
    f32 tensor; `ck` the color_gram cache or None (recompute), in linear
    color mode the masked ci (required); `min_d2` [N/TILE_I, M/TILE_J]
    tile bounds or None (no skip)."""
    linear = linear_mode("fused_moments", p, ck)
    check_cloud("fused_moments", xp, xf, xm)
    check_cloud("fused_moments", yp, yf, ym)
    n, m = xp.shape[0], yp.shape[0]
    if n % TILE_I or m % TILE_J:
        raise ValueError(
            f"fused_moments: capacities must be multiples of {TILE_I} and "
            f"{TILE_J}, got {n} and {m}"
        )
    if phi.shape != (n, NUM_MONO):
        raise ValueError(f"fused_moments: phi must be [{n}, {NUM_MONO}]")
    if ck is not None and ck.shape != (n, m):
        raise ValueError(f"fused_moments: ck must be [{n}, {m}]")
    if min_d2 is not None and min_d2.shape != (n // TILE_I, m // TILE_J):
        raise ValueError(
            f"fused_moments: min_d2 must be [{n // TILE_I}, {m // TILE_J}]"
        )
    dev = xp.device
    scal = scalars(ell, p)
    if dev.type == "cpu":
        return fused_moments_plain(xp, xf, xm, yp, yf, ym, phi, scal, ck,
                                   min_d2, linear)
    if dev.type != "cuda":
        raise ValueError(f"fused_moments: unsupported device {dev}")
    return fused_moments_cuda(xp, xf, xm, yp, yf, ym, phi, scal, ck, min_d2,
                              linear)


def fused_moments_cuda(xp, xf, xm, yp, yf, ym, phi, scal, ck=None,
                       min_d2=None, linear=False):
    """Launch csrc/fused_moments.cu on CUDA tensors (shapes checked by
    `fused_moments`); counts one launch in `fused_moments.launches`."""
    dev = xp.device
    opt = tuple(t for t in (ck, min_d2) if t is not None)
    check_inputs("fused_moments", (xp, xf, xm, yp, yf, ym, phi, scal) + opt,
                 dev)
    # the kernel copies phi rows and ck tiles in 16-byte pieces
    if phi.data_ptr() % 16 or (ck is not None and ck.data_ptr() % 16):
        raise ValueError("fused_moments: phi and ck must be 16-byte aligned")
    n, m = xp.shape[0], yp.shape[0]
    shapes = sweep_scratch(n, m)
    part = torch.empty(shapes["part"], dtype=torch.float32, device=dev)
    cnt_part = torch.empty(shapes["count"], dtype=torch.int32, device=dev)
    mom = torch.empty((m, NUM_MONO), dtype=torch.float32, device=dev)
    nnz = torch.empty((1,), dtype=torch.float32, device=dev)
    launch = _build.entry("fused_moments")
    err = launch(
        xp.data_ptr(), xf.data_ptr(), xm.data_ptr(),
        yp.data_ptr(), yf.data_ptr(), ym.data_ptr(), phi.data_ptr(),
        None if ck is None else ck.data_ptr(),
        None if min_d2 is None else min_d2.data_ptr(),
        scal.data_ptr(), part.data_ptr(), cnt_part.data_ptr(),
        mom.data_ptr(), nnz.data_ptr(), n, m, int(linear),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("fused_moments", err)
    fused_moments.launches += 1
    return mom, nnz[0]


fused_moments.launches = 0
