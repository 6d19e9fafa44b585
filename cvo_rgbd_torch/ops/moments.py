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

Clouds on a leading lane axis ([B, N, *] and [B, M, *], one ell a lane)
give the B pairs' Mom [B, M, 35] and nnz [B] in one launch, as JAX's
vmap gives the Pallas kernel a lane axis in its grid (the batched loop
of `parallel.align_batched`); each lane is the bits of the one-pair call
on it, and a lane that `live` marks False is not swept (zeros).
"""

from __future__ import annotations

import torch

from cvo_rgbd_torch.core.gram import pairwise_sqdist
from cvo_rgbd_torch.core.numerics import gram_exp
from cvo_rgbd_torch.core.step_factored import NUM_MONO
from cvo_rgbd_torch.ops import _build
from cvo_rgbd_torch.ops.gram import (
    MAX_LANES,
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
from cvo_rgbd_torch.params import fast_exp

TILE_I = 64    # fixed-cloud rows per kernel tile (csrc/moment_tile.cuh TI)
TILE_J = 128   # moving-cloud rows per kernel block (csrc/moment_tile.cuh TJ)
# conservative slack on the skip compare: the AABB bound and the
# in-kernel d2 round differently; 1e-5 m^2 skips essentially nothing
# extra and keeps the skip exact (pallas_moments.py:58)
SKIP_MARGIN = 1e-5


def pair_weights(xp, xf, xm, yp, yf, ym, scal, ck=None, linear=False,
                 fast=False):
    """The gated [N,M] Gram A (port of pallas_gram.py:_pair_tile),
    per-component d2 in difference form.  The exponentials are taken
    only where the position gate can pass: every other entry is zero in
    any case, and the values kept are the same bits.  In linear mode (ck
    the masked ci) the gate is k >= sp_thres alone, which a pair a hair
    beyond d2_thres can pass in fp32, so k is taken out to d2_thres +
    SKIP_MARGIN, where it is far below sp_thres.  `fast` takes
    torch.exp(-z) for every exponential of a pair (exp_mode="fast", the
    JAX package's jnp.exp)."""
    d2 = pairwise_sqdist(xp, yp)
    if linear:
        near = d2 <= scal[S_D2_THRES] + SKIP_MARGIN
    else:
        near = d2 < scal[S_D2_THRES]
    ii, jj = near.nonzero(as_tuple=True)
    d2n = d2[ii, jj]
    k = scal[S_S2] * gram_exp(d2n * scal[S_INV_2L2], fast)
    if linear:
        a = ck[ii, jj] * k
        gate = k >= scal[S_SP_THRES]
    elif ck is not None:
        a = k * ck[ii, jj]
        gate = a > scal[S_SP_THRES]
    else:
        ckv, d2c = color_terms(xf[ii], yf[jj], scal, fast)
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


# relative band about sp_thres inside which the kernels' hardware exp
# (__expf, a few ulp) and the plain version's torch.exp may decide the
# sparsity gate differently: ten times their combined error
# (csrc/pair_tile.cuh)
GATE_BAND = 1e-5


def near_gate_pairs(xp, xf, xm, yp, yf, ym, scal, ck=None, linear=False):
    """How many pairs pass every gate but the sparsity one and hold its
    value (a, or k in linear mode, with torch.exp) within GATE_BAND of
    sp_thres, relative: the pairs whose gate another exp may flip.  In
    fast mode a kernel's nnz may differ from its plain version's by at
    most this count."""
    d2 = pairwise_sqdist(xp, yp)
    k = scal[S_S2] * torch.exp(-d2 * scal[S_INV_2L2])
    if linear:
        g = k
        other = ck != 0
    else:
        if ck is None:
            ck, d2c = color_terms(xf[:, None, :], yf[None, :, :], scal, True)
            other = ((d2c < scal[S_D2_C_THRES]) & (xm[:, None] > 0)
                     & (ym[None, :] > 0))
        else:
            other = ck > 0
        g = k * ck
        other = other & (d2 < scal[S_D2_THRES])
    near = (g / scal[S_SP_THRES] - 1.0).abs() <= GATE_BAND
    return int((near & other).sum())


def fused_moments_plain(xp, xf, xm, yp, yf, ym, phi, scal, ck=None,
                        min_d2=None, linear=False, fast=False):
    """Plain torch version of the kernel: the dense gated A, tiles the
    bound rules out set to zero, then A^T Phi and the nonzero count."""
    A = pair_weights(xp, xf, xm, yp, yf, ym, scal, ck, linear, fast)
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


def fused_moments_plain_batched(xp, xf, xm, yp, yf, ym, phi, scal, ck=None,
                                min_d2=None, linear=False, fast=False,
                                live=None):
    """The plain version on a lane axis: `fused_moments_plain` lane by
    lane with the lane's scalar row, zeros for a lane that `live` marks
    False (the kernel sweeps no frozen lane)."""
    moms, nnzs = [], []
    for b in range(xp.shape[0]):
        if live is not None and not bool(live[b]):
            moms.append(xp.new_zeros((yp.shape[-2], NUM_MONO)))
            nnzs.append(xp.new_zeros(()))
            continue
        mom, nnz = fused_moments_plain(
            xp[b], xf[b], xm[b], yp[b], yf[b], ym[b], phi[b], scal[b],
            None if ck is None else ck[b],
            None if min_d2 is None else min_d2[b], linear, fast)
        moms.append(mom)
        nnzs.append(nnz)
    return torch.stack(moms), torch.stack(nnzs)


def _check_shapes(xp, yp, phi, ell, ck, min_d2, live):
    """Raise unless the inputs are one pair's or B lanes' (a leading
    lane axis on every tensor, ell and live [B])."""
    lead = xp.shape[:-2]
    if yp.shape[:-2] != lead:
        raise ValueError(f"fused_moments: lanes {tuple(lead)} and "
                         f"{tuple(yp.shape[:-2])} differ")
    n, m = xp.shape[-2], yp.shape[-2]
    if n % TILE_I or m % TILE_J:
        raise ValueError(
            f"fused_moments: capacities must be multiples of {TILE_I} and "
            f"{TILE_J}, got {n} and {m}"
        )
    if phi.shape != (*lead, n, NUM_MONO):
        raise ValueError(f"fused_moments: phi must be [{n}, {NUM_MONO}]"
                         f"{' a lane' if lead else ''}")
    if ck is not None and ck.shape != (*lead, n, m):
        raise ValueError(f"fused_moments: ck must be [{n}, {m}]"
                         f"{' a lane' if lead else ''}")
    if min_d2 is not None and min_d2.shape != (
            *lead, n // TILE_I, m // TILE_J):
        raise ValueError(
            f"fused_moments: min_d2 must be [{n // TILE_I}, {m // TILE_J}]"
            f"{' a lane' if lead else ''}"
        )
    if tuple(ell.shape) != tuple(lead):
        raise ValueError(f"fused_moments: ell must be one a lane, "
                         f"{tuple(lead)}, got {tuple(ell.shape)}")
    if live is not None and (not lead or live.shape != lead
                             or live.dtype != torch.bool):
        raise ValueError("fused_moments: live must be a bool flag a lane")
    if len(lead) > 1 or (lead and lead[0] > MAX_LANES):
        raise ValueError(f"fused_moments: one lane axis of at most "
                         f"{MAX_LANES} lanes, got {tuple(lead)}")


def fused_moments(xp, xf, xm, yp, yf, ym, phi, ell, ck=None, min_d2=None,
                  *, p, live=None):
    """Returns (Mom [M, 35] f32, nnz 0-dim f32), or on a lane axis
    (Mom [B, M, 35], nnz [B]).

    `xp`/`yp` are the CENTERED positions (x - c0, y - c0); `phi` is
    core.step_factored.monomial_features(x - c0) [N, 35]; `ell` a 0-dim
    f32 tensor; `ck` the color_gram cache or None (recompute), in linear
    color mode the masked ci (required); `min_d2` [N/TILE_I, M/TILE_J]
    tile bounds or None (no skip).  With a leading lane axis B on every
    cloud tensor, `phi`, `ck` and `min_d2`, `ell` is [B] and `live` an
    optional [B] bool: a False lane is not swept and gets zeros."""
    linear = linear_mode("fused_moments", p, ck)
    check_cloud("fused_moments", xp, xf, xm, lanes=True)
    check_cloud("fused_moments", yp, yf, ym, lanes=True)
    _check_shapes(xp, yp, phi, ell, ck, min_d2, live)
    dev = xp.device
    scal = scalars(ell, p)
    if dev.type == "cpu":
        if xp.dim() == 3:
            return fused_moments_plain_batched(
                xp, xf, xm, yp, yf, ym, phi, scal, ck, min_d2, linear,
                fast_exp(p), live)
        return fused_moments_plain(xp, xf, xm, yp, yf, ym, phi, scal, ck,
                                   min_d2, linear, fast_exp(p))
    if dev.type != "cuda":
        raise ValueError(f"fused_moments: unsupported device {dev}")
    return fused_moments_cuda(xp, xf, xm, yp, yf, ym, phi, scal, ck, min_d2,
                              linear, fast_exp(p), live)


def fused_moments_cuda(xp, xf, xm, yp, yf, ym, phi, scal, ck=None,
                       min_d2=None, linear=False, fast=False, live=None):
    """Launch csrc/fused_moments.cu on CUDA tensors (shapes checked by
    `fused_moments`): one launch for one pair (scal [8]), counted in
    `fused_moments.launches`, or for the B lanes of [B, ...] inputs
    (scal [B, 8], `live` [B] bool or None), counted in
    `fused_moments.lanes.launches`."""
    dev = xp.device
    opt = tuple(t for t in (ck, min_d2) if t is not None)
    check_inputs("fused_moments", (xp, xf, xm, yp, yf, ym, phi, scal) + opt,
                 dev)
    # the kernel copies ck tiles in 16-byte pieces; phi is held to the
    # same rule, the contract of every kernel that stages it (a lane's
    # slices start 16-byte aligned: N is a multiple of TILE_I)
    if phi.data_ptr() % 16 or (ck is not None and ck.data_ptr() % 16):
        raise ValueError("fused_moments: phi and ck must be 16-byte aligned")
    lead = xp.shape[:-2]
    b = lead[0] if lead else 1
    if scal.shape != (*lead, 8):
        raise ValueError(f"fused_moments: scal must be [{b}, 8] for {b} "
                         "lanes" if lead else "fused_moments: scal must be [8]")
    if live is not None and (live.device != dev or live.dtype != torch.bool
                             or live.shape != (b,)
                             or not live.is_contiguous()):
        raise ValueError(f"fused_moments: live must be a contiguous [{b}] "
                         f"bool tensor on {dev}")
    n, m = xp.shape[-2], yp.shape[-2]
    shapes = sweep_scratch(n, m)
    part = torch.empty((*lead, *shapes["part"]), dtype=torch.float32,
                       device=dev)
    cnt_part = torch.empty((*lead, *shapes["count"]), dtype=torch.int32,
                           device=dev)
    mom = torch.empty((*lead, m, NUM_MONO), dtype=torch.float32, device=dev)
    nnz = torch.empty((b,), dtype=torch.float32, device=dev)
    launch = _build.entry("fused_moments")
    err = launch(
        xp.data_ptr(), xf.data_ptr(), xm.data_ptr(),
        yp.data_ptr(), yf.data_ptr(), ym.data_ptr(), phi.data_ptr(),
        None if ck is None else ck.data_ptr(),
        None if min_d2 is None else min_d2.data_ptr(),
        scal.data_ptr(), None if live is None else live.data_ptr(),
        part.data_ptr(), cnt_part.data_ptr(),
        mom.data_ptr(), nnz.data_ptr(), n, m, int(linear), int(fast), b,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("fused_moments", err)
    (fused_moments.lanes if lead else fused_moments).launches += 1
    return mom, (nnz if lead else nnz[0])


class LaunchCount:
    """The launch count of one form of a kernel, beside its wrapper's."""

    def __init__(self):
        self.launches = 0


fused_moments.launches = 0
# the launches on a lane axis (one a batch), apart from the one-pair ones
fused_moments.lanes = LaunchCount()
