"""The kernels' plain versions against the JAX package's Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as the JAX suite
runs them (tests/test_pallas.py).  The CUDA kernels themselves run only
on a card: tests/test_torch_cuda.py holds them against these plain
versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvo_rgbd_torch.core import cloud as tcloud
from cvo_rgbd_torch.core.step_factored import monomial_features
from cvo_rgbd_torch.ops import color_gram as t_color_gram
from cvo_rgbd_torch.ops import fused_moments as t_fused_moments
from cvo_rgbd_torch.ops.moments import TILE_I, TILE_J
from cvo_rgbd_torch.params import CvoParams as TP
from cvo_rgbd_tpu import pad_cloud, se3
from cvo_rgbd_tpu.core.moments import monomial_features_padded
from cvo_rgbd_tpu.ops import color_gram as j_color_gram
from cvo_rgbd_tpu.ops import fused_moments as j_fused_moments
from cvo_rgbd_tpu.ops.pallas_gram import aabb_min_d2, block_bounds
from cvo_rgbd_tpu.params import CvoParams as JP

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _pair(rng, n, cap):
    """A rotated, shifted, overlapping pair with padding — the shape of
    tests/test_pallas.py's pairs."""
    base = rng.standard_normal((n + 30, 3)).astype(np.float32) * 0.4
    feat = (rng.random((n + 30, 5)) * np.array([255, 255, 255, 60, 60]))
    feat = feat.astype(np.float32)
    R = np.asarray(se3.exp_so3(np.array([0.01, -0.012, 0.008], np.float32)))
    t = np.array([0.02, -0.01, 0.015], np.float32)
    yp = (base[20:20 + n] @ R.T + t).astype(np.float32)
    x = pad_cloud(base[:n], feat[:n], capacity=cap)
    y = pad_cloud(yp, feat[20:20 + n], capacity=cap)
    return ([np.asarray(a) for a in x], [np.asarray(a) for a in y])


@pytest.mark.parametrize("n,cap", [(200, 256), (470, 512)])
def test_color_gram_plain_matches_pallas(rng, n, cap):
    x, y = _pair(rng, n, cap)
    ref = np.asarray(j_color_gram(*x, *y, p=JP(), interpret=True))
    got = t_color_gram(*map(T, x), *map(T, y), p=TP()).numpy()
    # same fp32 operations; exp_neg differs by at most an ulp of <= 1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # padding rows and columns are exactly zero
    assert not got[n:].any() and not got[:, n:].any()


@pytest.mark.parametrize("use_ck", [True, False])
@pytest.mark.parametrize("use_skip", [False, True])
@pytest.mark.parametrize("ell", [0.15, 0.05])
def test_fused_moments_plain_matches_pallas(rng, use_ck, use_skip, ell):
    n, cap = 470, 512
    (xp, xf, xm), (yp, yf, ym) = _pair(rng, n, cap)
    c0 = xp[:n].mean(0).astype(np.float32)
    xc, yc = xp - c0, yp - c0
    jp = JP(backend="pallas")
    ck = j_color_gram(xp, xf, xm, yp, yf, ym, p=jp, interpret=True)
    md = None
    if use_skip:
        # bounds at the JAX kernel's 256-tiles: the skip is exact at any
        # tile size
        md = aabb_min_d2(*block_bounds(xp, xm, 256), *block_bounds(yp, ym, 256))
    phi = monomial_features_padded(jnp.asarray(xc))
    ref_mom, ref_nnz = j_fused_moments(
        xc, xf, xm, yc, yf, ym, phi, jnp.float32(ell),
        ck if use_ck else None, md, p=jp, interpret=True,
    )
    ref_mom = np.asarray(ref_mom)[:, :35]

    t_md = None
    if use_skip:
        t_md = tcloud.aabb_min_d2(
            *tcloud.block_bounds(T(xp), T(xm), TILE_I),
            *tcloud.block_bounds(T(yp), T(ym), TILE_J),
        )
    mom, nnz = t_fused_moments(
        T(xc), T(xf), T(xm), T(yc), T(yf), T(ym),
        monomial_features(T(xc)), torch.tensor(ell, dtype=torch.float32),
        T(ck) if use_ck else None, t_md, p=TP(),
    )
    assert float(nnz) == float(ref_nnz) > 0
    # A^T Phi summed in another order (tile dot products vs one matmul):
    # 1e-5 of each moment column's magnitude
    scale = np.abs(ref_mom).max(axis=0)
    assert (np.abs(mom.numpy() - ref_mom) <= 1e-5 * scale).all()


def test_fused_moments_skip_is_exact(rng):
    """Tile skip on and off give bit-identical moments."""
    n, cap = 900, 1024
    (xp, xf, xm), (yp, yf, ym) = _pair(rng, n, cap)
    md = tcloud.aabb_min_d2(*tcloud.block_bounds(T(xp), T(xm), TILE_I),
                            *tcloud.block_bounds(T(yp), T(ym), TILE_J))
    args = (T(xp), T(xf), T(xm), T(yp), T(yf), T(ym),
            monomial_features(T(xp)), torch.tensor(0.05))
    p = TP()
    ck = t_color_gram(*args[:6], p=p)
    scal_thres = -2.0 * 0.05 * 0.05 * np.log(p.sp_thres / p.sigma**2)
    assert (md.numpy() > scal_thres + 1e-5).any()   # some tiles do skip
    on = t_fused_moments(*args, ck, md, p=p)
    off = t_fused_moments(*args, ck, None, p=p)
    assert torch.equal(on[0], off[0]) and float(on[1]) == float(off[1])


@pytest.mark.parametrize("tile", [TILE_I, TILE_J, 256])
def test_block_bounds_and_aabb_match_jax(rng, tile):
    pos = rng.standard_normal((512, 3)).astype(np.float32)
    mask = (rng.random(512) > 0.3).astype(np.float32)
    mask[256:384] = 0.0   # an all-invalid tile at every tile size
    lo, hi = block_bounds(jnp.asarray(pos), jnp.asarray(mask), tile)
    tlo, thi = tcloud.block_bounds(T(pos), T(mask), tile)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(hi))
    np.testing.assert_array_equal(
        tcloud.aabb_min_d2(tlo, thi, tlo, thi).numpy(),
        np.asarray(aabb_min_d2(lo, hi, lo, hi)),
    )


def test_wrappers_validate_shapes(rng):
    (xp, xf, xm), (yp, yf, ym) = _pair(rng, 100, 128)
    p = TP()
    with pytest.raises(ValueError):
        t_color_gram(T(xp), T(xf[:, :3]), T(xm), T(yp), T(yf), T(ym), p=p)
    with pytest.raises(ValueError):   # capacity not a multiple of TILE_I
        t_fused_moments(T(xp[:100]), T(xf[:100]), T(xm[:100]), T(yp),
                        T(yf), T(ym), monomial_features(T(xp[:100])),
                        torch.tensor(0.1), p=p)
    with pytest.raises(ValueError):   # bound matrix at the wrong tiles
        md = tcloud.aabb_min_d2(*tcloud.block_bounds(T(xp), T(xm), 128),
                                *tcloud.block_bounds(T(yp), T(ym), 128))
        t_fused_moments(T(xp), T(xf), T(xm), T(yp), T(yf), T(ym),
                        monomial_features(T(xp)), torch.tensor(0.1),
                        None, md, p=p)
