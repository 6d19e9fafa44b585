"""The CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  On the
card, run them without the JAX test configuration:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cvo_rgbd_torch.ops import _build

    _build.build()
    return torch.device("cuda")


def _clouds(dev, n=1000, cap=1024, seed=0):
    from cvo_rgbd_torch import pad_cloud
    from cvo_rgbd_torch.core.cloud import kd_sort

    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)) * np.array([2.0, 1.5, 1.0]) + np.array(
        [-1.0, -0.7, 1.0])
    feat = rng.random((n, 5)) * np.array([255, 255, 255, 60, 60])
    y = pos + rng.normal(0.0, 0.01, pos.shape)
    x = kd_sort(pad_cloud(pos, feat, cap, device=dev))
    y = kd_sort(pad_cloud(y, feat, cap, device=dev))
    return x, y


def test_color_gram_kernel_matches_plain(dev):
    from cvo_rgbd_torch.ops import gram
    from cvo_rgbd_torch.params import CvoParams

    x, y = _clouds(dev)
    p = CvoParams()
    launches = gram.color_gram.launches
    ck = gram.color_gram(*x, *y, p=p)
    assert gram.color_gram.launches == launches + 1
    scal = gram.scalars(torch.full((), p.ell_init, device=dev), p)
    ref = gram.color_gram_plain(x.features, x.mask, y.features, y.mask, scal)
    # same fp32 operations; FMA contraction in the kernel: one ulp of <= 1
    assert (ck - ref).abs().max().item() <= 1e-6


@pytest.mark.parametrize("use_ck", [True, False])
@pytest.mark.parametrize("ell", [0.15, 0.03])
def test_fused_moments_kernel_matches_plain(dev, use_ck, ell):
    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import gram, moments
    from cvo_rgbd_torch.params import CvoParams

    x, y = _clouds(dev)
    p = CvoParams()
    ck = gram.color_gram(*x, *y, p=p) if use_ck else None
    c0, xc, phi = build_moments_pre(x)
    yc = y.positions - c0
    md = aabb_min_d2(*block_bounds(x.positions, x.mask, moments.TILE_I),
                     *block_bounds(y.positions, y.mask, moments.TILE_J))
    ell_t = torch.full((), ell, device=dev)
    scal = gram.scalars(ell_t, p)
    ref, ref_nnz = moments.fused_moments_plain(
        xc, x.features, x.mask, yc, y.features, y.mask, phi, scal, ck, None)
    out = {}
    for skip in (None, md):
        mom, nnz = moments.fused_moments(xc, x.features, x.mask, yc,
                                         y.features, y.mask, phi, ell_t, ck,
                                         skip, p=p)
        out[skip is None] = (mom, float(nnz))
        # FMA contraction can flip a gate at its edge: 1e-4 of each
        # moment column's magnitude, nnz within 1e-4
        scale = ref.abs().amax(dim=0).clamp_min(1e-30)
        assert ((mom - ref).abs() / scale).max().item() <= 1e-4
        assert abs(float(nnz) - float(ref_nnz)) <= 1e-4 * float(ref_nnz)
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]


def test_align_on_card_matches_cpu(dev):
    import cvo_rgbd_torch as ct

    x, y = _clouds(dev, n=500, cap=512, seed=1)
    p = ct.CvoParams(max_iter=40)
    gpu = ct.align(p, x, y)
    cpu = ct.align(p, x.to("cpu"), y.to("cpu"), device="cpu")
    # the JAX suite's stop-skew tolerance (tests/test_parallel.py:217)
    assert (gpu.tf.cpu() - cpu.tf).abs().max().item() <= 3e-4


def _rendered_pair(dev, num_want=512):
    """The acvo frontend's clouds of the first rendered pair, on `dev`."""
    from cvo_rgbd_torch import synth
    from cvo_rgbd_torch.frontend import make_frontend

    fe = make_frontend(1, num_want, 0, device=str(dev))
    frames = synth.render_frames(synth.revisit_path(2, period=33),
                                 synth.BandScene(h=96, w=128))
    return [fe(f[2], f[3]) for f in frames]


@pytest.mark.parametrize("use_ck", [True, False])
@pytest.mark.parametrize("ell", [0.1, 0.0391])
def test_fused_wsq_kernel_matches_plain(dev, use_ck, ell):
    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds, kd_sort
    from cvo_rgbd_torch.ops import gram, wsq
    from cvo_rgbd_torch.params import AcvoParams

    p = AcvoParams()
    for x in map(kd_sort, _rendered_pair(dev)):
        ck = gram.color_gram(*x, *x, p=p) if use_ck else None
        lo, hi = block_bounds(x.positions, x.mask, wsq.TILE_W)
        md = aabb_min_d2(lo, hi, lo, hi)
        ell_t = torch.full((), ell, device=dev)
        ref_w, ref_n = wsq.fused_wsq_plain(*x, *x, gram.scalars(ell_t, p), ck)
        out = {}
        for sym in (False, True):
            for skip in (None, md):
                launches = wsq.fused_wsq.launches
                w, n = wsq.fused_wsq(*x, *x, ell_t, ck, skip, p=p,
                                     symmetric=sym)
                assert wsq.fused_wsq.launches == launches + 1
                out[sym, skip is None] = (float(w), float(n))
                # one fp32 sum in another order: 1e-4 relative; the
                # gates agree pair by pair
                assert abs(float(w) - float(ref_w)) <= 1e-4 * float(ref_w)
                assert float(n) == float(ref_n) > 0
        for sym in (False, True):   # the skip drops only zero tiles
            assert out[sym, True] == out[sym, False]


def test_acvo_align_on_card_matches_cpu(dev):
    import cvo_rgbd_torch as ct

    x, y = _rendered_pair(dev)
    p = ct.AcvoParams(eps=5e-4, eps_2=1e-4)
    gpu = ct.align(p, x, y)
    cpu = ct.align(p, x.to("cpu"), y.to("cpu"), device="cpu")
    assert bool(gpu.converged) and bool(cpu.converged)
    # the JAX suite's stop-skew tolerance (tests/test_parallel.py:217)
    assert (gpu.tf.cpu() - cpu.tf).abs().max().item() <= 3e-4
