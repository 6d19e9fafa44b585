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


def _rendered_pair(dev, num_want=512, size=(96, 128)):
    """The acvo frontend's clouds of the first rendered pair, on `dev`."""
    from cvo_rgbd_torch import synth
    from cvo_rgbd_torch.frontend import make_frontend

    fe = make_frontend(1, num_want, 0, device=str(dev))
    frames = synth.render_frames(synth.revisit_path(2, period=33),
                                 synth.BandScene(*size))
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


def _fused_pair(dev, algo, mode):
    """A pair the fused backend runs in `mode`: random clouds for cvo,
    the rendered acvo pair (whose self-Grams have neighbours) for acvo."""
    from cvo_rgbd_torch.core.cloud import kd_sort

    cap = 1024 if mode == "resident" else 1152
    if algo == "cvo":
        return _clouds(dev, n=cap - 24, cap=cap, seed=2)
    return [kd_sort(c) for c in _rendered_pair(dev, num_want=cap)]


@pytest.mark.parametrize("max_iter", [1, 3, 10])
@pytest.mark.parametrize("mode", ["resident", "tiled"])
@pytest.mark.parametrize("algo", ["cvo", "acvo"])
def test_align_fused_kernel_matches_plain(dev, algo, mode, max_iter):
    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused,
        align_fused_cuda,
        align_fused_plain,
        fused_mode,
    )

    x, y = _fused_pair(dev, algo, mode)
    cls = ct.CvoParams if algo == "cvo" else ct.AcvoParams
    p = cls(backend="fused", max_iter=max_iter, eps=0.0, eps_2=0.0)
    assert fused_mode(p, x, y) == mode
    launches = align_fused.launches
    row = align_fused_cuda(p, x, y)
    assert align_fused.launches == launches + 1
    ref = align_fused_plain(p, x, y)
    assert row[24].item() == ref[24].item() == max_iter
    # R, T, ell, omega, v: fp32 sums in another order, 1e-5 after 1 and 3
    # iterations and 1e-4 after 10 (tests/test_torch_fused.py)
    tol = 1e-5 if max_iter <= 3 else 1e-4
    assert (row[12:] - ref[12:]).abs().max().item() <= tol


@pytest.mark.parametrize("mode", ["resident", "tiled"])
@pytest.mark.parametrize("algo", ["cvo", "acvo"])
def test_fused_degenerate_pairs_on_card(dev, algo, mode):
    """Self-registration stops at iteration 0 with tf == I; an all-masked
    moving cloud converges at iteration 0 with a finite tf."""
    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.ops.align_fused import fused_mode

    x, _ = _fused_pair(dev, algo, mode)
    p = (ct.CvoParams if algo == "cvo" else ct.AcvoParams)(backend="fused")
    assert fused_mode(p, x, x) == mode
    res = ct.align(p, x, x)
    assert int(res.iterations) == 0 and bool(res.converged)
    assert torch.equal(res.tf.cpu(), torch.eye(4))
    empty = ct.pad_cloud(np.zeros((0, 3)), capacity=x.capacity, device=dev)
    res = ct.align(p, x, empty)
    assert int(res.iterations) == 0 and bool(res.converged)
    assert torch.isfinite(res.tf).all()


@pytest.mark.parametrize("mode", ["resident", "tiled"])
def test_align_fused_long_ell_schedule(dev, mode):
    """A six-step cvo schedule reaches the kernel whole: ell moves at the
    same iterations as in the plain version."""
    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_cuda,
        align_fused_plain,
    )

    x, y = _fused_pair(dev, "cvo", mode)
    sched = ((0, 0.12), (1, 0.10), (2, 0.08), (4, 0.06), (6, 0.05),
             (8, 0.04))
    p = ct.CvoParams(backend="fused", ell_sched=sched, max_iter=10, eps=0.0,
                     eps_2=0.0)
    row = align_fused_cuda(p, x, y)
    ref = align_fused_plain(p, x, y)
    assert row[24].item() == ref[24].item() == 10
    assert row[26].item() == ref[26].item() == np.float32(0.04)
    assert (row[12:] - ref[12:]).abs().max().item() <= 1e-4


@pytest.mark.parametrize("mode,n,m", [("resident", 512, 1024),
                                      ("tiled", 2048, 1152)])
@pytest.mark.parametrize("algo", ["cvo", "acvo"])
def test_align_fused_unequal_clouds(dev, algo, mode, n, m):
    """Fixed and moving clouds of different capacities: every work split
    of the kernel (row blocks, moment items, columns, both self
    triangles) sizes itself from its own cloud."""
    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_cuda,
        align_fused_plain,
        fused_mode,
    )

    rng = np.random.default_rng(4)
    k = max(n, m)
    pos = rng.random((k, 3)) * np.array([2.0, 1.5, 1.0]) + np.array(
        [-1.0, -0.7, 1.0])
    feat = rng.random((k, 5)) * np.array([255, 255, 255, 60, 60])
    moved = pos + rng.normal(0.0, 0.01, pos.shape)
    x = kd_sort(ct.pad_cloud(pos[:n - 24], feat[:n - 24], n, device=dev))
    y = kd_sort(ct.pad_cloud(moved[:m - 24], feat[:m - 24], m, device=dev))
    cls = ct.CvoParams if algo == "cvo" else ct.AcvoParams
    p = cls(backend="fused", max_iter=3, eps=0.0, eps_2=0.0)
    assert fused_mode(p, x, y) == mode
    row = align_fused_cuda(p, x, y)
    ref = align_fused_plain(p, x, y)
    assert row[24].item() == ref[24].item() == 3
    assert (row[12:] - ref[12:]).abs().max().item() <= 1e-5


def test_align_fused_pads_a_resident_fixed_cloud(dev):
    """A hand-built fixed cloud of capacity 1000 (a multiple of 8 only)
    runs resident; the kernel pads it to whole row blocks with masked
    rows, which must change nothing."""
    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_cuda,
        align_fused_plain,
        fused_mode,
    )

    x, y = _clouds(dev, n=1000, cap=1024, seed=3)
    x = ct.PointCloud(*(t[:1000] for t in x))
    p = ct.CvoParams(backend="fused", max_iter=3, eps=0.0, eps_2=0.0)
    assert fused_mode(p, x, y) == "resident"
    row = align_fused_cuda(p, x, y)
    ref = align_fused_plain(p, x, y)
    assert row[24].item() == ref[24].item() == 3
    assert (row[12:] - ref[12:]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("mode", ["resident", "tiled"])
@pytest.mark.parametrize("algo", ["cvo", "acvo"])
def test_fused_align_on_card_matches_cpu(dev, algo, mode):
    import cvo_rgbd_torch as ct

    x, y = _fused_pair(dev, algo, mode)
    p = (ct.CvoParams if algo == "cvo" else ct.AcvoParams)(backend="fused")
    gpu = ct.align(p, x, y)
    again = ct.align(p, x, y)
    cpu = ct.align(p, x.to("cpu"), y.to("cpu"), device="cpu")
    assert bool(gpu.converged) and bool(cpu.converged)
    # no float atomics: the same align repeats bit for bit
    assert torch.equal(gpu.tf, again.tf)
    assert int(gpu.iterations) == int(again.iterations)
    # the JAX suite's stop-skew tolerance (tests/test_parallel.py:217); at
    # the C++ stops the last iterations contract slowly, so the stopping
    # iteration moves with the fp32 summation order
    assert (gpu.tf.cpu() - cpu.tf).abs().max().item() <= 3e-4
    it_g, it_c = int(gpu.iterations), int(cpu.iterations)
    assert abs(it_g - it_c) <= max(2, 0.25 * it_c)


def _linear_clouds(dev, n=1000, cap=1024, seed=5):
    """A kd-sorted pair with 3 color features (MATLAB's linear mode) and
    the pair's masked ci, as the kernel backend builds it."""
    from cvo_rgbd_torch import pad_cloud
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.core.registration import prepare_ci
    from cvo_rgbd_torch.params import MATLAB_PARAMS

    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)) * np.array([2.0, 1.5, 1.0]) + np.array(
        [-1.0, -0.7, 1.0])
    col = rng.random((n, 3)) * 255.0
    y = pos + rng.normal(0.0, 0.01, pos.shape)
    x = kd_sort(pad_cloud(pos, col, cap, device=dev))
    y = kd_sort(pad_cloud(y, col, cap, device=dev))
    return x, y, prepare_ci(MATLAB_PARAMS, x, y)


def _padded(cloud):
    """The cloud's features zero-padded to the kernels' 5 planes, as
    `align` pads them."""
    from cvo_rgbd_torch.ops.gram import pad_feat

    return cloud._replace(features=pad_feat(cloud.features))


def _flow_inputs(dev, mode):
    """(fixed, moving, ck, params) of a sweep in `mode`."""
    from cvo_rgbd_torch.ops import gram
    from cvo_rgbd_torch.params import MATLAB_PARAMS, CvoParams

    if mode == "linear":
        x, y, ci = _linear_clouds(dev)
        return _padded(x), _padded(y), ci, MATLAB_PARAMS
    x, y = _clouds(dev)
    p = CvoParams()
    return x, y, gram.color_gram(*x, *y, p=p) if mode == "se_ck" else None, p


def _close(got, ref, tol=1e-4):
    """|got - ref| within tol of |ref| (the norm for a vector)."""
    return (got - ref).norm().item() <= tol * ref.norm().item()


@pytest.mark.parametrize("ell", [0.1, 0.03])
@pytest.mark.parametrize("mode", ["se", "se_ck", "linear"])
def test_fused_flow_kernel_matches_plain(dev, mode, ell):
    from cvo_rgbd_torch.ops import flow, gram

    x, y, ck, p = _flow_inputs(dev, mode)
    scal = gram.scalars(torch.full((), ell, device=dev), p)
    args = (*x, *y, scal, ck, mode == "linear")
    launches = flow.fused_flow.launches
    out = flow.fused_flow_cuda(*args)
    assert flow.fused_flow.launches == launches + 1
    ref = flow.fused_flow_plain(*args)
    # fp32 sums in another order: omega*c, v*d, sum A d2 and sum A within
    # 1e-4 of their magnitude; the gates agree pair by pair
    assert out[8].item() == ref[8].item() > 0
    for sl in (slice(0, 3), slice(3, 6), slice(6, 7), slice(7, 8)):
        assert _close(out[sl], ref[sl]), (sl, out, ref)


@pytest.mark.parametrize("ell", [0.1, 0.03])
@pytest.mark.parametrize("mode", ["se", "se_ck", "linear"])
def test_fused_step_coeffs_kernel_matches_plain(dev, mode, ell):
    from cvo_rgbd_torch.ops import flow, gram

    x, y, ck, p = _flow_inputs(dev, mode)
    ell_t = torch.full((), ell, device=dev)
    om, v, *_ = flow.fused_flow(*x, *y, ell_t, ck, p=p)
    scal = gram.scalars(ell_t, p)
    wv = torch.cat([om, v])
    args = (*x, *y, scal, wv, ck, mode == "linear")
    launches = flow.fused_step_coeffs.launches
    out = flow.fused_step_coeffs_cuda(*args)
    assert flow.fused_step_coeffs.launches == launches + 1
    ref = flow.fused_step_coeffs_plain(*args)
    for q in range(4):   # B, C, D, E: one fp32 sum in another order
        assert _close(out[q], ref[q]), (q, out, ref)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _sweeps(x, y, ck, p, ell, skip):
    """(fused_flow row, [B, C, D, E]) of the two kernels with the tile
    skip on or off, the step at the plain flow's omega and v."""
    from cvo_rgbd_torch.ops import flow, gram

    scal = gram.scalars(torch.full((), ell, device=x.positions.device), p)
    linear = p.color_mode == "linear"
    ref = flow.fused_flow_plain(*x, *y, scal, ck, linear)
    wv = torch.cat([ref[0:3] / p.c, ref[3:6] / p.d])
    return (flow.fused_flow_cuda(*x, *y, scal, ck, linear, skip=skip),
            flow.fused_step_coeffs_cuda(*x, *y, scal, wv, ck, linear,
                                        skip=skip))


@pytest.mark.parametrize("ell", [0.1, 0.03])
@pytest.mark.parametrize("mode", ["se", "se_ck", "linear"])
def test_flow_sweeps_skip_on_and_off_and_reruns_give_the_same_bits(
        dev, mode, ell):
    """The in-kernel tile skip is exact, and the ticket reduction sums in
    a fixed order: skip on, skip off and a second run, the same bits."""
    from cvo_rgbd_torch.ops import flow, gram

    x, y, ck, p = _flow_inputs(dev, mode)
    keep = flow.tile_keep(x.positions, x.mask, y.positions, y.mask,
                          gram.scalars(torch.full((), ell, device=dev), p))
    assert 0 < int(keep.sum()) < keep.numel()
    on, off, again = (_sweeps(x, y, ck, p, ell, skip)
                      for skip in (True, False, True))
    for a, b, c in zip(on, off, again):
        assert torch.equal(_bits(a), _bits(b)), (a, b)
        assert torch.equal(_bits(a), _bits(c)), (a, c)


def _one_launch_window(fn):
    """(launches, device kernel names) of one torch.profiler window
    around fn.  The profiler itself drops a one-kernel window's kernel
    record now and then: its launch is recorded, its results hold no
    device event at all (`time_fused.py --profiler` on the card: 18 of
    1200 windows with the launch right after the profiler starts, 2 of
    1200 with it 2 ms later, whatever the margins of the kernel to the
    window's ends).  So the launch waits PROFILER_LEAD_S inside the
    window, and a window that lost its only kernel record that way is
    opened again, at most PROFILER_WINDOWS times."""
    import time

    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_LEAD_S)
            fn()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        launches = sum(e.count for e in prof.key_averages()
                       if e.key.startswith("cudaLaunch"))
        if not (launches == 1 and not kernels):
            break
    return launches, kernels


PROFILER_LEAD_S = 0.002
PROFILER_WINDOWS = 3


@pytest.mark.parametrize("mode", ["se", "se_ck", "linear"])
def test_flow_sweeps_are_one_launch_a_call(dev, mode):
    """Each call is one kernel launch: the reduction is in the sweep."""
    from cvo_rgbd_torch.ops import flow, gram

    x, y, ck, p = _flow_inputs(dev, mode)
    scal = gram.scalars(torch.full((), 0.1, device=dev), p)
    wv = torch.zeros(6, device=dev)
    linear = mode == "linear"
    for fn, tag in (
            (lambda: flow.fused_flow_cuda(*x, *y, scal, ck, linear),
             "flow_kernel"),
            (lambda: flow.fused_step_coeffs_cuda(*x, *y, scal, wv, ck,
                                                 linear), "step_kernel")):
        fn()
        torch.cuda.synchronize()
        launches, kernels = _one_launch_window(fn)
        assert launches == 1 and len(kernels) == 1, (launches, kernels)
        assert tag in kernels[0]


@pytest.mark.parametrize("mode", ["se", "se_ck", "linear"])
@pytest.mark.parametrize("n,m", [(1024, 512), (512, 1152)])
def test_flow_sweeps_unequal_clouds_with_an_invalid_tile(dev, mode, n, m):
    """N != M, a fixed row block and a moving column tile all invalid
    (positions kept, masks 0, the cache built after): every output against
    the plain version, the skip exact and dropping those tiles."""
    from cvo_rgbd_torch.core.registration import prepare_ci
    from cvo_rgbd_torch.ops import flow, gram
    from cvo_rgbd_torch.params import MATLAB_PARAMS, CvoParams

    x, _ = _clouds(dev, n=n - 24, cap=n, seed=2)
    _, y = _clouds(dev, n=m - 24, cap=m, seed=2)
    xm, ym = x.mask.clone(), y.mask.clone()
    xm[flow.ROWS:2 * flow.ROWS] = 0.0
    ym[flow.TILE_J:2 * flow.TILE_J] = 0.0
    x, y = x._replace(mask=xm), y._replace(mask=ym)
    if mode == "linear":
        p = MATLAB_PARAMS
        ck = prepare_ci(p, *(c._replace(features=c.features[:, :3])
                             for c in (x, y)))
    else:
        p = CvoParams()
        ck = gram.color_gram(*x, *y, p=p) if mode == "se_ck" else None
    scal = gram.scalars(torch.full((), 0.1, device=dev), p)
    keep = flow.tile_keep(x.positions, x.mask, y.positions, y.mask, scal)
    assert not keep[1].any() and not keep[:, 1].any() and keep.any()
    on, off = (_sweeps(x, y, ck, p, 0.1, skip) for skip in (True, False))
    linear = mode == "linear"
    ref = flow.fused_flow_plain(*x, *y, scal, ck, linear)
    wv = torch.cat([ref[0:3] / p.c, ref[3:6] / p.d])
    ref_s = flow.fused_step_coeffs_plain(*x, *y, scal, wv, ck, linear)
    assert on[0][8].item() == ref[8].item() > 0
    for sl in (slice(0, 3), slice(3, 6), slice(6, 7), slice(7, 8)):
        assert _close(on[0][sl], ref[sl]), (sl, on[0], ref)
    for q in range(4):
        assert _close(on[1][q], ref_s[q]), (q, on[1], ref_s)
    for a, b in zip(on, off):
        assert torch.equal(_bits(a), _bits(b)), (a, b)


@pytest.mark.parametrize("ell", [0.15, 0.03])
def test_fused_moments_linear_kernel_matches_plain(dev, ell):
    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import gram, moments
    from cvo_rgbd_torch.params import MATLAB_PARAMS

    x, y, ci = _linear_clouds(dev)
    x, y = _padded(x), _padded(y)
    c0, xc, phi = build_moments_pre(x)
    yc = y.positions - c0
    md = aabb_min_d2(*block_bounds(x.positions, x.mask, moments.TILE_I),
                     *block_bounds(y.positions, y.mask, moments.TILE_J))
    ell_t = torch.full((), ell, device=dev)
    ref, ref_nnz = moments.fused_moments_plain(
        xc, x.features, x.mask, yc, y.features, y.mask, phi,
        gram.scalars(ell_t, MATLAB_PARAMS), ci, None, True)
    out = {}
    for skip in (None, md):
        mom, nnz = moments.fused_moments(xc, x.features, x.mask, yc,
                                         y.features, y.mask, phi, ell_t, ci,
                                         skip, p=MATLAB_PARAMS)
        out[skip is None] = (mom, float(nnz))
        scale = ref.abs().amax(dim=0).clamp_min(1e-30)
        assert ((mom - ref).abs() / scale).max().item() <= 1e-4
        assert float(nnz) == float(ref_nnz) > 0
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]


@pytest.mark.parametrize("max_iter", [1, 3, 10])
@pytest.mark.parametrize("mode,cap", [("resident", 1024), ("tiled", 1152)])
def test_align_fused_linear_kernel_matches_plain(dev, mode, cap, max_iter):
    import dataclasses

    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_cuda,
        align_fused_plain,
        fused_mode,
    )

    x, y, _ = _linear_clouds(dev, n=cap - 24, cap=cap, seed=6)
    p = dataclasses.replace(ct.MATLAB_PARAMS, backend="fused",
                            max_iter=max_iter, eps=0.0, eps_2=0.0)
    assert fused_mode(p, x, y) == mode
    x, y = _padded(x), _padded(y)
    row = align_fused_cuda(p, x, y)
    ref = align_fused_plain(p, x, y)
    assert row[24].item() == ref[24].item() == max_iter
    tol = 1e-5 if max_iter <= 3 else 1e-4
    assert (row[12:] - ref[12:]).abs().max().item() <= tol


@pytest.mark.parametrize("backend,step_mode", [
    ("kernel", "factored"), ("kernel", "direct"), ("dense", "factored"),
    ("fused", "factored")])
def test_matlab_align_on_card_matches_cpu(dev, backend, step_mode):
    import dataclasses

    import cvo_rgbd_torch as ct

    x, y, _ = _linear_clouds(dev, n=500, cap=512, seed=7)
    p = dataclasses.replace(ct.MATLAB_PARAMS, backend=backend,
                            step_mode=step_mode)
    gpu = ct.align(p, x, y)
    cpu = ct.align(p, x.to("cpu"), y.to("cpu"), device="cpu")
    assert bool(gpu.converged) and bool(cpu.converged)
    # the JAX suite's stop-skew tolerance (tests/test_parallel.py:217)
    assert (gpu.tf.cpu() - cpu.tf).abs().max().item() <= 3e-4


_PROBES = ("a", "b", "b2", "c", "d", "e", "h", "i", "j", "k")


@pytest.mark.parametrize("case,form", [
    (c, f) for c in _PROBES for f in ("scripts", "seed0", "seed1")]
    + [("d", "guard_off"), ("e", "guard_off")])
def test_construct_probe_kernel_matches_plain(dev, case, form):
    """On the scripts' inputs every case but e gives its plain version's
    bits and its closed form; on seeded inputs (and with the guard of d
    and e off) a, b, b2, c, d and k give the plain version's bits, e, h,
    i and j lie within `probes.tolerance` of it."""
    from cvo_rgbd_torch import probes

    if form == "scripts":
        ins = probes.inputs(case, dev)
    else:
        seed = {"seed0": 0, "seed1": 1, "guard_off": 0}[form]
        guard = probes.GUARD_OFF if form == "guard_off" else 0.0
        ins = probes.seeded_inputs(case, dev, seed, guard)
    launches = probes.construct_probe.launches
    got = probes.construct_probe(case, *ins)
    assert probes.construct_probe.launches == launches + 1
    ref = probes.construct_probe_plain(case, *ins)
    if form == "scripts" and case == "e":
        # fp32 sums of 256 products in another order
        assert (got - ref).abs().max().item() <= 1e-6 * probes.CLOSED["e"]
    elif form == "scripts" or case in probes.EXACT:
        assert torch.equal(got, ref)
    else:
        assert probes.within_tolerance(case, got, ref, ins)
    if form == "scripts":
        assert probes.closed_form_ok(case, got[0, 0].item())
    if form == "guard_off":
        assert not got.any()


@pytest.mark.parametrize("case", ["f", "g", "g2_x2_y1", "g3_x1_y2"])
def test_probe_tiled_align_matches_plain(dev, case):
    from cvo_rgbd_torch import probes
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_cuda,
        align_fused_plain,
    )

    p, x, y = probes.tiled_problem(case, dev)
    row = align_fused_cuda(p, x, y, mode="tiled")
    ref = align_fused_plain(p, x, y, mode="tiled")
    assert row[24].item() == ref[24].item()
    assert (row[:12] - ref[:12]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("mode,cap", [("resident", 256), ("tiled", 1152)])
@pytest.mark.parametrize("algo", ["cvo", "acvo"])
def test_align_fused_batched_lanes_are_single_launches(dev, algo, mode, cap):
    """One launch for the batch; each lane the bits of its pair's
    single-pair launch, a retired (empty) lane and ragged clouds
    included."""
    from cvo_rgbd_torch import pad_cloud
    from cvo_rgbd_torch.core.cloud import kd_sort, stack_clouds
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused,
        align_fused_batched_cuda,
        align_fused_cuda,
        fused_mode,
    )
    from cvo_rgbd_torch.params import AcvoParams, CvoParams

    cls = CvoParams if algo == "cvo" else AcvoParams
    p = cls(backend="fused", eps=5e-4, eps_2=1e-4, max_iter=60)

    def pair(k):
        # a shifted copy of a compact cloud: every lane iterates
        rng = np.random.default_rng(k)
        n = cap - 100 * k
        pos = rng.standard_normal((n + 30, 3)) * 0.4
        feat = rng.random((n + 30, 5)) * np.array([255, 255, 255, 60, 60])
        y = pos[20:20 + n] + np.array([0.02, -0.01, 0.015])
        return (kd_sort(pad_cloud(pos[:n], feat[:n], cap, device=dev)),
                kd_sort(pad_cloud(y, feat[20:20 + n], cap, device=dev)))

    pairs = [pair(k) for k in range(3)]
    pairs.append((pairs[0][0], pad_cloud(np.zeros((0, 3)), capacity=cap,
                                         device=dev)))
    fb = stack_clouds([x for x, _ in pairs])
    mb = stack_clouds([y for _, y in pairs])
    assert fused_mode(p, fb, mb) == mode
    launches = align_fused.launches
    rows = align_fused_batched_cuda(p, fb, mb)
    assert align_fused.launches == launches + 1
    for k, (x, y) in enumerate(pairs):
        assert torch.equal(rows[k], align_fused_cuda(p, x, y)), k
    assert rows[3, 24].item() == 1 and rows[:3, 24].gt(1).all()


@pytest.mark.parametrize("mode", ["se", "se_ck", "linear"])
@pytest.mark.parametrize("n,m", [(1024, 512), (512, 1152)])
def test_fused_moments_unequal_clouds(dev, mode, n, m):
    """N != M: the tile grid is n / 64 by m / 128, each tile its own
    item; every mode against its plain version, the skip exact."""
    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import gram, moments
    from cvo_rgbd_torch.params import MATLAB_PARAMS, CvoParams

    x, _ = _clouds(dev, n=n - 24, cap=n, seed=2)
    _, y = _clouds(dev, n=m - 24, cap=m, seed=2)
    if mode == "linear":
        from cvo_rgbd_torch.core.registration import prepare_ci

        p = MATLAB_PARAMS
        x3, y3 = (c._replace(features=c.features[:, :3]) for c in (x, y))
        ck = prepare_ci(p, x3, y3)
    else:
        p = CvoParams()
        ck = gram.color_gram(*x, *y, p=p) if mode == "se_ck" else None
    c0, xc, phi = build_moments_pre(x)
    yc = y.positions - c0
    md = aabb_min_d2(*block_bounds(x.positions, x.mask, moments.TILE_I),
                     *block_bounds(y.positions, y.mask, moments.TILE_J))
    ell_t = torch.full((), 0.1, device=dev)
    linear = mode == "linear"
    ref, ref_nnz = moments.fused_moments_plain(
        xc, x.features, x.mask, yc, y.features, y.mask, phi,
        gram.scalars(ell_t, p), ck, None, linear)
    got = [moments.fused_moments(xc, x.features, x.mask, yc, y.features,
                                 y.mask, phi, ell_t, ck, skip, p=p)
           for skip in (None, md)]
    scale = ref.abs().amax(dim=0).clamp_min(1e-30)
    for mom, nnz in got:
        assert mom.shape == (m, 35)
        assert ((mom - ref).abs() / scale).max().item() <= 1e-4
        assert abs(float(nnz) - float(ref_nnz)) <= 1e-4 * float(ref_nnz)
    assert torch.equal(got[0][0], got[1][0])


@pytest.mark.parametrize("which", ["every tile skipped", "none skipped"])
def test_fused_moments_skip_extremes(dev, which):
    """Bounds that drop every tile give zero moments and count; bounds
    that keep every tile give the bits of no skip at all."""
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import gram, moments
    from cvo_rgbd_torch.params import CvoParams

    x, y = _clouds(dev)
    p = CvoParams()
    ck = gram.color_gram(*x, *y, p=p)
    c0, xc, phi = build_moments_pre(x)
    yc = y.positions - c0
    shape = (x.capacity // moments.TILE_I, y.capacity // moments.TILE_J)
    md = torch.full(shape, float("inf") if which == "every tile skipped"
                    else 0.0, device=dev)
    ell_t = torch.full((), 0.1, device=dev)
    args = (xc, x.features, x.mask, yc, y.features, y.mask, phi, ell_t, ck)
    mom, nnz = moments.fused_moments(*args, md, p=p)
    if which == "every tile skipped":
        assert not mom.any() and float(nnz) == 0.0
    else:
        ref, ref_nnz = moments.fused_moments(*args, None, p=p)
        assert float(ref_nnz) > 0
        assert torch.equal(mom, ref) and float(nnz) == float(ref_nnz)


def _lane_pairs(dev, case):
    """(params, three kd-sorted pairs) of a lane-bits case: linear pairs
    tiled at 1152 or resident at 384, or se pairs resident at 1024."""
    import dataclasses

    import cvo_rgbd_torch as ct

    if case == "resident se 1024":
        p = ct.CvoParams()
        pairs = [_clouds(dev, n=1000, cap=1024, seed=s) for s in (6, 7, 8)]
    else:
        p = ct.MATLAB_PARAMS
        n, cap = (1100, 1152) if case == "tiled linear 1152" else (360, 384)
        pairs = [_linear_clouds(dev, n=n, cap=cap, seed=s)[:2]
                 for s in (6, 7, 8)]
        pairs = [(_padded(x), _padded(y)) for x, y in pairs]
    return dataclasses.replace(p, backend="fused", max_iter=12, eps=0.0,
                               eps_2=0.0), pairs


@pytest.mark.parametrize("lanes", [1, 9, 63])
@pytest.mark.parametrize("case", ["tiled linear 1152", "resident linear 384",
                                  "resident se 1024"])
def test_align_fused_lane_bits_at_any_lane_count(dev, case, lanes):
    """A batch of `lanes` copies of three pairs: every lane the bits of
    its pair's one-pair launch."""
    from cvo_rgbd_torch.core.cloud import stack_clouds
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_batched_cuda,
        align_fused_cuda,
        fused_mode,
    )

    p, pairs = _lane_pairs(dev, case)
    assert fused_mode(p, *pairs[0]) == case.split()[0]
    order = [k % 3 for k in range(lanes)]
    rows = align_fused_batched_cuda(
        p, *(stack_clouds([pairs[k][side] for k in order]) for side in (0, 1)))
    single = [align_fused_cuda(p, x, y) for x, y in pairs]
    for lane, k in enumerate(order):
        assert torch.equal(rows[lane], single[k]), lane


def _resident_pair(dev, algo):
    """A resident pair for cvo (random clouds), acvo (the rendered acvo
    pair) or linear (random colored clouds, 5 planes), kd-sorted, and
    its params."""
    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.core.cloud import kd_sort

    if algo == "cvo":
        return ct.CvoParams(), _clouds(dev, n=1000, cap=1024, seed=2)
    if algo == "acvo":
        return ct.AcvoParams(), [kd_sort(c) for c in
                                 _rendered_pair(dev, num_want=1024)]
    x, y, _ = _linear_clouds(dev, n=360, cap=384, seed=9)
    return ct.MATLAB_PARAMS, (_padded(x), _padded(y))


@pytest.mark.parametrize("exp_mode", ["precise", "fast"])
@pytest.mark.parametrize("algo", ["cvo", "acvo", "linear"])
def test_resident_skip_on_and_off_give_the_same_rows(dev, algo, exp_mode):
    """The resident kernel with the tile skip on and off after 1, 3 and
    10 iterations: the same result rows, bit for bit."""
    import dataclasses

    from cvo_rgbd_torch.ops.align_fused import align_fused_cuda, fused_mode

    base, (x, y) = _resident_pair(dev, algo)
    for it in (1, 3, 10):
        rows = []
        for skip in (True, False):
            p = dataclasses.replace(base, backend="fused", max_iter=it,
                                    eps=0.0, eps_2=0.0, tile_skip=skip,
                                    exp_mode=exp_mode)
            assert fused_mode(p, x, y) == "resident"
            rows.append(align_fused_cuda(p, x, y))
        assert torch.equal(rows[0], rows[1]), it


@pytest.mark.parametrize("algo", ["cvo", "acvo", "linear"])
def test_resident_align_after_another_pair_gives_its_solo_bits(dev, algo):
    """The resident scratch (the stored weights, the row-block tickets)
    holds nothing from the launch before: a pair aligned right after a
    different pair, of the same shape, gives the bits it gave alone."""
    import dataclasses

    from cvo_rgbd_torch.ops.align_fused import align_fused_cuda

    base, (x, y) = _resident_pair(dev, algo)
    p = dataclasses.replace(base, backend="fused", max_iter=10, eps=0.0,
                            eps_2=0.0)
    solo = align_fused_cuda(p, x, y).clone()
    torch.cuda.synchronize()
    # another pair of the same capacities: the moving cloud shifted
    other = y._replace(positions=y.positions + 0.05)
    align_fused_cuda(p, y, other)
    assert torch.equal(align_fused_cuda(p, x, y), solo)


@pytest.mark.parametrize("mode", ["resident", "tiled"])
@pytest.mark.parametrize("algo", ["cvo", "acvo"])
def test_timer_build_gives_the_main_build_row(dev, algo, mode):
    """The timing tool's build (per-phase timers compiled in) returns the
    main library's result row bit for bit, and its timers count the
    iterations it ran."""
    import importlib

    from cvo_rgbd_torch.params import AcvoParams, CvoParams

    af = importlib.import_module("cvo_rgbd_torch.ops.align_fused")
    cap = 256 if mode == "resident" else 1152
    x, y = _clouds(dev, n=cap - 24, cap=cap, seed=3)
    cls = CvoParams if algo == "cvo" else AcvoParams
    p = cls(backend="fused", max_iter=7, eps=0.0, eps_2=0.0)
    assert af.fused_mode(p, x, y) == mode
    main = af.align_fused_cuda(p, x, y)
    af.phase_ns(reset=True)
    timed = af.align_fused_cuda(p, x, y, timed=True)
    torch.cuda.synchronize()
    *spans, iters = af.phase_ns(reset=True)
    assert torch.equal(main, timed)
    assert iters == 7 and spans[0] > 0 and spans[3] > 0


def test_fused_moments_refuses_unaligned_phi(dev):
    """The kernel copies Phi rows in 16-byte pieces: a view that starts
    off a 16-byte boundary is refused, not read wrong."""
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import moments
    from cvo_rgbd_torch.params import CvoParams

    x, y = _clouds(dev)
    c0, xc, phi = build_moments_pre(x)
    shifted = torch.empty(phi.numel() + 1, device=dev)[1:].view(phi.shape)
    shifted.copy_(phi)
    with pytest.raises(ValueError, match="aligned"):
        moments.fused_moments(xc, x.features, x.mask, y.positions - c0,
                              y.features, y.mask, shifted,
                              torch.full((), 0.1, device=dev), p=CvoParams())


def _self_sweep_inputs(dev, x, p, use_ck):
    """(cloud, ck, bound matrix, TileOrder) of x's symmetric self-sweep."""
    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
    from cvo_rgbd_torch.ops import gram, wsq

    ck = gram.color_gram(*x, *x, p=p) if use_ck else None
    lo, hi = block_bounds(x.positions, x.mask, wsq.TILE_W)
    md = aabb_min_d2(lo, hi, lo, hi)
    return x, ck, md, wsq.tile_order(md, True)


@pytest.mark.parametrize("use_ck", [True, False])
def test_fused_wsq_sweeps_are_one_launch_with_each_sweeps_bits(dev, use_ck):
    """S = 2 (an exact acvo iteration) and S = 2K = 24 (the Chebyshev
    tables, an ell a sweep): one launch a call, each sweep the bits of
    its own one-sweep launch; S = 34 takes two launches."""
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.ops import gram, wsq
    from cvo_rgbd_torch.params import AcvoParams

    p = AcvoParams()
    ins = [_self_sweep_inputs(dev, x, p, use_ck)
           for x in map(kd_sort, _rendered_pair(dev))]
    sweeps = [wsq.Sweep(tuple(x), tuple(x), ck, t, True)
              for x, ck, _, t in ins]
    for count, launches in ((2, 1), (24, 1), (34, 2)):
        ells = torch.linspace(0.0391, 0.15, count, device=dev)
        ells = ells.reshape(-1, 2)[:, :1].expand(-1, 2).reshape(-1)
        scal = gram.scalars(ells, p)
        before = wsq.fused_wsq.launches
        w, n = wsq.fused_wsq_sweeps_cuda(sweeps * (count // 2), scal)
        assert wsq.fused_wsq.launches == before + launches
        for k in range(count):
            x, ck, _, t = ins[k % 2]
            w1, n1 = wsq.fused_wsq_cuda(*x, *x, scal[k], ck, t,
                                        symmetric=True)
            assert torch.equal(_bits(w[k]), _bits(w1)), (k, w[k], w1)
            assert torch.equal(_bits(n[k]), _bits(n1)) and float(n1) > 0


def _cluster_cloud(dev, clusters=16, per=64, gap=1.0, extent=0.02, seed=3):
    """Clusters of one tile each, in tile order, `gap` apart along x:
    every off-diagonal tile's bound is ~gap^2, far past acvo's gate."""
    from cvo_rgbd_torch import pad_cloud

    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.random((per, 3)) * extent + [k * gap, 0.0, 1.0]
                          for k in range(clusters)])
    feat = np.repeat(rng.random((clusters, 5)) * 0.1, per, axis=0)
    return pad_cloud(pos, feat, clusters * per, device=dev)


@pytest.mark.parametrize("case", ["ell_init", "ell_min", "diagonal only"])
@pytest.mark.parametrize("use_ck", [True, False])
def test_fused_wsq_skip_on_and_off_give_the_same_bits(dev, case, use_ck):
    """The prefix of the tile order keeps exactly the tiles the bound
    rule keeps: skip on (bound matrix or TileOrder) and off, the same
    bits, symmetric and full; and within 1e-4 of the plain version."""
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.ops import gram, wsq
    from cvo_rgbd_torch.params import AcvoParams

    p = AcvoParams()
    if case == "diagonal only":
        xs, ell = [_cluster_cloud(dev)], p.ell_init
    else:
        xs = list(map(kd_sort, _rendered_pair(dev)))
        ell = getattr(p, case)
    for x in xs:
        x, ck, md, t = _self_sweep_inputs(dev, x, p, use_ck)
        ell_t = torch.full((), ell, device=dev)
        scal = gram.scalars(ell_t, p)
        keep = md <= scal[gram.S_D2_THRES] + wsq.SKIP_MARGIN
        off_diag = keep & ~torch.eye(md.shape[0], dtype=torch.bool,
                                     device=dev)
        if case == "diagonal only":
            assert not bool(off_diag.any()) and bool(keep.diagonal().all())
        ref_w, ref_n = wsq.fused_wsq_plain(*x, *x, scal, ck)
        for sym in (True, False):
            outs = [wsq.fused_wsq_cuda(*x, *x, scal, ck, skip, symmetric=sym)
                    for skip in (None, md, wsq.tile_order(md, sym))]
            for w, n in outs:
                assert torch.equal(_bits(w), _bits(outs[0][0]))
                assert torch.equal(_bits(n), _bits(outs[0][1]))
            assert abs(float(outs[0][0]) - float(ref_w)) <= 1e-4 * float(ref_w)
            assert float(outs[0][1]) == float(ref_n) > 0


@pytest.mark.parametrize("use_ck", [True, False])
def test_fused_wsq_of_an_all_masked_self_pair_is_positive_zero(dev, use_ck):
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.ops import gram, wsq
    from cvo_rgbd_torch.params import AcvoParams

    p = AcvoParams()
    x = kd_sort(_rendered_pair(dev)[0])
    x = x._replace(mask=torch.zeros_like(x.mask))
    x, ck, md, t = _self_sweep_inputs(dev, x, p, use_ck)
    scal = gram.scalars(torch.full((), p.ell_init, device=dev), p)
    for skip in (None, t):
        w, n = wsq.fused_wsq_cuda(*x, *x, scal, ck, skip, symmetric=True)
        assert float(w) == 0.0 and not bool(torch.signbit(w))
        assert float(n) == 0.0
    w, n = wsq.fused_wsq_sweeps_cuda(
        [wsq.Sweep(tuple(x), tuple(x), ck, t, True)] * 3, scal)
    assert not bool(w.ne(0).any() or torch.signbit(w).any() or n.ne(0).any())


@pytest.mark.parametrize("n,m", [(3072, 3072), (2816, 384), (1000, 130),
                                 (37, 1001)])
def test_color_gram_kernel_at_any_shape(dev, n, m):
    """The register-tiled kernel at the main path's shapes and at ragged
    ones (rows past the last tile, m % 4 != 0), against its plain
    version."""
    from cvo_rgbd_torch.core.cloud import PointCloud
    from cvo_rgbd_torch.ops import gram
    from cvo_rgbd_torch.params import AcvoParams

    rng = np.random.default_rng(n + m)
    palette = rng.random((8, 5))

    def cloud(k):
        # colors from a small palette, so that many pairs pass the gate;
        # a tenth of the points invalid
        return PointCloud(*(torch.tensor(a, dtype=torch.float32, device=dev)
                            for a in (rng.random((k, 3)),
                                      palette[rng.integers(8, size=k)],
                                      rng.random(k) > 0.1)))

    x, y = cloud(n), cloud(m)
    p = AcvoParams()
    ck = gram.color_gram(*x, *y, p=p)
    scal = gram.scalars(torch.full((), p.ell_init, device=dev), p)
    ref = gram.color_gram_plain(x.features, x.mask, y.features, y.mask, scal)
    assert ck.shape == (n, m)
    assert (ck - ref).abs().max().item() <= 1e-6
    assert int((ck > 0).sum()) > 0


def test_color_gram_of_a_self_pair_is_exactly_symmetric(dev):
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.ops import gram
    from cvo_rgbd_torch.params import AcvoParams

    for x in map(kd_sort, _rendered_pair(dev, num_want=3000)):
        ck = gram.color_gram(*x, *x, p=AcvoParams())
        assert torch.equal(ck, ck.T)


# ---- exp_mode="fast": the kernels' __expf forms against their plain
# versions on torch.exp.  Values within the precise checks' tolerances;
# nnz off by at most the pairs whose gate value lies within GATE_BAND of
# sp_thres (ops.moments.near_gate_pairs), where the two exps may disagree.

def _fast(p):
    import dataclasses

    return dataclasses.replace(p, exp_mode="fast")


@pytest.mark.parametrize("ell", [0.1, 0.03])
@pytest.mark.parametrize("mode", ["se", "se_ck", "linear"])
def test_fast_fused_moments_kernel_matches_plain(dev, mode, ell):
    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import gram, moments

    x, y, ck, p = _flow_inputs(dev, mode)
    p = _fast(p)
    linear = mode == "linear"
    c0, xc, phi = build_moments_pre(x)
    yc = y.positions - c0
    md = aabb_min_d2(*block_bounds(x.positions, x.mask, moments.TILE_I),
                     *block_bounds(y.positions, y.mask, moments.TILE_J))
    ell_t = torch.full((), ell, device=dev)
    scal = gram.scalars(ell_t, p)
    cloud_args = (xc, x.features, x.mask, yc, y.features, y.mask)
    ref, ref_nnz = moments.fused_moments_plain(
        *cloud_args, phi, scal, ck, None, linear, fast=True)
    near = moments.near_gate_pairs(*cloud_args, scal, ck, linear)
    out = {}
    for skip in (None, md):
        launches = moments.fused_moments.launches
        mom, nnz = moments.fused_moments(*cloud_args, phi, ell_t, ck, skip,
                                         p=p)
        assert moments.fused_moments.launches == launches + 1
        out[skip is None] = (mom, float(nnz))
        scale = ref.abs().amax(dim=0).clamp_min(1e-30)
        assert ((mom - ref).abs() / scale).max().item() <= 1e-4
        assert abs(float(nnz) - float(ref_nnz)) <= near and float(nnz) > 0
    # the skip drops only zero tiles under __expf too
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]


@pytest.mark.parametrize("use_ck", [True, False])
def test_fast_fused_wsq_kernel_matches_plain(dev, use_ck):
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.ops import gram, moments, wsq
    from cvo_rgbd_torch.params import AcvoParams

    p = _fast(AcvoParams())
    ins = [_self_sweep_inputs(dev, x, p, use_ck)
           for x in map(kd_sort, _rendered_pair(dev))]
    for ell in (0.1, 0.0391):
        ell_t = torch.full((), ell, device=dev)
        scal = gram.scalars(ell_t, p)
        sweeps = [wsq.Sweep(tuple(x), tuple(x), ck, t, True)
                  for x, ck, _, t in ins]
        w2, n2 = wsq.fused_wsq_sweeps(sweeps, ell_t, p=p)
        for k, (x, ck, md, t) in enumerate(ins):
            ref_w, ref_n = wsq.fused_wsq_plain(*x, *x, scal, ck, fast=True)
            near = moments.near_gate_pairs(*x, *x, scal, ck)
            bits = set()
            for skip in (None, md, t):
                w, n = wsq.fused_wsq(*x, *x, ell_t, ck, skip, p=p,
                                     symmetric=True)
                assert abs(float(w) - float(ref_w)) <= 1e-4 * float(ref_w)
                assert abs(float(n) - float(ref_n)) <= near and float(n) > 0
                bits.add((float(w), float(n)))
            bits.add((float(w2[k]), float(n2[k])))
            assert len(bits) == 1, bits


@pytest.mark.parametrize("ell", [0.1, 0.03])
@pytest.mark.parametrize("mode", ["se", "se_ck", "linear"])
def test_fast_flow_sweeps_match_plain_and_skip_exactly(dev, mode, ell):
    from cvo_rgbd_torch.ops import flow, gram, moments

    x, y, ck, p = _flow_inputs(dev, mode)
    linear = mode == "linear"
    scal = gram.scalars(torch.full((), ell, device=dev), p)
    near = moments.near_gate_pairs(*x, *y, scal, ck, linear)
    ref = flow.fused_flow_plain(*x, *y, scal, ck, linear, fast=True)
    wv = torch.cat([ref[0:3] / p.c, ref[3:6] / p.d])
    ref_s = flow.fused_step_coeffs_plain(*x, *y, scal, wv, ck, linear,
                                         fast=True)
    runs = []
    for skip in (True, False, True):
        out = flow.fused_flow_cuda(*x, *y, scal, ck, linear, skip=skip,
                                   fast=True)
        step = flow.fused_step_coeffs_cuda(*x, *y, scal, wv, ck, linear,
                                           skip=skip, fast=True)
        assert abs(out[8].item() - ref[8].item()) <= near
        for sl in (slice(0, 3), slice(3, 6), slice(6, 7), slice(7, 8)):
            assert _close(out[sl], ref[sl]), (sl, out, ref)
        for q in range(4):
            assert _close(step[q], ref_s[q]), (q, step, ref_s)
        runs.append((out, step))
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(_bits(a), _bits(b))
    for a, b in zip(runs[0], runs[2]):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("mode", ["se", "se_ck", "linear", "wsq_ck", "wsq"])
def test_fast_forms_differ_on_one_pair(dev, mode):
    """Each fast instantiation takes __expf.  A real sweep's one-float sum
    may round to the same bits under both exps, so each kernel runs on
    one valid pair (two points of one cloud for the self-sweep) whose
    position exp takes z in [42, 72], the gate opened (d2_thres 2,
    sp_thres 0): there __expf is up to tens of ulps from exp_neg, and
    fast and precise must part at some z."""
    from cvo_rgbd_torch.core.cloud import PointCloud
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import flow, gram, moments, wsq
    from cvo_rgbd_torch.params import MATLAB_PARAMS, CvoParams

    cap = 128
    pos = torch.zeros(cap, 3, device=dev)
    pos[:, 0] = 100.0 + 10.0 * torch.arange(cap, device=dev)
    pos[:2] = torch.tensor([[0.3, -0.2, 1.5], [0.3, 0.8, 1.5]], device=dev)
    feat = torch.full((cap, 5), 0.5, device=dev)
    valid = 2 if mode.startswith("wsq") else 1
    x = PointCloud(pos, feat, (torch.arange(cap, device=dev) < valid).float())
    y = x._replace(positions=pos + torch.tensor([1.0, 0.0, 0.0], device=dev))
    ck = None
    if mode in ("se_ck", "linear", "wsq_ck"):
        ck = torch.zeros(cap, cap, device=dev)
        ck[:valid, :valid] = 1.0
    p = MATLAB_PARAMS if mode == "linear" else CvoParams()
    linear = mode == "linear"
    c0, xc, phi = build_moments_pre(x)
    wv = torch.tensor([0.1, -0.2, 0.3, 0.05, 0.1, -0.1], device=dev)
    base = gram.scalars(torch.full((), 0.1, device=dev), p)

    def launches(r, fast):
        if mode.startswith("wsq"):
            return wsq.fused_wsq_cuda(*x, *x, r, ck, None, symmetric=True,
                                      fast=fast)
        return (*moments.fused_moments_cuda(
            xc, x.features, x.mask, y.positions - c0, y.features, y.mask,
            phi, r, ck, None, linear, fast=fast),
            flow.fused_flow_cuda(*x, *y, r, ck, linear, skip=False,
                                 fast=fast),
            flow.fused_step_coeffs_cuda(*x, *y, r, wv, ck, linear,
                                        skip=False, fast=fast))

    differ = []
    for z in range(42, 74, 2):
        r = base.clone()
        r[gram.S_INV_2L2], r[gram.S_D2_THRES], r[gram.S_SP_THRES] = z, 2, 0
        fast, precise = launches(r, True), launches(r, False)
        assert float(precise[0].abs().max()) > 0
        # each output of each kernel on its own
        differ.append([not torch.equal(_bits(a), _bits(b))
                       for a, b in zip(fast, precise)])
    outputs = [0] if mode.startswith("wsq") else [0, 2, 3]
    for k in outputs:
        assert any(d[k] for d in differ), (k, differ)


@pytest.mark.parametrize("max_iter", [1, 10])
@pytest.mark.parametrize("mode", ["resident", "tiled"])
@pytest.mark.parametrize("algo", ["cvo", "acvo", "linear"])
def test_fast_align_fused_kernel_matches_plain(dev, algo, mode, max_iter):
    import dataclasses

    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_cuda,
        align_fused_plain,
        fused_mode,
    )

    if algo == "linear":
        cap = 1024 if mode == "resident" else 1152
        x, y, _ = _linear_clouds(dev, n=cap - 24, cap=cap, seed=6)
        x, y = _padded(x), _padded(y)
        p = ct.MATLAB_PARAMS
    else:
        x, y = _fused_pair(dev, algo, mode)
        p = ct.CvoParams() if algo == "cvo" else ct.AcvoParams()
    p = dataclasses.replace(p, backend="fused", max_iter=max_iter, eps=0.0,
                            eps_2=0.0, exp_mode="fast")
    assert fused_mode(p, x, y) == mode
    row = align_fused_cuda(p, x, y)
    ref = align_fused_plain(p, x, y)
    precise = align_fused_cuda(dataclasses.replace(p, exp_mode="precise"),
                               x, y)
    assert row[24].item() == ref[24].item() == max_iter
    tol = 1e-5 if max_iter <= 3 else 1e-4
    assert (row[12:] - ref[12:]).abs().max().item() <= tol
    # a form of its own: the fast launch does not give the precise bits
    assert not torch.equal(row, precise)


@pytest.mark.parametrize("mode,cap", [("resident", 256), ("tiled", 1152)])
def test_fast_align_fused_batched_lanes_are_single_launches(dev, mode, cap):
    """A lane's bits do not depend on its neighbours in fast mode."""
    import dataclasses

    from cvo_rgbd_torch import pad_cloud
    from cvo_rgbd_torch.core.cloud import kd_sort, stack_clouds
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_batched_cuda,
        align_fused_cuda,
    )
    from cvo_rgbd_torch.params import MATLAB_PARAMS

    p = dataclasses.replace(MATLAB_PARAMS, backend="fused", max_iter=10,
                            exp_mode="fast")
    pairs = []
    for k in range(3):
        rng = np.random.default_rng(40 + k)
        n = cap - 50 * k
        pos = rng.standard_normal((n + 30, 3)) * 0.4
        col = rng.random((n + 30, 3)) * 255.0
        y = pos[20:20 + n] + np.array([0.02, -0.01, 0.015])
        pairs.append((kd_sort(_padded(pad_cloud(pos[:n], col[:n], cap,
                                                device=dev))),
                      kd_sort(_padded(pad_cloud(y, col[20:20 + n], cap,
                                                device=dev)))))
    rows = align_fused_batched_cuda(p, stack_clouds([a for a, _ in pairs]),
                                    stack_clouds([b for _, b in pairs]))
    for k, (x, y) in enumerate(pairs):
        assert torch.equal(rows[k], align_fused_cuda(p, x, y)), k


@pytest.mark.parametrize("backend", ["kernel", "dense", "fused"])
def test_fast_align_on_card_matches_precise(dev, backend):
    """At the MATLAB stops, where the hardware exp converges, a fast
    align lands within the JAX package's fast-vs-precise bound of the
    precise one (tests/test_core.py: translation 2e-3)."""
    import dataclasses

    import cvo_rgbd_torch as ct

    x, y, _ = _linear_clouds(dev, n=500, cap=512, seed=7)
    p = dataclasses.replace(ct.MATLAB_PARAMS, backend=backend)
    precise = ct.align(p, x, y)
    fast = ct.align(_fast(p), x, y)
    assert bool(fast.converged) and bool(precise.converged)
    assert (fast.tf[:3, 3] - precise.tf[:3, 3]).abs().max().item() <= 2e-3
    cpu = ct.align(_fast(p), x.to("cpu"), y.to("cpu"), device="cpu")
    assert (fast.tf.cpu() - cpu.tf).abs().max().item() <= 3e-4


# ---- keyframe SLAM on the card ----------------------------------------------

def _square_world_clouds(dev, n=250, cap=256, seed=0):
    """The square-loop world of tests/test_slam.py: a random world cloud
    seen from a camera that walks a small square and returns."""
    from cvo_rgbd_torch import pad_cloud

    rng = np.random.default_rng(seed)
    world = (rng.standard_normal((n, 3)) * np.array([1.0, 0.8, 0.6])
             + np.array([0, 0, 2.5]))
    feat = rng.random((n, 5)) * np.array([255, 255, 255, 60, 60])
    poses = [np.eye(4)]
    for d in ([0.05, 0, 0], [0, 0.05, 0], [-0.05, 0, 0], [0, -0.05, 0]):
        for _ in range(3):
            T = poses[-1].copy()
            T[:3, 3] += d
            poses.append(T)
    out = []
    for T in poses:
        inv = np.linalg.inv(T)
        out.append(pad_cloud(world @ inv[:3, :3].T + inv[:3, 3], feat, cap,
                             device=dev))
    return out


def _slam(p, clouds, device):
    from cvo_rgbd_torch.keyframes import KeyframePolicy
    from cvo_rgbd_torch.slam import KeyframeSlam, SlamConfig

    slam = KeyframeSlam(p, SlamConfig(
        keyframe=KeyframePolicy(threshold=0.995, max_span=2),
        loop_min_separation=3, loop_score_threshold=0.5), device=device)
    for i, c in enumerate(clouds):
        slam.process(i, c)
    return slam, slam.solve()


@pytest.mark.parametrize("backend", ["kernel", "fused"])
def test_keyframe_slam_on_card_matches_cpu(dev, backend):
    """The same keyframes and loop edges as on the CPU, the poses within
    the aligns' stop skew chained over frames (tests/test_torch_slam.py)."""
    import dataclasses

    import cvo_rgbd_torch as ct

    clouds = _square_world_clouds(dev)
    p = dataclasses.replace(ct.CvoParams(max_iter=150, eps=5e-4, eps_2=1e-4),
                            backend=backend)
    gpu, (g_poses, g_nodes) = _slam(p, clouds, dev)
    cpu, (c_poses, c_nodes) = _slam(p, [c.to("cpu") for c in clouds], "cpu")
    assert [k.index for k in gpu.keyframes] == [k.index for k in cpu.keyframes]
    assert ([e[:2] for e in gpu.loop_edges] == [e[:2] for e in cpu.loop_edges]
            and len(gpu.loop_edges) >= 1)
    assert np.abs(np.stack(g_poses) - np.stack(c_poses)).max() <= 2e-3
    assert np.abs(g_nodes - c_nodes).max() <= 2e-3


@pytest.mark.parametrize("backend", ["kernel", "fused"])
def test_fast_keyframe_slam_on_card_matches_precise(dev, backend):
    """exp_mode="fast" SLAM at the MATLAB stops: the keyframes and loop
    edges of the precise run, each frame within the fast-vs-precise bound
    chained over frames."""
    import dataclasses

    import cvo_rgbd_torch as ct

    clouds = _square_world_clouds(dev, seed=1)
    p = dataclasses.replace(ct.CvoParams(max_iter=150, eps=5e-4, eps_2=1e-4),
                            backend=backend)
    precise, (p_poses, _) = _slam(p, clouds, dev)
    fast, (f_poses, _) = _slam(_fast(p), clouds, dev)
    assert [k.index for k in fast.keyframes] == [
        k.index for k in precise.keyframes]
    assert [e[:2] for e in fast.loop_edges] == [
        e[:2] for e in precise.loop_edges]
    gap = max(np.linalg.norm(a[:3, 3] - b[:3, 3])
              for a, b in zip(f_poses, p_poses))
    assert gap <= 1e-2, gap


def test_pose_graph_on_card_matches_cpu(dev):
    from cvo_rgbd_torch.core import posegraph

    rng = np.random.default_rng(4)
    poses = [np.eye(4)]
    for _ in range(40):
        step = np.eye(4)
        step[:3, 3] = [0.2, 0.0, 0.01]
        poses.append(poses[-1] @ step)
    noisy = [p.copy() for p in poses]
    for k, p in enumerate(noisy):
        p[:3, 3] += rng.normal(0.0, 0.01 * k ** 0.5, 3)
    loops = [(0, 40, np.linalg.inv(poses[0]) @ poses[40], 5.0)]
    for solver in ("dense", "pcg"):
        out = [posegraph.optimize(posegraph.from_odometry(
            noisy, loops, device=d), iters=5, solver=solver, huber_delta=0.3,
            robust="cauchy", robust_warmup=2) for d in (dev, "cpu")]
        assert (out[0][0].cpu() - out[1][0]).abs().max().item() <= 1e-3
        assert torch.allclose(out[0][1].cpu(), out[1][1], rtol=1e-3)


# ---- the rest of cli run and cli slam: timing, profiler, loader, BA, trace


def test_phase_timer_waits_on_the_device(dev):
    """`sync=` and `sync_point` wait for the tensors' device: the phase
    holds a ~50 ms device sleep that a host clock alone would miss."""
    from cvo_rgbd_torch.utils.timing import PhaseTimer

    cycles = 100_000_000
    timer = PhaseTimer()
    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    with timer.phase("unsynced"):
        torch.cuda._sleep(cycles)
        y = x + 1
    torch.cuda.synchronize()
    with timer.phase("synced", sync=[y]):
        torch.cuda._sleep(cycles)
        y = x + 1
    torch.cuda._sleep(cycles)
    timer.sync_point("wait", x + 2)
    assert timer.totals["synced"] > 0.02 > timer.totals["unsynced"]
    assert timer.totals["wait"] > 0.02
    assert timer.report()["synced"]["count"] == 1


def test_profiler_trace_requires_cuda_activity(dev, tmp_path):
    """A trace on the card holds the kernels of the block, and a block
    that ran nothing on the device raises: no CPU-only trace passes as a
    device trace."""
    from cvo_rgbd_torch.ops import gram
    from cvo_rgbd_torch.params import CvoParams
    from cvo_rgbd_torch.utils.timing import device_events, profiler_trace

    import time

    x, y = _clouds(dev)
    gram.color_gram(*x, *y, p=CvoParams())
    torch.cuda.synchronize()
    # 20 launches, after the lead of _one_launch_window: the profiler
    # drops a kernel record now and then
    with profiler_trace(tmp_path / "on"):
        time.sleep(PROFILER_LEAD_S)
        for _ in range(20):
            gram.color_gram(*x, *y, p=CvoParams())
    (trace,) = (tmp_path / "on").iterdir()
    assert any("color_gram_kernel" in n for n in device_events(trace))
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        with profiler_trace(tmp_path / "off"):
            torch.zeros(3).sum()


def test_native_loader_decodes_on_the_card_host(dev, tmp_path):
    """The loader builds with the card host's g++ and zlib and decodes
    the files of chip_smoke's writer to their bits."""
    import chip_smoke
    from cvo_rgbd_torch import native

    rng = np.random.default_rng(0)
    rgbs = [rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
            for _ in range(4)]
    deps = [rng.integers(0, 65536, (48, 64)).astype(np.uint16)
            for _ in range(4)]
    paths = []
    for i, (r, d) in enumerate(zip(rgbs, deps)):
        rp, dp = tmp_path / f"r{i}.png", tmp_path / f"d{i}.png"
        rp.write_bytes(chip_smoke.png_bytes(r))
        dp.write_bytes(chip_smoke.png_bytes(d))
        paths.append((str(rp), str(dp)))
    loader = native.PrefetchLoader([a for a, _ in paths],
                                   [b for _, b in paths], 64, 48)
    got = list(loader)
    loader.close()
    assert [g[0] for g in got] == [0, 1, 2, 3]
    for (_, r, d), r0, d0 in zip(got, rgbs, deps):
        np.testing.assert_array_equal(r, r0)
        np.testing.assert_array_equal(d, d0)


def _ba_problem(noise, partial, device):
    """tests/test_ba.py's synthetic problem, made with the port's se3:
    6 poses observing 40 landmarks, pose 0 at the truth."""
    from cvo_rgbd_torch import se3
    from cvo_rgbd_torch.parallel import make_ba_problem

    rng = np.random.default_rng(7)
    k, m = 6, 40

    def exp(xi):
        return se3.exp_se3(torch.tensor(xi, dtype=torch.float32)).numpy()

    lms = rng.uniform(-1, 1, (m, 3)).astype(np.float32) + [0, 0, 3.0]
    poses = np.stack([exp(np.concatenate([rng.normal(0, 0.1, 3),
                                          rng.normal(0, 0.3, 3)]))
                      for _ in range(k)])
    op = np.repeat(np.arange(k), m)
    ol = np.tile(np.arange(m), k)
    z = np.einsum("oi,oij->oj", lms[ol] - poses[op, :3, 3], poses[op, :3, :3])
    z = z + rng.normal(0, noise, z.shape)
    init = poses.copy()
    for i in range(1, k):
        init[i] = init[i] @ exp(rng.normal(0, 0.05, 6))
    w = np.where(ol == 7, 0.0, 1.0) if partial else None
    return make_ba_problem(init, lms + rng.normal(0, 0.05, lms.shape), op,
                           ol, z.astype(np.float32), w, device=device)


@pytest.mark.parametrize("case", ["clean", "noisy", "partial"])
def test_ba_solve_on_card_matches_cpu(dev, case):
    """The card's scatter-adds are atomic, in no fixed order: held to the
    CPU's solve by tests/test_torch_ba.py's tolerances, not by bits."""
    from cvo_rgbd_torch.parallel import ba_cost, ba_solve

    problem = _ba_problem(0.005 if case == "noisy" else 0.0,
                          case == "partial", "cpu")
    card = ba_solve(problem, iters=8, device=dev)
    cpu = ba_solve(problem, iters=8, device="cpu")
    for a, b in zip(card[:2], cpu[:2]):
        assert a.device.type == "cuda"
        assert (a.cpu() - b).abs().max().item() <= 1e-4
    assert torch.allclose(card[2].cpu(), cpu[2], rtol=1e-3, atol=1e-7)
    assert float(ba_cost(problem, device=dev)) == pytest.approx(
        float(ba_cost(problem, device="cpu")), rel=1e-5)


@pytest.mark.parametrize("algo", ["cvo", "acvo"])
@pytest.mark.parametrize("cap", [1024, 3072])
def test_align_trace_on_card_is_align(dev, cap, algo):
    """Past align's stop the record freezes at its stopping iteration,
    and the final state is align's bits on the card."""
    from cvo_rgbd_torch import align
    from cvo_rgbd_torch.core.trace import align_trace
    from cvo_rgbd_torch.params import AcvoParams, CvoParams

    x, y = _clouds(dev, n=cap - 24, cap=cap, seed=cap)
    p = (AcvoParams if algo == "acvo" else CvoParams)(eps=5e-4, eps_2=1e-4)
    res = align(p, x, y)
    k = int(res.iterations)
    final, rec = align_trace(p, x, y, k + 5)
    conv = rec.converged.cpu()
    assert bool(res.converged) and not conv[:k].any() and conv[k:].all()
    for a, b in ((final.tf, res.tf), (final.R, res.R), (final.T, res.T),
                 (final.ell, res.ell)):
        assert torch.equal(a, b)


# --- rows 1-3 at the mesh paths' block shapes (parallel/sharded.py) ---------

def _filled_render(dev, sp):
    """The 240x320 render pair (1325 and 1647 valid points of 3000 asked)
    cut to one capacity, a multiple of 128 * sp that the fewer valid
    points fill, every row valid, kd-sorted: each of sp row blocks holds
    valid rows, where at capacity 3072 kd_sort would put them all in the
    first block."""
    from cvo_rgbd_torch.core.cloud import PointCloud, kd_sort
    from cvo_rgbd_torch.ops.gram import pad_feat

    pair = _rendered_pair(dev, 3000, (240, 320))
    step = 128 * sp
    cap = min(int(c.mask.sum().item()) for c in pair) // step * step
    return [kd_sort(PointCloud(
        c.positions[:cap], pad_feat(c.features)[:cap], c.mask[:cap]))
        for c in (PointCloud(*(t[torch.nonzero(c.mask > 0)[:, 0]]
                               for t in c)) for c in pair)]


@pytest.mark.parametrize("sp", [2, 4])
def test_kernels_on_row_and_ring_blocks_match_plain(dev, sp):
    """align_sharded's blocks: color_gram [N/sp, M], fused_moments
    [N/sp, M] with the cache and the skip, fused_wsq as the cross sweep
    [N/sp, N]; align_ring's: fused_moments [N/sp, M/sp] and fused_wsq
    [N/sp, N/sp] recomputing color; each against its plain version, and
    the row blocks' moments and sweeps summed against the whole cloud's
    launch.  Every row block holds valid rows and must give pairs; two
    kd-sorted clouds' blocks r need not overlap, so a ring block must
    give pairs in some hop."""
    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import gram, moments, wsq
    from cvo_rgbd_torch.params import AcvoParams

    p = AcvoParams()
    x, y = _filled_render(dev, sp)
    n, m = x.capacity, y.capacity
    nb, mb = n // sp, m // sp
    ell = torch.full((), 0.1, device=dev)
    scal = gram.scalars(ell, p)
    c0, xc, phi = build_moments_pre(x)
    yc = y.positions - c0

    def moments_block(rows, cols, use_ck):
        xb = [t[rows] for t in (xc, x.features, x.mask)]
        yb = [t[cols] for t in (yc, y.features, y.mask)]
        ck = None
        if use_ck:
            args = (x.features[rows], x.mask[rows], yb[1], yb[2], scal)
            ck = gram.color_gram_cuda(*args)
            assert (ck - gram.color_gram_plain(*args)).abs().max() <= 1e-6
        md = aabb_min_d2(*block_bounds(xb[0], xb[2], moments.TILE_I),
                         *block_bounds(yb[0], yb[2], moments.TILE_J))
        a = (*xb, *yb, phi[rows], scal, ck, md)
        mom, nnz = moments.fused_moments_cuda(*a)
        ref, ref_nnz = moments.fused_moments_plain(*a)
        scale = ref.abs().amax(dim=0).clamp_min(1e-30)
        assert ((mom - ref).abs() / scale).max().item() <= 1e-4
        assert abs(float(nnz) - float(ref_nnz)) <= 1e-4 * float(ref_nnz)
        return mom, float(nnz)

    every = slice(None)
    rows = [slice(r * nb, (r + 1) * nb) for r in range(sp)]
    whole, nnz = moments_block(every, every, True)
    parts = [moments_block(r, every, True) for r in rows]
    scale = whole.abs().amax(dim=0).clamp_min(1e-30)
    assert ((sum(m_ for m_, _ in parts) - whole).abs() / scale).max() <= 1e-4
    assert sum(c for _, c in parts) == nnz
    assert all(c > 0 for _, c in parts)
    # the ring's hops: every x block against every y block, summed against
    # the whole launch; each block meets a pair in some hop
    cols = [slice(s * mb, (s + 1) * mb) for s in range(sp)]
    hops = [[moments_block(r, c, False) for c in cols] for r in rows]
    whole, nnz = moments_block(every, every, False)
    scale = whole.abs().amax(dim=0).clamp_min(1e-30)
    # Mom is [M, 35]: a y block's rows sum over the x blocks
    summed = torch.cat([sum(hop[s][0] for hop in hops) for s in range(sp)])
    assert ((summed - whole).abs() / scale).max() <= 1e-4
    assert sum(c for hop in hops for _, c in hop) == nnz
    assert all(any(c > 0 for _, c in hop) for hop in hops)
    assert all(any(hop[s][1] > 0 for hop in hops) for s in range(sp))

    def sweep(xb, yb, use_ck, symmetric=False):
        ck = gram.color_gram_cuda(xb.features, xb.mask, yb.features,
                                  yb.mask, scal) if use_ck else None
        md = aabb_min_d2(*block_bounds(xb.positions, xb.mask, wsq.TILE_W),
                         *block_bounds(yb.positions, yb.mask, wsq.TILE_W))
        a = (*xb, *yb, scal, ck, wsq.tile_order(md, symmetric))
        w, nz = wsq.fused_wsq_cuda(*a, symmetric=symmetric)
        ref_w, ref_n = wsq.fused_wsq_plain(*a)
        assert abs(float(w) - float(ref_w)) <= 1e-4 * abs(float(ref_w))
        assert float(nz) == float(ref_n)
        return float(w), float(nz)

    from cvo_rgbd_torch.core.cloud import PointCloud

    xs = [PointCloud(*(t[r] for t in x)) for r in rows]
    full = sweep(x, x, True, symmetric=True)
    parts = [sweep(xb, x, True) for xb in xs]
    assert abs(sum(w for w, _ in parts) - full[0]) <= 1e-4 * abs(full[0])
    assert sum(c for _, c in parts) == full[1]
    assert all(c > 0 for _, c in parts)
    assert all(sweep(xb, xb, False)[1] > 0 for xb in xs)


@pytest.mark.parametrize("entry", ["sharded", "ring"])
def test_mesh_aligns_on_two_ranks_sharing_the_card(dev, entry):
    """align_sharded / align_ring on 2 ranks on cuda:0 over gloo, cvo and
    acvo at the C++ stops on a pair whose row blocks both hold valid
    rows, against the single-device align on the card."""
    import sys
    from pathlib import Path

    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.parallel import mesh as tmesh

    sys.path.insert(0, str(Path(__file__).parent))
    import torch_ranks

    x, y = _filled_render(dev, 2)
    clouds = {"render": tuple(tuple(t.cpu().numpy() for t in c)
                              for c in (x, y))}
    params = [ct.CvoParams(), ct.AcvoParams()]
    cases = [({"sp": 2}, entry, p, "render", {}) for p in params]
    got = tmesh.launch(torch_ranks.aligns, 2, (cases, clouds, None),
                       timeout=600)
    for r in got[1:]:
        for a, b in zip(got[0], r):
            for f in a:
                np.testing.assert_array_equal(a[f], b[f])
    for p, res in zip(params, got[0]):
        ref = ct.align(p, x, y)
        np.testing.assert_allclose(res["tf"], ref.tf.cpu().numpy(),
                                   atol=3e-4)
        assert bool(res["converged"]) and bool(ref.converged)
        np.testing.assert_allclose(res["ell"], ref.ell.cpu().numpy(),
                                   rtol=0.05)


@pytest.mark.parametrize("transport", ["gloo", "nccl"])
def test_compiled_mesh_loops_have_the_eager_bits_on_the_card(dev, transport):
    """align_sharded (cvo, acvo) and align_ring (cvo), whose loops are
    compiled, against their eager loops on the same ranks at the C++
    stops, bit for bit: 2 ranks sharing the card over gloo (a block is
    graph segments, the staged collectives between them) and 1 rank
    over NCCL (a block is one graph, its all_reduces inside).  Then
    optimize(mesh=) and ba_solve(mesh=) against their eager mesh loops:
    2e-4 (BA 1e-4) and costs 1e-3, the same on every rank."""
    import sys
    from pathlib import Path

    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.parallel import mesh as tmesh

    sys.path.insert(0, str(Path(__file__).parent))
    import torch_ranks
    from torch_ranks import BA, OPT

    world = 2 if transport == "gloo" else 1
    x, y = _filled_render(dev, 2)
    clouds = {"render": tuple(tuple(t.cpu().numpy() for t in c)
                              for c in (x, y))}
    axes = {"sp": world}
    cases = [(axes, "sharded", ct.CvoParams(), "render"),
             (axes, "sharded", ct.AcvoParams(), "render"),
             (axes, "ring", ct.CvoParams(), "render")]
    got = tmesh.launch(torch_ranks.jobs, world, ([
        ("compiled_and_eager", (cases, clouds, None)),
        ("solvers_compiled_and_eager", (axes, torch_ranks.mesh_graph(),
                                        torch_ranks.mesh_problem(), OPT, BA,
                                        None))],), backend=transport,
        timeout=600)
    for rank in got:
        for (res, ref, _, replays, segments), first in zip(rank[0],
                                                           got[0][0]):
            for f in ref:
                np.testing.assert_array_equal(res[f], ref[f], err_msg=f)
                np.testing.assert_array_equal(res[f], first[0][f])
            assert bool(res["converged"]) and replays > 0
            # gloo: 2 psums an iteration (the ring adds a ppermute a hop)
            assert all((n == 1) == (transport == "nccl")
                       for n in segments.values()) and segments
        comp, eager = rank[1]
        for part, tol in ((slice(0, 2), 2e-4), (slice(2, 5), 1e-4)):
            for a, b in zip(comp[part][:-1], eager[part][:-1]):
                np.testing.assert_allclose(a, b, atol=tol)
            np.testing.assert_allclose(comp[part][-1], eager[part][-1],
                                       rtol=1e-3)
        for a, b in zip(comp, got[0][1][0]):
            np.testing.assert_array_equal(a, b)


def test_a_failed_nccl_mesh_capture_raises(dev):
    """A kernel body with a host read cannot be captured on an NCCL
    axis: align_sharded raises, naming the entry point, after its one
    eager warm-up block; no block is replayed or run eagerly in its
    place."""
    import sys
    from pathlib import Path

    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.parallel import mesh as tmesh

    sys.path.insert(0, str(Path(__file__).parent))
    import torch_ranks

    x, y = _filled_render(dev, 2)
    (err, replays, warmups), = tmesh.launch(
        torch_ranks.capture_fails, 1, ({"sp": 1}, ct.CvoParams(), tuple(
            tuple(t.cpu().numpy() for t in c) for c in (x, y))),
        backend="nccl", timeout=300)
    assert err is not None and "capturing 8 iterations of align_sharded" \
        in err and "nccl" in err
    assert replays == 0 and warmups == 8


@pytest.fixture(scope="module")
def degraded(tmp_path_factory):
    """tests/test_degradation.py's sequence: total dropout at frame 10."""
    from cvo_rgbd_torch.synth import Degradation, make_tum_dataset
    from cvo_rgbd_torch.synth import revisit_path

    root = tmp_path_factory.mktemp("degraded")
    make_tum_dataset(root, revisit_path(24, period=33),
                     degrade=Degradation(depth_noise=2e-3, dropout=0.08,
                                         low_texture_frames=(6,),
                                         drop_frames=(10,), seed=3))
    return root


@pytest.mark.parametrize("driver", ["sequential", "batched",
                                    "batched_prior"])
def test_degraded_failed_pairs_on_card(dev, degraded, tmp_path, driver):
    """The drivers' skip-and-mark on the card (kernel backend; the
    batched driver fused, one launch a batch of 4) fails the pairs the
    CPU run fails: exactly the dropped frame's two."""
    import dataclasses

    from cvo_rgbd_torch.odometry import run_odometry, run_odometry_batched
    from cvo_rgbd_torch.params import CvoParams

    p = CvoParams(eps=5e-4, eps_2=1e-4)

    def failed(device):
        kw = dict(num_want=512, max_frames=13, use_native=False,
                  output=str(tmp_path / f"{device}.txt"),
                  log=lambda *a: None, device=device)
        if driver == "sequential":
            recs = run_odometry(str(degraded), 1, params=p, **kw)
        else:
            recs = run_odometry_batched(
                str(degraded), 1,
                params=dataclasses.replace(p, backend="fused"), batch=4,
                motion_prior=driver == "batched_prior", **kw)
        return {r.index for r in recs if r.failed}

    assert failed("cuda") == failed("cpu") == {10, 11}


# ---- align_jit: the align loop captured as CUDA graphs ---------------------


def _jit_cases(dev):
    """(params, fixed, moving, warm start) of each compiled configuration
    at the main path's sizes: the rendered pair at capacity 3072 (cvo
    and acvo frontends) and a linear pair at 2816."""
    import dataclasses

    import cvo_rgbd_torch as ct

    x, y = _rendered_pair(dev, num_want=3000, size=(240, 320))
    lx, ly, _ = _linear_clouds(dev, n=2800, cap=2816, seed=9)
    stops = dict(eps=5e-4, eps_2=1e-4, max_iter=60)
    warm = (torch.eye(3, device=dev), torch.full((3,), 0.002, device=dev),
            torch.full((), 0.1, device=dev))
    return {
        "cvo": (ct.CvoParams(max_iter=60), x, y, ()),
        "acvo exact": (ct.AcvoParams(**stops), x, y, ()),
        "acvo cheb": (ct.AcvoParams(self_mode="cheb", **stops), x, y, ()),
        "direct": (ct.CvoParams(step_mode="direct", max_iter=60), x, y, ()),
        "linear": (dataclasses.replace(ct.MATLAB_PARAMS, max_iter=60), lx,
                   ly, ()),
        "dense": (ct.CvoParams(backend="dense", max_iter=60), x, y, ()),
        "cvo fast": (ct.CvoParams(exp_mode="fast", max_iter=60), x, y, ()),
        "warm start": (ct.CvoParams(max_iter=60), x, y, warm),
    }


_JIT_FIELDS = ("tf", "R", "T", "iterations", "converged", "ell", "omega",
               "v")


def _launch_counts():
    from cvo_rgbd_torch.core.compiled import COUNTED

    return [w.launches for w in COUNTED]


@pytest.mark.parametrize("case", ["cvo", "acvo exact", "acvo cheb", "direct",
                                  "linear", "dense", "cvo fast",
                                  "warm start"])
def test_align_jit_gives_the_bits_of_align_on_the_card(dev, case):
    """The replayed graphs launch what `align` launches, in its order:
    the same bits, one replay every 8 iterations started, and on a
    second call (the graphs built) the same kernel launches as `align`."""
    import math

    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.core import compiled

    p, x, y, warm = _jit_cases(dev)[case]
    ref = ct.align(p, x, y, *warm)
    first = ct.align_jit(p, x, y, *warm)
    before = _launch_counts()
    eager = ct.align(p, x, y, *warm)
    eager_counts = [a - b for a, b in zip(_launch_counts(), before)]
    replays = compiled.align_jit.replays
    before = _launch_counts()
    got = ct.align_jit(p, x, y, *warm)
    jit_counts = [a - b for a, b in zip(_launch_counts(), before)]
    torch.cuda.synchronize()
    for f in _JIT_FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
        assert torch.equal(getattr(first, f), getattr(ref, f)), f
        assert torch.equal(getattr(eager, f), getattr(ref, f)), f
    assert compiled.align_jit.replays - replays == math.ceil(
        (int(got.iterations) + 1) / 8)
    assert jit_counts == eager_counts


def test_align_jit_tail_graph_on_the_card(dev):
    """max_iter=13 that cannot stop: the block of 8, then the tail of 5
    in a graph of its own, and exactly 13 iterations."""
    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.core import compiled

    p = ct.CvoParams(max_iter=13, eps=0.0, eps_2=0.0)
    x, y = _clouds(dev, n=3000, cap=3072, seed=2)
    replays = compiled.align_jit.replays
    got = ct.align_jit(p, x, y)
    assert compiled.align_jit.replays - replays == 2
    ref = ct.align(p, x, y)
    assert int(got.iterations) == 12 and not bool(got.converged)
    for f in _JIT_FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    (obj,) = [v for k, v in compiled.CACHE.items()
              if k[0] == p and k[1:3] == (3072, 3072)]
    assert sorted(obj.graphs) == [5, 8]


def test_align_jit_three_pairs_through_one_graph_on_the_card(dev):
    """Each result a fresh tensor: the first is unchanged after two more
    pairs have run through the same graphs."""
    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.core import compiled

    p = ct.CvoParams(max_iter=40, eps=5e-4, eps_2=1e-4)
    pairs = [_clouds(dev, n=3000, cap=3072, seed=s) for s in (3, 4, 5)]
    got = [ct.align_jit(p, *pairs[0])]
    first = got[0].tf.clone()
    got += [ct.align_jit(p, *pr) for pr in pairs[1:]]
    assert len([k for k in compiled.CACHE
                if k[0] == p and k[1:3] == (3072, 3072)]) == 1
    assert torch.equal(got[0].tf, first)
    for res, pr in zip(got, pairs):
        ref = ct.align(p, *pr)
        for f in _JIT_FIELDS:
            assert torch.equal(getattr(res, f), getattr(ref, f)), f


def test_align_jit_raises_when_capture_fails(dev, monkeypatch):
    """A block with a host read cannot be captured: the call raises and
    nothing falls back to the eager loop."""
    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.core import compiled

    real = compiled.make_align_step

    def with_host_read(p):
        body = real(p)

        def reads(state, *args):
            float(state.ell.item())
            return body(state, *args)
        return reads

    monkeypatch.setattr(compiled, "make_align_step", with_host_read)
    p = ct.CvoParams(max_iter=16, eps=1e-3)
    x, y = _clouds(dev, n=500, cap=512, seed=6)
    replays = compiled.align_jit.replays
    with pytest.raises(RuntimeError, match="capturing 8 iterations"):
        ct.align_jit(p, x, y)
    assert compiled.align_jit.replays == replays
    torch.cuda.synchronize()
    for key in [k for k in compiled.CACHE if k[0] == p]:
        del compiled.CACHE[key]


# ---- color_gram's lane axis and align_batched's compiled lanes ---------------


def _lane_clouds(dev, b, n, m, seed=11):
    """b kd-sorted pairs of capacities (n, m) stacked on a lane axis, the
    fixed cloud of lane 1 (where b > 1) all masked."""
    from cvo_rgbd_torch.core.cloud import kd_sort, stack_clouds

    xs, ys = [], []
    for i in range(b):
        x, _ = _clouds(dev, n=n - 100, cap=n, seed=seed + i)
        y, _ = _clouds(dev, n=m - 60, cap=m, seed=seed + 50 + i)
        if i == 1:
            x = x._replace(mask=torch.zeros_like(x.mask))
        xs.append(x)
        ys.append(y)
    return kd_sort(stack_clouds(xs)), kd_sort(stack_clouds(ys))


@pytest.mark.parametrize("n,m", [(1024, 1024), (512, 1152)])
@pytest.mark.parametrize("b", [1, 3, 9])
def test_batched_color_gram_kernel_matches_plain(dev, b, n, m):
    """One launch a batch: within 1e-6 of the plain version, every lane
    the bits of the one-pair launch on its pair, a masked lane zero."""
    from cvo_rgbd_torch.ops import gram
    from cvo_rgbd_torch.params import CvoParams

    x, y = _lane_clouds(dev, b, n, m)
    p = CvoParams()
    launches = gram.color_gram.launches
    ck = gram.color_gram(*x, *y, p=p)
    assert gram.color_gram.launches == launches + 1
    assert ck.shape == (b, n, m)
    scal = gram.scalars(torch.full((), p.ell_init, device=dev), p)
    ref = gram.color_gram_plain(x.features, x.mask, y.features, y.mask, scal)
    assert (ck - ref).abs().max().item() <= 1e-6
    for i in range(b):
        one = gram.color_gram(*x.lane(i), *y.lane(i), p=p)
        assert one.shape == (n, m) and torch.equal(ck[i], one)
    if b > 1:
        assert not ck[1].any() and ck[0].any()


def test_batched_color_gram_refuses_too_many_lanes(dev):
    from cvo_rgbd_torch.ops import gram

    f = torch.zeros((65536, 1, 5), device=dev)
    mask = torch.zeros((65536, 1), device=dev)
    scal = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="65535"):
        gram.color_gram_cuda(f, mask, f, mask, scal)


@pytest.mark.parametrize("algo", ["cvo", "acvo exact", "acvo cheb", "dense",
                                  "warm transposed"])
def test_align_batched_compiled_lanes_on_the_card(dev, algo):
    """align_batched on the kernel (and dense) backend: each lane the
    bits of `align` on its pair on the card (warm-started from a
    transposed view of R0 in the last case), one compiled loop for the
    batch (the slowest lane's graph replays; on the kernel backend one
    `fused_moments` launch a batch an iteration, exact acvo's one
    `fused_wsq` launch a batch an iteration, cheb's one for its tables),
    and one color_gram launch a cache a batch."""
    import math

    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.core import compiled
    from cvo_rgbd_torch.core.cloud import stack_clouds
    from cvo_rgbd_torch.ops import gram
    from cvo_rgbd_torch.parallel import align_batched

    stops = dict(eps=5e-4, eps_2=1e-4, max_iter=60)
    p = {"cvo": ct.CvoParams(**stops), "acvo exact": ct.AcvoParams(**stops),
         "acvo cheb": ct.AcvoParams(self_mode="cheb", **stops),
         "dense": ct.CvoParams(backend="dense", **stops),
         "warm transposed": ct.CvoParams(max_iter=59)}[algo]
    pairs = [_clouds(dev, n=2900, cap=3072, seed=20 + s) for s in range(3)]
    xs = stack_clouds([x for x, _ in pairs])
    ys = stack_clouds([y for _, y in pairs])
    warm = [None] * 3
    if algo == "warm transposed":
        R = ct.se3.exp_so3(torch.tensor(
            [[0.004, 0.0, -0.003], [0.0, 0.002, 0.0], [-0.002, 0.001, 0.003]],
            device=dev))
        warm = [R.transpose(1, 2).contiguous().transpose(1, 2),
                torch.full((3, 3), 0.002, device=dev),
                torch.full((3,), 0.1, device=dev)]
        assert warm[0][0].stride() == (1, 3)
    from cvo_rgbd_torch.ops import moments, wsq

    launches = gram.color_gram.launches
    wsq_launches = wsq.fused_wsq.launches
    lane_launches = moments.fused_moments.lanes.launches
    one_pair = moments.fused_moments.launches
    replays = compiled.align_jit.replays
    warmups = compiled.align_jit.warmups
    R0, T0, ell0 = warm
    res = align_batched(p, xs, ys, R0=R0, T0=T0, ell0=ell0)
    torch.cuda.synchronize()
    want = 0 if p.backend == "dense" else (3 if "acvo" in algo else 1)
    assert gram.color_gram.launches - launches == want
    blocks = [math.ceil((int(k) + 1) / 8) for k in res.iterations]
    replayed = compiled.align_jit.replays - replays
    assert replayed == max(blocks)
    # the captures' eager warm-up blocks launch too
    iters = 8 * replayed + compiled.align_jit.warmups - warmups
    if p.backend != "dense":
        assert moments.fused_moments.lanes.launches - lane_launches == iters
        assert moments.fused_moments.launches == one_pair
    assert wsq.fused_wsq.launches - wsq_launches == {
        "acvo exact": iters, "acvo cheb": 1}.get(algo, 0)
    # one compiled loop for the batch
    assert len([k for k in compiled.CACHE if k[0] == p and k[1:3] == (
        3072, 3072) and k[-1] == (3,)]) == 1
    for i, (x, y) in enumerate(pairs):
        ref = ct.align(p, x, y, *(None if w is None else w[i] for w in warm))
        for f in _JIT_FIELDS:
            assert torch.equal(getattr(res, f)[i], getattr(ref, f)), (i, f)


@pytest.mark.parametrize("mode", ["ck skip", "no ck", "no skip", "fast",
                                  "cheb"])
def test_fused_wsq_lanes_are_one_pair_launches(dev, mode):
    """fused_wsq on a lane axis: one launch for the sweeps of three lanes
    (an exact acvo batch iteration's two; cheb: a batch's 2K = 24 table
    sweeps, an ell a lane and a sweep), each (lane, sweep) the bits of
    the lane's one-pair launch and within 1e-4 of its plain version (nnz
    exact; fast: within the near-gate pairs), a frozen lane zeros and
    the others unchanged."""
    from cvo_rgbd_torch.core import registration as treg
    from cvo_rgbd_torch.core.cloud import stack_clouds
    from cvo_rgbd_torch.ops import gram, moments, wsq
    from cvo_rgbd_torch.params import AcvoParams

    fast = mode == "fast"
    p = AcvoParams(exp_mode="fast" if fast else "precise",
                   ck_cache=mode != "no ck", tile_skip=mode != "no skip")
    pairs = [_clouds(dev, seed=60 + s) for s in range(3)]
    x = stack_clouds([a for a, _ in pairs])
    y = stack_clouds([b for _, b in pairs])
    pre = treg.prepare_batch(p, x, y, [None] * 3)
    sweeps = treg._self_sweeps(x, tuple(y), pre.ck, pre.skip)
    ell = torch.tensor([0.1, 0.06, 0.0391], device=dev)
    if mode == "cheb":
        sweeps = sweeps * 12
        ell = ell[:, None] * torch.linspace(0.5, 1.5, 24, device=dev)
    scal = gram.scalars(ell, p)
    before = wsq.fused_wsq.launches
    w, n = wsq.fused_wsq_sweeps_cuda(sweeps, scal, fast)
    torch.cuda.synchronize()
    assert wsq.fused_wsq.launches == before + 1
    assert w.shape == n.shape == (3, len(sweeps))
    ref_w, ref_n = wsq.fused_wsq_sweeps_plain(sweeps, scal, fast)
    for b in range(3):
        lane = [wsq.lane_sweep(sw, b) for sw in sweeps]
        w1, n1 = wsq.fused_wsq_sweeps_cuda(lane, scal[b], fast)
        assert torch.equal(_bits(w[b]), _bits(w1))
        assert torch.equal(_bits(n[b]), _bits(n1))
        assert ((w[b] - ref_w[b]).abs() <= 1e-4 * ref_w[b].abs()).all()
        for k, sw in enumerate(lane):
            row = scal[b] if scal.dim() == 2 else scal[b, k]
            near = (moments.near_gate_pairs(*sw.x, *sw.y, row, sw.ck)
                    if fast else 0)
            assert abs(float(n[b, k]) - float(ref_n[b, k])) <= near
            assert float(n[b, k]) > 0
    live = torch.tensor([True, False, True], device=dev)
    wl, nl = wsq.fused_wsq_sweeps_cuda(sweeps, scal, fast, live)
    assert not wl[1].any() and not nl[1].any()
    assert torch.equal(wl[0::2], w[0::2]) and torch.equal(nl[0::2], n[0::2])


@pytest.mark.parametrize("mode", ["ck", "no ck", "linear", "fast"])
def test_batched_fused_moments_lanes_are_one_pair_launches(dev, mode):
    """fused_moments on a lane axis (one launch, counted apart from the
    one-pair launches): every lane the bits of the one-pair launch on it
    and within 1e-4 of its plain version (nnz exact; fast: within the
    near-gate pairs), a frozen lane zeros and the others unchanged."""
    from cvo_rgbd_torch.core.cloud import (
        aabb_min_d2,
        block_bounds,
        stack_clouds,
    )
    from cvo_rgbd_torch.core.registration import build_moments_pre
    from cvo_rgbd_torch.ops import gram, moments
    from cvo_rgbd_torch.params import MATLAB_PARAMS, CvoParams

    linear = mode == "linear"
    p = MATLAB_PARAMS if linear else CvoParams(
        exp_mode="fast" if mode == "fast" else "precise")
    xs, ys, cks = [], [], []
    for s in range(3):
        if linear:
            x, y, ci = _linear_clouds(dev, seed=40 + s)
            x, y = _padded(x), _padded(y)
        else:
            x, y = _clouds(dev, seed=40 + s)
            ci = gram.color_gram(*x, *y, p=p)
        xs.append(x)
        ys.append(y)
        cks.append(ci)
    x, y = stack_clouds(xs), stack_clouds(ys)
    ck = torch.stack(cks) if mode != "no ck" else None
    c0 = torch.stack([build_moments_pre(c)[0] for c in xs])
    phi = torch.stack([build_moments_pre(c)[2] for c in xs])
    xc = x.positions - c0[:, None, :]
    yc = y.positions - c0[:, None, :]
    md = aabb_min_d2(*block_bounds(x.positions, x.mask, moments.TILE_I),
                     *block_bounds(y.positions, y.mask, moments.TILE_J))
    scal = gram.scalars(torch.tensor([0.1, 0.06, 0.03], device=dev), p)
    args = (xc, x.features, x.mask, yc, y.features, y.mask, phi, scal)
    kw = dict(linear=linear, fast=mode == "fast")
    lanes0 = moments.fused_moments.lanes.launches
    one0 = moments.fused_moments.launches
    mom, nnz = moments.fused_moments_cuda(*args, ck, md, **kw)
    torch.cuda.synchronize()
    assert moments.fused_moments.lanes.launches == lanes0 + 1
    assert moments.fused_moments.launches == one0
    for i in range(3):
        lane = tuple(a[i] for a in args)
        ck_i = None if ck is None else ck[i]
        one, one_nnz = moments.fused_moments_cuda(*lane, ck_i, md[i], **kw)
        assert torch.equal(mom[i], one) and float(nnz[i]) == float(one_nnz)
        ref, ref_nnz = moments.fused_moments_plain(*lane, ck_i, md[i], **kw)
        scale = ref.abs().amax(dim=0).clamp_min(1e-30)
        assert ((mom[i] - ref).abs() / scale).max().item() <= 1e-4
        if mode == "fast":
            near = moments.near_gate_pairs(*lane[:6], lane[7], ck_i)
            assert abs(float(nnz[i]) - float(ref_nnz)) <= near
        else:
            assert float(nnz[i]) == float(ref_nnz) > 0
    live = torch.tensor([True, False, True], device=dev)
    part, part_nnz = moments.fused_moments_cuda(*args, ck, md, live=live,
                                                **kw)
    assert not part[1].any() and float(part_nnz[1]) == 0.0
    for i in (0, 2):
        assert torch.equal(part[i], mom[i])
        assert float(part_nnz[i]) == float(nnz[i])


def _kept_lanes(dev, lanes=9):
    """`lanes` pairs at 1024 whose tiles are mostly kept at ell 0.3-0.5
    (the batch regime of the two sweeps on a lane axis)."""
    from cvo_rgbd_torch.core.cloud import stack_clouds

    pairs = [_clouds(dev, seed=80 + s) for s in range(lanes)]
    return (stack_clouds([a for a, _ in pairs]),
            stack_clouds([b for _, b in pairs]),
            torch.linspace(0.3, 0.5, lanes, device=dev))


@pytest.mark.parametrize("exp_mode", ["precise", "fast"])
@pytest.mark.parametrize("kernel", ["fused_moments", "fused_wsq"])
def test_lanes_where_most_tiles_are_kept_are_one_pair_launches(
        dev, kernel, exp_mode):
    """Nine lanes at length-scales where most tiles are kept: one launch,
    each live lane the bits of its one-pair launch, a frozen lane not
    swept (zeros) and the others unchanged by it."""
    from cvo_rgbd_torch.core import registration as treg
    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
    from cvo_rgbd_torch.ops import gram, moments, wsq
    from cvo_rgbd_torch.params import AcvoParams, CvoParams

    fast = exp_mode == "fast"
    x, y, ell = _kept_lanes(dev)
    b = ell.numel()
    live = torch.ones(b, dtype=torch.bool, device=dev)
    live[4] = False
    if kernel == "fused_moments":
        p = CvoParams(exp_mode=exp_mode)
        pre = treg.prepare_batch(p, x, y, [None] * b)
        c0, xc, phi = pre.moments
        md = aabb_min_d2(*pre.skip[:2],
                         *block_bounds(y.positions, y.mask, moments.TILE_J))
        scal = gram.scalars(ell, p)
        keep = md <= scal[:, gram.S_D2_THRES, None, None] + \
            moments.SKIP_MARGIN
        assert keep.float().mean().item() > 0.5
        args = (xc, x.features, x.mask, y.positions - c0[:, None, :],
                y.features, y.mask, phi, scal, pre.ck[0], md)
        before = moments.fused_moments.lanes.launches
        out = moments.fused_moments_cuda(*args, False, fast)
        frozen = moments.fused_moments_cuda(*args, False, fast, live)
        assert moments.fused_moments.lanes.launches == before + 2

        def one(i):
            return moments.fused_moments_cuda(*(a[i] for a in args), False,
                                              fast)
    else:
        p = AcvoParams(exp_mode=exp_mode)
        pre = treg.prepare_batch(p, x, y, [None] * b)
        sweeps = treg._self_sweeps(x, tuple(y), pre.ck, pre.skip)
        scal = gram.scalars(ell, p)
        kept = [wsq.kept_prefix(sw.tiles.sorted[i],
                                scal[i, gram.S_D2_THRES].item()
                                + moments.SKIP_MARGIN)
                for i in range(b) for sw in sweeps]
        assert sum(kept) > 0.5 * b * sum(wsq._swept_tiles(sw)
                                         for sw in sweeps)
        before = wsq.fused_wsq.launches
        out = wsq.fused_wsq_sweeps_cuda(sweeps, scal, fast)
        frozen = wsq.fused_wsq_sweeps_cuda(sweeps, scal, fast, live)
        assert wsq.fused_wsq.launches == before + 2

        def one(i):
            return wsq.fused_wsq_sweeps_cuda(
                [wsq.lane_sweep(sw, i) for sw in sweeps], scal[i], fast)
    torch.cuda.synchronize()
    for i in range(b):
        single = one(i)
        for got, want, part in zip(out, single, frozen):
            assert torch.equal(_bits(got[i]), _bits(want)), i
            if i == 4:
                assert not part[i].any()
            else:
                assert torch.equal(_bits(part[i]), _bits(got[i])), i


def test_fused_wsq_runs_split_over_blocks_keep_the_bits(dev, monkeypatch):
    """A launch's bits do not depend on how its kept tiles fall into the
    blocks' runs: nine lanes' two self-sweeps on a grid of one block an
    SM (each unit's tiles over several blocks, a block over the end of
    one unit and the start of the next), of the rule's and of a block a
    tile, every lane the bits of its one-pair launch."""
    from cvo_rgbd_torch.core import registration as treg
    from cvo_rgbd_torch.ops import gram, moments, wsq
    from cvo_rgbd_torch.params import AcvoParams

    x, y, ell = _kept_lanes(dev)
    b = ell.numel()
    p = AcvoParams()
    pre = treg.prepare_batch(p, x, y, [None] * b)
    sweeps = treg._self_sweeps(x, tuple(y), pre.ck, pre.skip)
    scal = gram.scalars(ell, p)
    kept = [wsq.kept_prefix(sw.tiles.sorted[i],
                            scal[i, gram.S_D2_THRES].item()
                            + moments.SKIP_MARGIN)
            for i in range(b) for sw in sweeps]
    swept = b * sum(wsq._swept_tiles(sw) for sw in sweeps)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    singles = [wsq.fused_wsq_sweeps_cuda(
        [wsq.lane_sweep(sw, i) for sw in sweeps], scal[i]) for i in range(b)]
    outs = []
    for per_sm in (1, wsq.BLOCKS_PER_SM, swept):
        monkeypatch.setattr(wsq, "BLOCKS_PER_SM", per_sm)
        runs = wsq.block_runs(kept, wsq.persistent_grid(swept, sms))
        if per_sm == 1:
            spans = [sum(any(u == k for k, _, _ in block) for block in runs)
                     for u in range(len(kept))]
            assert max(spans) > 1 and any(len(block) > 1 for block in runs)
        outs.append(wsq.fused_wsq_sweeps_cuda(sweeps, scal))
    torch.cuda.synchronize()
    for w, n in outs:
        assert torch.equal(_bits(w), _bits(outs[0][0]))
        assert torch.equal(_bits(n), _bits(outs[0][1]))
    for i, (w1, n1) in enumerate(singles):
        assert torch.equal(_bits(outs[0][0][i]), _bits(w1)), i
        assert torch.equal(_bits(outs[0][1][i]), _bits(n1)), i


# ---- the compiled frontend and the odometry step's bookkeeping ---------------

_FRONTEND_SIZES = [(240, 320), (480, 640)]


@pytest.fixture(scope="module")
def frontend_frames():
    """Two frames of the revisit path at 240x320 and at TUM's 480x640, as
    the PNG loader gives them (uint8 RGB, uint16 depth)."""
    from cvo_rgbd_torch import synth

    return {size: [(f[2].astype(np.uint8), f[3].astype(np.uint16))
                   for f in synth.render_frames(
                       synth.revisit_path(2, period=33),
                       synth.BandScene(*size))]
            for size in _FRONTEND_SIZES}


def _sha1s(cloud):
    import hashlib

    return [hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()
            for t in cloud]


def _eager_frontend(dev, rgb, dep, feature_type, bgr_quirk=False):
    """`_process` op by op on the card, after a host-side float32
    conversion."""
    from cvo_rgbd_torch.frontend.camera import get_camera
    from cvo_rgbd_torch.frontend.pipeline import _process

    return _process(torch.as_tensor(rgb, dtype=torch.float32).to(dev),
                    torch.as_tensor(dep, dtype=torch.float32).to(dev),
                    cam=get_camera(1), num_want=3000,
                    feature_type=feature_type, dep_thres=20000.0, pot=3,
                    bgr_quirk=bgr_quirk)


@pytest.mark.parametrize("inputs", ["raw", "float32", "holes"])
@pytest.mark.parametrize("feature_type,bgr_quirk",
                         [(1, False), (0, False), (1, True), (0, True)])
@pytest.mark.parametrize("size", _FRONTEND_SIZES)
def test_frontend_jit_has_the_bits_of_process_on_the_card(
        dev, frontend_frames, size, feature_type, bgr_quirk, inputs):
    """The compiled processor's clouds at num_want 3000 have the SHA-1 of
    `_process` op by op, on uint8/uint16 and float32 frames and on a
    frame with zero and NaN depth; one graph replay a frame."""
    from cvo_rgbd_torch.frontend import make_frontend

    fe = make_frontend(1, 3000, feature_type, bgr_quirk=bgr_quirk,
                       device="cuda")
    for rgb, dep in frontend_frames[size]:
        if inputs != "raw":
            rgb, dep = rgb.astype(np.float32), dep.astype(np.float32)
        if inputs == "holes":
            h, w = dep.shape
            dep[h // 8:h // 4, w // 8:w // 2] = 0.0
            dep[h // 2:h // 2 + h // 8, w // 4:w // 2] = np.nan
        replays = fe.replays
        got = fe(rgb, dep)
        assert fe.replays == replays + 1
        ref = _eager_frontend(dev, rgb, dep, feature_type, bgr_quirk)
        assert _sha1s(got) == _sha1s(ref)
        assert got.positions.is_cuda and got.capacity == 3072
        assert int(got.mask.sum()) > 1000


def test_frontend_jit_is_one_replay_a_frame_on_the_card(dev,
                                                        frontend_frames):
    """Once built, a frame is one graph launch beside its copies in and
    its one copy out: no kernel launch of its own, and the clouds keep
    their own storage."""
    from torch.profiler import ProfilerActivity, profile

    from cvo_rgbd_torch.frontend import make_frontend

    fe = make_frontend(1, 3000, 1, device="cuda")
    frames = frontend_frames[(480, 640)]
    first = fe(*frames[0])
    kept = [t.clone() for t in first]
    fe(*frames[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        clouds = [fe(*f) for f in frames * 2]
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()}
    assert calls.get("cudaGraphLaunch") == 4
    assert not calls.get("cudaLaunchKernel")
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert _sha1s(clouds[0]) == _sha1s(clouds[2]) == _sha1s(first)


def test_frontend_jit_raises_when_capture_fails(dev, frontend_frames,
                                                monkeypatch):
    """A frontend whose body reads the card from the host cannot be
    captured: the call raises with the config and the input key, and
    nothing runs op by op instead."""
    from cvo_rgbd_torch.frontend import pipeline
    from cvo_rgbd_torch.frontend.camera import get_camera

    real = pipeline._process

    def with_host_read(rgb, depth, **kw):
        float(depth.sum().item())
        return real(rgb, depth, **kw)

    monkeypatch.setattr(pipeline, "_process", with_host_read)
    fe = pipeline.Frontend(1, get_camera(1), dict(
        num_want=3000, feature_type=1, dep_thres=20000.0, pot=3,
        bgr_quirk=False), dev)
    with pytest.raises(RuntimeError,
                       match=r"capturing the frontend of camera 1 .*"
                       r"'num_want': 3000.*\(480, 640, 3\)"):
        fe(*frontend_frames[(480, 640)][0])
    assert fe.replays == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("backend", ["kernel", "fused"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_frontend_jit_odometry_on_the_card(dev, frontend_frames, monkeypatch,
                                           backend, adaptive):
    """`run_odometry_frames` at 240x320: the compiled frontend's and the
    compiled bookkeeping's trajectory is the eager frontend's, one
    bookkeeping replay a pair, and each step's packed row and warm state
    the eager bookkeeping's bits."""
    import dataclasses
    import io

    from cvo_rgbd_torch import odometry
    from cvo_rgbd_torch.params import AcvoParams, CvoParams

    p = dataclasses.replace(AcvoParams() if adaptive else CvoParams(),
                            backend=backend)
    ft = 0 if adaptive else 1
    pair = frontend_frames[(240, 320)]
    frames = [(i, f"{i}", *pair[i % 2]) for i in range(4)]

    def run():
        traj = io.StringIO()
        recs = odometry.run_odometry_frames(
            frames, 1, adaptive=adaptive, params=p, traj=traj,
            log=lambda *a: None)
        return traj.getvalue(), recs

    runs0 = {k: v.runs for k, v in odometry.STEP_CACHE.items()}
    got, recs = run()
    stepped = sum(v.runs - runs0.get(k, 0)
                  for k, v in odometry.STEP_CACHE.items())
    assert stepped == len(recs) == 3
    assert not any(r.failed for r in recs)

    def eager_make_frontend(*a, **kw):
        return lambda rgb, dep: _eager_frontend(dev, rgb, dep, ft)

    with monkeypatch.context() as m:
        m.setattr(odometry, "make_frontend", eager_make_frontend)
        ref, _ = run()
    assert got == ref

    # the bookkeeping's bits against the eager ops on one real pair
    x, y = (_eager_frontend(dev, *f, ft) for f in pair)
    warm = (torch.eye(3, device=dev), torch.zeros(3, device=dev),
            torch.full((), p.ell_init, device=dev))
    res = odometry.align_jit(p, x, y, *warm)
    flat = odometry._bookkeeping(p, adaptive, 64, res.tf, res.R, res.T,
                                 res.ell, res.iterations, res.converged,
                                 x.positions, x.mask, y.positions, y.mask)
    monkeypatch.setattr(odometry, "align_jit", lambda *a, **k: res)
    packed, nxt = odometry._odom_step(p, adaptive, x, y, warm, 64, dev)
    torch.cuda.synchronize()
    assert torch.equal(packed, flat[:19])
    for a, b in zip(nxt, (flat[32:41].view(3, 3), flat[48:51], flat[64])):
        assert torch.equal(a, b)


# ---- cli slam's compiled forms: the inner products, cloud_ok, the SLAM step,
# the pose-graph and BA solves, multiseq's lane post


def _pcd_like_clouds(dev, k=3, cap=512, seed=21):
    """k clouds in MATLAB's linear mode (3 colour features, 0..255), each
    a shifted copy of one random cloud."""
    from cvo_rgbd_torch import pad_cloud

    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((400, 3)) * 0.4 + np.array([0, 0, 2.0])
    feat = rng.random((400, 3)) * 255.0
    return [pad_cloud(pos + np.array([0.03, -0.01, 0.02]) * q, feat, cap,
                      device=dev) for q in range(k)]


def _graph_runs(fn, graphs, kernels=0):
    """fn() under torch.profiler, which must launch `graphs` CUDA graphs
    and at most `kernels` kernels of its own (a stack, a fill) beside its
    copies."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()}
    assert calls.get("cudaGraphLaunch") == graphs, calls
    assert calls.get("cudaLaunchKernel", 0) <= kernels, calls
    return out


@pytest.mark.parametrize("mode", ["linear", "se"])
def test_inner_product_programs_have_the_eager_bits_on_the_card(dev, mode):
    """Each inner product's program (self, cross, under a transform) is
    one graph replay with the SHA-1 of `function_inner_product` op by
    op; the loop-closure scores are a replay a candidate."""
    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch import keyframes as kf
    from cvo_rgbd_torch.core.registration import function_inner_product

    if mode == "linear":
        p, clouds = ct.MATLAB_PARAMS, _pcd_like_clouds(dev, 4)
    else:
        p, clouds = ct.AcvoParams(), list(_clouds(dev)) + list(
            _clouds(dev, seed=1))
    a, b = clouds[:2]
    for x, y in ((a, b), (a, a), (b, a)):
        kf.inner_product_async(p, x, y)   # built and captured
        got = _graph_runs(lambda: kf.inner_product_async(p, x, y), 1)
        assert _sha1s([got]) == _sha1s([function_inner_product(p, x, y)])
    tfs = torch.eye(4, device=dev).repeat(3, 1, 1)
    tfs[1, :3, 3] = torch.tensor([0.02, 0.0, -0.01], device=dev)
    tfs[2, :3, :3] = ct.se3.exp_so3(torch.tensor([0.01, -0.02, 0.005],
                                                 device=dev))
    kf.aligned_fip(p, a, b, tfs)
    got = _graph_runs(lambda: kf.aligned_fip(p, a, b, tfs), 3, kernels=1)
    for q in range(3):
        moved = b._replace(positions=b.positions @ tfs[q, :3, :3].T
                           + tfs[q, :3, 3])
        assert _sha1s([got[q]]) == _sha1s([function_inner_product(
            p, a, moved)])
    selfs = [float(function_inner_product(p, c, c)) for c in clouds]
    scores = kf.keyframe_scores_batched(p, clouds[1:], clouds[0], selfs[1:],
                                        selfs[0])
    cross = np.array([float(function_inner_product(p, c, clouds[0]))
                      for c in clouds[1:]])
    assert np.array_equal(scores, (cross / np.sqrt(
        np.asarray(selfs[1:]) * selfs[0] + 1e-30)).astype(np.float32))


def test_slam_step_and_cloud_ok_programs_have_the_eager_bits_on_the_card(
        dev):
    """`_compiled_cloud_ok` and the SLAM step's program after align
    (`_step_post`) against the same functions op by op, a good frame and
    a degenerate one."""
    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch import slam
    from cvo_rgbd_torch.core.cloud import cloud_ok

    p = ct.MATLAB_PARAMS
    key, cloud = _pcd_like_clouds(dev, 2)
    empty = cloud._replace(mask=torch.zeros_like(cloud.mask))
    warm = (torch.eye(3, device=dev), torch.zeros(3, device=dev),
            torch.full((), p.ell_init, device=dev))
    for frame in (cloud, empty):
        assert torch.equal(slam._compiled_cloud_ok(frame, 64),
                           cloud_ok(frame, 64))
        res = slam.align_jit(p, key, frame, *warm)
        got = slam._slam_step(p, key, frame, warm, 64, dev)
        ref = slam._step_post(p, 64, res.tf, res.R, res.T, *key, *frame)
        assert _sha1s(got[1:]) == _sha1s(ref)
        assert bool(got[1]) == (frame is cloud)


def _eager_posegraph(graph, solver, iters, cg_iters, kw, damping=1e-6):
    from cvo_rgbd_torch.core import posegraph

    nodes, costs = graph.nodes, []
    for k in range(iters):
        if solver == "dense":
            nodes, cost = posegraph._gn_step_dense(
                graph, nodes, damping, kw["huber_delta"], kw["robust"], k,
                kw["robust_warmup"])
        else:
            nodes, cost = posegraph._gn_step_pcg(
                graph, nodes, damping, cg_iters, kw["huber_delta"],
                kw["robust"], k, kw["robust_warmup"])
        costs.append(cost)
    return nodes, torch.stack(costs)


@pytest.mark.parametrize("loops", [1, 2])
@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_optimize_is_captured_with_the_ex_algebra_on_the_card(dev, solver,
                                                              loops):
    """`optimize` without a mesh captures its GN iteration (the `_ex`
    solve and inverses inside) and replays it: a later call is `iters`
    graph launches and one kernel launch (the slot's reset).  With one
    loop edge (0, 20) every scatter-add sum takes at most two terms onto
    a zero base, so the card's atomics sum it in any order to the same
    bits: the eager loop's bits.  With a second loop edge (2, 15) node
    15's sums take two terms onto a written base, whose order varies
    from run to run, eager or captured: within 2e-4 (costs 1e-3)."""
    from cvo_rgbd_torch.core import posegraph

    rng = np.random.default_rng(4)
    poses = [np.eye(4)]
    for _ in range(20):
        step = np.eye(4)
        step[:3, 3] = [0.2, 0.0, 0.01]
        poses.append(poses[-1] @ step)
    noisy = [q.copy() for q in poses]
    for k, q in enumerate(noisy):
        q[:3, 3] += rng.normal(0.0, 0.01 * k ** 0.5, 3)
    edges = [(0, 20), (2, 15)][:loops]
    graph = posegraph.from_odometry(noisy, [
        (i, j, np.linalg.inv(poses[i]) @ poses[j], 5.0) for i, j in edges],
        device=dev)
    kw = dict(huber_delta=0.3, robust="cauchy", robust_warmup=3)
    first = posegraph.optimize(graph, iters=9, solver=solver, cg_iters=64,
                               **kw)
    later = _graph_runs(lambda: posegraph.optimize(
        graph, iters=9, solver=solver, cg_iters=64, **kw), 9, kernels=1)
    eager = _eager_posegraph(graph, solver, 9, 64, kw)
    for got in (first, later):
        if loops == 1:
            assert all(torch.equal(a, b) for a, b in zip(got, eager))
        assert (got[0] - eager[0]).abs().max().item() <= 2e-4
        assert torch.allclose(got[1], eager[1], rtol=1e-3, atol=1e-6)


def test_ba_solve_is_captured_with_the_ex_algebra_on_the_card(dev):
    """`ba_solve` without a mesh: a later call is `iters` graph launches
    and no kernel launch, against `_solve_local` op by op within
    tests/test_torch_ba.py's tolerances (atomic scatter-adds)."""
    from cvo_rgbd_torch.parallel import ba

    problem = _ba_problem(0.005, False, dev)
    first = ba.ba_solve(problem, iters=6, device=dev)
    later = _graph_runs(lambda: ba.ba_solve(problem, iters=6, device=dev), 6,
                        kernels=1)
    eager = ba._solve_local(problem, 6, 1e-4, 48)
    for got in (first, later):
        for a, b in zip(got[:2], eager[:2]):
            assert (a - b).abs().max().item() <= 1e-4
        assert torch.allclose(got[2], eager[2], rtol=1e-3, atol=1e-7)


def test_lane_post_program_has_the_eager_bits_on_the_card(dev):
    from types import SimpleNamespace

    from cvo_rgbd_torch import multiseq
    from cvo_rgbd_torch.core.cloud import stack_clouds

    clouds = _pcd_like_clouds(dev, 4)
    fixed = stack_clouds(clouds)
    moving = stack_clouds(clouds[1:] + [clouds[0]._replace(
        mask=torch.zeros_like(clouds[0].mask))])
    rng = np.random.default_rng(5)
    tf = torch.eye(4, device=dev).repeat(4, 1, 1)
    tf[:, :3, 3] = torch.tensor(rng.normal(0, 0.1, (4, 3)),
                                dtype=torch.float32, device=dev)
    tf[1, 0, 0] = float("nan")
    res = SimpleNamespace(tf=tf, R=tf[:, :3, :3].clone(),
                          T=tf[:, :3, 3].clone(),
                          ell=torch.tensor([0.05, 0.06, 0.07, 0.08],
                                           device=dev))
    for adaptive in (False, True):
        multiseq.lane_post(res, fixed, moving, adaptive, 0.1, 64)
        got = _graph_runs(lambda: multiseq.lane_post(
            res, fixed, moving, adaptive, 0.1, 64), 1)
        ref = multiseq._lane_post(adaptive, 0.1, 64, res.tf, res.R, res.T,
                                  res.ell, fixed.positions, fixed.mask,
                                  moving.positions, moving.mask)
        assert _sha1s(got) == _sha1s(ref)
        assert got[0].tolist() == [True, False, True, False]


def test_captures_with_a_host_sync_raise_on_the_card(dev, monkeypatch):
    """A program or a GN iteration whose body reads the card from the
    host cannot be captured: the call raises and nothing runs op by op
    in its place."""
    import dataclasses

    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch import keyframes as kf
    from cvo_rgbd_torch.core import posegraph

    p = dataclasses.replace(ct.MATLAB_PARAMS, ell_init=0.0917)
    a, b = _pcd_like_clouds(dev, 2)
    real = kf._FORMS["cross"]

    def with_host_read(*args):
        out = real(*args)
        float(out.item())
        return out

    monkeypatch.setitem(kf._FORMS, "cross", with_host_read)
    with pytest.raises(RuntimeError,
                       match=r"capturing the cross inner product .*failed"):
        kf.inner_product_async(p, a, b)
    monkeypatch.undo()

    real_step = posegraph._gn_step_dense

    def step_with_host_read(*args):
        nodes, cost = real_step(*args)
        float(cost.item())
        return nodes, cost

    monkeypatch.setattr(posegraph, "_gn_step_dense", step_with_host_read)
    graph = posegraph.from_odometry(np.stack([np.eye(4)] * 3), device=dev)
    with pytest.raises(RuntimeError, match=r"capturing the dense pose-graph"):
        posegraph.optimize(graph, iters=3, solver="dense", damping=3.3e-6)
    torch.cuda.synchronize()
