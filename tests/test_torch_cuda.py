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
    of the kernel (row items, moment chunks, columns, both self
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
    runs resident; the kernel pads it to whole row items with masked
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


@pytest.mark.parametrize("case", ["a", "b", "b2", "c", "d", "e", "h", "i",
                                  "j", "k"])
def test_construct_probe_kernel_matches_plain(dev, case):
    from cvo_rgbd_torch import probes

    ins = probes.inputs(case, dev)
    launches = probes.construct_probe.launches
    got = probes.construct_probe(case, *ins)
    assert probes.construct_probe.launches == launches + 1
    ref = probes.construct_probe_plain(case, *ins)
    if case == "e":
        # fp32 sums of 256 products in another order
        assert (got - ref).abs().max().item() <= 1e-6 * probes.CLOSED["e"]
    else:
        assert torch.equal(got, ref)
    assert probes.closed_form_ok(case, got[0, 0].item())


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


@pytest.mark.parametrize("lanes", [1, 9, 63])
def test_align_fused_lane_bits_at_any_lane_count(dev, lanes):
    """A batch of `lanes` copies of three pairs (tiled linear, 1152):
    every lane the bits of its pair's one-pair launch."""
    import dataclasses

    import cvo_rgbd_torch as ct
    from cvo_rgbd_torch.core.cloud import stack_clouds
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_batched_cuda,
        align_fused_cuda,
    )

    pairs = [_linear_clouds(dev, n=1100, cap=1152, seed=s)[:2]
             for s in (6, 7, 8)]
    pairs = [(_padded(x), _padded(y)) for x, y in pairs]
    p = dataclasses.replace(ct.MATLAB_PARAMS, backend="fused", max_iter=12,
                            eps=0.0, eps_2=0.0)
    order = [k % 3 for k in range(lanes)]
    rows = align_fused_batched_cuda(
        p, *(stack_clouds([pairs[k][side] for k in order]) for side in (0, 1)))
    single = [align_fused_cuda(p, x, y) for x, y in pairs]
    for lane, k in enumerate(order):
        assert torch.equal(rows[lane], single[k]), lane


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
