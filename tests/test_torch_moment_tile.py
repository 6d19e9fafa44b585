"""The moment sweep of `csrc/moment_tile.cuh` on the CPU: the work split
and scratch shapes of `ops/moments.py` and `ops/align_fused.py`, the
float64 option of `align_fused_plain`, and the two tensor-core forms of
the contraction that were measured on the card before the kernel kept
its float32 multiply-adds, emulated in torch against float64 A^T Phi.

3xTF32: hi = tf32(v), lo = tf32(v - hi) (cvt.rna: 10 mantissa bits, ties
away from zero), A_lo Phi_hi + A_hi Phi_lo + A_hi Phi_hi in fp32.
float64 steps: each 8-row step's products summed in float64, rounded to
float32 and added to float32 sums.  Both hold every column far inside
the kernel's 1e-4 gate; on the card the align loop amplified their
difference from the float32 sums past the 10-iteration and C++-stop
gates (PERF.md §6).  Card runs hold the kernel itself to its plain
version (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses
import importlib.util
import os
import tempfile

import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds, kd_sort
from cvo_rgbd_torch.core.registration import build_moments_pre
from cvo_rgbd_torch.frontend import make_frontend
from cvo_rgbd_torch.ops import gram, moments
from cvo_rgbd_torch.ops.align_fused import align_fused_plain, lane_scratch
from cvo_rgbd_torch.ops.gram import pad_feat
from cvo_rgbd_torch.params import MATLAB_PARAMS
from cvo_rgbd_torch.synth import BandScene, render_frames, revisit_path

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
# 2e-6 of a column's magnitude leaves the kernel's 1e-4 gate a margin of
# 50x; the float64 steps round once a step and stay at float32's own
# level, within 1e-6
SPLIT_TOL = 2e-6
STEP_TOL = 1e-6


def _tf32(v):
    """cvt.rna.tf32.f32: round the fp32 magnitude to 10 mantissa bits,
    half away from zero, on the bit pattern."""
    u = v.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _mom_3xtf32(A, phi):
    """A^T Phi in 3xTF32: the three tf32 products (exact in fp32), small
    terms first, summed in fp32."""
    ah, ph = _tf32(A), _tf32(phi)
    al, pl = _tf32(A - ah), _tf32(phi - ph)
    return al.T @ ph + ah.T @ pl + ah.T @ ph


def _mom_f64_steps(A, phi):
    """A^T Phi in float64 steps: each 8-row step's products summed in
    float64, rounded to float32 and added to float32 sums in row order."""
    steps = (A.double().reshape(-1, 8, A.shape[1]).transpose(1, 2)
             @ phi.double().reshape(-1, 8, phi.shape[1])).float()
    acc = torch.zeros(A.shape[1], phi.shape[1])
    for s in steps:
        acc = acc + s
    return acc


def _errors(A, phi):
    """(float64 steps, 3xTF32, fp32) error of A^T Phi against float64,
    each over each column's magnitude."""
    ref = A.double().T @ phi.double()
    col = ref.abs().amax(dim=0).clamp_min(1e-30)
    return tuple(((got.double() - ref).abs() / col).max().item()
                 for got in (_mom_f64_steps(A, phi), _mom_3xtf32(A, phi),
                             A.T @ phi))


def _kept(A, md, scal):
    """A with the tiles the exact AABB skip drops set to zero."""
    keep = md <= scal[gram.S_D2_THRES] + moments.SKIP_MARGIN
    keep = keep.repeat_interleave(moments.TILE_I, 0).repeat_interleave(
        moments.TILE_J, 1)
    return torch.where(keep, A, 0.0)


def _bounds(x, y):
    return aabb_min_d2(*block_bounds(x.positions, x.mask, moments.TILE_I),
                       *block_bounds(y.positions, y.mask, moments.TILE_J))


@pytest.fixture(scope="module")
def render_pair():
    """The kd-sorted cvo clouds of the 3072 render's first pair, as
    chip_smoke.py's phase 3 takes them."""
    fe = make_frontend(1, 3000, 1, device="cpu")
    frames = render_frames(revisit_path(2, period=33), BandScene(240, 320))
    return [kd_sort(fe(f[2], f[3])) for f in frames]


@pytest.fixture(scope="module")
def pcd_pair():
    """chip_smoke.py's linear pcd pair at the 0.015 m grid (N=M=2816):
    the 10 frames written as .pcd and loaded, the set padded to one
    capacity, kd-sorted, its masked CI and the features padded to 5."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    scene = BandScene(*smoke.SIZE)
    frames = list(render_frames(revisit_path(smoke.FRAMES, period=33), scene))
    with tempfile.TemporaryDirectory() as root:
        sets = smoke.pcd_sets(frames, root, scene.cam)
    return smoke.linear_pair(sets[smoke.FINE_GRID], torch.device("cpu"))


def test_tf32_rounding_is_cvt_rna():
    """10 mantissa bits kept, ties away from zero, either sign."""
    one_ulp = 2.0 ** -10
    v = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 2 - 2.0 ** -23, 3.0, 0.0])
    got = _tf32(v)
    assert got.tolist() == [1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0, 0.0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    hi = _tf32(x)
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("ell", [0.1, 0.03])
def test_contraction_holds_the_render_moments(render_pair, ell):
    """se mode with the ck cache and the tile skip (chip_smoke.py's
    phase 3 at both ell of the C++ schedule)."""
    x, y = render_pair
    p = ct.CvoParams()
    ck = gram.color_gram(*x, *y, p=p)
    c0, xc, phi = build_moments_pre(x)
    yc = y.positions - c0
    scal = gram.scalars(torch.full((), ell), p)
    A = _kept(moments.pair_weights(xc, x.features, x.mask, yc, y.features,
                                   y.mask, scal, ck), _bounds(x, y), scal)
    assert int((A > 0).sum()) > 1000
    step, split, fp32 = _errors(A, phi)
    assert step <= STEP_TOL and split <= SPLIT_TOL, (step, split, fp32)


@pytest.mark.parametrize("ell", [0.1, 0.03])
def test_contraction_holds_the_linear_pcd_moments(pcd_pair, ell):
    """MATLAB's linear mode on the 2816 pair of chip_smoke.py's phases 3e
    and 8."""
    x, y, ci = pcd_pair
    assert x.capacity == 2816
    c0, xc, phi = build_moments_pre(x)
    yc = y.positions - c0
    scal = gram.scalars(torch.full((), ell), MATLAB_PARAMS)
    A = _kept(moments.pair_weights(xc, x.features, x.mask, yc, y.features,
                                   y.mask, scal, ci, linear=True),
              _bounds(x, y), scal)
    assert int((A > 0).sum()) > 1000
    step, split, fp32 = _errors(A, phi)
    assert step <= STEP_TOL and split <= SPLIT_TOL, (step, split, fp32)


@pytest.mark.parametrize("n,m", [(3072, 3072), (2816, 2816), (2048, 1152),
                                 (64, 128)])
def test_sweep_split_follows_the_shapes_alone(n, m):
    """One work item per (i-tile, j-block) pair, each with its own slice
    of a partial slot and its own count; align_fused's
    lane scratch holds the same sweep scratch, a count and a ticket per
    j-block (+1 for acvo's counts), whatever the lanes or the grid."""
    nbi, nbj = n // moments.TILE_I, m // moments.TILE_J
    sweep = moments.sweep_scratch(n, m)
    assert sweep == {"part": (nbi, moments.NUM_MONO, m),
                     "count": (nbi, nbj)}
    for mode in ("resident", "tiled"):
        for adaptive in (False, True):
            lane = lane_scratch(n, m, mode, adaptive)
            assert lane["mom_part"] == (sweep["part"], torch.float32)
            assert lane["cnt_part"] == (sweep["count"], torch.int32)
            assert lane["cnt_col"] == ((nbj,), torch.int32)
            assert lane["ticket"] == ((nbj + 1,), torch.int32)
            assert list(lane)[-1] == "out"


def test_the_63_lane_batch_scratch_fits_with_room_to_spare():
    """chip_smoke.py's phase 8 at 2816: 63 lanes of tiled linear cvo."""
    per_lane = sum(int(np.prod(shape)) * 4 for shape, _ in
                   lane_scratch(2816, 2816, "tiled", False).values())
    assert 17e6 < per_lane < 18e6          # 44 x 35 x 2816 partials
    assert 63 * per_lane < 1.2e9           # of the card's 80 GB


@pytest.mark.parametrize("mode", ["resident", "tiled"])
def test_float64_plain_agrees_with_float32_on_a_small_linear_pair(mode):
    """The float64 reference of align_fused_plain (exact exp, the cubic
    in float64) is the float32 plain version's algebra: within 1e-5
    after 1, 3 and 10 iterations on a small linear pair."""
    rng = np.random.default_rng(5)
    n, cap = 230, 256
    base = rng.standard_normal((n + 30, 3)).astype(np.float32) * 0.4
    feat = (rng.random((n + 30, 3)) * 255).astype(np.float32)
    R = ct.se3.exp_so3(torch.tensor([0.01, -0.012, 0.008])).numpy()
    yp = base[20:20 + n] @ R.T + np.array([0.02, -0.01, 0.015], np.float32)
    x, y = (kd_sort(ct.pad_cloud(p, f, cap, device="cpu"))
            for p, f in ((base[:n], feat[:n]), (yp, feat[20:20 + n])))
    x, y = (c._replace(features=pad_feat(c.features)) for c in (x, y))
    for it in (1, 3, 10):
        q = dataclasses.replace(MATLAB_PARAMS, backend="fused", max_iter=it,
                                eps=0.0, eps_2=0.0)
        r32 = align_fused_plain(q, x, y, mode=mode)
        r64 = align_fused_plain(q, x, y, mode=mode, dtype=torch.float64)
        assert r64.dtype == torch.float64 and r64[24].item() == it
        assert (r32.double() - r64)[12:].abs().max().item() <= 1e-5


def test_float64_plain_runs_on_the_cpu_only():
    x = ct.pad_cloud(np.zeros((4, 3)), capacity=128, device="cpu")
    with pytest.raises(ValueError, match="float64"):
        align_fused_plain(ct.CvoParams(backend="fused"), x, x,
                          dtype=torch.float16)
