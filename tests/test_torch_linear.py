"""MATLAB's linear color mode (MATLAB_PARAMS) in the port against the JAX
package: the linear branch of `fused_moments`, whole aligns on every
backend, the numpy-only pcd / export / downsample copies, and the batch
runner with `cli batch` and `cli stitch`.

The JAX kernel and fused aligns run op by op (`core.registration.align`),
as tests/test_torch_align.py explains; the dense ones through `align_jit`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch.convert import cloud_from_numpy, params_from_jax_dict
from cvo_rgbd_torch.core import cloud as tcloud
from cvo_rgbd_torch.core.registration import prepare_ci as t_prepare_ci
from cvo_rgbd_torch.core.step_factored import monomial_features
from cvo_rgbd_torch.ops import fused_moments as t_fused_moments
from cvo_rgbd_torch.ops.gram import pad_feat
from cvo_rgbd_torch.ops.moments import TILE_I, TILE_J
from cvo_rgbd_tpu import align_jit, pad_cloud, se3
from cvo_rgbd_tpu.core import registration as jreg
from cvo_rgbd_tpu.core.moments import monomial_features_padded
from cvo_rgbd_tpu.ops import fused_moments as j_fused_moments
from cvo_rgbd_tpu.ops.pallas_gram import aabb_min_d2, block_bounds
from cvo_rgbd_tpu.params import MATLAB_PARAMS as J_MATLAB
from cvo_rgbd_tpu.params import AcvoParams as JA

torch.set_num_threads(2)

# the MATLAB stops (5e-4 / 1e-4) converge here in 13-18 iterations
TF_TOL = 3e-4   # the JAX suite's stop skew (tests/test_parallel.py:217)


@dataclasses.dataclass(frozen=True)
class _JAcvoLinear(JA):
    """The JAX AcvoParams with the `color_scale` field it lacks, so the
    JAX package can run the linear acvo algebra the port runs."""

    color_scale: float = 1e-5


def _pair(seed, n, cap, m=None, capm=None):
    """A rotated, shifted, overlapping pair with 3 color features."""
    rng = np.random.default_rng(seed)
    m, capm = m or n, capm or cap
    base = rng.standard_normal((max(n, m) + 30, 3)).astype(np.float32) * 0.4
    feat = (rng.random((max(n, m) + 30, 3)) * 255).astype(np.float32)
    R = np.asarray(se3.exp_so3(np.array([0.01, -0.012, 0.008], np.float32)))
    t = np.array([0.02, -0.01, 0.015], np.float32)
    yp = (base[20:20 + m] @ R.T + t).astype(np.float32)
    return (pad_cloud(base[:n], feat[:n], capacity=cap),
            pad_cloud(yp, feat[20:20 + m], capacity=capm))


def _port(cloud):
    return cloud_from_numpy(*(np.asarray(a) for a in cloud), device="cpu")


def _params(jp):
    return params_from_jax_dict(dataclasses.asdict(jp))


def _check(got, ref):
    assert bool(got.converged) and bool(ref.converged)
    assert abs(int(got.iterations) - int(ref.iterations)) <= 2
    np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf),
                               atol=TF_TOL)


@pytest.mark.parametrize("use_skip", [False, True])
@pytest.mark.parametrize("ell", [0.15, 0.03])
def test_fused_moments_linear_plain_matches_pallas(use_skip, ell):
    x, y = _pair(0, 470, 512)
    tx, ty = _port(x), _port(y)
    jp = dataclasses.replace(J_MATLAB, backend="pallas")
    jci = jreg.prepare_ci(jp, x, y)
    tci = t_prepare_ci(ct.MATLAB_PARAMS, tx, ty)
    np.testing.assert_allclose(tci.numpy(), np.asarray(jci), rtol=1e-6)
    xp, yp = np.array(x.positions), np.array(y.positions)
    c0 = xp[:470].mean(0).astype(np.float32)
    xc, yc = xp - c0, yp - c0
    md = t_md = None
    if use_skip:
        md = aabb_min_d2(*block_bounds(xp, x.mask, 256),
                         *block_bounds(yp, y.mask, 256))
        t_md = tcloud.aabb_min_d2(
            *tcloud.block_bounds(torch.from_numpy(xp), tx.mask, TILE_I),
            *tcloud.block_bounds(torch.from_numpy(yp), ty.mask, TILE_J))
    ref, ref_nnz = j_fused_moments(
        xc, x.features, x.mask, yc, y.features, y.mask,
        monomial_features_padded(jnp.asarray(xc)), jnp.float32(ell), jci, md,
        p=jp, interpret=True)
    ref = np.asarray(ref)[:, :35]
    mom, nnz = t_fused_moments(
        torch.from_numpy(xc), pad_feat(tx.features), tx.mask,
        torch.from_numpy(yc), pad_feat(ty.features), ty.mask,
        monomial_features(torch.from_numpy(xc)),
        torch.tensor(ell), tci, t_md, p=ct.MATLAB_PARAMS)
    assert float(nnz) == float(ref_nnz) > 0
    # tests/test_torch_ops.py: 1e-5 of each moment column's magnitude
    scale = np.abs(ref).max(axis=0)
    assert (np.abs(mom.numpy() - ref) <= 1e-5 * scale).all()


def test_fused_moments_linear_needs_the_ci():
    x, y = (_port(c) for c in _pair(0, 100, 128))
    with pytest.raises(ValueError, match="ci cache"):
        t_fused_moments(*x, *y, monomial_features(x.positions),
                        torch.tensor(0.1), p=ct.MATLAB_PARAMS)


@pytest.mark.parametrize("op", ["fused_moments", "fused_flow",
                                "fused_step_coeffs", "align_fused"])
def test_kernels_take_clouds_padded_once_by_align(op):
    """The op wrappers take the kernels' 5 feature planes: a 3-feature
    cloud raises there, and `align` pads it once for every backend."""
    from cvo_rgbd_torch.ops import align_fused, fused_flow, fused_step_coeffs

    x, y = (_port(c) for c in _pair(0, 100, 128))
    ci = t_prepare_ci(ct.MATLAB_PARAMS, x, y)
    ell, w = torch.tensor(0.1), torch.zeros(3)
    p = ct.MATLAB_PARAMS
    calls = {
        "fused_moments": lambda: t_fused_moments(
            *x, *y, monomial_features(x.positions), ell, ci, p=p),
        "fused_flow": lambda: fused_flow(*x, *y, ell, ci, p=p),
        "fused_step_coeffs": lambda: fused_step_coeffs(*x, *y, ell, w, w, ci,
                                                       p=p),
        "align_fused": lambda: align_fused(
            dataclasses.replace(p, backend="fused"), x, y),
    }
    with pytest.raises(ValueError, match=r"features"):
        calls[op]()
    padded = [c._replace(features=pad_feat(c.features)) for c in (x, y)]
    backend = "fused" if op == "align_fused" else "kernel"
    q = dataclasses.replace(p, backend=backend)
    got = ct.align(q, x, y, device="cpu")
    if backend == "fused":
        # align routes 3-feature clouds to the fused kernel (as JAX)
        assert torch.equal(got.tf, align_fused(q, *(
            tcloud.kd_sort(c) for c in padded)).tf)
    else:
        assert torch.equal(got.tf, ct.align(q, *padded, device="cpu").tf)


@pytest.mark.parametrize("n,cap", [(230, 256), (470, 512)])
def test_kernel_backend_matches_jax_pallas(n, cap):
    x, y = _pair(1, n, cap)
    jp = dataclasses.replace(J_MATLAB, backend="pallas")
    ref = jreg.align(jp, x, y)
    p = _params(jp)
    assert p == ct.MATLAB_PARAMS
    _check(ct.align(p, _port(x), _port(y), device="cpu"), ref)


def test_dense_backend_matches_jax_xla():
    x, y = _pair(2, 470, 512)
    ref = align_jit(J_MATLAB, x, y)
    p = _params(J_MATLAB)
    assert p.backend == "dense"
    _check(ct.align(p, _port(x), _port(y), device="cpu"), ref)


def test_direct_step_matches_jax_xla_direct():
    """The kernel backend's two sweeps (fused_flow, fused_step_coeffs)
    against the JAX dense backend's direct line search."""
    x, y = _pair(3, 470, 512)
    ref = align_jit(dataclasses.replace(J_MATLAB, step_mode="direct"), x, y)
    p = dataclasses.replace(ct.MATLAB_PARAMS, step_mode="direct")
    _check(ct.align(p, _port(x), _port(y), device="cpu"), ref)


def test_linear_acvo_dense_matches_jax_algebra():
    """Linear acvo on the dense backend: A and Axx through matlab_gram
    with the pair's CI, Ayy through se_gram (the JAX algebra); the JAX
    side runs with the color_scale its AcvoParams lacks."""
    x, y = _pair(4, 230, 256)
    jp = _JAcvoLinear(color_mode="linear", eps=5e-4, eps_2=1e-4)
    ref = align_jit(jp, x, y)
    p = ct.AcvoParams(color_mode="linear", backend="dense", eps=5e-4,
                      eps_2=1e-4)
    got = ct.align(p, _port(x), _port(y), device="cpu")
    _check(got, ref)
    np.testing.assert_allclose(float(got.ell), float(ref.ell), atol=5e-4)
    # the fused backend cannot run it and routes it to dense
    fused = ct.align(dataclasses.replace(p, backend="fused"), _port(x),
                     _port(y), device="cpu")
    assert torch.equal(fused.tf, got.tf)


@pytest.mark.parametrize("n,cap,m,capm,mode", [
    (230, 256, None, None, "resident"),
    (1100, 1152, 1000, 1024, "tiled"),
])
def test_fused_backend_matches_jax_align_fused(n, cap, m, capm, mode):
    from cvo_rgbd_torch.ops.align_fused import fused_mode
    from cvo_rgbd_tpu.ops.pallas_align import _fused_mode as j_fused_mode

    x, y = _pair(5, n, cap, m, capm)
    jp = dataclasses.replace(J_MATLAB, backend="fused")
    p = _params(jp)
    assert j_fused_mode(jp, x, y) == fused_mode(p, _port(x), _port(y)) == mode
    _check(ct.align(p, _port(x), _port(y), device="cpu"), jreg.align(jp, x, y))


def test_backends_agree_on_the_matlab_pair():
    """kernel (factored and direct), dense and fused register the same
    pair to the same pose at the MATLAB stops."""
    x, y = (_port(c) for c in _pair(6, 230, 256))
    base = ct.align(ct.MATLAB_PARAMS, x, y, device="cpu")
    for kw in ({"step_mode": "direct"}, {"backend": "dense"},
               {"backend": "fused"}, {"tile_skip": False}):
        other = ct.align(dataclasses.replace(ct.MATLAB_PARAMS, **kw), x, y,
                         device="cpu")
        assert bool(other.converged)
        assert (other.tf - base.tf).abs().max().item() <= TF_TOL, kw


# --- the numpy-only copies, array for array ---------------------------------


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("colors", [True, False])
def test_pcd_roundtrip_matches_jax(tmp_path, binary, colors):
    from cvo_rgbd_torch.io import pcd as tpcd
    from cvo_rgbd_torch.io.export import write_pcd as t_write
    from cvo_rgbd_tpu.io import pcd as jpcd
    from cvo_rgbd_tpu.io.export import write_pcd as j_write

    rng = np.random.default_rng(7)
    pos = rng.standard_normal((60, 3)).astype(np.float32)
    col = rng.integers(0, 256, (60, 3)).astype(np.float32) if colors else None
    j_write(tmp_path / "j.pcd", pos, col, binary=binary)
    t_write(tmp_path / "t.pcd", pos, col, binary=binary)
    assert (tmp_path / "j.pcd").read_bytes() == (tmp_path / "t.pcd").read_bytes()
    ref, got = jpcd.read_pcd(tmp_path / "j.pcd"), tpcd.read_pcd(tmp_path / "j.pcd")
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_export_helpers_match_jax(tmp_path):
    from cvo_rgbd_torch.frontend.camera import get_camera
    from cvo_rgbd_torch.io import export as tex
    from cvo_rgbd_torch.io.pcd import unpack_rgb as t_unpack
    from cvo_rgbd_tpu.io import export as jex
    from cvo_rgbd_tpu.io.pcd import unpack_rgb as j_unpack

    rng = np.random.default_rng(8)
    col = rng.integers(0, 256, (40, 3)).astype(np.float32)
    np.testing.assert_array_equal(tex.pack_rgb(col).view(np.uint32),
                                  jex.pack_rgb(col).view(np.uint32))
    packed = jex.pack_rgb(col)
    np.testing.assert_array_equal(t_unpack(packed), j_unpack(packed))
    depth = (rng.random((12, 16)) * 20000).astype(np.float32)
    depth[rng.random((12, 16)) < 0.3] = 0
    rgb = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
    cam = get_camera("fr1")
    for stride in (1, 2):
        for a, b in zip(tex.depth_to_cloud(rgb, depth, cam, stride),
                        jex.depth_to_cloud(rgb, depth, cam, stride)):
            np.testing.assert_array_equal(a, b)
    pos = rng.standard_normal((40, 3)).astype(np.float32)
    T = np.eye(4)
    T[:3, :3] = np.asarray(se3.exp_so3(np.array([0.1, 0.2, -0.1],
                                                np.float32)))
    T[:3, 3] = [0.5, -0.2, 1.0]
    np.testing.assert_array_equal(tex.transform_points(T, pos),
                                  jex.transform_points(T, pos))
    clouds = [(pos, col), (tex.transform_points(T, pos), col)]
    for a, b in zip(tex.merge_clouds(clouds, grid=0.05),
                    jex.merge_clouds(clouds, grid=0.05)):
        np.testing.assert_array_equal(a, b)
    tex.write_ply(tmp_path / "t.ply", pos, col)
    jex.write_ply(tmp_path / "j.ply", pos, col)
    assert (tmp_path / "t.ply").read_text() == (tmp_path / "j.ply").read_text()


@pytest.mark.parametrize("grid", [0.02, 0.05])
def test_range_filter_and_grid_downsample_match_jax(grid):
    from cvo_rgbd_torch.utils import downsample as tds
    from cvo_rgbd_tpu.utils import downsample as jds

    rng = np.random.default_rng(9)
    pos = (rng.standard_normal((2000, 3)) * 2.0).astype(np.float32)
    col = rng.random((2000, 3)).astype(np.float32)
    for a, b in zip(tds.range_filter(pos, col), jds.range_filter(pos, col)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tds.range_filter(pos, None, 1.0, 3.0),
                                  jds.range_filter(pos, None, 1.0, 3.0))
    kept, kcol = jds.range_filter(pos, col)
    for a, b in zip(tds.grid_downsample(kept, kcol, grid),
                    jds.grid_downsample(kept, kcol, grid)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tds.grid_downsample(kept, None, grid),
                                  jds.grid_downsample(kept, None, grid))


# --- the batch runner and the CLI --------------------------------------------


@pytest.fixture(scope="module")
def pcd_dir(tmp_path_factory):
    """tests/test_export_batch.py's data: three shifted copies of a
    shell of points with radii in [1, 3] m, which the range filter
    keeps."""
    from cvo_rgbd_tpu.io.export import write_pcd

    root = tmp_path_factory.mktemp("pcd")
    rng = np.random.default_rng(10)
    base = rng.standard_normal((300, 3)).astype(np.float32)
    base = base / np.linalg.norm(base, axis=1, keepdims=True) * (
        1.0 + rng.random(300).astype(np.float32)[:, None] * 2.0)
    col = rng.integers(0, 256, (300, 3)).astype(np.float32)
    for i in range(3):
        write_pcd(root / f"f{i}.pcd", base + np.array([0.005 * i, 0, 0],
                                                      np.float32), col)
    return root


def test_load_pcd_dir_matches_jax(pcd_dir):
    from cvo_rgbd_torch.batch import load_pcd_dir as t_load
    from cvo_rgbd_tpu.batch import load_pcd_dir as j_load

    ref, got = j_load(str(pcd_dir), grid=0.02), t_load(str(pcd_dir), grid=0.02)
    assert [c[0] for c in got] == [c[0] for c in ref] == [
        "f0.pcd", "f1.pcd", "f2.pcd"]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[1], r[1])
        np.testing.assert_array_equal(g[2], r[2])


def test_run_batch_matches_jax(pcd_dir, tmp_path):
    from cvo_rgbd_torch.batch import run_batch as t_run
    from cvo_rgbd_tpu.batch import run_batch as j_run

    quiet = lambda *a: None  # noqa: E731
    ref, _ = j_run(str(pcd_dir), grid=0.02, output=str(tmp_path / "j.npz"),
                   log=quiet)
    got, times = t_run(str(pcd_dir), grid=0.02, output=str(tmp_path / "t.npz"),
                       log=quiet, device="cpu")
    assert got.shape == (3, 4, 4) and times.shape == (2,)
    np.testing.assert_array_equal(got[0], np.eye(4))
    np.testing.assert_allclose(got, ref, atol=TF_TOL)
    # estimated pairwise translation ~ -5 mm in x (tests/test_export_batch.py)
    assert abs(got[1][0, 3] + 0.005) < 0.004
    saved = np.load(tmp_path / "t.npz")
    np.testing.assert_array_equal(saved["results"], got)
    assert list(saved["names"]) == ["f0.pcd", "f1.pcd", "f2.pcd"]


def test_run_batch_marks_a_degenerate_cloud(tmp_path):
    """A cloud with too few points after the range filter marks both of
    its pairs NaN; the other pair still registers."""
    from cvo_rgbd_torch.batch import run_batch
    from cvo_rgbd_torch.io.export import write_pcd

    rng = np.random.default_rng(11)
    base = rng.standard_normal((300, 3)).astype(np.float32)
    base = base / np.linalg.norm(base, axis=1, keepdims=True) * 2.0
    col = rng.integers(0, 256, (300, 3)).astype(np.float32)
    write_pcd(tmp_path / "a.pcd", base, col)
    write_pcd(tmp_path / "b.pcd", base + 0.003, col)
    write_pcd(tmp_path / "c.pcd", base[:20], col[:20])   # 20 < min_valid
    write_pcd(tmp_path / "d.pcd", base, col)
    results, _ = run_batch(str(tmp_path), grid=0.02, log=lambda *a: None,
                           device="cpu")
    assert np.isfinite(results[1]).all()
    assert np.isnan(results[2]).all() and np.isnan(results[3]).all()
    assert len(list(tmp_path.glob("cvo_batch_*.npz"))) == 1


def test_cli_batch_and_stitch(pcd_dir, tmp_path, capsys):
    from cvo_rgbd_torch.cli import main as t_cli
    from cvo_rgbd_tpu.cli import main as j_cli

    out = tmp_path / "b.npz"
    t_cli(["batch", str(pcd_dir), "--grid", "0.02", "--output", str(out),
           "--device", "cpu"])
    assert np.isfinite(np.load(out)["results"]).all()
    ply_t, ply_j = tmp_path / "t.ply", tmp_path / "j.ply"
    t_cli(["stitch", str(pcd_dir), "--grid", "0.02", "--output", str(ply_t),
           "--device", "cpu"])
    j_cli(["stitch", str(pcd_dir), "--grid", "0.02", "--output", str(ply_j)])
    head_t, head_j = (p.read_text().split("end_header")[0]
                      for p in (ply_t, ply_j))
    n_t = int(head_t.split("element vertex ")[1].split()[0])
    assert n_t > 0
    # the merged scenes from poses within the stop skew: the same points
    # to a fraction of the merge grid
    assert abs(n_t - int(head_j.split("element vertex ")[1].split()[0])) <= 2
    assert str(ply_t) in capsys.readouterr().out
