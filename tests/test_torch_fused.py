"""The port's whole-align backend (`backend="fused"`, plain version on the
CPU) against the JAX package's `align_fused` (interpret-mode Pallas).

The JAX side runs `core.registration.align` op by op, as
tests/test_torch_align.py does: under jit, XLA:CPU's kd_sort duplicates
points (ROADMAP, queue 3).  Both sides kd-sort the same clouds, so both
sweep the same point order.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch.convert import cloud_from_numpy, params_from_jax_dict
from cvo_rgbd_torch.core import registration as treg
from cvo_rgbd_torch.core.cloud import kd_sort
from cvo_rgbd_torch.ops.align_fused import (
    align_fused,
    align_fused_plain,
    fused_mode,
)
from cvo_rgbd_tpu import pad_cloud, se3
from cvo_rgbd_tpu.core import registration as jreg
from cvo_rgbd_tpu.ops.pallas_align import _fused_mode as j_fused_mode
from cvo_rgbd_tpu.params import MATLAB_PARAMS as J_MATLAB
from cvo_rgbd_tpu.params import AcvoParams as JA
from cvo_rgbd_tpu.params import CvoParams as JC

from torch_scenes import N_FRAMES, make_parallax_folder

torch.set_num_threads(2)

# the tiled-mode stops of the JAX suite (tests/test_pallas_align.py:211)
TILED_STOPS = dict(eps=5e-4, eps_2=1e-4, max_iter=40)
FIXED = dict(eps=0.0, eps_2=0.0)


def _pair(seed, n, cap):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n + 30, 3)).astype(np.float32) * 0.4
    feat = (rng.random((n + 30, 5)) * np.array([255, 255, 255, 60, 60]))
    feat = feat.astype(np.float32)
    R = np.asarray(se3.exp_so3(np.array([0.01, -0.012, 0.008], np.float32)))
    t = np.array([0.02, -0.01, 0.015], np.float32)
    yp = (base[20:20 + n] @ R.T + t).astype(np.float32)
    return (pad_cloud(base[:n], feat[:n], capacity=cap),
            pad_cloud(yp, feat[20:20 + n], capacity=cap))


def _port(cloud):
    return cloud_from_numpy(*(np.asarray(a) for a in cloud), device="cpu")


def _params(jp):
    return params_from_jax_dict(dataclasses.asdict(jp))


@pytest.fixture(scope="module")
def small():
    return _pair(0, 200, 256)


@pytest.fixture(scope="module")
def mid():
    return _pair(1, 1100, 1152)


def _run(jp, x, y, *warm):
    ref = jreg.align(jp, x, y, *warm)
    port_warm = [torch.from_numpy(np.array(w, np.float32)) for w in warm]
    got = ct.align(_params(jp), _port(x), _port(y), *port_warm, device="cpu")
    return got, ref


def _check_whole(got, ref, adaptive):
    assert bool(got.converged) == bool(ref.converged)
    assert abs(int(got.iterations) - int(ref.iterations)) <= 2
    # the JAX suite's stop-skew tolerance (tests/test_parallel.py:217)
    np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf), atol=3e-4)
    if adaptive:
        # tests/test_pallas_align.py:42
        np.testing.assert_allclose(float(got.ell), float(ref.ell), atol=5e-4)
    else:
        assert float(got.ell) == float(ref.ell)


@pytest.mark.parametrize("jp", [JC(backend="fused"),
                                JA(backend="fused", max_iter=60)],
                         ids=["cvo", "acvo"])
def test_resident_align_matches_jax(small, jp):
    x, y = small
    got, ref = _run(jp, x, y)
    assert fused_mode(_params(jp), _port(x), _port(y)) == "resident"
    _check_whole(got, ref, isinstance(jp, JA))
    assert bool(got.converged)


def test_resident_warm_start_matches_jax(small):
    x, y = small
    R0 = np.asarray(se3.exp_so3(np.array([0.004, 0.0, -0.003], np.float32)))
    T0 = np.array([0.01, 0.0, 0.005], np.float32)
    got, ref = _run(JC(backend="fused"), x, y, R0, T0, np.float32(0.03))
    _check_whole(got, ref, False)


@pytest.mark.parametrize("max_iter", [1, 3, 10])
@pytest.mark.parametrize("jcls", [JC, JA], ids=["cvo", "acvo"])
def test_fixed_iterations_match_jax(small, jcls, max_iter):
    """The state after a fixed number of iterations, so a drift shows
    at the iteration where it starts."""
    x, y = small
    got, ref = _run(jcls(backend="fused", max_iter=max_iter, **FIXED), x, y)
    assert int(got.iterations) == int(ref.iterations) == max_iter - 1
    tol = 1e-5 if max_iter <= 3 else 1e-4
    for name in ("R", "T", "ell", "omega", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=tol,
                                   err_msg=name)


# six steps, more than the default three; some fall inside the run
LONG_SCHED = ((0, 0.12), (1, 0.10), (2, 0.08), (4, 0.06), (6, 0.05),
              (8, 0.04))


def test_long_ell_schedule_matches_jax(small):
    """A cvo schedule of any length runs, as in the JAX package, and
    moves ell at the same iterations."""
    x, y = small
    got, ref = _run(JC(backend="fused", ell_sched=LONG_SCHED, max_iter=10,
                       **FIXED), x, y)
    assert int(got.iterations) == int(ref.iterations) == 9
    assert float(got.ell) == float(ref.ell) == np.float32(0.04)
    for name in ("R", "T", "omega", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-4,
                                   err_msg=name)


@pytest.fixture(scope="module")
def tiled_refs(mid):
    """The two JAX tiled aligns, computed once (about a minute)."""
    x, y = mid
    return {cls: jreg.align(cls(backend="fused", **TILED_STOPS), x, y)
            for cls in (JC, JA)}


@pytest.mark.parametrize("jcls", [JC, JA], ids=["cvo", "acvo"])
def test_tiled_align_matches_jax(mid, tiled_refs, jcls):
    x, y = mid
    jp = jcls(backend="fused", **TILED_STOPS)
    assert fused_mode(_params(jp), _port(x), _port(y)) == "tiled"
    assert j_fused_mode(jp, x, y) == "tiled"
    got = ct.align(_params(jp), _port(x), _port(y), device="cpu")
    _check_whole(got, tiled_refs[jcls], jcls is JA)
    assert bool(got.converged)


def _shapes(n, m, nfeat, torch_side):
    def cloud(k):
        if torch_side:
            return types.SimpleNamespace(positions=torch.empty(k, 3),
                                         features=torch.empty(k, nfeat))
        return types.SimpleNamespace(positions=np.empty((k, 3)),
                                     features=np.empty((k, nfeat)))
    return cloud(n), cloud(m)


@pytest.mark.parametrize("jp,nfeat", [
    (JC(backend="fused"), 5),
    (JA(backend="fused"), 5),
    (JA(backend="fused", yy_quirk=True), 5),
    (dataclasses.replace(J_MATLAB, backend="fused"), 3),
], ids=["cvo", "acvo", "acvo-quirk", "matlab"])
def test_fused_mode_matches_jax(jp, nfeat):
    caps = (8, 128, 256, 1000, 1024, 1032, 1152, 2048, 3072, 4096, 4224)
    p = _params(jp)
    for n in caps:
        for m in caps:
            want = j_fused_mode(jp, *_shapes(n, m, nfeat, False))
            assert fused_mode(p, *_shapes(n, m, nfeat, True)) == want, (n, m)


class _Routed(Exception):
    pass


@pytest.mark.parametrize("jp,n,cap,want", [
    (JC(backend="fused"), 300, 1032, "dense"),
    (JA(backend="fused", yy_quirk=True), 200, 256, "dense"),
    (JC(backend="fused"), 300, 4224, "kernel"),
], ids=["unaligned", "yy_quirk", "oversize"])
def test_ineligible_problems_route_as_in_jax(monkeypatch, jp, n, cap, want):
    """A problem the fused kernel cannot run goes to the backend the JAX
    package picks; each side is stopped right after it has chosen."""
    seen = {}

    def spy_jax(p, *_):
        seen["jax"] = p.backend
        raise _Routed

    def spy_port(p, *_args, **_kw):
        seen["port"] = p.backend
        raise _Routed

    monkeypatch.setattr(jreg, "prepare_ci", spy_jax)
    monkeypatch.setattr(treg, "init_state", spy_port)
    x, y = _pair(2, n, cap)
    with pytest.raises(_Routed):
        jreg.align(jp, x, y)
    with pytest.raises(_Routed):
        ct.align(_params(jp), _port(x), _port(y), device="cpu")
    assert {"xla": "dense", "pallas": "kernel"}[seen["jax"]] == want
    assert seen["port"] == want


@pytest.mark.parametrize("cls", [ct.CvoParams, ct.AcvoParams],
                         ids=["cvo", "acvo"])
def test_tile_skip_is_exact(mid, cls):
    """The tiled sweep's AABB skip drops only tiles of zeros: skip on and
    off give the same bits, and on this pair it does skip."""
    from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds
    from cvo_rgbd_torch.ops.moments import TILE_I, TILE_J

    x, y = (kd_sort(_port(c)) for c in mid)
    p = cls(max_iter=4, **FIXED)
    rows = [align_fused_plain(dataclasses.replace(p, tile_skip=s), x, y)
            for s in (True, False)]
    assert torch.equal(rows[0], rows[1])
    md = aabb_min_d2(*block_bounds(x.positions, x.mask, TILE_I),
                     *block_bounds(y.positions, y.mask, TILE_J))
    d2_thres = -2.0 * p.ell_init ** 2 * np.log(p.sp_thres / p.sigma ** 2)
    assert (md.numpy() > d2_thres + 1e-5).any()


@pytest.mark.parametrize("which", ["small", "mid"])
def test_self_registration_is_identity(small, mid, which):
    x = _port({"small": small, "mid": mid}[which][0])
    res = ct.align(ct.CvoParams(backend="fused"), x, x, device="cpu")
    assert int(res.iterations) == 0 and bool(res.converged)
    np.testing.assert_array_equal(res.tf.numpy(), np.eye(4, dtype=np.float32))


def test_empty_moving_cloud_converges_at_iteration_zero(small):
    x = _port(small[0])
    empty = ct.pad_cloud(np.zeros((0, 3)), capacity=256, device="cpu")
    for p in (ct.CvoParams(backend="fused"), ct.AcvoParams(backend="fused")):
        res = ct.align(p, x, empty, device="cpu")
        assert int(res.iterations) == 0 and bool(res.converged)
        assert torch.isfinite(res.tf).all()


def test_wrapper_checks_the_problem(small):
    x, y = (kd_sort(_port(c)) for c in small)
    big = ct.pad_cloud(np.zeros((0, 3)), capacity=4224, device="cpu")
    with pytest.raises(ValueError, match="not eligible"):
        align_fused(ct.CvoParams(backend="fused"), big, big)
    meta = ct.PointCloud(*(t.to("meta") for t in x))
    with pytest.raises(ValueError, match="unsupported device"):
        align_fused(ct.CvoParams(backend="fused"), meta, meta)


def test_cli_run_fused(tmp_path):
    """`cli run --backend fused --device cpu` on the parallax folder
    writes every frame's pose, close to the ground truth."""
    from cvo_rgbd_torch.cli import main as t_cli
    from cvo_rgbd_torch.evaluation import ate_rmse
    from cvo_rgbd_torch.io.tum import read_trajectory

    root = make_parallax_folder(tmp_path)
    out = tmp_path / "fused.txt"
    t_cli(["run", str(root), "1", "--backend", "fused", "--device", "cpu",
           "--num-want", "512", "--matlab-tol", "--output", str(out)])
    traj = read_trajectory(out)
    assert len(traj) == N_FRAMES
    gt = read_trajectory(root / "groundtruth.txt")
    # the JAX suite's bound for this folder (tests/test_odometry.py)
    assert ate_rmse(gt, traj)["rmse"] < 0.012
