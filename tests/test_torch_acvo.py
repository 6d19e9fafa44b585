"""The port's adaptive CVO on the kernel backend (plain versions on the
CPU) against the JAX package's Pallas backend (interpret mode).

Inputs are the rendered pair of `torch_scenes.rendered_acvo_pair`.  The
JAX side runs `core.registration.align` op by op, as
tests/test_torch_align.py does for cvo (under jit, XLA:CPU's kd_sort
duplicates points; ROADMAP queue 3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch.convert import params_from_jax_dict
from cvo_rgbd_torch.core import cloud as tcloud
from cvo_rgbd_torch.core import registration as treg
from cvo_rgbd_torch.ops import color_gram as t_color_gram
from cvo_rgbd_torch.ops import fused_wsq as t_fused_wsq
from cvo_rgbd_torch.ops.wsq import TILE_W
from cvo_rgbd_tpu.core import registration as jreg
from cvo_rgbd_tpu.core.cloud import PointCloud as JCloud
from cvo_rgbd_tpu.core.cloud import kd_sort as j_kd_sort
from cvo_rgbd_tpu.ops import color_gram as j_color_gram
from cvo_rgbd_tpu.ops import fused_wsq as j_fused_wsq
from cvo_rgbd_tpu.ops.pallas_gram import aabb_min_d2, block_bounds
from cvo_rgbd_tpu.params import AcvoParams as JA

from torch_scenes import N_FRAMES, make_parallax_folder, rendered_acvo_pair

torch.set_num_threads(2)

# the MATLAB stop set: the ROADMAP's hold for whole aligns against JAX
# (tf within 3e-4).  At the C++ stops the last iterations contract so
# slowly that fp32 summation order moves the stopping iteration by ~5%.
MATLAB_STOPS = dict(eps=5e-4, eps_2=1e-4)


@pytest.fixture(scope="module")
def pair():
    """(port clouds on the CPU, JAX clouds) of the first rendered pair."""
    port = rendered_acvo_pair()
    jax_clouds = [JCloud(*(np.asarray(a) for a in c)) for c in port]
    return port, jax_clouds


def _port_params(jp):
    return params_from_jax_dict(dataclasses.asdict(jp))


@pytest.mark.parametrize("ell", [0.1, 0.0391])
@pytest.mark.parametrize("use_skip", [False, True])
@pytest.mark.parametrize("use_ck", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_fused_wsq_plain_matches_pallas(pair, symmetric, use_ck, use_skip,
                                        ell):
    (tx, ty), (jx, jy) = pair
    # the symmetric sweep is for self-pairs; the full one takes any pair
    (tx2, jx2) = (tx, jx) if symmetric else (ty, jy)
    jp = JA(backend="pallas")
    ck = j_color_gram(*jx, *jx2, p=jp, interpret=True) if use_ck else None
    md = t_md = None
    if use_skip:
        # each side at its own tile size: the skip is exact at any tile
        md = aabb_min_d2(*block_bounds(jx.positions, jx.mask, 256),
                         *block_bounds(jx2.positions, jx2.mask, 256))
        t_md = tcloud.aabb_min_d2(
            *tcloud.block_bounds(tx.positions, tx.mask, TILE_W),
            *tcloud.block_bounds(tx2.positions, tx2.mask, TILE_W))
    ref_wsq, ref_nnz = j_fused_wsq(*jx, *jx2, np.float32(ell), ck, md, p=jp,
                                   symmetric=symmetric, interpret=True)
    wsq, nnz = t_fused_wsq(
        *tx, *tx2, torch.tensor(ell, dtype=torch.float32),
        None if ck is None else torch.from_numpy(np.array(ck)), t_md,
        p=_port_params(jp), symmetric=symmetric)
    assert float(nnz) == float(ref_nnz) > 0
    # one fp32 sum in another order (tiles, upper triangle x2)
    np.testing.assert_allclose(float(wsq), float(ref_wsq), rtol=1e-4)


def test_fused_wsq_symmetric_and_skip_are_exact(pair):
    """On the CPU the symmetric sweep is the full one, and the tile skip
    drops only tiles of zeros: all four give the same bits."""
    (tx, _), _ = pair
    tx = tcloud.kd_sort(tx)   # compact tiles, as align sweeps them
    p = ct.AcvoParams()
    ell = torch.tensor(p.ell_min)
    ck = t_color_gram(*tx, *tx, p=p)
    assert torch.equal(ck, ck.T)   # the symmetric sweep relies on it
    lo, hi = tcloud.block_bounds(tx.positions, tx.mask, TILE_W)
    md = tcloud.aabb_min_d2(lo, hi, lo, hi)
    d2_thres = -2.0 * p.ell_min ** 2 * np.log(p.sp_thres / p.sigma ** 2)
    assert (md.numpy() > d2_thres + 1e-5).any()   # some tiles do skip
    outs = [t_fused_wsq(*tx, *tx, ell, ck, skip, p=p, symmetric=sym)
            for sym in (False, True) for skip in (None, md)]
    for w, n in outs[1:]:
        assert torch.equal(w, outs[0][0]) and torch.equal(n, outs[0][1])
    with pytest.raises(ValueError, match="self-pair"):
        t_fused_wsq(*tx, *(t[:448] for t in tx), ell, p=p, symmetric=True)


@pytest.mark.parametrize("max_iter", [1, 3, 10])
def test_acvo_ell_trajectory_matches_jax(pair, max_iter):
    """dl cancels heavily (wsq_yy - 2 wsq_xy + wsq_xx): hold ell after a
    few iterations before holding a whole align."""
    (tx, ty), (jx, jy) = pair
    jp = JA(backend="pallas", max_iter=max_iter)
    ref = jreg.align(jp, jx, jy)
    got = ct.align(_port_params(jp), tx, ty, device="cpu")
    assert int(got.iterations) == int(ref.iterations) == max_iter - 1
    np.testing.assert_allclose(float(got.ell), float(ref.ell), rtol=1e-4)
    np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf), atol=3e-4)


@pytest.mark.parametrize("self_mode", ["exact", "cheb"])
def test_acvo_align_matches_jax(pair, self_mode):
    (tx, ty), (jx, jy) = pair
    jp = JA(backend="pallas", self_mode=self_mode, **MATLAB_STOPS)
    ref = jreg.align(jp, jx, jy)
    got = ct.align(_port_params(jp), tx, ty, device="cpu")
    assert bool(got.converged) and bool(ref.converged)
    assert abs(int(got.iterations) - int(ref.iterations)) <= 2
    # the JAX suite's stop-skew tolerance (tests/test_parallel.py:217)
    np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf), atol=3e-4)
    np.testing.assert_allclose(float(got.ell), float(ref.ell), rtol=1e-3)


def test_cheb_tables_match_jax(pair):
    (tx, ty), (jx, jy) = pair
    jp = JA(backend="pallas", self_mode="cheb")
    jx, jy = j_kd_sort(jx), j_kd_sort(jy)
    ref_logv, ref_meta = jreg.build_selfsweep_cheb(
        jp, True, jx, jy, jreg.build_ck_caches(jp, True, jx, jy),
        jreg.build_skip_pre(jp, True, jx, jy))
    tx, ty = tcloud.kd_sort(tx), tcloud.kd_sort(ty)
    logv, meta = treg.prepare(_port_params(jp), tx, ty).cheb
    # each entry one fused_wsq sum; the node abscissae are host math
    np.testing.assert_allclose(logv.exp().numpy(),
                               np.exp(np.asarray(ref_logv)), rtol=1e-4)
    for got, want in zip(meta, ref_meta):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_cheb_span_widens_for_a_large_host_ell0(pair):
    (tx, ty), _ = pair
    p = ct.AcvoParams(self_mode="cheb")
    lo_default = treg.prepare(p, tx, ty).cheb[1][0]
    lo_wide = treg.prepare(p, tx, ty, ell0=torch.tensor(0.3)).cheb[1][0]
    np.testing.assert_allclose(float(lo_default), np.log(1 / (2 * 0.15 ** 2)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(lo_wide), np.log(1 / (2 * 0.3 ** 2)),
                               rtol=1e-6)


def test_kernel_acvo_matches_dense_acvo(pair):
    (tx, ty), _ = pair
    kern = ct.align(ct.AcvoParams(**MATLAB_STOPS), tx, ty, device="cpu")
    dense = ct.align(ct.AcvoParams(backend="dense", **MATLAB_STOPS), tx, ty,
                     device="cpu")
    assert bool(kern.converged) and bool(dense.converged)
    np.testing.assert_allclose(kern.tf.numpy(), dense.tf.numpy(), atol=3e-4)


def test_acvo_options_do_not_change_the_result(pair):
    """ck_cache off recomputes the same color kernels, and the tile skip
    (cross and self sweeps) is exact: both give the default's bits."""
    (tx, ty), _ = pair
    base = ct.align(ct.AcvoParams(max_iter=20), tx, ty, device="cpu")
    for kw in ({"ck_cache": False}, {"tile_skip": False}):
        other = ct.align(ct.AcvoParams(max_iter=20, **kw), tx, ty,
                         device="cpu")
        assert torch.equal(other.tf, base.tf)
        assert torch.equal(other.ell, base.ell)


def test_cli_run_adaptive_matches_jax(tmp_path):
    """`cli run --adaptive --device cpu` on the 6-frame parallax folder
    against the JAX package's acvo odometry (its default dense backend:
    the JAX Pallas path kd-sorts under jit, wrong on XLA:CPU), at the
    MATLAB stops: at the C++ stops the first pair of this folder takes
    ~800 iterations, two minutes of the plain versions on the CPU."""
    import json

    from cvo_rgbd_torch.cli import main as t_cli
    from cvo_rgbd_torch.evaluation import ate_rmse
    from cvo_rgbd_torch.io.tum import read_trajectory
    from cvo_rgbd_tpu.odometry import run_odometry as j_run_odometry

    root = tmp_path / "tum"
    root.mkdir()
    make_parallax_folder(root)
    ckpt = tmp_path / "ckpt.json"
    t_cli(["run", str(root), "1", "--adaptive", "--device", "cpu",
           "--num-want", "1024", "--matlab-tol", "--checkpoint", str(ckpt)])
    port = read_trajectory(root / "acvo_poses_qt.txt")   # the default name
    ref_out = tmp_path / "jax.txt"
    j_run_odometry(str(root), 1, adaptive=True, params=JA(**MATLAB_STOPS),
                   num_want=1024, output=str(ref_out), log=lambda *a: None)
    ref = read_trajectory(ref_out)
    assert set(port) == set(ref) and len(ref) == N_FRAMES
    keys = sorted(ref)
    for a, b in zip(keys, keys[1:]):
        np.testing.assert_allclose(np.linalg.inv(port[a]) @ port[b],
                                   np.linalg.inv(ref[a]) @ ref[b], atol=1e-3)
    # the JAX suite's bound for this folder (tests/test_odometry.py)
    gt = read_trajectory(root / "groundtruth.txt")
    assert ate_rmse(gt, port)["rmse"] < 0.012
    # acvo resets ell per pair: the checkpoint carries no warm ell
    state = json.loads(ckpt.read_text())
    assert state["frame_index"] == N_FRAMES
    assert state["warm_ell"] is None and state["warm_R"] is not None
