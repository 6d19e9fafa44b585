"""The port's align (kernel backend, plain versions on the CPU) against
the JAX package's align with the Pallas backend (interpret mode).

The JAX side runs `core.registration.align` op by op, not `align_jit`:
under jit, XLA:CPU's kd_sort duplicates points (ROADMAP, queue 3), so
the jitted Pallas path registers corrupted clouds on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch.convert import cloud_from_numpy, params_from_jax_dict
from cvo_rgbd_tpu import pad_cloud, se3
from cvo_rgbd_tpu.core.registration import align as j_align
from cvo_rgbd_tpu.params import CvoParams as JP

torch.set_num_threads(2)


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


def _check_same(got, ref):
    assert bool(got.converged) == bool(ref.converged)
    assert abs(int(got.iterations) - int(ref.iterations)) <= 2
    # the JAX suite's own stop-skew tolerance (tests/test_parallel.py:217)
    np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf), atol=3e-4)
    assert float(got.ell) == float(ref.ell)


@pytest.mark.parametrize("seed,n,cap", [(0, 400, 512), (1, 300, 384)])
def test_align_matches_jax_pallas(seed, n, cap):
    x, y = _pair(seed, n, cap)
    jp = JP(backend="pallas")
    ref = j_align(jp, x, y)
    p = params_from_jax_dict(dataclasses.asdict(jp))
    assert p == ct.CvoParams()
    got = ct.align(p, _port(x), _port(y), device="cpu")
    _check_same(got, ref)
    assert bool(got.converged)


def test_align_warm_start_matches_jax():
    x, y = _pair(2, 400, 512)
    R0 = np.asarray(se3.exp_so3(np.array([0.004, 0.0, -0.003], np.float32)))
    T0 = np.array([0.01, 0.0, 0.005], np.float32)
    ell0 = np.float32(0.06)
    ref = j_align(JP(backend="pallas"), x, y, R0, T0, ell0)
    got = ct.align(ct.CvoParams(), _port(x), _port(y), torch.from_numpy(R0.copy()),
                   torch.from_numpy(T0), torch.tensor(ell0), device="cpu")
    _check_same(got, ref)


def test_align_options_do_not_change_the_result():
    """ck_cache off recomputes the same color kernel, and the tile skip is
    exact: both give the default's bits."""
    x, y = _pair(3, 300, 384)
    base = ct.align(ct.CvoParams(max_iter=30), _port(x), _port(y),
                    device="cpu")
    for kw in ({"ck_cache": False}, {"tile_skip": False}):
        other = ct.align(ct.CvoParams(max_iter=30, **kw), _port(x), _port(y),
                         device="cpu")
        assert torch.equal(other.tf, base.tf)
        assert int(other.iterations) == int(base.iterations)


def test_empty_moving_cloud_converges_at_iteration_zero():
    x, _ = _pair(4, 200, 256)
    empty = ct.pad_cloud(np.zeros((0, 3)), capacity=256, device="cpu")
    res = ct.align(ct.CvoParams(), _port(x), empty, device="cpu")
    assert int(res.iterations) == 0 and bool(res.converged)
    assert torch.isfinite(res.tf).all()


@pytest.mark.parametrize("params", [
    ct.AcvoParams(backend="fused"),
    ct.AcvoParams(exp_mode="fast"),
    ct.CvoParams(backend="fused"),
    ct.MATLAB_PARAMS,
    ct.CvoParams(exp_mode="fast"),
])
def test_unported_configurations_raise(params):
    x, y = _pair(5, 100, 128)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ct.align(params, _port(x), _port(y), device="cpu")


@pytest.mark.parametrize("params,match", [
    (ct.AcvoParams(yy_quirk=True), "yy_quirk"),
    (ct.AcvoParams(color_mode="linear"), "linear"),
])
def test_kernel_backend_refuses_what_the_jax_pallas_backend_refuses(
        params, match):
    """As the JAX package's pallas backend (core/registration.py:95-100):
    yy_quirk and linear acvo need the dense backend."""
    x, y = _pair(5, 100, 128)
    with pytest.raises(ValueError, match=match):
        ct.align(params, _port(x), _port(y), device="cpu")


def test_params_from_jax_dict_maps_backends():
    from cvo_rgbd_tpu.params import AcvoParams as JA

    for jb, tb in (("xla", "dense"), ("pallas", "kernel"), ("fused", "fused")):
        got = params_from_jax_dict(dataclasses.asdict(JP(backend=jb, eps=1e-4)))
        assert got == ct.CvoParams(backend=tb, eps=1e-4)
    got = params_from_jax_dict(dataclasses.asdict(JA(backend="pallas")))
    assert got == ct.AcvoParams()
