"""exp_mode="fast" whole aligns in the port against the JAX package's.

At the MATLAB stops, where the hardware exp converges, on the kernel,
dense and fused backends (tf within 3e-4, the JAX suite's stop skew),
and `align_batched` on each.  The JAX
kernel-backend aligns run op by op (`core.registration.align`) with the
Pallas kernels in interpret mode, as tests/test_torch_align.py explains.
The kernels' plain versions, and the fused one after a fixed number of
iterations, are held in tests/test_torch_fastexp.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch.core import cloud as tcloud
from cvo_rgbd_torch.parallel import align_batched
from cvo_rgbd_tpu import align_jit
from cvo_rgbd_tpu.core import registration as jreg
from cvo_rgbd_tpu.core.cloud import PointCloud as JCloud
from cvo_rgbd_tpu.params import MATLAB_PARAMS as J_MATLAB
from cvo_rgbd_tpu.params import AcvoParams as JA
from cvo_rgbd_tpu.params import CvoParams as JC

from test_torch_fastexp import (
    MATLAB_STOPS,
    TF_TOL,
    _fast,
    _pair,
    _params,
    _port,
)
from torch_scenes import rendered_acvo_pair

torch.set_num_threads(2)


# ---- whole aligns at the MATLAB stops -------------------------------------


def _check(got, ref):
    assert bool(got.converged) and bool(ref.converged)
    np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf),
                               atol=TF_TOL)


@pytest.mark.parametrize("color", ["linear", "se"])
@pytest.mark.parametrize("backend", ["kernel", "dense", "fused"])
def test_fast_align_matches_jax(backend, color):
    linear = color == "linear"
    x, y = _pair(4, 230, 256, 3 if linear else 5)
    base = J_MATLAB if linear else JC(**MATLAB_STOPS)
    jname = {"kernel": "pallas", "dense": "xla", "fused": "fused"}[backend]
    jp = _fast(dataclasses.replace(base, backend=jname))
    ref = align_jit(jp, x, y) if backend == "dense" else jreg.align(jp, x, y)
    p = _params(jp)
    assert p.exp_mode == "fast" and p.backend == backend
    _check(ct.align(p, _port(x), _port(y), device="cpu"), ref)


def test_fast_acvo_kernel_align_matches_jax():
    tx, ty = rendered_acvo_pair()
    jx, jy = (JCloud(*(np.asarray(a) for a in c)) for c in (tx, ty))
    jp = _fast(JA(backend="pallas", **MATLAB_STOPS))
    ref = jreg.align(jp, jx, jy)
    got = ct.align(_params(jp), tx, ty, device="cpu")
    _check(got, ref)
    np.testing.assert_allclose(float(got.ell), float(ref.ell), atol=5e-4)


@pytest.mark.parametrize("backend", ["kernel", "dense", "fused"])
def test_fast_align_batched_lanes_are_aligns(backend):
    """align_batched takes exp_mode="fast" on every backend: each lane is
    `align` on its pair (the fused backend in one launch on the card,
    lane by lane on the plain version here)."""
    pairs = [tuple(_port(c) for c in _pair(5 + k, 200 - 30 * k, 256, 3))
             for k in range(2)]
    p = _fast(dataclasses.replace(ct.MATLAB_PARAMS, backend=backend))
    fb = tcloud.stack_clouds([x for x, _ in pairs])
    mb = tcloud.stack_clouds([y for _, y in pairs])
    res = align_batched(p, fb, mb, device="cpu")
    for k, (x, y) in enumerate(pairs):
        one = ct.align(p, x, y, device="cpu")
        assert bool(one.converged)
        assert torch.equal(res.tf[k], one.tf), k
