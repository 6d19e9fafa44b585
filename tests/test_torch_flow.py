"""The two-pass sweeps' plain versions against the JAX package's Pallas
`fused_flow` and `fused_step_coeffs` (interpret mode on the CPU, as
tests/test_pallas.py runs them), in se mode without and with the color
cache and in MATLAB's linear mode with the masked CI.  The CUDA kernels
are held against these plain versions on a card (tests/test_torch_cuda.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvo_rgbd_torch.convert import cloud_from_numpy
from cvo_rgbd_torch.core.registration import prepare_ci as t_prepare_ci
from cvo_rgbd_torch.ops import color_gram as t_color_gram
from cvo_rgbd_torch.ops import fused_flow as t_fused_flow
from cvo_rgbd_torch.ops import fused_step_coeffs as t_fused_step
from cvo_rgbd_torch.ops.gram import pad_feat
from cvo_rgbd_torch.params import MATLAB_PARAMS as T_MATLAB
from cvo_rgbd_torch.params import CvoParams as TP
from cvo_rgbd_tpu import pad_cloud, se3
from cvo_rgbd_tpu.core.registration import prepare_ci as j_prepare_ci
from cvo_rgbd_tpu.ops import color_gram as j_color_gram
from cvo_rgbd_tpu.ops import fused_flow as j_fused_flow
from cvo_rgbd_tpu.ops import fused_step_coeffs as j_fused_step
from cvo_rgbd_tpu.params import MATLAB_PARAMS as J_MATLAB
from cvo_rgbd_tpu.params import CvoParams as JP

torch.set_num_threads(2)

J_LINEAR = dataclasses.replace(J_MATLAB, backend="pallas")
MODES = ["se", "se_ck", "linear"]


def _pair(seed, n, cap, nfeat):
    """tests/test_pallas.py's pair: rotated, shifted, overlapping, padded."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n + 30, 3)).astype(np.float32) * 0.4
    feat = (rng.random((n + 30, 5)) * np.array([255, 255, 255, 60, 60]))
    feat = feat[:, :nfeat].astype(np.float32)
    R = np.asarray(se3.exp_so3(np.array([0.01, -0.012, 0.008], np.float32)))
    t = np.array([0.02, -0.01, 0.015], np.float32)
    yp = (base[20:20 + n] @ R.T + t).astype(np.float32)
    return (pad_cloud(base[:n], feat[:n], capacity=cap),
            pad_cloud(yp, feat[20:20 + n], capacity=cap))


def _port(cloud):
    return cloud_from_numpy(*(np.asarray(a) for a in cloud), device="cpu")


def _inputs(mode, seed=0, n=None, cap=256):
    """(jax clouds, port clouds, jax ck, port ck, jax p, port p): the
    port builds its own cache from the same numpy inputs."""
    x, y = _pair(seed, n or cap - 40, cap, 3 if mode == "linear" else 5)
    tx, ty = _port(x), _port(y)
    if mode == "linear":
        # the port's kernels read 5 feature planes (align pads them)
        tci = t_prepare_ci(T_MATLAB, tx, ty)
        tx, ty = (c._replace(features=pad_feat(c.features)) for c in (tx, ty))
        return ((x, y), (tx, ty), j_prepare_ci(J_LINEAR, x, y), tci,
                J_LINEAR, T_MATLAB)
    jck = tck = None
    if mode == "se_ck":
        jck = j_color_gram(*x, *y, p=JP(), interpret=True)
        tck = t_color_gram(*tx, *ty, p=TP())
    return (x, y), (tx, ty), jck, tck, JP(), TP()


def _np(t):
    return np.asarray(t, dtype=np.float64)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cap", [256, 512])
def test_fused_flow_plain_matches_pallas(mode, cap):
    (x, y), (tx, ty), jck, tck, jp, tp = _inputs(mode, cap=cap)
    ell = 0.1
    om_r, v_r, wsq_r, nnz_r, sA_r = j_fused_flow(*x, *y, ell, jck, p=jp,
                                                interpret=True)
    om, v, wsq, nnz, sA = t_fused_flow(*tx, *ty, torch.tensor(ell), tck,
                                       p=tp)
    # tests/test_pallas.py:48-54: tile-order fp32 accumulation
    scale = max(float(np.linalg.norm(_np(om_r))), 1e-8)
    np.testing.assert_allclose(_np(om), _np(om_r), rtol=1e-3,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(_np(v), _np(v_r), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(float(wsq), float(wsq_r), rtol=1e-3)
    assert int(nnz) == int(nnz_r) > 0
    np.testing.assert_allclose(float(sA), float(sA_r), rtol=1e-4)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cap", [256, 512])
def test_fused_step_coeffs_plain_matches_pallas(mode, cap):
    (x, y), (tx, ty), jck, tck, jp, tp = _inputs(mode, seed=1, cap=cap)
    ell = jnp.float32(0.1)
    om, v, *_ = j_fused_flow(*x, *y, ell, jck, p=jp, interpret=True)
    ref = j_fused_step(*x, *y, ell, om, v, jck, p=jp, interpret=True)
    got = t_fused_step(*tx, *ty, torch.tensor(0.1), torch.from_numpy(
        np.array(om)), torch.from_numpy(np.array(v)), tck, p=tp)
    # tests/test_pallas.py:68-69
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=2e-3, atol=1e-6)


def test_color_cache_gives_the_same_bits():
    """With the color_gram cache the sweeps reproduce the recompute path
    bit for bit (tests/test_pallas.py:142-168)."""
    _, (tx, ty), _, tck, _, tp = _inputs("se_ck", seed=2)
    ell = torch.tensor(0.1)
    ref = t_fused_flow(*tx, *ty, ell, p=tp)
    got = t_fused_flow(*tx, *ty, ell, tck, p=tp)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    ref_s = t_fused_step(*tx, *ty, ell, ref[0], ref[1], p=tp)
    got_s = t_fused_step(*tx, *ty, ell, ref[0], ref[1], tck, p=tp)
    for a, b in zip(ref_s, got_s):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_padding_contributes_nothing(mode):
    """Padded rows poisoned with far-off positions change nothing
    (tests/test_pallas.py:72-88); the JAX kernel agrees."""
    (x, y), (tx, ty), jck, tck, jp, tp = _inputs(mode, seed=3, n=100)
    ell = torch.tensor(0.1)
    clean = t_fused_flow(*tx, *ty, ell, tck, p=tp)
    xp2 = tx.positions.clone()
    xp2[100:] = 7.7
    poisoned = t_fused_flow(xp2, tx.features, tx.mask, *ty, ell, tck, p=tp)
    for a, b in zip(clean[:2], poisoned[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    j_poisoned = j_fused_flow(jnp.asarray(xp2.numpy()), x.features, x.mask,
                              *y, 0.1, jck, p=jp, interpret=True)
    for a, b in zip(poisoned[:2], j_poisoned[:2]):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("fn", ["flow", "step"])
def test_wrappers_refuse_what_the_jax_ones_refuse(fn):
    """A capacity that is not a multiple of 128, and linear mode without
    the CI cache, raise ValueError as pallas_gram.py:319, 429-430 do."""
    _, (tx, ty), _, _, _, tp = _inputs("se")
    ell, w = torch.tensor(0.1), torch.zeros(3)

    def call(x, p):
        if fn == "flow":
            return t_fused_flow(*x, *ty, ell, p=p)
        return t_fused_step(*x, *ty, ell, w, w, p=p)

    with pytest.raises(ValueError, match="multiples of 128"):
        call([t[:100] for t in tx], tp)
    with pytest.raises(ValueError, match="ci cache"):
        call(tx, T_MATLAB)


@pytest.mark.parametrize("adaptive", [False, True], ids=["cvo", "acvo"])
def test_direct_step_align_matches_jax_xla_direct(adaptive):
    """The kernel backend under step_mode="direct" (the two sweeps each
    iteration; acvo adds its self sweeps) against the JAX dense backend's
    direct line search, at the MATLAB stops, on the rendered acvo pair
    (whose self-Grams have neighbours)."""
    from cvo_rgbd_torch import AcvoParams, align
    from cvo_rgbd_tpu import align_jit
    from cvo_rgbd_tpu.params import AcvoParams as JA

    from torch_scenes import rendered_acvo_pair

    stops = dict(step_mode="direct", eps=5e-4, eps_2=1e-4)
    x, y = rendered_acvo_pair()
    jx, jy = (pad_cloud(c.positions[:int(c.mask.sum())].numpy(),
                        c.features[:int(c.mask.sum())].numpy(),
                        capacity=c.capacity) for c in (x, y))
    jp = (JA if adaptive else JP)(**stops)
    ref = align_jit(jp, jx, jy)
    got = align((AcvoParams if adaptive else TP)(**stops), _port(jx),
                _port(jy), device="cpu")
    assert bool(got.converged) and bool(ref.converged)
    assert abs(int(got.iterations) - int(ref.iterations)) <= 2
    # the JAX suite's stop skew (tests/test_parallel.py:217)
    np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf), atol=3e-4)
