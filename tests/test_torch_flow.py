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


def _sorted_inputs(mode, seed=4, n=None, cap=512, m_cap=None, empty=False):
    """(port clouds kd-sorted, ck, params) of a sweep in `mode`; the
    moving cloud at capacity `m_cap` (default `cap`).  With `empty`, the
    second row block of the fixed cloud and the second column tile of the
    moving one are made invalid (their positions kept), and the cache is
    built after, as the kernel backend builds it from the masks."""
    from cvo_rgbd_torch import pad_cloud as t_pad_cloud
    from cvo_rgbd_torch.core.cloud import kd_sort
    from cvo_rgbd_torch.ops import flow

    m_cap = m_cap or cap
    n = n or min(cap, m_cap) - 40
    rng = np.random.default_rng(seed)
    # a noisy copy of a 2 x 1.5 x 1 m volume: neighbours within ell 0.03
    pos = rng.random((n, 3)) * np.array([2.0, 1.5, 1.0]) + np.array(
        [-1.0, -0.7, 1.0])
    feat = rng.random((n, 5)) * np.array([255, 255, 255, 60, 60])
    feat = feat[:, :3] if mode == "linear" else feat
    tx, ty = (kd_sort(t_pad_cloud(q, feat, c, device="cpu")) for q, c in (
        (pos, cap), (pos + rng.normal(0.0, 0.01, pos.shape), m_cap)))
    if empty:
        xm, ym = tx.mask.clone(), ty.mask.clone()
        xm[flow.ROWS:2 * flow.ROWS] = 0.0
        ym[flow.TILE_J:2 * flow.TILE_J] = 0.0
        tx, ty = tx._replace(mask=xm), ty._replace(mask=ym)
    if mode == "linear":
        ck = t_prepare_ci(T_MATLAB, tx, ty)
        tx, ty = (c._replace(features=pad_feat(c.features)) for c in (tx, ty))
        return tx, ty, ck, T_MATLAB
    ck = t_color_gram(*tx, *ty, p=TP()) if mode == "se_ck" else None
    return tx, ty, ck, TP()


def _block_tree(v):
    """csrc/fused_flow.cu's block_sum over its 128 threads' values v
    [128, k]: each warp's shuffle-down tree, then the warps in order."""
    w = v.reshape(4, 32, -1).clone()
    for off in (16, 8, 4, 2, 1):
        w[:, :32 - off] = w[:, :32 - off] + w[:, off:]
    total = torch.zeros_like(w[0, 0])
    for k in range(4):
        total = total + w[k, 0]
    return total


def _item_sums(xp, yp, A, keep):
    """A torch transcription of csrc/fused_flow.cu's work split: each
    (ROWS, TILE_J) item's flow partial (the rows' residuals over the
    item's columns, then summed over its rows), and the kept items'
    partials summed in item order as the last block sums them (items t,
    t + 128, ... in thread t, then the block's tree), the all-zero sign
    made +0 as its last write makes it."""
    from cvo_rgbd_torch.ops import flow

    nbi, nbj = xp.shape[0] // flow.ROWS, yp.shape[0] // flow.TILE_J
    a = A.reshape(nbi, flow.ROWS, nbj, flow.TILE_J)
    x = xp.reshape(nbi, flow.ROWS, 1, 3)
    sA = a.sum(-1)
    r = torch.einsum("iajb,jbk->iajk", a,
                     yp.reshape(nbj, flow.TILE_J, 3)) - sA[..., None] * x
    x0, x1, x2 = x.unbind(-1)
    r0, r1, r2 = r.unbind(-1)
    part = torch.stack([x1 * r2 - x2 * r1, x2 * r0 - x0 * r2,
                        x0 * r1 - x1 * r0, r0, r1, r2, sA], -1).sum(1)
    part, kept = part.reshape(nbi * nbj, -1), keep.reshape(-1)
    acc = torch.zeros(128, part.shape[1])
    for k0 in range(0, part.shape[0], 128):
        rows, use = part[k0:k0 + 128], kept[k0:k0 + 128, None]
        acc[:len(rows)] = torch.where(use, acc[:len(rows)] + rows,
                                      acc[:len(rows)])
    return _block_tree(acc) + 0.0


def _skip_checks(tx, ty, ck, p, ell):
    """The skip rule (flow.tile_keep) holds every nonzero A, the plain
    sweeps with the dropped tiles zeroed give the full ones' bits, and
    the kernel's work split gives the same bits with the skip on and
    off.  Returns the share of tiles kept."""
    from cvo_rgbd_torch.ops import flow, gram
    from cvo_rgbd_torch.ops.moments import pair_weights

    linear = p.color_mode == "linear"
    scal = gram.scalars(torch.tensor(ell), p)
    keep = flow.tile_keep(tx.positions, tx.mask, ty.positions, ty.mask,
                          scal)
    assert keep.shape == (tx.capacity // flow.ROWS,
                          ty.capacity // flow.TILE_J)
    A = pair_weights(*tx, *ty, scal, ck, linear)
    assert (A != 0).any()
    dense = keep.repeat_interleave(flow.ROWS, 0).repeat_interleave(
        flow.TILE_J, 1)
    assert not (A != 0)[~dense].any()
    args = (*tx, *ty, scal)
    full = flow.fused_flow_plain(*args, ck, linear)
    wv = torch.cat([full[0:3] / p.c, full[3:6] / p.d])
    for got, ref in (
            (flow.fused_flow_plain(*args, ck, linear, keep=keep), full),
            (flow.fused_step_coeffs_plain(*args, wv, ck, linear, keep=keep),
             flow.fused_step_coeffs_plain(*args, wv, ck, linear))):
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    on = _item_sums(tx.positions, ty.positions, A, keep)
    off = _item_sums(tx.positions, ty.positions, A, torch.ones_like(keep))
    assert torch.equal(on.view(torch.int32), off.view(torch.int32))
    # the split sums in another order than the plain version: 1e-4 of
    # each output's magnitude, as the kernel is held on the card
    for sl in (slice(0, 3), slice(3, 6), slice(7, 8)):
        assert (on[sl] - full[sl]).norm() <= 1e-4 * full[sl].norm()
    return keep.float().mean().item()


@pytest.mark.parametrize("ell", [0.1, 0.03])
@pytest.mark.parametrize("mode", MODES)
def test_tile_skip_rule_and_work_split_are_exact(mode, ell):
    """On kd-sorted clouds at the kernel's (128, 32) tiles: the skip
    drops tiles and keeps every nonzero A, in all three modes."""
    tx, ty, ck, p = _sorted_inputs(mode)
    kept = _skip_checks(tx, ty, ck, p, ell)
    assert 0.0 < kept < 1.0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,m", [(512, 256), (256, 384)])
def test_tile_skip_with_an_invalid_tile_and_unequal_clouds(mode, n, m):
    """N != M, with an all-invalid row block and column tile: their
    boxes are empty and every item holding them is dropped."""
    from cvo_rgbd_torch.ops import flow, gram

    tx, ty, ck, p = _sorted_inputs(mode, n=min(n, m) - 40, cap=n, m_cap=m,
                                   empty=True)
    _skip_checks(tx, ty, ck, p, 0.1)
    keep = flow.tile_keep(tx.positions, tx.mask, ty.positions, ty.mask,
                          gram.scalars(torch.tensor(0.1), p))
    assert not keep[1].any() and not keep[:, 1].any()
