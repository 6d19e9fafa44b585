"""exp_mode="fast" in the port against the JAX package's exp_mode="fast".

The JAX package's fast form takes jnp.exp(-z) in place of exp_neg in
every Gram kernel (params.py:61-67); the port's plain versions take
torch.exp(-z), its CUDA kernels __expf (held against these plain
versions on a card, tests/test_torch_cuda.py).  The two exps round
differently, so outputs are held by tolerance, never by bits, and a nnz
may differ by at most the pairs whose gate value lies within GATE_BAND of
sp_thres (`ops.moments.near_gate_pairs`).  The Pallas kernels run in
interpret mode on the CPU; the fused plain version is held after a fixed
number of iterations.  Whole aligns are held in
tests/test_torch_fastexp_align.py.
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
from cvo_rgbd_torch.ops import color_gram as t_color_gram
from cvo_rgbd_torch.ops import fused_flow as t_fused_flow
from cvo_rgbd_torch.ops import fused_moments as t_fused_moments
from cvo_rgbd_torch.ops import fused_step_coeffs as t_fused_step
from cvo_rgbd_torch.ops import fused_wsq as t_fused_wsq
from cvo_rgbd_torch.ops import gram as tgram
from cvo_rgbd_torch.ops.gram import pad_feat
from cvo_rgbd_torch.ops.moments import (
    GATE_BAND,
    SKIP_MARGIN,
    TILE_I,
    TILE_J,
    fused_moments_plain,
    near_gate_pairs,
)
from cvo_rgbd_tpu import pad_cloud, se3
from cvo_rgbd_tpu.core import registration as jreg
from cvo_rgbd_tpu.core.cloud import PointCloud as JCloud
from cvo_rgbd_tpu.core.moments import monomial_features_padded
from cvo_rgbd_tpu.ops import color_gram as j_color_gram
from cvo_rgbd_tpu.ops import fused_flow as j_fused_flow
from cvo_rgbd_tpu.ops import fused_moments as j_fused_moments
from cvo_rgbd_tpu.ops import fused_step_coeffs as j_fused_step
from cvo_rgbd_tpu.ops import fused_wsq as j_fused_wsq
from cvo_rgbd_tpu.params import MATLAB_PARAMS as J_MATLAB
from cvo_rgbd_tpu.params import AcvoParams as JA
from cvo_rgbd_tpu.params import CvoParams as JC

from torch_scenes import rendered_acvo_pair

torch.set_num_threads(2)

MODES = ["se", "se_ck", "linear"]
TF_TOL = 3e-4   # the JAX suite's stop skew (tests/test_parallel.py:217)
MATLAB_STOPS = dict(eps=5e-4, eps_2=1e-4)
# __expf's error at the linear gate, |z| = ln(s2 / sp_thres) <= 2.4 at
# the parameter sets below: 2 + floor(1.17 |z|) = 4 ulp of float32
EXPF_REL = 4 * 2.0 ** -23


def _fast(p):
    return dataclasses.replace(p, exp_mode="fast")


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


def _params(jp):
    return params_from_jax_dict(dataclasses.asdict(jp))


def _inputs(mode, seed=0, cap=256):
    """(jax clouds, port clouds with 5 feature planes, jax ck, port ck,
    jax p, port p), both in fast mode."""
    x, y = _pair(seed, cap - 40, cap, 3 if mode == "linear" else 5)
    tx, ty = _port(x), _port(y)
    if mode == "linear":
        jp = _fast(dataclasses.replace(J_MATLAB, backend="pallas"))
        tp = _params(jp)
        tci = t_prepare_ci(tp, tx, ty)
        tx, ty = (c._replace(features=pad_feat(c.features)) for c in (tx, ty))
        return (x, y), (tx, ty), jreg.prepare_ci(jp, x, y), tci, jp, tp
    jp = _fast(JC(backend="pallas"))
    jck = tck = None
    if mode == "se_ck":
        # the color cache stays precise in both packages
        jck = j_color_gram(*x, *y, p=jp, interpret=True)
        tck = t_color_gram(*tx, *ty, p=_params(jp))
    return (x, y), (tx, ty), jck, tck, jp, _params(jp)


def _near(tx, ty, tp, ell, tck, linear):
    """The near-gate pairs of the port's inputs at `ell`, in fast mode."""
    scal = tgram.scalars(torch.tensor(ell, dtype=torch.float32), tp)
    return near_gate_pairs(*tx, *ty, scal, tck, linear)


def _np(t):
    return np.asarray(t, dtype=np.float64)


# ---- the kernels' plain versions against the JAX Pallas kernels ----------


@pytest.mark.parametrize("ell", [0.15, 0.05])
@pytest.mark.parametrize("mode", MODES)
def test_fused_moments_fast_plain_matches_pallas(mode, ell):
    (x, y), (tx, ty), jck, tck, jp, tp = _inputs(mode)
    xp, yp = np.array(x.positions), np.array(y.positions)
    c0 = xp[:200].mean(0).astype(np.float32)
    xc, yc = xp - c0, yp - c0
    ref, ref_nnz = j_fused_moments(
        xc, x.features, x.mask, yc, y.features, y.mask,
        monomial_features_padded(jnp.asarray(xc)), jnp.float32(ell), jck,
        None, p=jp, interpret=True)
    ref = np.asarray(ref)[:, :35]
    txc, tyc = torch.from_numpy(xc), torch.from_numpy(yc)
    args = (txc, tx.features, tx.mask, tyc, ty.features, ty.mask)
    md = tcloud.aabb_min_d2(*tcloud.block_bounds(txc, tx.mask, TILE_I),
                            *tcloud.block_bounds(tyc, ty.mask, TILE_J))
    phi = monomial_features(txc)
    ell_t = torch.tensor(ell)
    mom, nnz = t_fused_moments(*args, phi, ell_t, tck, md, p=tp)
    near = _near((txc, tx.features, tx.mask), (tyc, ty.features, ty.mask),
                 tp, ell, tck, mode == "linear")
    assert abs(float(nnz) - float(ref_nnz)) <= near and float(nnz) > 0
    # tests/test_torch_ops.py: 1e-5 of each moment column's magnitude
    scale = np.abs(ref).max(axis=0)
    assert (np.abs(mom.numpy() - ref) <= 1e-5 * scale).all()
    # the skip drops only zero tiles under torch.exp too
    off = t_fused_moments(*args, phi, ell_t, tck, None, p=tp)
    assert torch.equal(mom, off[0]) and float(nnz) == float(off[1])
    # and the flag reaches the plain version: precise is another form
    precise, _ = fused_moments_plain(
        *args, phi, tgram.scalars(ell_t, tp), tck, None, mode == "linear")
    assert not torch.equal(mom, precise)
    assert torch.allclose(mom, precise, rtol=1e-4,
                          atol=1e-4 * float(scale.max()))


@pytest.mark.parametrize("ell", [0.1, 0.0391])
@pytest.mark.parametrize("use_ck", [False, True])
def test_fused_wsq_fast_plain_matches_pallas(use_ck, ell):
    x = tcloud.kd_sort(rendered_acvo_pair()[0])
    jx = JCloud(*(np.asarray(a) for a in x))
    jp = _fast(JA(backend="pallas"))
    tp = _params(jp)
    ck = j_color_gram(*jx, *jx, p=jp, interpret=True) if use_ck else None
    tck = None if ck is None else torch.from_numpy(np.array(ck))
    ref_wsq, ref_nnz = j_fused_wsq(*jx, *jx, np.float32(ell), ck, None,
                                   p=jp, symmetric=True, interpret=True)
    lo, hi = tcloud.block_bounds(x.positions, x.mask, 64)
    wsq, nnz = t_fused_wsq(*x, *x, torch.tensor(ell, dtype=torch.float32),
                           tck, tcloud.aabb_min_d2(lo, hi, lo, hi), p=tp,
                           symmetric=True)
    assert abs(float(nnz) - float(ref_nnz)) <= _near(x, x, tp, ell, tck,
                                                     False)
    assert float(nnz) > 0
    # one fp32 sum in another order (tests/test_torch_acvo.py)
    np.testing.assert_allclose(float(wsq), float(ref_wsq), rtol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_fused_flow_and_step_fast_plain_match_pallas(mode):
    (x, y), (tx, ty), jck, tck, jp, tp = _inputs(mode, seed=1)
    ell = 0.1
    om_r, v_r, wsq_r, nnz_r, sA_r = j_fused_flow(*x, *y, ell, jck, p=jp,
                                                interpret=True)
    om, v, wsq, nnz, sA = t_fused_flow(*tx, *ty, torch.tensor(ell), tck,
                                       p=tp)
    # tests/test_torch_flow.py's tolerances (tests/test_pallas.py:48-54)
    scale = max(float(np.linalg.norm(_np(om_r))), 1e-8)
    np.testing.assert_allclose(_np(om), _np(om_r), rtol=1e-3,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(_np(v), _np(v_r), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(float(wsq), float(wsq_r), rtol=1e-3)
    assert abs(int(nnz) - int(nnz_r)) <= _near(tx, ty, tp, ell, tck,
                                               mode == "linear")
    np.testing.assert_allclose(float(sA), float(sA_r), rtol=1e-4)
    ref = j_fused_step(*x, *y, jnp.float32(ell), om_r, v_r, jck, p=jp,
                       interpret=True)
    got = t_fused_step(*tx, *ty, torch.tensor(ell),
                       torch.from_numpy(np.array(om_r)),
                       torch.from_numpy(np.array(v_r)), tck, p=tp)
    for g, r in zip(got, ref):   # tests/test_pallas.py:68-69
        np.testing.assert_allclose(float(g), float(r), rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("max_iter", [1, 10])
@pytest.mark.parametrize("jp", [JC(backend="fused"), JA(backend="fused"),
                                dataclasses.replace(J_MATLAB,
                                                    backend="fused")],
                         ids=["cvo", "acvo", "linear"])
def test_align_fused_fast_fixed_iterations_match_jax(jp, max_iter):
    """The fused plain version's state after a fixed number of
    iterations, against the JAX fused kernel's fast form (resident)."""
    jp = _fast(dataclasses.replace(jp, max_iter=max_iter, eps=0.0,
                                   eps_2=0.0))
    linear = jp.color_mode == "linear"
    x, y = _pair(2, 200, 256, 3 if linear else 5)
    ref = jreg.align(jp, x, y)
    got = ct.align(_params(jp), _port(x), _port(y), device="cpu")
    assert int(got.iterations) == int(ref.iterations) == max_iter - 1
    # tests/test_torch_fused.py: 1e-5 after 1 iteration, 1e-4 after 10
    tol = 1e-5 if max_iter == 1 else 1e-4
    for name in ("R", "T", "ell", "omega", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=tol,
                                   err_msg=name)


# ---- the exact tile skip in linear mode ----------------------------------


@pytest.mark.parametrize("p", [ct.MATLAB_PARAMS, ct.CvoParams(),
                               ct.AcvoParams()],
                         ids=["matlab", "cvo", "acvo"])
def test_skip_margin_covers_the_hardware_exp(p):
    """A skipped tile's pairs all lie beyond d2_thres + SKIP_MARGIN.  In
    linear mode the gate is k >= sp_thres alone, so k there must stay
    below sp_thres under the hardware exp too: the margin's relative gap
    1 - exp(-SKIP_MARGIN / 2 ell^2) must exceed __expf's error at the
    gate, with the rounding of z, by a wide factor.  At every ell the
    schedules, the warm starts and acvo reach (ell_init and the schedule
    of cvo; acvo's ceiling ell_max_init down to ell_min)."""
    ells = {p.ell_init}
    if isinstance(p, ct.AcvoParams):
        ells |= {p.ell_max_init, p.ell_min}
    else:
        ells |= {e for _, e in p.ell_sched}
    z_gate = np.log(p.sigma ** 2 / p.sp_thres)
    assert z_gate <= 2.4          # EXPF_REL's bound holds here
    for ell in sorted(ells):
        scal = tgram.scalars(torch.tensor(ell, dtype=torch.float32), p)
        d2 = scal[tgram.S_D2_THRES] + SKIP_MARGIN      # float32, rounded
        z = d2 * scal[tgram.S_INV_2L2]
        k = scal[tgram.S_S2] * torch.exp(-z)
        gap = 1.0 - float(k) / p.sp_thres
        exact_gap = -np.expm1(-SKIP_MARGIN / (2.0 * ell * ell))
        assert gap >= 0.5 * exact_gap, (ell, gap, exact_gap)
        # __expf's error plus z's rounding, ten times over
        assert gap > 10 * (EXPF_REL + float(z) * 2.0 ** -24), (ell, gap)
        # and the near-gate band the card checks use lies inside the gap
        assert GATE_BAND < gap, (ell, gap)


def test_no_pair_beyond_the_margin_passes_the_fast_linear_gate():
    """The plain version takes k out to d2_thres + SKIP_MARGIN in linear
    mode: in fast mode, as in precise, no pair beyond the margin passes
    the gate k >= sp_thres, at any ell of the MATLAB schedule."""
    from cvo_rgbd_torch.core.gram import pairwise_sqdist

    (_, _), (tx, ty), _, _, _, tp = _inputs("linear", seed=3)
    d2 = pairwise_sqdist(tx.positions, ty.positions)
    for ell in (0.15, 0.1, 0.06, 0.03):
        scal = tgram.scalars(torch.tensor(ell), tp)
        k = scal[tgram.S_S2] * torch.exp(-(d2 * scal[tgram.S_INV_2L2]))
        beyond = d2 > scal[tgram.S_D2_THRES] + SKIP_MARGIN
        assert beyond.any() and not (beyond & (k >= scal[tgram.S_SP_THRES])
                                     ).any(), ell
