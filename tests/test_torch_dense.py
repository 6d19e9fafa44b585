"""The port's dense backend (`backend="dense"`) against the JAX package's
"xla" backend, function by function and as a whole align.

Inputs: `torch_scenes.rendered_acvo_pair` (acvo frontend, capacity 512)
and, for dl and the linear-color functions, numpy clouds made from a
seed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch.convert import params_from_jax_dict
from cvo_rgbd_torch.core import flow as tflow
from cvo_rgbd_torch.core import gram as tgram
from cvo_rgbd_torch.core import step as tstep
from cvo_rgbd_torch.core.registration import (
    function_inner_product as t_fip,
)
from cvo_rgbd_torch.core.step_factored import step_coefficients_factored
from cvo_rgbd_tpu import align_jit
from cvo_rgbd_tpu.core import flow as jflow
from cvo_rgbd_tpu.core import gram as jgram
from cvo_rgbd_tpu.core import step as jstep
from cvo_rgbd_tpu.core import step_factored as jsf
from cvo_rgbd_tpu.core.cloud import PointCloud as JCloud
from cvo_rgbd_tpu.core.registration import (
    function_inner_product as j_fip,
)
from cvo_rgbd_tpu.params import AcvoParams as JA
from cvo_rgbd_tpu.params import CvoParams as JC

from torch_scenes import rendered_acvo_pair

torch.set_num_threads(2)

P = ct.AcvoParams()
KW = dict(sigma=P.sigma, c_ell=P.c_ell, c_sigma=P.c_sigma,
          sp_thres=P.sp_thres, c_sp_thres=P.c_sp_thres)
# the twist the line-search coefficients are taken along
OMEGA = np.array([0.004, -0.006, 0.003], np.float32)
V = np.array([0.01, 0.004, -0.008], np.float32)


@pytest.fixture(scope="module")
def pair():
    """numpy (positions, features, mask) of the first rendered pair."""
    return [[t.numpy() for t in c] for c in rendered_acvo_pair()]


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _grams(x, y, ell=0.1):
    """JAX and port A, Axx, Ayy at `ell`."""
    ref = [np.asarray(jgram.se_gram(*a, *b, np.float32(ell), **KW))
           for a, b in ((x, y), (x, x), (y, y))]
    got = [tgram.se_gram(*map(T, a), *map(T, b), torch.tensor(ell), **KW)
           for a, b in ((x, y), (x, x), (y, y))]
    return ref, got


def test_pairwise_sqdist_matches_jax(pair):
    x, y = pair
    ref = np.asarray(jgram.pairwise_sqdist(x[0], y[0]))
    got = tgram.pairwise_sqdist(T(x[0]), T(y[0])).numpy()
    # the same three differences squared and summed in order
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ell", [0.15, 0.0391])
def test_se_gram_matches_jax(pair, ell):
    x, y = pair
    ref, got = _grams(x, y, ell)
    for r, g in zip(ref, got):
        g = g.numpy()
        # same gates; exp_neg within an ulp of values <= s2 * cs2 = 0.01
        np.testing.assert_array_equal(g > 0, r > 0)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-9)
        assert (r > 0).sum() > 0


def test_flow_matches_jax(pair):
    x, y = pair
    ref, got = _grams(x, y)
    om_r, v_r = jflow.flow(ref[0], x[0], y[0], c=P.c, d=P.d)
    om, v = tflow.flow(got[0], T(x[0]), T(y[0]), c=P.c, d=P.d)
    # difference-form row sums in another order: 1e-4 of the flow's size
    for g, r in ((om, om_r), (v, v_r)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


@pytest.mark.parametrize("yy_quirk", [False, True])
def test_adaptive_dl_matches_jax(rng, yy_quirk):
    """On a compact patch near the origin.  dl's factored sums
    A.(|x|^2 + |y|^2 - 2 x.y) cancel by |x|^2 / |x - y|^2, then the
    numerator cancels again, so at camera-frame coordinates either
    package's fp32 dl carries summation-order noise: on the rendered pair
    at ell=0.1, 6.8e-3 (JAX) and 9.2e-4 (port) relative to an fp64 dl.
    On the patch the two agree to 1e-4 of the cancelling terms' size."""
    n = 400
    xp = (rng.standard_normal((n, 3)) * 0.1).astype(np.float32)
    xf = (rng.random((n, 5)) * 0.2).astype(np.float32)
    yp = (xp + rng.standard_normal((n, 3)) * 0.01).astype(np.float32)
    yf = (xf + rng.standard_normal((n, 5)) * 0.002).astype(np.float32)
    m = np.ones(n, np.float32)
    m[350:] = 0.0
    x, y = (xp, xf, m), (yp, yf, m)
    ref, got = _grams(x, y)
    assert min((r > 0).sum() for r in ref) > 2 * n   # real neighbourhoods
    n_fixed = 300.0   # the quirk's row split, inside the valid rows
    dl_r = jflow.adaptive_dl(*ref, xp, yp, np.float32(0.1),
                             num_fixed=n_fixed, yy_quirk=yy_quirk)
    dl = tflow.adaptive_dl(*got, T(xp), T(yp), torch.tensor(0.1),
                           num_fixed=torch.tensor(n_fixed),
                           yy_quirk=yy_quirk)
    ws = tflow.weighted_sqdist_sum
    terms = (abs(float(ws(got[2], T(yp), T(yp))))
             + 2 * abs(float(ws(got[0], T(xp), T(yp))))
             + abs(float(ws(got[1], T(xp), T(xp)))))
    denom = sum(int(tflow.nnz(a)) for a in got[1:]) - 2 * int(
        tflow.nnz(got[0]))
    scale = terms / 0.1 ** 3 / abs(denom)
    assert abs(float(dl) - float(dl_r)) <= 1e-4 * scale
    assert int(tflow.nnz(got[0])) == int(jflow.nnz(ref[0]))


@pytest.mark.parametrize("mode", ["factored", "direct"])
def test_step_matches_jax(pair, mode):
    x, y = pair
    ref, got = _grams(x, y)
    ell = 0.1
    args_r = (ref[0], x[0], y[0], OMEGA, V, np.float32(ell))
    args_t = (got[0], T(x[0]), T(y[0]), T(OMEGA), T(V), torch.tensor(ell))
    if mode == "factored":
        coef_r = jsf.step_coefficients_factored(*args_r)
        coef = step_coefficients_factored(*args_t)
    else:
        coef_r = jstep.step_coefficients(*args_r)
        coef = tstep.step_coefficients(*args_t)
    for g, r in zip(coef, coef_r):
        # sums of large cancelling polynomial terms: 1e-4 relative
        np.testing.assert_allclose(float(g), float(r), rtol=1e-4, atol=1e-7)
    step_r = jstep.step_size(*args_r, min_step=P.min_step,
                             max_step=P.max_step)
    step = tstep.step_size(*args_t, min_step=P.min_step, max_step=P.max_step)
    np.testing.assert_allclose(float(step), float(step_r), rtol=1e-4)


@pytest.mark.parametrize("params", ["acvo", "linear"])
def test_function_inner_product_matches_jax(pair, rng, params):
    x, y = pair
    if params == "linear":
        jp = JC(color_mode="linear", sp_thres=1e-3)
        feat = [rng.random((512, 3)).astype(np.float32) for _ in range(2)]
        x, y = ((c[0], f, c[2]) for c, f in zip((x, y), feat))
    else:
        jp = JA()
    p = params_from_jax_dict(dataclasses.asdict(jp))
    for a, b in ((x, y), (x, x)):
        ref = float(j_fip(jp, JCloud(*a), JCloud(*b), ell=0.1))
        got = float(t_fip(p, ct.PointCloud(*map(T, a)),
                          ct.PointCloud(*map(T, b)), ell=0.1))
        np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_linear_color_grams_match_jax(rng):
    xp, yp = (rng.standard_normal((256, 3)).astype(np.float32) * 0.3
              for _ in range(2))
    xf, yf = (rng.random((256, 3)).astype(np.float32) * 255 for _ in range(2))
    m = (rng.random(256) > 0.2).astype(np.float32)
    ci_r = jgram.linear_color_gram(xf, yf, 1e-5)
    ci = tgram.linear_color_gram(T(xf), T(yf), 1e-5)
    np.testing.assert_allclose(ci.numpy(), np.asarray(ci_r), rtol=1e-6)
    ref = np.asarray(jgram.matlab_gram(xp, m, yp, m, ci_r, jnp.float32(0.15),
                                       sigma=0.1, sp_thres=1e-3))
    got = tgram.matlab_gram(T(xp), T(m), T(yp), T(m), ci, torch.tensor(0.15),
                            sigma=0.1, sp_thres=1e-3).numpy()
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)


# cvo at the MATLAB stops: at the C++ stops its last iterations contract
# so slowly that summation order moves the stop by ~5%.  acvo at the C++
# stops: ell settles on its floor there, while at the MATLAB stops the
# run stops right after a ceiling shrink whose iteration the dense dl's
# summation-order noise decides.
@pytest.mark.parametrize("jp", [
    JC(eps=5e-4, eps_2=1e-4),
    JA(),
], ids=["cvo", "acvo"])
def test_dense_align_matches_jax_xla(pair, jp):
    x, y = pair
    ref = align_jit(jp, JCloud(*x), JCloud(*y))
    p = params_from_jax_dict(dataclasses.asdict(jp))
    assert p.backend == "dense"
    got = ct.align(p, ct.PointCloud(*map(T, x)), ct.PointCloud(*map(T, y)),
                   device="cpu")
    assert bool(got.converged) and bool(ref.converged)
    assert abs(int(got.iterations) - int(ref.iterations)) <= 2
    # the JAX suite's stop-skew tolerance (tests/test_parallel.py:217)
    np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf), atol=3e-4)
