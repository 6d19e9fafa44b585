"""The port's core math against the JAX package on the same inputs.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm, logm
from scipy.spatial.transform import Rotation

from cvo_rgbd_torch import se3 as tse3
from cvo_rgbd_torch.core import cloud as tcloud
from cvo_rgbd_torch.core import cubic as tcubic
from cvo_rgbd_torch.core import moments as tmom
from cvo_rgbd_torch.core import numerics as tnum
from cvo_rgbd_torch.core import step_factored as tsf
from cvo_rgbd_tpu import se3 as jse3
from cvo_rgbd_tpu.core import cloud as jcloud
from cvo_rgbd_tpu.core import cubic as jcubic
from cvo_rgbd_tpu.core import moments as jmom
from cvo_rgbd_tpu.core import numerics as jnum
from cvo_rgbd_tpu.core import step_factored as jsf

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def test_exp_neg_matches_jax():
    z = np.linspace(0.0, 80.0, 200001, dtype=np.float32)
    got = tnum.exp_neg(T(z)).numpy()
    # op by op, JAX runs the same IEEE operations in the same order:
    # bit-identical
    np.testing.assert_array_equal(got, np.asarray(jnum.exp_neg(jnp.asarray(z))))
    # under jit, XLA:CPU fuses the Horner steps into FMAs: 1 ulp
    assert _ulps(got, jax.jit(jnum.exp_neg)(z)) <= 1


def _rand_w(rng, scale=1.0):
    return (rng.standard_normal(3) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-8, 1e-4, 0.1, 1.0, 2.5])
def test_exp_so3_matches_scipy_and_jax(rng, scale):
    w = _rand_w(rng, scale)
    R = tse3.exp_so3(T(w)).numpy()
    R_ref = Rotation.from_rotvec(w.astype(np.float64)).as_matrix()
    np.testing.assert_allclose(R, R_ref, atol=1e-5)
    # fp32 round-off of the same formula
    np.testing.assert_allclose(R, np.asarray(jse3.exp_so3(w)), atol=1e-6)


@pytest.mark.parametrize("scale", [1e-4, 0.1, 1.0, 2.5])
def test_log_so3_roundtrip(rng, scale):
    w = _rand_w(rng, scale)
    if np.linalg.norm(w) < np.pi - 1e-3:
        w_back = tse3.log_so3(tse3.exp_so3(T(w))).numpy()
        np.testing.assert_allclose(w_back, w, atol=1e-4 * max(1.0, scale))
    R = tse3.exp_so3(T(w))
    np.testing.assert_allclose(
        tse3.exp_so3(tse3.log_so3(R)).numpy(), R.numpy(), atol=1e-4
    )


def test_left_jacobians(rng):
    w, u = _rand_w(rng), _rand_w(rng)
    X = tse3.exp_se3(T(np.concatenate([w, u]))).numpy()
    hat = np.zeros((4, 4))
    hat[:3, :3] = tse3.skew(T(w)).numpy()
    hat[:3, 3] = u
    np.testing.assert_allclose(X, expm(hat), atol=1e-5)
    J = tse3.left_jacobian_so3(T(w)).numpy()
    Ji = tse3.left_jacobian_inv_so3(T(w)).numpy()
    np.testing.assert_allclose(J @ Ji, np.eye(3), atol=1e-5)
    xi = np.concatenate([_rand_w(rng, 0.8), _rand_w(rng)])
    np.testing.assert_allclose(
        tse3.log_se3(tse3.exp_se3(T(xi))).numpy(), xi, atol=1e-4
    )
    np.testing.assert_allclose(
        tse3.left_jacobian_se3(T(xi)).numpy(),
        np.asarray(jse3.left_jacobian_se3(xi)), atol=1e-5,
    )
    np.testing.assert_allclose(
        tse3.adjoint_se3(T(X)).numpy(),
        np.asarray(jse3.adjoint_se3(X.astype(np.float32))), atol=1e-6,
    )


def test_exp_sek3_matches_expm_and_jax(rng):
    w, v = _rand_w(rng), _rand_w(rng)
    dR, dT = tse3.exp_sek3(T(w), T(v), 0.37)
    hat = np.zeros((4, 4))
    hat[:3, :3] = tse3.skew(T(w)).numpy()
    hat[:3, 3] = v
    X_ref = expm(0.37 * hat)
    np.testing.assert_allclose(dR.numpy(), X_ref[:3, :3], atol=1e-5)
    np.testing.assert_allclose(dT.numpy(), X_ref[:3, 3], atol=1e-5)
    jR, jT = jse3.exp_sek3(w, v, np.float32(0.37))
    np.testing.assert_allclose(dR.numpy(), np.asarray(jR), atol=1e-6)
    np.testing.assert_allclose(dT.numpy(), np.asarray(jT), atol=1e-6)


def test_exp_sek3_small_angle_reference_quirk():
    """theta < 1e-6 => Jl = I (LieGroup.cpp:168-170): dT == v, not dt*v."""
    v = np.array([1.0, 2.0, 3.0], np.float32)
    dR, dT = tse3.exp_sek3(torch.zeros(3), T(v), 0.25)
    np.testing.assert_allclose(dR.numpy(), np.eye(3), atol=1e-7)
    np.testing.assert_allclose(dT.numpy(), v, atol=1e-7)


@pytest.mark.parametrize("scale", [1e-3, 0.5, 2.0])
def test_dist_se3_matches_logm_and_jax(rng, scale):
    w, t = _rand_w(rng, scale), _rand_w(rng)
    R = tse3.exp_so3(T(w))
    X = np.eye(4)
    X[:3, :3] = R.numpy()
    X[:3, 3] = t
    d = float(tse3.dist_se3(R, T(t)))
    np.testing.assert_allclose(d, np.linalg.norm(logm(X), "fro"),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        d, float(jse3.dist_se3(R.numpy(), t)), rtol=1e-6, atol=1e-7
    )


def test_se3_inv_and_make_se3(rng):
    R = tse3.exp_so3(T(_rand_w(rng)))
    t = T(_rand_w(rng))
    Ri, ti = tse3.se3_inv(R, t)
    X = tse3.make_se3(R, t).numpy()
    np.testing.assert_allclose(X @ tse3.make_se3(Ri, ti).numpy(), np.eye(4),
                               atol=1e-6)
    np.testing.assert_array_equal(X, np.asarray(jse3.make_se3(R.numpy(),
                                                               t.numpy())))


def _cloud_arrays(rng, n, cap):
    pos = np.zeros((cap, 3), np.float32)
    pos[:n] = rng.standard_normal((n, 3)) * np.array([1.0, 0.5, 0.3])
    feat = np.zeros((cap, 5), np.float32)
    feat[:n] = rng.random((n, 5)) * 255
    mask = np.zeros(cap, np.float32)
    mask[:n] = 1
    return pos, feat, mask


@pytest.mark.parametrize("n,cap", [(200, 256), (600, 640), (1000, 1024)])
def test_kd_sort_same_permutation_as_jax(rng, n, cap):
    pos, feat, mask = _cloud_arrays(rng, n, cap)
    # eager JAX: under jit, XLA:CPU's kd_sort duplicates points
    # (ROADMAP, queue 3); op by op it is the reference permutation
    ref = jcloud.kd_sort(jcloud.PointCloud(jnp.asarray(pos),
                                           jnp.asarray(feat),
                                           jnp.asarray(mask)))
    got = tcloud.kd_sort(tcloud.PointCloud(T(pos), T(feat), T(mask)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cloud_ok_and_transform(rng):
    pos, feat, mask = _cloud_arrays(rng, 100, 128)
    c = tcloud.PointCloud(T(pos), T(feat), T(mask))
    assert bool(tcloud.cloud_ok(c, 64))
    assert not bool(tcloud.cloud_ok(c, 101))
    bad = pos.copy()
    bad[3, 1] = np.nan
    assert not bool(tcloud.cloud_ok(tcloud.PointCloud(T(bad), T(feat),
                                                      T(mask)), 64))
    R = tse3.exp_so3(T([0.1, -0.2, 0.05]))
    t = T([0.3, 0.1, -0.2])
    np.testing.assert_allclose(
        tcloud.transform_cloud(R, t, T(pos)).numpy(),
        np.asarray(jcloud.transform_cloud(R.numpy(), t.numpy(), pos)),
        atol=1e-6,
    )


def test_monomial_features_match_jax(rng):
    x = (rng.standard_normal((300, 3)) * 0.7).astype(np.float32)
    np.testing.assert_array_equal(
        tsf.monomial_features(T(x)).numpy(),
        np.asarray(jsf.monomial_features(jnp.asarray(x))),
    )


def _moment_inputs(rng, m=256):
    """A moment matrix from a real gated Gram (plain torch), so its
    columns have the magnitudes and signs the align loop sees."""
    from cvo_rgbd_torch.ops.gram import scalars
    from cvo_rgbd_torch.ops.moments import pair_weights
    from cvo_rgbd_torch.params import CvoParams

    x = (rng.standard_normal((m, 3)) * 0.3).astype(np.float32)
    y = (x + rng.standard_normal((m, 3)) * 0.02).astype(np.float32)
    feat = (rng.random((m, 5)) * 255).astype(np.float32)
    ones = np.ones(m, np.float32)
    c0 = x.mean(0)
    scal = scalars(torch.tensor(0.1), CvoParams())
    A = pair_weights(T(x - c0), T(feat), T(ones), T(y - c0), T(feat),
                     T(ones), scal)
    Mom = (A.T @ tsf.monomial_features(T(x - c0))).numpy()
    return Mom, y, c0.astype(np.float32)


def test_flow_and_step_from_moments_match_jax(rng):
    Mom, y, c0 = _moment_inputs(rng)
    got = tmom.flow_from_moments(T(Mom), T(y), T(c0), c=7.0, d=7.0)
    Mom128 = np.concatenate([Mom, np.zeros((Mom.shape[0], 93), np.float32)], 1)
    ref = jmom.flow_from_moments(jnp.asarray(Mom128), jnp.asarray(y),
                                 jnp.asarray(c0), c=7.0, d=7.0)
    # the flow is a sum over columns that cancels to a small vector, so
    # fp32 sums taken in another order leave ~1e-5 of it: allow 1e-4
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())
    omega, v = got[0], got[1]
    got = tmom.step_from_moments(T(Mom), T(y), T(c0), omega, v,
                                 torch.tensor(0.1))
    ref = jmom.step_from_moments(jnp.asarray(Mom128), jnp.asarray(y),
                                 jnp.asarray(c0), jnp.asarray(omega.numpy()),
                                 jnp.asarray(v.numpy()), jnp.float32(0.1))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)


@pytest.mark.parametrize("coefs", [
    (1.0, -6.0, 11.0, -6.0),          # roots 1, 2, 3
    (2.0, 0.0, -2.0, 0.5),            # three real roots of mixed sign
    (1.0, 0.0, 1.0, 5.0),             # one real root
    (1e-7, 1.0, -3.0, 2.0),           # huge third root
    (0.0, 1.0, -3.0, 2.0),            # quadratic
    (0.0, 0.0, 2.0, -1.0),            # linear
    (-4.2e-3, 3.1e-2, -0.8, 0.17),    # line-search shaped
])
def test_cubic_roots_match_jax(coefs):
    args = [np.float32(c) for c in coefs]
    roots, valid = tcubic.cubic_roots(*(torch.tensor(c) for c in args))
    jroots, jvalid = jcubic.cubic_roots(*args)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    r, jr = roots.numpy(), np.asarray(jroots)
    ok = np.isfinite(jr)
    np.testing.assert_array_equal(np.isfinite(r), ok)
    # Newton-polished roots of the same polynomial: fp32 round-off
    np.testing.assert_allclose(r[ok], jr[ok], rtol=1e-5, atol=1e-6)
    step = tcubic.min_positive_root(roots, valid, 0.2, 0.8)
    jstep = jcubic.min_positive_root(jroots, jvalid, 0.2, 0.8)
    np.testing.assert_allclose(float(step), float(jstep), rtol=1e-5)
