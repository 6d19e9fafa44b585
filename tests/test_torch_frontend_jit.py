"""The compiled frontend and the odometry step's compiled bookkeeping.

`make_frontend`'s processor (`frontend.pipeline.Frontend`) runs
`_process` as one captured program per input key, the float32
conversion inside; `odometry._odom_step` folds its bookkeeping into one
captured program per key.  On the CPU both run uncaptured on the same
static tensors, so these tests hold the keying, the copies in and the
fresh copies out: the JAX package's frontend within
tests/test_torch_frontend.py's tolerance, `_process`'s bits called
directly, and the eager step's bits.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvo_rgbd_torch import odometry
from cvo_rgbd_torch import synth as tsynth
from cvo_rgbd_torch.core.cloud import PointCloud, cloud_ok
from cvo_rgbd_torch.core.registration import AlignResult
from cvo_rgbd_torch.evaluation import nan_cloud
from cvo_rgbd_torch.frontend import make_frontend
from cvo_rgbd_torch.frontend.camera import get_camera
from cvo_rgbd_torch.frontend.pipeline import Frontend, _process
from cvo_rgbd_torch.params import AcvoParams, CvoParams
from cvo_rgbd_tpu.frontend import make_frontend as j_make_frontend

torch.set_num_threads(2)

NUM_WANT = 1024
SIZES = [(96, 128), (240, 320)]


@pytest.fixture(scope="module")
def renders():
    """Two frames of the revisit path at each size, as the PNG loader
    gives them: uint8 RGB, uint16 depth."""
    out = {}
    for size in SIZES:
        frames = tsynth.render_frames(tsynth.revisit_path(2, period=33),
                                      tsynth.BandScene(*size))
        out[size] = [(f[2].astype(np.uint8), f[3].astype(np.uint16))
                     for f in frames]
    return out


def _eager(rgb, dep, feature_type, bgr_quirk=False):
    """`_process` called directly, after the host-side float32 conversion
    the processor used to make."""
    return _process(torch.as_tensor(rgb, dtype=torch.float32),
                    torch.as_tensor(dep, dtype=torch.float32),
                    cam=get_camera(1), num_want=NUM_WANT,
                    feature_type=feature_type, dep_thres=20000.0, pot=3,
                    bgr_quirk=bgr_quirk)


def _same(a, b):
    """The same bits, field by field (NaN too)."""
    return all(x.dtype == y.dtype and x.shape == y.shape
               and x.numpy().tobytes() == y.numpy().tobytes()
               for x, y in zip(a, b))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("feature_type,bgr_quirk",
                         [(1, False), (0, False), (1, True)])
def test_compiled_frontend_matches_jax(renders, size, feature_type,
                                       bgr_quirk):
    jf = j_make_frontend(1, NUM_WANT, feature_type, bgr_quirk=bgr_quirk)
    tf = make_frontend(1, NUM_WANT, feature_type, bgr_quirk=bgr_quirk,
                       device="cpu")
    assert isinstance(tf, Frontend)
    for rgb, dep in renders[size]:
        ref = jf(jnp.asarray(rgb, jnp.float32), jnp.asarray(dep, jnp.float32))
        got = tf(rgb, dep)
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
        assert got.mask.sum() > 300
        # tests/test_torch_frontend.py's tolerance: XLA's fusion rounds
        # the backprojection otherwise
        np.testing.assert_allclose(got.positions.numpy(),
                                   np.asarray(ref.positions),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.features.numpy(),
                                   np.asarray(ref.features),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("inputs", ["raw", "float32"])
@pytest.mark.parametrize("feature_type", [1, 0])
def test_compiled_frontend_has_the_bits_of_process(renders, inputs,
                                                   feature_type):
    fe = make_frontend(1, NUM_WANT, feature_type, device="cpu")
    for size in SIZES:
        for rgb, dep in renders[size]:
            if inputs == "float32":
                rgb, dep = rgb.astype(np.float32), dep.astype(np.float32)
            got = fe(rgb, dep)
            assert got.capacity == 1024 and got.features.shape == (1024, 5)
            assert _same(got, _eager(rgb, dep, feature_type))


def test_compiled_frontend_zero_and_nan_depth(renders):
    """Holes in the depth (zero) and NaN depth fail the gates as in
    `_process` (a NaN depth leaves NaN in its slot's position, masked
    off, as in the JAX package)."""
    fe = make_frontend(1, NUM_WANT, 1, device="cpu")
    rgb, dep = renders[SIZES[0]][0]
    dep = dep.astype(np.float32)
    dep[10:40, 20:90] = 0.0
    dep[50:70, 30:110] = np.nan
    got = fe(rgb, dep)
    assert _same(got, _eager(rgb, dep, 1))
    valid = got.mask > 0
    assert torch.isfinite(got.positions[valid]).all()
    assert not torch.isfinite(got.positions[~valid]).all()
    clean = fe(rgb, renders[SIZES[0]][0][1])
    assert got.mask.sum() < clean.mask.sum()


def test_compiled_frontend_returns_clouds_of_their_own(renders):
    """A later frame leaves an earlier cloud as it was: the program's
    static output is copied out, once, on every call."""
    fe = make_frontend(1, NUM_WANT, 1, device="cpu")
    (r0, d0), (r1, d1) = renders[SIZES[0]]
    first = fe(r0, d0)
    kept = [t.clone() for t in first]
    second = fe(r1, d1)
    assert _same(first, kept)
    assert not torch.equal(first.positions, second.positions)
    assert first.positions.untyped_storage().data_ptr() != (
        second.positions.untyped_storage().data_ptr())
    # the three fields share the one copy
    assert first.mask.untyped_storage().data_ptr() == (
        first.positions.untyped_storage().data_ptr())


def test_compiled_frontend_keys_on_shape_type_and_layout(renders):
    """A new image shape, input type or layout gets a program of its
    own; a repeated one replays its program."""
    fe = Frontend(1, get_camera(1), dict(num_want=NUM_WANT, feature_type=1,
                                         dep_thres=20000.0, pot=3,
                                         bgr_quirk=False),
                  torch.device("cpu"))
    (r0, d0), (r1, d1) = renders[SIZES[0]]
    fe(r0, d0)
    fe(r1, d1)
    assert len(fe.programs) == 1 and fe.replays == 2
    fe(r0.astype(np.float32), d0)
    assert len(fe.programs) == 2
    big = renders[SIZES[1]][0]
    fe(*big)
    assert len(fe.programs) == 3
    # the same image in another layout
    t = np.ascontiguousarray(r0.transpose(1, 0, 2)).transpose(1, 0, 2)
    got = fe(t, d0)
    assert len(fe.programs) == 4 and _same(got, _eager(r0, d0, 1))
    assert fe.replays == 5
    assert [p.runs for p, _ in fe.programs.values()] == [2, 1, 1, 1]


def test_nan_cloud_still_injects_through_the_driver(renders):
    """`evaluation.nan_cloud` wraps the compiled processor: the poisoned
    cloud fails its two pairs, the others pass."""
    frames = [(i, f"{i}", *renders[SIZES[0]][i % 2]) for i in range(4)]
    p = CvoParams(max_iter=12)
    with nan_cloud(odometry, 1):
        recs = odometry.run_odometry_frames(
            frames, 1, params=p, num_want=512, traj=io.StringIO(),
            log=lambda *a: None, device="cpu")
    assert [r.failed for r in recs] == [True, True, False]


def _eager_step(params, adaptive, fixed, moving, res, min_valid):
    """The eager bookkeeping `_odom_step` ran after `align_jit` before it
    was one captured program."""
    finite = (torch.isfinite(res.tf).all() & cloud_ok(fixed, min_valid)
              & cloud_ok(moving, min_valid))
    f32 = torch.float32
    Rw = torch.where(finite, res.R, torch.eye(3, dtype=f32))
    Tw = torch.where(finite, res.T, torch.zeros(3, dtype=f32))
    if adaptive:
        ellw = torch.full((), params.ell_init, dtype=f32)
    else:
        ellw = torch.where(finite, res.ell, params.ell_init)
    packed = torch.cat([
        res.tf.reshape(16),
        torch.stack([res.iterations.to(f32), res.converged.to(f32),
                     finite.to(f32)]),
    ])
    return packed, (Rw, Tw, ellw)


def _result(rng, finite=True):
    tf = torch.as_tensor(rng.standard_normal((4, 4)), dtype=torch.float32)
    if not finite:
        tf[1, 2] = float("inf")
    return AlignResult(
        tf=tf, R=torch.as_tensor(rng.standard_normal((3, 3)),
                                 dtype=torch.float32),
        T=torch.as_tensor(rng.standard_normal(3), dtype=torch.float32),
        iterations=torch.tensor(37, dtype=torch.int32),
        converged=torch.tensor(True),
        ell=torch.tensor(0.0734, dtype=torch.float32),
        omega=torch.zeros(3), v=torch.zeros(3))


def _cloud(rng, n_valid, cap=256, nan=False):
    pos = np.zeros((cap, 3), np.float32)
    pos[:n_valid] = rng.standard_normal((n_valid, 3))
    if nan:
        pos[3, 1] = np.nan
    mask = np.zeros(cap, np.float32)
    mask[:n_valid] = 1.0
    return PointCloud(torch.as_tensor(pos), torch.zeros(cap, 5),
                      torch.as_tensor(mask))


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("case", ["passes", "few points", "nan position",
                                  "non-finite tf"])
def test_step_bookkeeping_has_the_eager_bits(monkeypatch, adaptive, case):
    rng = np.random.default_rng(7)
    params = AcvoParams() if adaptive else CvoParams()
    res = _result(rng, finite=case != "non-finite tf")
    fixed = _cloud(rng, 200, nan=case == "nan position")
    moving = _cloud(rng, 40 if case == "few points" else 180)
    monkeypatch.setattr(odometry, "align_jit", lambda *a, **k: res)
    warm = (torch.eye(3), torch.zeros(3),
            torch.full((), params.ell_init))
    runs = {k: v.runs for k, v in odometry.STEP_CACHE.items()}
    packed, nxt = odometry._odom_step(params, adaptive, fixed, moving, warm,
                                      64, "cpu")
    ref_packed, ref_nxt = _eager_step(params, adaptive, fixed, moving, res,
                                      64)
    assert packed.shape == (19,)
    assert torch.equal(packed, ref_packed)
    assert bool(packed[18]) == (case == "passes")
    for got, ref in zip(nxt, ref_nxt):
        assert got.shape == ref.shape and torch.equal(got, ref)
    # one program a key, one run a step; the next step's result is a
    # tensor of its own
    (key,) = [k for k, v in odometry.STEP_CACHE.items()
              if v.runs != runs.get(k, 0)]
    assert key[:3] == (params, adaptive, 64)
    kept = packed.clone()
    odometry._odom_step(params, adaptive, moving, fixed, nxt, 64, "cpu")
    assert torch.equal(packed, kept)
