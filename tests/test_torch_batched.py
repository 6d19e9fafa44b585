"""Batched registration in the port (plain versions on the CPU) against
the JAX package: `stack_clouds` and the batched `kd_sort`,
`parallel.align_batched` on the three backends, and the batched drivers
`run_odometry_batched` and `run_multiseq` (mirroring
tests/test_multiseq.py against the JAX drivers on the parallax folder),
with their CLI forms.

A lane of `align_batched` must be the port's single-pair `align` on its
pair, bit for bit: the fused backend's lanes go through one batched call
(lane by lane on the CPU), the other backends through `align` itself.
The JAX side runs op by op or with its dense backend (under jit, its
Pallas path kd-sorts with XLA:CPU, which duplicates points: ROADMAP,
queue 3).
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch.cli import main as t_cli
from cvo_rgbd_torch.convert import cloud_from_numpy
from cvo_rgbd_torch.core import cloud as tcloud
from cvo_rgbd_torch.evaluation import ate_rmse
from cvo_rgbd_torch.io.tum import read_trajectory
from cvo_rgbd_torch.multiseq import run_multiseq
from cvo_rgbd_torch.odometry import run_odometry_batched
from cvo_rgbd_torch.ops.align_fused import align_fused_batched, moments_center
from cvo_rgbd_torch.ops.gram import pad_feat
from cvo_rgbd_torch.parallel import align_batched
from cvo_rgbd_tpu import pad_cloud, se3
from cvo_rgbd_tpu.core import cloud as jcloud
from cvo_rgbd_tpu.odometry import run_odometry as j_run_odometry
from cvo_rgbd_tpu.odometry import run_odometry_batched as j_run_batched
from cvo_rgbd_tpu.params import MATLAB_PARAMS as J_MATLAB
from cvo_rgbd_tpu.params import CvoParams as JC

from torch_scenes import make_parallax_folder

torch.set_num_threads(2)

NUM_WANT = 512
# the MATLAB stops keep the aligns short on the CPU
FAST = dict(eps=5e-4, eps_2=1e-4, max_iter=60)
QUIET = dict(log=lambda *a: None)


def _pair(seed, n=96, cap=256, nfeat=5):
    """tests/test_parallel.py:_pair (the JAX package's clouds)."""
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


def _empty(cap, nfeat=5):
    return ct.pad_cloud(np.zeros((0, 3)), np.zeros((0, nfeat)), capacity=cap,
                        device="cpu")


def _assert_same(a, b):
    for f, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f


@pytest.mark.parametrize("repeat", [1, 3])
def test_stack_clouds_matches_jax(repeat):
    pairs = [_pair(s) for s in range(2)]
    ref = jcloud.stack_clouds([x for x, _ in pairs], repeat=repeat)
    got = tcloud.stack_clouds([_port(x) for x, _ in pairs], repeat=repeat)
    assert got.positions.shape == (2 * repeat, 256, 3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _assert_same(got.lane(2 % (2 * repeat)), _port(pairs[0][0]))


def test_batched_kd_sort_matches_jax():
    """Each lane of the batched sort is the JAX package's (eager) sort of
    its cloud, and the port's single-cloud sort: the same permutation."""
    rng = np.random.default_rng(3)
    clouds = []
    for n_valid in (384, 250, 0, 1):
        pos = rng.standard_normal((n_valid, 3)).astype(np.float32)
        pos = np.round(pos * 4) / 4          # ties along every axis
        feat = rng.random((n_valid, 5)).astype(np.float32)
        clouds.append(pad_cloud(pos, feat, capacity=384))
    got = tcloud.kd_sort(tcloud.stack_clouds([_port(c) for c in clouds]))
    for i, c in enumerate(clouds):
        ref = jcloud.kd_sort(c)
        for a, b in zip(got.lane(i), ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _assert_same(got.lane(i), tcloud.kd_sort(_port(c)))


def test_lane_helpers_match_per_lane():
    """block_bounds, aabb_min_d2 and moments_center take the lane axis
    and give each lane the bits of the single-cloud call."""
    pairs = [_pair(s, n=150 + 40 * s) for s in range(3)]
    xs = tcloud.stack_clouds([_port(x) for x, _ in pairs])
    ys = tcloud.stack_clouds([_port(y) for _, y in pairs])
    lo, hi = tcloud.block_bounds(xs.positions, xs.mask, 64)
    lo_y, hi_y = tcloud.block_bounds(ys.positions, ys.mask, 128)
    md = tcloud.aabb_min_d2(lo, hi, lo_y, hi_y)
    c0, phi = moments_center(xs)
    for i in range(3):
        x, y = xs.lane(i), ys.lane(i)
        l1, h1 = tcloud.block_bounds(x.positions, x.mask, 64)
        l2, h2 = tcloud.block_bounds(y.positions, y.mask, 128)
        assert torch.equal(lo[i], l1) and torch.equal(hi[i], h1)
        assert torch.equal(md[i], tcloud.aabb_min_d2(l1, h1, l2, h2))
        c, f = moments_center(x)
        assert torch.equal(c0[i], c) and torch.equal(phi[i], f)


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("mode", ["resident", "tiled"])
def test_tenth_iteration_is_one_step_from_the_ninth_state(mode, linear):
    """chip_smoke.py's phase 8 holds the kernel's 10th iteration against
    one plain step from the kernel's state after 9 iterations; in the
    plain version that step is its own 10th iteration, bit for bit."""
    from cvo_rgbd_torch.ops.align_fused import align_fused_plain
    from cvo_rgbd_torch.params import MATLAB_PARAMS

    nfeat = 3 if linear else 5
    x, y = (tcloud.kd_sort(c._replace(features=pad_feat(c.features)))
            for c in map(_port, _pair(5, nfeat=nfeat)))
    base = MATLAB_PARAMS if linear else ct.CvoParams()

    def run(it, *state):
        q = dataclasses.replace(base, max_iter=it, eps=0.0, eps_2=0.0)
        return align_fused_plain(q, x, y, *state, mode=mode)

    r9, r10 = run(9), run(10)
    step = run(1, r9[12:21].reshape(3, 3), r9[21:24], r9[26])
    # tf, R, T, then omega and v; ell follows the schedule's iteration count
    for cols in (slice(0, 24), slice(27, 33)):
        assert torch.equal(step[cols], r10[cols])


BACKENDS = [
    ("kernel", ct.CvoParams), ("dense", ct.CvoParams),
    ("fused", ct.CvoParams), ("fused", ct.AcvoParams),
    ("kernel", ct.AcvoParams),
]


@pytest.mark.parametrize("backend,cls", BACKENDS,
                         ids=[f"{b}-{c.__name__}" for b, c in BACKENDS])
def test_align_batched_lanes_equal_single_align(backend, cls):
    """Lanes of different pairs, one retired (empty moving cloud): each
    lane is `align` on its own pair, bit for bit; the retired one stops
    at iteration 0 with a finite transform."""
    p = cls(backend=backend, **FAST)
    pairs = [_pair(s, n=96 + 30 * s) for s in range(3)]
    xs = [_port(x) for x, _ in pairs]
    ys = [_port(y) for _, y in pairs]
    ys[2] = _empty(256)
    res = align_batched(p, tcloud.stack_clouds(xs), tcloud.stack_clouds(ys),
                        device="cpu")
    for i in range(3):
        one = ct.align(p, xs[i], ys[i], device="cpu")
        lane = type(one)(*(f[i] for f in res))
        _assert_same(lane, one)
    assert int(res.iterations[0]) > 0 and int(res.iterations[2]) == 0
    assert bool(res.converged[2]) and torch.isfinite(res.tf).all()


def test_dense_lanes_match_jax_align_batched():
    """tests/test_parallel.py:91-104: the JAX dense backend's
    vmap(align) at max_iter=30, within 2e-5 of each lane's tf."""
    from cvo_rgbd_tpu.parallel import align_batched as j_align_batched

    pairs = [_pair(10 + s) for s in range(4)]
    jp = JC(max_iter=30)
    ref = j_align_batched(jp, jcloud.stack_clouds([x for x, _ in pairs]),
                          jcloud.stack_clouds([y for _, y in pairs]))
    got = align_batched(ct.CvoParams(backend="dense", max_iter=30),
                        tcloud.stack_clouds([_port(x) for x, _ in pairs]),
                        tcloud.stack_clouds([_port(y) for _, y in pairs]),
                        device="cpu")
    np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf), atol=2e-5)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))


def test_fused_lanes_match_jax_vmap():
    """tests/test_pallas_align.py:149-168: JAX's vmap of align_fused
    (interpret-mode Pallas) on MATLAB pairs against the port's batched
    fused call on the same, unsorted lanes: the tolerances of
    test_torch_fused.py."""
    import jax

    from cvo_rgbd_tpu.ops.pallas_align import align_fused as j_align_fused

    pairs = [_pair(20 + s, n=200, nfeat=3) for s in range(3)]
    vf = jax.vmap(lambda f, m: j_align_fused(J_MATLAB, f, m, interpret=True))
    ref = vf(jcloud.stack_clouds([x for x, _ in pairs]),
             jcloud.stack_clouds([y for _, y in pairs]))
    p = dataclasses.replace(ct.MATLAB_PARAMS, backend="fused")

    def stacked(k):
        c = tcloud.stack_clouds([_port(pr[k]) for pr in pairs])
        return c._replace(features=pad_feat(c.features))

    got = align_fused_batched(p, stacked(0), stacked(1))
    its = np.asarray(ref.iterations)
    assert np.all(np.abs(got.iterations.numpy() - its) <= 2)
    np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf), atol=3e-4)
    assert got.converged.all() and np.asarray(ref.converged).all()


@pytest.mark.parametrize("backend", ["kernel", "dense", "fused"])
def test_all_masked_lanes_converge_at_iteration_zero(backend):
    """A retired lane's all-masked clouds (both sides, as two steps after
    a sequence ends in run_multiseq) stop at once with a finite tf."""
    x, y = (_port(c) for c in _pair(30))
    e = _empty(256)
    res = align_batched(ct.CvoParams(backend=backend, **FAST),
                        tcloud.stack_clouds([x, x, e]),
                        tcloud.stack_clouds([y, e, e]), device="cpu")
    assert res.iterations.tolist()[1:] == [0, 0]
    assert int(res.iterations[0]) > 0
    assert torch.isfinite(res.tf).all() and bool(res.converged[1:].all())


@pytest.mark.parametrize("backend", ["kernel", "fused"])
def test_warm_start_lanes(backend):
    """R0/T0/ell0 seed each lane as `align` seeds one pair; they are
    given together or not at all."""
    p = ct.CvoParams(backend=backend, **FAST)
    pairs = [_pair(40 + s) for s in range(2)]
    xs = tcloud.stack_clouds([_port(x) for x, _ in pairs])
    ys = tcloud.stack_clouds([_port(y) for _, y in pairs])
    R0 = np.stack([np.asarray(se3.exp_so3(np.array(w, np.float32)))
                   for w in ([0.004, 0.0, -0.003], [0.0, 0.002, 0.0])])
    T0 = np.array([[0.01, 0.0, 0.005], [0.0, -0.01, 0.0]], np.float32)
    ell0 = np.array([0.03, 0.1], np.float32)
    res = align_batched(p, xs, ys, R0=R0, T0=T0, ell0=ell0, device="cpu")
    for i in range(2):
        one = ct.align(p, xs.lane(i), ys.lane(i), torch.from_numpy(R0[i]),
                       torch.from_numpy(T0[i]), torch.tensor(ell0[i]),
                       device="cpu")
        _assert_same(type(one)(*(f[i] for f in res)), one)
    with pytest.raises(ValueError, match="together"):
        align_batched(p, xs, ys, R0=R0, T0=T0, device="cpu")


def test_mesh_is_not_ported():
    x, y = (_port(c) for c in _pair(50))
    b = tcloud.stack_clouds([x])
    with pytest.raises(NotImplementedError, match="Multi-device, on torch.distributed"):
        align_batched(ct.CvoParams(), b, tcloud.stack_clouds([y]),
                      mesh=object(), device="cpu")


# --- the drivers, mirroring tests/test_multiseq.py ---------------------
# (at 512 points a frame and the MATLAB stops, to stay short on the CPU)

P = ct.CvoParams(backend="fused", **FAST)
JP = JC(**FAST)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_parallax_folder(tmp_path_factory.mktemp("torch_batched"))


@pytest.fixture(scope="module")
def jax_single(dataset, tmp_path_factory):
    """The JAX sequential driver's trajectories, cold and warm."""
    out = {}
    for warm in (False, True):
        path = tmp_path_factory.mktemp("jax") / "single.txt"
        j_run_odometry(str(dataset), 1, params=JP, num_want=NUM_WANT,
                       output=str(path), warm_start=warm, **QUIET)
        out[warm] = read_trajectory(path)
    return out


def _close(got, ref, atol=5e-3):
    """tests/test_multiseq.py's trajectory tolerance."""
    assert set(got) == set(ref)
    for t in ref:
        np.testing.assert_allclose(got[t], ref[t], atol=atol)


def test_multiseq_matches_single(dataset, jax_single):
    outs = run_multiseq([str(dataset), str(dataset)], 1, params=P,
                        num_want=NUM_WANT, warm_start=False, device="cpu",
                        **QUIET)
    (path,) = set(outs.values())
    batched = read_trajectory(path)
    _close(batched, jax_single[False])
    gt = read_trajectory(dataset / "groundtruth.txt")
    ate_b = ate_rmse(gt, batched)["rmse"]
    ate_s = ate_rmse(gt, jax_single[False])["rmse"]
    assert ate_b < max(2 * ate_s, 0.012)


def test_multiseq_warm_start_matches_sequential_warm(dataset, jax_single):
    outs = run_multiseq([str(dataset)], 1, params=P, num_want=NUM_WANT,
                        warm_start=True, device="cpu", **QUIET)
    (path,) = set(outs.values())
    _close(read_trajectory(path), jax_single[True])


@pytest.mark.parametrize("motion_prior", [False, True])
def test_odometry_batched_matches_jax(dataset, tmp_path, motion_prior):
    """run_odometry_batched(batch=2): the repeat-padded last chunk, and
    the motion prior, against the JAX batched driver's plain run."""
    ref_out = tmp_path / "jax.txt"
    j_run_batched(str(dataset), 1, params=JP, num_want=NUM_WANT,
                  output=str(ref_out), batch=2, **QUIET)
    out = tmp_path / "port.txt"
    recs = run_odometry_batched(str(dataset), 1, params=P,
                                num_want=NUM_WANT, output=str(out), batch=2,
                                motion_prior=motion_prior, device="cpu",
                                **QUIET)
    assert [r.index for r in recs] == list(range(1, len(recs) + 1))
    assert not any(r.failed for r in recs) and all(r.converged for r in recs)
    _close(read_trajectory(out), read_trajectory(ref_out))


def test_multiseq_ragged_lanes(dataset, jax_single, tmp_path):
    """A 2-frame lane retires after its one pair: its trajectory stops at
    its length and matches the solo run's start, and the long lane is
    unaffected by the retired one (kernel backend)."""
    short = tmp_path / "short"
    short.mkdir()
    (short / "rgb").symlink_to(dataset / "rgb")
    (short / "depth").symlink_to(dataset / "depth")
    entries = (dataset / "assoc.txt").read_text().splitlines()
    (short / "assoc.txt").write_text("\n".join(entries[:2]) + "\n")
    outs = run_multiseq([str(dataset), str(short)], 1,
                        params=dataclasses.replace(P, backend="kernel"),
                        num_want=NUM_WANT, warm_start=False, device="cpu",
                        **QUIET)
    long_solo = jax_single[False]
    _close(read_trajectory(outs[str(dataset)]), long_solo)
    short_batch = read_trajectory(outs[str(short)])
    assert len(short_batch) == 2
    for t in short_batch:
        np.testing.assert_allclose(short_batch[t], long_solo[t], atol=5e-3)


def test_multiseq_adaptive_matches_single(dataset, tmp_path):
    from cvo_rgbd_tpu.params import AcvoParams as JA

    ref_out = tmp_path / "single.txt"
    j_run_odometry(str(dataset), 1, adaptive=True, params=JA(**FAST),
                   num_want=NUM_WANT, output=str(ref_out), max_frames=4,
                   warm_start=False, **QUIET)
    outs = run_multiseq([str(dataset)], 1, adaptive=True,
                        params=ct.AcvoParams(backend="fused", **FAST),
                        num_want=NUM_WANT, max_frames=4, warm_start=False,
                        device="cpu", **QUIET)
    (path,) = set(outs.values())
    assert path.endswith("acvo_poses_qt_batch.txt")
    _close(read_trajectory(path), read_trajectory(ref_out))


def test_multiseq_fetch_cadence_invariant(dataset, tmp_path):
    """fetch_every only batches the device->host reads: the trajectories
    are bit-identical across cadences."""
    trajs = {}
    for fe in (1, 3):
        root = tmp_path / f"fe{fe}"
        shutil.copytree(dataset, root)
        outs = run_multiseq([str(root)], 1, params=P, num_want=NUM_WANT,
                            fetch_every=fe, device="cpu", **QUIET)
        (path,) = set(outs.values())
        trajs[fe] = read_trajectory(path)
    assert set(trajs[1]) == set(trajs[3])
    for t in trajs[1]:
        np.testing.assert_array_equal(trajs[1][t], trajs[3][t])


def test_cli_run_batch(dataset, jax_single, tmp_path):
    out = tmp_path / "batch.txt"
    t_cli(["run", str(dataset), "1", "--device", "cpu", "--batch", "2",
           "--backend", "fused", "--num-want", str(NUM_WANT), "--matlab-tol",
           "--output", str(out)])
    _close(read_trajectory(out), jax_single[False])
    with pytest.raises(SystemExit):
        t_cli(["run", str(dataset), "1", "--device", "cpu", "--batch", "2",
               "--checkpoint", str(tmp_path / "c.json")])


def test_cli_multiseq(dataset, jax_single, tmp_path):
    root = tmp_path / "seq"
    shutil.copytree(dataset, root)
    t_cli(["multiseq", "1", str(root), "--device", "cpu", "--backend",
           "dense", "--num-want", str(NUM_WANT), "--matlab-tol",
           "--cold-start"])
    _close(read_trajectory(root / "cvo_poses_qt_batch.txt"),
           jax_single[False])
