"""The dense backend's batched loop on the CPU: `align_batched` on "dense"
as one compiled loop for the batch, the Grams [B, N, M] and the
reductions lane by lane (`core/lanes.py`).

JAX compiles `align_batched` on "xla" as jit(vmap(align)): the whole
dense body runs on the lane axis and the while_loop runs until every
lane has converged, a converged lane frozen.  The port runs the batch
the same way (`core/registration.make_batched_step`,
`core/compiled.run_compiled` on the stacked state).  A lane must be the
port's single-pair `align` on its pair, bit for bit; against JAX
`align_batched` the lanes are held at the dense backend's tolerances
(tests/test_torch_dense.py: tf within the stop skew 3e-4, iterations
within 2), acvo at the C++ stops (ROADMAP, queue 3).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch import se3 as tse3
from cvo_rgbd_torch.core import cloud as tcloud
from cvo_rgbd_torch.core import compiled
from cvo_rgbd_torch.core import registration as treg
from cvo_rgbd_torch.parallel import align_batched
from cvo_rgbd_tpu.core import cloud as jcloud
from cvo_rgbd_tpu.params import MATLAB_PARAMS as J_MATLAB
from cvo_rgbd_tpu.params import AcvoParams as JA
from cvo_rgbd_tpu.params import CvoParams as JC
from cvo_rgbd_tpu.parallel import align_batched as j_align_batched

from test_torch_batched import _assert_same, _empty, _pair, _port

torch.set_num_threads(2)

# the MATLAB stops keep the aligns short on the CPU
FAST = dict(eps=5e-4, eps_2=1e-4, max_iter=40)
# the JAX suite's stop-skew tolerance (tests/test_parallel.py:217)
TF_TOL = 3e-4
CAP = 256
LANES = 3


def _lane(res, i):
    return type(res)(*(f[i] for f in res))


def _clouds(seeds, nfeat=5, n=220):
    pairs = [_pair(s, n=n, cap=CAP, nfeat=nfeat) for s in seeds]
    return (pairs, [_port(x) for x, _ in pairs],
            [_port(y) for _, y in pairs])


CASES = {
    "cvo": ct.CvoParams(backend="dense", **FAST),
    "acvo": ct.AcvoParams(backend="dense", **FAST),
    "linear": dataclasses.replace(ct.MATLAB_PARAMS, backend="dense",
                                  max_iter=40),
    "linear acvo": dataclasses.replace(
        ct.AcvoParams(backend="dense", **FAST), color_mode="linear"),
    "direct": ct.CvoParams(backend="dense", step_mode="direct", **FAST),
    "acvo direct": ct.AcvoParams(backend="dense", step_mode="direct",
                                 **FAST),
    "yy_quirk": ct.AcvoParams(backend="dense", yy_quirk=True, **FAST),
    "fast": ct.CvoParams(backend="dense", exp_mode="fast", **FAST),
}


class _GramSpy:
    """`_gram` of core/registration.py, counting its calls and the lanes
    of each."""

    def __init__(self):
        self.lanes = []
        self.real = treg._gram

    def __call__(self, p, x_pos, *a):
        self.lanes.append(x_pos.shape[0] if x_pos.dim() == 3 else None)
        return self.real(p, x_pos, *a)


@pytest.mark.parametrize("case", list(CASES))
def test_dense_batched_loop_lanes_are_the_bits_of_align(case, monkeypatch):
    """Three pairs, one retired: one compiled loop for the batch (one
    cache entry, keyed by its lanes), its blocks the slowest lane's; the
    cross Gram (and acvo's Axx) formed once an iteration on the lane
    axis; and every lane the bits of the port's `align` on its pair."""
    p = CASES[case]
    nfeat = 3 if p.color_mode == "linear" else 5
    _, xs, ys = _clouds(range(60, 60 + LANES), nfeat=nfeat)
    ys[2] = _empty(CAP, nfeat=nfeat)
    compiled.align_jit.cache_clear()
    spy = _GramSpy()
    monkeypatch.setattr(treg, "_gram", spy)
    replays = compiled.align_jit.replays
    res = align_batched(p, tcloud.stack_clouds(xs), tcloud.stack_clouds(ys),
                        device="cpu")
    blocks = compiled.align_jit.replays - replays
    assert len(compiled.CACHE) == 1
    (key,) = compiled.CACHE
    assert key[-1] == (LANES,)
    slowest = int(res.iterations.max())
    assert blocks == math.ceil((slowest + 1) / treg.CHECK_EVERY)
    per_iter = 2 if isinstance(p, ct.AcvoParams) else 1
    assert spy.lanes == [LANES] * per_iter * blocks * treg.CHECK_EVERY
    monkeypatch.undo()
    for i in range(LANES):
        _assert_same(_lane(res, i), ct.align(p, xs[i], ys[i], device="cpu"))
    assert int(res.iterations[2]) == 0 and bool(res.converged[2])
    assert int(res.iterations[0]) > 0 and int(res.iterations[1]) > 0


JAX_CASES = {
    "cvo": (ct.CvoParams(backend="dense", **FAST), JC(**FAST)),
    "acvo": (ct.AcvoParams(backend="dense"), JA()),
    "linear": (dataclasses.replace(ct.MATLAB_PARAMS, backend="dense"),
               J_MATLAB),
    "direct": (ct.CvoParams(backend="dense", step_mode="direct", **FAST),
               JC(step_mode="direct", **FAST)),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_dense_batched_loop_matches_jax_align_batched(case):
    """JAX `align_batched` on "xla" (jit(vmap(align))) on the same lanes:
    both converged, iterations within 2, tf within 3e-4."""
    p, jp = JAX_CASES[case]
    pairs, xs, ys = _clouds(range(70, 70 + LANES),
                            nfeat=3 if p.color_mode == "linear" else 5)
    ref = j_align_batched(jp, jcloud.stack_clouds([x for x, _ in pairs]),
                          jcloud.stack_clouds([y for _, y in pairs]))
    got = align_batched(p, tcloud.stack_clouds(xs), tcloud.stack_clouds(ys),
                        device="cpu")
    assert bool(got.converged.all()) and bool(np.asarray(ref.converged).all())
    assert np.abs(got.iterations.numpy()
                  - np.asarray(ref.iterations)).max() <= 2
    np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf),
                               atol=TF_TOL)


def test_a_converged_dense_lane_stays_frozen():
    """An identical pair converges at iteration 0 and stays frozen
    (identity, its ell untouched) while the other lanes move; lane i
    alone (a batch of one) is the bits of lane i in the batch of three."""
    p = ct.AcvoParams(backend="dense", **FAST)
    _, xs, ys = _clouds(range(80, 80 + LANES))
    ys[1] = xs[1]
    res = align_batched(p, tcloud.stack_clouds(xs), tcloud.stack_clouds(ys),
                        device="cpu")
    assert int(res.iterations[1]) == 0 and bool(res.converged[1])
    assert torch.equal(res.tf[1], torch.eye(4))
    assert float(res.ell[1]) == float(np.float32(p.ell_init))
    assert int(res.iterations[0]) > 0 and int(res.iterations[2]) > 0
    for i in (0, 2):
        alone = align_batched(p, tcloud.stack_clouds([xs[i]]),
                              tcloud.stack_clouds([ys[i]]), device="cpu")
        _assert_same(_lane(alone, 0), _lane(res, i))


def test_a_transposed_warm_start_keys_its_own_dense_batch():
    """R0/T0/ell0 seed every lane; a transposed view of the same R0 keys
    its own compiled batch, and each layout's lanes are `align`'s bits
    with that lane's view."""
    p = ct.AcvoParams(backend="dense", **FAST)
    _, xs, ys = _clouds(range(90, 90 + LANES))
    xb, yb = tcloud.stack_clouds(xs), tcloud.stack_clouds(ys)
    R = torch.stack([tse3.exp_so3(torch.tensor(w)) for w in (
        [0.004, 0.0, -0.003], [0.0, 0.002, 0.0], [-0.002, 0.001, 0.003])])
    T0 = torch.tensor([[0.01, 0.0, 0.005], [0.0, -0.01, 0.0],
                       [0.004, 0.003, -0.002]])
    ell0 = torch.tensor([0.12, 0.1, 0.06])
    transposed = R.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(transposed, R) and transposed.stride() == (9, 1, 3)
    compiled.align_jit.cache_clear()
    for R0 in (R, transposed):
        res = align_batched(p, xb, yb, R0=R0, T0=T0, ell0=ell0, device="cpu")
        for i in range(LANES):
            one = ct.align(p, xs[i], ys[i], R0[i], T0[i], ell0[i],
                           device="cpu")
            _assert_same(_lane(res, i), one)
    assert len(compiled.CACHE) == 2
    assert {k[-1] for k in compiled.CACHE} == {(LANES,)}


@pytest.mark.parametrize("step_mode", ["factored", "direct"])
def test_make_batched_step_takes_the_dense_backend(step_mode):
    """The dense backend runs the batched loop in both step modes (JAX's
    vmap(align) on "xla"); the kernel backend's direct step does not."""
    q = ct.CvoParams(backend="dense", step_mode=step_mode)
    assert treg.batched_loop(q)
    assert callable(treg.make_batched_step(q))
    kernel = dataclasses.replace(q, backend="kernel")
    assert treg.batched_loop(kernel) == (step_mode == "factored")
