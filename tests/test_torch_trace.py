"""`core.trace.align_trace` in the port against the JAX package, on the
CPU.

The port's trace runs on the kernel backend (plain versions, kd-sorted
clouds).  Its first record, one step from identity on the same inputs,
is held within 1e-4 relative of JAX's `align_trace`: on the "xla"
backend for cvo, on the "pallas" one for acvo (below).  The later records are not held to JAX's later records: the two
trajectories part at a near-cancelling step by up to 7e-4 (cvo) and, for
acvo, whose dense dl is summation-order noise (ROADMAP queue 3), by tens
of percent, as far as JAX's own "pallas" and "xla" traces part from each
other.  So each of the first 10 records is held within 1e-4 relative of
one JAX step taken from the port's own state at that iteration: the
"xla" step for cvo, and for acvo the "pallas" step, whose moment and
self-sweep algebra the kernel backend shares (the "xla" dl moves ell by
up to 5e-4 relative from one state).

The trace's endpoint must be the port's own `align` on the same pair,
bit for bit, and its record must freeze at `align`'s stopping iteration
(tests/test_core.py holds JAX's trace to its align the same way).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvo_rgbd_torch import align
from cvo_rgbd_torch.core.trace import IterRecord, align_trace
from cvo_rgbd_torch.params import AcvoParams, CvoParams
from cvo_rgbd_tpu import se3 as jse3
from cvo_rgbd_tpu.core import registration as jreg
from cvo_rgbd_tpu.core.cloud import PointCloud as JCloud
from cvo_rgbd_tpu.core.cloud import kd_sort as j_kd_sort
from cvo_rgbd_tpu.core.trace import align_trace as j_align_trace
from cvo_rgbd_tpu.params import AcvoParams as JA
from cvo_rgbd_tpu.params import CvoParams as JC

torch.set_num_threads(2)

MATLAB_STOPS = dict(eps=5e-4, eps_2=1e-4)
RECORD_RTOL = 1e-4


@pytest.fixture(scope="module")
def pairs():
    """The first rendered pair of revisit_path(2) at 96x128 through the
    cvo frontend (RGB features) and the acvo one (HSV), capacity 512."""
    from cvo_rgbd_torch import synth
    from cvo_rgbd_torch.frontend import make_frontend

    frames = list(synth.render_frames(synth.revisit_path(2, period=33),
                                      synth.BandScene(h=96, w=128)))
    return {algo: [make_frontend(1, 512, ft, device="cpu")(f[2], f[3])
                   for f in frames]
            for algo, ft in (("cvo", 1), ("acvo", 0))}


def _params(algo, **kw):
    return (AcvoParams if algo == "acvo" else CvoParams)(**kw)


def _jax_clouds(*clouds):
    return [JCloud(*(np.asarray(a) for a in c)) for c in clouds]


def _jax_params(algo):
    """JAX's backend the port's kernel trace is held to (module doc)."""
    return JA(backend="pallas") if algo == "acvo" else JC(backend="xla")


@pytest.mark.parametrize("algo", ["cvo", "acvo"])
def test_first_record_matches_jax_trace(pairs, algo):
    x, y = pairs[algo]
    _, ref = j_align_trace(_jax_params(algo), *_jax_clouds(x, y), 1)
    _, got = align_trace(_params(algo), x, y, 1, device="cpu")
    for name in IterRecord._fields[:4]:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=RECORD_RTOL, err_msg=name)


@pytest.mark.parametrize("algo", ["cvo", "acvo"])
def test_each_record_is_a_jax_step_from_the_ports_state(pairs, algo):
    adaptive = algo == "acvo"
    x, y = pairs[algo]
    jx, jy = _jax_clouds(x, y)
    jp = _jax_params(algo)
    if adaptive:
        # the pallas backend's point order, as JAX's align_trace sorts
        jx, jy = j_kd_sort(jx), j_kd_sort(jy)
    body = jreg.make_align_step(jp, adaptive)
    ck = jreg.build_ck_caches(jp, adaptive, jx, jy)
    skip = jreg.build_skip_pre(jp, adaptive, jx, jy)
    pre = (jreg.prepare_ci(jp, jx, jy), ck, jreg.build_moments_pre(jp, jx),
           skip, jreg.build_selfsweep_cheb(jp, adaptive, jx, jy, ck, skip))
    p = _params(algo)
    _, rec = align_trace(p, x, y, 10, device="cpu")
    assert not bool(rec.converged.any())
    if adaptive:
        # the adaptive ell moves in these iterations
        assert len(set(rec.ell.tolist())) > 1
    for i in range(10):
        state, _ = align_trace(p, x, y, i, device="cpu")
        s = jreg.AlignState(*(jnp.asarray(v.numpy()) for v in state))
        new = body(s, jx, jy, *pre)
        dR = s.R.T @ new.R
        ref = (jnp.linalg.norm(new.omega), jnp.linalg.norm(new.v), new.ell,
               jse3.dist_se3(dR, s.R.T @ (new.T - s.T)))
        for name, r in zip(IterRecord._fields, ref):
            np.testing.assert_allclose(
                float(getattr(rec, name)[i]), float(r), rtol=RECORD_RTOL,
                err_msg=f"{name} at iteration {i}")


@pytest.mark.parametrize("algo", ["cvo", "acvo"])
def test_endpoint_is_align(pairs, algo):
    """Run 5 iterations past `align`'s stop: the record freezes at its
    stopping iteration, and the final state is its bits."""
    x, y = pairs[algo]
    p = _params(algo, **MATLAB_STOPS)
    res = align(p, x, y, device="cpu")
    k = int(res.iterations)
    assert bool(res.converged)
    final, rec = align_trace(p, x, y, k + 5, device="cpu")
    conv = rec.converged.numpy()
    assert not conv[:k].any() and conv[k:].all()
    for a, b in ((final.tf, res.tf), (final.R, res.R), (final.T, res.T),
                 (final.ell, res.ell)):
        assert torch.equal(a, b)
    assert int(final.k) - 1 == k
    # frozen: every record after the stop repeats the stop's values
    for name in IterRecord._fields:
        col = getattr(rec, name)
        assert torch.equal(col[k + 1:], col[k].expand(4))


def test_fused_traces_on_the_kernel_backend(pairs):
    """The fused backend cannot record an iteration: its trace is the
    kernel backend's, as the JAX package routes it to its pallas one."""
    x, y = pairs["cvo"]
    a = align_trace(CvoParams(backend="fused"), x, y, 3, device="cpu")
    b = align_trace(CvoParams(backend="kernel"), x, y, 3, device="cpu")
    for u, v in zip(a[1], b[1]):
        assert torch.equal(u, v)


def test_linear_acvo_traces_on_the_dense_backend(pairs):
    """yy_quirk and linear acvo run only on the dense backend, as in the
    JAX package's trace."""
    x, y = pairs["acvo"]
    p = dataclasses.replace(AcvoParams(backend="fused"), yy_quirk=True)
    a = align_trace(p, x, y, 2, device="cpu")
    b = align_trace(dataclasses.replace(p, backend="dense"), x, y, 2,
                    device="cpu")
    for u, v in zip(a[1], b[1]):
        assert torch.equal(u, v)
