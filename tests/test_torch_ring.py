"""`parallel.align_ring` of the port on gloo ranks on the CPU, and the
kernel pieces the mesh paths run on row and ring blocks.

- cvo and MATLAB_PARAMS (linear) on the kernel backend against the JAX
  package's `align_ring` ("pallas") on the same sp, cvo on the dense
  backend against JAX "xla", each against the port's `align_sharded`:
  tf within 3e-4 at the C++ stops (tests/test_parallel.py's gates).
- acvo against the port's single-device `align` and `align_sharded`,
  not against JAX's ring: tests/test_parallel.py's
  `test_align_ring_pallas_matches_single[base1]` holds JAX's ring
  against `align_jit`, whose jitted kd-sort duplicates points on
  XLA:CPU (ROADMAP queue 3).
- The ell trajectory: the port's ring after exactly 1, 3, 10 and 20
  acvo iterations on a rendered pair (whose ell adapts, away from its
  floor and ceiling) against the single align's at the same iteration,
  at sp=2 and sp=4.
- The pieces on CPU tensors (the kernels' plain versions): the ranks'
  row-block moments summed against the whole cloud's, and the cross
  self-sweeps of the row blocks against the full symmetric sweep.

The JAX side runs as in tests/test_torch_sharded.py.
"""

import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch.core.cloud import aabb_min_d2, block_bounds, kd_sort
from cvo_rgbd_torch.core.registration import build_moments_pre
from cvo_rgbd_torch.ops import color_gram, fused_moments, fused_wsq
from cvo_rgbd_torch.ops.gram import pad_feat
from cvo_rgbd_torch.ops.moments import TILE_I, TILE_J
from cvo_rgbd_torch.ops.wsq import TILE_W, tile_order
from cvo_rgbd_torch.parallel import mesh as tmesh
from cvo_rgbd_tpu import CvoParams as JC
from cvo_rgbd_tpu import MATLAB_PARAMS as J_MATLAB
from cvo_rgbd_tpu.parallel import make_mesh as j_make_mesh
from cvo_rgbd_tpu.parallel import sharded as jsharded

import torch_ranks
from test_torch_sharded import (
    _pair,
    jax_body_jitted,
    jax_cloud,
    port_cloud,
)
from torch_scenes import rendered_acvo_pair

torch.set_num_threads(2)

STOPS = dict(eps=5e-5, eps_2=1e-5)
FIXED = (1, 3, 10, 20)
PORT = {"cvo-kernel": ct.CvoParams(**STOPS),
        "linear-kernel": dataclasses.replace(ct.MATLAB_PARAMS, **STOPS),
        "acvo-kernel": ct.AcvoParams(**STOPS),
        "cvo-dense": ct.CvoParams(backend="dense", **STOPS),
        "acvo-dense": ct.AcvoParams(backend="dense", **STOPS)}
JAX = {"cvo-kernel": JC(backend="pallas", **STOPS),
       "linear-kernel": dataclasses.replace(J_MATLAB, backend="pallas",
                                            **STOPS),
       "cvo-dense": JC(backend="xla", **STOPS)}
SHARDED = ("cvo-kernel", "linear-kernel", "acvo-kernel")


def _fixed(k):
    return ct.AcvoParams(max_iter=k, eps=0.0, eps_2=0.0)


def _arrays(cloud):
    return tuple(t.numpy() for t in cloud)


@pytest.fixture(scope="module")
def runs():
    pair = _pair(21)
    render = tuple(_arrays(c) for c in rendered_acvo_pair())
    clouds = {"big": pair, "render": render}
    cases2 = [({"sp": 2}, "ring", p, "big", {}) for p in PORT.values()]
    cases2 += [({"sp": 2}, "sharded", PORT[k], "big", {}) for k in SHARDED]
    traj = [("ring", _fixed(k), "render", {}) for k in FIXED]
    cases2 += [({"sp": 2},) + c for c in traj]
    cases4 = [({"sp": 4},) + c for c in traj]
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        fut2 = ex.submit(tmesh.launch, torch_ranks.aligns, 2,
                         (cases2, clouds), device="cpu", threads=2)
        fut4 = ex.submit(tmesh.launch, torch_ranks.aligns, 4,
                         (cases4, clouds), device="cpu", threads=1)
        mesh = j_make_mesh({"sp": 2})
        jx, jy = (jax_cloud(a) for a in pair)
        with jax_body_jitted():
            ref = {k: dict(zip(jsharded.AlignResult._fields, (
                np.asarray(v) for v in jsharded.align_ring(p, mesh, jx, jy))))
                for k, p in JAX.items()}
        x, y = (port_cloud(a) for a in pair)
        single = {k: torch_ranks.result(ct.align(PORT[k], x, y, device="cpu"))
                  for k in ("acvo-kernel",)}
        rx, ry = (port_cloud(a) for a in render)
        single_traj = [torch_ranks.result(ct.align(_fixed(k), rx, ry,
                                                   device="cpu"))
                       for k in FIXED]
        got2, got4 = fut2.result()[0], fut4.result()[0]
    n = len(PORT)
    return {"ring": dict(zip(PORT, got2[:n])),
            "sharded": dict(zip(SHARDED, got2[n:n + len(SHARDED)])),
            "traj": {2: got2[n + len(SHARDED):], 4: got4},
            "jax": ref, "single": single, "single_traj": single_traj}


def _close(got, ref, ell=False):
    np.testing.assert_allclose(got["tf"], ref["tf"], atol=3e-4)
    assert bool(got["converged"]) and bool(ref["converged"])
    if ell:
        np.testing.assert_allclose(got["ell"], ref["ell"], rtol=0.05)


@pytest.mark.parametrize("case", list(JAX))
def test_align_ring_matches_jax(runs, case):
    _close(runs["ring"][case], runs["jax"][case])


def test_align_ring_matches_sharded(runs):
    for case in SHARDED:
        _close(runs["ring"][case], runs["sharded"][case],
               ell=case.startswith("acvo"))


def test_acvo_ring_matches_single_align(runs):
    _close(runs["ring"]["acvo-kernel"], runs["single"]["acvo-kernel"],
           ell=True)


def test_acvo_dense_ring_matches_kernel_ring(runs):
    _close(runs["ring"]["acvo-dense"], runs["ring"]["acvo-kernel"],
           ell=True)


@pytest.mark.parametrize("sp", [2, 4])
def test_acvo_ring_follows_the_single_ell_trajectory(runs, sp):
    """After exactly k iterations the ring's ell is the single align's
    (within 1e-4 relative: its sums are reassociated across blocks),
    while ell climbs from 0.1 well inside its floor and ceiling, so a dl
    fed a wrong partial (the carry-order fault JAX's ring once had)
    moves it off at the first iteration."""
    ells = [float(r["ell"]) for r in runs["single_traj"]]
    assert ells == sorted(ells) and 0.1 < ells[0] < ells[-1] < 0.15
    for k, got, ref in zip(FIXED, runs["traj"][sp], runs["single_traj"]):
        assert int(got["iterations"]) == k - 1
        np.testing.assert_allclose(got["ell"], ref["ell"], rtol=1e-4,
                                   err_msg=f"after {k} iterations")
        np.testing.assert_allclose(got["tf"], ref["tf"], atol=1e-4)


# --- the kernel pieces on row and ring blocks -------------------------------

@pytest.fixture(scope="module")
def render_sorted():
    x, y = rendered_acvo_pair()
    return [kd_sort(c._replace(features=pad_feat(c.features))) for c in (x, y)]


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("ck", [True, False])
def test_row_block_moments_sum_to_the_whole(render_sorted, sp, ck):
    """Each rank's fused_moments on its row block [N/sp, M] (with the
    color cache, or recomputing color as the ring does), summed over the
    ranks, is the whole cloud's within 1e-4 of each column's scale, and
    the nonzero counts add up exactly; with the tile skip on each."""
    p = ct.AcvoParams()
    x, y = render_sorted
    ell = torch.tensor(0.1)
    c0, x_c, phi = build_moments_pre(x)
    y_c = y.positions - c0

    def moments(rows):
        xb = [t[rows] for t in (x_c, x.features, x.mask)]
        cache = (color_gram(*(t[rows] for t in x), *y, p=p)
                 if ck else None)
        md = aabb_min_d2(*block_bounds(xb[0], xb[2], TILE_I),
                         *block_bounds(y_c, y.mask, TILE_J))
        return fused_moments(*xb, y_c, y.features, y.mask, phi[rows], ell,
                             cache, md, p=p)

    whole, nnz = moments(slice(None))
    n = x.capacity // sp
    parts = [moments(slice(r * n, (r + 1) * n)) for r in range(sp)]
    summed = sum(m for m, _ in parts)
    scale = whole.abs().amax(dim=0).clamp_min(1e-30)
    assert float(((summed - whole).abs() / scale).max()) <= 1e-4
    assert float(sum(c for _, c in parts)) == float(nnz) > 0


@pytest.mark.parametrize("sp", [2, 4])
def test_cross_self_sweeps_sum_to_the_symmetric_sweep(render_sorted, sp):
    """acvo's Axx on a rank: its row block against the whole fixed cloud
    [N/sp, N], a cross sweep with a non-symmetric TileOrder; summed over
    the ranks it is the symmetric full sweep within 1e-4 relative, the
    counts exactly."""
    p = ct.AcvoParams()
    x, _ = render_sorted
    ell = torch.tensor(0.1)
    box = block_bounds(x.positions, x.mask, TILE_W)
    full = fused_wsq(*x, *x, ell, None,
                     tile_order(aabb_min_d2(*box, *box), symmetric=True),
                     p=p, symmetric=True)
    n = x.capacity // sp
    parts = []
    for r in range(sp):
        rows = [t[r * n:(r + 1) * n] for t in x]
        order = tile_order(aabb_min_d2(*block_bounds(rows[0], rows[2],
                                                     TILE_W), *box))
        parts.append(fused_wsq(*rows, *x, ell, None, order, p=p))
    wsq = sum(w for w, _ in parts)
    assert abs(float(wsq) - float(full[0])) <= 1e-4 * abs(float(full[0]))
    assert float(sum(c for _, c in parts)) == float(full[1]) > 0


def test_the_jax_ring_faults_reference_is_the_jitted_kd_sort():
    """Why tests/test_parallel.py's
    test_align_ring_pallas_matches_single[base1] fails: on a pair of its
    kind, JAX's adaptive ring (its body under jit, the kd-sort op by op)
    and JAX's "xla" align (no kd-sort) both put ell at its floor after
    one iteration, while `align_jit` on "pallas", whose kd-sort runs
    under jit, registers a cloud with duplicated points (fewer distinct
    rows than the eager sort) and lands ell far from it (ROADMAP queue
    3)."""
    import jax.numpy as jnp

    from cvo_rgbd_tpu import AcvoParams as JA
    from cvo_rgbd_tpu import align_jit
    from cvo_rgbd_tpu.core.cloud import kd_sort as j_kd_sort

    x, y = (jax_cloud(a) for a in _pair(0))
    rows = [len(np.unique(np.asarray(c.positions), axis=0))
            for c in (j_kd_sort(x), jax.jit(j_kd_sort)(x))]
    assert rows[0] == 901 > rows[1]
    p = JA(max_iter=1)
    with jax_body_jitted():
        ring = jsharded.align_ring(dataclasses.replace(p, backend="pallas"),
                                   j_make_mesh({"sp": 2}), x, y)
    xla = align_jit(p, x, y)
    bad = align_jit(dataclasses.replace(p, backend="pallas"), x, y)
    floor = jnp.float32(p.ell_min)
    assert float(ring.ell) == float(xla.ell) == float(floor)
    assert float(bad.ell) > 1.5 * float(floor)
