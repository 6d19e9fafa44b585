"""SE(3) pose-graph optimization: Gauss-Newton on the device.

Port of the JAX package's `core/posegraph.py`.  The reference chains
odometry with no global consistency machinery (cvo.cpp:414); this module
closes loops.  Given keyframe nodes and relative-pose edges (odometry and
the loop closures of `slam.KeyframeSlam`), it minimizes

    sum_e  || log( Z_e^{-1} X_i^{-1} X_j ) ||^2_{Omega_e}

by Gauss-Newton with right-multiplicative updates, node 0 gauge-fixed by
a large prior.  Two solvers share the per-edge residual and Jacobian
(batched over the edges):

- "dense": the full 6N x 6N normal equations, solved exactly; O(N^2)
  memory, right at tens of keyframes.
- "pcg": the per-edge 6x6 coupling blocks and the N block-diagonal
  entries only, solved by block-Jacobi preconditioned CG whose matvec
  scatters and gathers through the edge list (O(E)).

Edge Jacobians take the small-residual form
  d r / d xi_i = -Jr^{-1}(r) Ad(X_j^{-1} X_i),   d r / d xi_j = Jr^{-1}(r)
with the exact right-Jacobian inverse from se3.left_jacobian_se3.
Everything is float32, as in the JAX package, with full-fp32 matmuls
(`device.pin_fp32`).

Without a mesh, the JAX package jits the whole solve, its Gauss-Newton
loop one `lax.scan` (`_optimize_dense`, `_optimize_pcg`).  Here one GN
iteration is captured in place (`core.compiled.CapturedLoop`) on a static
state (the nodes, a [iters] cost tensor, the cost slot and the edges),
once per (solver, nodes, edges, iters, damping, cg_iters, huber_delta,
robust, warmup, device, dtype), and replayed `iters` times, each replay
writing its cost into its slot; the graduated kernel (Cauchy after
`robust_warmup` Huber iterations) is two captured iterations, replayed
in turn.  On the CPU the same iteration runs uncaptured on the same
state.  The linear algebra takes the `_ex` forms (`solve_ex`, `inv_ex`),
whose info stays on the device: the checked forms read it on the host,
which a capture forbids; the eager mesh loop runs the same ops.

Over a mesh (`optimize(mesh=...)`) the edge set shards over the ranks of
an axis and the PCG solver's sums are psum'd (`collectives.py`): the
accumulators and each CG matvec's off-diagonal.  Its GN iteration is
captured likewise on this rank's shard (the JAX package jits it,
`_compiled_pcg_sharded`), keyed also by the axis and its backend: one
graph an iteration on NCCL, psums included; on gloo graph segments cut
at each psum (about `cg_iters + 1` of them), the staged all_reduces
between them.  `_mesh_eager` keeps the loop op by op, its reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cvo_rgbd_torch import collectives, se3
from cvo_rgbd_torch.collectives import psum
from cvo_rgbd_torch.core.compiled import (
    CapturedLoop,
    _copy_in,
    _static,
    axis_key,
    cached,
)
from cvo_rgbd_torch.core.pcg import pcg
from cvo_rgbd_torch.device import pin_fp32, resolve_device

_GAUGE = 1e6

# the compiled solves, one per (solver, nodes, edges, iters, damping,
# cg_iters, huber_delta, robust, warmup, device, dtype, and over a mesh its
# axis: `compiled.axis_key`), kept for the life of the process as JAX keeps
# its jitted solves
CACHE: dict = {}


class PoseGraph(NamedTuple):
    """nodes [N,4,4]; edges (i [E], j [E], z [E,4,4], weight [E])."""

    nodes: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_z: torch.Tensor
    edge_w: torch.Tensor


def from_odometry(poses, loop_edges=(), device=None) -> PoseGraph:
    """A graph from absolute poses [N,4,4] (host arrays), on `device` (the
    card unless `device="cpu"`): consecutive odometry edges of weight 1
    and the optional (i, j, Z, w) loop closures."""
    poses = np.asarray(poses)
    n = poses.shape[0]
    ei, ej, ez, ew = [], [], [], []
    for k in range(n - 1):
        ei.append(k)
        ej.append(k + 1)
        ez.append(np.linalg.inv(poses[k]) @ poses[k + 1])
        ew.append(1.0)
    for (i, j, z, w) in loop_edges:
        ei.append(i)
        ej.append(j)
        ez.append(np.asarray(z))
        ew.append(float(w))
    dev = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return PoseGraph(
        nodes=f32(poses),
        edge_i=torch.tensor(ei, dtype=torch.int64, device=dev),
        edge_j=torch.tensor(ej, dtype=torch.int64, device=dev),
        edge_z=f32(np.stack(ez)),
        edge_w=f32(ew),
    )


def _se3_inv44(X):
    R = X[..., :3, :3]
    t = X[..., :3, 3]
    Ri, ti = se3.se3_inv(R, t)
    return se3.make_se3(Ri, ti)


def _edge_residual_jac(Xi, Xj, Z):
    """r [E,6], Ji [E,6,6], Jj [E,6,6], batched over the edges."""
    rel = _se3_inv44(Xi) @ Xj
    E = _se3_inv44(Z) @ rel
    r = se3.log_se3(E)
    # right Jacobian inverse: Jr(r) = Jl(-r)
    Jr_inv = torch.linalg.inv_ex(se3.left_jacobian_se3(-r))[0]
    Adj = se3.adjoint_se3(_se3_inv44(rel))
    return r, -Jr_inv @ Adj, Jr_inv


def _edge_terms(nodes, edge_i, edge_j, edge_z, edge_w, huber_delta,
                robust="huber", k=None, warmup=0):
    """Per-edge normal-equation pieces: Hii/Hjj [E,6,6], the coupling
    block B = w Ji^T Jj [E,6,6], bi/bj [E,6], and the cost.

    `huber_delta > 0` turns on a robust kernel by IRLS (each GN iteration
    rescales the edge weights from the current residual norms); <= 0 is
    exact least squares.  `robust`: "huber", w = min(1, delta/|r|)
    (convex, bounded outlier force), or "cauchy", w = 1/(1 + |r|^2/delta^2)
    (redescending).  With "cauchy", the GN iterations k < `warmup` run the
    Huber kernel first (graduated robustification: a genuine closure of
    large drift is pulled into its basin before Cauchy's vanishing weight
    could freeze it out).  The cost is the matching robust cost."""
    r, Ji, Jj = _edge_residual_jac(nodes[edge_i], nodes[edge_j], edge_z)
    rn2 = torch.sum(r * r, dim=-1)
    rn = torch.sqrt(rn2 + 1e-12)
    d2 = huber_delta * huber_delta
    h_scale = torch.clamp_max(huber_delta / rn, 1.0)
    h_rho = torch.where(rn > huber_delta,
                        huber_delta * (2.0 * rn - huber_delta), rn2)
    if robust == "cauchy":
        scale = 1.0 / (1.0 + rn2 / max(d2, 1e-12))
        rho = d2 * torch.log1p(rn2 / max(d2, 1e-12))
        if warmup and k is not None and k < warmup:
            scale, rho = h_scale, h_rho
    elif robust == "huber":
        scale, rho = h_scale, h_rho
    else:
        raise ValueError(f"unknown robust kernel {robust!r}")
    use = huber_delta > 0.0
    w_e = edge_w * (scale if use else 1.0)
    w = w_e[:, None, None]
    JiT = Ji.transpose(-1, -2)
    JjT = Jj.transpose(-1, -2)
    Hii = w * (JiT @ Ji)
    Hjj = w * (JjT @ Jj)
    B = w * (JiT @ Jj)
    bi = (w * (JiT @ r[..., None]))[..., 0]
    bj = (w * (JjT @ r[..., None]))[..., 0]
    cost = torch.sum(edge_w * (rho if use else rn2))
    return Hii, Hjj, B, bi, bj, cost


def _apply_update(nodes, delta):
    """X <- X exp(delta), right-multiplicative."""
    return nodes @ se3.exp_se3(delta)


def _gradient(n, edge_i, edge_j, bi, bj):
    b = torch.zeros((n, 6), dtype=bi.dtype, device=bi.device)
    return b.index_add(0, edge_i, bi).index_add(0, edge_j, bj)


def _gn_step_dense(graph, nodes, damping, huber_delta, robust, k, warmup):
    n = nodes.shape[0]
    ei, ej = graph.edge_i, graph.edge_j
    Hii, Hjj, B, bi, bj, cost = _edge_terms(
        nodes, ei, ej, graph.edge_z, graph.edge_w, huber_delta, robust,
        k=k, warmup=warmup)
    H = torch.zeros((n, n, 6, 6), dtype=nodes.dtype, device=nodes.device)
    H.index_put_((ei, ei), Hii, accumulate=True)
    H.index_put_((ej, ej), Hjj, accumulate=True)
    H.index_put_((ei, ej), B, accumulate=True)
    H.index_put_((ej, ei), B.transpose(-1, -2), accumulate=True)
    b = _gradient(n, ei, ej, bi, bj)
    eye6 = torch.eye(6, dtype=nodes.dtype, device=nodes.device)
    # gauge fix node 0: a huge prior on its increment
    H[0, 0] += _GAUGE * eye6
    Hd = H.permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    Hd = Hd + damping * torch.eye(6 * n, dtype=nodes.dtype,
                                  device=nodes.device)
    delta = torch.linalg.solve_ex(Hd, -b.reshape(6 * n))[0].reshape(n, 6)
    return _apply_update(nodes, delta), cost


def _gn_step_pcg(graph, nodes, damping, cg_iters, huber_delta, robust, k,
                 warmup, axis=None):
    """Sparse GN step: block-diagonal accumulation and edge-block
    matrix-free PCG.  Over a mesh axis (`axis`, a `parallel.mesh.Axis`)
    the graph's edges are this rank's shard: the accumulators and each
    matvec's off-diagonal scatter are psum'd, so every rank takes the
    same step."""
    n = nodes.shape[0]
    ei, ej = graph.edge_i, graph.edge_j
    Hii, Hjj, B, bi, bj, cost = _edge_terms(
        nodes, ei, ej, graph.edge_z, graph.edge_w, huber_delta, robust,
        k=k, warmup=warmup)
    Hd = torch.zeros((n, 6, 6), dtype=nodes.dtype, device=nodes.device)
    Hd = Hd.index_add(0, ei, Hii).index_add(0, ej, Hjj)
    b = _gradient(n, ei, ej, bi, bj)
    if axis is not None:
        Hd, b, cost = psum((Hd, b, cost), axis)
    eye6 = torch.eye(6, dtype=nodes.dtype, device=nodes.device)
    Hd[0] += _GAUGE * eye6                      # gauge prior
    BT = B.transpose(-1, -2)

    def matvec(x):                              # H x, never forming H
        off = (torch.zeros_like(x)
               .index_add(0, ei, (B @ x[ej][..., None])[..., 0])
               .index_add(0, ej, (BT @ x[ei][..., None])[..., 0]))
        if axis is not None:
            off = psum(off, axis)
        return (Hd @ x[..., None])[..., 0] + damping * x + off

    Minv = torch.linalg.inv_ex(Hd + damping * eye6)[0]  # block-Jacobi

    def precond(r):
        return (Minv @ r[..., None])[..., 0]

    delta = pcg(matvec, precond, -b, cg_iters)
    return _apply_update(nodes, delta), cost


def _edge_shard(graph: PoseGraph, ax) -> PoseGraph:
    """This rank's block of the edges over mesh axis `ax`, the edges first
    padded with weight-0 self-loops of node 0 to a multiple of its size
    (a zero weight adds nothing anywhere)."""
    e = int(graph.edge_i.shape[0])
    pad = -e % ax.size
    i0 = graph.edge_i.new_zeros(pad)
    graph = PoseGraph(
        nodes=graph.nodes,
        edge_i=torch.cat([graph.edge_i, i0]),
        edge_j=torch.cat([graph.edge_j, i0]),
        edge_z=torch.cat([graph.edge_z, torch.eye(
            4, dtype=graph.edge_z.dtype,
            device=graph.edge_z.device).expand(pad, 4, 4)]),
        edge_w=torch.cat([graph.edge_w, graph.edge_w.new_zeros(pad)]),
    )
    per = (e + pad) // ax.size
    sl = slice(ax.index * per, (ax.index + 1) * per)
    return graph._replace(**{f: getattr(graph, f)[sl] for f in (
        "edge_i", "edge_j", "edge_z", "edge_w")})


def _gn_iteration(solver, damping, cg_iters, huber_delta, robust, k,
                  warmup, axis=None):
    """One GN iteration in place on the static state (nodes, costs,
    slot, edge_i, edge_j, edge_z, edge_w): the step of iteration `k`
    (which matters only to the graduated kernel's `k < warmup`), its cost
    into `costs[slot]`, then the slot moved on.  Over a mesh `axis` the
    edges are this rank's shard (PCG, its sums psum'd)."""

    def iteration(nodes, costs, slot, *edges):
        graph = PoseGraph(nodes, *edges)
        if solver == "dense":
            new, cost = _gn_step_dense(graph, nodes, damping, huber_delta,
                                       robust, k, warmup)
        else:
            new, cost = _gn_step_pcg(graph, nodes, damping, cg_iters,
                                     huber_delta, robust, k, warmup, axis)
        nodes.copy_(new)
        costs.index_copy_(0, slot, cost.reshape(1))
        slot.add_(1)

    return iteration


def _compiled_solve(graph, solver, iters, damping, cg_iters, huber_delta,
                    robust, warmup, axis=None):
    """`optimize`: the GN iterations replayed on the key's
    `CapturedLoop` (built on the key's first call; over a mesh `axis`,
    on this rank's edge shard, its psums in the graph on NCCL and
    between graph segments on gloo); fresh nodes and costs."""
    n, e = int(graph.nodes.shape[0]), int(graph.edge_i.shape[0])
    dev = graph.nodes.device
    key = (solver, n, e, iters, damping, cg_iters, huber_delta, robust,
           warmup, dev, graph.nodes.dtype)
    where = f"on {dev}"
    if axis is not None:
        key += (axis_key(axis),)
        where = (f"over {axis.name}={axis.size} (index {axis.index}, "
                 f"{collectives.backend(axis)}) on {dev}")

    def build():
        state = _static((graph.nodes, graph.nodes.new_zeros(iters),
                         torch.zeros(1, dtype=torch.int64, device=dev),
                         *graph[1:]))
        phases = ({"huber": 0, "cauchy": warmup}
                  if robust == "cauchy" and warmup else {robust: warmup})
        return CapturedLoop(
            {name: _gn_iteration(solver, damping, cg_iters, huber_delta,
                                 robust, k, warmup, axis)
             for name, k in phases.items()}, state,
            f"the {solver} pose-graph solve of {n} nodes and {e} edges "
            f"({iters} iterations, damping {damping}, cg_iters {cg_iters}, "
            f"{robust} {huber_delta}, warmup {warmup}) {where}", axis)

    loop = cached(CACHE, key, axis, build)
    nodes, costs, slot, *edges = loop.state
    _copy_in((nodes, *edges), (graph.nodes, *graph[1:]))
    slot.zero_()
    if len(loop.steps) == 2:
        loop.run("huber", min(warmup, iters))
        loop.run("cauchy", iters - min(warmup, iters))
    else:
        loop.run(robust, iters)
    return nodes.clone(), costs.clone()


def _mesh_eager(graph, ax, iters, damping, cg_iters, huber_delta, robust,
                warmup):
    """`optimize(mesh=)`'s GN loop op by op on this rank's edge shard,
    the reference of its compiled form."""
    nodes = graph.nodes
    costs = []
    for k in range(iters):
        nodes, cost = _gn_step_pcg(graph, nodes, damping, cg_iters,
                                   huber_delta, robust, k, warmup, ax)
        costs.append(cost)
    return nodes, torch.stack(costs) if costs else graph.nodes.new_zeros(0)


def optimize(graph: PoseGraph, iters: int = 10, damping: float = 1e-6,
             solver: str = "auto", cg_iters: int | None = None, mesh=None,
             axis: str = "sp", huber_delta: float = 0.0,
             robust: str = "huber", robust_warmup: int = 0):
    """Gauss-Newton where the graph lies; returns (optimized nodes
    [N,4,4], costs [iters]), the cost of each iteration before its step.

    solver: "dense" (exact 6N x 6N solve), "pcg" (edge-block
    matrix-free) or "auto" (dense up to 64 nodes).  `cg_iters` defaults
    to max(64, 2N): block-Jacobi CG moves a correction about one graph hop
    an iteration.  `huber_delta`, `robust` and `robust_warmup` as in
    `_edge_terms` (0 = exact least squares, the default).

    The GN loop is one captured iteration replayed `iters` times
    (`_compiled_solve`; uncaptured on the CPU).  `mesh` (a
    `parallel.make_mesh` mesh) shards the edge set over its `axis` and
    forces PCG: every rank of the mesh calls it with the same graph, on
    its own device, and gets the same result; the edges are padded with
    weight-0 self-loops to a multiple of the axis size."""
    pin_fp32()
    n = int(graph.nodes.shape[0])
    if solver == "auto":
        solver = "dense" if n <= 64 and mesh is None else "pcg"
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown solver {solver!r}")
    if cg_iters is None:
        cg_iters = max(64, 2 * n)
    if mesh is None:
        return _compiled_solve(graph, solver, iters, damping, cg_iters,
                               huber_delta, robust, robust_warmup)
    ax = mesh.axis(axis)
    return _compiled_solve(_edge_shard(graph, ax), "pcg", iters, damping,
                           cg_iters, huber_delta, robust, robust_warmup, ax)


def graph_cost(graph: PoseGraph, nodes=None):
    """Total weighted squared residual of the graph."""
    nodes = graph.nodes if nodes is None else nodes
    r = se3.log_se3(_se3_inv44(graph.edge_z) @ _se3_inv44(
        nodes[graph.edge_i]) @ nodes[graph.edge_j])
    return torch.sum(graph.edge_w * torch.sum(r * r, dim=-1))
