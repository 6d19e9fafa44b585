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
(`device.pin_fp32`).  The JAX package's `mesh=` (the edge set sharded
over devices) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cvo_rgbd_torch import se3
from cvo_rgbd_torch.core.pcg import pcg
from cvo_rgbd_torch.device import pin_fp32, resolve_device

_GAUGE = 1e6


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
    Jr_inv = torch.linalg.inv(se3.left_jacobian_se3(-r))
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
    delta = torch.linalg.solve(Hd, -b.reshape(6 * n)).reshape(n, 6)
    return _apply_update(nodes, delta), cost


def _gn_step_pcg(graph, nodes, damping, cg_iters, huber_delta, robust, k,
                 warmup):
    """Sparse GN step: block-diagonal accumulation and edge-block
    matrix-free PCG."""
    n = nodes.shape[0]
    ei, ej = graph.edge_i, graph.edge_j
    Hii, Hjj, B, bi, bj, cost = _edge_terms(
        nodes, ei, ej, graph.edge_z, graph.edge_w, huber_delta, robust,
        k=k, warmup=warmup)
    Hd = torch.zeros((n, 6, 6), dtype=nodes.dtype, device=nodes.device)
    Hd = Hd.index_add(0, ei, Hii).index_add(0, ej, Hjj)
    b = _gradient(n, ei, ej, bi, bj)
    eye6 = torch.eye(6, dtype=nodes.dtype, device=nodes.device)
    Hd[0] += _GAUGE * eye6                      # gauge prior
    BT = B.transpose(-1, -2)

    def matvec(x):                              # H x, never forming H
        off = (torch.zeros_like(x)
               .index_add(0, ei, (B @ x[ej][..., None])[..., 0])
               .index_add(0, ej, (BT @ x[ei][..., None])[..., 0]))
        return (Hd @ x[..., None])[..., 0] + damping * x + off

    Minv = torch.linalg.inv(Hd + damping * eye6)  # block-Jacobi

    def precond(r):
        return (Minv @ r[..., None])[..., 0]

    delta = pcg(matvec, precond, -b, cg_iters)
    return _apply_update(nodes, delta), cost


def optimize(graph: PoseGraph, iters: int = 10, damping: float = 1e-6,
             solver: str = "auto", cg_iters: int | None = None, mesh=None,
             huber_delta: float = 0.0, robust: str = "huber",
             robust_warmup: int = 0):
    """Gauss-Newton where the graph lies; returns (optimized nodes
    [N,4,4], costs [iters]), the cost of each iteration before its step.

    solver: "dense" (exact 6N x 6N solve), "pcg" (edge-block
    matrix-free) or "auto" (dense up to 64 nodes).  `cg_iters` defaults
    to max(64, 2N): block-Jacobi CG moves a correction about one graph hop
    an iteration.  `huber_delta`, `robust` and `robust_warmup` as in
    `_edge_terms` (0 = exact least squares, the default).  `mesh` (the
    edge set sharded over devices) is not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "optimize over a mesh is not ported yet: ROADMAP queue 1, "
            "\"Multi-device, on torch.distributed\"")
    pin_fp32()
    n = int(graph.nodes.shape[0])
    if solver == "auto":
        solver = "dense" if n <= 64 else "pcg"
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown solver {solver!r}")
    if cg_iters is None:
        cg_iters = max(64, 2 * n)
    nodes = graph.nodes
    costs = []
    for k in range(iters):
        if solver == "dense":
            nodes, cost = _gn_step_dense(graph, nodes, damping, huber_delta,
                                         robust, k, robust_warmup)
        else:
            nodes, cost = _gn_step_pcg(graph, nodes, damping, cg_iters,
                                       huber_delta, robust, k, robust_warmup)
        costs.append(cost)
    return nodes, torch.stack(costs) if costs else graph.nodes.new_zeros(0)


def graph_cost(graph: PoseGraph, nodes=None):
    """Total weighted squared residual of the graph."""
    nodes = graph.nodes if nodes is None else nodes
    r = se3.log_se3(_se3_inv44(graph.edge_z) @ _se3_inv44(
        nodes[graph.edge_i]) @ nodes[graph.edge_j])
    return torch.sum(graph.edge_w * torch.sum(r * r, dim=-1))
