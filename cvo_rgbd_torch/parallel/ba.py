"""Bundle adjustment of a keyframe map: sparse Schur complement and
matrix-free PCG, on one device or over a mesh.

Port of the JAX package's `parallel/ba.py` (the reference chains accum_transform, cvo.cpp:414, and never builds a
map):

  poses      X_k in SE(3)   (keyframe camera-to-world)
  landmarks  l_m in R^3     (world-frame map points)
  residual   r_o = X_k^{-1} l_m - z_o
             (z_o = the 3-D point measured in camera k's frame: RGB-D
             observes full 3-D points, so no projection model is needed)

Gauss-Newton with right-multiplicative pose updates X <- X exp(xi^),
xi = [omega; v] (the se3.exp_se3 convention).  With d = R^T (l - t):

  dr/dxi = [skew(d), -I_3]        dr/dl = R^T

H_pp is block-diagonal over poses, H_ll over landmarks, and the coupling
H_pl is sparse: one [6,3] block per distinct (pose, landmark) edge,
E [Ne, 6, 3].  The reduced camera system

  S dp = -(b_p - H_pl W b_l),   S = H_pp - H_pl W H_lp,  W = H_ll^{-1}

is solved matrix-free: each PCG matvec goes through the edge blocks
(H_lp x: an edge scatter-add into [M,3]; W; H_pl: an edge scatter-add
back into [K,6]) in O(Ne) work, with a block-Jacobi preconditioner built
from the same blocks.  Landmarks then back-substitute
dl = -W (b_l + H_lp dp).

The accumulators are scatter-adds (`index_add_`); on CUDA these are
atomic and their order varies from run to run, so a card's solve agrees
with the CPU's within a tolerance, not in its bits.  Every fp32 product
runs at full fp32 (`pin_fp32`, the JAX package's Precision.HIGHEST).

Over a mesh (`ba_solve(mesh=...)`) the observations shard over the ranks
of an axis: each rank scatter-adds its shard into the accumulators, and
ONE psum of them a GN iteration sums them (payload O(Ne*18 + K*36 +
M*9), no K*M term); the landmark blocks are inverted on landmark shards
and all-gathered; the PCG loop, O(Ne*18) a matvec, runs replicated.  Its
scatter-adds may round differently on each rank's card, so the axis's
first rank broadcasts its updated poses and landmarks (K*16 + M*3
floats) each GN iteration, and every rank starts the next one from the
same bits.  Its GN iteration is captured too (the JAX package jits it,
`_compiled_ba_sharded`), keyed also by the axis and its backend: one
graph an iteration on NCCL, collectives included; on gloo graph
segments cut at the psum, the all_gather and the broadcast.
`_solve_local` keeps the loop op by op, its reference.

Without a mesh, the JAX package jits the whole solve (`_ba_single`, the
GN loop one `lax.scan`).  Here one GN iteration (the accumulators, the
landmark inverse, the Schur step with its PCG) is captured in place
(`core.compiled.CapturedLoop`) on a static state (poses, landmarks, a
[iters] cost tensor, the cost slot and the problem's other fields), once
per (K poses, M landmarks, observations, edges, iters, damping,
cg_iters, device, dtype), and replayed `iters` times; on the CPU the
same iteration runs uncaptured.  The block inverses take `inv_ex`, whose
info stays on the device (`inv` reads it on the host, which a capture
forbids); the eager reference runs the same op.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cvo_rgbd_torch import collectives, se3
from cvo_rgbd_torch.collectives import all_gather, broadcast, psum
from cvo_rgbd_torch.core.compiled import (
    CapturedLoop,
    _copy_in,
    _static,
    axis_key,
    cached,
)
from cvo_rgbd_torch.core.pcg import pcg
from cvo_rgbd_torch.device import pin_fp32, resolve_device
from cvo_rgbd_torch.parallel.mesh import rank_device

_INDEX_FIELDS = ("obs_pose", "obs_lm", "obs_edge", "edge_pose", "edge_lm")

# the compiled solves, one per (K, M, observations, edges, iters, damping,
# cg_iters, device, dtype, and over a mesh its axis: `compiled.axis_key`),
# kept for the life of the process as JAX keeps its jitted solve
CACHE: dict = {}


class BAProblem(NamedTuple):
    """poses [K,4,4] camera-to-world; landmarks [M,3] world;
    observations (obs_pose [O] int64, obs_lm [O] int64, obs_z [O,3]
    camera-frame measured points, obs_w [O] weights, 0 marks padding);
    edge structure (obs_edge [O] int64 mapping each observation to its
    distinct (pose, landmark) pair, edge_pose/edge_lm [Ne] int64), fixed
    per problem, built by make_ba_problem.
    """

    poses: torch.Tensor
    landmarks: torch.Tensor
    obs_pose: torch.Tensor
    obs_lm: torch.Tensor
    obs_z: torch.Tensor
    obs_w: torch.Tensor
    obs_edge: torch.Tensor
    edge_pose: torch.Tensor
    edge_lm: torch.Tensor

    def to(self, device) -> "BAProblem":
        return BAProblem(*(t.to(device) for t in self))


def problem_on(arrays, device=None) -> BAProblem:
    """A BAProblem on `device` from its nine fields as arrays, in
    BAProblem's order: floats as float32, indices as int64."""
    dev = resolve_device(device)
    return BAProblem(*(
        torch.from_numpy(np.array(
            a, np.int64 if name in _INDEX_FIELDS else np.float32)).to(dev)
        for name, a in zip(BAProblem._fields, arrays)))


def make_ba_problem(poses, landmarks, obs_pose, obs_lm, obs_z, obs_w=None,
                    pad_to=None, pad_landmarks_to=None, device=None):
    """Assemble a BAProblem on `device` (the card unless `device="cpu"`)
    from host arrays, padding observations to `pad_to` and landmarks to
    `pad_landmarks_to`.  The (pose, landmark) edge list, the sparsity
    pattern of H_pl, is derived with np.unique, so duplicate observations
    of one pair merge into one coupling block."""
    poses = np.asarray(poses, np.float32)
    landmarks = np.asarray(landmarks, np.float32)
    obs_pose = np.asarray(obs_pose, np.int32)
    obs_lm = np.asarray(obs_lm, np.int32)
    obs_z = np.asarray(obs_z, np.float32)
    o = obs_pose.shape[0]
    obs_w = (np.ones(o, np.float32) if obs_w is None
             else np.asarray(obs_w, np.float32))

    # edge structure from the real (pre-padding) observations
    m = landmarks.shape[0]
    pair_key = obs_pose.astype(np.int64) * m + obs_lm.astype(np.int64)
    uniq, obs_edge = np.unique(pair_key, return_inverse=True)
    edge_pose = (uniq // m).astype(np.int32)
    edge_lm = (uniq % m).astype(np.int32)
    obs_edge = obs_edge.astype(np.int32)

    if pad_to is not None and pad_to > o:
        pad = pad_to - o
        obs_pose = np.concatenate([obs_pose, np.zeros(pad, np.int32)])
        obs_lm = np.concatenate([obs_lm, np.zeros(pad, np.int32)])
        obs_z = np.concatenate([obs_z, np.zeros((pad, 3), np.float32)])
        obs_w = np.concatenate([obs_w, np.zeros(pad, np.float32)])
        # w=0 padding contributes nothing wherever it scatters
        obs_edge = np.concatenate([obs_edge, np.zeros(pad, np.int32)])
    if pad_landmarks_to is not None and pad_landmarks_to > m:
        landmarks = np.concatenate([
            landmarks,
            np.zeros((pad_landmarks_to - m, 3), np.float32),
        ])  # unobserved: H_ll block = 0, damping keeps W finite, dl = 0
    return problem_on((poses, landmarks, obs_pose, obs_lm, obs_z, obs_w,
                       obs_edge, edge_pose, edge_lm), device)


def _scatter(n, index, values):
    """zeros([n, *values.shape[1:]]) with `values` added at `index`."""
    return values.new_zeros((n,) + values.shape[1:]).index_add_(
        0, index, values)


def _residual(problem: BAProblem, poses, landmarks):
    """(R [O,3,3], d = R^T (l - t) [O,3], r = d - z [O,3])."""
    R = poses[problem.obs_pose, :3, :3]
    t = poses[problem.obs_pose, :3, 3]
    l = landmarks[problem.obs_lm]
    d = ((l - t)[:, None, :] @ R)[:, 0, :]
    return R, d, d - problem.obs_z


def _accumulate(problem: BAProblem, poses, landmarks, n_edges):
    """Normal-equation accumulators: edge coupling blocks E [Ne,6,3]
    (the sparse H_pl), block diagonals H_pp [K,6,6] / H_ll [M,3,3],
    gradients b_p/b_l, and the cost."""
    k, m = poses.shape[0], landmarks.shape[0]
    R, d, r = _residual(problem, poses, landmarks)
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    Jp = torch.cat([se3.skew(d), -eye.expand(d.shape[:1] + (3, 3))],
                   dim=-1)                           # [O,3,6]
    Jl = R.transpose(-1, -2)                         # R^T, [O,3,3]

    w = problem.obs_w[:, None, None]
    JpT = Jp.transpose(-1, -2)
    JlT = Jl.transpose(-1, -2)
    H_pp = _scatter(k, problem.obs_pose, w * (JpT @ Jp))
    H_ll = _scatter(m, problem.obs_lm, w * (JlT @ Jl))
    E = _scatter(n_edges, problem.obs_edge, w * (JpT @ Jl))
    b_p = _scatter(k, problem.obs_pose, (w * (JpT @ r[..., None]))[..., 0])
    b_l = _scatter(m, problem.obs_lm, (w * (JlT @ r[..., None]))[..., 0])
    cost = torch.sum(problem.obs_w * torch.sum(r * r, dim=-1))
    return E, H_pp, H_ll, b_p, b_l, cost


def _landmark_inverse(H_ll, damping, axis=None):
    """W = (H_ll + damping I)^{-1}, block by block; over a mesh axis each
    rank inverts its M/n slice of the blocks and the slices are
    all-gathered."""
    eye3 = torch.eye(3, dtype=H_ll.dtype, device=H_ll.device)
    damped = H_ll + damping * eye3
    if axis is None:
        return torch.linalg.inv_ex(damped)[0]
    local = damped.shape[0] // axis.size
    mine = damped[axis.index * local:(axis.index + 1) * local]
    return all_gather(torch.linalg.inv_ex(mine)[0], axis)


def _edge_matvecs(E, edge_pose, edge_lm, n_lm):
    """Matrix-free pieces of the Schur complement built from the edge
    blocks: Hlp_x (scatter [K,6] -> [M,3]), Hpl_scatter (back to
    [K,6])."""

    def Hlp_x(x):                       # H_lp x : [K,6] -> [M,3]
        per_edge = (E.transpose(-1, -2) @ x[edge_pose][..., None])[..., 0]
        return _scatter(n_lm, edge_lm, per_edge)

    def Hpl_scatter(z, n_pose):         # H_pl z : [M,3] -> [K,6]
        per_edge = (E @ z[edge_lm][..., None])[..., 0]
        return _scatter(n_pose, edge_pose, per_edge)

    return Hlp_x, Hpl_scatter


def _schur_precond(E, edge_pose, edge_lm, W, H_pp, damping, gauge):
    """Block-Jacobi preconditioner: the exact 6x6 diagonal blocks of
    S = H_pp - H_pl W H_lp (+ damping + gauge), inverted."""
    k = H_pp.shape[0]
    AWAt = (E @ W[edge_lm]) @ E.transpose(-1, -2)   # [Ne,6,6]
    eye6 = torch.eye(6, dtype=H_pp.dtype, device=H_pp.device)
    Sdiag = H_pp - _scatter(k, edge_pose, AWAt) + damping * eye6
    Sdiag[0] += gauge * eye6
    return torch.linalg.inv_ex(Sdiag)[0]


def _schur_step(problem, poses, landmarks, acc, damping, cg_iters,
                gauge=1e6):
    """One GN update from the accumulators: matrix-free Schur PCG for
    the poses, closed-form back-substitution for the landmarks."""
    E, H_pp, H_ll, b_p, b_l, cost, W = acc
    k, m = H_pp.shape[0], H_ll.shape[0]
    Hlp_x, Hpl_scatter = _edge_matvecs(E, problem.edge_pose,
                                       problem.edge_lm, m)

    def Wdot(y):
        return (W @ y[..., None])[..., 0]

    def matvec(x):                      # S x, never forming S
        out = ((H_pp @ x[..., None])[..., 0]
               - Hpl_scatter(Wdot(Hlp_x(x)), k) + damping * x)
        return torch.cat([out[:1] + gauge * x[:1], out[1:]])

    Minv = _schur_precond(E, problem.edge_pose, problem.edge_lm, W, H_pp,
                          damping, gauge)

    def precond(r):
        return (Minv @ r[..., None])[..., 0]

    rhs = -(b_p - Hpl_scatter(Wdot(b_l), k))
    dp = pcg(matvec, precond, rhs, cg_iters)

    dl = -Wdot(b_l + Hlp_x(dp))
    return poses @ se3.exp_se3(dp), landmarks + dl, cost


def _gn_step(problem: BAProblem, poses, landmarks, damping, cg_iters,
             axis=None):
    """One GN iteration from (poses, landmarks): (new poses, new
    landmarks, the cost of the starting point).  Over a mesh axis
    (`axis`, a `parallel.mesh.Axis`) the obs_* fields hold this rank's
    shard, the accumulators are psum'd before the replicated update, and
    the axis's first rank's update is broadcast after it."""
    acc = _accumulate(problem, poses, landmarks, problem.edge_pose.shape[0])
    if axis is not None:
        acc = psum(acc, axis)
    W = _landmark_inverse(acc[2], damping, axis)
    poses, landmarks, cost = _schur_step(
        problem, poses, landmarks, acc + (W,), damping, cg_iters)
    if axis is not None:
        poses, landmarks = broadcast((poses, landmarks), axis)
    return poses, landmarks, cost


def _solve_local(problem: BAProblem, iters: int, damping: float,
                 cg_iters: int, axis=None):
    """The GN loop op by op (`_gn_step`), the reference of the captured
    one; returns (poses, landmarks, costs [iters]), each cost that of the
    iteration's starting point."""
    poses, landmarks = problem.poses, problem.landmarks
    costs = []
    for _ in range(iters):
        poses, landmarks, cost = _gn_step(problem, poses, landmarks,
                                          damping, cg_iters, axis)
        costs.append(cost)
    return poses, landmarks, (torch.stack(costs) if costs
                              else poses.new_zeros(0))


def _ba_iteration(damping, cg_iters, axis=None):
    """`_gn_step` in place on the static state (poses, landmarks, costs,
    slot, then the problem's other fields): its cost into `costs[slot]`,
    then the slot moved on."""

    def iteration(poses, landmarks, costs, slot, *fields):
        new_poses, new_landmarks, cost = _gn_step(
            BAProblem(poses, landmarks, *fields), poses, landmarks, damping,
            cg_iters, axis)
        poses.copy_(new_poses)
        landmarks.copy_(new_landmarks)
        costs.index_copy_(0, slot, cost.reshape(1))
        slot.add_(1)

    return iteration


def _compiled_solve(problem: BAProblem, iters, damping, cg_iters,
                    axis=None):
    """`ba_solve`: the GN iterations replayed on the key's `CapturedLoop`
    (built on the key's first call; over a mesh `axis`, on this rank's
    shard, its psum, all_gather and broadcast in the graph on NCCL and
    between graph segments on gloo); fresh poses, landmarks and costs."""
    k, m = (int(t.shape[0]) for t in problem[:2])
    o, e = int(problem.obs_pose.shape[0]), int(problem.edge_pose.shape[0])
    dev, dtype = problem.poses.device, problem.poses.dtype
    key = (k, m, o, e, iters, damping, cg_iters, dev, dtype)
    where = f"on {dev}"
    if axis is not None:
        key += (axis_key(axis),)
        where = (f"over {axis.name}={axis.size} (index {axis.index}, "
                 f"{collectives.backend(axis)}) on {dev}")

    def build():
        state = _static((problem.poses, problem.landmarks,
                         problem.poses.new_zeros(iters),
                         torch.zeros(1, dtype=torch.int64, device=dev),
                         *problem[2:]))
        return CapturedLoop(
            {"gn": _ba_iteration(damping, cg_iters, axis)}, state,
            f"ba_solve of {k} poses, {m} landmarks, {o} observations and "
            f"{e} edges ({iters} iterations, damping {damping}, cg_iters "
            f"{cg_iters}) {where}", axis)

    loop = cached(CACHE, key, axis, build)
    poses, landmarks, costs, slot, *fields = loop.state
    _copy_in((poses, landmarks, *fields), tuple(problem))
    slot.zero_()
    loop.run("gn", iters)
    return poses.clone(), landmarks.clone(), costs.clone()


def _mesh_shard(problem: BAProblem, ax, dev):
    """This rank's shard of `problem` over mesh axis `ax` on `dev`: the
    observations padded with weight-0 ones, and the landmarks with
    unobserved ones, to multiples of the axis size, then the rank's
    block of the observations; and the real landmark count."""
    n = ax.size
    o = int(problem.obs_pose.shape[0])
    m = int(problem.landmarks.shape[0])
    if o % n or m % n:
        real = (problem.obs_w > 0).cpu().numpy()
        host = [t.cpu().numpy() for t in problem]
        problem = make_ba_problem(
            host[0], host[1], *(a[real] for a in host[2:6]),
            pad_to=-(-o // n) * n, pad_landmarks_to=-(-m // n) * n,
            device=dev)
    problem = problem.to(dev)
    per = problem.obs_pose.shape[0] // n
    sl = slice(ax.index * per, (ax.index + 1) * per)
    return problem._replace(**{f: getattr(problem, f)[sl] for f in (
        "obs_pose", "obs_lm", "obs_z", "obs_w", "obs_edge")}), m


def ba_solve(problem: BAProblem, mesh=None, axis: str = "sp",
             iters: int = 10, damping: float = 1e-4, cg_iters: int = 48,
             device=None):
    """Bundle-adjust on `device`; returns (poses [K,4,4], landmarks [M,3],
    costs [iters]) there.  One captured GN iteration replayed `iters`
    times (`_compiled_solve`; uncaptured on the CPU).

    Without a mesh, on one device (the card unless `device="cpu"`).  With
    a mesh (`parallel.make_mesh`), every rank of it calls this with the
    same problem and gets the same result on its own device (the rank's
    card unless `device="cpu"`): the observations shard over `axis`,
    padded with weight-0 observations, and the landmarks with unobserved
    ones, to multiples of its size (the padding landmarks are dropped
    from the result)."""
    if mesh is None:
        dev = resolve_device(device)
        pin_fp32()
        return _compiled_solve(problem.to(dev), iters, damping, cg_iters)
    dev = rank_device(device)
    pin_fp32()
    ax = mesh.axis(axis)
    shard, m = _mesh_shard(problem, ax, dev)
    poses, landmarks, costs = _compiled_solve(shard, iters, damping,
                                              cg_iters, ax)
    return poses, landmarks[:m], costs


def ba_cost(problem: BAProblem, poses=None, landmarks=None, device=None):
    """Total weighted squared residual, on `device` (the card unless
    `device="cpu"`)."""
    dev = resolve_device(device)
    pin_fp32()
    problem = problem.to(dev)
    poses = problem.poses if poses is None else poses.to(dev)
    landmarks = problem.landmarks if landmarks is None else landmarks.to(dev)
    _, _, r = _residual(problem, poses, landmarks)
    return torch.sum(problem.obs_w * torch.sum(r * r, dim=-1))


def ba_from_keyframes(keyframe_clouds, poses, grid=0.1, radius=0.05,
                      max_landmarks=8192, min_obs=2, rng=None,
                      feature_weight=2.0, device=None):
    """Harvest a BA problem on `device` (the card unless `device="cpu"`)
    from keyframe clouds (`PointCloud`s, wherever they lie) and their
    camera-to-world poses [K,4,4].

    CVO is correspondence-free, so the correspondences are built here on
    the host, in the JAX package's float64 numpy, so that both packages
    give the same problem: landmark candidates are a `grid` subsample of
    all keyframe clouds merged in the world frame; a keyframe observes a
    landmark where its cloud has a point within `radius` (brute-force
    nearest neighbour, minimizing d2_pos + lam * d2_feat inside the
    radius, `feature_weight` scaling lam; 0 disables the feature term);
    landmarks seen by fewer than `min_obs` keyframes are dropped, and
    each one starts at the mean of its observers' matched world points.
    Returns a BAProblem, or None when there are too few observations.
    """
    from cvo_rgbd_torch.utils.downsample import grid_downsample

    rng = np.random.default_rng(0) if rng is None else rng
    poses = np.asarray(poses, np.float32)

    def world(cloud, T):
        valid = cloud.mask.cpu().numpy() > 0
        pos = cloud.positions.cpu().numpy()[valid]
        feat = cloud.features.cpu().numpy()[valid]
        return pos @ T[:3, :3].T + T[:3, 3], feat

    pairs = [world(c, T) for c, T in zip(keyframe_clouds, poses)]
    merged = np.concatenate([p for p, _ in pairs], axis=0)
    merged_f = np.concatenate([f for _, f in pairs], axis=0).astype(
        np.float64)
    cand, cand_f = grid_downsample(merged, merged_f, grid)
    if cand.shape[0] > max_landmarks:
        pick = rng.choice(cand.shape[0], max_landmarks, replace=False)
        cand, cand_f = cand[pick], cand_f[pick]

    # a 1-sigma total feature mismatch costs (feature_weight * radius/2)^2
    # of position distance
    fvar = float(np.mean(np.var(merged_f, axis=0)))
    nfeat = merged_f.shape[1]
    if feature_weight > 0.0 and fvar > 1e-12:
        lam = (feature_weight * 0.5 * radius) ** 2 / (nfeat * fvar)
    else:
        lam = 0.0

    obs_pose, obs_lm, obs_z, obs_w_pts = [], [], [], []
    r2 = radius * radius
    for k, ((pts_w, f_k), T) in enumerate(zip(pairs, poses)):
        d2 = ((cand[:, None, :] - pts_w[None, :, :]) ** 2).sum(-1)
        if lam > 0.0:
            fk = f_k.astype(np.float64)
            d2f = (
                (cand_f * cand_f).sum(1)[:, None]
                + (fk * fk).sum(1)[None, :]
                - 2.0 * cand_f @ fk.T
            )
            cost = np.where(d2 < r2, d2 + lam * np.maximum(d2f, 0.0),
                            np.inf)
        else:
            cost = np.where(d2 < r2, d2, np.inf)
        j = cost.argmin(1)
        hit = np.isfinite(cost[np.arange(cand.shape[0]), j])
        if not hit.any():
            continue
        # observation = the matched point in camera k's frame
        Rk, tk = T[:3, :3], T[:3, 3]
        z = (pts_w[j[hit]] - tk) @ Rk
        obs_pose.append(np.full(hit.sum(), k, np.int32))
        obs_lm.append(np.nonzero(hit)[0].astype(np.int32))
        obs_z.append(z.astype(np.float32))
        obs_w_pts.append(pts_w[j[hit]].astype(np.float32))

    if not obs_pose:
        return None
    obs_pose = np.concatenate(obs_pose)
    obs_lm = np.concatenate(obs_lm)
    obs_z = np.concatenate(obs_z)
    obs_w_pts = np.concatenate(obs_w_pts)

    counts = np.bincount(obs_lm, minlength=cand.shape[0])
    keep = counts >= max(min_obs, 1)
    if not keep.any():
        return None
    remap = np.cumsum(keep) - 1
    sel = keep[obs_lm]
    obs_pose, obs_lm, obs_z, obs_w_pts = (
        obs_pose[sel], remap[obs_lm[sel]].astype(np.int32), obs_z[sel],
        obs_w_pts[sel],
    )
    # landmark init = mean of its observers' matched world points
    m = int(keep.sum())
    sums = np.zeros((m, 3), np.float64)
    np.add.at(sums, obs_lm, obs_w_pts.astype(np.float64))
    cnt = np.bincount(obs_lm, minlength=m)[:, None]
    landmarks = (sums / np.maximum(cnt, 1)).astype(np.float32)

    return make_ba_problem(poses, landmarks, obs_pose, obs_lm, obs_z,
                           device=device)
