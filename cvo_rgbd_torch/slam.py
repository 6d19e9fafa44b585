"""Keyframe SLAM: keyframe odometry, loop closure, pose-graph optimization.

Port of the JAX package's `slam.py`.  The reference stops at
frame-to-frame chaining (cvo.cpp:414); this module composes the port's
pieces into a SLAM system:

- frames register against the current keyframe (drift accumulates only
  across keyframe promotions);
- promotion uses the normalized function inner product
  (`keyframes.KeyframeSelector`, the hook adaptive_cvo.cpp:385-439
  defines and never wires);
- a new keyframe is scored against the past ones; a high-overlap,
  non-adjacent pair is registered and added as a loop-closure edge;
- the SE(3) pose graph (`core.posegraph`) spreads the loop error;
- `refine_map` bundle-adjusts the keyframe poses and a landmark map
  harvested from the keyframe clouds (`parallel.ba`).

Every align, inner product and pose-graph solve runs on the slam's
device (the card unless `device="cpu"`); a frame's results reach the host
in one read (`process`), a group's in one read (`process_batch`).

The JAX package's compiled forms are captured programs here
(`core.compiled`): the aligns go through `align_jit`; a frame's self
and cross inner products (`keyframes.py`) and `cloud_ok`
(`_compiled_cloud_ok`) are one CUDA graph each, and `process_batch`'s
step after its align (`_slam_step`, the JAX package's
`_compiled_slam_step`) is one; the loop-closure search replays the
one-pair inner product programs; `solve`'s `posegraph.optimize` and
`refine_map`'s `ba_solve` replay one captured Gauss-Newton iteration
(`CapturedLoop`).  On the CPU the same functions run uncaptured.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cvo_rgbd_torch.core.cloud import PointCloud, cloud_ok
from cvo_rgbd_torch.core.compiled import align_jit, program_for
from cvo_rgbd_torch.core.posegraph import from_odometry, optimize
from cvo_rgbd_torch.core.registration import function_inner_product
from cvo_rgbd_torch.device import resolve_device
from cvo_rgbd_torch.keyframes import (
    KeyframePolicy,
    KeyframeSelector,
    aligned_fip,
    inner_product_async,
    keyframe_scores_batched,
)


def _cloud_ok(min_valid, positions, mask):
    return cloud_ok(PointCloud(positions, None, mask), min_valid)


def _compiled_cloud_ok(cloud, min_valid):
    """`cloud_ok` as a captured program (the JAX package's
    `_compiled_cloud_ok`): a 0-dim bool tensor where the cloud lies."""
    inputs = (cloud.positions, cloud.mask)
    return program_for("cloud_ok", _cloud_ok, (min_valid,), inputs)(*inputs)


def _fetch(*values):
    """The tensors `values` read back to the host in one transfer, as
    float64 numpy arrays of their own shapes."""
    flat = torch.cat([torch.as_tensor(v).reshape(-1).to(torch.float64)
                      for v in values]).cpu().numpy()
    out, k = [], 0
    for v in values:
        n = torch.as_tensor(v).numel()
        out.append(flat[k:k + n].reshape(tuple(torch.as_tensor(v).shape)))
        k += n
    return out


def _step_post(params, min_valid, tf, R, T, k_pos, k_feat, k_mask, pos,
               feat, mask):
    """The work of a frame after its align (the rest of the JAX
    package's `_compiled_slam_step`): (finite, warm R, warm T, fresh ell,
    <f,f>, <f_key,f>)."""
    key_cloud = PointCloud(k_pos, k_feat, k_mask)
    cloud = PointCloud(pos, feat, mask)
    dev = tf.device
    finite = torch.isfinite(tf).all() & cloud_ok(cloud, min_valid)
    f32 = torch.float32
    Rw = torch.where(finite, R, torch.eye(3, dtype=f32, device=dev))
    Tw = torch.where(finite, T, torch.zeros(3, dtype=f32, device=dev))
    ellw = torch.full((), params.ell_init, dtype=f32, device=dev)
    cs = function_inner_product(params, cloud, cloud)
    cross = function_inner_product(params, key_cloud, cloud)
    return finite, Rw, Tw, ellw, cs, cross


def _slam_step(params, key_cloud, cloud, warm, min_valid, device):
    """One frame's work on the device, no host sync: the align against
    the keyframe through `align_jit`, then one captured program
    (`_step_post`) that folds in the warm-start bookkeeping and the self
    and cross inner products the promotion needs.  Returns (tf, finite,
    R, T, ell, <f,f>, <f_key,f>), the next warm state being the three in
    the middle.

    Warm R/T, FRESH ell: keyframe-relative pairs have growing baselines,
    and carrying the previous pair's fully shrunk ell (0.03 after the
    k>19 schedule, cvo.cpp:408-410) narrows the kernel support so much
    that the flow dies before covering the extra offset; the warm
    transform is the right prior, the warm length-scale is not."""
    res = align_jit(params, key_cloud, cloud, *warm, device=device)
    inputs = (res.tf, res.R, res.T, *key_cloud, *cloud)
    post = program_for("the SLAM step", _step_post, (params, min_valid),
                       inputs)(*inputs)
    return (res.tf,) + post


def _angle(R):
    return np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))


@dataclasses.dataclass
class Keyframe:
    index: int            # frame index in the input sequence
    pose: np.ndarray      # [4,4] world pose (odometry estimate)
    cloud: object         # PointCloud, on the slam's device
    self_fip: float = 1.0  # cached <f,f> (rigid-invariant)


@dataclasses.dataclass
class SlamConfig:
    keyframe: KeyframePolicy = dataclasses.field(
        default_factory=KeyframePolicy)
    loop_min_separation: int = 3       # keyframes between loop candidates
    loop_score_threshold: float = 0.5  # overlap needed to attempt closure
    loop_edge_weight: float = 5.0
    loop_max_correction_m: float = 0.5     # outlier gates on measured
    loop_max_correction_rad: float = 0.5   # vs odometry prior
    # spatial prior gate: candidates whose odometry-relative pose to the
    # new keyframe exceeds these bounds are skipped before any kernel
    # evaluation
    loop_prior_max_m: float = 1.0
    loop_prior_max_rad: float = 1.0
    # input-sanity gate (core.cloud.cloud_ok): frames with fewer valid
    # points, or non-finite positions, are skipped and marked and never
    # become keyframes
    min_valid: int = 64
    optimize_iters: int = 15
    # robust kernel of the pose-graph solve (core.posegraph): a wrong
    # loop closure that slips past the correction gates down-weights
    # itself by IRLS; huber_delta=0 is exact least squares
    huber_delta: float = 0.3
    robust_kernel: str = "cauchy"
    # graduated robustification: the first GN iterations run Huber
    # before Cauchy, so a genuine closure of large drift lands
    robust_warmup_iters: int = 5


class KeyframeSlam:
    """Feed clouds with `process`; call `solve` for the optimized poses."""

    def __init__(self, params, config: SlamConfig | None = None,
                 device=None):
        self.params = params
        self.config = config or SlamConfig()
        self.device = resolve_device(device)
        self.selector = KeyframeSelector(params, self.config.keyframe)
        self.keyframes: list[Keyframe] = []
        self.frame_poses: list[np.ndarray] = []   # per input frame
        self.frame_keyframe: list[int] = []       # owning keyframe id
        self.loop_edges: list[tuple] = []
        # across-frame warm start, valid only while the keyframe is
        # unchanged: the previous frame's keyframe-relative transform is
        # a near-exact prior for the next frame's
        self._warm = None       # (R0, T0, ell0)
        self._warm_kf = -1
        # the explicit cold start: identity and ell_init, on the device,
        # so a warm start uploads nothing
        f32 = torch.float32
        self._cold = (torch.eye(3, dtype=f32, device=self.device),
                      torch.zeros(3, dtype=f32, device=self.device),
                      torch.full((), params.ell_init, dtype=f32,
                                 device=self.device))

    def process(self, index, cloud):
        """Register one frame; returns its (odometry) world pose."""
        cloud = cloud.to(self.device)
        cloud_self_d = inner_product_async(self.params, cloud, cloud)
        ok_d = _compiled_cloud_ok(cloud, self.config.min_valid)
        if not self.keyframes:
            pose = np.eye(4)
            self.frame_poses.append(pose)
            self.frame_keyframe.append(0)
            if not bool(ok_d):
                # a degenerate frame never becomes a keyframe, frame 0
                # included: seeding waits for the first frame that passes
                return pose
            cloud_self = float(cloud_self_d)
            self.keyframes.append(Keyframe(index, pose, cloud, cloud_self))
            self.selector.update(index, cloud, cloud_self=cloud_self)
            return pose

        key = self.keyframes[-1]
        kf_id = len(self.keyframes) - 1
        warm = (self._warm if self._warm is not None
                and self._warm_kf == kf_id else self._cold)
        res = align_jit(self.params, key.cloud, cloud, *warm,
                        device=self.device)
        cross_d = inner_product_async(self.params, key.cloud, cloud)
        rel, cloud_self, cross, ok = _fetch(res.tf, cloud_self_d, cross_d,
                                            ok_d)
        cloud_self = float(cloud_self)
        failed = not (bool(ok) and np.isfinite(rel).all())
        if failed:
            # skip-and-mark: carry the previous frame's pose (rel =
            # identity would snap back to the keyframe's pose)
            rel = np.linalg.inv(key.pose) @ self.frame_poses[-1]
            self._warm = None
        else:
            # warm R/T, fresh ell (see _slam_step)
            self._warm = (res.R, res.T, self._cold[2])
            self._warm_kf = kf_id
        pose = key.pose @ rel
        self.frame_poses.append(pose)
        self.frame_keyframe.append(kf_id)

        if failed:
            # never promote a degenerate frame; keep the span counter
            self.selector.tick()
            return pose
        score = float(cross / np.sqrt(float(key.self_fip) * cloud_self
                                      + 1e-30))
        promoted, _ = self.selector.update_scored(index, cloud, cloud_self,
                                                  score)
        if promoted:
            self.keyframes.append(Keyframe(index, pose, cloud, cloud_self))
            self._try_loop_closure(len(self.keyframes) - 1)
        return pose

    def process_batch(self, items):
        """Process consecutive `(index, cloud)` frames with ONE host read
        for the group.  Each frame registers against the keyframe active
        when the group started, so each pose is exact; what changes
        against `process` is the promotion cadence: scores are examined a
        group at a time, so a promotion (and its loop-closure search) may
        land up to len(items)-1 frames later, and after an in-group
        promotion the group's remaining frames skip the check (their
        scores were measured against the old keyframe).  Returns the
        frames' world poses."""
        poses_out = []
        items = list(items)
        # the first frame seeds the keyframe set through process()
        while items and not self.keyframes:
            index, cloud = items.pop(0)
            poses_out.append(self.process(index, cloud))
        if not items:
            return poses_out

        key = self.keyframes[-1]
        kf_id = len(self.keyframes) - 1
        if self._warm is not None and self._warm_kf == kf_id:
            warm = self._warm
        else:
            # odometry prior for the group's first frame: a group can
            # open several steps from a keyframe promoted in the last
            # group, where a cold start can exhaust max_iter under the
            # shrinking ell schedule; inv(key.pose) @ last_pose is one
            # frame stale, which the warm chain absorbs
            prior = np.linalg.inv(key.pose) @ self.frame_poses[-1]
            R0 = prior[:3, :3].T.astype(np.float32)
            T0 = (-prior[:3, :3].T @ prior[:3, 3]).astype(np.float32)
            warm = (R0, T0, self._cold[2])
        pend = []
        for index, cloud in items:
            cloud = cloud.to(self.device)
            out = _slam_step(self.params, key.cloud, cloud, warm,
                             self.config.min_valid, self.device)
            warm = out[2:5]   # the warm chain stays on the device
            pend.append((index, cloud, out))
        fetched = _fetch(*(v for _, _, out in pend for v in
                           (out[0], out[1], out[5], out[6])))
        self._warm, self._warm_kf = warm, kf_id

        promoted_any = False
        for q, (index, cloud, _) in enumerate(pend):
            rel, fin, cs, cross = fetched[4 * q:4 * q + 4]
            if not bool(fin):
                # skip-and-mark: carry the previous frame's pose
                rel = np.linalg.inv(key.pose) @ self.frame_poses[-1]
            pose = key.pose @ rel
            self.frame_poses.append(pose)
            self.frame_keyframe.append(kf_id)
            poses_out.append(pose)
            if not bool(fin) or promoted_any:
                # a degenerate frame is never promoted; after an in-group
                # promotion the scores are stale: keep the frame counter
                self.selector.tick()
                continue
            cs = float(cs)
            score = float(cross / np.sqrt(float(key.self_fip) * cs + 1e-30))
            promoted, _ = self.selector.update_scored(index, cloud, cs,
                                                      score)
            if promoted:
                self.keyframes.append(Keyframe(index, pose, cloud, cs))
                self._try_loop_closure(len(self.keyframes) - 1)
                promoted_any = True
        if promoted_any:
            # the stored warm state is relative to the old keyframe
            self._warm = None
        return poses_out

    def _try_loop_closure(self, kf_id):
        cfg = self.config
        kf = self.keyframes[kf_id]
        # 1. spatial prior gate, host math: by odometry, keyframes beyond
        # the bound cannot overlap
        cand_ids, priors = [], {}
        for cand_id in range(kf_id - cfg.loop_min_separation):
            prior = np.linalg.inv(self.keyframes[cand_id].pose) @ kf.pose
            if (np.linalg.norm(prior[:3, 3]) <= cfg.loop_prior_max_m
                    and _angle(prior[:3, :3]) <= cfg.loop_prior_max_rad):
                cand_ids.append(cand_id)
                priors[cand_id] = prior
        if not cand_ids:
            return
        # 2. the overlap scores of every surviving candidate at once,
        # from the cached self products
        scores = keyframe_scores_batched(
            self.params, [self.keyframes[c].cloud for c in cand_ids],
            kf.cloud, [self.keyframes[c].self_fip for c in cand_ids],
            kf.self_fip)
        order = int(np.argmax(scores))
        if scores[order] < cfg.loop_score_threshold:
            return
        cand_id = cand_ids[order]
        cand = self.keyframes[cand_id]

        # 3. register from the odometry prior and from a cold start, and
        # keep the one with the higher post-align inner product (the
        # quantity the flow maximizes): a cold start across a large offset
        # can stop at a nearby local optimum, a drifted prior can strand
        # the align at the drift scale
        prior = priors[cand_id]
        R0 = prior[:3, :3].T.astype(np.float32)
        T0 = (-prior[:3, :3].T @ prior[:3, 3]).astype(np.float32)
        res_p = align_jit(self.params, cand.cloud, kf.cloud, R0, T0,
                          device=self.device)
        res_c = align_jit(self.params, cand.cloud, kf.cloud, *self._cold,
                          device=self.device)
        quals = aligned_fip(self.params, cand.cloud, kf.cloud,
                            (res_p.tf, res_c.tf))
        rel_p, cv_p, rel_c, cv_c, quals = _fetch(
            res_p.tf, res_p.converged, res_c.tf, res_c.converged, quals)
        cands = [(float(q), r) for q, r, cv in
                 ((quals[0], rel_p, cv_p), (quals[1], rel_c, cv_c))
                 if bool(cv) and np.isfinite(r).all()]
        if not cands:
            return
        rel = max(cands, key=lambda t: t[0])[1]
        # 4. outlier gate: the measured relative pose must lie within a
        # plausible correction of the prior
        delta = np.linalg.inv(prior) @ rel
        if (np.linalg.norm(delta[:3, 3]) > cfg.loop_max_correction_m
                or _angle(delta[:3, :3]) > cfg.loop_max_correction_rad):
            return
        self.loop_edges.append((cand_id, kf_id, rel, cfg.loop_edge_weight))

    def solve(self):
        """Optimize the keyframe graph on the slam's device; returns
        (per-frame corrected poses, keyframe nodes [K,4,4] numpy)."""
        if not self.keyframes:
            # every frame was degenerate: nothing was ever seeded
            return list(self.frame_poses), np.zeros((0, 4, 4))
        kf_poses = np.stack([k.pose for k in self.keyframes])
        if len(self.keyframes) < 2:
            return list(self.frame_poses), kf_poses
        graph = from_odometry(kf_poses, loop_edges=self.loop_edges,
                              device=self.device)
        nodes, _ = optimize(graph, iters=self.config.optimize_iters,
                            huber_delta=self.config.huber_delta,
                            robust=self.config.robust_kernel,
                            robust_warmup=self.config.robust_warmup_iters)
        nodes = nodes.cpu().numpy().astype(np.float64)
        # re-anchor every frame to its corrected keyframe
        out = []
        for pose, kf_id in zip(self.frame_poses, self.frame_keyframe):
            correction = nodes[kf_id] @ np.linalg.inv(
                self.keyframes[kf_id].pose)
            out.append(correction @ pose)
        return out, nodes

    def refine_map(self, kf_poses=None, mesh=None, iters=8, grid=0.05,
                   radius=0.03, feature_weight=2.0):
        """Bundle-adjust keyframe poses and a landmark map on the slam's
        device (`parallel.ba`).

        Starts from `kf_poses` (default: the pose-graph solution of
        `solve`).  Returns (refined keyframe poses [K,4,4], landmarks
        [M,3], costs [iters]) as tensors on the slam's device, or None
        below two keyframes or when the keyframes give no problem.
        `mesh` (`parallel.make_mesh`) shards the observation reductions
        over its ranks (`parallel.ba.ba_solve`); every rank of it then
        calls this, each with its own slam on its own device.

        `radius` must stay below the clouds' typical point spacing: on
        continuous surfaces a larger radius lets the landmark-to-point
        association slide along the surface between views, and that bias
        shows up as pose error; `feature_weight` pins each correspondence
        to the same textured spot across views (the JAX package's
        calibration, `parallel.ba.ba_from_keyframes`)."""
        from cvo_rgbd_torch.parallel import ba_from_keyframes, ba_solve

        if len(self.keyframes) < 2:
            return None
        if kf_poses is None:
            _, kf_poses = self.solve()
        problem = ba_from_keyframes(
            [k.cloud for k in self.keyframes], np.asarray(kf_poses),
            grid=grid, radius=radius, feature_weight=feature_weight,
            device=self.device,
        )
        if problem is None:
            return None
        return ba_solve(problem, mesh=mesh, iters=iters, device=self.device)
