"""Keyframe selection and the inner products it scores with.

Port of the JAX package's `keyframes.py`.  The reference defines
`function_inner_product` (adaptive_cvo.cpp:385-439) as a keyframe hook
but never wires it into its mains; this module completes it.  The
normalized cross inner product

    score(a, b) = <f_a, f_b> / sqrt(<f_a, f_a> <f_b, f_b>)

measures the overlap of a keyframe and the current frame; when it drops
below `threshold`, the current frame is promoted.

These are dense Grams, which the JAX package computes outside any Pallas
kernel; here they are plain torch where the clouds lie (the card unless
the caller put them on the CPU).  Self inner products are rigid-invariant
per cloud, so a keyframe's is computed once (`self_inner_product`); the
loop-closure search scores one frame against K candidates with one read
back to the host (`keyframe_scores_batched`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cvo_rgbd_torch.core.registration import function_inner_product
from cvo_rgbd_torch.device import pin_fp32


def aligned_fip(params, cloud_a, cloud_b, tfs):
    """<f_a, f_b> with `cloud_b` moved by each of K transforms, [K] where
    the clouds lie.  `tfs` a [K,4,4] tensor or a sequence of [4,4] (align
    results' `.tf`, stacked with no host sync).  The registration flow
    maximizes exactly this quantity, so it ranks competing registrations
    of one pair."""
    pin_fp32()
    if isinstance(tfs, (list, tuple)):
        tfs = torch.stack([torch.as_tensor(t, dtype=torch.float32)
                           .to(cloud_b.positions.device) for t in tfs])
    out = []
    for tf in tfs:
        pos = cloud_b.positions @ tf[:3, :3].T + tf[:3, 3]
        out.append(function_inner_product(
            params, cloud_a, cloud_b._replace(positions=pos)))
    return torch.stack(out)


def inner_product_async(params, cloud_a, cloud_b):
    """<f_a, f_b> as a 0-dim tensor where the clouds lie, with no host
    sync: a driver reads it with the frame's other results at once."""
    pin_fp32()
    return function_inner_product(params, cloud_a, cloud_b)


def self_inner_product(params, cloud) -> float:
    """<f,f> of one cloud: rigid-invariant, cached per keyframe."""
    return float(inner_product_async(params, cloud, cloud))


def keyframe_score(params, key_cloud, cloud, key_self=None,
                   cloud_self=None) -> float:
    """Normalized function inner product in [0, ~1].  `key_self` /
    `cloud_self`, the clouds' cached self inner products, skip two of the
    three Gram evaluations."""
    cross = inner_product_async(params, key_cloud, cloud)
    aa = (self_inner_product(params, key_cloud) if key_self is None
          else key_self)
    bb = (self_inner_product(params, cloud) if cloud_self is None
          else cloud_self)
    return float(cross / np.sqrt(float(aa) * float(bb) + 1e-30))


def keyframe_scores_batched(params, cand_clouds, cloud, cand_selfs,
                            cloud_self):
    """Scores of `cloud` against K candidate clouds, np [K] float32, from
    their cached self products `cand_selfs`: the K cross products stacked
    on the device and read back at once."""
    if not cand_clouds:
        return np.zeros((0,), np.float32)
    cross = torch.stack([inner_product_async(params, c, cloud)
                         for c in cand_clouds])
    cross = cross.cpu().numpy().astype(np.float64)
    selfs = np.asarray(cand_selfs, np.float64)
    return (cross / np.sqrt(selfs * float(cloud_self) + 1e-30)).astype(
        np.float32)


@dataclasses.dataclass
class KeyframePolicy:
    threshold: float = 0.6    # promote when overlap drops below this
    max_span: int = 30        # force promotion after this many frames


class KeyframeSelector:
    """Tracks the active keyframe; call `update` once per frame."""

    def __init__(self, params, policy: KeyframePolicy | None = None):
        self.params = params
        self.policy = policy or KeyframePolicy()
        self.key_cloud = None
        self.key_self = None      # cached <f,f> of the active keyframe
        self.key_index = -1
        self.frames_since = 0

    def update(self, index, cloud, cloud_self=None):
        """Returns (is_new_keyframe, score).  `cloud_self`: the cloud's
        self inner product, if the caller has it."""
        if cloud_self is None:
            cloud_self = self_inner_product(self.params, cloud)
        if self.key_cloud is None:
            self._promote(index, cloud, cloud_self)
            return True, 1.0
        score = keyframe_score(self.params, self.key_cloud, cloud,
                               key_self=self.key_self, cloud_self=cloud_self)
        return self.update_scored(index, cloud, cloud_self, score)

    def update_scored(self, index, cloud, cloud_self, score):
        """`update` with the overlap score already in hand (a driver that
        reads its per-frame results at once); never for the first
        frame."""
        self.frames_since += 1
        if (score < self.policy.threshold
                or self.frames_since >= self.policy.max_span):
            self._promote(index, cloud, cloud_self)
            return True, score
        return False, score

    def tick(self):
        """Advance the frame counter without scoring (a frame whose
        promotion check is skipped), so max_span keeps its cadence."""
        self.frames_since += 1

    def _promote(self, index, cloud, cloud_self):
        self.key_cloud = cloud
        self.key_self = cloud_self
        self.key_index = index
        self.frames_since = 0
