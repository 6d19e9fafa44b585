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

The JAX package jits each inner product once per params
(`_compiled_fip`, `_compiled_fip_batched`, `_compiled_aligned_fip`).
Here each is a captured program (`core.compiled.CapturedProgram`, one
CUDA graph on the card, a replay a call; uncaptured on the CPU) per
(params, the clouds' shapes, types, strides and device), kept for the
life of the process as JAX's `lru_cache` keeps its jits: a self product
(one cloud), a cross product (two) and a cross product under a transform
(two clouds and a [4,4]).  Where JAX vmaps a program over the K
candidates of a loop-closure search (`keyframe_scores_batched`) or the K
transforms of `aligned_fip`, padding K to a power of two floored at 32
so that its recompiles stay few, the port replays its one-pair program
once a candidate: a capture costs nothing past the first, and a padded,
all-masked lane would cost a real one's N x M Grams.  Each lane is then
the bits of its one-pair call, and the K results are read back at once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cvo_rgbd_torch.core.cloud import PointCloud
from cvo_rgbd_torch.core.compiled import program_for
from cvo_rgbd_torch.core.registration import function_inner_product
from cvo_rgbd_torch.device import pin_fp32


def _self_fip(params, pos, feat, mask):
    cloud = PointCloud(pos, feat, mask)
    return function_inner_product(params, cloud, cloud)


def _cross_fip(params, a_pos, a_feat, a_mask, b_pos, b_feat, b_mask):
    return function_inner_product(params, PointCloud(a_pos, a_feat, a_mask),
                                  PointCloud(b_pos, b_feat, b_mask))


def _moved_fip(params, a_pos, a_feat, a_mask, b_pos, b_feat, b_mask, tf):
    pos = b_pos @ tf[:3, :3].T + tf[:3, 3]
    return function_inner_product(params, PointCloud(a_pos, a_feat, a_mask),
                                  PointCloud(pos, b_feat, b_mask))


_FORMS = {"self": _self_fip, "cross": _cross_fip, "moved": _moved_fip}


def _program(form, params, inputs):
    """The captured program of inner product `form` ("self": one cloud's
    fields; "cross": two clouds'; "moved": two clouds' and a [4,4]
    transform of the second) for these inputs."""
    return program_for(f"the {form} inner product", _FORMS[form],
                       (params,), inputs)


def _fip(params, cloud_a, cloud_b):
    """<f_a, f_b>, 0-dim where the clouds lie, through its program."""
    pin_fp32()
    if all(x is y for x, y in zip(cloud_a, cloud_b)):
        inputs = tuple(cloud_a)
        return _program("self", params, inputs)(*inputs)
    inputs = (*cloud_a, *cloud_b)
    return _program("cross", params, inputs)(*inputs)


def aligned_fip(params, cloud_a, cloud_b, tfs):
    """<f_a, f_b> with `cloud_b` moved by each of K transforms, [K] where
    the clouds lie.  `tfs` a [K,4,4] tensor or a sequence of [4,4] (align
    results' `.tf`, with no host sync).  The registration flow maximizes
    exactly this quantity, so it ranks competing registrations of one
    pair.  One replay of the one-pair program a transform."""
    pin_fp32()
    dev = cloud_b.positions.device
    out = []
    for tf in tfs:
        tf = torch.as_tensor(tf, dtype=torch.float32).to(dev)
        inputs = (*cloud_a, *cloud_b, tf)
        out.append(_program("moved", params, inputs)(*inputs))
    return torch.stack(out)


def inner_product_async(params, cloud_a, cloud_b):
    """<f_a, f_b> as a 0-dim tensor where the clouds lie, with no host
    sync: a driver reads it with the frame's other results at once."""
    return _fip(params, cloud_a, cloud_b)


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
    their cached self products `cand_selfs`: the K cross products, a
    replay of the one-pair program each, stacked on the device and read
    back at once."""
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
