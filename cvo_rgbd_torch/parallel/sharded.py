"""Batch data parallelism over frame pairs: `align_batched`.

Port of the JAX package's `parallel/sharded.py:align_batched`
(:792-837), which vmaps `align` over a leading lane axis.  Here:

- `backend="fused"`: the batch is kd-sorted lane by lane in one call and
  registered by ONE launch of the whole-align kernel
  (`ops/align_fused.align_fused_batched`), every lane running its own
  loop, as vmap makes the Pallas kernel a grid dimension.  A problem the
  kernel cannot run is routed as `align` routes one pair.
- `backend="kernel"` and `"dense"`: the lanes run one after another
  through the single-pair `align`, so each lane's result is `align`'s on
  its pair (what a vmapped while_loop gives a lane) and the launches grow
  with the lanes.  A lane axis for those kernels is ROADMAP queue 2's
  next batching step.
"""

from __future__ import annotations

import torch

from cvo_rgbd_torch.core.cloud import PointCloud, kd_sort
from cvo_rgbd_torch.core.registration import (
    AlignResult,
    align,
    check_supported,
)
from cvo_rgbd_torch.device import pin_fp32, resolve_device
from cvo_rgbd_torch.ops.align_fused import align_fused_batched, fused_eligible
from cvo_rgbd_torch.ops.gram import pad_feat


def align_batched(p, fixed_batch: PointCloud, moving_batch: PointCloud,
                  mesh=None, dp_axis: str = "dp", R0=None, T0=None,
                  ell0=None, device=None) -> AlignResult:
    """Register B pairs stacked on a leading lane axis
    (`core.cloud.stack_clouds`) on `device` (the card unless
    `device="cpu"`); returns a batched AlignResult.

    Each lane stops on its own and a converged lane freezes, so a lane's
    result does not depend on the lanes beside it.  `R0` [B,3,3] / `T0`
    [B,3] / `ell0` [B] warm-start each lane (see
    core.registration.align); all three are given together or not at
    all.  `mesh` (sharding the lanes over a `dp` axis) is not ported."""
    warm = (R0, T0, ell0)
    if any(w is not None for w in warm) and any(w is None for w in warm):
        raise ValueError("pass R0, T0 and ell0 together")
    if mesh is not None:
        raise NotImplementedError(
            f"align_batched over a mesh ({dp_axis!r} axis) is not ported "
            "yet: ROADMAP queue 1, \"Multi-device, on torch.distributed\""
        )
    check_supported(p)
    dev = resolve_device(device)
    pin_fp32()
    fixed, moving = fixed_batch.to(dev), moving_batch.to(dev)
    if p.backend == "fused" and fused_eligible(p, fixed, moving):
        # as align: the kernels' NFEAT planes, compact tiles for the skip
        fixed, moving = (c._replace(features=pad_feat(c.features))
                         for c in (fixed, moving))
        fixed, moving = (kd_sort(c) if c.capacity % 128 == 0 else c
                         for c in (fixed, moving))
        return align_fused_batched(p, fixed, moving, *warm)
    lanes = [
        align(p, fixed.lane(i), moving.lane(i),
              *(None if w is None else w[i] for w in warm), device=dev)
        for i in range(fixed.positions.shape[0])
    ]
    return AlignResult(*(torch.stack(field) for field in zip(*lanes)))
