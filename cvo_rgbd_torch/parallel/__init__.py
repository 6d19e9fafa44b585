"""Batch parallelism over frame pairs (the JAX package's `parallel/`).

Only `align_batched` is ported; the mesh paths (`align_sharded`,
`align_ring`, `train_step_2d`, the `dp` axis of `align_batched`) and
bundle adjustment wait for ROADMAP queue 1, item 15.
"""

from cvo_rgbd_torch.parallel.sharded import align_batched

__all__ = ["align_batched"]
