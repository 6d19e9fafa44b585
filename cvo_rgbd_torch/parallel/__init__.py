"""Batch parallelism over frame pairs and bundle adjustment (the JAX
package's `parallel/`).

`align_batched` and the single-device bundle adjustment are ported; the
mesh paths (`align_sharded`, `align_ring`, `train_step_2d`, the `dp`
axis of `align_batched`, the sharded `ba_solve`) wait for ROADMAP queue
1, "Multi-device, on torch.distributed".
"""

from cvo_rgbd_torch.parallel.ba import (
    BAProblem,
    ba_cost,
    ba_from_keyframes,
    ba_solve,
    make_ba_problem,
)
from cvo_rgbd_torch.parallel.sharded import align_batched

__all__ = [
    "BAProblem",
    "ba_cost",
    "ba_from_keyframes",
    "ba_solve",
    "make_ba_problem",
    "align_batched",
]
