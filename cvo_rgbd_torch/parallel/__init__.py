"""Multi-device registration and bundle adjustment over
`torch.distributed` (the JAX package's `parallel/`).

- `make_mesh`, `multihost_initialize` (`mesh.py`): named axes over the
  ranks, and the process group; `mesh.launch` starts local ranks.
- `align_sharded`, `align_ring`, `train_step_2d`, `align_batched`
  (`sharded.py`): fixed-cloud rows over `sp`, both clouds around a ring,
  pairs over `dp` (and a pair's rows over `sp`), pairs stacked on a lane
  axis (sharded over `dp` with a mesh).
- bundle adjustment (`ba.py`), on one device or over a mesh.
"""

from cvo_rgbd_torch.parallel.ba import (
    BAProblem,
    ba_cost,
    ba_from_keyframes,
    ba_solve,
    make_ba_problem,
)
from cvo_rgbd_torch.parallel.mesh import make_mesh, multihost_initialize
from cvo_rgbd_torch.parallel.sharded import (
    align_batched,
    align_ring,
    align_sharded,
    train_step_2d,
)

__all__ = [
    "BAProblem",
    "ba_cost",
    "ba_from_keyframes",
    "ba_solve",
    "make_ba_problem",
    "make_mesh",
    "multihost_initialize",
    "align_batched",
    "align_ring",
    "align_sharded",
    "train_step_2d",
]
