"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

- `gram.color_gram` (csrc/color_gram.cu): the per-pair color cache.
- `moments.fused_moments` (csrc/fused_moments.cu): the per-iteration
  moment sweep.
- `wsq.fused_wsq` (csrc/fused_wsq.cu): the adaptive self-kernel sweep.

A wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises.  `wrapper.launches` counts launches.
"""

from cvo_rgbd_torch.ops.gram import color_gram
from cvo_rgbd_torch.ops.moments import fused_moments
from cvo_rgbd_torch.ops.wsq import fused_wsq

__all__ = ["color_gram", "fused_moments", "fused_wsq"]
