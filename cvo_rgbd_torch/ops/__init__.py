"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

- `gram.color_gram` (csrc/color_gram.cu): the per-pair color cache.
- `moments.fused_moments` (csrc/fused_moments.cu): the per-iteration
  moment sweep.
- `wsq.fused_wsq` (csrc/fused_wsq.cu): the adaptive self-kernel sweep.
- `flow.fused_flow` and `flow.fused_step_coeffs` (csrc/fused_flow.cu): the
  two sweeps of the two-pass step (kernel backend, `step_mode="direct"`).
- `align_fused.align_fused` (csrc/align_fused.cu): the whole align loop,
  one launch per align; `align_fused.align_fused_batched`: B aligns
  stacked on a lane axis, one launch for all of them.

The construct probes' kernel (csrc/construct_probe.cu) sits beside its
plain versions in `cvo_rgbd_torch.probes`.

A wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises.  `wrapper.launches` counts launches.
"""

from cvo_rgbd_torch.ops.align_fused import align_fused, align_fused_batched
from cvo_rgbd_torch.ops.flow import fused_flow, fused_step_coeffs
from cvo_rgbd_torch.ops.gram import color_gram
from cvo_rgbd_torch.ops.moments import fused_moments
from cvo_rgbd_torch.ops.wsq import fused_wsq

__all__ = ["align_fused", "align_fused_batched", "color_gram", "fused_flow",
           "fused_moments", "fused_step_coeffs", "fused_wsq"]
