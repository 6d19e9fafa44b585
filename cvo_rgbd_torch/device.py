"""Device choice and fp32 precision for the port's entry points.

Entry points run on the card unless the caller asks for the CPU with
`device="cpu"`.  Without a card they raise: nothing falls back to the
CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cvo_rgbd_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def pin_fp32() -> None:
    """Every fp32 contraction at full fp32: no TF32 in matmuls or cuDNN.

    The align loop converges at the C++ stops only with full-precision
    SE(3) products and moment epilogues (ROADMAP numerics rules); TF32
    plays the role the TPU's bf16 default played there."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
