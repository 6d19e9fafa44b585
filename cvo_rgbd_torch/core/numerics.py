"""Accurate exp(-z) for the Gram entries.

exp_neg(z) = 2^-n * p(-r),  n = round(z*log2 e),  r = z - n*ln 2

with a Cody-Waite two-part ln2 reduction and a degree-7 polynomial on
[-ln2/2, ln2/2] — the same constants and operation order as the JAX
package, so the CPU result matches it bit for bit where neither side
fuses a multiply-add.  A fast approximate exp jitters the sparsity
gates (a > sp_thres) and stalls the align loop above the C++ stop
eps=5e-5.  The CUDA kernels carry the same function in
csrc/pair_tile.cuh.
"""

from __future__ import annotations

import torch

LN2_HI = 0.693145751953125      # 11 significand bits: n*LN2_HI is exact
LN2_LO = 1.42860677e-06
LOG2E = 1.4426950408889634
# degree-7 relative-error LSQ fit of e^x on [-ln2/2, ln2/2]
EXP_COEF = (
    9.9999999997e-01, 1.0000000002e+00, 5.0000000815e-01,
    1.6666665277e-01, 4.1666287710e-02, 8.3335634999e-03,
    1.3944149940e-03, 1.9761959601e-04,
)
# exp(-80) ~ 1.8e-35 is still a normal fp32
Z_MAX = 80.0


def exp_neg(z: torch.Tensor) -> torch.Tensor:
    """exp(-z) for fp32 z >= 0, ~1e-7 relative error."""
    z = torch.clamp_max(z, Z_MAX)
    n = torch.round(z * LOG2E)          # half to even, as jnp.round
    r = (z - n * LN2_HI) - n * LN2_LO
    p = torch.full_like(z, EXP_COEF[7])
    for c in EXP_COEF[6::-1]:
        p = p * (-r) + c
    two_pow = ((127 - n.to(torch.int32)) << 23).view(torch.float32)
    return p * two_pow
