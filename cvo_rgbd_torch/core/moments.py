"""Flow and line-search reductions from the A-weighted x-monomial moments.

Port of the JAX package's `core/moments.py`.  The kernel backend accumulates,
in one sweep over the Gram, the omega-independent moment matrix

    Mom[j, m] = sum_i A_ij phi_m(x_i - c0)        [M, 35]

(ops/moments.py).  Every reduction of the reference iteration is then
an O(M) epilogue here: the flow omega, v (cvo.cpp:164-210) from the
degree <= 2 moments, and the quartic line-search coefficients B..E
(cvo.cpp:213-289) from the full matrix.  The JAX package pads Mom to
128 lanes for the TPU; the port keeps the 35 real columns.

Both take a leading lane axis ([B, M, 35], the batched loop of
`parallel.align_batched`): the elementwise work runs on the [B, ...]
tensors, and each sum over a lane's points is the one-pair sum on that
lane (`core.lanes`), so a lane's values are the bits of the one-pair
call on it.
"""

from __future__ import annotations

import torch

from cvo_rgbd_torch.core.lanes import by_lane, lane_matmul
from cvo_rgbd_torch.core.step_factored import M_INDEX, line_search_polys

_I000 = M_INDEX[(0, 0, 0)]
_I100 = M_INDEX[(1, 0, 0)]
_I010 = M_INDEX[(0, 1, 0)]
_I001 = M_INDEX[(0, 0, 1)]
_I200 = M_INDEX[(2, 0, 0)]
_I020 = M_INDEX[(0, 2, 0)]
_I002 = M_INDEX[(0, 0, 2)]


def flow_from_moments(Mom, y_pos, c0, *, c, d):
    """(omega, v, wsq, sum_A) from the moment matrix, in DIFFERENCE form:
    per j, r_j = S0_j y'_j - S1'_j = sum_i A_ij (y_j - x_i) cancels
    inside each column before the j-reduction, which keeps the fp32
    noise floor of the flow below the C++ stop eps=5e-5.  Exact algebra:
      sum_ij A_ij (y_j - x_i)   = sum_j r_j
      sum_ij A_ij (x_i x y_j)   = sum_j S1'_j x y'_j + c0 x sum_j r_j
      sum_ij A_ij |x_i-y_j|^2   = sum_j [tr S2'_j - 2 S1'_j.y'_j
                                         + S0_j |y'_j|^2]
    Mom [M, 35], y_pos [M, 3], c0 [3], or each with a leading lane axis.
    """
    lane = by_lane(Mom.dim() == 3)
    S0 = Mom[..., _I000]
    S1 = torch.stack(
        [Mom[..., _I100], Mom[..., _I010], Mom[..., _I001]], dim=-1)
    S2tr = Mom[..., _I200] + Mom[..., _I020] + Mom[..., _I002]

    def col_sum(t):
        return torch.sum(t, dim=0)

    y_c = y_pos - c0[..., None, :]
    r = S0[..., None] * y_c - S1
    r_sum = lane(col_sum, r)
    v = r_sum / d
    omega = (
        lane(col_sum, torch.linalg.cross(S1, y_c, dim=-1))
        + torch.linalg.cross(c0, r_sum, dim=-1)
    ) / c

    wsq = (
        lane(torch.sum, S2tr)
        - 2.0 * lane(torch.sum, S1 * y_c)
        + lane(torch.dot, S0, torch.sum(y_c * y_c, dim=-1))
    )
    return omega, v, wsq, lane(torch.sum, S0)


def step_from_moments(Mom, y_pos, c0, omega, v, ell):
    """B, C, D, E (cvo.cpp:249-289): each line-search polynomial's
    [M]-vector monomial coefficients contracted against the matching
    moment columns — no [N, M] object."""
    lane = by_lane(Mom.dim() == 3)
    polys = line_search_polys(y_pos, y_pos - c0[..., None, :], omega, v,
                              ell, lane_matmul)

    def contract(P):
        acc = None
        for e, coef in P.terms.items():
            t = coef * Mom[..., M_INDEX[e]]
            acc = t if acc is None else acc + t
        return lane(torch.sum, acc)

    return tuple(contract(P) for P in polys)
