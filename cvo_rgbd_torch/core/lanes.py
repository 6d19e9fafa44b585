"""Per-lane forms of the torch ops whose batched call rounds otherwise.

The batched align loop (`core/registration.make_batched_step`) runs the
O(M) epilogue on tensors with a leading lane axis [B, ...].  An
elementwise op gives every lane the bits of the one-pair op, and so does
a sum over a last axis of 3 (its split depends on that axis alone).  Two
kinds of op do not:
- a sum over a lane's points: on the card torch splits a reduction by
  its number of outputs, so [B, M, k] sums otherwise than [M, k];
- the small matmuls and `torch.dot`: on the CPU a batched 3x3 product
  takes a loop of torch's own where a single one calls BLAS.
`per_lane` and `lane_matmul` run the one-pair op on each lane's slice
(a lane of a contiguous stack has the strides of a fresh tensor of its
shape) and stack the results, so each lane is the bits of the one-pair
op; without a lane axis they are the op itself.

The batched loops (the kernel backend's moment step, the dense backend)
keep on the stack only ops shown to give every lane the one-pair bits,
on the CPU (tests/test_torch_batched_loop.py, test_torch_batched_dense.py)
and on the card (chip_smoke.py 8e: every lane `align_jit`'s bits):
- elementwise ops: the dense Grams `se_gram` and `matlab_gram` on
  [B, N, M] (`exp_neg`'s polynomial, or torch.exp in fast mode), the
  products A * y of the dense flow, the direct step's [B, N, M] fields,
  the line-search polynomials and the moment epilogue's terms on
  [B, M], `cubic_roots`, the stops and the ell update;
- sums over a last axis of 3 and `torch.linalg.cross`;
- the dense count `nnz` over [B, N, M] (an integer sum: exact in any
  order).
Lane by lane: the sums over a lane's points or pairs (the Gram's row
and column sums, the flow's residual sums, B..E, the centroids), the
products with A (A @ y, A @ C), `torch.dot` and the 3x3 and
vector-matrix products.
"""

from __future__ import annotations

import torch


def per_lane(fn, *xs):
    """fn on each lane of the tensors `xs` (a leading lane axis each),
    stacked."""
    return torch.stack([fn(*(x[i] for x in xs))
                        for i in range(xs[0].shape[0])])


def _direct(fn, *xs):
    return fn(*xs)


def by_lane(lanes: bool):
    """`per_lane` where the tensors have a lane axis, else fn(*xs)."""
    return per_lane if lanes else _direct


def lane_matmul(a, b):
    """a @ b: one matmul for matrices, lane by lane where a or b has a
    leading lane axis (the other broadcast to every lane)."""
    if a.dim() < 3 and b.dim() < 3:
        return a @ b
    lanes = a.shape[0] if a.dim() == 3 else b.shape[0]
    return torch.stack([(a[i] if a.dim() == 3 else a)
                        @ (b[i] if b.dim() == 3 else b)
                        for i in range(lanes)])
