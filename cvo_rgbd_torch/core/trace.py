"""Per-iteration records of an align, for convergence debugging.

Port of the JAX package's `core/trace.py`.  The reference prints raw
couts (cvo.cpp:380-405) and the MATLAB prototype an iteration table
every 5 iterations (rkhs_se3_registration.m:252-258).  `align_trace`
runs a fixed number of align iterations and returns the whole record:
|omega|, |v|, ell, the se3 distance of each update and `converged`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cvo_rgbd_torch import se3
from cvo_rgbd_torch.core.cloud import PointCloud, kd_sort
from cvo_rgbd_torch.core.registration import (
    AlignState,
    check_supported,
    init_state,
    make_align_step,
    prepare,
)
from cvo_rgbd_torch.device import pin_fp32, resolve_device
from cvo_rgbd_torch.ops.gram import pad_feat
from cvo_rgbd_torch.params import AcvoParams


class IterRecord(NamedTuple):
    omega_norm: torch.Tensor
    v_norm: torch.Tensor
    ell: torch.Tensor
    dist: torch.Tensor       # se3 distance of the applied update
    converged: torch.Tensor


def align_trace(p, fixed: PointCloud, moving: PointCloud, n_iters: int,
                device=None) -> tuple[AlignState, IterRecord]:
    """Run exactly `n_iters` iterations of `align`'s step on `device`
    (the card unless `device="cpu"`), recording each one.

    The stopping rules still freeze the state, as in `align`; the
    records after convergence repeat the frozen values.  Returns
    (final AlignState, IterRecord of [n_iters] tensors).

    The fused backend runs its whole loop in one launch and cannot
    record an iteration, so its trace runs on the closest per-iteration
    backend, as the JAX package's does: "dense" for acvo's yy_quirk and
    linear mode, else "kernel".  On the kernel backend both clouds are
    kd-sorted, as `align` sorts them: on another point order the fp32
    sums, hence the records, would drift from the align they document.
    """
    adaptive = isinstance(p, AcvoParams)
    if p.backend == "fused":
        to_dense = adaptive and (p.yy_quirk or p.color_mode == "linear")
        p = dataclasses.replace(p, backend="dense" if to_dense else "kernel")
    check_supported(p)
    dev = resolve_device(device)
    pin_fp32()
    fixed, moving = fixed.to(dev), moving.to(dev)
    fixed, moving = (c._replace(features=pad_feat(c.features))
                     for c in (fixed, moving))
    if p.backend == "kernel":
        fixed, moving = kd_sort(fixed), kd_sort(moving)
    state = init_state(p, dev)
    pre = prepare(p, fixed, moving)
    body = make_align_step(p)

    records = [[] for _ in IterRecord._fields]
    for _ in range(n_iters):
        prev_R, prev_T = state.R, state.T
        state = body(state, fixed, moving, pre)
        dR = prev_R.T @ state.R
        dT = prev_R.T @ (state.T - prev_T)
        for col, v in zip(records, (
                torch.linalg.norm(state.omega), torch.linalg.norm(state.v),
                state.ell, se3.dist_se3(dR, dT), state.converged)):
            col.append(v)
    return state, IterRecord(*(
        torch.stack(col) if col else torch.empty(0, device=dev)
        for col in records))
