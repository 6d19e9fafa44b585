"""The Mosaic construct probes, ported.

The JAX package bisected the lowering of its tiled whole-align kernel
with toy `pallas_call`s: `scripts/tpu_construct_probe.py` (cases a, b,
b2, c, d, e, and the tiled align at one and at 2x2 tiles, f and g) and
`scripts/tpu_construct_probe2.py` (h, i, j, k, and the tiled align with
N != M, g2_x2_y1 and g3_x1_y2).  Here each toy case is a hand-written
CUDA kernel, `csrc/construct_probe.cu`, behind `construct_probe`, with
its plain torch version `construct_probe_plain` beside it; the align
cases run the port's `align_fused` kernel forced to mode "tiled", as the
scripts force the JAX one.  Each kernel computes its TPU case's [8, 128]
result from the same inputs; where the script's construct does not reach
the result (the rows of b2's and k's scratches past the output, e's dot
computed three times), the kernel drops it, and the source's header says
per case what was kept.  No case keeps a device scratch: each is one
launch of one pass.

`inputs` gives each case the scripts' constant inputs, whose results
have closed forms (CLOSED); `seeded_inputs` the same shapes drawn from a
seed, on which each kernel is held to its plain version (`tolerance`),
so a kernel that wrote a closed form without reading its inputs fails.

    python -m cvo_rgbd_torch.probes [--device cpu]

prints one {"case", "ok", "val"} JSON line per case, `val` the first
element of the result (for the aligns, the iteration count), then DONE,
as the scripts do; `ok` says that a toy case gave its closed form and an
align a finite transform (the command exits 1 otherwise).  It runs on
the card unless `--device cpu` is given.

The TPU cases b, d and e read their scratch before writing it, so their
TPU values are undefined; the port's scratch starts at zero, which gives
the closed forms of CLOSED.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from cvo_rgbd_torch.device import pin_fp32, resolve_device
from cvo_rgbd_torch.ops import _build
from cvo_rgbd_torch.ops.gram import check_inputs

# the toy cases, in the kernel's case numbering
CASES = ("a", "b", "b2", "c", "d", "e", "h", "i", "j", "k")
# first element of each result with zero-initialized scratch
CLOSED = {"a": 3.0, "b": 6.0, "b2": 1.0, "c": 159.0, "d": 3.0,
          "e": 3 * 256 * 0.01 * 0.02, "h": 256.0, "i": 512.0,
          "j": 65536.0, "k": 2.0}
# e sums 768 fp32 products of the inexact 0.01 and 0.02; every other
# case is exact in fp32
E_RTOL = 1e-5
# the tiled aligns: (fixed capacity, moving capacity, max_iter)
ALIGNS = {"f": (256, 256, 5), "g": (512, 512, 5),
          "g2_x2_y1": (512, 256, 4), "g3_x1_y2": (256, 512, 4)}
OUT_SHAPE = (8, 128)
# the shapes of each case's inputs, as the scripts give them
SHAPES = {"a": ((8, 128),), "b": ((8, 1024),), "b2": ((256, 1024),),
          "c": ((1, 160),), "d": ((1, 8),),
          "e": ((1, 8), (256, 256), (256, 128)), "h": ((512, 1),),
          "i": ((1, 512),), "j": ((512, 1), (1, 512)), "k": ((1, 8),)}
# the cases whose first input is a guard row: the work runs while its
# first element is > -1; GUARD_OFF turns it off
GUARDED = ("d", "e")
GUARD_OFF = -2.0
# the cases whose kernel rounds every operation as the plain version
# does, so it gives the plain version's bits on any input
EXACT = ("a", "b", "b2", "c", "d", "k")


def inputs(case, device):
    """The inputs the scripts give each toy case, on `device`."""
    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return {
        "a": lambda: (full((8, 128), 1.0),),
        "b": lambda: (full((8, 1024), 1.0),),
        "b2": lambda: (full((256, 1024), 1.0),),
        "c": lambda: (torch.arange(160, dtype=torch.float32,
                                   device=device).reshape(1, 160),),
        "d": lambda: (full((1, 8), 0.0),),
        # the guard row, then the kernel's constant operands a and b
        "e": lambda: (full((1, 8), 0.0), full((256, 256), 0.01),
                      full((256, 128), 0.02)),
        "h": lambda: (full((512, 1), 1.0),),
        "i": lambda: (full((1, 512), 1.0),),
        "j": lambda: (full((512, 1), 1.0), full((1, 512), 1.0)),
        "k": lambda: (full((1, 8), 0.0),),
    }[case]()


def seeded_inputs(case, device, seed, guard=0.0):
    """Case `case`'s inputs in the shapes of SHAPES, drawn with numpy's
    default_rng(seed) uniformly from [0.5, 1.5) on a grid of 2^-23 (every
    value exact in float32), on `device`; the guard row of d and e is
    `guard` (0: on, GUARD_OFF: off).  Unlike the scripts' constant
    inputs, these have no closed form a kernel could write unread."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in SHAPES[case]:
        v = 0.5 + rng.integers(0, 1 << 23, size=shape) * 2.0 ** -23
        out.append(torch.from_numpy(v.astype(np.float32)).to(device))
    if case in GUARDED:
        out[0].fill_(guard)
    return tuple(out)


def tolerance(case, *ins):
    """The largest |kernel - plain| allowed on each of the [8, 128]
    outputs of `case` on `ins`: 0 where the kernel rounds every operation
    as the plain version does (a, b, b2, c, d, k, and every output of h,
    i, j outside row 0); for the sums, whose order differs, a fraction of
    the sum of their terms' magnitudes: e 1e-6 (three times its 256
    products), h and i 1e-6, j 1e-5 (its 65536 squares)."""
    x = ins[0]
    tol = torch.zeros(OUT_SHAPE, dtype=torch.float64, device=x.device)
    if case == "e" and bool(x[0, 0] > -1.0):
        a, b = ins[1].double().abs(), ins[2].double().abs()
        tol += 1e-6 * 3 * (a[:, 0:8].T @ b[:, 0:128])
    elif case in ("h", "i"):
        tol[0] = 1e-6 * (1 if case == "h" else 2) * torch.sum(
            x.double().reshape(-1)[256:512].abs())
    elif case == "j":
        d = x.double()[256:512, :] - 2 * ins[1].double()[:, 256:512]
        tol[0] = 1e-5 * torch.sum(d * d)
    return tol


def within_tolerance(case, got, ref, ins):
    """Whether the kernel's `got` lies within `tolerance` of the plain
    `ref` on every output."""
    err = (got.double() - ref.double()).abs()
    return bool((err <= tolerance(case, *ins)).all())


def _row0(v, like):
    out = torch.zeros(OUT_SHAPE, dtype=torch.float32, device=like.device)
    out[0] = v
    return out


def construct_probe_plain(case, *ins):
    """Plain torch version of toy case `case`: the [8, 128] result."""
    x = ins[0]
    if case == "a":
        s = x * 2.0
        return s + 1.0
    if case == "b":
        s = torch.zeros((8, 1024), dtype=x.dtype, device=x.device)
        acc = 1.0
        for _ in range(3):
            s[:, 256:512] += x[:, 0:256] * acc
            acc += 1.0
        return s[:, 256:384].clone()
    if case == "b2":
        s = torch.empty((128, 1024), dtype=x.dtype, device=x.device)
        for _ in range(3):
            s.zero_()
            s[:, 0:256] += x[0:128, 0:256]
        return s[0:8, 0:128].clone()
    if case == "c":
        return _row0(x[0, 0] + x[0, 159], x)
    if case in ("d", "e"):
        sc = torch.zeros(OUT_SHAPE, dtype=x.dtype, device=x.device)
        for _ in range(3):
            if bool(x[0, 0] > -1.0):
                sc += 1.0 if case == "d" else (ins[1].T @ ins[2])[0:8, 0:128]
        return sc
    if case == "h":
        return _row0(torch.sum(x[256:512, :]), x)
    if case == "i":
        return _row0(torch.sum((x * 2.0)[:, 256:512]), x)
    if case == "j":
        d = (x[256:512, :] - (ins[1] * 2.0)[:, 256:512]) ** 2
        return _row0(torch.sum(d), x)
    if case == "k":
        sc = torch.empty((128, 512), dtype=x.dtype, device=x.device)
        for _ in range(2):
            sc.zero_()
            sc[:, 256:512] += torch.full((128, 256), 2.0, device=x.device)
        return sc[0:8, 256:384].clone()
    raise ValueError(f"unknown probe case {case!r}")


def construct_probe_cuda(case, *ins):
    """Launch toy case `case` of csrc/construct_probe.cu on CUDA tensors;
    returns the [8, 128] result and counts one launch in
    `construct_probe.launches`."""
    dev = ins[0].device
    check_inputs("construct_probe", ins, dev)
    shapes = tuple(tuple(t.shape) for t in ins)
    if shapes != SHAPES[case]:
        raise ValueError(f"construct_probe {case}: inputs of shapes "
                         f"{SHAPES[case]}, got {shapes}")
    if any(t.data_ptr() % 16 for t in ins):
        raise ValueError(f"construct_probe {case}: the kernel reads its "
                         "inputs in 16-byte loads; every input must be "
                         "16-byte aligned")
    out = torch.empty(OUT_SHAPE, dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in ins] + [None] * (3 - len(ins))
    launch = _build.entry("construct_probe")
    err = launch(CASES.index(case), *ptrs, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check("construct_probe", err)
    construct_probe.launches += 1
    return out


def construct_probe(case, *ins):
    """Toy case `case` on its inputs' device: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    if case not in CASES:
        raise ValueError(f"unknown probe case {case!r}")
    dev = ins[0].device
    if dev.type == "cpu":
        return construct_probe_plain(case, *ins)
    if dev.type != "cuda":
        raise ValueError(f"construct_probe: unsupported device {dev}")
    return construct_probe_cuda(case, *ins)


construct_probe.launches = 0


def tiled_problem(case, device):
    """(params, fixed, moving) of align case `case`, built as the scripts
    build them: default_rng(0), standard_normal positions, random()*255
    features, padded to the capacities of ALIGNS; f and g register a
    cloud to itself shifted by 0.01, g2 and g3 two independent clouds."""
    from cvo_rgbd_torch.core.cloud import pad_cloud
    from cvo_rgbd_torch.params import CvoParams

    n, m, max_iter = ALIGNS[case]
    rng = np.random.default_rng(0)
    if case in ("f", "g"):
        k = {"f": 220, "g": 500}[case]
        pos = rng.standard_normal((k, 3)).astype(np.float32)
        feat = (rng.random((k, 5)) * 255).astype(np.float32)
        x = pad_cloud(pos, feat, capacity=n, device=device)
        y = pad_cloud(pos + 0.01, feat, capacity=m, device=device)
    else:
        pos = rng.standard_normal((n - 20, 3)).astype(np.float32)
        feat = (rng.random((n - 20, 5)) * 255).astype(np.float32)
        pos2 = rng.standard_normal((m - 20, 3)).astype(np.float32)
        feat2 = (rng.random((m - 20, 5)) * 255).astype(np.float32)
        x = pad_cloud(pos, feat, capacity=n, device=device)
        y = pad_cloud(pos2, feat2, capacity=m, device=device)
    return CvoParams(max_iter=max_iter, eps=5e-4, eps_2=1e-4), x, y


def tiled_align(case, device=None):
    """Align case `case` through the port's align_fused forced to mode
    "tiled": the kernel on the card, the plain version on the CPU.
    Returns the AlignResult."""
    from cvo_rgbd_torch.ops.align_fused import (
        align_fused_cuda,
        align_fused_plain,
        result_from_row,
    )

    dev = resolve_device(device)
    p, x, y = tiled_problem(case, dev)
    run = align_fused_plain if dev.type == "cpu" else align_fused_cuda
    return result_from_row(run(p, x, y, mode="tiled"))


def closed_form_ok(case, val) -> bool:
    want = CLOSED[case]
    if case == "e":
        return abs(val - want) <= E_RTOL * want
    return val == want


def run(device=None, log=print):
    """Every case on `device`, each logged as the scripts log it.
    Returns {case: (ok, val)}."""
    dev = resolve_device(device)
    pin_fp32()
    out = {}
    for case in CASES:
        val = float(construct_probe(case, *inputs(case, dev))[0, 0])
        out[case] = (closed_form_ok(case, val), val)
    for case in ALIGNS:
        res = tiled_align(case, dev)
        out[case] = (bool(torch.isfinite(res.tf).all()),
                     float(res.iterations))
    for case, (ok, val) in out.items():
        log(json.dumps({"case": case, "ok": ok, "val": val}))
    log("DONE")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m cvo_rgbd_torch.probes")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run the "
                    "plain versions on the CPU)")
    out = run(ap.parse_args(argv).device, log=lambda s: print(s, flush=True))
    return 0 if all(ok for ok, _ in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
