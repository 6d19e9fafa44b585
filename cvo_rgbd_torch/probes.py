"""The Mosaic construct probes, ported.

The JAX package bisected the lowering of its tiled whole-align kernel
with toy `pallas_call`s: `scripts/tpu_construct_probe.py` (cases a, b,
b2, c, d, e, and the tiled align at one and at 2x2 tiles, f and g) and
`scripts/tpu_construct_probe2.py` (h, i, j, k, and the tiled align with
N != M, g2_x2_y1 and g3_x1_y2).  Here each toy case is a hand-written
CUDA kernel, `csrc/construct_probe.cu` (what each computes is listed
there), behind `construct_probe`, with its plain torch version
`construct_probe_plain` beside it; the align cases run the port's
`align_fused` kernel forced to mode "tiled", as the scripts force the
JAX one.

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
# device scratch of the cases whose scratch exceeds a block's shared memory
SCRATCH = {"b2": (128, 1024), "k": (128, 512)}


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
    out = torch.empty(OUT_SHAPE, dtype=torch.float32, device=dev)
    scratch = (torch.empty(SCRATCH[case], dtype=torch.float32, device=dev)
               if case in SCRATCH else None)
    ptrs = [t.data_ptr() for t in ins] + [None] * (3 - len(ins))
    launch = _build.entry("construct_probe")
    err = launch(CASES.index(case), *ptrs, out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
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
