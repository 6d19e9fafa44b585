"""Command-line interface.

    python -m cvo_rgbd_torch.cli run <folder> <seq> [--adaptive]
        [--backend kernel|dense] [--device cpu]
    python -m cvo_rgbd_torch.cli evaluate-ate <groundtruth> <estimate>
    python -m cvo_rgbd_torch.cli evaluate-rpe <groundtruth> <estimate>

`run` mirrors the reference executables (`./cvo $data_path $tum_seq`,
and the adaptive one with `--adaptive`) on the CUDA device unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys


def _make_params(args):
    """Params from CLI flags: AcvoParams under `--adaptive`, else
    CvoParams, on `--backend`, with the C++ constants (eps=5e-5/1e-5)
    unless `--matlab-tol` (5e-4/1e-4) or `--eps/--eps-2` say otherwise."""
    from cvo_rgbd_torch.params import AcvoParams, CvoParams

    kw = {"backend": args.backend}
    if args.matlab_tol:
        kw["eps"], kw["eps_2"] = 5e-4, 1e-4
    if args.eps is not None:
        kw["eps"] = args.eps
    if args.eps_2 is not None:
        kw["eps_2"] = args.eps_2
    return (AcvoParams if args.adaptive else CvoParams)(**kw)


def _cmd_run(args):
    from cvo_rgbd_torch.odometry import run_odometry

    seq = int(args.seq) if args.seq.isdigit() else args.seq
    run_odometry(
        args.folder,
        seq,
        adaptive=args.adaptive,
        params=_make_params(args),
        output=args.output,
        max_frames=args.max_frames,
        checkpoint=args.checkpoint,
        num_want=args.num_want,
        warm_start=not args.cold_start,
        fetch_every=args.fetch_every,
        device=args.device,
    )


def _cmd_ate(args):
    from cvo_rgbd_torch.evaluation import ate_rmse
    from cvo_rgbd_torch.io.tum import read_trajectory

    stats = ate_rmse(
        read_trajectory(args.groundtruth),
        read_trajectory(args.estimate),
        max_difference=args.max_difference,
    )
    if args.verbose:
        print(json.dumps(stats, indent=2))
    else:
        print(f"{stats['rmse']:.6f}")


def _cmd_rpe(args):
    from cvo_rgbd_torch.evaluation import rpe
    from cvo_rgbd_torch.io.tum import read_trajectory

    stats = rpe(
        read_trajectory(args.groundtruth),
        read_trajectory(args.estimate),
        delta=args.delta,
        delta_unit=args.delta_unit,
        fixed_delta=True,
    )
    print(json.dumps(stats, indent=2))


def main(argv=None):
    p = argparse.ArgumentParser(prog="cvo_rgbd_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run odometry on a TUM-format folder")
    pr.add_argument("folder")
    pr.add_argument("seq", help="camera key: 0..5 or "
                    "realsense/fr1/fr2/fr3/kitti15/kitti05")
    pr.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    pr.add_argument("--adaptive", action="store_true",
                    help="adaptive CVO (acvo): HSV features and the "
                    "adaptive length-scale (adaptive_cvo.cpp)")
    pr.add_argument("--backend", default="kernel",
                    choices=["kernel", "dense"],
                    help="'kernel' (default; the hand-written CUDA kernels, "
                    "the JAX package's 'pallas') or 'dense' (the dense "
                    "Gram in plain torch, its 'xla'); the whole-align "
                    "'fused' backend is not ported yet")
    pr.add_argument("--output")
    pr.add_argument("--max-frames", type=int)
    pr.add_argument("--checkpoint")
    pr.add_argument("--num-want", type=int, default=3000)
    pr.add_argument("--matlab-tol", action="store_true",
                    help="MATLAB stop set (eps=5e-4/1e-4)")
    pr.add_argument("--eps", type=float, help="flow-norm stop override")
    pr.add_argument("--eps-2", type=float, dest="eps_2",
                    help="se3-distance stop override")
    pr.add_argument("--cold-start", action="store_true",
                    help="start every pair from identity at ell_init "
                    "instead of the reference's across-pair R/T/ell "
                    "warm start (cvo.cpp:43-45, 398-399)")
    pr.add_argument("--fetch-every", type=int, default=8,
                    help="frames between device->host result flushes "
                    "(the trajectory is identical for any value)")
    pr.set_defaults(fn=_cmd_run)

    pa = sub.add_parser("evaluate-ate", help="ATE RMSE of a trajectory")
    pa.add_argument("groundtruth")
    pa.add_argument("estimate")
    pa.add_argument("--max-difference", type=float, default=0.02)
    pa.add_argument("--verbose", action="store_true")
    pa.set_defaults(fn=_cmd_ate)

    pp = sub.add_parser("evaluate-rpe", help="RPE of a trajectory")
    pp.add_argument("groundtruth")
    pp.add_argument("estimate")
    pp.add_argument("--delta", type=float, default=1.0)
    pp.add_argument("--delta-unit", default="s",
                    choices=["s", "m", "rad", "deg", "f"])
    pp.set_defaults(fn=_cmd_rpe)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
