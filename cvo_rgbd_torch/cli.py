"""Command-line interface.

    python -m cvo_rgbd_torch.cli run <folder> <seq> [--adaptive]
        [--backend kernel|dense|fused] [--batch N [--motion-prior]]
        [--device cpu]
    python -m cvo_rgbd_torch.cli multiseq <seq> <folder>... [--adaptive]
        [--backend kernel|dense|fused] [--device cpu]
    python -m cvo_rgbd_torch.cli batch <pcd dir> [--grid 0.05]
        [--output f.npz] [--device cpu]
    python -m cvo_rgbd_torch.cli stitch <pcd dir> [--output scene.ply]
        [--grid 0.05] [--merge-grid 0.01] [--device cpu]
    python -m cvo_rgbd_torch.cli slam <pcd dir> [--output f.txt]
        [--grid 0.05] [--device cpu]
    python -m cvo_rgbd_torch.cli evaluate-ate <groundtruth> <estimate>
    python -m cvo_rgbd_torch.cli evaluate-rpe <groundtruth> <estimate>

`run` mirrors the reference executables (`./cvo $data_path $tum_seq`,
and the adaptive one with `--adaptive`), or with `--batch N` registers N
pairs per batched call offline; `multiseq` runs several folders in
lockstep, one pair of each per batched call; `batch` and `stitch` the MATLAB
batch runner (MATLAB_PARAMS: linear color mode, MATLAB stops); `slam`
keyframe SLAM over a pcd folder (keyframes, loop closure, pose graph) on
MATLAB_PARAMS.  All run on the CUDA device unless `--device cpu` is
given.
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


def _seq(args):
    return int(args.seq) if args.seq.isdigit() else args.seq


def _cmd_run(args):
    from cvo_rgbd_torch.odometry import run_odometry, run_odometry_batched

    seq = _seq(args)
    if args.batch > 1:
        if args.checkpoint:
            raise SystemExit("--batch does not support checkpointing")
        run_odometry_batched(
            args.folder, seq, adaptive=args.adaptive,
            params=_make_params(args), output=args.output,
            max_frames=args.max_frames, num_want=args.num_want,
            batch=args.batch, motion_prior=args.motion_prior,
            device=args.device,
        )
        return
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


def _cmd_multiseq(args):
    from cvo_rgbd_torch.multiseq import run_multiseq

    run_multiseq(
        args.folders, _seq(args), adaptive=args.adaptive,
        params=_make_params(args), num_want=args.num_want,
        max_frames=args.max_frames, warm_start=not args.cold_start,
        device=args.device,
    )


def _cmd_batch(args):
    from cvo_rgbd_torch.batch import run_batch

    run_batch(args.directory, grid=args.grid, output=args.output,
              device=args.device)


def _cmd_stitch(args):
    import numpy as np

    from cvo_rgbd_torch.batch import align_pairs, load_pcd_dir, pad_clouds
    from cvo_rgbd_torch.device import resolve_device
    from cvo_rgbd_torch.io.export import (
        merge_clouds,
        transform_points,
        write_ply,
    )
    from cvo_rgbd_torch.params import MATLAB_PARAMS

    clouds = load_pcd_dir(args.directory, grid=args.grid)
    padded = pad_clouds(clouds, resolve_device(args.device))
    # independent cold-start aligns, then one device->host read
    done, errors, _ = align_pairs(MATLAB_PARAMS, padded)
    if errors:
        raise RuntimeError(f"stitch: pairs failed: {errors}")
    accum = np.eye(4)
    placed = [(clouds[0][1], clouds[0][2])]
    for k in range(1, len(clouds)):
        accum = accum @ done[k][0]
        placed.append((transform_points(accum, clouds[k][1]), clouds[k][2]))
    pos, col = merge_clouds(placed, grid=args.merge_grid)
    write_ply(args.output, pos, col)
    print(f"{pos.shape[0]} points -> {args.output}")


def _cmd_slam(args):
    from cvo_rgbd_torch.batch import load_pcd_dir, pad_clouds
    from cvo_rgbd_torch.device import resolve_device
    from cvo_rgbd_torch.io.tum import write_trajectory_line
    from cvo_rgbd_torch.params import MATLAB_PARAMS
    from cvo_rgbd_torch.slam import KeyframeSlam, SlamConfig

    if args.refine:
        raise SystemExit("slam --refine (bundle adjustment) is not ported "
                         "yet: ROADMAP queue 1, item 5")
    clouds = load_pcd_dir(args.directory, grid=args.grid)
    if not clouds:
        raise SystemExit(f"no .pcd files in {args.directory}")
    dev = resolve_device(args.device)
    slam = KeyframeSlam(MATLAB_PARAMS, SlamConfig(), device=dev)
    for i, cloud in enumerate(pad_clouds(clouds, dev)):
        slam.process(i, cloud)
    poses, _ = slam.solve()
    print(f"{len(clouds)} frames, {len(slam.keyframes)} keyframes, "
          f"{len(slam.loop_edges)} loop closures")
    with open(args.output, "w") as fh:
        for (name, _, _), pose in zip(clouds, poses):
            write_trajectory_line(fh, name.removesuffix(".pcd"), pose)
    print(f"trajectory -> {args.output}")


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
                    choices=["kernel", "dense", "fused"],
                    help="'kernel' (default; the hand-written CUDA kernels, "
                    "one sweep per iteration, the JAX package's 'pallas'), "
                    "'dense' (the dense Gram in plain torch, its 'xla') "
                    "or 'fused' (the whole align loop in one kernel "
                    "launch)")
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
    pr.add_argument("--batch", type=int, default=1,
                    help="register this many pairs per batched call, "
                    "offline (cold-start pairs; on --backend fused, one "
                    "kernel launch a batch)")
    pr.add_argument("--motion-prior", action="store_true",
                    help="with --batch: warm-start each chunk with the "
                    "previous chunk's last relative transform "
                    "(constant-velocity approximation)")
    pr.set_defaults(fn=_cmd_run)

    pm = sub.add_parser(
        "multiseq",
        help="batched odometry over several TUM folders in lockstep "
        "(one batched call registers one pair from every sequence)",
    )
    pm.add_argument("seq", help="camera key shared by all folders")
    pm.add_argument("folders", nargs="+")
    pm.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    pm.add_argument("--adaptive", action="store_true")
    pm.add_argument("--backend", default="kernel",
                    choices=["kernel", "dense", "fused"])
    pm.add_argument("--num-want", type=int, default=3000)
    pm.add_argument("--max-frames", type=int)
    pm.add_argument("--matlab-tol", action="store_true",
                    help="MATLAB stop set (see `run --matlab-tol`)")
    pm.add_argument("--eps", type=float)
    pm.add_argument("--eps-2", type=float, dest="eps_2")
    pm.add_argument("--cold-start", action="store_true",
                    help="disable the per-lane across-pair warm start")
    pm.set_defaults(fn=_cmd_multiseq)

    pb = sub.add_parser("batch", help="pairwise registration over a pcd dir")
    pb.add_argument("directory")
    pb.add_argument("--grid", type=float, default=0.05)
    pb.add_argument("--output")
    pb.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    pb.set_defaults(fn=_cmd_batch)

    pst = sub.add_parser("stitch",
                         help="register + merge a pcd dir into a PLY scene")
    pst.add_argument("directory")
    pst.add_argument("--output", default="scene.ply")
    pst.add_argument("--grid", type=float, default=0.05)
    pst.add_argument("--merge-grid", type=float, default=0.01)
    pst.add_argument("--device", default=None,
                     help="torch device (default: cuda; 'cpu' to run on the CPU)")
    pst.set_defaults(fn=_cmd_stitch)

    psl = sub.add_parser(
        "slam",
        help="keyframe SLAM (loop closure + pose graph) over a pcd dir")
    psl.add_argument("directory")
    psl.add_argument("--output", default="slam_poses_qt.txt")
    psl.add_argument("--grid", type=float, default=0.05)
    psl.add_argument("--device", default=None,
                     help="torch device (default: cuda; 'cpu' to run on the CPU)")
    psl.add_argument("--refine", action="store_true",
                     help="bundle-adjust the keyframe map (not ported: exits "
                     "with an error)")
    psl.set_defaults(fn=_cmd_slam)

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
