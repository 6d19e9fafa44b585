"""Command-line interface.

    python -m cvo_rgbd_torch.cli run <folder> <seq> [--adaptive]
        [--backend kernel|dense|fused] [--batch N [--motion-prior]]
        [--no-native-io] [--profile-dir DIR] [--device cpu]
    python -m cvo_rgbd_torch.cli multiseq <seq> <folder>... [--adaptive]
        [--backend kernel|dense|fused] [--device cpu]
    python -m cvo_rgbd_torch.cli batch <pcd dir> [--grid 0.05]
        [--output f.npz] [--device cpu]
    python -m cvo_rgbd_torch.cli stitch <pcd dir> [--output scene.ply]
        [--grid 0.05] [--merge-grid 0.01] [--device cpu]
    python -m cvo_rgbd_torch.cli slam <pcd dir> [--output f.txt]
        [--grid 0.05] [--refine] [--device cpu]
    python -m cvo_rgbd_torch.cli evaluate-ate <groundtruth> <estimate>
    python -m cvo_rgbd_torch.cli evaluate-rpe <groundtruth> <estimate>
    python -m cvo_rgbd_torch.cli generate-pointclouds <folder> <seq>
        [--out pcd_full] [--format pcd|ply] [--stride 1]
    python -m cvo_rgbd_torch.cli registered-cloud <folder> <seq> <traj>
        [--output registered.ply] [--stride 4] [--downsample 0.0]
    python -m cvo_rgbd_torch.cli plot-trajectory <folder> <seq> <traj>
        [--output trajectory.png] [--frame 0]
    python -m cvo_rgbd_torch.cli associate <rgb.txt> <depth.txt>

`run` mirrors the reference executables (`./cvo $data_path $tum_seq`,
and the adaptive one with `--adaptive`), or with `--batch N` registers N
pairs per batched call offline; `multiseq` runs several folders in
lockstep, one pair of each per batched call; `batch` and `stitch` the MATLAB
batch runner (MATLAB_PARAMS: linear color mode, MATLAB stops); `slam`
keyframe SLAM over a pcd folder (keyframes, loop closure, pose graph,
and with `--refine` bundle adjustment of the keyframe map) on
MATLAB_PARAMS.  These run on the CUDA device unless `--device cpu` is
given.  The file tools (`generate-pointclouds`, `registered-cloud`,
`plot-trajectory`, `associate`, `evaluate-*`) are host numpy.
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


def _seq_key(seq):
    return int(seq) if seq.isdigit() else seq


def _cmd_run(args):
    import contextlib

    trace = contextlib.nullcontext()
    if args.profile_dir:
        # a torch.profiler trace of the whole drive, written into
        # --profile-dir (open it in Perfetto or chrome://tracing)
        from cvo_rgbd_torch.utils.timing import profiler_trace

        trace = profiler_trace(args.profile_dir, device=args.device)
    with trace:
        _run_odometry_cmd(args)


def _run_odometry_cmd(args):
    from cvo_rgbd_torch.odometry import run_odometry, run_odometry_batched

    seq = _seq_key(args.seq)
    if args.batch > 1:
        if args.checkpoint:
            raise SystemExit("--batch does not support checkpointing")
        run_odometry_batched(
            args.folder, seq, adaptive=args.adaptive,
            params=_make_params(args), output=args.output,
            max_frames=args.max_frames, num_want=args.num_want,
            batch=args.batch, use_native=not args.no_native_io,
            motion_prior=args.motion_prior, device=args.device,
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
        use_native=not args.no_native_io,
        warm_start=not args.cold_start,
        fetch_every=args.fetch_every,
        device=args.device,
    )


def _cmd_multiseq(args):
    from cvo_rgbd_torch.multiseq import run_multiseq

    run_multiseq(
        args.folders, _seq_key(args.seq), adaptive=args.adaptive,
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
    import numpy as np

    from cvo_rgbd_torch.batch import load_pcd_dir, pad_clouds
    from cvo_rgbd_torch.device import resolve_device
    from cvo_rgbd_torch.io.tum import write_trajectory_line
    from cvo_rgbd_torch.params import MATLAB_PARAMS
    from cvo_rgbd_torch.slam import KeyframeSlam, SlamConfig

    clouds = load_pcd_dir(args.directory, grid=args.grid)
    if not clouds:
        raise SystemExit(f"no .pcd files in {args.directory}")
    dev = resolve_device(args.device)
    slam = KeyframeSlam(MATLAB_PARAMS, SlamConfig(), device=dev)
    for i, cloud in enumerate(pad_clouds(clouds, dev)):
        slam.process(i, cloud)
    poses, kf_nodes = slam.solve()
    print(f"{len(clouds)} frames, {len(slam.keyframes)} keyframes, "
          f"{len(slam.loop_edges)} loop closures")
    if args.refine:
        out = slam.refine_map(kf_poses=kf_nodes)
        if out is None:
            print("refine: too few correspondences, skipped")
        else:
            kf_ba, landmarks, costs = (t.cpu().numpy() for t in out)
            print(f"refine: BA cost {float(costs[0]):.3e} -> "
                  f"{float(costs[-1]):.3e}, {landmarks.shape[0]} landmarks")
            # every frame follows its keyframe's correction
            corr = {k.index: kf_ba[i] @ np.linalg.inv(kf_nodes[i])
                    for i, k in enumerate(slam.keyframes)}
            poses = [
                corr.get(slam.keyframes[slam.frame_keyframe[i]].index,
                         np.eye(4)) @ pose
                for i, pose in enumerate(poses)
            ]
    with open(args.output, "w") as fh:
        for (name, _, _), pose in zip(clouds, poses):
            write_trajectory_line(fh, name.removesuffix(".pcd"), pose)
    print(f"trajectory -> {args.output}")


def _cmd_generate_pointclouds(args):
    """Every assoc.txt frame as a cloud file (generate_pointcloud.py,
    util/generate_pointclouds.m:1-47): the camera's depth scale, PLY or
    PCD out."""
    import os

    from cvo_rgbd_torch.frontend.camera import get_camera
    from cvo_rgbd_torch.io.export import depth_to_cloud, write_pcd, write_ply
    from cvo_rgbd_torch.io.tum import load_assoc
    from cvo_rgbd_torch.odometry import load_image_pair

    cam = get_camera(_seq_key(args.seq))
    entries = load_assoc(os.path.join(args.folder, "assoc.txt"))
    if args.max_frames is not None:
        entries = entries[: args.max_frames]
    os.makedirs(args.out, exist_ok=True)
    write = write_ply if args.format == "ply" else write_pcd
    for e in entries:
        rgb, dep = load_image_pair(args.folder, e)
        pos, col = depth_to_cloud(rgb, dep, cam, stride=args.stride)
        write(os.path.join(args.out, f"{e.name}.{args.format}"), pos, col)
    print(f"{len(entries)} clouds -> {args.out}")


def _matched_frames(args):
    """The camera of `args.seq`, the folder's assoc.txt entries by
    timestamp, the trajectory of `args.trajectory` and the (frame,
    pose) timestamp matches; exits when nothing matches."""
    import os

    from cvo_rgbd_torch.evaluation.associate import associate
    from cvo_rgbd_torch.frontend.camera import get_camera
    from cvo_rgbd_torch.io.tum import load_assoc, read_trajectory

    cam = get_camera(_seq_key(args.seq))
    entries = {float(e.name): e for e in
               load_assoc(os.path.join(args.folder, "assoc.txt"))}
    traj = read_trajectory(args.trajectory)
    matches = associate(entries, traj, 0.0, args.max_difference)
    if not matches:
        raise SystemExit("no frame matches the trajectory timestamps")
    return cam, entries, traj, matches


def _cmd_registered_cloud(args):
    """One world-frame PLY along a trajectory
    (generate_registered_pointcloud.py: frames matched to poses by
    timestamp, backprojected, transformed, merged)."""
    from cvo_rgbd_torch.io.export import merge_clouds, write_ply
    from cvo_rgbd_torch.odometry import load_image_pair
    from cvo_rgbd_torch.visualize import export_registered_clouds

    cam, entries, traj, matches = _matched_frames(args)
    # stride first, then the frame cap: --max-frames K --frame-stride S
    # exports K frames spaced S apart
    matches = matches[:: args.frame_stride]
    if args.max_frames is not None:
        matches = matches[: args.max_frames]
    frames = []
    for ft, tt in matches:
        rgb, dep = load_image_pair(args.folder, entries[ft])
        frames.append((tt, rgb, dep))
    pos, col = export_registered_clouds(frames, traj, cam, stride=args.stride)
    if args.downsample > 0:
        pos, col = merge_clouds([(pos, col)], grid=args.downsample)
    write_ply(args.output, pos, col)
    print(f"{pos.shape[0]} points from {len(frames)} frames -> {args.output}")


def _cmd_plot_trajectory(args):
    """A trajectory projected into one frame's image
    (plot_trajectory_into_image.py)."""
    import numpy as np
    from PIL import Image

    from cvo_rgbd_torch.odometry import load_image_pair
    from cvo_rgbd_torch.visualize import draw_trajectory_into_image

    cam, entries, traj, matches = _matched_frames(args)
    if args.frame < 0:
        raise SystemExit(f"--frame must be >= 0 (got {args.frame})")
    if args.frame >= len(matches):
        print(
            f"--frame {args.frame} out of range; using last matched "
            f"frame {len(matches) - 1}"
        )
    ft, tt = matches[min(args.frame, len(matches) - 1)]
    rgb, _ = load_image_pair(args.folder, entries[ft])
    img = draw_trajectory_into_image(
        np.asarray(rgb), cam, traj[tt], traj, radius=args.radius
    )
    Image.fromarray(img).save(args.output)
    print(f"frame {entries[ft].name} + {len(traj)} poses -> {args.output}")


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


def _cmd_associate(args):
    from cvo_rgbd_torch.evaluation.associate import associate, read_file_list

    first = read_file_list(args.first)
    second = read_file_list(args.second)
    for a, b in associate(first, second, args.offset, args.max_difference):
        print(f"{a:f} {' '.join(first[a])} {b:f} {' '.join(second[b])}")


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
    pr.add_argument("--no-native-io", action="store_true",
                    help="read the PNGs with PIL instead of the C++ "
                    "prefetch loader")
    pr.add_argument("--profile-dir",
                    help="record a torch.profiler trace of the run (CPU "
                    "and CUDA activities) into this directory; open the "
                    "*.pt.trace.json in Perfetto or chrome://tracing")
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
                     help="bundle-adjust the keyframe map after the pose "
                     "graph")
    psl.set_defaults(fn=_cmd_slam)

    pg = sub.add_parser(
        "generate-pointclouds",
        help="export every assoc.txt frame as a .pcd/.ply cloud",
    )
    pg.add_argument("folder")
    pg.add_argument("seq", help="camera key (intrinsics + depth scale)")
    pg.add_argument("--out", default="pcd_full")
    pg.add_argument("--format", default="pcd", choices=["pcd", "ply"])
    pg.add_argument("--stride", type=int, default=1,
                    help="pixel subsampling stride")
    pg.add_argument("--max-frames", type=int)
    pg.set_defaults(fn=_cmd_generate_pointclouds)

    prc = sub.add_parser(
        "registered-cloud",
        help="merge frames along a trajectory into one world-frame PLY",
    )
    prc.add_argument("folder")
    prc.add_argument("seq")
    prc.add_argument("trajectory", help="TUM-format pose file")
    prc.add_argument("--output", default="registered.ply")
    prc.add_argument("--stride", type=int, default=4,
                     help="pixel subsampling stride per frame")
    prc.add_argument("--frame-stride", type=int, default=1)
    prc.add_argument("--max-frames", type=int)
    prc.add_argument("--downsample", type=float, default=0.0,
                     help="grid size for a final merge downsample (m)")
    prc.add_argument("--max-difference", type=float, default=0.02)
    prc.set_defaults(fn=_cmd_registered_cloud)

    ppt = sub.add_parser(
        "plot-trajectory",
        help="project a trajectory into one frame's image (png)",
    )
    ppt.add_argument("folder")
    ppt.add_argument("seq")
    ppt.add_argument("trajectory")
    ppt.add_argument("--output", default="trajectory.png")
    ppt.add_argument("--frame", type=int, default=0,
                     help="index of the matched frame to draw into")
    ppt.add_argument("--radius", type=int, default=2)
    ppt.add_argument("--max-difference", type=float, default=0.02)
    ppt.set_defaults(fn=_cmd_plot_trajectory)

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

    ps = sub.add_parser("associate",
                        help="match rgb.txt and depth.txt timestamps")
    ps.add_argument("first")
    ps.add_argument("second")
    ps.add_argument("--offset", type=float, default=0.0)
    ps.add_argument("--max-difference", type=float, default=0.02)
    ps.set_defaults(fn=_cmd_associate)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
