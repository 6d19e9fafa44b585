"""The port's file tooling against the JAX package's, on the same seeded
inputs: `utils.edge`, `io.matlab`, `evaluation.plots`/`baselines`,
`visualize`, the `generate-pointclouds`, `registered-cloud`,
`plot-trajectory` and `associate` subcommands, `process_frame` and the
top-level `function_inner_product`.  All of it is host numpy in both
packages, so every array is held exactly (the baselines' statistics
within 1e-9)."""

import os
import struct
import zlib

import numpy as np
import pytest

import cvo_rgbd_torch
from cvo_rgbd_torch.synth import BandScene, make_tum_dataset, revisit_path

N_FRAMES = 4


def _rng(name):
    return np.random.default_rng(zlib.adler32(name.encode()))


def _image(rng, h=48, w=64):
    """A smooth field with a step and a bright square: edges of every
    orientation, and weak ones for the hysteresis."""
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(rng.normal(0, 1, (h, w, 3)), (2, 2, 0)) * 30 + 100
    img[:, w // 2:] += 60
    img[h // 4:h // 2, w // 5:w // 3] += 80
    return np.clip(img, 0, 255).astype(np.float32)


# -- utils.edge --------------------------------------------------------

@pytest.mark.parametrize("thresholds", [(None, None), (2.0, 6.0)])
def test_canny_edges_match_jax(thresholds):
    from cvo_rgbd_tpu.utils.edge import canny_edges as jax_canny

    from cvo_rgbd_torch.utils import canny_edges

    gray = _image(_rng("canny")) @ np.array([0.299, 0.587, 0.114],
                                            np.float32)
    low, high = thresholds
    got = canny_edges(gray, low=low, high=high, sigma=1.2)
    want = jax_canny(gray, low=low, high=high, sigma=1.2)
    assert got.dtype == bool and got.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_colors", [False, True])
def test_edge_filter_matches_jax(with_colors):
    from cvo_rgbd_tpu.utils.edge import edge_filter as jax_filter

    from cvo_rgbd_torch.utils import edge_filter

    rng = _rng("edge_filter")
    rgb = _image(rng)
    pos = rng.normal(0, 1, rgb.shape).astype(np.float32)
    pos[rng.random(rgb.shape[:2]) < 0.1] = np.nan
    pos[rng.random(rgb.shape[:2]) < 0.1] = 0.0
    colors = rgb / 255.0 if with_colors else None
    got = edge_filter(rgb, pos, colors)
    want = jax_filter(rgb, pos, colors)
    if with_colors:
        assert len(got) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        assert got.shape[0] > 0 and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)


# -- io.matlab ---------------------------------------------------------

def _affine(rng):
    from scipy.spatial.transform import Rotation

    H = np.eye(4)
    H[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.05, 3)).as_matrix()
    H[:3, 3] = rng.normal(0, 0.1, 3)
    return H


def _mcos_blob(mats, rng, decoys=3):
    """A workspace blob with each matrix as MATLAB serializes an
    affine3d's T: the [4,4] dims element, an empty name element, then a
    miDOUBLE tag and 16 float64 in column order, of the row-vector
    convention (T = H'); junk between them, and [4,4] dims elements with
    no miDOUBLE tag after them, which the scan must pass over."""
    from cvo_rgbd_torch.io import matlab

    parts = [rng.bytes(37)]
    for _ in range(decoys):
        parts += [matlab._DIMS_4X4, rng.bytes(40)]
    for H in mats:
        parts += [matlab._DIMS_4X4, struct.pack("<II", 1, 0),
                  matlab._MIDOUBLE_128,
                  np.asarray(H.T, "<f8").tobytes(order="F"), rng.bytes(11)]
    return b"".join(parts)


def test_scan_4x4_doubles_matches_jax():
    from cvo_rgbd_tpu.io.matlab import _scan_4x4_doubles as jax_scan

    from cvo_rgbd_torch.io.matlab import _scan_4x4_doubles

    rng = _rng("scan")
    mats = [np.eye(4)] + [_affine(rng) for _ in range(6)]
    blob = _mcos_blob(mats, rng)
    got, want = _scan_4x4_doubles(blob), jax_scan(blob)
    assert len(got) == len(want) == len(mats)
    for g, w, H in zip(got, want, mats):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g.T, H)


def _stub_loadmat(monkeypatch, mats, rng, name="freiburg1_desk"):
    """scipy.io.loadmat answering every path with a stored run of
    `mats` (the run's own file is not vendored)."""
    import scipy.io

    n = len(mats)
    blob = _mcos_blob(mats, rng)
    fake = {
        "registration_time": rng.random((1, n - 1)),
        "dataset_name": np.array([name]),
        "result": np.empty((n, 1), object),
        "__function_workspace__": np.frombuffer(blob, np.uint8)[None, :],
    }
    monkeypatch.setattr(scipy.io, "loadmat", lambda path, **kw: fake)
    return fake


def test_read_stored_run_matches_jax(monkeypatch):
    from cvo_rgbd_tpu.io.matlab import read_stored_run as jax_read

    from cvo_rgbd_torch.io import StoredRun, read_stored_run

    rng = _rng("stored")
    mats = [np.eye(4)] + [_affine(rng) for _ in range(5)]
    _stub_loadmat(monkeypatch, mats, rng)
    got, want = read_stored_run("run.mat"), jax_read("run.mat")
    assert isinstance(got, StoredRun)
    np.testing.assert_array_equal(got.transforms, want.transforms)
    np.testing.assert_array_equal(got.transforms, np.stack(mats))
    np.testing.assert_array_equal(got.registration_time,
                                  want.registration_time)
    assert got.dataset_name == want.dataset_name == "freiburg1_desk"
    assert got.num_pairs == want.num_pairs == 5
    np.testing.assert_array_equal(got.pair_transform(2),
                                  want.pair_transform(2))
    # a result count the scan does not find raises in both
    fake = _stub_loadmat(monkeypatch, mats, rng)
    fake["result"] = np.empty((len(mats) + 1, 1), object)
    for fn in (read_stored_run, jax_read):
        with pytest.raises(ValueError, match="embedded 4x4 doubles"):
            fn("run.mat")


# -- evaluation.plots / baselines -------------------------------------

def _trajectory(rng, n, t0=100.0, scale=0.02):
    traj, T = {}, np.eye(4)
    for i in range(n):
        traj[round(t0 + 0.1 * i, 6)] = T.copy()
        step = _affine(rng)
        step[:3, 3] *= scale / 0.1
        T = T @ step
    return traj


def test_relative_errors_match_jax():
    from cvo_rgbd_tpu.evaluation.plots import relative_errors as jax_rel

    from cvo_rgbd_torch.evaluation.plots import relative_errors

    rng = _rng("relative")
    gt = _trajectory(rng, 12)
    est = {t: T @ _affine(rng) for t, T in list(gt.items())[1:]}
    got, want = relative_errors(gt, est), jax_rel(gt, est)
    assert got[0].shape == (10,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _write_csv(path, rels, columns, header):
    rows = []
    for k, H in enumerate(rels):
        if columns == 14:
            row = [k, k + 1, *H[:3, 3], *H[:3, :3].ravel()]
        elif columns == 16:
            row = list(H.ravel())
        else:
            row = list(H[:3, :4].ravel())
        rows.append(",".join(f"{v:.9g}" for v in row))
    text = ("frame1,frame2,tx,ty,tz,r11\n" if header else "")
    path.write_text(text + "\n".join(rows) + "\n")
    return path


@pytest.mark.parametrize("columns,header", [(14, True), (16, False),
                                            (12, False)])
def test_load_relative_pose_csv_matches_jax(tmp_path, columns, header):
    from cvo_rgbd_tpu.evaluation.plots import load_relative_pose_csv as jl

    from cvo_rgbd_torch.evaluation.plots import load_relative_pose_csv

    rng = _rng(f"csv{columns}")
    rels = [_affine(rng) for _ in range(7)]
    path = _write_csv(tmp_path / "poses.csv", rels, columns, header)
    got, want = load_relative_pose_csv(path), jl(path)
    assert got.shape == (7, 4, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.stack(rels), atol=1e-8)


@pytest.mark.parametrize("invert,lead_identity", [(False, False),
                                                  (True, True)])
def test_chain_relative_poses_matches_jax(invert, lead_identity):
    from cvo_rgbd_tpu.evaluation.plots import chain_relative_poses as jchain

    from cvo_rgbd_torch.evaluation.plots import chain_relative_poses

    rng = _rng(f"chain{invert}")
    stamps = [100.0 + 0.1 * i for i in range(8)]
    rels = np.stack([_affine(rng) for _ in range(7)])
    rels[3] = np.nan                    # a failed pair freezes the pose
    if lead_identity:
        rels = np.concatenate([np.eye(4)[None], rels])
    got = chain_relative_poses(rels, stamps, invert=invert)
    want = jchain(rels, stamps, invert=invert)
    assert list(got) == list(want) == stamps
    for t in stamps:
        np.testing.assert_array_equal(got[t], want[t])
    np.testing.assert_array_equal(got[stamps[4]], got[stamps[3]])


def _png_ok(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plots_write_pngs(tmp_path):
    from cvo_rgbd_torch.evaluation.plots import (
        plot_error_cdfs,
        plot_trajectories,
        relative_errors,
    )

    rng = _rng("plots")
    gt = _trajectory(rng, 10)
    est = {t: T @ _affine(rng) for t, T in gt.items()}
    cdf = plot_error_cdfs({"cvo": relative_errors(gt, est),
                           "gt": relative_errors(gt, gt)},
                          str(tmp_path / "cdf.png"))
    traj = plot_trajectories({"gt": gt, "cvo": est},
                             str(tmp_path / "traj.png"))
    assert _png_ok(cdf) and _png_ok(traj)


def test_mint_fr1_desk_baselines_matches_jax(tmp_path, monkeypatch):
    """A synthetic dataset folder in the fr1/desk layout: assoc.txt,
    groundtruth.txt, the OpenCV CSV (inverse motions, identity rows on
    failure) and the stored MATLAB run (read through a loadmat stub)."""
    from cvo_rgbd_tpu.evaluation.baselines import (
        mint_fr1_desk_baselines as jax_mint,
    )

    from cvo_rgbd_torch.evaluation import mint_fr1_desk_baselines
    from cvo_rgbd_torch.evaluation.baselines import STORED_MATLAB_RUN
    from cvo_rgbd_torch.io.tum import write_trajectory_line

    rng = _rng("baselines")
    n = 15
    gt = _trajectory(rng, n)
    stamps = list(gt)
    with open(tmp_path / "groundtruth.txt", "w") as f:
        for t in stamps:
            write_trajectory_line(f, f"{t:.6f}", gt[t])
    (tmp_path / "assoc.txt").write_text("".join(
        f"{t:.6f} rgb/{t:.6f}.png {t:.6f} depth/{t:.6f}.png\n"
        for t in stamps))
    motion = [np.linalg.inv(gt[a]) @ gt[b] @ _affine(rng)
              for a, b in zip(stamps, stamps[1:])]
    cv = [np.linalg.inv(H) for H in motion]
    cv[4] = np.eye(4)
    _write_csv(tmp_path / "cv_rgbd_poses.csv", cv, 14, header=True)
    _stub_loadmat(monkeypatch, [np.eye(4)] + motion, rng)
    assert STORED_MATLAB_RUN.endswith(".mat")

    got, want = mint_fr1_desk_baselines(str(tmp_path)), jax_mint(
        str(tmp_path))
    assert set(got) == set(want) == {"opencv_vo", "matlab_cvo"}
    for k in got:
        assert set(got[k]) == set(want[k])
        for s in got[k]:
            np.testing.assert_allclose(got[k][s], want[k][s], rtol=0,
                                       atol=1e-9)
    assert 0 < got["matlab_cvo"]["rmse"] < 0.2


# -- visualize ---------------------------------------------------------

def test_selected_pixels_image_matches_jax():
    from cvo_rgbd_tpu.visualize import selected_pixels_image as jax_sel

    from cvo_rgbd_torch.visualize import selected_pixels_image

    rng = _rng("selected")
    rgb = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    depth = rng.uniform(2000, 20000, (64, 96)).astype(np.float32)
    idx = rng.choice(64 * 96, 300, replace=False)
    valid = (rng.random(300) < 0.8).astype(np.float32)
    got = selected_pixels_image(rgb, depth, idx, valid)
    assert got.dtype == np.uint8 and not np.array_equal(got, rgb)
    np.testing.assert_array_equal(got, jax_sel(rgb, depth, idx, valid))


def test_draw_trajectory_into_image_matches_jax():
    from cvo_rgbd_tpu.frontend.camera import get_camera as jax_camera
    from cvo_rgbd_tpu.visualize import draw_trajectory_into_image as jax_draw

    from cvo_rgbd_torch.frontend.camera import get_camera
    from cvo_rgbd_torch.visualize import draw_trajectory_into_image

    rng = _rng("draw")
    rgb = rng.integers(0, 256, (480, 640, 3)).astype(np.uint8)
    traj = {}
    for i in range(9):
        T = _affine(rng)
        T[:3, 3] += [0.05 * i - 0.2, 0.0, 2.0]
        traj[float(i)] = T
    cam_pose = _affine(rng)
    got = draw_trajectory_into_image(rgb, get_camera("fr1"), cam_pose, traj,
                                     radius=3)
    want = jax_draw(rgb, jax_camera("fr1"), cam_pose, traj, radius=3)
    assert ((got == (255, 40, 40)).all(-1)).sum() > 5
    np.testing.assert_array_equal(got, want)


def test_export_registered_clouds_matches_jax():
    from cvo_rgbd_tpu.frontend.camera import get_camera as jax_camera
    from cvo_rgbd_tpu.visualize import export_registered_clouds as jax_export

    from cvo_rgbd_torch.frontend.camera import get_camera
    from cvo_rgbd_torch.visualize import export_registered_clouds

    rng = _rng("export")
    frames, traj = [], {}
    for i in range(3):
        rgb = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
        depth = rng.uniform(0, 20000, (48, 64)).astype(np.float32)
        depth[rng.random((48, 64)) < 0.2] = 0
        frames.append((float(i), rgb, depth))
        traj[float(i)] = _affine(rng)
    frames.append((7.0, rgb, depth))    # no pose: left out
    got = export_registered_clouds(frames, traj, get_camera(1), stride=3)
    want = jax_export(frames, traj, jax_camera(1), stride=3)
    assert got[0].shape[0] > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    empty = export_registered_clouds(frames, {}, get_camera(1))
    assert empty[0].shape == (0, 3)


# -- the four subcommands ----------------------------------------------

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("tooling_tum")
    make_tum_dataset(root, revisit_path(N_FRAMES, period=33), BandScene())
    return root


def _forward_trajectory(path):
    """Poses at the frames' timestamps, in front of frame 0's camera, on
    a bearing that projects into the 96x128 frame."""
    lines = ["200.000000 0 0 0 0 0 0 1\n"]
    for i in range(1, N_FRAMES):
        z = 1.0 + 0.2 * i
        lines.append(f"{200.0 + 0.1 * i:.6f} {-0.5 * z:.6f} {-0.4 * z:.6f} "
                     f"{z:.6f} 0 0 0 1\n")
    path.write_text("".join(lines))
    return path


def _cases(folder, out):
    rgb_txt = out.parent / "rgb.txt"
    depth_txt = out.parent / "depth.txt"
    rgb_txt.write_text("# rgb\n1.00 rgb/1.png\n2.00 rgb/2.png\n"
                       "3.50 rgb/3.png\n")
    depth_txt.write_text("# depth\n1.01 depth/1.png\n2.015 depth/2.png\n"
                         "3.40 depth/3.png\n")
    traj = _forward_trajectory(out.parent / "fwd.txt")
    return {
        "generate-pointclouds": [
            ["generate-pointclouds", str(folder), "1", "--out", str(out),
             "--stride", "3", "--max-frames", "3"],
            ["generate-pointclouds", str(folder), "1", "--out", str(out),
             "--format", "ply", "--stride", "5"]],
        "registered-cloud": [
            ["registered-cloud", str(folder), "1",
             str(folder / "groundtruth.txt"), "--output",
             str(out / "scene.ply"), "--stride", "4", "--frame-stride", "2",
             "--downsample", "0.05"],
            ["registered-cloud", str(folder), "fr1",
             str(folder / "groundtruth.txt"), "--output",
             str(out / "whole.ply"), "--max-frames", "3"]],
        "plot-trajectory": [
            ["plot-trajectory", str(folder), "1", str(traj), "--output",
             str(out / "traj.png"), "--frame", "0"],
            ["plot-trajectory", str(folder), "1", str(traj), "--output",
             str(out / "last.png"), "--frame", "9", "--radius", "1"]],
        "associate": [
            ["associate", str(rgb_txt), str(depth_txt)],
            ["associate", str(rgb_txt), str(depth_txt), "--offset", "-0.1",
             "--max-difference", "0.2"]],
    }


def _run(main, argv, out, capsys):
    """Run one package's subcommand into an empty `out`; returns (printed
    lines, {file name: bytes})."""
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    out.mkdir()
    capsys.readouterr()
    main(argv)
    files = {}
    for name in sorted(os.listdir(out)):
        with open(out / name, "rb") as f:
            files[name] = f.read()
    return capsys.readouterr().out.splitlines(), files


@pytest.mark.parametrize("cmd", ["generate-pointclouds", "registered-cloud",
                                 "plot-trajectory", "associate"])
def test_subcommand_matches_jax_cli(folder, tmp_path, capsys, cmd):
    from cvo_rgbd_tpu.cli import main as jax_main

    from cvo_rgbd_torch.cli import main

    out = tmp_path / "out"
    for argv in _cases(folder, out)[cmd]:
        lines, files = _run(main, argv, out, capsys)
        jlines, jfiles = _run(jax_main, argv, out, capsys)
        assert lines == jlines and lines
        assert files == jfiles
        if cmd != "associate":
            assert files
    if cmd == "registered-cloud":
        head = files["whole.ply"].split(b"end_header")[0].decode()
        n = int(head.split("element vertex")[1].split()[0])
        assert n > 100 and f"{n} points from 3 frames" in lines[0]


def test_registered_cloud_without_a_match_exits(folder, tmp_path):
    from cvo_rgbd_torch.cli import main

    far = tmp_path / "far.txt"
    far.write_text("900.000000 0 0 0 0 0 0 1\n")
    with pytest.raises(SystemExit, match="no frame matches"):
        main(["registered-cloud", str(folder), "1", str(far), "--output",
              str(tmp_path / "x.ply")])


# -- the frontend and the package's top level ---------------------------

def test_function_inner_product_is_the_core_one():
    from cvo_rgbd_torch.core import registration

    assert cvo_rgbd_torch.function_inner_product is (
        registration.function_inner_product)
    assert "function_inner_product" in cvo_rgbd_torch.__all__


@pytest.mark.parametrize("feature_type,bgr_quirk",
                         [(1, False), (0, True), (0, False), (1, True)])
def test_process_frame_is_make_frontend(folder, feature_type, bgr_quirk):
    """process_frame on a raw uint8/uint16 frame: JAX's process_frame's
    cloud (the mask exactly, the rest to float32 rounding, as
    tests/test_torch_frontend.py) and exactly make_frontend's."""
    import torch

    from cvo_rgbd_tpu.frontend import process_frame as jax_process_frame

    from PIL import Image

    from cvo_rgbd_torch.frontend import make_frontend, process_frame
    from cvo_rgbd_torch.io.tum import load_assoc

    entry = load_assoc(os.path.join(folder, "assoc.txt"))[1]
    rgb = np.asarray(Image.open(os.path.join(folder, entry.rgb_path)))
    dep = np.asarray(Image.open(os.path.join(folder, entry.depth_path)))
    assert rgb.dtype == np.uint8 and dep.dtype == np.uint16
    got = process_frame(rgb, dep, 1, 256, feature_type, bgr_quirk,
                        device="cpu")
    ref = jax_process_frame(rgb, dep, 1, 256, feature_type, bgr_quirk)
    assert got.positions.device == torch.device("cpu")
    assert got.mask.sum() > 64
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(ref.positions), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.features.numpy(),
                               np.asarray(ref.features), rtol=1e-5,
                               atol=1e-6)
    want = make_frontend(1, 256, feature_type, bgr_quirk=bgr_quirk,
                         device="cpu")(rgb, dep)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
