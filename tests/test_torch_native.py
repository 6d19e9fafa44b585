"""The port's native PNG decoder and prefetch loader, on the CPU.

`cvo_rgbd_torch.native` builds its own copies of the JAX package's
`native/pngio.cpp` and `loader.cpp` into `cvo_rgbd_torch/_build/`.  Its
decoder must give the bits of PIL and of the JAX package's decoder, its
loader must keep order and content, a missing file and a failed build
must raise, and `odometry.make_frame_source` must give the same frames
through the loader and through PIL, falling back to neither.  The PNG
writer of `chip_smoke.py` (phase 10, for a host without PIL) must write
files that PIL and the loader read back bit for bit.
"""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from cvo_rgbd_torch import native
from cvo_rgbd_torch.io.tum import load_assoc
from cvo_rgbd_torch.odometry import make_frame_source
from cvo_rgbd_tpu import native as jnative

from torch_scenes import N_FRAMES, make_parallax_folder

JAX_NATIVE = Path(jnative.__file__).resolve().parent


@pytest.fixture(scope="module")
def lib():
    return native.get_lib()


def _body(path, skip):
    """A source's lines after its first `skip` lines."""
    return path.read_text().splitlines()[skip:]


@pytest.mark.parametrize("name", ["pngio.cpp", "loader.cpp"])
def test_sources_are_copies_of_the_jax_packages(name):
    """Only the header comment differs: three lines naming the copy, and
    in loader.cpp the device the loader overlaps with."""
    ours = _body(Path(native.__file__).parent / name, 3)
    theirs = _body(JAX_NATIVE / name, 0)
    differ = [i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b]
    assert len(ours) == len(theirs)
    assert differ == ([4] if name == "loader.cpp" else [])
    assert all(ours[i].startswith("//") for i in differ)


def _save_pil(path, img):
    Image.fromarray(img).save(path)
    return str(path)


@pytest.mark.parametrize("kind", ["rgb8", "gray16", "textured"])
def test_decode_matches_pil_and_jax(lib, tmp_path, rng, kind):
    if kind == "rgb8":
        img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    elif kind == "gray16":
        img = rng.integers(0, 65536, (41, 29)).astype(np.uint16)
    else:  # every PNG filter type, as PIL's optimizer picks them
        yy, xx = np.mgrid[0:240, 0:320]
        img = np.stack([127 + 100 * np.sin(xx / 9.0) * np.cos(yy / 7.0),
                        xx * 255 / 320, yy * 255 / 240],
                       axis=-1).astype(np.uint8)
    path = tmp_path / "a.png"
    Image.fromarray(img).save(path, optimize=kind == "textured")
    out = native.decode_png(str(path))
    assert out.dtype == img.dtype
    np.testing.assert_array_equal(out, img)
    np.testing.assert_array_equal(out, np.asarray(Image.open(path)))
    if jnative.get_lib() is not None:
        np.testing.assert_array_equal(out, jnative.decode_png(str(path)))
    assert native.png_shape(str(path)) == img.shape[:2]


def test_prefetch_loader_keeps_order_and_content(lib, tmp_path, rng):
    n = 12
    frames, rpaths, dpaths = [], [], []
    for i in range(n):
        rgb = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
        dep = rng.integers(0, 60000, (24, 32)).astype(np.uint16)
        rpaths.append(_save_pil(tmp_path / f"r{i}.png", rgb))
        dpaths.append(_save_pil(tmp_path / f"d{i}.png", dep))
        frames.append((rgb, dep))
    loader = native.PrefetchLoader(rpaths, dpaths, 32, 24, workers=3,
                                   ahead=4)
    got = 0
    for idx, rgb, dep in loader:
        assert idx == got
        np.testing.assert_array_equal(rgb, frames[idx][0])
        np.testing.assert_array_equal(dep, frames[idx][1])
        got += 1
    assert got == n == len(loader)
    loader.close()


def test_a_missing_file_raises(lib, tmp_path, rng):
    rgb = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    dep = rng.integers(0, 100, (8, 8)).astype(np.uint16)
    rp = _save_pil(tmp_path / "r.png", rgb)
    dp = _save_pil(tmp_path / "d.png", dep)
    loader = native.PrefetchLoader([rp, str(tmp_path / "missing.png")],
                                   [dp, dp], 8, 8)
    assert next(loader)[0] == 0
    with pytest.raises(IOError):
        next(loader)
    loader.close()
    with pytest.raises(FileNotFoundError):
        native.decode_png(str(tmp_path / "missing.png"))


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    """No silent fallback: a source g++ rejects gives a RuntimeError
    that carries g++'s stderr, and nothing is loaded."""
    bad = tmp_path / "pngio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(native, "LIB", tmp_path / "_build" / "libnative.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.get_lib()
    assert "pngio.cpp" in str(err.value)
    assert not (tmp_path / "_build" / "libnative.so").exists()
    assert native._lib is None


def test_a_newer_source_rebuilds(tmp_path, monkeypatch):
    """The library is built beside no source, and again once a source is
    newer than it."""
    srcs = tuple(shutil.copy(s, tmp_path) for s in native.SOURCES)
    lib = tmp_path / "_build" / "libnative.so"
    monkeypatch.setattr(native, "SOURCES", tuple(map(Path, srcs)))
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(native, "LIB", lib)
    assert native._stale()
    native._build()
    assert not native._stale()
    os.utime(srcs[1], (lib.stat().st_mtime + 10,) * 2)
    assert native._stale()
    assert sorted(os.listdir(tmp_path / "_build")) == ["libnative.so"]


@pytest.mark.parametrize("kind", ["rgb8", "gray16"])
def test_chip_smoke_png_writer_reads_back(lib, tmp_path, rng, kind):
    if kind == "rgb8":
        img = rng.integers(0, 256, (30, 45, 3)).astype(np.uint8)
    else:
        img = rng.integers(0, 65536, (30, 45)).astype(np.uint16)
    path = tmp_path / "w.png"
    path.write_bytes(chip_smoke.png_bytes(img))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(native.decode_png(str(path)), img)


def test_frame_source_native_and_pil_give_the_same_frames(lib, tmp_path):
    folder = make_parallax_folder(tmp_path)
    entries = load_assoc(str(folder / "assoc.txt"))
    a = list(make_frame_source(str(folder), entries, 2, use_native=True))
    b = list(make_frame_source(str(folder), entries, 2, use_native=False))
    assert [f[0] for f in a] == [f[0] for f in b] == list(range(2, N_FRAMES))
    for (_, ra, da), (_, rb, db) in zip(a, b):
        assert ra.dtype == rb.dtype == np.uint8
        assert da.dtype == db.dtype == np.uint16
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(da, db)


def test_frame_source_does_not_fall_back_to_pil(lib, tmp_path):
    """A frame the loader cannot read raises, though PIL could read it
    (a 16-bit RGB image, which the loader's 8-bit RGB decoder refuses)."""
    folder = make_parallax_folder(tmp_path)
    entries = load_assoc(str(folder / "assoc.txt"))
    wide = np.zeros((4, 4, 3), np.uint16)
    Image.fromarray(wide[..., 0]).save(folder / entries[1].rgb_path)
    src = make_frame_source(str(folder), entries, 0, use_native=True)
    assert next(src)[0] == 0
    with pytest.raises(IOError):
        next(src)
