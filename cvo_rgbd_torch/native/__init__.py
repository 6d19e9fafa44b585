"""The native threaded PNG prefetch loader (C++).

Port of the JAX package's `native/__init__.py`.  `pngio.cpp` and
`loader.cpp` are this package's own copies of that package's sources;
g++ builds them, with zlib, into `cvo_rgbd_torch/_build/libnative.so` at
first use (never next to the sources) and again whenever a source is
newer than the library.  Nothing is built at import.

Unlike the JAX package, nothing falls back: when the library cannot be
built, `get_lib` raises with the compiler's output, and
`odometry.make_frame_source(use_native=True)` raises with it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD = _DIR.parent / "_build"
LIB = BUILD / "libnative.so"
SOURCES = (_DIR / "pngio.cpp", _DIR / "loader.cpp")
_lock = threading.Lock()
_lib = None


def _stale() -> bool:
    return not LIB.exists() or any(
        s.stat().st_mtime > LIB.stat().st_mtime for s in SOURCES)


def _build() -> None:
    """g++ into a temporary file beside the target, then a rename, so a
    concurrent build never loads a half-written library."""
    BUILD.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
           *map(str, SOURCES), "-lz", "-pthread", "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run g++ for the native loader: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            "g++ failed to build the native loader "
            f"({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, LIB)


def get_lib():
    """The native library, built first if it is missing or stale.
    Raises RuntimeError (with the compiler's stderr) when it cannot be
    built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _build()
        lib = ctypes.CDLL(str(LIB))
        i_p = ctypes.POINTER(ctypes.c_int)
        lib.png_probe.restype = ctypes.c_int
        lib.png_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  i_p, i_p, i_p, i_p]
        lib.png_decode.restype = ctypes.c_int
        lib.png_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_void_p]
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ] + [ctypes.c_int] * 7
        lib.loader_next.restype = ctypes.c_int
        lib.loader_next.argtypes = [ctypes.c_void_p] * 3
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _probe(lib, data, path):
    w, h, ch, depth = (ctypes.c_int() for _ in range(4))
    rc = lib.png_probe(data, len(data), ctypes.byref(w), ctypes.byref(h),
                       ctypes.byref(ch), ctypes.byref(depth))
    if rc != 0:
        raise ValueError(f"png_probe({path}) failed: {rc}")
    return w.value, h.value, ch.value, depth.value


def png_shape(path):
    """(height, width) of a PNG file, from its header."""
    with open(path, "rb") as fh:
        data = fh.read()
    w, h, _, _ = _probe(get_lib(), data, path)
    return h, w


def decode_png(path):
    """Decode a PNG with the native decoder -> ndarray (u8 [H,W,C] or
    u16 [H,W]).  Raises on failure."""
    lib = get_lib()
    with open(path, "rb") as fh:
        data = fh.read()
    w, h, ch, depth = _probe(lib, data, path)
    shape = (h, w, ch) if ch > 1 else (h, w)
    out = np.empty(shape, np.uint8 if depth == 8 else np.uint16)
    rc = lib.png_decode(data, len(data), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"png_decode({path}) failed: {rc}")
    return out


class PrefetchLoader:
    """Iterate decoded (index, rgb [H,W,3] u8, depth [H,W] u16) frame
    pairs, decoded ahead of time by native worker threads."""

    def __init__(self, rgb_paths, depth_paths, width, height,
                 depth_width=None, depth_height=None, workers=2, ahead=8):
        lib = get_lib()
        if len(rgb_paths) != len(depth_paths):
            raise ValueError("path list length mismatch")
        self._lib = lib
        self._n = len(rgb_paths)
        self._w, self._h = width, height
        self._dw = depth_width or width
        self._dh = depth_height or height
        # the path arrays stay referenced while the workers read them
        self._rgb_arr = (ctypes.c_char_p * self._n)(
            *[os.fsencode(p) for p in rgb_paths])
        self._dep_arr = (ctypes.c_char_p * self._n)(
            *[os.fsencode(p) for p in depth_paths])
        self._handle = lib.loader_create(
            self._rgb_arr, self._dep_arr, self._n,
            width, height, self._dw, self._dh, workers, ahead,
        )
        if not self._handle:
            raise RuntimeError("loader_create failed")

    def __len__(self):
        return self._n

    def next(self):
        """Returns (index, rgb, depth); raises StopIteration at the end
        and IOError for a file that is missing, unreadable or of another
        size."""
        if not self._handle:
            raise StopIteration
        rgb = np.empty((self._h, self._w, 3), np.uint8)
        dep = np.empty((self._dh, self._dw), np.uint16)
        rc = self._lib.loader_next(
            self._handle,
            rgb.ctypes.data_as(ctypes.c_void_p),
            dep.ctypes.data_as(ctypes.c_void_p),
        )
        if rc == -1:
            raise StopIteration
        if rc < 0:
            raise IOError(f"native loader error {rc}")
        return rc, rgb, dep

    __next__ = next

    def __iter__(self):
        return self

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
