"""Build the CUDA kernels of `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `_build/lib<name>.so`, a shared library
with a plain C interface.  A library is built on first use and rebuilt
when a source or header is newer than it.  Nothing here runs at import:
the CPU tests import every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
KERNELS = ("color_gram", "fused_moments", "fused_wsq", "align_fused",
           "fused_flow", "construct_probe")
# libraries built from another source with extra flags, only when an
# entry point asks for them: the timing tool's builds of the align kernel
# with its per-phase timers (cvo_rgbd_torch/time_fused.py --phases) and
# of the two-pass sweeps with per-block marks (--flow)
VARIANTS = {"align_fused_timed": ("align_fused", ("-DALIGN_PHASE_TIMERS",)),
            "fused_flow_timed": ("fused_flow", ("-DFLOW_PHASE_TIMERS",))}

# No --use_fast_math: it turns expf into __expf and flushes denormals,
# and the Gram needs the accurate exp (csrc/pair_tile.cuh); the kernels'
# exp_mode="fast" forms take __expf by a template flag, never a build flag.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each C entry point; pointers and the stream are c_void_p so
# ctypes never cuts a 64-bit address to an int
SIGNATURES = {
    "color_gram": ("color_gram_launch", [_P] * 6 + [_I] * 3 + [_P]),
    "fused_moments": (
        "fused_moments_launch", [_P] * 15 + [_I] * 5 + [_P]
    ),
    "fused_wsq": (
        "fused_wsq_launch", [_P, _I, _I, _P, _I, _P, _P, _I, _P, _P]
        + [_I] * 4 + [_P]
    ),
    "align_fused_tiled": (
        "align_fused_tiled_launch", [_P] * 27 + [_I] * 6 + [_P]
    ),
    "align_fused_resident": (
        "align_fused_resident_launch", [_P] * 27 + [_I] * 6 + [_P]
    ),
    "fused_flow": ("fused_flow_launch", [_P] * 12 + [_I] * 5 + [_P]),
    "fused_step_coeffs": ("fused_step_launch", [_P] * 13 + [_I] * 5 + [_P]),
    "construct_probe": ("construct_probe_launch", [_I] + [_P] * 5),
    "align_fused_tiled_timed": (
        "align_fused_tiled_launch", [_P] * 27 + [_I] * 6 + [_P]
    ),
    "align_fused_resident_timed": (
        "align_fused_resident_launch", [_P] * 27 + [_I] * 6 + [_P]
    ),
    "align_fused_phase_ns": ("align_fused_phase_ns", [_P, _I]),
    "fused_flow_timed": ("fused_flow_launch", [_P] * 12 + [_I] * 5 + [_P]),
    "fused_step_coeffs_timed": (
        "fused_step_launch", [_P] * 13 + [_I] * 5 + [_P]
    ),
    "fused_flow_marks": ("fused_flow_marks", [_P, _I]),
    "align_fused_item_ns": ("align_fused_item_ns", [_P, _I]),
}
# entry points that live in another source's library
LIBRARY = {
    "align_fused_tiled": "align_fused",
    "align_fused_resident": "align_fused",
    "fused_step_coeffs": "fused_flow",
    "align_fused_tiled_timed": "align_fused_timed",
    "align_fused_resident_timed": "align_fused_timed",
    "align_fused_phase_ns": "align_fused_timed",
    "align_fused_item_ns": "align_fused_timed",
    "fused_step_coeffs_timed": "fused_flow_timed",
    "fused_flow_marks": "fused_flow_timed",
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale(name: str) -> bool:
    lib = BUILD / f"lib{name}.so"
    if not lib.exists():
        return True
    src = VARIANTS.get(name, (name,))[0]
    deps = [CSRC / f"{src}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in deps)


def _start(name: str) -> tuple[subprocess.Popen, str]:
    """Start one nvcc into a temporary file beside the target, so a
    concurrent build never loads a half-written library."""
    BUILD.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    src, flags = VARIANTS.get(name, (name, ()))
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, str(CSRC / f"{src}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp


def build(names=KERNELS) -> None:
    """Build every stale library, one nvcc per source, all at once."""
    jobs = {n: _start(n) for n in names if _stale(n)}
    errors = []
    for name, (proc, tmp) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, BUILD / f"lib{name}.so")
    if errors:
        raise RuntimeError("\n".join(errors))


@functools.lru_cache(maxsize=None)
def entry(name: str):
    """The C launch function `name`, its library built and loaded once."""
    lib = LIBRARY.get(name, name)
    build((lib,))
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(ctypes.CDLL(str(BUILD / f"lib{lib}.so")), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
