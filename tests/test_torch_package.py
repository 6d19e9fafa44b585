"""Guards on the port's package boundary and device rule."""

import ast
import inspect
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import cvo_rgbd_torch
from cvo_rgbd_torch.ops import _build, gram, moments, wsq

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "cvo_rgbd_torch"
FORBIDDEN = ("jax", "cvo_rgbd_tpu")


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py")
    )


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names += [a.value for a in node.args
                      if isinstance(a, ast.Constant)]
    return names


def test_sources_neither_import_nor_name_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    for path in sorted(PKG.rglob("*")):
        if path.suffix in (".py", ".cu", ".cuh"):
            assert "cvo_rgbd_tpu" not in path.read_text(), path
    # chip_smoke.py names the JAX package only as the file:line of the
    # TPU kernel each CUDA kernel replaces
    smoke = (ROOT / "chip_smoke.py").read_text()
    rest = re.sub(r'"cvo_rgbd_tpu/[\w/]+\.py:\d+"', "", smoke)
    assert "cvo_rgbd_tpu" not in rest


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_card_unless_told_cpu(no_cuda, tmp_path):
    from cvo_rgbd_torch.cli import main
    from cvo_rgbd_torch.frontend import make_frontend
    from cvo_rgbd_torch.odometry import run_odometry_frames

    pts = np.random.default_rng(0).standard_normal((100, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cvo_rgbd_torch.pad_cloud(pts)
    x = cvo_rgbd_torch.pad_cloud(pts, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cvo_rgbd_torch.align(cvo_rgbd_torch.CvoParams(), x, x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_frontend(1, 256)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_odometry_frames([], 1)
    (tmp_path / "assoc.txt").write_text("")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["run", str(tmp_path), "1"])


def test_wrappers_never_fall_back():
    """A CUDA tensor launches the kernel or raises: no try/except around
    a launch, and any device that is neither CPU nor CUDA is refused."""
    for fn in (gram.color_gram, gram.color_gram_cuda, moments.fused_moments,
               moments.fused_moments_cuda, wsq.fused_wsq, wsq.fused_wsq_cuda,
               _build.entry, _build.check):
        tree = ast.parse(inspect.getsource(fn).lstrip())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn
    meta = [torch.empty((128, k), device="meta") for k in (3, 5)]
    mask = torch.empty(128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gram.color_gram(meta[0], meta[1], mask, meta[0], meta[1], mask,
                        p=cvo_rgbd_torch.CvoParams())
