"""Fault injection for the odometry drivers' failure paths."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def nan_cloud(module, k, nan_like=None):
    """Within the block, the frontends that `module.make_frontend` makes
    return their k-th cloud with NaN positions and its mask as it was (the
    align loop alone would not flag it).  `nan_like(positions)` makes the
    NaN array; by default `torch.full_like(positions, nan)`."""
    if nan_like is None:
        import torch

        def nan_like(x):
            return torch.full_like(x, float("nan"))

    real = module.make_frontend

    def patched(*a, **kw):
        f = real(*a, **kw)
        count = [0]

        def wrap(rgb, dep):
            c = f(rgb, dep)
            if count[0] == k:
                c = c._replace(positions=nan_like(c.positions))
            count[0] += 1
            return c

        return wrap

    module.make_frontend = patched
    try:
        yield
    finally:
        module.make_frontend = real
