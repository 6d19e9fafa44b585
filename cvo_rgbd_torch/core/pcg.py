"""Fixed-iteration preconditioned conjugate gradients.

Port of the JAX package's `core/pcg.py`, the solver of the sparse
pose-graph step (`core/posegraph.py`).  The iteration count is fixed and
a converged state freezes in place (`torch.where` on a done flag), so
the loop never reads a value back to the host.
"""

from __future__ import annotations

import torch


def pcg(matvec, precond, b, iters, rtol2=1e-12):
    """Solve A x = b with preconditioned CG; returns x.

    `matvec`/`precond` map tensors shaped like `b` (in practice [N,6]
    float32) to the same shape.  Stops updating once the squared
    relative residual drops below `rtol2`."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    rz = torch.sum(r * z)
    p = z
    b2 = torch.clamp_min(torch.sum(b * b), 1e-30)
    for _ in range(iters):
        done = torch.sum(r * r) / b2 < rtol2
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), 1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        rz_new = torch.sum(r_new * z_new)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        p_new = z_new + beta * p
        x, r, p, rz = (torch.where(done, old, new) for old, new in
                       zip((x, r, p, rz), (x_new, r_new, p_new, rz_new)))
    return x
