"""Frozen hyperparameter sets for CVO and Adaptive CVO.

Every field and default of the JAX package's `params.py`, so its kwargs
build these.  Defaults reproduce the reference constants:
- CvoParams     <- cvo.cpp:25-41
- AcvoParams    <- adaptive_cvo.cpp:25-43

Backends are named for what runs on the card:
- "kernel" (port of "pallas"): the hand-written CUDA kernels of
  `cvo_rgbd_torch.ops`, one moment sweep per iteration.  The default.
- "dense" (port of "xla"): the dense masked Gram in plain torch, no
  kd-sort; the only backend of `yy_quirk`.
- "fused" (port of "fused"): the whole align loop in one launch of
  `csrc/align_fused.cu`, resident or tiled by problem size; problems it
  cannot run go to "dense" or "kernel" as in the JAX package.  It
  recomputes the color kernel in the kernel, so `ck_cache` and
  `self_mode` do not apply to it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CvoParams:
    """Fixed-schedule CVO (cvo.cpp:25-41)."""

    ell_init: float = 0.15      # kernel length-scale (cvo.cpp:25)
    sigma: float = 0.1          # kernel signal std (cvo.cpp:26)
    sp_thres: float = 8e-3      # sparsification threshold (cvo.cpp:27)
    c: float = 7.0              # so(3) inner-product scale (cvo.cpp:28)
    d: float = 7.0              # R^3 inner-product scale (cvo.cpp:29)
    color_scale: float = 1e-5   # linear color-kernel scale (cvo.cpp:30)
    c_ell: float = 200.0        # color kernel length-scale (cvo.cpp:31)
    c_sigma: float = 1.0        # color kernel signal std (cvo.cpp:32)
    max_iter: int = 2000        # (cvo.cpp:38)
    min_step: float = 0.2       # (cvo.cpp:39)
    max_step: float = 0.8       # step clamp (cvo.cpp:307)
    eps: float = 5e-5           # flow-norm stop (cvo.cpp:40)
    eps_2: float = 1e-5         # se3-distance stop (cvo.cpp:41)
    # ell schedule: k>2 -> 0.10, k>9 -> 0.06, k>19 -> 0.03 (cvo.cpp:408-410)
    ell_sched: tuple = ((2, 0.10), (9, 0.06), (19, 0.03))
    # "se": squared-exponential on 5-dim features (cvo.cpp:143-153);
    # "linear": MATLAB's linear color inner product CI = color_scale *
    # Cx Cz^T, once per pair (rkhs_se3_registration.m:40-53, 125-127)
    color_mode: str = "se"
    backend: str = "kernel"
    # kernel backend: cache the loop-invariant color kernel as an [N,M]
    # f32 tensor per pair; False recomputes it inside the moment kernel
    ck_cache: bool = True
    # "factored": the line search (and, on the kernel backend, the flow)
    # from moments of the Gram; "direct": per-pair fields (cvo.cpp:164-289)
    # -- on the kernel backend the two sweeps fused_flow, fused_step_coeffs
    step_mode: str = "factored"
    # "precise": the accurate exp_neg of core/numerics.py, required for
    # the C++ stops; "fast": the hardware exp (__expf in the kernels,
    # torch.exp in the plain versions), which converges at the MATLAB
    # stops 5e-4/1e-4 only
    exp_mode: str = "precise"
    # kernel backend: exact AABB tile skip (cvo.cpp:119-125 kd-tree
    # radius pruning at tile granularity)
    tile_skip: bool = True

    @property
    def c_sp_thres(self) -> float:
        # cvo uses sp_thres for the color gate too (cvo.cpp:103)
        return self.sp_thres


@dataclasses.dataclass(frozen=True)
class AcvoParams:
    """Adaptive CVO (adaptive_cvo.cpp:25-43): the length-scale follows
    the gradient dl of the objective instead of a schedule."""

    ell_init: float = 0.1       # (adaptive_cvo.cpp:25)
    ell_min: float = 0.0391     # (adaptive_cvo.cpp:27)
    ell_max_init: float = 0.15  # reset per pair (adaptive_cvo.cpp:28, 477)
    dl_step: float = 0.3        # (adaptive_cvo.cpp:30)
    sigma: float = 0.1          # (adaptive_cvo.cpp:33)
    sp_thres: float = 8.315e-3  # (adaptive_cvo.cpp:34)
    c: float = 7.0              # (adaptive_cvo.cpp:35)
    d: float = 7.0              # (adaptive_cvo.cpp:36)
    c_ell: float = 0.5          # HSV-scale color length (adaptive_cvo.cpp:37)
    c_sigma: float = 1.0        # (adaptive_cvo.cpp:38)
    c_sp_thres: float = 8.315e-3  # separate color gate (adaptive_cvo.cpp:39)
    max_iter: int = 2000        # (adaptive_cvo.cpp:40)
    min_step: float = 0.2       # (adaptive_cvo.cpp:41)
    max_step: float = 0.8       # (adaptive_cvo.cpp:369)
    eps: float = 5e-5           # (adaptive_cvo.cpp:42)
    eps_2: float = 1e-5         # (adaptive_cvo.cpp:43)
    ell_shrink: float = 0.7     # ceiling shrink factor (adaptive_cvo.cpp:542-543)
    # "linear" (MATLAB's CI, scaled by ACVO_COLOR_SCALE): dense backend
    # only (the fused one routes it there, the kernel one refuses it)
    color_mode: str = "se"
    # reference quirk (adaptive_cvo.cpp:190, 256): Ayy rows i < num_fixed
    # read a zero buffer; dense backend only
    yy_quirk: bool = False
    backend: str = "kernel"
    ck_cache: bool = True
    step_mode: str = "factored"
    exp_mode: str = "precise"
    tile_skip: bool = True
    # "exact" sweeps both self-kernels every iteration; "cheb"
    # interpolates per-align Chebyshev tables of the four reductions
    self_mode: str = "exact"
    self_cheb_k: int = 12


# linear color mode's CI scale in acvo.  The JAX package's AcvoParams has
# no color_scale field, so its linear acvo stops on the missing field
# (ROADMAP queue 3); the port takes cvo's reference value (cvo.cpp:30).
ACVO_COLOR_SCALE = 1e-5


def fast_exp(p) -> bool:
    """True when the Gram takes the hardware exp (exp_mode="fast")."""
    return p.exp_mode == "fast"


def color_scale(p) -> float:
    """The linear color-kernel scale of a CvoParams or AcvoParams."""
    return ACVO_COLOR_SCALE if isinstance(p, AcvoParams) else p.color_scale


# MATLAB prototype parameter set (rkhs_se3_registration.m:7-36).
MATLAB_PARAMS = CvoParams(
    sp_thres=1e-3,
    eps=5e-4,
    eps_2=1e-4,
    color_mode="linear",
)
