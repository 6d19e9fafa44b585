"""The resident form of `csrc/align_fused.cu` on the CPU: its lane
scratch (the moment items' stored weights W and a ticket per row block),
the tile rule its row blocks count their kept tiles by, transcribed in
torch on kd-sorted clouds, and the plain version's resident align with
the tile skip on and off.  Card runs hold the kernel itself
(tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import cvo_rgbd_torch as ct
from cvo_rgbd_torch import se3, synth
from cvo_rgbd_torch.core.cloud import block_bounds, kd_sort
from cvo_rgbd_torch.frontend import make_frontend
from cvo_rgbd_torch.ops.moments import SKIP_MARGIN, TILE_I, TILE_J

# the module, which ops/__init__.py's function of the same name hides
af = importlib.import_module("cvo_rgbd_torch.ops.align_fused")
torch.set_num_threads(2)

# the card's L2 cache: phase 8's 63-lane batch keeps its weights there
L2_BYTES = 50e6


@pytest.mark.parametrize("n", [384, 512, 1024])
@pytest.mark.parametrize("adaptive", [False, True], ids=["cvo", "acvo"])
def test_resident_scratch_holds_the_weights_and_row_block_tickets(n,
                                                                  adaptive):
    """A resident lane holds W [n, m] and, after the j-blocks' tickets
    and acvo's, one ticket per row block; tiled mode holds no W."""
    nbj, rows = n // TILE_J, n // af.ROWS
    lane = af.lane_scratch(n, n, "resident", adaptive)
    assert lane["w"] == ((n, n), torch.float32)
    assert lane["ticket"] == ((nbj + 1 + rows,), torch.int32)
    assert lane["flow_part"] == ((rows, 8), torch.float32)
    assert list(lane)[-1] == "out"
    assert [k for k in af.SCRATCH_ARGS if k in lane] == list(lane)
    tiled = af.lane_scratch(n, n, "tiled", adaptive)
    assert "w" not in tiled and tiled["ticket"] == ((nbj + 1,), torch.int32)
    assert [k for k in af.SCRATCH_ARGS if k in tiled] == list(tiled)


def test_the_63_lane_resident_batch_keeps_its_weights_in_l2():
    """chip_smoke.py's phase 8 at 384: 63 lanes of W take 37 MB of the
    card's 50 MB L2; the largest resident lane (N*M = 2^20) 4 MB."""
    w_bytes = 4 * int(np.prod(af.lane_scratch(384, 384, "resident",
                                              False)["w"][0]))
    assert 63 * w_bytes < L2_BYTES
    assert 4 * int(np.prod(af.lane_scratch(1024, 1024, "resident",
                                           True)["w"][0])) == 4 << 20


def _render_pair(num_want, rgb):
    fe = make_frontend(1, num_want, rgb, device="cpu")
    frames = synth.render_frames(synth.revisit_path(2, period=33),
                                 synth.BandScene(h=96, w=128))
    return [kd_sort(fe(f[2], f[3])) for f in frames]


@pytest.fixture(scope="module")
def pairs():
    return {n: _render_pair(n, 1) for n in (384, 1024)}


def _moved_boxes(lo, hi, Rt, tT):
    """csrc/align_fused.cu:moved_box in torch: [nbj, 3] lo and hi of a
    box holding each j-block's transformed points (tf = [Rt, -tT]),
    widened by its slack; an empty block stays empty."""
    c, h = 0.5 * (lo + hi), 0.5 * (hi - lo)
    cc = c @ Rt.T - tT
    hh = h @ Rt.abs().T
    slack = 1e-4 + 1e-5 * (cc.abs() + hh + tT.abs())
    empty = ~(lo[:, :1] <= hi[:, :1])
    return (torch.where(empty, float("inf"), cc - hh - slack),
            torch.where(empty, float("-inf"), cc + hh + slack))


def _kept(x, y, Rt, tT, thres):
    """[n / TILE_I, m / TILE_J]: the tiles csrc/align_fused.cu's
    kept_bitmaps keeps, the gap between an i-tile's box and a j-block's
    moved box not above thres."""
    xlo, xhi = block_bounds(x.positions, x.mask, TILE_I)
    blo, bhi = _moved_boxes(*block_bounds(y.positions, y.mask, TILE_J), Rt,
                            tT)
    gap = torch.clamp_min(torch.maximum(blo[None] - xhi[:, None],
                                        xlo[:, None] - bhi[None]), 0.0)
    return ~((gap * gap).sum(-1) > thres)


@pytest.mark.parametrize("n", [384, 1024])
@pytest.mark.parametrize("ell", [0.15, 0.06])
@pytest.mark.parametrize("mode", ["se", "linear"])
def test_row_block_kept_tiles_hold_every_nonzero_weight(pairs, n, ell, mode):
    """On kd-sorted clouds moved by a small step: every tile with a
    nonzero weight is kept, so a row block's kept count is at least its
    tiles with a nonzero weight (never fewer), the row blocks' counts add
    up to the j-blocks', and zeroing the dropped tiles leaves A's bits."""
    p = ct.CvoParams() if mode == "se" else ct.MATLAB_PARAMS
    k = af.constants(p)
    x, y = pairs[n]
    R = se3.exp_so3(torch.tensor([0.004, -0.003, 0.002]))
    T = torch.tensor([0.003, -0.004, 0.002])
    Rt, t_inv, ty = af._transform(R, T, y.positions)
    ell_t = torch.tensor(ell)
    A, _ = af._gated(k, x.positions, x.features, x.mask, ty, y.features,
                     y.mask, ell_t, False)
    thres = float(torch.tensor(k[af.C_THRES_C]) * ell_t * ell_t) + SKIP_MARGIN
    kept = _kept(x, y, Rt, -t_inv, thres)
    nbi, nbj = n // TILE_I, n // TILE_J
    nonzero = (A != 0).reshape(nbi, TILE_I, nbj, TILE_J).any(3).any(1)
    assert nonzero.any()
    assert not (nonzero & ~kept).any()
    per_row = af.ROWS // TILE_I
    rows = kept.reshape(-1, per_row * nbj).sum(1)
    assert (rows >= nonzero.reshape(-1, per_row * nbj).sum(1)).all()
    assert int(rows.sum()) == int(kept.sum(0).sum())
    dense = kept.repeat_interleave(TILE_I, 0).repeat_interleave(TILE_J, 1)
    assert torch.equal(torch.where(dense, A, 0.0), A)
    if mode == "se" and ell == 0.06:
        assert not kept.all()  # the skip drops tiles on these clouds


@pytest.mark.parametrize("algo", ["cvo", "acvo", "linear"])
def test_resident_plain_skip_on_and_off_give_the_same_rows(pairs, algo):
    """align_fused_plain in resident mode after 1, 3 and 10 iterations:
    the tile skip on and off give the same bits, and on counts fewer
    pairs."""
    base = {"cvo": ct.CvoParams(), "acvo": ct.AcvoParams(),
            "linear": ct.MATLAB_PARAMS}[algo]
    x, y = pairs[384]
    if algo == "acvo":
        x, y = _render_pair(384, 0)
    for it in (1, 3, 10):
        rows, counts = [], []
        for skip in (True, False):
            p = dataclasses.replace(base, backend="fused", max_iter=it,
                                    eps=0.0, eps_2=0.0, tile_skip=skip)
            assert af.fused_mode(p, x, y) == "resident"
            counts.append({})
            rows.append(af.align_fused_plain(p, x, y, counts=counts[-1]))
        assert torch.equal(rows[0], rows[1]), it
        assert counts[0]["gated"] == counts[1]["gated"]
        assert counts[0]["pairs"] <= counts[1]["pairs"] == it * 384 * 384
