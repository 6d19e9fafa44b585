"""Semi-dense pixel selection — the JAX package's stateless DSO redesign.

Port of the JAX package's `frontend/selector.py` (reference:
PixelSelector2.cpp:71-433, pcd_generator.cpp:135-163):
- the per-32x32-block gradient-histogram threshold map, as DSO computes it;
- a 3-scale blocked argmax whose winners get priority tiers;
- a deterministic global top-k over (tier, gradient) scores in place of
  DSO's stateful potential recursion and random subsample;
- the gated, one-pixel-per-8x8-block refill standing in for the Canny
  top-up.

Ties break as in the reference: the blocked argmax and the top-k both
take the lowest index first.  `torch.topk` leaves the order among ties
undefined, so the top-k is a stable descending sort.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

HIST_BLOCK = 32          # PixelSelector2.cpp:79-80
HIST_CUT = 0.5           # setting_minGradHistCut (PixelSelector2.h:32)
HIST_ADD = 7.0           # setting_minGradHistAdd (PixelSelector2.h:33)
DOWNWEIGHT = 0.75        # setting_gradDownweightPerLevel (PixelSelector2.h:30)
NUM_BINS = 49            # sqrt-gradient clipped to 48 (PixelSelector2.cpp:96-98)


def _grid(h, w, device):
    ys = torch.arange(h, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, device=device)[None, :].expand(h, w)
    return ys, xs


def _block_threshold_map(abs_sq_grad):
    """Per-pixel smoothed threshold, DSO makeHists
    (PixelSelector2.cpp:71-136).  Returns [H,W] of squared thresholds."""
    h, w = abs_sq_grad.shape
    dev = abs_sq_grad.device
    h32, w32 = h // HIST_BLOCK, w // HIST_BLOCK
    hc, wc = h32 * HIST_BLOCK, w32 * HIST_BLOCK

    g = torch.sqrt(torch.clamp_min(abs_sq_grad[:hc, :wc], 0.0))
    g = torch.clamp_max(torch.floor(g), 48.0)

    # DSO skips pixels within 1 px of the full-image border
    ys, xs = _grid(hc, wc, dev)
    valid = (xs >= 1) & (xs <= w - 2) & (ys >= 1) & (ys <= h - 2)

    blocks = g.reshape(h32, HIST_BLOCK, w32, HIST_BLOCK)
    vblocks = valid.reshape(h32, HIST_BLOCK, w32, HIST_BLOCK)
    bins = torch.arange(NUM_BINS, dtype=g.dtype, device=dev)
    onehot = (blocks[..., None] == bins) & vblocks[..., None]
    hist = onehot.sum(dim=(1, 3))                  # [h32, w32, BINS]
    total = hist.sum(dim=-1)

    # computeHistQuantil (PixelSelector2.cpp:59-68): min i with
    # cumsum_i > floor(N*cut + 0.5); empty blocks get 90
    th0 = torch.floor(total * HIST_CUT + 0.5)
    exceeded = torch.cumsum(hist, dim=-1) > th0[..., None]
    idx = torch.argmax(exceeded.to(torch.uint8), dim=-1)
    quant = torch.where(exceeded.any(dim=-1), idx, 90)
    ths = quant.to(torch.float32) + HIST_ADD

    # 3x3 neighbor mean then square (PixelSelector2.cpp:107-131)
    pad = F.pad(ths, (1, 1, 1, 1))
    cnt = F.pad(torch.ones_like(ths), (1, 1, 1, 1))
    sm = 0
    n = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            sm = sm + pad[1 + dy:1 + dy + h32, 1 + dx:1 + dx + w32]
            n = n + cnt[1 + dy:1 + dy + h32, 1 + dx:1 + dx + w32]
    ths_sm = (sm / n) * (sm / n)

    # pixels beyond the 32-divisible crop get an infinite threshold
    full = torch.full((h, w), float("inf"), dtype=torch.float32, device=dev)
    full[:hc, :wc] = ths_sm.repeat_interleave(HIST_BLOCK, 0).repeat_interleave(
        HIST_BLOCK, 1
    )
    return full


def _blockwise_argmax(score, block):
    """[H,W] -> per-block (flat_idx, value) for block x block tiles (H, W
    padded to multiples of `block`); the first maximum wins."""
    h, w = score.shape
    hb, wb = h // block, w // block
    tiles = (
        score.reshape(hb, block, wb, block)
        .permute(0, 2, 1, 3)
        .reshape(hb, wb, block * block)
    )
    best = torch.argmax(tiles, dim=-1)
    val = torch.gather(tiles, -1, best[..., None])[..., 0]
    ys, xs = _grid(hb, wb, score.device)
    ys = ys * block + best // block
    xs = xs * block + best % block
    return ys * w + xs, val


def select_pixels(pyramid, num_want, pot=3):
    """Select ~num_want semi-dense pixels.  Returns (idx [num_want],
    valid [num_want]) into the flattened level-0 image."""
    asg0 = pyramid[0][3]
    asg1 = pyramid[1][3]
    asg2 = pyramid[2][3]
    h, w = asg0.shape
    dev = asg0.device

    ths = _block_threshold_map(asg0)

    # in-border test (PixelSelector2.cpp:364): 4 <= x < w-5, 4 <= y <= h-4
    ys, xs = _grid(h, w, dev)
    inb = (xs >= 4) & (xs < w - 5) & (ys >= 4) & (ys <= h - 4)

    # coarse gradient maps at level-0 coordinates, DSO's index mapping
    # (PixelSelector2.cpp:384, 396)
    ag1 = asg1[(ys // 2).clamp(0, asg1.shape[0] - 1),
               (xs // 2).clamp(0, asg1.shape[1] - 1)]
    ag2 = asg2[(ys // 4).clamp(0, asg2.shape[0] - 1),
               (xs // 4).clamp(0, asg2.shape[1] - 1)]

    neg = float("-inf")
    pass0 = inb & (asg0 > ths)
    pass1 = inb & (ag1 > ths * DOWNWEIGHT)
    pass2 = inb & (ag2 > ths * DOWNWEIGHT * DOWNWEIGHT)

    def pad_to(a, blk):
        hp = -(-h // blk) * blk
        wp = -(-w // blk) * blk
        return F.pad(a, (0, wp - w, 0, hp - h), value=neg)

    def squash(v):
        return v / (v + 1.0)

    def block_winners(src, blk):
        sp = pad_to(src, blk)
        wp = sp.shape[1]
        idx_p, val = _blockwise_argmax(sp, blk)
        yy, xx = idx_p // wp, idx_p % wp
        ok = torch.isfinite(val) & (yy < h) & (xx < w)
        # a losing slot scatters 0 onto pixel 0: a no-op, scores are >= 0
        flat = torch.where(ok, yy * w + xx, 0)
        return flat.reshape(-1), ok.reshape(-1), val.reshape(-1)

    score = torch.zeros(h * w, dtype=torch.float32, device=dev)
    # tier scores: level-0 winners highest, then level 1, level 2 (DSO
    # codes 1/2/4, PixelSelector2.cpp:408-428); within a tier the
    # squashed gradient val/(val+1) keeps gradient order
    tiers = [
        (torch.where(pass0, asg0, neg), pot, 3.0),
        (torch.where(pass1, ag1, neg), 2 * pot, 2.0),
        (torch.where(pass2, ag2, neg), 4 * pot, 1.0),
    ]
    for s, blk, base in tiers:
        flat, ok, val = block_winners(s, blk)
        contrib = torch.where(ok, base + squash(val), 0.0)
        score = score.scatter_reduce(0, flat, contrib, "amax")

    # refill tier in (0, 1): fires only when the tiers found fewer than
    # num_want/3 pixels, at most one pixel per 8x8 block
    # (pcd_generator.cpp:135-163)
    gate = (score >= 1.0).sum() < (num_want // 3)
    flat, ok, val = block_winners(torch.where(inb & (asg0 > 0), asg0, neg), 8)
    contrib = torch.where(ok & gate, squash(val), 0.0)
    refill = torch.zeros(h * w, dtype=torch.float32, device=dev).scatter_reduce(
        0, flat, contrib, "amax"
    )
    score = torch.maximum(score, refill)

    val, idx = torch.sort(score, descending=True, stable=True)
    return idx[:num_want], val[:num_want] > 0.0
