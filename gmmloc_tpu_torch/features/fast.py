"""FAST-16 corner scoring + per-cell keypoint distribution.

PyTorch port of `gmmloc_tpu/features/fast.py` (ref per-cell FAST +
DistributeOctTree, orb_extractor.cpp:529-988): the segment test as 16
shifted full-image maps with a circular arc minimum, per-cell winners
(3x3 NMS first) and a per-level top-quota selection with the 20 -> 7
threshold fallback expressed as a sort priority.

`nms3x3(fast_score(img))` is the plain version of kernel K4
(`fast_kernels.fast_score_nms`, `csrc/fast_nms.cu`): every step is a
float32 subtract, min, max, compare or the one `+ 1e-6`, so the kernel
equals it bit for bit.

Ties: `jax.lax.top_k` returns the lowest index first among equal values;
`torch.topk` promises no order among ties, so selection sorts stably
(descending) and takes the first k.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# FAST-16 ring offsets (row, col), radius 3 -- standard Bresenham circle
RING = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ]
)

FAST_TH_HIGH = 20.0
FAST_TH_LOW = 7.0
ARC_LEN = 9


def _shift2d(img, dy, dx):
    """out[y, x] = img[(y + dy) % H, (x + dx) % W] (jnp.roll(img, (-dy, -dx)))."""
    return torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(0, 1))


def _window_max_min9(v):
    """max over the 16 circular 9-arcs of the arc minimum: doubling to 8
    (2, 4, 8) then one more element. min/max are exact, so this equals
    the arc-by-arc form of the JAX package bit for bit."""
    m1 = [torch.minimum(v[s], v[(s + 1) % 16]) for s in range(16)]
    m2 = [torch.minimum(m1[s], m1[(s + 2) % 16]) for s in range(16)]
    m4 = [torch.minimum(m2[s], m2[(s + 4) % 16]) for s in range(16)]
    out = torch.minimum(m4[0], v[8])
    for s in range(1, 16):
        out = torch.maximum(out, torch.minimum(m4[s], v[(s + 8) % 16]))
    return out


def _window_best9_halves(v, bright: bool):
    """The arc pass as kernel K4 runs it (`csrc/fast_nms.cu::arc_best9`):
    with `bright`, max over the 16 circular 9-arcs of the arc minimum
    (= `_window_max_min9`); else min over the arcs of the arc maximum,
    whose negation equals `_window_max_min9([-x for x in v])` bit for bit
    (negation is exact and min(-a, -b) = -max(a, b)). The arc from t
    (t = 0..7) is the suffix v[t..7] of the first half and the prefix
    v[8..8+t] of the second; the arc from 8 + t is the suffix v[8+t..15]
    and the prefix v[0..t]: 57 min/max against 79 for doubling windows."""
    inner, outer = (torch.minimum, torch.maximum) if bright else (torch.maximum, torch.minimum)
    pa, pb = [v[0]], [v[8]]
    for t in range(1, 8):
        pa.append(inner(pa[-1], v[t]))
        pb.append(inner(pb[-1], v[8 + t]))
    sa, sb = [None] * 8, [None] * 8
    sa[7], sb[7] = v[7], v[15]
    for t in range(6, 0, -1):
        sa[t] = inner(sa[t + 1], v[t])
        sb[t] = inner(sb[t + 1], v[8 + t])
    sa[0], sb[0] = pa[7], pb[7]
    best = None
    for t in range(8):
        for arc in (inner(sa[t], pb[t]), inner(sb[t], pa[t])):
            best = arc if best is None else outer(best, arc)
    return best


def _ring_diffs(img):
    return [_shift2d(img, dy, dx) - img for dy, dx in RING]


def _inside_border(img):
    h, w = img.shape
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    return (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)


def fast_score(img):
    """Continuous FAST corner score per pixel: the max over (bright,
    dark) of the best 9-contiguous-arc strength, 0 where no arc clears
    FAST_TH_LOW; the 3 px border is zero. (An arc clears the threshold
    iff its minimum does, so thresholding the best arc minimum equals the
    JAX package's per-arc mask.)"""
    d = _ring_diffs(img)
    mb = _window_max_min9(d)
    md = _window_max_min9([-x for x in d])
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    score = torch.maximum(torch.where(mb > FAST_TH_LOW, mb, zero),
                          torch.where(md > FAST_TH_LOW, md, zero))
    return torch.where(_inside_border(img), score, zero)


def arc_bounds(d, pairs=range(8)):
    """(U, L) of the 16 ring differences: U = min_k max(d_k, d_{k+8}) and
    L = max_k min(d_k, d_{k+8}) over the antipodal pairs k of `pairs` (all
    8 by default). Every 9-arc holds one index of each pair, so the bright
    arc strength is <= U and the dark one <= -L, over any subset of the
    pairs: kernel K4's exact reject."""
    u = l = None
    for k in pairs:
        hi, lo = torch.maximum(d[k], d[k + 8]), torch.minimum(d[k], d[k + 8])
        u = hi if u is None else torch.minimum(u, hi)
        l = lo if l is None else torch.maximum(l, lo)
    return u, l


def fast_score_rejecting(img):
    """`fast_score` in the arithmetic of kernel K4 (`csrc/fast_nms.cu`):
    the arc passes only where the pair bounds allow a score, over prefix
    and suffix extrema of the ring's halves, the dark term from the same
    differences. Returns (score, bright survivors,
    dark survivors); the score equals `fast_score(img)` bit for bit. The
    tests and the kernel's bound use it; no path of the port does."""
    d = _ring_diffs(img)
    u, l = arc_bounds(d)
    inside = _inside_border(img)
    bright = inside & (u > FAST_TH_LOW)
    dark = inside & (l < -FAST_TH_LOW)
    mb = _window_best9_halves(d, bright=True)
    md = -_window_best9_halves(d, bright=False)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    score = torch.maximum(torch.where(bright & (mb > FAST_TH_LOW), mb, zero),
                          torch.where(dark & (md > FAST_TH_LOW), md, zero))
    return score, bright, dark


def nms3x3(score):
    """3x3 non-max suppression (keep strict maxima: score >= the 8
    neighbours' max + 1e-6)."""
    neigh = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = _shift2d(score, dy, dx)
            neigh = n if neigh is None else torch.maximum(neigh, n)
    return torch.where(score >= neigh + 1e-6, score, torch.zeros_like(score))


def _edge_masked(score, edge: int):
    h, w = score.shape
    ys = torch.arange(h, device=score.device)[:, None]
    xs = torch.arange(w, device=score.device)[None, :]
    ok = (ys >= edge) & (ys < h - edge) & (xs >= edge) & (xs < w - edge)
    return torch.where(ok, score, torch.zeros_like(score))


def _cell_winners(s, cell: int):
    """Per-cell max and its pixel (first maximum in row-major cell
    order): (win_val (C,), cx (C,), cy (C,)) int64 coordinates."""
    h, w = s.shape
    hc, wc = -(-h // cell), -(-w // cell)
    sp = F.pad(s, (0, wc * cell - w, 0, hc * cell - h))
    cells = sp.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3).reshape(hc * wc, cell * cell)
    win_val = cells.amax(dim=1)
    win_arg = torch.argmax(cells, dim=1)
    ci = torch.arange(hc * wc, device=s.device)
    cy = win_arg // cell + (ci // wc) * cell
    cx = win_arg % cell + (ci % wc) * cell
    return win_val, cx, cy


def _top(prio, k: int):
    """Indices and values of the k largest, lowest index first among ties
    (jax.lax.top_k)."""
    vals, idx = torch.sort(prio, descending=True, stable=True)
    return vals[:k], idx[:k]


def _pad_quota(uv, resp, valid, quota: int):
    n = uv.shape[0]
    if n < quota:
        uv = F.pad(uv, (0, 0, 0, quota - n))
        resp = F.pad(resp, (0, quota - n))
        valid = F.pad(valid, (0, quota - n))
    return uv, resp, valid


def select_keypoints_octree(score, cells=(96, 48, 24), quota: int = 256, edge: int = 16):
    """Coarse-to-fine multi-scale cell selection (a static-shape emulation
    of DistributeOctTree, orb_extractor.cpp:529-737): per-cell winners at
    each cell size; priority (coarsest winning scale, then the 20 -> 7
    fallback, then response); a pixel winning at several scales keeps its
    coarsest entry."""
    h, w = score.shape
    s = _edge_masked(score, edge)
    n_scales = len(cells)
    cand_xy, cand_val, cand_rank = [], [], []
    for rank, cell in enumerate(cells):
        win_val, cx, cy = _cell_winners(s, cell)
        cand_xy.append(torch.stack([cx, cy], -1))
        cand_val.append(win_val)
        cand_rank.append(torch.full_like(cx, rank))
    xy = torch.cat(cand_xy)
    val = torch.cat(cand_val)
    rank = torch.cat(cand_rank)

    key = xy[:, 1] * w + xy[:, 0]
    n = key.shape[0]
    order = torch.arange(n, device=score.device)
    first = torch.full((h * w,), n, dtype=torch.int64, device=score.device)
    first = first.scatter_reduce(0, key, torch.where(val > 0, order, n), "amin")
    is_first = (first[key] == order) & (val > 0)

    rankw = 1e8
    prio = (n_scales - 1 - rank).to(torch.float32) * rankw
    prio = prio + torch.where(val >= FAST_TH_HIGH, 1e6, 0.0) + val
    prio = torch.where(is_first, prio, -1.0)
    k = min(quota, n)
    top_p, top_i = _top(prio, k)
    uv = xy[top_i].to(torch.float32)
    return _pad_quota(uv, val[top_i], top_p > 0.0, quota)


def select_keypoints(score, cell: int = 32, quota: int = 256, edge: int = 16):
    """Per-cell winners + top-quota selection. Returns (uv (quota,2)
    float32, resp (quota,), valid (quota,)). Cells whose winner clears
    FAST_TH_HIGH outrank low-threshold winners (the reference's 20 -> 7
    fallback, orb_extractor.cpp:780-788); `edge` excludes the
    orientation/descriptor patch border."""
    s = _edge_masked(score, edge)
    win_val, cx, cy = _cell_winners(s, cell)
    prio = torch.where(win_val >= FAST_TH_HIGH, win_val + 1e6, win_val)
    prio = torch.where(win_val > 0.0, prio, -1.0)
    top_p, top_i = _top(prio, min(quota, win_val.shape[0]))
    uv = torch.stack([cx[top_i], cy[top_i]], -1).to(torch.float32)
    return _pad_quota(uv, win_val[top_i], top_p > 0.0, quota)
