"""Stereo correspondence: row-banded Hamming match + SAD subpixel refine.

PyTorch port of `gmmloc_tpu/features/stereo.py` (ref
Frame::computeStereoMatches, frame.cpp:179-349): one dense masked (NL, NR)
pass over the Hamming matrix -- kernel K3 (`cuda_kernels.hamming_matrix`)
on the card -- then the 11-step SAD refinement as batched window gathers
with a parabola fit, then the median SAD outlier cut (:337-348).

`torch.argmin`, like `jnp.argmin`, returns the first minimum. The median
is `jnp.nanmedian`'s: over an even count it is the mean of the two middle
values (`torch.nanmedian` returns the lower one).
"""

from __future__ import annotations

import functools

import torch

from . import matching

TH_HIGH = matching.TH_HIGH
TH_LOW = matching.TH_LOW
BIG = 1 << 20


def match_stereo(uv_l, octave_l, desc_l, valid_l, uv_r, octave_r, desc_r, valid_r,
                 scale_factors, bf: float, min_z: float):
    """Descriptor stage (frame.cpp:193-277): best right index per left
    keypoint (-1 where it fails) and its descriptor distance."""
    max_d = bf / min_z
    band = 2.0 * scale_factors[octave_r]                 # |vL - vR| <= 2 sf (:196-206)
    row_ok = torch.abs(uv_l[:, None, 1] - uv_r[None, :, 1]) <= band[None, :]
    lvl_ok = (octave_r[None, :] >= octave_l[:, None] - 1) & (
        octave_r[None, :] <= octave_l[:, None] + 1)
    du = uv_l[:, None, 0] - uv_r[None, :, 0]             # disparity = uL - uR
    disp_ok = (du >= 0.0) & (du <= max_d)
    cand = row_ok & lvl_ok & disp_ok & valid_l[:, None] & valid_r[None, :]

    dist = matching.hamming_matrix(desc_l.contiguous(), desc_r.contiguous())
    dist = torch.where(cand, dist, BIG)
    best = torch.argmin(dist, dim=1)
    d0 = torch.gather(dist, 1, best[:, None])[:, 0]
    ok = d0 < (TH_HIGH + TH_LOW) // 2
    return torch.where(ok, best, -1), d0


def _atlas(pyr, offs, H, W0):
    a = pyr[0].new_zeros(H, W0)
    for l, im in enumerate(pyr):
        h, w = im.shape
        a[offs[l]:offs[l] + h, :w] = im
    return a


@functools.lru_cache(maxsize=None)
def _level_tables(offs, heights, widths, device):
    """The levels' row offsets, heights and widths in the atlas as int64
    tensors on `device`, made once per geometry and device: the per-frame
    pass copies nothing from the host (a copy from pageable memory waits
    for the stream, and a CUDA graph cannot hold one)."""
    return tuple(torch.tensor(v, device=device) for v in (offs, heights, widths))


def refine_subpixel(pyr_l, pyr_r, uv_l, octave_l, u_r0, matched, scale_factors,
                    bf: float, min_z: float):
    """SAD subpixel refinement (frame.cpp:279-335): 11x11 windows, +-5
    shift, centre-normalised L1, parabola interpolation. Each pyramid is
    stacked into one atlas so that a keypoint gathers from its own level
    by a row offset (clip bounds per level, as the per-level images).
    Returns (u_right, depth, good, sad)."""
    W, L = 5, 5
    dev = uv_l.device
    inv_sf = 1.0 / scale_factors
    su_l = uv_l[:, 0] * inv_sf[octave_l]
    sv_l = uv_l[:, 1] * inv_sf[octave_l]
    su_r = u_r0 * inv_sf[octave_l]
    iy = torch.round(sv_l).to(torch.int64)
    ixl = torch.round(su_l).to(torch.int64)
    ixr = torch.round(su_r).to(torch.int64)

    heights = tuple(im.shape[0] for im in pyr_l)
    widths = tuple(im.shape[1] for im in pyr_l)
    offs = [0]
    for h in heights[:-1]:
        offs.append(offs[-1] + h)
    H, W0 = offs[-1] + heights[-1], widths[0]
    al, ar = _atlas(pyr_l, offs, H, W0), _atlas(pyr_r, offs, H, W0)
    off_v, h_v, w_v = (t[octave_l] for t in _level_tables(tuple(offs), heights, widths, dev))
    y_lo = off_v[:, None, None]
    y_hi = (off_v + h_v - 1)[:, None, None]
    x_hi = (w_v - 1)[:, None, None]

    def win(img, cy, cx, rx_lo, rx_hi):
        dy = torch.arange(-W, W + 1, device=dev)
        dx = torch.arange(rx_lo, rx_hi + 1, device=dev)
        yy = torch.minimum(torch.maximum(cy[:, None, None] + dy[None, :, None], y_lo), y_hi)
        xx = torch.clamp(cx[:, None, None] + dx[None, None, :], min=0).minimum(x_hi)
        return img[yy, xx]

    wl = win(al, iy + off_v, ixl, -W, W)                      # (NL, 11, 11)
    wl = wl - wl[:, W:W + 1, W:W + 1]
    wr_wide = win(ar, iy + off_v, ixr, -W - L, W + L)         # (NL, 11, 11+2L)
    cols = []
    for k in range(2 * L + 1):
        wr = wr_wide[:, :, k:k + 2 * W + 1]
        wr = wr - wr[:, W:W + 1, W:W + 1]
        cols.append(torch.sum(torch.abs(wl - wr), dim=(1, 2)))
    dists = torch.stack(cols, dim=1)                          # (NL, 2L+1)

    best_k = torch.argmin(dists, dim=1)
    interior = (best_k > 0) & (best_k < 2 * L)
    km = torch.clamp(best_k - 1, 0, 2 * L)
    kp = torch.clamp(best_k + 1, 0, 2 * L)
    d1 = torch.gather(dists, 1, km[:, None])[:, 0]
    d2 = torch.gather(dists, 1, best_k[:, None])[:, 0]
    d3 = torch.gather(dists, 1, kp[:, None])[:, 0]
    denom = 2.0 * (d1 + d3 - 2.0 * d2)
    delta = torch.where(torch.abs(denom) > 1e-9, (d1 - d3) / denom, 2.0)
    good = matched & interior & (delta >= -1.0) & (delta <= 1.0)

    best_inc = best_k.to(torch.float32) - L
    u_right = scale_factors[octave_l] * (torch.round(su_r) + best_inc + delta)
    disparity = uv_l[:, 0] - u_right
    max_d = bf / min_z
    in_range = (disparity >= 0.0) & (disparity < max_d)
    disparity = torch.where(disparity <= 0.0, 0.01, disparity)
    u_right = torch.where(disparity <= 0.01, uv_l[:, 0] - 0.01, u_right)
    return u_right, bf / disparity, good & in_range, d2


def masked_median(x, mask):
    """`jnp.nanmedian(where(mask, x, nan))` without a host read: the
    masked values sorted, q = 0.5 (n - 1), and the linear interpolation
    low * (1 - w) + high * w of `jnp.quantile`; 0 where nothing is masked
    in (the JAX code replaces the NaN median by 0)."""
    v = torch.sort(torch.where(mask, x, torch.inf)).values
    n = mask.sum().to(x.dtype)
    q = 0.5 * (n - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    hw = q - lo
    top = torch.clamp(n - 1.0, min=0.0)
    # one gather of both: a 0-d index tensor would be read back to the host
    lo_v, hi_v = v[torch.stack([lo, hi]).clamp(min=0.0).minimum(top).to(torch.int64)]
    med = lo_v * (1.0 - hw) + hi_v * hw
    return torch.where(n > 0, med, torch.zeros_like(med))


def compute_stereo_matches(pyr_l, pyr_r, uv_l, octave_l, desc_l, valid_l,
                           uv_r, octave_r, desc_r, valid_r, scale_factors,
                           bf: float, baseline: float):
    """The stereo pipeline with the median SAD outlier cut (frame.cpp:
    337-348: keep sad <= 1.5 * 1.4 * median). Returns (u_right (NL,),
    depth (NL,)), -1 where unmatched. `scale_factors` is a tensor (the
    front end keeps it on the device)."""
    sf = scale_factors.to(uv_l.device, torch.float32)
    best, _ = match_stereo(uv_l, octave_l, desc_l, valid_l, uv_r, octave_r, desc_r,
                           valid_r, sf, bf=bf, min_z=baseline)
    matched = best >= 0
    u_r0 = torch.where(matched, uv_r[torch.clamp(best, min=0), 0], 0.0)
    u_right, depth, good, sad = refine_subpixel(
        pyr_l, pyr_r, uv_l, octave_l, u_r0, matched, sf, bf=bf, min_z=baseline)
    good = good & (sad <= 1.5 * 1.4 * masked_median(sad, good))
    return torch.where(good, u_right, -1.0), torch.where(good, depth, -1.0)
