"""Oriented BRIEF descriptors: IC-angle + steered binary tests.

PyTorch port of `gmmloc_tpu/features/orb.py` (ref ORBextractor
IC_Angle:77-101, computeOrbDescriptor:104-146): the atlas forms that
detection runs (`ic_angle_atlas`, `brief_descriptors_atlas`), and the
JAX module's per-level forms (`gather_patches`, `ic_angle`,
`brief_descriptors`), which no caller in either package uses. The
256 test pairs are the JAX package's procedural BRIEF G-II pattern (numpy
`default_rng` with the same seed, so the same pairs), not OpenCV's
bit_pattern_31.

Numerics against the JAX package:
  - `jnp.degrees(arctan2) % 360` is a floor-mod: `torch.remainder`;
  - `jnp.round` and `torch.round` both round half to even;
  - the atlas moment maps are float32 cumulative sums along the width of
    values up to ~1e8, so their summation order shows in the angles:
    `cumsum_blocked` sums in the order of XLA's CPU lowering and the
    moment updates are the fused multiply-adds of the compiled JAX code
    (`utils.numerics`), so the angles agree to an ulp; a rotated test
    point that still lands on a .5 can flip a bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.numerics import fma32

PATCH_R = 15          # IC-angle circular patch radius (HALF_PATCH_SIZE)
N_TESTS = 256
PATTERN_SEED = 20200829  # fixed: descriptors must be stable across runs


def _make_pattern():
    """256 (p1, p2) test pairs, clipped to the 31x31 patch (BRIEF G-II:
    p1 ~ N(0, sigma^2), p2 ~ N(p1, (sigma/2)^2), sigma = 31/5)."""
    rng = np.random.default_rng(PATTERN_SEED)
    sigma = 31 / 5.0
    p1 = rng.normal(0.0, sigma, size=(N_TESTS, 1, 2))
    p2 = p1 + rng.normal(0.0, sigma / 2.0, size=(N_TESTS, 1, 2))
    pts = np.concatenate([p1, p2], axis=1)
    return np.clip(pts, -PATCH_R, PATCH_R).astype(np.float32)


PATTERN = _make_pattern()

# circular u_max table for IC-angle (orb_extractor.cpp:408-441)
_UMAX = np.zeros(PATCH_R + 1, np.int32)
for _v in range(PATCH_R + 1):
    _UMAX[_v] = int(np.round(np.sqrt(PATCH_R**2 - _v**2)))


def _circle_mask():
    ys, xs = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1]
    return (np.abs(xs) <= _UMAX[np.abs(ys)]).astype(np.float32)


CIRCLE = _circle_mask()
_BIT_WEIGHTS = [1, 2, 4, 8, 16, 32, 64, 128]


@functools.lru_cache(maxsize=None)
def _tables(device):
    """PATTERN (float32) and the bit weights (uint8) on `device`, made
    once per device: the per-frame pass copies nothing from the host (a
    copy from pageable memory waits for the stream, and a CUDA graph
    cannot hold one)."""
    return (torch.from_numpy(PATTERN).to(device),
            torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=device))


def gather_patches(img, uv):
    """The 31x31 patches (N, 31, 31) around keypoints rounded to integer
    pixels, clamped a patch radius inside the image."""
    h, w = img.shape
    ys = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), PATCH_R, h - PATCH_R - 1)
    xs = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), PATCH_R, w - PATCH_R - 1)
    d = torch.arange(-PATCH_R, PATCH_R + 1, device=img.device)
    return img[ys[:, None, None] + d[None, :, None], xs[:, None, None] + d[None, None, :]]


def ic_angle(img, uv):
    """Intensity-centroid orientation in degrees of keypoints on one image
    (IC_Angle, :77-101), from their 31x31 patches."""
    patches = gather_patches(img, uv)
    mask = torch.from_numpy(CIRCLE).to(img.device)
    r = torch.arange(-PATCH_R, PATCH_R + 1, dtype=torch.float32, device=img.device)
    m01 = torch.sum(patches * mask * r[:, None], dim=(1, 2))
    m10 = torch.sum(patches * mask * r[None, :], dim=(1, 2))
    return _angle_deg(m01, m10)


def _seq_cumsum(x):
    """Cumulative sum along the last axis, one add per column in order."""
    cols = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., k])
    return torch.stack(cols, -1)


def cumsum_blocked(x, base: int = 16):
    """Float32 cumulative sum along the last axis in the order XLA's CPU
    compiler sums `jnp.cumsum`: sequential within blocks of `base`, the
    block totals scanned the same way recursively, then added back. Its
    values equal the JAX package's bit for bit (`torch.cumsum` sums in
    another order, which moves the IC-angle moments by up to a few ulps of
    a 1e8-sized prefix sum, enough to turn angles by ~0.02 deg and flip
    descriptor bits)."""
    n = x.shape[-1]
    if n <= base:
        return _seq_cumsum(x)
    nb = -(-n // base)
    blocks = F.pad(x, (0, nb * base - n)).reshape(*x.shape[:-1], nb, base)
    inner = _seq_cumsum(blocks)
    before = F.pad(cumsum_blocked(inner[..., -1], base)[..., :-1], (1, 0))
    return (inner + before[..., None]).reshape(*x.shape[:-1], nb * base)[..., :n]


def _angle_deg(m01, m10):
    return torch.remainder(torch.rad2deg(torch.atan2(m01, m10)), 360.0)


def ic_angle_atlas(atlas, uv, y_off, h_v, w_v):
    """IC-angle for keypoints of every pyramid level at once. `atlas`
    stacks the raw level images vertically; per keypoint, (y_off, h_v,
    w_v) give its level's row offset and size. Centres are clamped
    PATCH_R inside the level. The circular moments are computed for every
    pixel from windowed sums of two x-prefix-sum maps (half-width
    UMAX[|dy|] per row offset dy), then read at the keypoint centres;
    selected keypoints sit >= 16 px inside their band, so no window
    crosses a band boundary."""
    dev = atlas.device
    ys = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), PATCH_R) \
        .minimum(h_v.to(torch.int64) - PATCH_R - 1) + y_off.to(torch.int64)
    xs = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), PATCH_R) \
        .minimum(w_v.to(torch.int64) - PATCH_R - 1)
    H, W = atlas.shape
    pad = PATCH_R + 1
    x_coord = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    C = cumsum_blocked(atlas)
    C2 = cumsum_blocked(atlas * x_coord)
    # leading zero column (the C[x-1] lookup), then the window padding
    Cp = F.pad(C, (1 + pad + 1, pad))
    C2p = F.pad(C2, (1 + pad + 1, pad))

    neg_x = (-x_coord).expand(H, W)
    m01 = torch.zeros(H, W, dtype=torch.float32, device=dev)
    m10 = torch.zeros(H, W, dtype=torch.float32, device=dev)
    base = pad + 1
    for dy in range(-PATCH_R, PATCH_R + 1):
        u = int(_UMAX[abs(dy)])
        # row y+dy with zero rows beyond the atlas (read only by
        # un-selectable border centres)
        if dy < 0:
            Crow = F.pad(Cp, (0, 0, -dy, 0))[:H]
            C2row = F.pad(C2p, (0, 0, -dy, 0))[:H]
        elif dy > 0:
            Crow = F.pad(Cp, (0, 0, 0, dy))[dy:]
            C2row = F.pad(C2p, (0, 0, 0, dy))[dy:]
        else:
            Crow, C2row = Cp, C2p
        hi, lo = base + u, base - u - 1
        win_c = Crow[:, hi:hi + W] - Crow[:, lo:lo + W]
        win_c2 = C2row[:, hi:hi + W] - C2row[:, lo:lo + W]
        # the compiled JAX form: m01 += dy * win_c and win_c2 - x * win_c
        # are each one fused multiply-add
        m01 = fma32(float(dy), win_c, m01)
        m10 = m10 + fma32(neg_x, win_c, win_c2)
    return _angle_deg(m01[ys, xs], m10[ys, xs])


def _steered_points(uv, angle_deg):
    """Test points rotated by the keypoint angle, (N,256,2) x and y:
    x' = x cos - y sin, y' = x sin + y cos, plus the centre."""
    a = torch.deg2rad(angle_deg)
    ca, sa = torch.cos(a)[:, None, None], torch.sin(a)[:, None, None]
    pat = _tables(uv.device)[0]
    px = pat[None, :, :, 0] * ca - pat[None, :, :, 1] * sa
    py = pat[None, :, :, 0] * sa + pat[None, :, :, 1] * ca
    return (torch.round(uv[:, None, None, 0] + px).to(torch.int64),
            torch.round(uv[:, None, None, 1] + py).to(torch.int64))


def _pack_bits(vals):
    """(N,256,2) sampled pairs -> (N,32) uint8 (bit b of byte k is test
    8k+b, little-endian)."""
    bits = (vals[:, :, 0] < vals[:, :, 1]).to(torch.uint8).reshape(-1, 32, 8)
    w = _tables(vals.device)[1]
    return torch.sum(bits * w, dim=-1).to(torch.uint8)


def brief_descriptors(img_blur, uv, angle_deg):
    """Steered BRIEF-256 -> (N, 32) uint8 on one blurred image, test points
    read with nearest sampling (computeOrbDescriptor:104-146)."""
    h, w = img_blur.shape
    xs, ys = _steered_points(uv, angle_deg)
    return _pack_bits(img_blur[torch.clamp(ys, 0, h - 1), torch.clamp(xs, 0, w - 1)])


def brief_descriptors_atlas(atlas_blur, uv, angle_deg, y_off, h_v, w_v):
    """Steered BRIEF-256 for keypoints of every level in one gather from
    the atlas of per-level blurred images; test points clip to
    [0, h-1] x [0, w-1] of the keypoint's own level."""
    xs, ys = _steered_points(uv, angle_deg)
    xs = torch.clamp(xs, min=0).minimum(w_v.to(torch.int64)[:, None, None] - 1)
    ys = torch.clamp(ys, min=0).minimum(h_v.to(torch.int64)[:, None, None] - 1)
    ys = ys + y_off.to(torch.int64)[:, None, None]
    return _pack_bits(atlas_blur[ys, xs])
