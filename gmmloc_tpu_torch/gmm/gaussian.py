"""Batched 2-D Gaussian-component math (projected components).

PyTorch port of the 2x2 closed forms of `gmmloc_tpu/gmm/gaussian.py` (ref
gaussian.cpp) that rendering uses; the 3-D decomposition runs on the host
in float64 at map load (`mixture.from_arrays`).
"""

from __future__ import annotations

import torch


def eig2x2(covs2d):
    """Closed-form eigendecomposition of symmetric 2x2 matrices: (evals
    ascending (...,2), theta of the smallest-eigenvalue eigenvector)."""
    a = covs2d[..., 0, 0]
    b = covs2d[..., 0, 1]
    c = covs2d[..., 1, 1]
    tr = a + c
    disc = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    lam0 = 0.5 * tr - disc
    lam1 = 0.5 * tr + disc
    big_b = torch.abs(b) > 1e-12
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    vx = torch.where(big_b, b, torch.where(a <= c, one, zero))
    vy = torch.where(big_b, lam0 - a, torch.where(a <= c, zero, one))
    return torch.stack([lam0, lam1], dim=-1), torch.atan2(vy, vx)


def inv2x2(covs2d):
    a = covs2d[..., 0, 0]
    b = covs2d[..., 0, 1]
    c = covs2d[..., 1, 0]
    d = covs2d[..., 1, 1]
    det = a * d - b * c
    det_safe = torch.where(torch.abs(det) < 1e-24, torch.full_like(det, 1e-24), det)
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], dim=-2)
    return inv / det_safe[..., None, None], det


def mdist2_2d(mean2d, cov2d_inv, x2d):
    d = x2d - mean2d
    return torch.einsum("...i,...ij,...j->...", d, cov2d_inv, d)
