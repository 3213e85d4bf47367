"""Batched 3-D and 2-D Gaussian-component math.

PyTorch port of `gmmloc_tpu/gmm/gaussian.py` (ref gaussian.cpp,
gaussian.h:14-162, gmm_utils.h:30-52): components as struct-of-arrays,
every op batched over the component axis. The map loader decomposes on the
host in float64 (`mixture.from_arrays`); these are the same functions on
tensors.
"""

from __future__ import annotations

import math

import torch


def decompose(covs):
    """Batched eigendecomposition of 3x3 covariances (ref
    GaussianComponent::decompose, gaussian.cpp:36-63): ascending
    eigenvalues ("scale"), eigenvectors as columns ("axis"), the inverse,
    the determinant and the smallest-eigenvalue direction ("normal")."""
    evals, evecs = torch.linalg.eigh(covs)
    return {
        "scale": evals,
        "axis": evecs,
        "cov_inv": torch.linalg.inv(covs),
        "det": torch.linalg.det(covs),
        "normal": evecs[..., :, 0],
    }


def degenerate_flags(scale, eig_thresh=1e-4, salient_thresh=0.2):
    """(is_degenerated, is_salient) from ascending eigenvalues."""
    is_deg = scale[..., 0] < eig_thresh
    is_sal = (scale[..., 1] > salient_thresh) & (scale[..., 2] > salient_thresh)
    return is_deg, is_sal


def sqrt_info(cov_inv):
    """Lower Cholesky factor L of cov^-1 (ref gaussian.cpp:47-49); the
    whitened point-to-Gaussian residual is L^T (x - mean)."""
    return torch.linalg.cholesky(cov_inv)


def chi2(mean, cov_inv, x):
    """Squared Mahalanobis distance (ref gaussian.cpp:65-70); broadcasts
    mean/cov_inv (...,3)/(...,3,3) against x (...,3)."""
    d = x - mean
    return torch.einsum("...i,...ij,...j->...", d, cov_inv, d)


def pdf(mean, cov_inv, det, x):
    """Gaussian density (ref gaussian.cpp:72-77)."""
    dim = mean.shape[-1]
    norm = (2.0 * math.pi) ** (-0.5 * dim) / torch.sqrt(torch.clamp(det, min=1e-300))
    return norm * torch.exp(-0.5 * chi2(mean, cov_inv, x))


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


def bhattacharyya_3d(mean_a, cov_a, det_a, mean_b, cov_b, det_b):
    """Pairwise-broadcastable Bhattacharyya distance of 3-D components
    (ref BHCoefficient, gmm_utils.h:30-52)."""
    cov = 0.5 * (cov_a + cov_b)
    delta = mean_b - mean_a
    cov, delta = torch.broadcast_tensors(cov, delta[..., None])
    sol = torch.linalg.solve(cov, delta)[..., 0]
    d0 = torch.sum(delta[..., 0] * sol, -1) / 8.0
    det_c = torch.linalg.det(cov)
    d1 = 0.5 * torch.log(torch.clamp(det_c, min=1e-300)
                         / torch.sqrt(torch.clamp(det_a * det_b, min=1e-300)))
    return d0 + d1


def bhattacharyya_2d(mean_a, cov_a, mean_b, cov_b):
    """Bhattacharyya distance of 2-D (projected) components, with the
    closed-form 2x2 inverse."""
    cov = 0.5 * (cov_a + cov_b)
    inv, det_c = inv2x2(cov)
    delta = mean_b - mean_a
    d0 = mdist2_2d(torch.zeros_like(delta), inv, delta) / 8.0
    det_a2 = cov_a[..., 0, 0] * cov_a[..., 1, 1] - cov_a[..., 0, 1] * cov_a[..., 1, 0]
    det_b2 = cov_b[..., 0, 0] * cov_b[..., 1, 1] - cov_b[..., 0, 1] * cov_b[..., 1, 0]
    d1 = 0.5 * torch.log(torch.clamp(det_c, min=1e-30)
                         / torch.sqrt(torch.clamp(det_a2 * det_b2, min=1e-60)))
    return d0 + d1
