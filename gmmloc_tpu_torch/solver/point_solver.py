"""Batched tiny point-only Gauss-Newton solves (3x3 normal equations).

PyTorch port of `gmmloc_tpu/solver/point_solver.py`:

  1. GMMLoc::optimizePoint (gmmloc_opt.cpp:260-352): one point, one
     stereo reprojection edge + one point-to-plane edge with information
     tri_lambda2 * z^2, 5 GN iterations, chi2 gates -- one batch over
     (points x candidate components).
  2. Localization::optimizeTriangulationVec (localization_opt.cpp:27-204):
     one point, two reprojection edges + a point-to-plane edge per
     candidate degenerate component, 20 GN iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import factors


def _solve3(H, b, damping=1e-8):
    from .local_ba import _inv3

    H = H + torch.eye(3, dtype=H.dtype, device=H.device) * damping
    Hinv, _ = _inv3(H)
    return torch.einsum("...ij,...j->...i", Hinv, b)


class PointOptResult(NamedTuple):
    x: torch.Tensor          # (...,3)
    chi2_proj: torch.Tensor  # (...)
    chi2_str: torch.Tensor   # (...)
    ok: torch.Tensor         # (...) bool, passed both gates


def optimize_point_stereo(cam, x0, q_cw, t_cw, obs_uvr, sigma2_inv,
                          plane_normal, plane_mean, str_info,
                          chi2_proj_thresh: float = 7.815,
                          str_chi2_thresh: float = float("inf"),
                          iters: int = 5,
                          tri_check_str_chi2: bool = True) -> PointOptResult:
    """Batched GMMLoc::optimizePoint. All leading dims are batch."""
    is_stereo = torch.ones(obs_uvr.shape[:-1], dtype=torch.bool, device=x0.device)
    x = x0
    for _ in range(iters):
        r, pc, _ = factors.reproj_residual(cam, q_cw, t_cw, x, obs_uvr, is_stereo)
        Jp = factors.stereo_proj_jac_point(cam, q_cw, pc, is_stereo)
        rs = factors.pt2plane_residual(x, plane_mean, plane_normal)
        H = (torch.einsum("...ij,...ik->...jk", Jp, Jp) * sigma2_inv[..., None, None]
             + str_info[..., None, None]
             * plane_normal[..., :, None] * plane_normal[..., None, :])
        b = (torch.einsum("...ij,...i->...j", Jp, r) * sigma2_inv[..., None]
             + (str_info * rs)[..., None] * plane_normal)
        x = x - _solve3(H, b)
    r, _, _ = factors.reproj_residual(cam, q_cw, t_cw, x, obs_uvr, is_stereo)
    chi2_proj = torch.sum(r * r, dim=-1) * sigma2_inv
    rs = factors.pt2plane_residual(x, plane_mean, plane_normal)
    chi2_str = rs * rs * str_info
    # gates (gmmloc_opt.cpp:337-348); the structure threshold has no z^2
    # factor although the edge information does
    ok = chi2_proj <= chi2_proj_thresh
    if tri_check_str_chi2:
        ok = ok & (chi2_str <= str_chi2_thresh)
    return PointOptResult(x, chi2_proj, chi2_str, ok)


def optimize_triangulation(cam, x0, q1, t1, obs1, stereo1, sigma2_inv1,
                           q2, t2, obs2, stereo2, sigma2_inv2,
                           plane_normal, plane_mean, tri_lambda2: float,
                           iters: int = 20):
    """Batched optimizeTriangulationVec inner solve. Returns (x, chi2_kf1,
    chi2_kf2, chi2_str); gating and argmin are the caller's."""
    x = x0
    for _ in range(iters):
        r1, pc1, _ = factors.reproj_residual(cam, q1, t1, x, obs1, stereo1)
        J1 = factors.stereo_proj_jac_point(cam, q1, pc1, stereo1)
        r2, pc2, _ = factors.reproj_residual(cam, q2, t2, x, obs2, stereo2)
        J2 = factors.stereo_proj_jac_point(cam, q2, pc2, stereo2)
        rs = factors.pt2plane_residual(x, plane_mean, plane_normal)
        H = (torch.einsum("...ij,...ik->...jk", J1, J1) * sigma2_inv1[..., None, None]
             + torch.einsum("...ij,...ik->...jk", J2, J2) * sigma2_inv2[..., None, None]
             + tri_lambda2 * plane_normal[..., :, None] * plane_normal[..., None, :])
        b = (torch.einsum("...ij,...i->...j", J1, r1) * sigma2_inv1[..., None]
             + torch.einsum("...ij,...i->...j", J2, r2) * sigma2_inv2[..., None]
             + (tri_lambda2 * rs)[..., None] * plane_normal)
        x = x - _solve3(H, b)
    r1, _, _ = factors.reproj_residual(cam, q1, t1, x, obs1, stereo1)
    r2, _, _ = factors.reproj_residual(cam, q2, t2, x, obs2, stereo2)
    rs = factors.pt2plane_residual(x, plane_mean, plane_normal)
    return (x, torch.sum(r1 * r1, dim=-1) * sigma2_inv1,
            torch.sum(r2 * r2, dim=-1) * sigma2_inv2, rs * rs * tri_lambda2)
