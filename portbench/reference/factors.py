"""Batched residual/Jacobian terms for the factor zoo.

PyTorch port of `gmmloc_tpu/solver/factors.py`: mono/stereo reprojection
(pose and point Jacobians), point-to-Gaussian (3-D, sqrt-info whitened),
point-to-plane (1-D), the SE3 pose prior and Huber weights. Poses are T_cw
as (q, t); pc = R(q) x + t; updates are left-multiplicative with
xi = [omega, upsilon]; residuals are predicted - observed.
"""

from __future__ import annotations

import torch

from . import camera as cam_mod
from . import se3


def reproj_residual(cam, q_cw, t_cw, x_w, obs_uvr, is_stereo):
    """Unified mono/stereo reprojection residual as a 3-vector (mono rows
    zero the u_right component). Returns (r (...,3), pc (...,3),
    depth_ok (...,))."""
    pc = se3.apply(q_cw, t_cw, x_w)
    pred, _ = cam_mod.project_stereo(cam, pc)
    r = pred - obs_uvr
    one = torch.ones_like(r[..., 0])
    mask3 = torch.stack([one, one, is_stereo.to(r.dtype).expand_as(one)], dim=-1)
    return r * mask3, pc, pc[..., 2] > 0.0


def _dpc_rows(cam, pc, is_stereo):
    x, y, z = pc.unbind(-1)
    iz = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    iz2 = iz * iz
    zr = torch.zeros_like(x)
    du = torch.stack([cam.fx * iz, zr, -cam.fx * x * iz2], dim=-1)
    dv = torch.stack([zr, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    dur = du + torch.stack([zr, zr, cam.bf * iz2], dim=-1)
    dur = dur * is_stereo.to(pc.dtype)[..., None]
    return torch.stack([du, dv, dur], dim=-2)          # (...,3,3)


def stereo_proj_jac_point(cam, q_cw, pc, is_stereo):
    """d r / d x_w: (...,3,3) = dr/dpc @ R."""
    return _dpc_rows(cam, pc, is_stereo) @ se3.quat_to_matrix(q_cw)


def stereo_proj_jac_pose(cam, pc, is_stereo):
    """d r / d xi (...,3,6) for the left-multiplicative update:
    d pc / d xi = [-skew(pc) | I]."""
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dpc_dxi = torch.cat([-se3.skew(pc), eye], dim=-1)
    return _dpc_rows(cam, pc, is_stereo) @ dpc_dxi


def pt2gaussian_residual(x, mean, sqrt_info):
    """3-D whitened point-to-Gaussian: r = L^T (x - mean)."""
    return torch.einsum("...ji,...j->...i", sqrt_info, x - mean)


def pt2plane_residual(x, mean, normal):
    """1-D point-to-plane along the dominant normal: r = n^T (x - mean)."""
    return torch.sum((x - mean) * normal, dim=-1)


def anchor_point_world(q_cw, t_cw, x_c):
    """x_w = R_cw^T (x_c - t_cw). Returns (x_w, R_wc)."""
    R_wc = se3.quat_to_matrix(q_cw).transpose(-1, -2)
    x_w = torch.einsum("...ij,...j->...i", R_wc, x_c - t_cw)
    return x_w, R_wc


def anchor_jac_pose(R_wc, x_c):
    """d x_w / d xi = R_wc [skew(x_c) | -I] (...,3,6)."""
    eye = torch.eye(3, dtype=x_c.dtype, device=x_c.device).expand(x_c.shape[:-1] + (3, 3))
    return torch.einsum(
        "...ij,...jk->...ik", R_wc, torch.cat([se3.skew(x_c), -eye], -1)
    )


def se3_prior_residual(q, t, q_prior, t_prior):
    """r = log(T_prior^-1 * T)."""
    qi, ti = se3.inverse(q_prior, t_prior)
    qd, td = se3.compose(qi, ti, q, t)
    return se3.log(qd, td)


def se3_prior_jacobian(q, t, q_prior, t_prior, h: float = 1e-6):
    """d r / d xi (6x6) at xi = 0 for the left-multiplicative update, by
    central differences in float64 over the 6 directions in one batched
    residual evaluation (truncation ~h^2, far below float32). Forward-mode
    AD of the same function costs thousands of small ops per call."""
    f64 = torch.float64
    eye = torch.eye(6, dtype=f64, device=t.device) * h
    xi = torch.cat([eye, -eye])                                   # (12,6)
    qq, tt = se3.boxplus(q.to(f64).expand(12, 4), t.to(f64).expand(12, 3), xi)
    r = se3_prior_residual(qq, tt, q_prior.to(f64), t_prior.to(f64))
    return ((r[:6] - r[6:]).T / (2.0 * h)).to(t.dtype)


def huber_weight(chi2, delta):
    """g2o RobustKernelHuber IRLS weight: 1 if sqrt(chi2) <= delta else
    delta / sqrt(chi2)."""
    s = torch.sqrt(torch.clamp(chi2, min=1e-24))
    return torch.where(s <= delta, torch.ones_like(s), delta / s)
