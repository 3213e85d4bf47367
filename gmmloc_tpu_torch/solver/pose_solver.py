"""Pose-only Gauss-Newton solver with staged inlier reclassification.

PyTorch port of `gmmloc_tpu/solver/pose_solver.py`, and the plain version
of the hand-written CUDA kernels in `solver/cuda_pose.py` (which replace
the Pallas kernels of `gmmloc_tpu/solver/pallas_pose.py`). One SE3 vertex,
N mono/stereo reprojection edges with Huber kernels, 4 rounds x 10
iterations restarting from the initial pose, chi2 reclassification
(5.991 mono / 7.815 stereo) between rounds, robust kernel dropped for the
final round (ref tracking_opt.cpp:21-227).

The data-dependent early stop (max|dx| < step_tol, or a non-finite step)
freezes the pose for the remaining iterations instead of leaving the
loop, so no iteration waits for the host: the result equals the
while-loop form.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import factors
from ..geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815

ANCHOR_NONE = 0
ANCHOR_DEG = 1      # 1-D point-to-plane along the dominant normal
ANCHOR_NONDEG = 2   # 3-D sqrt-info whitened


class PoseOptResult(NamedTuple):
    q: torch.Tensor           # (4,) optimized T_cw rotation
    t: torch.Tensor           # (3,)
    is_outlier: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor        # (N,) final per-edge chi2
    gn_iters: Optional[torch.Tensor] = None  # () GN steps run (kernel only)


class PoseAnchorResult(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    is_outlier: torch.Tensor
    num_inliers: torch.Tensor
    chi2: torch.Tensor
    anc_outlier: torch.Tensor  # (N,) anchor-edge outliers
    num_anchors: torch.Tensor  # () int32 surviving anchors
    gn_iters: Optional[torch.Tensor] = None  # () GN steps run (kernel only)


def _chol_solve6(H, b):
    """Unrolled 6x6 Cholesky solve with the pivot clamp of the reference
    (sqrt(max(s, 1e-20)))."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        s = H[i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = torch.sqrt(torch.clamp(s, min=1e-20))
        for j in range(i + 1, 6):
            s2 = H[j, i]
            for k in range(i):
                s2 = s2 - L[j][k] * L[i][k]
            L[j][i] = s2 / L[i][i]
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def _reproj_normal(cam, q, t, x_w, obs_uvr, is_stereo, sigma2_inv, active,
                   huber_delta, use_huber):
    r, pc, _ = factors.reproj_residual(cam, q, t, x_w, obs_uvr, is_stereo)
    J = factors.stereo_proj_jac_pose(cam, pc, is_stereo)          # (N,3,6)
    chi2 = torch.sum(r * r, dim=-1) * sigma2_inv
    w = sigma2_inv * active.to(r.dtype)
    if use_huber:
        w = w * factors.huber_weight(chi2, huber_delta)
    H = torch.einsum("nij,n,nik->jk", J, w, J)
    b = torch.einsum("nij,n,ni->j", J, w, r)
    return H, b


def _chi2(cam, q, t, x_w, obs_uvr, is_stereo, sigma2_inv):
    r, _, _ = factors.reproj_residual(cam, q, t, x_w, obs_uvr, is_stereo)
    return torch.sum(r * r, dim=-1) * sigma2_inv


def _gn(q0, t0, iters, step_tol, normal_eq):
    """Up to `iters` GN steps from (q0, t0); a converged or non-finite
    step freezes the pose for the rest (the while-loop semantics)."""
    q, t = q0, t0
    done = torch.zeros((), dtype=torch.bool, device=q0.device)
    eye = torch.eye(6, dtype=q0.dtype, device=q0.device)
    for _ in range(iters):
        H, b = normal_eq(q, t)
        dx = -_chol_solve6(H + eye * 1e-6, b)
        q_n, t_n = se3.boxplus(q, t, dx)
        ok = torch.isfinite(q_n).all() & torch.isfinite(t_n).all()
        upd = ok & ~done
        q = torch.where(upd, q_n, q)
        t = torch.where(upd, t_n, t)
        done = done | ~ok | (torch.max(torch.abs(dx)) < step_tol)
    return q, t


def optimize_pose(cam, q0, t0, x_w, obs_uvr, is_stereo, sigma2_inv, valid,
                  rounds: int = 4, iters: int = 10,
                  step_tol: float = 1e-8) -> PoseOptResult:
    """The 4x10 staged pose-only solve (plain version of kernel K1).

    x_w (N,3) landmarks, obs_uvr (N,3) measurements (u, v, u_right),
    is_stereo (N,) bool, sigma2_inv (N,), valid (N,) bool."""
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(x_w.dtype)
    delta = torch.sqrt(chi2_th)
    outlier = torch.zeros_like(valid)
    q, t = q0, t0
    for rd in range(rounds):
        active = valid & ~outlier
        use_huber = rd < 3   # robust kernel removed at it==2 (tracking_opt.cpp:181)
        q, t = _gn(q0, t0, iters, step_tol, lambda qi, ti: _reproj_normal(
            cam, qi, ti, x_w, obs_uvr, is_stereo, sigma2_inv, active, delta,
            use_huber))
        chi2 = _chi2(cam, q, t, x_w, obs_uvr, is_stereo, sigma2_inv)
        # ~(chi2 <= th): a NaN chi2 classifies as an outlier
        outlier = valid & ~(chi2 <= chi2_th)
    chi2 = _chi2(cam, q, t, x_w, obs_uvr, is_stereo, sigma2_inv)
    n_inl = torch.sum(valid & ~outlier).to(torch.int32)
    return PoseOptResult(q, t, outlier, n_inl, chi2)


def _anchor_terms(q, t, anc_xc, anc_mean, anc_normal, anc_sqrt_info, is_deg,
                  anc_weight):
    """Anchor residual rows r3 (N,3), Jacobian rows J3 (N,3,6), chi2 (N,)."""
    x_w_a, R_wc = factors.anchor_point_world(q, t, anc_xc)
    Jx = factors.anchor_jac_pose(R_wc, anc_xc)                    # (N,3,6)
    d = x_w_a - anc_mean
    r_deg = torch.sum(d * anc_normal, -1)
    J_deg = torch.einsum("ni,nij->nj", anc_normal, Jx)
    r_nd = torch.einsum("nji,nj->ni", anc_sqrt_info, d)
    J_nd = torch.einsum("nji,njk->nik", anc_sqrt_info, Jx)
    r3 = torch.where(
        is_deg[:, None],
        torch.cat([r_deg[:, None], torch.zeros_like(r_nd[:, :2])], -1), r_nd)
    J3 = torch.where(
        is_deg[:, None, None],
        torch.cat([J_deg[:, None, :], torch.zeros_like(J_nd[:, :2])], 1), J_nd)
    chi2 = torch.sum(r3 * r3, -1) * anc_weight
    return r3, J3, chi2


def optimize_pose_anchored(cam, q0, t0, x_w, obs_uvr, is_stereo, sigma2_inv,
                           valid, anc_xc, anc_mean, anc_normal, anc_sqrt_info,
                           anc_type, anc_weight, anc_chi2_th,
                           rounds: int = 4, iters: int = 10,
                           step_tol: float = 1e-8) -> PoseAnchorResult:
    """Staged pose-only solve with per-frame GMM structure anchors (plain
    version of kernel K2): each anchored feature adds a pose edge tying
    its own stereo point (anc_xc, camera frame) to its GMM component —
    1-D point-to-plane for a degenerate component, 3-D whitened
    otherwise, with its own Huber weight and chi2 gate anc_chi2_th."""
    dt = x_w.dtype
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(dt)
    delta = torch.sqrt(chi2_th)
    anc_exists = anc_type != ANCHOR_NONE
    is_deg = anc_type == ANCHOR_DEG
    anc_chi2_th = torch.as_tensor(anc_chi2_th, dtype=dt, device=x_w.device)
    anc_delta = torch.sqrt(anc_chi2_th)
    anc = (anc_xc, anc_mean, anc_normal, anc_sqrt_info, is_deg, anc_weight)

    outlier = torch.zeros_like(valid)
    anc_out = torch.zeros_like(anc_exists)
    q, t = q0, t0
    for rd in range(rounds):
        active = valid & ~outlier
        use_huber = rd < 3
        # robust rounds keep every anchor; the final round the gated set
        active_anc = anc_exists & (use_huber | ~anc_out)

        def normal_eq(qi, ti, active=active, active_anc=active_anc,
                      use_huber=use_huber):
            H, b = _reproj_normal(cam, qi, ti, x_w, obs_uvr, is_stereo,
                                  sigma2_inv, active, delta, use_huber)
            r3, J3, chi2_a = _anchor_terms(qi, ti, *anc)
            w = anc_weight * active_anc.to(dt)
            if use_huber:
                w = w * factors.huber_weight(chi2_a, anc_delta)
            H = H + torch.einsum("nij,n,nik->jk", J3, w, J3)
            b = b + torch.einsum("nij,n,ni->j", J3, w, r3)
            return H, b

        q, t = _gn(q0, t0, iters, step_tol, normal_eq)
        chi2 = _chi2(cam, q, t, x_w, obs_uvr, is_stereo, sigma2_inv)
        outlier = valid & ~(chi2 <= chi2_th)
        _, _, chi2_a = _anchor_terms(q, t, *anc)
        anc_out = anc_exists & ~(chi2_a <= anc_chi2_th)
    chi2 = _chi2(cam, q, t, x_w, obs_uvr, is_stereo, sigma2_inv)
    n_inl = torch.sum(valid & ~outlier).to(torch.int32)
    n_anc = torch.sum(anc_exists & ~anc_out).to(torch.int32)
    return PoseAnchorResult(q, t, outlier, n_inl, chi2, anc_out, n_anc)
