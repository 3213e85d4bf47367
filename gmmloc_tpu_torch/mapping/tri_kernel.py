"""Fused triangulation: epipolar search + init + GMM-constrained solve +
acceptance gates as one device program over the mirror.

PyTorch port of `gmmloc_tpu/mapping/tri_kernel.py` (ref
Localization::createMapPoints + optimizeTriangulationVec,
localization_opt.cpp:206-455). Every host step of the unfused path
(match flattening, DLT/stereo init, candidate assembly, gates,
first-wins selection) is masked tensor arithmetic on rows of the
device-world mirror, so the keyframe's triangulation is enqueued without
a host round trip and read back once.

The 4x4 DLT null vector comes from the adjugate instead of an SVD: for a
near-rank-3 A, adj(A) ~ sigma1 sigma2 sigma3 v4 u4^T, so the dominant
eigenvector of adj(A) adj(A)^T is v4, which float32 power iteration
recovers (the Gram matrix A^T A would square the condition number).
"""

from __future__ import annotations

import math

import torch

from ..features import matching
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..solver import point_solver


def _adj4(M):
    """Batched adjugate of (...,4,4) matrices via 3x3 cofactors."""

    def det3(r, c):
        rows = [i for i in range(4) if i != r]
        cols = [j for j in range(4) if j != c]
        a, b, c_ = (M[..., rows[0], cols[k]] for k in range(3))
        d, e, f = (M[..., rows[1], cols[k]] for k in range(3))
        g, h, i = (M[..., rows[2], cols[k]] for k in range(3))
        return a * (e * i - f * h) - b * (d * i - f * g) + c_ * (d * h - e * g)

    # adj(M)[i, j] = (-1)^(i+j) minor(j, i)
    return torch.stack([
        torch.stack([((-1.0) ** (i + j)) * det3(j, i) for j in range(4)], -1)
        for i in range(4)
    ], -2)


def _dlt_null(A):
    """Approximate null vector of (...,4,4) A (module docstring)."""
    A = A / torch.clamp(torch.linalg.norm(A, dim=-1, keepdim=True), min=1e-12)
    G = _adj4(A)
    B = torch.einsum("...ik,...jk->...ij", G, G)
    j = torch.argmax(torch.diagonal(B, dim1=-2, dim2=-1), dim=-1)
    v = torch.take_along_dim(B, j[..., None, None].expand(B.shape[:-1] + (1,)), -1)[..., 0]
    for _ in range(2):
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
        v = torch.einsum("...ij,...j->...i", B, v)
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)


def triangulate_kernel(
    cam: cam_mod.CameraParams,
    kf1: int,
    kf2_idx,          # (TP,) int64 neighbour keyframes (padded; job_ok masks)
    job_ok,           # (TP,) bool
    free1,            # (F,) bool
    free2,            # (TP,F) bool
    fmat,             # (TP,3,3)
    epipole2,         # (TP,2)
    sigma2_tab,       # (L,)
    sigma2_inv_tab,   # (L,)
    sf_tab,           # (L,) scale factors
    kf_q, kf_t, kf_uv, kf_ur, kf_desc, kf_oct, kf_angle, kf_depth, kf_cand,
    g_means, g_normal, g_deg,
    *,
    m_tri: int,
    tri_lambda2: float,
    tri_opt_iters: int,
    tri_check_str_chi2: bool,
    tri_str_thresh: float,
    ratio_factor: float,
):
    """Per-match records over a fixed m_tri budget: (win, idx1, idx2,
    pair_t, pts, has_str, str_comp, from_mono, n_matches). Matches beyond
    the budget are dropped pair-major-last (n_matches confesses the
    overflow). Every gather index is in range by construction: idx1 and
    idx2 < F, pair_t < TP, candidate components >= 0 after the clamp."""
    TP, F = free2.shape
    dev = free2.device

    # ---- epipolar search over all neighbour pairs ------------------------
    match = matching.search_for_triangulation_gather(
        kf1, kf2_idx, free1, free2 & job_ok[:, None], fmat, epipole2, sigma2_tab,
        kf_uv, kf_ur, kf_desc, kf_oct, kf_angle)                  # (TP, F)

    # ---- compact matches to the m_tri budget, pair-major order -----------
    flat_ok = (match >= 0).reshape(-1)
    n_matches = torch.sum(flat_ok.to(torch.int32))
    take = torch.argsort((~flat_ok).to(torch.int8), stable=True)[:m_tri]
    m_ok = flat_ok[take]
    pair_t = take // F
    idx1 = take % F
    idx2 = torch.clamp(match.reshape(-1)[take], min=0)
    kf2_of = kf2_idx[pair_t]

    # ---- per-match geometry ---------------------------------------------
    q1, t1 = kf_q[kf1], kf_t[kf1]
    q2, t2 = kf_q[kf2_of], kf_t[kf2_of]
    R1 = se3.quat_to_matrix(q1)
    R2 = se3.quat_to_matrix(q2)                                  # (M,3,3)
    t1_wc = -R1.T @ t1
    t2_wc = -torch.einsum("mji,mj->mi", R2, t2)

    uv1, uv2 = kf_uv[kf1, idx1], kf_uv[kf2_of, idx2]
    ur1, ur2 = kf_ur[kf1, idx1], kf_ur[kf2_of, idx2]
    z1, z2 = kf_depth[kf1, idx1], kf_depth[kf2_of, idx2]
    oct1, oct2 = kf_oct[kf1, idx1], kf_oct[kf2_of, idx2]
    st1, st2 = ur1 >= 0, ur2 >= 0
    M = idx1.shape[0]

    one = torch.ones(M, dtype=torch.float32, device=dev)
    xn1 = torch.stack([(uv1[:, 0] - cam.cx) / cam.fx, (uv1[:, 1] - cam.cy) / cam.fy, one], -1)
    xn2 = torch.stack([(uv2[:, 0] - cam.cx) / cam.fx, (uv2[:, 1] - cam.cy) / cam.fy, one], -1)
    ray1 = xn1 @ R1
    ray2 = torch.einsum("mi,mij->mj", xn2, R2)
    cos_rays = torch.sum(ray1 * ray2, -1) / (
        torch.linalg.norm(ray1, dim=1) * torch.linalg.norm(ray2, dim=1))
    half_b = (cam.bf / cam.fx) / 2

    def cos_stereo_of(st, z):
        zc = torch.clamp(z, min=1e-6)
        ang = torch.atan2(torch.full_like(zc, half_b), zc)
        return torch.where(st, torch.cos(2 * ang), cos_rays + 1)

    cos_st1, cos_st2 = cos_stereo_of(st1, z1), cos_stereo_of(st2, z2)
    cos_stereo = torch.minimum(cos_st1, cos_st2)
    use_dlt = (cos_rays < cos_stereo) & (cos_rays > 0) & (st1 | st2 | (cos_rays < 0.9998))
    use_s1 = ~use_dlt & st1 & (cos_st1 < cos_st2)
    use_s2 = ~use_dlt & st2 & (cos_st2 <= cos_st1) & ~use_s1
    usable = (use_dlt | use_s1 | use_s2) & m_ok
    from_mono = use_dlt

    # ---- init: DLT (adjugate null vector) or stereo unproject ------------
    T1r = torch.cat([R1, t1[:, None]], 1)                        # (3,4)
    T2r = torch.cat([R2, t2[..., None]], 2)                      # (M,3,4)
    A = torch.stack([
        xn1[:, 0, None] * T1r[2][None, :] - T1r[0][None, :],
        xn1[:, 1, None] * T1r[2][None, :] - T1r[1][None, :],
        xn2[:, 0, None] * T2r[:, 2] - T2r[:, 0],
        xn2[:, 1, None] * T2r[:, 2] - T2r[:, 1],
    ], 1)                                                        # (M,4,4)
    v = _dlt_null(A)
    dlt_bad = torch.abs(v[:, 3]) < 1e-9
    pts_dlt = v[:, :3] / torch.where(dlt_bad, torch.ones_like(v[:, 3]), v[:, 3])[:, None]
    usable = usable & ~(use_dlt & dlt_bad)
    pts_s1 = (xn1 * z1[:, None] - t1) @ R1
    pts_s2 = torch.einsum("mi,mij->mj", xn2 * z2[:, None] - t2, R2)
    pts0 = torch.where(use_dlt[:, None], pts_dlt,
                       torch.where(use_s1[:, None], pts_s1, pts_s2))

    # ---- candidate degenerate components (union of both features') -------
    cands = torch.cat([kf_cand[kf1, idx1], kf_cand[kf2_of, idx2]], 1).to(torch.int64)
    cands = torch.where((cands >= 0) & g_deg[torch.clamp(cands, min=0)], cands, -1)
    CK = cands.shape[1]

    # ---- GMM-constrained solve over all (match x candidate) pairs -------
    obs1 = torch.cat([uv1, ur1[:, None]], -1)
    obs2 = torch.cat([uv2, ur2[:, None]], -1)
    s2i1 = sigma2_inv_tab[oct1]  # the reference uses sigma2_inv1 for both edges
    safe_c = torch.clamp(cands, min=0)

    def bc(a):
        return a[:, None].expand((M, CK) + tuple(a.shape[1:]))

    x_opt, c1o, c2o, cso = point_solver.optimize_triangulation(
        cam, bc(pts0), q1.expand(M, CK, 4), t1.expand(M, CK, 3),
        bc(obs1), bc(st1), bc(s2i1), bc(q2), bc(t2), bc(obs2), bc(st2), bc(s2i1),
        g_normal[safe_c].to(torch.float32), g_means[safe_c].to(torch.float32),
        tri_lambda2=tri_lambda2, iters=tri_opt_iters)           # (M,CK,...)

    th1 = torch.where(st1, 7.8, 5.991)[:, None]
    th2 = torch.where(st2, 7.8, 5.991)[:, None]
    ok = (cands >= 0) & (c1o <= th1) & (c2o <= th2)
    if tri_check_str_chi2:
        ok = ok & (cso <= tri_str_thresh * tri_lambda2)
    err_sum = torch.where(ok, c1o + c2o, math.inf)
    best = torch.argmin(err_sum, dim=1)
    has_str = torch.isfinite(torch.gather(err_sum, 1, best[:, None])[:, 0])
    str_comp = torch.where(has_str, torch.gather(cands, 1, best[:, None])[:, 0], -1)
    pts = torch.where(has_str[:, None],
                      torch.gather(x_opt, 1, best[:, None, None].expand(M, 1, 3))[:, 0],
                      pts0)

    # ---- acceptance gates (localization_opt.cpp:358-412) ----------------
    def reproj_ok(pc, uvk, urk, stk):
        z = pc[:, 2]
        zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v_ = cam.fy * pc[:, 1] / zs + cam.cy
        err = (u - uvk[:, 0]) ** 2 + (v_ - uvk[:, 1]) ** 2
        e = torch.where(stk, err + (u - cam.bf / zs - urk) ** 2, err)
        th = torch.where(stk, 7.8, 5.991)
        # the reference scales both gates by sigma2[kp1.octave] (:371,:382)
        return (z > 0) & (e <= th * sigma2_tab[oct1])

    ok_pt = usable & reproj_ok(pts @ R1.T + t1, uv1, ur1, st1)
    pc2 = torch.einsum("mij,mj->mi", R2, pts) + t2
    ok_pt = ok_pt & reproj_ok(pc2, uv2, ur2, st2)
    d1 = torch.linalg.norm(pts - t1_wc, dim=1)
    d2 = torch.linalg.norm(pts - t2_wc, dim=1)
    ok_pt = ok_pt & (d1 >= 1e-9) & (d2 >= 1e-9)
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    ratio_oct = sf_tab[oct1] / sf_tab[oct2]
    ok_pt = ok_pt & (ratio_dist * ratio_factor >= ratio_oct) & (
        ratio_dist <= ratio_oct * ratio_factor)

    # ---- first wins per kf1 feature across pairs (covisibility order) ----
    BIG = 1 << 20
    score = torch.where(ok_pt, pair_t, BIG)
    best_for_feat = torch.full((F,), BIG, dtype=score.dtype, device=dev).scatter_reduce(
        0, idx1, score, reduce="amin")
    win = ok_pt & (score == best_for_feat[idx1]) & (score < BIG)
    return win, idx1, idx2, pair_t, pts, has_str, str_comp, from_mono, n_matches
