"""Keyframe association against the prior map: the map's derived tables,
the view render, the candidate search and the point-to-component solves.

Plain copies of the port's `gmm/mixture.py::from_arrays` (the derived
tables and the Bhattacharyya neighbour graph), `gmm/render.py`
(render_view, search_correspondence, query_point_3d),
`solver/point_solver.py::optimize_point_stereo` and
`mapping/association.py::associate_and_check_kernel` (ref
GMM::renderView / searchCorrespondence / queryPoint,
gaussian_mixture.cpp:271-371, 484-576; GMMLoc::associateMapElements,
checkMapAssociation, optimizePoint, gmmloc_opt.cpp:115-352), on the CPU
in the dtype of the inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import camera as cam_mod
from . import factors
from . import se3
from .local_ba import _inv3


# ---------------------------------------------------------------------------
# the map
# ---------------------------------------------------------------------------


def neighbor_graph(means, covs, dets, thresh: float, cap: int, block: int = 256):
    """(K, cap) neighbour table: Bhattacharyya distance < thresh, self
    excluded, the `cap` nearest kept, -1 padded (ref gaussian_mixture.cpp:
    61-78), with the spatial prefilter BH >= |d|^2 / (4 (tr_a + tr_b))."""
    K = means.shape[0]
    neighbors = np.full((K, cap), -1, dtype=np.int64)
    tr = covs[:, 0, 0] + covs[:, 1, 1] + covs[:, 2, 2]
    C = {k: covs[:, i, j] for k, (i, j) in
         dict(a=(0, 0), b=(0, 1), c=(0, 2), e=(1, 1), f=(1, 2), i=(2, 2)).items()}
    for start in range(0, K, block):
        stop = min(start + block, K)
        d = means[None, :] - means[start:stop, None]
        dist2 = np.einsum("bki,bki->bk", d, d)
        gate = dist2 < 4.0 * thresh * (tr[start:stop, None] + tr[None, :])
        gate[np.arange(stop - start), np.arange(start, stop)] = False
        rr, cc = np.nonzero(gate)
        if len(rr) == 0:
            continue
        gi = rr + start
        a, b, c3, e, f, i3 = (0.5 * (C[k][gi] + C[k][cc]) for k in "abcefi")
        det_c = a * (e * i3 - f * f) - b * (b * i3 - f * c3) + c3 * (b * f - e * c3)
        dx, dy, dz = (means[cc] - means[gi]).T
        quad = (
            dx * dx * (e * i3 - f * f) + dy * dy * (a * i3 - c3 * c3)
            + dz * dz * (a * e - b * b)
            + 2.0 * (dx * dy * (c3 * f - b * i3) + dx * dz * (b * f - c3 * e)
                     + dy * dz * (b * c3 - a * f))
        ) / np.clip(det_c, 1e-300, None)
        bh = quad / 8.0 + 0.5 * np.log(
            np.clip(det_c, 1e-300, None) / np.sqrt(np.clip(dets[gi] * dets[cc], 1e-300, None)))
        ok = bh < thresh
        rr, cc, bh = rr[ok], cc[ok], bh[ok]
        for r in np.unique(rr):
            sel = rr == r
            idx = cc[sel]
            if len(idx) > cap:
                idx = idx[np.argsort(bh[sel])[:cap]]
            neighbors[start + r, : len(idx)] = idx
    return neighbors


def gmm_map(means, covs, pad_to: int, neighbor_dist_thresh: float, neighbor_cap: int,
            degenerate_eig_thresh: float, dtype=torch.float64) -> dict:
    """The map's tables from its raw (K,3) means and (K,3,3) covariances,
    padded to `pad_to` (identity covariances in the padding): means, covs,
    cov_inv, normal (the smallest-eigenvalue direction), is_degenerated,
    valid, neighbors."""
    means = np.asarray(means, np.float64)
    covs = np.asarray(covs, np.float64)
    K = means.shape[0]
    evals, evecs = np.linalg.eigh(covs)
    det = np.linalg.det(covs)
    pad = pad_to - K
    eye = np.tile(np.eye(3), (pad, 1, 1))
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return dict(
        means=t(np.concatenate([means, np.zeros((pad, 3))])),
        covs=t(np.concatenate([covs, eye])),
        cov_inv=t(np.concatenate([np.linalg.inv(covs), eye])),
        normal=t(np.concatenate([evecs, eye])[:, :, 0]),
        is_degenerated=torch.tensor(np.concatenate([evals[:, 0] < degenerate_eig_thresh,
                                                    np.zeros(pad, bool)])),
        valid=torch.arange(pad_to) < K,
        neighbors=torch.tensor(np.concatenate([
            neighbor_graph(means, covs, det, neighbor_dist_thresh, neighbor_cap),
            np.full((pad, neighbor_cap), -1, np.int64)])))


def as_dtype(gmap: dict, dtype) -> dict:
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in gmap.items()}


# ---------------------------------------------------------------------------
# the render and the candidate search
# ---------------------------------------------------------------------------


def _eig2x2_values(a, b, c):
    tr = a + c
    disc = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    return 0.5 * tr - disc, 0.5 * tr + disc


def _inv2x2(m):
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    det_safe = torch.where(torch.abs(det) < 1e-24, torch.full_like(det, 1e-24), det)
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], dim=-2)
    return inv / det_safe[..., None, None]


def render_view(gmap: dict, cam, q_cw, t_cw, view_cos_deg: float, cov2d_scale_thresh: float,
                occlusion_bh_thresh: float, block: int = 512):
    """Every component projected, with renderView's gates in order: the
    view angle of degenerate normals, the mean inside the image with
    z > 0, the 2-D scale, then occlusion (i is hidden by an alive j that
    overlaps it, BH2d < thresh, and is strictly nearer, ties by index).
    Returns (mean2d (K,2), cov2d_inv (K,2,2), visible (K,))."""
    means = gmap["means"]
    _, t_wc = se3.inverse(q_cw, t_cw)
    po = means - t_wc
    po = po / torch.clamp(torch.linalg.norm(po, dim=-1, keepdim=True), min=1e-12)
    view_cos = torch.abs(torch.sum(po * gmap["normal"], -1))
    pass_viewcos = ~gmap["is_degenerated"] | (view_cos >= math.cos(math.radians(view_cos_deg)))
    pc = se3.apply(q_cw, t_cw, means)
    uv, vis_proj = cam_mod.project(cam, pc)
    JR = cam_mod.project_jacobian(cam, pc) @ se3.quat_to_matrix(q_cw)
    cov2d = JR @ gmap["covs"] @ JR.transpose(-1, -2)
    ca, cb, cc = cov2d[:, 0, 0], cov2d[:, 0, 1], cov2d[:, 1, 1]
    _, scale_hi = _eig2x2_values(ca, cb, cc)
    alive = gmap["valid"] & pass_viewcos & vis_proj & (scale_hi >= cov2d_scale_thresh)

    depth = pc[:, 2]
    K = uv.shape[0]
    det = torch.clamp(ca * cc - cb * cb, min=1e-30)
    idx = torch.arange(K)
    occluded = torch.zeros(K, dtype=torch.bool)
    for s in range(0, K, block):
        e = min(s + block, K)
        A = 0.5 * (ca[s:e, None] + ca[None, :])
        B = 0.5 * (cb[s:e, None] + cb[None, :])
        Cc = 0.5 * (cc[s:e, None] + cc[None, :])
        det_c = torch.clamp(A * Cc - B * B, min=1e-30)
        du = uv[None, :, 0] - uv[s:e, None, 0]
        dv = uv[None, :, 1] - uv[s:e, None, 1]
        md2 = (Cc * du * du - 2.0 * B * du * dv + A * dv * dv) / det_c
        bh = md2 / 8.0 + 0.5 * torch.log(
            det_c / torch.sqrt(torch.clamp(det[s:e, None] * det[None, :], min=1e-60)))
        overlap = (bh < occlusion_bh_thresh) & alive[s:e, None] & alive[None, :]
        d_b, i_b = depth[s:e, None], idx[s:e, None]
        nearer = (depth[None, :] < d_b) | ((depth[None, :] == d_b) & (idx[None, :] < i_b))
        occluded[s:e] = torch.any(overlap & nearer & (idx[None, :] != i_b), dim=1)
    return uv, _inv2x2(cov2d), alive & ~occluded


def search_correspondence(mean2d, cov2d_inv, visible, feat_uv, feat_valid, knn: int,
                          mdist2_thresh: float):
    """Per feature the knn nearest visible projected means (euclidean),
    then the Mahalanobis gate: (N, knn) component ids by increasing
    distance, -1 where gated out."""
    d2 = torch.sum((feat_uv[:, None, :] - mean2d[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(visible[None, :], d2, float("inf"))
    top, cand = torch.topk(d2, knn, dim=1, largest=False, sorted=True)
    d = feat_uv[:, None, :] - mean2d[cand]
    md2 = torch.einsum("...i,...ij,...j->...", d, cov2d_inv[cand], d)
    keep = torch.isfinite(top) & (md2 < mdist2_thresh) & feat_valid[:, None]
    return torch.where(keep, cand, -1)


def query_point_3d(gmap: dict, pts, pts_valid):
    """The euclidean-nearest valid component per point; -1 where invalid."""
    d2 = torch.sum((pts[:, None, :] - gmap["means"][None, :, :]) ** 2, dim=-1)
    d2 = torch.where(gmap["valid"][None, :], d2, float("inf"))
    return torch.where(pts_valid, torch.argmin(d2, dim=1), -1)


# ---------------------------------------------------------------------------
# the point solves and the association
# ---------------------------------------------------------------------------


def optimize_point_stereo(cam, x0, q_cw, t_cw, obs_uvr, sigma2_inv, plane_normal, plane_mean,
                          str_info, chi2_proj_thresh: float, str_chi2_thresh: float,
                          iters: int, tri_check_str_chi2: bool):
    """GMMLoc::optimizePoint over a batch: one stereo reprojection edge and
    one point-to-plane edge of information str_info, `iters` GN steps,
    then the chi2 gates. Returns (x, chi2_proj, ok)."""
    is_stereo = torch.ones(obs_uvr.shape[:-1], dtype=torch.bool)
    eye = torch.eye(3, dtype=x0.dtype)
    x = x0
    for _ in range(iters):
        r, pc, _ = factors.reproj_residual(cam, q_cw, t_cw, x, obs_uvr, is_stereo)
        Jp = factors.stereo_proj_jac_point(cam, q_cw, pc, is_stereo)
        rs = factors.pt2plane_residual(x, plane_mean, plane_normal)
        H = (torch.einsum("...ij,...ik->...jk", Jp, Jp) * sigma2_inv[..., None, None]
             + str_info[..., None, None] * plane_normal[..., :, None] * plane_normal[..., None, :])
        b = (torch.einsum("...ij,...i->...j", Jp, r) * sigma2_inv[..., None]
             + (str_info * rs)[..., None] * plane_normal)
        Hinv, _ = _inv3(H + eye * 1e-8)
        x = x - torch.einsum("...ij,...j->...i", Hinv, b)
    r, _, _ = factors.reproj_residual(cam, q_cw, t_cw, x, obs_uvr, is_stereo)
    chi2_proj = torch.sum(r * r, dim=-1) * sigma2_inv
    rs = factors.pt2plane_residual(x, plane_mean, plane_normal)
    ok = chi2_proj <= chi2_proj_thresh
    if tri_check_str_chi2:
        ok = ok & (rs * rs * str_info <= str_chi2_thresh)
    return x, chi2_proj, ok


def associate(gmap: dict, cam, q_cw, t_cw, uv, ur, octave, valid, depth, sigma2_inv_tab, *,
              knn: int, mdist2_thresh: float, view_cos_deg: float, cov2d_scale_thresh: float,
              occlusion_bh_thresh: float, tri_lambda2: float, chi2_stereo: float,
              str_chi2_thresh: float, chi2_assoc_3d: float, iters: int,
              tri_check_str_chi2: bool):
    """One keyframe's association: the render, the candidate search, the
    point solve of every (feature x candidate) pair, the best pair, the
    switch to a neighbour component of lower chi2 (re-solved), the accept
    gate, and for features whose candidates all failed the nearest
    degenerate component's solve (queryPoint; no association). Returns
    (cand (F,knn), assoc (F,) or -1, pt_out (F,3))."""
    F = uv.shape[0]
    mean2d, cov2d_inv, visible = render_view(gmap, cam, q_cw, t_cw, view_cos_deg,
                                             cov2d_scale_thresh, occlusion_bh_thresh)
    cand = search_correspondence(mean2d, cov2d_inv, visible, uv, valid, knn, mdist2_thresh)

    feat_ok = valid & (depth > 0)
    z = torch.where(feat_ok, depth, 1.0)
    xn = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy,
                      torch.ones_like(z)], -1)
    q_wc, t_wc = se3.inverse(q_cw, t_cw)
    pts0 = se3.apply(q_wc, t_wc, xn * z[:, None])
    obs_uvr = torch.cat([uv, ur[:, None]], -1)
    s2i = sigma2_inv_tab[octave]
    str_info = tri_lambda2 * torch.clamp(z, min=1.0) ** 2

    def chi2_comp(comp, pts):
        safe = torch.clamp(comp, min=0)
        d = pts - gmap["means"][safe]
        return torch.einsum("...i,...ij,...j->...", d, gmap["cov_inv"][safe], d)

    def solve(comp, pts_init):
        safe = torch.clamp(comp, min=0)
        lead = pts_init.shape[:-1]
        if pts_init.dim() == 3:
            obs, s2, si = obs_uvr[:, None, :], s2i[:, None], str_info[:, None]
        else:
            obs, s2, si = obs_uvr, s2i, str_info
        x, c, ok = optimize_point_stereo(
            cam, pts_init, q_cw, t_cw, obs.expand(lead + (3,)), s2.expand(lead),
            gmap["normal"][safe], gmap["means"][safe], si.expand(lead),
            chi2_proj_thresh=chi2_stereo, str_chi2_thresh=str_chi2_thresh, iters=iters,
            tri_check_str_chi2=tri_check_str_chi2)
        return x, c, ok & (comp >= 0)

    x1, c1, ok1 = solve(cand, pts0[:, None, :].expand(F, knn, 3))
    c1 = torch.where(ok1 & feat_ok[:, None], c1, float("inf"))
    best = torch.argmin(c1, dim=1)
    found = torch.isfinite(torch.gather(c1, 1, best[:, None])[:, 0])
    best_comp = torch.gather(cand, 1, best[:, None])[:, 0]
    best_pt = x1[torch.arange(F), best]

    g = torch.clamp(best_comp, min=0)
    ll = chi2_comp(g, best_pt)
    nbs = gmap["neighbors"][g]
    ln = chi2_comp(torch.clamp(nbs, min=0), best_pt[:, None, :])
    ln = torch.where(nbs >= 0, ln, float("inf"))
    nb_best = torch.argmin(ln, dim=1)
    nb_ll = torch.gather(ln, 1, nb_best[:, None])[:, 0]
    switch = found & (nb_ll < ll)
    nb_comp = torch.gather(nbs, 1, nb_best[:, None])[:, 0]
    chosen = torch.where(switch, nb_comp, best_comp)
    x2, _, ok2 = solve(torch.where(switch, chosen, -1), pts0)
    best_pt = torch.where((switch & ok2)[:, None], x2, best_pt)
    chosen = torch.where(switch & ~ok2, best_comp, chosen)

    accept = found & (chi2_comp(torch.clamp(chosen, min=0), best_pt) <= chi2_assoc_3d)
    assoc = torch.where(accept, chosen, -1)
    pt_out = torch.where(accept[:, None], best_pt, pts0)

    miss = feat_ok & (cand >= 0).any(dim=1) & ~found
    nearest = query_point_3d(gmap, pts0, miss)
    deg_ok = miss & (nearest >= 0) & gmap["is_degenerated"][torch.clamp(nearest, min=0)]
    x3, _, ok3 = solve(torch.where(deg_ok, nearest, -1), pts0)
    pt_out = torch.where((deg_ok & ok3)[:, None], x3, pt_out)
    return cand, assoc, pt_out
