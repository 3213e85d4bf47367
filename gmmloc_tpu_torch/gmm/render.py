"""View rendering + feature-to-component association.

PyTorch port of `gmmloc_tpu/gmm/render.py` (ref GMM::renderView /
searchCorrespondence / queryPoint, gaussian_mixture.cpp:271-371,
484-534, 536-576): project all K components, visibility gates as masks,
occlusion as a pairwise keep-nearest suppression, features associated by
a dense masked top-k over the N x K distance matrix.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import gaussian
from ..geometry import camera as cam_mod
from ..geometry import se3


class Render2D(NamedTuple):
    """Projected 2-D components, index-aligned with the map."""

    mean2d: torch.Tensor     # (K,2)
    cov2d: torch.Tensor      # (K,2,2)
    cov2d_inv: torch.Tensor  # (K,2,2)
    depth: torch.Tensor      # (K,) camera-frame z of the mean
    visible: torch.Tensor    # (K,) bool, survived every gate incl. occlusion


class Projected(NamedTuple):
    """The per-component half of `render_view`: each component's own
    gates, before occlusion."""

    uv: torch.Tensor         # (K,2)
    cov2d: torch.Tensor      # (K,2,2)
    depth: torch.Tensor      # (K,)
    alive: torch.Tensor      # (K,) bool: valid, view-cos, in view, 2-D scale


def project_components(gmap, cam: cam_mod.CameraParams, q_cw, t_cw,
                       view_cos_deg: float = 78.0,
                       cov2d_scale_thresh: float = 4.0) -> Projected:
    """Project every component of `gmap` and apply the per-component gates
    of renderView, in order: view-cos of degenerate normals, mean inside
    the image with z > 0, 2-D scale (max eigenvalue >= thresh). Each row
    depends on its own component only."""
    means = gmap.means
    _, t_wc = se3.inverse(q_cw, t_cw)
    po = means - t_wc
    po = po / torch.clamp(torch.linalg.norm(po, dim=-1, keepdim=True), min=1e-12)
    view_cos = torch.abs(torch.sum(po * gmap.normal, -1))
    cos_thresh = math.cos(math.radians(view_cos_deg))
    pass_viewcos = ~gmap.is_degenerated | (view_cos >= cos_thresh)

    pc = se3.apply(q_cw, t_cw, means)
    uv, vis_proj = cam_mod.project(cam, pc)
    J = cam_mod.project_jacobian(cam, pc)                  # (K,2,3)
    JR = J @ se3.quat_to_matrix(q_cw)
    cov2d = JR @ gmap.covs @ JR.transpose(-1, -2)
    scale2d, _ = gaussian.eig2x2(cov2d)
    pass_scale = scale2d[..., 1] >= cov2d_scale_thresh
    alive = gmap.valid & pass_viewcos & vis_proj & pass_scale
    return Projected(uv, cov2d, pc[..., 2], alive)


def occluded_rows(uv, ca, cb, cc, depth, alive, rows: tuple[int, int],
                  occlusion_bh_thresh: float = 0.8, block: int = 512):
    """The occlusion pass for components rows[0]..rows[1]-1 against all K
    (the arrays are global: uv (K,2), the cov2d entries ca = [0,0],
    cb = [0,1], cc = [1,1], depth, alive): i is occluded if an alive j
    overlaps it (BH2d < thresh) and is strictly nearer (ties by index).
    Elementwise in blocks of rows, so any split of the rows gives the
    same flags. Returns (rows[1] - rows[0],) bool."""
    K = uv.shape[0]
    r0, r1 = rows
    det = torch.clamp(ca * cc - cb * cb, min=1e-30)
    idx = torch.arange(K, device=uv.device)
    occluded = torch.zeros(r1 - r0, dtype=torch.bool, device=uv.device)
    for s in range(r0, r1, block):
        e = min(s + block, r1)
        A = 0.5 * (ca[s:e, None] + ca[None, :])
        B = 0.5 * (cb[s:e, None] + cb[None, :])
        C = 0.5 * (cc[s:e, None] + cc[None, :])
        det_c = torch.clamp(A * C - B * B, min=1e-30)
        du = uv[None, :, 0] - uv[s:e, None, 0]
        dv = uv[None, :, 1] - uv[s:e, None, 1]
        md2 = (C * du * du - 2.0 * B * du * dv + A * dv * dv) / det_c
        bh = md2 / 8.0 + 0.5 * torch.log(
            det_c / torch.sqrt(torch.clamp(det[s:e, None] * det[None, :], min=1e-60)))
        overlap = (bh < occlusion_bh_thresh) & alive[s:e, None] & alive[None, :]
        d_b = depth[s:e, None]
        i_b = idx[s:e, None]
        nearer = (depth[None, :] < d_b) | ((depth[None, :] == d_b) & (idx[None, :] < i_b))
        occluded[s - r0:e - r0] = torch.any(overlap & nearer & (idx[None, :] != i_b), dim=1)
    return occluded


def render_view(gmap, cam: cam_mod.CameraParams, q_cw, t_cw,
                view_cos_deg: float = 78.0, cov2d_scale_thresh: float = 4.0,
                occlusion_bh_thresh: float = 0.8, block: int = 512) -> Render2D:
    """Project all components with the gates of renderView
    (`project_components`), then occlusion over every row
    (`occluded_rows`)."""
    pr = project_components(gmap, cam, q_cw, t_cw, view_cos_deg, cov2d_scale_thresh)
    c = pr.cov2d
    occluded = occluded_rows(pr.uv, c[:, 0, 0], c[:, 0, 1], c[:, 1, 1], pr.depth, pr.alive,
                             (0, pr.uv.shape[0]), occlusion_bh_thresh, block)
    cov2d_inv, _ = gaussian.inv2x2(c)
    return Render2D(pr.uv, c, cov2d_inv, pr.depth, pr.alive & ~occluded)


def search_correspondence(render: Render2D, feat_uv, feat_valid, knn: int = 5,
                          mdist2_thresh: float = 9.0):
    """Per-feature candidate components: knn nearest visible projected
    means (euclidean), then the Mahalanobis gate. (N, knn) int64, -1
    where gated out, by increasing distance."""
    d2 = torch.sum((feat_uv[:, None, :] - render.mean2d[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(render.visible[None, :], d2, float("inf"))
    top, cand = torch.topk(d2, knn, dim=1, largest=False, sorted=True)
    found = torch.isfinite(top)
    mu = render.mean2d[cand]
    ci = render.cov2d_inv[cand]
    md2 = gaussian.mdist2_2d(mu, ci, feat_uv[:, None, :])
    keep = found & (md2 < mdist2_thresh) & feat_valid[:, None]
    return torch.where(keep, cand, -1)


def query_point_3d(gmap, pts, pts_valid):
    """Euclidean-nearest component per point (ref queryPoint returns
    ret_index[0]); -1 where invalid."""
    d2 = torch.sum((pts[:, None, :] - gmap.means[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(gmap.valid[None, :], d2, float("inf"))
    return torch.where(pts_valid, torch.argmin(d2, dim=1), -1)
