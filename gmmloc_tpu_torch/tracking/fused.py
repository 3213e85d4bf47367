"""Fused per-frame track step.

PyTorch port of `gmmloc_tpu/tracking/fused.py::_track_core`:

  project last-frame landmarks -> guided motion-model match (with the
  widened-window retry, tracking.cpp:345-350) -> staged pose solve (K1)
  -> project + gate local-map points (scale/view-cos, mappoint.cpp:257-299)
  -> guided local match -> anchored second pose solve (K2) -> inlier stats

on tensors of one device, with no host synchronisation inside: the host
passes the last-frame set, the current features and a fixed-capacity
local-map snapshot, and reads the result once. On the card the Hamming
matrices go through kernel K3 and the two solves through K1/K2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..features import matching
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..solver import cuda_pose, pose_solver


class FusedTrackResult(NamedTuple):
    q: torch.Tensor               # (4,) optimized T_cw
    t: torch.Tensor               # (3,)
    feat_point: torch.Tensor      # (F,) int64 local-map / last-frame slot
    feat_from_local: torch.Tensor  # (F,) bool, True if slot indexes the local map
    is_outlier: torch.Tensor      # (F,) bool
    num_inliers: torch.Tensor     # ()
    n_motion_matches: torch.Tensor  # ()
    map_in_view: torch.Tensor     # (P,) bool, local points passing the gates
    num_anchors: torch.Tensor     # () surviving GMM anchors (0 if off)


def _project(cam, q, t, pts):
    pc = se3.apply(q, t, pts)
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    ur = u - cam.bf / zs
    inside = (z > 0) & (u >= 0) & (v >= 0) & (u < cam.width) & (v < cam.height)
    return torch.stack([u, v], -1), ur, z, inside


def _scatter_slots(match, n_feat):
    """feature -> query slot: out[match[q]] = q for matched q (F = scratch
    slot for the unmatched)."""
    q = torch.arange(match.shape[0], device=match.device)
    tgt = torch.where(match >= 0, match, n_feat)
    out = torch.full((n_feat + 1,), -1, dtype=torch.int64, device=match.device)
    return out.index_put((tgt,), q)[:n_feat]


def track_core(
    cam: cam_mod.CameraParams,
    q0, t0,
    last_pts, last_desc, last_octave, last_angle, last_ur, last_valid,
    feat_uv, feat_ur, feat_desc, feat_octave, feat_angle, feat_valid,
    feat_sigma2_inv,
    map_pts, map_desc, map_normal, map_min_dist, map_max_dist, map_valid,
    scale_factors,
    log_scale_factor: float,
    num_levels: int,
    motion_radius: float = 7.0,
    local_radius: float = 3.0,
    use_anchors: bool = False,
    last_anc_type=None, last_anc_mean=None, last_anc_normal=None,
    last_anc_sqrt_info=None,
    map_anc_type=None, map_anc_mean=None, map_anc_normal=None,
    map_anc_sqrt_info=None,
    anchor_lambda2: float = 400.0,
    anchor_chi2_gate: float = 2.56,
    anchor_min_edges: int = 10,
) -> FusedTrackResult:
    """One frame's track step; octave tensors are int64, the rest as in
    the JAX `_track_core`."""
    F = feat_uv.shape[0]
    P = map_pts.shape[0]
    dev = feat_uv.device

    # ---- stage 1: motion-model guided match ----------------------------
    uv_p, ur_p, _, inside = _project(cam, q0, t0, last_pts)
    q_valid = last_valid & inside
    # one Hamming matrix shared by the narrow and the widened retry
    dist_motion = matching.hamming_matrix(last_desc, feat_desc)
    proj_ur = torch.where(last_ur >= 0, ur_p, -1.0)
    taken = torch.zeros(F, dtype=torch.bool, device=dev)

    def run_match(th):
        m, _ = matching.search_by_projection(
            uv_p, proj_ur, last_desc, last_octave, last_angle, q_valid,
            th * scale_factors[last_octave], last_octave - 1, last_octave + 1,
            feat_uv, feat_ur, feat_desc, feat_octave, feat_angle, feat_valid,
            taken, desc_thresh=matching.TH_HIGH, nn_ratio=1.0,
            use_rotation=True, dist_precomputed=dist_motion,
        )
        return m

    m1 = run_match(motion_radius)
    m1b = run_match(2.0 * motion_radius)
    match_motion = torch.where(torch.sum(m1 >= 0) < 20, m1b, m1)
    n_motion = torch.sum(match_motion >= 0)
    feat_point = _scatter_slots(match_motion, F)
    has1 = feat_point >= 0

    # ---- first pose solve (K1) -----------------------------------------
    x1 = last_pts[torch.clamp(feat_point, min=0)]
    obs = torch.cat([feat_uv, feat_ur[:, None]], -1)
    is_stereo = feat_ur >= 0
    res1 = cuda_pose.optimize_pose(
        cam, q0, t0, x1, obs, is_stereo, feat_sigma2_inv, has1 & feat_valid)
    inl1 = has1 & feat_valid & ~res1.is_outlier

    # ---- stage 2: local-map gates + guided match -----------------------
    q1, t1 = res1.q, res1.t
    _, t_wc = se3.inverse(q1, t1)
    uv_m, ur_m, _, inside_m = _project(cam, q1, t1, map_pts)
    v = map_pts - t_wc
    dist = torch.linalg.norm(v, dim=-1)
    ok = (
        map_valid & inside_m
        & (dist >= 0.8 * map_min_dist) & (dist <= 1.2 * map_max_dist)
        & (dist > 1e-9)
    )
    view_cos = torch.sum(v * map_normal, -1) / torch.clamp(dist, min=1e-9)
    ok = ok & (view_cos >= 0.5)
    lvl = torch.ceil(
        torch.log(torch.clamp(map_max_dist / torch.clamp(dist, min=1e-9), min=1e-9))
        / log_scale_factor
    ).to(torch.int64)
    lvl = torch.clamp(lvl, 0, num_levels - 1)
    m2, _ = matching.search_by_projection(
        uv_m, ur_m, map_desc, lvl, torch.zeros(P, dtype=torch.float32, device=dev),
        ok, local_radius * scale_factors[lvl], lvl - 1, lvl,
        feat_uv, feat_ur, feat_desc, feat_octave, feat_angle, feat_valid, inl1,
        desc_thresh=matching.TH_HIGH, nn_ratio=0.8, use_rotation=False,
    )
    add2 = _scatter_slots(m2, F)
    use2 = (add2 >= 0) & ~inl1
    feat_point = torch.where(use2, add2, feat_point)
    has = (feat_point >= 0) & (inl1 | use2)

    # ---- second pose solve (K2 with anchors, else K1) --------------------
    # a slot indexes the local map (P rows) or the last frame (F rows):
    # both gathers run for every feature, each clamped to its own table
    fpm = torch.clamp(feat_point, 0, P - 1)
    fpl = torch.clamp(feat_point, 0, F - 1)
    sel = use2[:, None]
    x2 = torch.where(sel, map_pts[fpm], last_pts[fpl])
    if use_anchors:
        # anchors gathered at the final assignment: the feature's own
        # stereo point tied to the matched point's vetted GMM component
        a_type = torch.where(use2, map_anc_type[fpm], last_anc_type[fpl])
        a_mean = torch.where(sel, map_anc_mean[fpm], last_anc_mean[fpl])
        a_norm = torch.where(sel, map_anc_normal[fpm], last_anc_normal[fpl])
        a_sqi = torch.where(sel[:, :, None], map_anc_sqrt_info[fpm],
                            last_anc_sqrt_info[fpl])
        disp = obs[:, 0] - obs[:, 2]
        zs = torch.where(torch.abs(disp) < 1e-6, 1e9,
                         cam.bf / torch.clamp(disp, min=1e-6))
        anc_ok = ((a_type != pose_solver.ANCHOR_NONE) & has & feat_valid
                  & is_stereo & (zs > 0) & (zs < 1e3))
        a_type = torch.where(anc_ok, a_type, pose_solver.ANCHOR_NONE)
        # all-or-nothing: below min_edges the anchors add bias, not
        # observability
        enough = torch.sum(a_type != pose_solver.ANCHOR_NONE) >= anchor_min_edges
        a_type = torch.where(enough, a_type, pose_solver.ANCHOR_NONE).to(torch.int32)
        anc_xc = torch.stack([(obs[:, 0] - cam.cx) / cam.fx * zs,
                              (obs[:, 1] - cam.cy) / cam.fy * zs, zs], -1)
        zc = torch.clamp(zs, min=1.0)
        a_weight = torch.where(a_type == pose_solver.ANCHOR_DEG,
                               anchor_lambda2 * zc * zc, 1.0).to(torch.float32)
        res2 = cuda_pose.optimize_pose_anchored(
            cam, q1, t1, x2, obs, is_stereo, feat_sigma2_inv, has & feat_valid,
            anc_xc.contiguous(), a_mean.contiguous(), a_norm.contiguous(),
            a_sqi.contiguous(), a_type, a_weight, float(anchor_chi2_gate),
        )
        n_anc = res2.num_anchors
    else:
        res2 = cuda_pose.optimize_pose(
            cam, q1, t1, x2, obs, is_stereo, feat_sigma2_inv, has & feat_valid)
        n_anc = torch.zeros((), dtype=torch.int32, device=dev)
    inliers = has & feat_valid & ~res2.is_outlier
    return FusedTrackResult(
        q=res2.q, t=res2.t,
        feat_point=torch.where(has, feat_point, -1),
        feat_from_local=use2,
        is_outlier=res2.is_outlier,
        num_inliers=torch.sum(inliers),
        n_motion_matches=n_motion,
        map_in_view=ok,
        num_anchors=n_anc,
    )
