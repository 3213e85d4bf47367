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

import numpy as np
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


POSE_IMPLS = ("auto", "pallas", "xla")


def pose_solvers(pose_impl: str):
    """(optimize_pose, optimize_pose_anchored) for the JAX package's
    `pose_impl` knob: "auto" the wrappers of the kernels K1/K2 (the kernel
    on a CUDA tensor, the plain version on a CPU tensor); "pallas" the
    kernels only (a CPU tensor raises: a CUDA kernel has no interpret
    mode); "xla" the plain PyTorch solver on any device. Any other name
    raises, where the JAX package falls back silently (ROADMAP queue 3 c)."""
    if pose_impl == "auto":
        return cuda_pose.optimize_pose, cuda_pose.optimize_pose_anchored
    if pose_impl == "xla":
        return pose_solver.optimize_pose, pose_solver.optimize_pose_anchored
    if pose_impl == "pallas":
        return _kernel_only(cuda_pose.optimize_pose), _kernel_only(cuda_pose.optimize_pose_anchored)
    raise ValueError(f"unknown pose_impl {pose_impl!r}; one of {POSE_IMPLS}")


def _kernel_only(solve):
    def launch(cam, q0, t0, x_w, *args, **kw):
        if x_w.device.type != "cuda":
            raise ValueError(f"pose_impl 'pallas' launches the CUDA kernel; the features "
                             f"are on {x_w.device}")
        return solve(cam, q0, t0, x_w, *args, **kw)
    return launch


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
    pose_impl: str = "auto",
) -> FusedTrackResult:
    """One frame's track step; octave tensors are int64, the rest as in
    the JAX `_track_core`. `pose_impl` picks the pose solver
    (`pose_solvers`)."""
    opt_pose, opt_pose_anchored = pose_solvers(pose_impl)
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
    res1 = opt_pose(
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
        res2 = opt_pose_anchored(
            cam, q1, t1, x2, obs, is_stereo, feat_sigma2_inv, has & feat_valid,
            anc_xc.contiguous(), a_mean.contiguous(), a_norm.contiguous(),
            a_sqi.contiguous(), a_type, a_weight, float(anchor_chi2_gate),
        )
        n_anc = res2.num_anchors
    else:
        res2 = opt_pose(
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


# ---------------------------------------------------------------------------
# packed-IO variant: a few whole tables per frame, one output vector
# ---------------------------------------------------------------------------
#
# The current frame's features, the last frame's slot dynamics and the
# local-map snapshot travel as float32 tables; descriptors ride in eight
# float32 lanes of each row as their raw bytes (the host writes them
# through a uint8 view of the table and the step reads them through
# `Tensor.view(torch.uint8)`: no arithmetic touches those lanes). The GMM
# geometry and the pyramid scales are static tables. Every computation is
# `track_core`, so the result equals the unpacked step bit for bit.

CUR_W = 16      # uv(2) ur(1) angle(1) s2i(1) valid(1) octave(1) pad(1) desc(8)
DYN_W = 8       # last_pts(3) q_valid(1) comp(1) pid(1) pad(2)
MAP_W = 24      # pts(3) normal(3) min(1) max(1) valid(1) comp(1) pid(1) pad(5) desc(8)
GMM_W = 16      # mean(3) normal(3) sqrt_info(9) deg(1)
CUR_DESC, MAP_DESC = 8, 16   # first descriptor lane of a `cur` / `map_tab` row


def desc_bits(tab, lane: int):
    """(N, W) float32 table -> (N, 32) uint8 descriptors held as raw bytes
    in lanes lane..lane+7 (a byte view and a byte copy: bit transport)."""
    return tab.contiguous().view(torch.uint8)[:, 4 * lane:4 * lane + 32].contiguous()


def fused_track_step_packed(
    cam: cam_mod.CameraParams,
    scal,            # (16,) f32: q0(4) t0(3) motion_radius(1) local_radius(1)
    cur,             # (F, CUR_W) current frame
    last_cur,        # (F, CUR_W) previous frame's `cur`
    last_dyn,        # (F, DYN_W) last-frame slot dynamics
    map_tab,         # (P, MAP_W) local-map snapshot
    gmm_tab,         # (K, GMM_W) static GMM component geometry
    scale_factors,   # (L,) static pyramid scales
    log_scale_factor: float,
    num_levels: int,
    use_anchors: bool = False,
    map_is_stale: bool = False,
    anchor_lambda2: float = 400.0,
    anchor_chi2_gate: float = 2.56,
    anchor_min_edges: int = 10,
    pose_impl: str = "auto",
):
    """track_core on packed tables. Returns ONE float32 vector
    [q(4) t(3) n_inl n_motion n_anc | feat_point(F) | from_local(F) |
    is_outlier(F) | map_in_view(P)] (ints < 2^24 are exact)."""
    i64 = torch.int64
    q0, t0 = scal[:4], scal[4:7]
    motion_radius, local_radius = scal[7], scal[8]
    last_valid = last_dyn[:, 3] > 0.5
    last_pid = last_dyn[:, 5].to(i64)
    map_valid = map_tab[:, 8] > 0.5
    if map_is_stale:
        # the snapshot predates the last frame's matches: drop map slots
        # whose point a last-frame slot already carries
        carried = (map_tab[:, 10].to(i64)[:, None] == last_pid[None, :]) & last_valid[None, :]
        map_valid = map_valid & ~torch.any(carried, dim=1)

    anc_kw = {}
    if use_anchors:
        gmm_deg = gmm_tab[:, 15] > 0.5

        def slot_tables(comp):
            k = torch.clamp(comp, min=0)
            a_type = torch.where(comp >= 0, torch.where(gmm_deg[k], pose_solver.ANCHOR_DEG,
                                                        pose_solver.ANCHOR_NONDEG),
                                 pose_solver.ANCHOR_NONE)
            return (a_type, gmm_tab[k, 0:3], gmm_tab[k, 3:6],
                    gmm_tab[k, 6:15].reshape(-1, 3, 3))

        lt, lm, ln, ls = slot_tables(last_dyn[:, 4].to(i64))
        mt, mm, mn, msq = slot_tables(map_tab[:, 9].to(i64))
        anc_kw = dict(
            use_anchors=True,
            last_anc_type=lt, last_anc_mean=lm, last_anc_normal=ln, last_anc_sqrt_info=ls,
            map_anc_type=mt, map_anc_mean=mm, map_anc_normal=mn, map_anc_sqrt_info=msq,
            anchor_lambda2=anchor_lambda2, anchor_chi2_gate=anchor_chi2_gate,
            anchor_min_edges=anchor_min_edges,
        )

    r = track_core(
        cam, q0, t0,
        last_dyn[:, 0:3], desc_bits(last_cur, CUR_DESC), last_cur[:, 6].to(i64),
        last_cur[:, 3], last_cur[:, 2], last_valid,
        cur[:, 0:2], cur[:, 2], desc_bits(cur, CUR_DESC), cur[:, 6].to(i64), cur[:, 3],
        cur[:, 5] > 0.5, cur[:, 4].contiguous(),
        map_tab[:, 0:3], desc_bits(map_tab, MAP_DESC), map_tab[:, 3:6], map_tab[:, 6],
        map_tab[:, 7], map_valid,
        scale_factors, log_scale_factor, num_levels,
        motion_radius=motion_radius, local_radius=local_radius, pose_impl=pose_impl,
        **anc_kw,
    )
    f32 = torch.float32
    return torch.cat([
        r.q, r.t,
        torch.stack([r.num_inliers.to(f32), r.n_motion_matches.to(f32),
                     r.num_anchors.to(f32)]),
        r.feat_point.to(f32), r.feat_from_local.to(f32), r.is_outlier.to(f32),
        r.map_in_view.to(f32),
    ])


# ---------------------------------------------------------------------------
# device-chained variant: dispatch frame N+1 without reading frame N back
# ---------------------------------------------------------------------------
#
# The chained step computes all of frame N+1's dispatch inputs on the
# device from frame N's packed output (still unread) and the device-world
# mirror:
#
#   pose chain: the EMA/damped constant-velocity model
#     (system.init_pose_guess);
#   landmark chain: feat_point -> point id through the dyn/map pid
#     columns, positions refreshed from the mirror (BA moves points);
#   temporal points: re-synthesized from the last frame's own stereo
#     depths at its solved pose (tracker._create_temporal_points' rule),
#
# so the host uploads only the new frame's table and reads results
# `pipeline_depth` frames late, in order; all host bookkeeping runs at
# that drain (the reference's bounded-staleness tracking/mapping split,
# gmmloc.cpp:56-59).

TEMP_PID = -2.0   # dyn pid sentinel: the slot holds a synthesized temporal point


def _chain_prep(
    cam: cam_mod.CameraParams,
    prev_out,        # (10+3F+P [+7],) previous packed output (unread)
    prev_cur,        # (F, CUR_W) previous frame's feature table
    prev_dyn,        # (F, DYN_W) previous dispatch's landmark table
    prev_map_tab,    # (P, MAP_W) map table of the previous dispatch
    pose_prev2,      # (7,) pose of frame N-2 (q, t)
    vel,             # (8,) vel_q(4) vel_t(3) has_vel(1)
    pt_pos,          # (MP,3) device-world mirror
    pt_valid,        # (MP,)
    pt_comp,         # (MP,) vetted GMM component per point (-1 none)
    velocity_ema: float,
    velocity_damping: float,
    th_depth: float,
    temp_cap: int,
):
    """Frame N+1's dispatch inputs from frame N's output: (q0, t0, dyn,
    vel_new)."""
    F, P, MP = prev_cur.shape[0], prev_map_tab.shape[0], pt_pos.shape[0]
    dev = prev_cur.device
    q1, t1 = prev_out[0:4], prev_out[4:7]
    fp = prev_out[10:10 + F].to(torch.int64)
    fl = prev_out[10 + F:10 + 2 * F] > 0.5
    outl = prev_out[10 + 2 * F:10 + 3 * F] > 0.5

    # ---- landmark chain (fused_complete's fp -> pid mapping) ------------
    # a slot indexes the map table (P rows) or the dyn table (F rows):
    # each gather is clamped to its own table (the JAX package clamps both
    # through one index, which XLA clips to each table's last row: equal)
    src_pid = torch.where(fl, prev_map_tab[torch.clamp(fp, 0, P - 1), 10],
                          prev_dyn[torch.clamp(fp, 0, F - 1), 5])
    matched = (fp >= 0) & ~outl
    pid = torch.where(matched, src_pid, -1.0)
    pidi = torch.clamp(pid, 0, MP - 1).to(torch.int64)
    has_real = matched & (pid >= 0) & pt_valid[pidi]
    pos = pt_pos[pidi]                                  # refreshed (BA moves points)

    # ---- temporal points (tracker._create_temporal_points' rule) --------
    # depth-sorted prefix up to the first rank where z > th_depth and
    # rank + 1 > cap; created for slots without a persistent landmark
    u, v, ur = prev_cur[:, 0], prev_cur[:, 1], prev_cur[:, 2]
    disp = u - ur
    z = torch.where((ur >= 0) & (disp > 1e-6) & (prev_cur[:, 5] > 0.5),
                    cam.bf / torch.clamp(disp, min=1e-6), -1.0)
    zkey = torch.where(z > 0, z, torch.inf)
    order = torch.argsort(zkey, stable=True)
    ar = torch.arange(F, device=dev)
    rank = torch.empty_like(order).scatter_(0, order, ar)
    zo = zkey[order]
    stop = (zo > th_depth) & (ar + 1 > temp_cap) & torch.isfinite(zo)
    # first True of `stop` (argmax over an int tensor picks the first max)
    n_proc = torch.where(torch.any(stop), torch.argmax(stop.to(torch.int32)) + 1,
                         torch.sum(z > 0))
    sel_temp = (z > 0) & (rank < n_proc) & ~has_real
    R1 = se3.quat_to_matrix(q1)                         # R_cw
    pc = torch.stack([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z, z], -1)
    temp_pos = (pc - t1[None, :]) @ R1                   # R_cw^T (pc - t) = x_w

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    dyn = torch.zeros((F, DYN_W), dtype=torch.float32, device=dev)
    dyn[:, 0:3] = torch.where(has_real[:, None], pos,
                              torch.where(sel_temp[:, None], temp_pos, zero))
    dyn[:, 3] = (has_real | sel_temp).to(torch.float32)
    dyn[:, 4] = torch.where(has_real, pt_comp[pidi], -1.0)
    dyn[:, 5] = torch.where(has_real, pid, torch.where(sel_temp, TEMP_PID, -1.0))

    # ---- velocity model + pose prediction (system.init_pose_guess) ------
    ql_wc, tl_wc = se3.inverse(pose_prev2[0:4], pose_prev2[4:7])
    dq, dt = se3.compose(q1, t1, ql_wc, tl_wc)
    vel_q, vel_t, has_vel = vel[0:4], vel[4:7], vel[7] > 0.5
    a = velocity_ema
    if a < 1.0:
        dq_s = torch.where(torch.dot(vel_q, dq) < 0, -dq, dq)
        dq_e = (1.0 - a) * vel_q + a * dq_s
        dq_e = dq_e / torch.linalg.norm(dq_e)
        dt_e = (1.0 - a) * vel_t + a * dt
        dq = torch.where(has_vel, dq_e, dq)
        dt = torch.where(has_vel, dt_e, dt)
    g = velocity_damping
    if g < 1.0:
        dt = dt * g
        dq = torch.cat([dq[:1], dq[1:] * g])
        dq = dq / torch.linalg.norm(dq)
    vel_new = torch.cat([dq, dt, torch.ones(1, dtype=torch.float32, device=dev)])
    q0, t0 = se3.compose(dq, dt, q1, t1)
    return q0, t0, dyn, vel_new


def fused_track_step_chained(
    cam: cam_mod.CameraParams,
    prev_out, prev_cur, prev_dyn, prev_map_tab, pose_prev2, vel,
    pt_pos, pt_valid, pt_comp,
    cur,             # (F, CUR_W): the only per-frame upload
    map_tab,         # (P, MAP_W) current map table (keyframe-cadence cache)
    gmm_tab, scale_factors,
    log_scale_factor: float,
    num_levels: int,
    use_anchors: bool = False,
    anchor_lambda2: float = 400.0,
    anchor_chi2_gate: float = 2.56,
    anchor_min_edges: int = 10,
    velocity_ema: float = 0.5,
    velocity_damping: float = 1.0,
    th_depth: float = 35.0,
    temp_cap: int = 100,
    motion_radius: float = 7.0,
    local_radius: float = 3.0,
    pose_impl: str = "auto",
):
    """Chained packed track step. Returns (out_ext, dyn, vel, pose_prev):
    out_ext = the packed result + [q_pred(4) t_pred(3)]; dyn and vel feed
    the next chained call and pose_prev (this frame's predecessor pose) is
    its pose_prev2. All four stay on the device."""
    q0, t0, dyn, vel_new = _chain_prep(
        cam, prev_out, prev_cur, prev_dyn, prev_map_tab, pose_prev2, vel,
        pt_pos, pt_valid, pt_comp, velocity_ema, velocity_damping, th_depth, temp_cap)
    radii = torch.zeros(9, dtype=torch.float32, device=cur.device)  # no host copy
    radii[0], radii[1] = motion_radius, local_radius
    scal = torch.cat([q0, t0, radii])
    out = fused_track_step_packed(
        cam, scal, cur, prev_cur, dyn, map_tab, gmm_tab, scale_factors,
        log_scale_factor, num_levels, use_anchors=use_anchors, map_is_stale=True,
        anchor_lambda2=anchor_lambda2, anchor_chi2_gate=anchor_chi2_gate,
        anchor_min_edges=anchor_min_edges, pose_impl=pose_impl)
    return torch.cat([out, q0, t0]), dyn, vel_new, prev_out[0:7]


def unpack_result(out, F: int, P: int):
    """Host unpack of fused_track_step_packed's output vector (numpy) in
    FusedTrackResult's field order."""
    q = out[0:4].astype(np.float64)
    t = out[4:7].astype(np.float64)
    n_inl, n_motion, n_anc = int(out[7]), int(out[8]), int(out[9])
    o = 10
    feat_point = out[o:o + F].astype(np.int32)
    from_local = out[o + F:o + 2 * F] > 0.5
    is_outlier = out[o + 2 * F:o + 3 * F] > 0.5
    in_view = out[o + 3 * F:o + 3 * F + P] > 0.5
    return q, t, feat_point, from_local, is_outlier, n_inl, n_motion, in_view, n_anc
