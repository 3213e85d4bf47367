"""Local-BA problem assembly on the card, from the DeviceWorld mirror.

PyTorch port of `gmmloc_tpu/mapping/ba_assemble.py` (ref the g2o
graph-building loop of Localization::jointOptimization,
localization_opt.cpp:456-560). The mirror already holds every input, so
the host uploads only the window's slot lists; the observation tables,
camera blocks and structure factors are gathered on the card and handed
to `solver/local_ba.solve_local_ba` (the same Schur path and bf16 staging
rule as the host-assembled branch).
"""

from __future__ import annotations

import torch

from ..geometry import camera as cam_mod
from ..solver import local_ba


def assemble_problem(
    local_kfs,        # (L,) int64 keyframe ids, -1 padded
    fixed_kfs,        # (F_CAP,) int64, -1 padded
    pts_ids,          # (P,) int64 point ids, -1 padded
    slot_lut,         # (MK,) int64 kf id -> camera slot (-1 outside the window)
    has_prior: bool,
    first_kf: int,
    kf_q, kf_t, kf_feat_uv, kf_feat_ur, kf_feat_octave,
    pt_pos, pt_obs_kf, pt_obs_feat, pt_acomp,
    g_means, g_normal, g_sqrt_info, g_deg,
    sigma2_inv_tab,
    *,
    n_free: int,
    n_cams: int,
    mo: int,
    weak_obs_thresh: int = 10,
):
    """The BAProblem of the window. Returns (prob, obs_kfid (P,mo),
    n_obs_pt (P,)). Same stable compaction order, weak-KF demotion and
    structure-factor selection as the host assembly."""
    L, C = n_free, n_cams
    dev = pt_pos.device
    f32 = torch.float32

    # ---- camera slots ----------------------------------------------------
    slots = torch.cat([local_kfs[:L], fixed_kfs[:C - L]])
    slot_ok = slots >= 0
    safe_slots = torch.clamp(slots, min=0)
    ident = torch.tensor([1.0, 0, 0, 0], dtype=f32, device=dev)
    cam_q = torch.where(slot_ok[:, None], kf_q[safe_slots], ident)
    cam_t = torch.where(slot_ok[:, None], kf_t[safe_slots], 0.0)

    # ---- per-point observation compaction (stable, first-mo columns) ----
    pt_ok = pts_ids >= 0
    safe_p = torch.clamp(pts_ids, min=0)
    okf = pt_obs_kf[safe_p].to(torch.int64)                     # (P, MO_world)
    oft = pt_obs_feat[safe_p].to(torch.int64)
    oslot = torch.where(okf >= 0, slot_lut[torch.clamp(okf, min=0)], -1)
    use = (okf >= 0) & (oslot >= 0) & pt_ok[:, None]
    order = torch.argsort((~use).to(torch.int8), dim=1, stable=True)[:, :mo]
    use_c = torch.gather(use, 1, order)
    okf_c = torch.where(use_c, torch.gather(okf, 1, order), 0)
    oft_c = torch.where(use_c, torch.gather(oft, 1, order), 0)
    obs_cam = torch.where(use_c, torch.gather(oslot, 1, order), -1)
    uv = kf_feat_uv[okf_c, oft_c]                                # (P, mo, 2)
    urr = kf_feat_ur[okf_c, oft_c]
    obs_st = use_c & (urr >= 0)
    obs_s2i = torch.where(use_c, sigma2_inv_tab[kf_feat_octave[okf_c, oft_c]], 1.0)
    obs_kfid = torch.where(use_c, okf_c, -1)
    n_obs_pt = torch.sum(use_c, dim=1)

    # ---- weak-KF demotion (obs per local slot < thresh -> held fixed) ---
    onehot = (obs_cam[..., None] == torch.arange(C, device=dev)) & use_c[..., None]
    obs_per_cam = torch.sum(onehot, dim=(0, 1))
    weak = (torch.arange(C, device=dev) < L) & slot_ok & (obs_per_cam < weak_obs_thresh)
    if has_prior:
        weak[0] = False  # the prior-anchored first KF stays free
    cam_valid = slot_ok & ~weak

    # ---- structure factors ----------------------------------------------
    comp = torch.where(pt_ok, pt_acomp[safe_p].to(torch.int64), -1)
    has_c = comp >= 0
    cs = torch.clamp(comp, min=0)
    is_deg = has_c & g_deg[cs]
    is_nd = has_c & ~g_deg[cs]
    str_type = torch.where(is_deg, local_ba.STR_DEG,
                           torch.where(is_nd, local_ba.STR_NONDEG, 0))
    z_axis = torch.tensor([0.0, 0, 1], dtype=f32, device=dev)
    str_normal = torch.where(is_deg[:, None], g_normal[cs].to(f32), z_axis)
    str_mean = torch.where(has_c[:, None], g_means[cs].to(f32), 0.0)
    str_sqrt = torch.where(is_nd[:, None, None], g_sqrt_info[cs].to(f32),
                           torch.eye(3, dtype=f32, device=dev))

    fk = max(first_kf, 0)
    prob = local_ba.BAProblem(
        cam_q=cam_q, cam_t=cam_t, cam_valid=cam_valid,
        pts=torch.where(pt_ok[:, None], pt_pos[safe_p], 0.0),
        pt_valid=pt_ok,
        obs_cam=obs_cam,
        obs_uvr=torch.cat([uv, urr[..., None]], -1),
        obs_stereo=obs_st,
        obs_sigma2_inv=obs_s2i,
        obs_valid=use_c,
        str_type=str_type,
        str_normal=str_normal,
        str_mean=str_mean,
        str_sqrt_info=str_sqrt,
        prior_q=kf_q[fk],
        prior_t=kf_t[fk],
        has_prior=torch.tensor(bool(has_prior), device=dev),
    )
    return prob, obs_kfid, n_obs_pt


def assemble_and_solve(cam: cam_mod.CameraParams, *tables, n_free: int, n_cams: int,
                       mo: int, weak_obs_thresh: int = 10, **solve_kw):
    """assemble_problem on the mirror, then the staged local BA on it.
    `tables` are assemble_problem's positional arguments; `solve_kw` go to
    solve_local_ba. Returns (BAResult, obs_kfid, n_obs_pt)."""
    prob, obs_kfid, n_obs_pt = assemble_problem(
        *tables, n_free=n_free, n_cams=n_cams, mo=mo, weak_obs_thresh=weak_obs_thresh)
    res = local_ba.solve_local_ba(cam, prob, n_free=n_free, **solve_kw)
    return res, obs_kfid, n_obs_pt
