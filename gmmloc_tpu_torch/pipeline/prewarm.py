"""Take the first-use costs of every shape tier off a measured window.

PyTorch port of `gmmloc_tpu/pipeline/prewarm.py`, with the same tiers and
the same counts. The solvers run at tiered static shapes (the local-BA
window tiers of `localization.py`, the pow2 fusion and point buckets), and
the first call at a tier costs more than the next ones. Eager PyTorch
compiles nothing per shape, but on the card a first call still pays:

  - the kernel library's build (`utils/cuda_build.py`, nvcc) and load;
  - the lazy load of each CUDA module at its first launch, and cuBLAS /
    cuSOLVER handle and workspace set-up;
  - the caching allocator's growth to each tier's peak;
  - the first CUDA-graph capture of each BA stage (`solver/local_ba.py`).

`prewarm(cfg, cam, device)` calls each of those functions once at every
(tier, static argument) combination on zero-filled inputs on `device`.
It touches no state of a live system: it builds its own zero-filled
`MapState` and `DeviceWorld`, releases them (and the BA's graphs) before
it returns, draws no random numbers and starts no timer. The graphs each
BA tier captured are logged and counted in `stats`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SystemConfig
from ..features import matching
from ..geometry import camera as cam_mod
from ..solver import local_ba


def _read(x) -> None:
    """Wait for x's producer by reading one element back."""
    x.reshape(-1)[:1].cpu()


def _dummy_ba_problem(L: int, F_CAP: int, P: int, MO: int, device="cuda"):
    """The JAX package's dummy window: 4 valid cameras, 64 valid points
    with two stereo observations each."""
    C = L + F_CAP
    cam_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (C, 1))
    cam_t = np.zeros((C, 3), np.float32)
    cam_t[:, 0] = np.arange(C) * 0.05
    cam_valid = np.zeros(C, bool)
    cam_valid[: min(4, C)] = True
    pts = np.zeros((P, 3), np.float32)
    pts[:, 2] = 5.0
    pt_valid = np.zeros(P, bool)
    pt_valid[: min(64, P)] = True
    obs_uvr = np.zeros((P, MO, 3), np.float32)
    obs_uvr[..., :2] = 300.0
    obs_valid = np.zeros((P, MO), bool)
    obs_valid[: min(64, P), :2] = True
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
    return local_ba.BAProblem(
        cam_q=t(cam_q), cam_t=t(cam_t), cam_valid=t(cam_valid, torch.bool),
        pts=t(pts), pt_valid=t(pt_valid, torch.bool),
        obs_cam=torch.zeros((P, MO), dtype=torch.int64, device=device),
        obs_uvr=t(obs_uvr), obs_stereo=t(obs_valid, torch.bool),
        obs_sigma2_inv=torch.ones((P, MO), dtype=torch.float32, device=device),
        obs_valid=t(obs_valid, torch.bool),
        str_type=torch.zeros(P, dtype=torch.int64, device=device),
        str_normal=t(np.tile(np.array([0.0, 0, 1], np.float32), (P, 1))),
        str_mean=t(pts), str_sqrt_info=t(np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))),
        prior_q=t(cam_q[0]), prior_t=t(cam_t[0]),
        has_prior=torch.tensor(True, device=device),
    )


def ba_tiers(cfg: SystemConfig):
    caps = cfg.caps
    return [
        (8, 16, 2048),
        (16, 32, 4096),
        (caps.local_ba_kfs, caps.fixed_ba_kfs, caps.local_ba_points),
    ]


def _ba_kw(cfg: SystemConfig) -> dict:
    """The solve arguments `Localization` passes (`_ba_solve_kw`)."""
    lc = cfg.loc
    sig_rot = np.deg2rad(lc.prior_sigma_rot_deg)
    return dict(ba_lambda2=lc.ba_lambda2, tri_str_thresh=lc.tri_str_thresh,
                prior_rot_info=1.0 / sig_rot**2,
                prior_trans_info=1.0 / lc.prior_sigma_trans**2,
                iters1=lc.ba_iters_stage1, iters2=lc.ba_iters_stage2,
                iters3=lc.ba_iters_stage3, term_gain=lc.ba_term_gain,
                schur_impl=lc.ba_schur_impl, linear_solver=lc.ba_linear_solver,
                cg_iters=lc.ba_cg_iters)


class _Captures:
    """The BA graphs captured on this thread while a tier runs (the
    counter is per thread: a live system's mapper thread may capture its
    own meanwhile)."""

    def __init__(self, L, P, stats, log):
        self.L, self.P, self.stats, self.log = L, P, stats, log

    def __enter__(self):
        self.n0 = local_ba.thread_graph_captures()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            n = local_ba.thread_graph_captures() - self.n0
            if self.stats is not None:
                self.stats.setdefault("ba_graph_captures", {})[f"L={self.L} P={self.P}"] = n
            if self.log:
                self.log(f"prewarm ba tier L={self.L} P={self.P}: {n} graph captures")


def prewarm_ba(cfg: SystemConfig, cam: cam_mod.CameraParams, device="cuda", log=None,
               stats=None) -> int:
    """The staged Schur LM solve at every window tier, with the solve
    arguments joint_optimization passes."""
    n = 0
    for (L, F_CAP, P) in ba_tiers(cfg):
        prob = _dummy_ba_problem(L, F_CAP, P, cfg.caps.ba_obs_per_point, device)
        with _Captures(L, P, stats, log):
            res = local_ba.solve_local_ba(cam, prob, n_free=L, **_ba_kw(cfg))
            _read(res.cost)
        n += 1
    return n


def prewarm_fuse(cfg: SystemConfig, device="cuda", tp_tiers=(1, 2, 4, 8, 16),
                 buckets=(256, 512), log=None) -> int:
    """fuse_match_batch over its (pow2 job count, pow2 query bucket) tier
    grid (`Localization._fuse_jobs` shapes)."""
    F = cfg.frame.feat_cap
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
    n = 0
    for TP in tp_tiers:
        for B in buckets:
            m = matching.fuse_match_batch(
                z(TP, B, 2), z(TP, B) - 1.0, z(TP, B, 32, dt=torch.uint8),
                z(TP, B, dt=torch.int64), z(TP, B) + 1.0, z(TP, B, dt=torch.bool),
                z(TP, F, 2), z(TP, F) - 1.0, z(TP, F, 32, dt=torch.uint8),
                z(TP, F, dt=torch.int64), z(TP, F, dt=torch.bool),
                z(cfg.frame.num_levels) + 1.0)
            _read(m)
            n += 1
    if log:
        log(f"prewarm fuse: {n} tier programs")
    return n


def prewarm_point_solvers(cfg: SystemConfig, cam: cam_mod.CameraParams, device="cuda",
                          buckets=(256, 512, 1024, 2048, 4096, 8192), log=None) -> int:
    """optimize_point_stereo / optimize_triangulation at every pow2 bucket
    the association and triangulation paths can hit."""
    from ..solver import point_solver

    loc = cfg.loc
    f32 = dict(dtype=torch.float32, device=device)
    n = 0
    for B in buckets:
        x0 = torch.zeros((B, 3), **f32)
        x0[:, 2] = 5.0
        q = torch.tensor([1.0, 0, 0, 0], **f32).expand(B, 4)
        t = torch.zeros((B, 3), **f32)
        obs = torch.full((B, 3), 300.0, **f32)
        nrm = torch.tensor([0.0, 0, 1], **f32).expand(B, 3)
        ones = torch.ones(B, **f32)
        no = torch.zeros(B, dtype=torch.bool, device=device)
        res = point_solver.optimize_point_stereo(
            cam, x0, q, t, obs, ones, nrm, x0, ones,
            chi2_proj_thresh=loc.chi2_stereo,
            str_chi2_thresh=loc.tri_str_thresh * loc.tri_lambda2,
            iters=loc.point_opt_iters, tri_check_str_chi2=loc.tri_check_str_chi2)
        _read(res.ok)
        out = point_solver.optimize_triangulation(
            cam, x0, q, t, obs, no, ones, q, t, obs, no, ones, nrm, x0,
            tri_lambda2=loc.tri_lambda2, iters=loc.tri_opt_iters)
        _read(out[0])
        n += 2
    if log:
        log(f"prewarm point solvers: {n} bucket programs")
    return n


def _dummy_gmap(cfg: SystemConfig, device="cuda"):
    """Zero-filled GMMMap with the configured pad size (values
    irrelevant)."""
    from ..gmm.mixture import GMMMap

    K = cfg.caps.gmm_components_pad
    NB = cfg.gmm.neighbor_cap
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.eye(3, **f32).expand(K, 3, 3).contiguous()
    no = torch.zeros(K, dtype=torch.bool, device=device)
    return GMMMap(
        means=torch.zeros((K, 3), **f32), covs=eye, cov_inv=eye,
        det=torch.ones(K, **f32), scale=torch.ones((K, 3), **f32), axis=eye,
        normal=torch.tensor([0.0, 0, 1], **f32).expand(K, 3).contiguous(),
        sqrt_info=eye, is_degenerated=no, is_salient=no, valid=no,
        neighbors=torch.full((K, NB), -1, dtype=torch.int64, device=device), host={})


def prewarm_device_world(cfg: SystemConfig, cam: cam_mod.CameraParams, device="cuda",
                         fwd_tiers=(1, 2, 4, 8, 16, 32),
                         fwd_buckets=(256, 512, 1024, 2048), log=None, stats=None) -> int:
    """The device-world gathers (the merged fusion tier grid, the fused
    triangulation, the fused keyframe association, the assemble+solve BA
    tiers) against a zero-filled mirror, released before returning."""
    from ..mapping import ba_assemble
    from ..mapping.association import associate_and_check_kernel
    from ..mapping.device_world import DeviceWorld
    from ..mapping.map_state import MapState
    from ..mapping.tri_kernel import triangulate_kernel

    world = MapState(cfg)
    dv = DeviceWorld(world, device)
    dv.sync()
    dv.prewarm_scatters(pt_buckets=(256, 512, 1024, 2048, 4096, 8192))
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    no = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)  # noqa: E731
    s2i = torch.ones(cfg.frame.num_levels, **f32)
    sf = torch.ones(cfg.frame.num_levels, **f32)
    n = 0
    for TP in fwd_tiers:
        for B in fwd_buckets:
            m = matching.fuse_project_match_gather(
                cam, torch.zeros(TP, **i64), no(TP), torch.zeros((TP, B), **i64),
                no(TP, B), no(TP, B), dv.kf_q, dv.kf_t,
                dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_desc,
                dv.kf_feat_octave, dv.kf_feat_valid,
                dv.pt_pos, dv.pt_normal, dv.pt_min_dist, dv.pt_max_dist,
                dv.pt_desc, dv.pt_valid, s2i, sf, 0.18)
            _read(m)
            n += 1
    F = cfg.frame.feat_cap
    T = 10  # create_map_points' fixed neighbour tier
    gmap = _dummy_gmap(cfg, device)
    lc = cfg.loc
    if lc.fused_tri:
        r = triangulate_kernel(
            cam, 0, torch.zeros(T, **i64), no(T), no(F), no(T, F),
            torch.zeros((T, 3, 3), **f32), torch.zeros((T, 2), **f32), s2i, s2i, sf,
            dv.kf_q, dv.kf_t, dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_desc,
            dv.kf_feat_octave, dv.kf_feat_angle, dv.kf_feat_depth, dv.kf_comp_cand,
            gmap.means, gmap.normal, gmap.is_degenerated,
            m_tri=cfg.caps.tri_match_budget, tri_lambda2=lc.tri_lambda2,
            tri_opt_iters=lc.tri_opt_iters, tri_check_str_chi2=lc.tri_check_str_chi2,
            tri_str_thresh=lc.tri_str_thresh, ratio_factor=1.5 * cfg.frame.scale_factor)
        _read(r[0])
    else:
        m = matching.search_for_triangulation_gather(
            0, torch.zeros(T, **i64), no(F), no(T, F), torch.zeros((T, 3, 3), **f32),
            torch.zeros((T, 2), **f32), s2i, dv.kf_feat_uv, dv.kf_feat_ur,
            dv.kf_feat_desc, dv.kf_feat_octave, dv.kf_feat_angle)
        _read(m)
    n += 1
    if lc.fused_kf_assoc:
        g = cfg.gmm
        r = associate_and_check_kernel(
            gmap, cam, torch.tensor([1.0, 0, 0, 0], **f32), torch.zeros(3, **f32),
            torch.zeros((F, 2), **f32), torch.full((F,), -1.0, **f32),
            torch.zeros(F, **i64), no(F), torch.full((F,), -1.0, **f32), s2i,
            knn=g.assoc_knn, mdist2_thresh=g.assoc_mdist2_thresh,
            view_cos_deg=g.view_cos_deg, cov2d_scale_thresh=g.cov2d_scale_thresh,
            occlusion_bh_thresh=g.occlusion_bh_thresh, tri_lambda2=lc.tri_lambda2,
            chi2_stereo=lc.chi2_stereo, str_chi2_thresh=lc.tri_str_thresh * lc.tri_lambda2,
            chi2_assoc_3d=lc.chi2_assoc_3d, iters=lc.point_opt_iters,
            tri_check_str_chi2=lc.tri_check_str_chi2)
        _read(r[1])
        n += 1
    if lc.ba_device_assembly:
        for (L, F_CAP, P) in ba_tiers(cfg):
            with _Captures(L, P, stats, log):
                res, _, _ = ba_assemble.assemble_and_solve(
                    cam, torch.full((L,), -1, **i64), torch.full((F_CAP,), -1, **i64),
                    torch.full((P,), -1, **i64), torch.full((world.MK,), -1, **i64),
                    False, 0, dv.kf_q, dv.kf_t, dv.kf_feat_uv, dv.kf_feat_ur,
                    dv.kf_feat_octave, dv.pt_pos, dv.pt_obs_kf, dv.pt_obs_feat,
                    dv.pt_acomp, gmap.means, gmap.normal, gmap.sqrt_info,
                    gmap.is_degenerated, s2i,
                    n_free=L, n_cams=L + F_CAP, mo=cfg.caps.ba_obs_per_point,
                    **_ba_kw(cfg))
                _read(res.cost)
            n += 1
    del dv, world, gmap
    if log:
        log(f"prewarm device-world kernels: {n} programs")
    return n


def prewarm_chained(cfg: SystemConfig, cam: cam_mod.CameraParams, device="cuda",
                    log=None) -> int:
    """The device-chained track step (fused_track_step_chained) with the
    arguments fused_dispatch_chained passes, from a fresh chain (the
    prime's output) and from a chained one (7 more values)."""
    from ..mapping.map_state import MapState
    from ..tracking import fused

    tk = cfg.tracking
    if tk.pipeline_depth <= 1 or not tk.fused_packed_io:
        return 0
    pyr = MapState(cfg).pyr
    MP = cfg.caps.max_points
    F = cfg.frame.feat_cap
    P = tk.fused_local_map_cap
    f32 = dict(dtype=torch.float32, device=device)
    cur0 = torch.zeros((F, fused.CUR_W), **f32)
    dyn0 = torch.zeros((F, fused.DYN_W), **f32)
    map0 = torch.zeros((P, fused.MAP_W), **f32)
    gmm0 = torch.zeros((cfg.caps.gmm_components_pad, fused.GMM_W), **f32)
    kw = dict(
        use_anchors=tk.use_gmm_pose_anchor,
        anchor_lambda2=float(tk.anchor_lambda2),
        anchor_chi2_gate=float(tk.anchor_chi2_gate),
        anchor_min_edges=int(tk.anchor_min_edges),
        velocity_ema=float(tk.velocity_ema),
        velocity_damping=float(tk.velocity_damping),
        th_depth=float(pyr["th_depth"]),
        temp_cap=int(tk.temporal_points_cap),
        motion_radius=float(tk.motion_search_radius),
        local_radius=float(tk.local_search_radius),
        pose_impl=tk.pose_impl,
    )
    n = 0
    for out in (torch.zeros(10 + 3 * F + P, **f32), torch.zeros(10 + 3 * F + P + 7, **f32)):
        r = fused.fused_track_step_chained(
            cam, out, cur0, dyn0, map0, torch.zeros(7, **f32), torch.zeros(8, **f32),
            torch.zeros((MP, 3), **f32), torch.zeros(MP, dtype=torch.bool, device=device),
            torch.full((MP,), -1.0, **f32), cur0, map0, gmm0,
            torch.ones(cfg.frame.num_levels, **f32), float(pyr["log_scale_factor"]),
            cfg.frame.num_levels, **kw)
        _read(r[0])
        n += 1
    if log:
        log(f"prewarm chained track step: {n} programs")
    return n


def prewarm(cfg: SystemConfig, cam: cam_mod.CameraParams, device="cuda", log=None,
            stats=None) -> int:
    """Warm the tier grid a long run can hit after its opening frames.
    Returns the number of (tier, static argument) calls, as the JAX
    package's `prewarm` counts its programs; `stats` (a dict) receives
    the graphs each BA tier captured (`ba_graph_captures`)."""
    from ..utils.device import resolve

    device = resolve(device)
    if device.type == "cuda":
        from ..utils import cuda_build

        cuda_build.load()
    n = 0
    if not (cfg.loc.use_device_world and cfg.loc.ba_device_assembly):
        # solve-only tiers; with device assembly the assemble+solve tiers
        # (prewarm_device_world) cover them
        n += prewarm_ba(cfg, cam, device, log=log, stats=stats)
    if cfg.loc.use_device_world:
        n += prewarm_device_world(cfg, cam, device, log=log, stats=stats)
    else:
        n += prewarm_fuse(cfg, device, log=log)
    n += prewarm_point_solvers(cfg, cam, device, log=log)
    n += prewarm_chained(cfg, cam, device, log=log)
    return n
