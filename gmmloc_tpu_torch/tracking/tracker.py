"""Per-frame tracking front-end.

PyTorch port of `gmmloc_tpu/tracking/tracker.py`. `fused_dispatch`
uploads the last-frame set, the current features and the local-map
snapshot and enqueues one fused track step (kernels K3, K1, K2 on the
card) without waiting: `fused.track_core` on separate tensors, or with
`TrackingConfig.fused_packed_io` (the default) `fused_track_step_packed`
on three float32 tables and static GMM/scale tables.
`fused_dispatch_chained` enqueues the next frame from the previous
dispatch's device state alone (`fused_track_step_chained`: the pose and
landmark chains and the temporal points computed on the device).
`fused_complete` reads a result back and does the host bookkeeping. A
frame that under-matches falls into the classic path (tracking.cpp
track:35-116): updateLastFrame -> createTemporalPoints ->
trackWithMotionModel [-> trackKeyFrame] -> updateLocalMap ->
searchLocalPoints -> trackLocalMap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..mapping.map_state import MapState, _inverse, _quat_to_mat
from .frame import Frame
from ..utils.timing import Timer

from ..config import SystemConfig
from ..features import matching
from ..geometry import camera as cam_mod
from ..solver import cuda_pose, pose_solver
from . import fused


@dataclass
class TrackStat:
    """Ref tracking.h:16-21."""

    res: bool = False
    num_match_inliers: int = 0
    ratio_map: float = 0.0


class Readback:
    """A packed result vector on its way to the host. On the card the copy
    into pinned memory is enqueued right behind the step that produces it
    and an event marks its end, so reading it waits for that step only,
    not for the frames enqueued after it."""

    def __init__(self, x):
        self.event = None
        if x.device.type == "cuda":
            self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.host.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(x.device))
        else:
            self.host = x

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


@dataclass
class FusedPending:
    """A dispatched fused track step: the device result (not yet read) and
    what fused_complete needs for the bookkeeping."""

    frame: Frame
    result: object        # FusedTrackResult, or a Readback of the packed vector
    lp: np.ndarray        # local-map point ids aligned with kernel slots
    n_lp: int
    q_pred: Optional[np.ndarray]  # constant-velocity prediction (plausibility
    t_pred: Optional[np.ndarray]  # gate); chained: read from the result
    packed: bool = False
    chained: bool = False   # the last-frame prep runs at drain time


class Tracker:
    def __init__(self, cfg: SystemConfig, cam: cam_mod.CameraParams,
                 world: MapState, device, gmm_views: Optional[dict] = None):
        fused.pose_solvers(cfg.tracking.pose_impl)     # an unknown name raises
        self.cfg = cfg
        self.cam = cam
        self.world = world
        self.device = torch.device(device)
        self.gmm_views = gmm_views
        self.last_frame: Optional[Frame] = None
        self.ref_keyframe: int = -1
        self.local_keyframes: List[int] = []
        self.local_points: np.ndarray = np.zeros(0, np.int64)
        self.temp_points: List[int] = []
        self.stat = TrackStat()
        self.dbg: dict = {}
        self._coast_streak = 0
        pyr = world.pyr
        self.scale_factors = pyr["scale_factors"]
        self.sigma2_inv = pyr["sigma2_inv"]
        self.th_depth = pyr["th_depth"]
        self.log_sf = pyr["log_scale_factor"]
        self.num_levels = cfg.frame.num_levels
        self._scales_dev = self._t(self.scale_factors)
        # packed path: static tables and the keyframe-cadence map table
        self._dev: dict = {}
        # device-chained state: the last dispatch's device tensors (None =
        # not primed)
        self._chain: Optional[dict] = None
        self.dev_world = None      # the localizer's mirror, set by the system
        self.host_vel = None       # (vel_q, vel_t), set by the system at a prime
        self.n_chained = 0         # chained dispatches

    def _t(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _upload(self, a: np.ndarray):
        """A float32 host table on the device without waiting: on the card
        through pinned memory and a copy enqueued on the current stream (a
        copy from pageable memory would wait for every queued frame)."""
        x = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        if self.device.type != "cuda":
            return x
        return x.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------------------

    def initialize(self, frame: Frame) -> None:
        self.last_frame = frame
        self.ref_keyframe = frame.ref_kf
        self.local_keyframes = [frame.ref_kf]

    def track(self, frame: Frame) -> TrackStat:
        self.invalidate_chain()  # a synchronous frame: the device chain is stale
        if self.cfg.tracking.use_fused_track:
            pend = self.fused_dispatch(frame)
            st = self.fused_complete(pend) if pend is not None else None
            if st is not None:
                return st
            # the fused dispatch already ran the last-frame prep
            return self._track_classic(frame, prep=False)
        return self._track_classic(frame)

    def track_classic_fallback(self, frame: Frame) -> TrackStat:
        """Classic path for a frame whose fused dispatch under-matched
        (its last-frame prep already ran)."""
        self.invalidate_chain()
        return self._track_classic(frame, prep=False)

    def _track_classic(self, frame: Frame, prep: bool = True) -> TrackStat:
        if prep:
            self._update_last_frame()
            if not self.last_frame.is_keyframe:
                self._create_temporal_points()
        self.stat = TrackStat(res=True)
        self.dbg = {"path": "classic"}
        with Timer("track/motion"):
            n = self._track_with_motion_model(frame)
        self.dbg["n_after_motion"] = n
        if n < self.cfg.tracking.min_matches_track:
            n = self._track_keyframe(frame)
            self.dbg["used_kf_fallback"] = True
            self.dbg["n_after_kf"] = n
            if n < self.cfg.tracking.min_matches_track:
                self.stat.res = False
                self.stat.num_match_inliers = 10
                self._cleanup(frame)
                return self.stat
        frame.ref_kf = self.ref_keyframe
        with Timer("track/local"):
            self._update_local_map(frame)
            self._search_local_points(frame)
            self.stat.num_match_inliers = self._track_local_map(frame)
        sel = frame.mappoint[frame.mappoint >= 0]
        self.dbg["n_gmm_inliers"] = int((self.world.pt_assoc_comp[sel] >= 0).sum())
        self._plausibility_gate(frame)
        self.stat.ratio_map = self._ratio_map(frame)
        self._cleanup(frame)
        self.last_frame = frame
        return self.stat

    def _ratio_map(self, frame: Frame) -> float:
        """Map-coverage ratio over near-depth features (tracking.cpp:86-103)."""
        w = self.world
        near = (frame.depth > 0) & (frame.depth < self.th_depth) & frame.valid
        sel = near & (frame.mappoint >= 0)
        num_map = int((w.pt_n_obs[frame.mappoint[sel]] > 0).sum())
        return num_map / max(1, int(near.sum()))

    # ------------------------------------------------------------------

    def _update_last_frame(self) -> None:
        """Swap replaced mappoints (tracking.cpp:397-408)."""
        w = self.world
        fr = self.last_frame
        idx = np.where(fr.mappoint >= 0)[0]
        if len(idx):
            pts = fr.mappoint[idx].copy()
            rep = w.pt_replaced_by[pts]
            for _ in range(4):
                follow = rep >= 0
                if not follow.any():
                    break
                pts[follow] = rep[follow]
                rep = w.pt_replaced_by[pts]
            pts[~w.pt_valid[pts]] = -1
            fr.mappoint[idx] = pts

    def _create_temporal_points(self) -> None:
        """Short-lived stereo landmarks from the last frame
        (tracking.cpp:411-470): nearest depth first, up to 100 near points."""
        f = self.last_frame
        w = self.world
        zs = f.depth.copy()
        zs[~f.valid] = -1
        order = np.argsort(np.where(zs > 0, zs, np.inf))
        zo = zs[order]
        n_good = int(((zo > 0) & np.isfinite(zo)).sum())
        if n_good == 0:
            return
        cap = self.cfg.tracking.temporal_points_cap
        stop = (zo[:n_good] > self.th_depth) & (np.arange(1, n_good + 1) > cap)
        n_proc = int(np.argmax(stop)) + 1 if stop.any() else n_good
        sel = order[:n_proc]
        p = f.mappoint[sel]
        create = (p < 0) | (w.pt_n_obs[np.maximum(p, 0)] < 1)
        ci = sel[create]
        if len(ci) == 0:
            return
        q_wc, t_wc = _inverse(f.q_cw, f.t_cw)
        z = zs[ci]
        pc = np.stack([(f.uv[ci, 0] - self.cam.cx) / self.cam.fx * z,
                       (f.uv[ci, 1] - self.cam.cy) / self.cam.fy * z, z], -1)
        pw = pc @ _quat_to_mat(q_wc).T + t_wc
        for j, i in enumerate(ci):
            pid = w.alloc_point(pw[j], ref_kf=-1, created_kf_idx=-1)
            f.mappoint[i] = pid
            self.temp_points.append(pid)

    # ------------------------------------------------------------------

    def _project_points(self, frame: Frame, pts_pos):
        R = _quat_to_mat(frame.q_cw)
        pc = pts_pos @ R.T + frame.t_cw
        z = pc[:, 2]
        z_safe = np.where(np.abs(z) < 1e-9, 1e-9, z)
        u = self.cam.fx * pc[:, 0] / z_safe + self.cam.cx
        v = self.cam.fy * pc[:, 1] / z_safe + self.cam.cy
        ur = u - self.cam.bf / z_safe
        inside = (z > 0) & (u >= 0) & (v >= 0) & (u < self.cam.width) & (v < self.cam.height)
        return np.stack([u, v], -1), ur, z, inside

    def _frame_tensors(self, frame: Frame):
        t = self._t
        return (t(frame.uv), t(frame.ur), t(frame.desc, torch.uint8),
                t(frame.octave, torch.int64), t(frame.angle), t(frame.valid, torch.bool))

    def _run_pose_opt(self, frame: Frame, anchored: bool = False) -> int:
        w = self.world
        has_pt = frame.mappoint >= 0
        idx = np.where(has_pt)[0]
        x_w = np.zeros((frame.feat_cap, 3), np.float32)
        if len(idx):
            x_w[idx] = w.pt_pos[frame.mappoint[idx]]
        obs_uvr = np.concatenate([frame.uv, frame.ur[:, None]], -1)
        t = self._t
        base = (self.cam, t(frame.q_cw), t(frame.t_cw), t(x_w), t(obs_uvr),
                t(frame.ur >= 0, torch.bool), t(self.sigma2_inv[frame.octave]),
                t(has_pt & frame.valid, torch.bool))
        rounds, iters = self.cfg.loc.pose_opt_rounds, self.cfg.loc.pose_opt_iters
        anc = self._gather_anchors(frame) if anchored else None
        if anc is not None:
            res = cuda_pose.optimize_pose_anchored(
                *base, *anc, float(self.cfg.tracking.anchor_chi2_gate),
                rounds=rounds, iters=iters)
            self.dbg["n_anchors"] = int(res.num_anchors)
        else:
            res = cuda_pose.optimize_pose(*base, rounds=rounds, iters=iters)
        frame.set_pose(res.q.cpu().numpy().astype(np.float64),
                       res.t.cpu().numpy().astype(np.float64))
        frame.is_outlier = res.is_outlier.cpu().numpy().copy()
        return int(res.num_inliers)

    def _gather_anchors(self, frame: Frame):
        """Per-frame GMM structure anchors of the tracked features whose
        point has a vetted association and a stereo depth this frame."""
        gv = self.gmm_views
        if gv is None or not self.cfg.tracking.use_gmm_pose_anchor:
            return None
        w = self.world
        p = frame.mappoint
        ok = (p >= 0) & frame.valid & (frame.depth > 0)
        pc_ = np.clip(p, 0, None)
        comp = np.where(ok & w.pt_assoc_vetted[pc_], w.pt_assoc_comp[pc_], -1)
        ok &= comp >= 0
        if int(ok.sum()) < self.cfg.tracking.anchor_min_edges:
            return None
        k = np.maximum(comp, 0)
        z = np.where(ok, frame.depth, 1.0)
        xc = np.stack([(frame.uv[:, 0] - self.cam.cx) / self.cam.fx * z,
                       (frame.uv[:, 1] - self.cam.cy) / self.cam.fy * z, z], -1)
        deg = gv["is_degenerated"][k]
        anc_type = np.where(ok, np.where(deg, pose_solver.ANCHOR_DEG,
                                         pose_solver.ANCHOR_NONDEG), 0)
        zc = np.maximum(z, 1.0)
        weight = np.where(deg, self.cfg.tracking.anchor_lambda2 * zc * zc, 1.0)
        t = self._t
        return (t(xc), t(gv["means"][k]), t(gv["normal"][k]), t(gv["sqrt_info"][k]),
                t(anc_type, torch.int32), t(weight))

    def _plausibility_gate(self, frame: Frame) -> None:
        """Coast on the prediction for a solved pose beyond the physical
        per-frame motion limits (TrackingConfig.max_jump_*), at most
        max_coast_frames in a row."""
        qp = self.dbg.get("q_pred")
        tp = self.dbg.get("t_pred")
        if qp is None:
            return
        cfg = self.cfg.tracking
        _, c_pred = _inverse(qp, tp)
        _, c_post = _inverse(frame.q_cw, frame.t_cw)
        dt = float(np.linalg.norm(c_post - c_pred))
        dq = abs(float(np.dot(qp, frame.q_cw)))
        drot = float(np.degrees(2 * np.arccos(min(1.0, dq))))
        if (dt > cfg.max_jump_trans or drot > cfg.max_jump_rot_deg) and (
                self._coast_streak < cfg.max_coast_frames):
            frame.set_pose(qp, tp)
            self.dbg["coasted"] = True
            self._coast_streak += 1
        else:
            self._coast_streak = 0

    def _discard_outliers(self, frame: Frame) -> int:
        """Post-solve outlier stripping (tracking.cpp:355-377)."""
        w = self.world
        has = (frame.mappoint >= 0) & frame.valid
        out = has & frame.is_outlier
        w.pt_last_visible_idx[frame.mappoint[out]] = frame.idx
        frame.mappoint[out] = -1
        frame.is_outlier[out] = False
        good = has & ~out
        return int((w.pt_n_obs[frame.mappoint[good]] > 0).sum())

    def _track_with_motion_model(self, frame: Frame) -> int:
        """tracking.cpp:334-393."""
        w = self.world
        th = self.cfg.tracking.motion_search_radius
        n = self._search_frame_to_frame(frame, th)
        self.dbg["n_motion_match"] = n
        if n < self.cfg.tracking.min_matches_motion:
            frame.mappoint[:] = -1
            n = self._search_frame_to_frame(frame, 2 * th)
            self.dbg["used_wide_retry"] = True
            self.dbg["n_motion_match"] = n
        if n < self.cfg.tracking.min_matches_motion:
            return 0
        m = frame.mappoint[frame.mappoint >= 0]
        self.dbg["n_tmp_edges"] = int((w.pt_n_obs[m] < 1).sum())
        self.dbg["n_per_edges"] = int((w.pt_n_obs[m] >= 1).sum())
        self.dbg["q_pred"] = frame.q_cw.copy()
        self.dbg["t_pred"] = frame.t_cw.copy()
        self._run_pose_opt(frame, anchored=True)
        return self._discard_outliers(frame)

    def _search_frame_to_frame(self, frame: Frame, th: float) -> int:
        """Guided search from last-frame landmarks (orb_matcher.cpp:410-542)."""
        last = self.last_frame
        w = self.world
        q_has = (last.mappoint >= 0) & last.valid & ~last.is_outlier
        sel = np.where(q_has)[0]
        if len(sel) == 0:
            return 0
        pts = np.zeros((last.feat_cap, 3))
        ids = last.mappoint.copy()
        pts[sel] = w.pt_pos[ids[sel]]
        uv, ur, _, inside = self._project_points(frame, pts)
        octave = last.octave
        t = self._t
        match, _ = matching.search_by_projection(
            t(uv), t(np.where(last.ur >= 0, ur, -1.0)), t(last.desc, torch.uint8),
            t(octave, torch.int64), t(last.angle), t(q_has & inside, torch.bool),
            t(th * self.scale_factors[octave]), t(octave - 1, torch.int64),
            t(octave + 1, torch.int64), *self._frame_tensors(frame),
            t(frame.mappoint >= 0, torch.bool),
            desc_thresh=matching.TH_HIGH, nn_ratio=1.0, use_rotation=True,
        )
        match = match.cpu().numpy()
        qi = np.where(match >= 0)[0]
        frame.mappoint[match[qi]] = ids[qi]
        return len(qi)

    def _track_keyframe(self, frame: Frame) -> int:
        """Re-track against the reference KF (tracking.cpp:297-332) with
        mutual-best Hamming matching in place of searchByBoW."""
        w = self.world
        kf = self.ref_keyframe
        frame.mappoint[:] = -1
        t = self._t
        match, _ = matching.mutual_best_match(
            t(frame.desc, torch.uint8), t(frame.valid, torch.bool),
            t(w.kf_feat_desc[kf], torch.uint8),
            t(w.kf_feat_valid[kf] & (w.kf_obs_point[kf] >= 0), torch.bool),
            max_dist=matching.TH_LOW)
        match = match.cpu().numpy()
        mi = np.where(match >= 0)[0]
        p = w.kf_obs_point[kf, match[mi]]
        ok = (p >= 0) & w.pt_valid[np.maximum(p, 0)]
        frame.mappoint[mi[ok]] = p[ok]
        if int(ok.sum()) < 15:
            return 0
        frame.set_pose(self.last_frame.q_cw, self.last_frame.t_cw)
        self._run_pose_opt(frame, anchored=True)
        return self._discard_outliers(frame)

    # ------------------------------------------------------------------

    def _update_local_map(self, frame: Frame) -> None:
        """tracking.cpp:119-207: reference KF = most-shared KF; local KFs
        and points from the frame's matches."""
        w = self.world
        idx = np.where(frame.mappoint >= 0)[0]
        if len(idx) == 0:
            return
        pts = frame.mappoint[idx]
        bad = ~w.pt_valid[pts]
        if bad.any():
            frame.mappoint[idx[bad]] = -1
            pts = pts[~bad]
        if len(pts) == 0:
            return
        okf = w.pt_obs_kf[pts].ravel()
        okf = okf[okf >= 0]
        if len(okf) == 0:
            return
        counts = np.bincount(okf, minlength=w.MK)
        counts[~w.kf_valid] = 0
        kf_max = int(np.argmax(counts))
        if counts[kf_max] == 0:
            return
        local = np.where(counts > 0)[0]
        self.ref_keyframe = kf_max
        frame.ref_kf = kf_max
        self.local_keyframes = local.tolist()
        obs = w.kf_obs_point[local].ravel()
        pts_u = np.unique(obs[obs >= 0])
        self.local_points = pts_u[w.pt_valid[pts_u]].astype(np.int64)

    def _check_scale_and_visible(self, frame: Frame, pids):
        """mappoint.cpp:257-299 gates. Returns (ok, pred_level)."""
        w = self.world
        _, t_wc = _inverse(frame.q_cw, frame.t_cw)
        v = w.pt_pos[pids] - t_wc
        dist = np.linalg.norm(v, axis=-1)
        ok = (dist >= 0.8 * w.pt_min_dist[pids]) & (dist <= 1.2 * w.pt_max_dist[pids]) & (
            dist > 1e-9)
        ok &= np.einsum("ni,ni->n", v, w.pt_normal[pids]) / np.clip(dist, 1e-9, None) >= 0.5
        ratio = w.pt_max_dist[pids] / np.clip(dist, 1e-9, None)
        lvl = np.ceil(np.log(np.clip(ratio, 1e-9, None)) / self.log_sf).astype(np.int32)
        return ok, np.clip(lvl, 0, self.num_levels - 1)

    def _search_local_points(self, frame: Frame) -> None:
        """tracking.cpp:210-267."""
        w = self.world
        for i in np.where(frame.mappoint >= 0)[0]:
            p = frame.mappoint[i]
            if not w.pt_valid[p]:
                frame.mappoint[i] = -1
            else:
                w.pt_num_visible[p] += 1
                w.pt_last_visible_idx[p] = frame.idx
        if len(self.local_points) == 0:
            return
        cand = self.local_points[w.pt_last_visible_idx[self.local_points] != frame.idx]
        if len(cand) == 0:
            return
        uv, ur, _, inside = self._project_points(frame, w.pt_pos[cand])
        ok, lvl = self._check_scale_and_visible(frame, cand)
        ok &= inside
        cand = cand[ok]
        if len(cand) == 0:
            return
        uv, ur, lvl = uv[ok], ur[ok], lvl[ok]
        w.pt_num_visible[cand] += 1
        th = 5.0 if frame.idx < 2 else self.cfg.tracking.local_search_radius
        radius = th * self.scale_factors[lvl]
        N = self.cfg.frame.feat_cap
        if len(cand) > N:
            cand, uv, ur, lvl, radius = cand[:N], uv[:N], ur[:N], lvl[:N], radius[:N]

        def padded(a, fill, dtype):
            out = np.full((N,) + np.asarray(a).shape[1:], fill, dtype)
            out[: len(cand)] = a
            return out

        t = self._t
        match, _ = matching.search_by_projection(
            t(padded(uv, 0.0, np.float32)), t(padded(ur, -1.0, np.float32)),
            t(padded(w.pt_desc[cand], 0, np.uint8), torch.uint8),
            t(padded(lvl, 0, np.int64), torch.int64),
            torch.zeros(N, dtype=torch.float32, device=self.device),
            t(padded(np.ones(len(cand), bool), False, bool), torch.bool),
            t(padded(radius, 1.0, np.float32)),
            t(padded(lvl - 1, 0, np.int64), torch.int64),
            t(padded(lvl, 0, np.int64), torch.int64),
            *self._frame_tensors(frame), t(frame.mappoint >= 0, torch.bool),
            desc_thresh=matching.TH_HIGH, nn_ratio=self.cfg.loc.match_nn_ratio_local,
            use_rotation=False,
        )
        match = match.cpu().numpy()
        qi = np.where(match >= 0)[0]
        frame.mappoint[match[qi]] = cand[qi]

    def _track_local_map(self, frame: Frame) -> int:
        """tracking.cpp:269-294 (+ per-frame GMM structure anchors)."""
        w = self.world
        self._run_pose_opt(frame, anchored=True)
        has = (frame.mappoint >= 0) & frame.valid
        inl = has & ~frame.is_outlier
        np.add.at(w.pt_num_found, frame.mappoint[inl], 1)
        num_inliers = int((w.pt_n_obs[frame.mappoint[inl]] > 0).sum())
        frame.mappoint[has & frame.is_outlier] = -1
        return num_inliers

    def _cleanup(self, frame: Frame) -> None:
        """clearTemporalPoints (tracking.cpp:379-395)."""
        w = self.world
        has = frame.mappoint >= 0
        tmp = has.copy()
        tmp[has] = w.pt_n_obs[frame.mappoint[has]] < 1
        frame.is_outlier[tmp] = False
        frame.mappoint[tmp] = -1
        for p in self.temp_points:
            if w.pt_valid[p] and w.pt_n_obs[p] < 1:
                w.remove_point(p)
        self.temp_points.clear()

    # ------------------------------------------------------------------
    # fused path (tracking/fused.py)
    # ------------------------------------------------------------------

    def _anc_tables(self, point_ids, n_slots):
        """Slot-aligned GMM anchor tables (vetted associations only)."""
        gv = self.gmm_views
        typ = np.zeros(n_slots, np.int32)
        mean = np.zeros((n_slots, 3), np.float32)
        norm = np.zeros((n_slots, 3), np.float32)
        sqi = np.zeros((n_slots, 3, 3), np.float32)
        n = len(point_ids)
        if n:
            comp = self._vetted_comp(np.asarray(point_ids)).astype(np.int64)
            k = np.maximum(comp, 0)
            deg = gv["is_degenerated"][k]
            typ[:n] = np.where(comp >= 0, np.where(deg, pose_solver.ANCHOR_DEG,
                                                   pose_solver.ANCHOR_NONDEG), 0)
            mean[:n] = gv["means"][k]
            norm[:n] = gv["normal"][k]
            sqi[:n] = gv["sqrt_info"][k]
        t = self._t
        return t(typ, torch.int64), t(mean), t(norm), t(sqi)

    def fused_dispatch(self, frame: Frame,
                       prime_chain: bool = False) -> Optional[FusedPending]:
        """Last-frame prep + one enqueued track step; the read-back waits
        for fused_complete. Returns None to request the classic path (too
        few carried landmarks). prime_chain: record the packed dispatch's
        device tensors as the root of the chain that
        fused_dispatch_chained continues."""
        w = self.world
        tk = self.cfg.tracking
        t_prep = Timer("track/fused_prep").start()
        self._update_last_frame()
        if not self.last_frame.is_keyframe:
            self._create_temporal_points()
        last = self.last_frame
        q_has = (last.mappoint >= 0) & last.valid & ~last.is_outlier
        sel = np.where(q_has)[0]
        if len(sel) < 10:
            t_prep.stop()
            return None
        last_pts = np.zeros((last.feat_cap, 3), np.float32)
        last_pts[sel] = w.pt_pos[last.mappoint[sel]]

        # local-map snapshot without the points the last frame carries; in
        # keyframe-refresh mode the step drops them itself (map_is_stale),
        # since the carried set changes per frame and the table does not
        P = tk.fused_local_map_cap
        kf_mode = tk.fused_packed_io and tk.fused_map_refresh == "kf"
        lp = self.local_points
        lp = lp[w.pt_valid[lp]] if len(lp) else lp
        if len(lp) and not kf_mode:
            lp = lp[~np.isin(lp, last.mappoint[sel])]
        lp = lp[:P]
        n_lp = len(lp)
        if tk.fused_packed_io:
            return self._dispatch_packed(frame, last, q_has, last_pts, lp, t_prep,
                                         prime_chain and kf_mode)
        map_pts = np.zeros((P, 3), np.float32)
        map_desc = np.zeros((P, 32), np.uint8)
        map_normal = np.zeros((P, 3), np.float32)
        map_min = np.zeros(P, np.float32)
        map_max = np.zeros(P, np.float32)
        map_ok = np.zeros(P, bool)
        if n_lp:
            map_pts[:n_lp] = w.pt_pos[lp]
            map_desc[:n_lp] = w.pt_desc[lp]
            map_normal[:n_lp] = w.pt_normal[lp]
            map_min[:n_lp] = w.pt_min_dist[lp]
            map_max[:n_lp] = w.pt_max_dist[lp]
            map_ok[:n_lp] = True

        anc_kw = {}
        if tk.use_gmm_pose_anchor and self.gmm_views is not None:
            la = self._anc_tables(last.mappoint, last.feat_cap)
            ma = self._anc_tables(lp, P)
            anc_kw = dict(
                use_anchors=True,
                last_anc_type=la[0], last_anc_mean=la[1], last_anc_normal=la[2],
                last_anc_sqrt_info=la[3],
                map_anc_type=ma[0], map_anc_mean=ma[1], map_anc_normal=ma[2],
                map_anc_sqrt_info=ma[3],
                anchor_lambda2=float(tk.anchor_lambda2),
                anchor_chi2_gate=float(tk.anchor_chi2_gate),
                anchor_min_edges=int(tk.anchor_min_edges),
            )
        anc_kw["pose_impl"] = tk.pose_impl
        th_local = 5.0 if frame.idx < 2 else tk.local_search_radius
        t = self._t
        t_prep.stop()
        with Timer("track/fused_enqueue"):
            res = fused.track_core(
                self.cam, t(frame.q_cw), t(frame.t_cw),
                t(last_pts), t(last.desc, torch.uint8), t(last.octave, torch.int64),
                t(last.angle), t(last.ur), t(q_has, torch.bool),
                *self._frame_tensors(frame), t(self.sigma2_inv[frame.octave]),
                t(map_pts), t(map_desc, torch.uint8), t(map_normal), t(map_min),
                t(map_max), t(map_ok, torch.bool), self._scales_dev,
                float(self.log_sf), self.num_levels,
                motion_radius=tk.motion_search_radius, local_radius=th_local,
                **anc_kw,
            )
        return FusedPending(frame=frame, result=res, lp=lp, n_lp=n_lp,
                            q_pred=frame.q_cw.copy(), t_pred=frame.t_cw.copy())

    # ---------------- packed and chained paths ---------------------------

    def _pack_frame(self, frame: Frame) -> np.ndarray:
        """The frame's (F, CUR_W) float32 table; the descriptor lanes get
        the raw bytes through a uint8 view."""
        pk = np.zeros((frame.feat_cap, fused.CUR_W), np.float32)
        pk[:, 0:2] = frame.uv
        pk[:, 2] = frame.ur
        pk[:, 3] = frame.angle
        pk[:, 4] = self.sigma2_inv[frame.octave]
        pk[:, 5] = frame.valid
        pk[:, 6] = frame.octave
        b = 4 * fused.CUR_DESC
        pk.view(np.uint8)[:, b:b + 32] = frame.desc
        return pk

    def _dev_cur(self, frame: Frame):
        """The frame's packed table on the device (uploaded at its own
        dispatch; rebuilt here after a classic-path frame)."""
        d = getattr(frame, "_dev_cur", None)
        if d is None:
            d = frame._dev_cur = self._upload(self._pack_frame(frame))
        return d

    def _dev_static(self):
        """(gmm_tab, scales): the static tables, uploaded once."""
        if "gmm_tab" not in self._dev:
            gv = self.gmm_views
            tab = np.zeros((len(gv["means"]) if gv is not None else 1, fused.GMM_W),
                           np.float32)
            if gv is not None:
                tab[:, 0:3] = gv["means"]
                tab[:, 3:6] = gv["normal"]
                tab[:, 6:15] = gv["sqrt_info"].reshape(-1, 9)
                tab[:, 15] = gv["is_degenerated"]
            self._dev["gmm_tab"] = self._upload(tab)
        return self._dev["gmm_tab"], self._scales_dev

    def _vetted_comp(self, pid: np.ndarray) -> np.ndarray:
        """BA-vetted GMM component per point id (-1 where none or not
        vetted), the gate of _gather_anchors and _anc_tables."""
        w = self.world
        pc = np.clip(pid, 0, None)
        return np.where((pid >= 0) & w.pt_assoc_vetted[pc], w.pt_assoc_comp[pc],
                        -1).astype(np.float32)

    def _map_table(self, lp: np.ndarray) -> np.ndarray:
        """The (P, MAP_W) local-map table of point ids lp."""
        w = self.world
        tab = np.zeros((self.cfg.tracking.fused_local_map_cap, fused.MAP_W), np.float32)
        tab[:, 9] = -1.0
        n = len(lp)
        if n:
            tab[:n, 0:3] = w.pt_pos[lp]
            tab[:n, 3:6] = w.pt_normal[lp]
            tab[:n, 6] = w.pt_min_dist[lp]
            tab[:n, 7] = w.pt_max_dist[lp]
            tab[:n, 8] = 1.0
            tab[:n, 9] = self._vetted_comp(lp)
            tab[:n, 10] = lp
            b = 4 * fused.MAP_DESC
            tab.view(np.uint8)[:n, b:b + 32] = w.pt_desc[lp]
        return tab

    def _cached_map(self, lp: np.ndarray, use_cache: bool):
        """(map table on the device, its point ids). Keyframe-refresh mode
        keys the table on MapState.map_version, which every persistent
        map change bumps; the cached ids replace `lp` then."""
        token = self.world.map_version
        if use_cache and self._dev.get("map_token") == token:
            return self._dev["map_dev"], self._dev["map_lp"]
        map_dev = self._upload(self._map_table(lp))
        if use_cache:
            self._dev.update(map_token=token, map_dev=map_dev, map_lp=lp)
        return map_dev, lp

    def _anchor_kw(self) -> dict:
        tk = self.cfg.tracking
        return dict(use_anchors=tk.use_gmm_pose_anchor and self.gmm_views is not None,
                    anchor_lambda2=float(tk.anchor_lambda2),
                    anchor_chi2_gate=float(tk.anchor_chi2_gate),
                    anchor_min_edges=int(tk.anchor_min_edges), pose_impl=tk.pose_impl)

    def _dispatch_packed(self, frame, last, q_has, last_pts, lp, t_prep,
                         prime_chain: bool) -> FusedPending:
        tk = self.cfg.tracking
        F = frame.feat_cap
        scal = np.zeros(16, np.float32)
        scal[0:4] = frame.q_cw
        scal[4:7] = frame.t_cw
        scal[7] = tk.motion_search_radius
        scal[8] = 5.0 if frame.idx < 2 else tk.local_search_radius
        dyn = np.zeros((F, fused.DYN_W), np.float32)
        dyn[:, 0:3] = last_pts
        dyn[:, 3] = q_has
        dyn[:, 4] = self._vetted_comp(last.mappoint)
        dyn[:, 5] = last.mappoint
        kf_mode = tk.fused_map_refresh == "kf"
        map_dev, lp = self._cached_map(lp, kf_mode)
        gmm_tab, scales = self._dev_static()
        last_dev = self._dev_cur(last)
        cur_dev = frame._dev_cur = self._upload(self._pack_frame(frame))
        dyn_dev = self._upload(dyn)
        scal_dev = self._upload(scal)
        t_prep.stop()
        with Timer("track/fused_enqueue"):
            out = fused.fused_track_step_packed(
                self.cam, scal_dev, cur_dev, last_dev, dyn_dev, map_dev, gmm_tab, scales,
                float(self.log_sf), self.num_levels, map_is_stale=kf_mode,
                **self._anchor_kw())
        if prime_chain:
            vq, vt = self.host_vel if self.host_vel is not None else (None, None)
            vel = np.zeros(8, np.float32)
            if vq is not None:
                vel[0:4], vel[4:7], vel[7] = vq, vt, 1.0
            pose_prev = np.concatenate([last.q_cw, last.t_cw]).astype(np.float32)
            self._chain = dict(out=out, cur=cur_dev, dyn=dyn_dev, map_tab=map_dev,
                               vel=self._upload(vel), pose_prev=self._upload(pose_prev))
        return FusedPending(frame=frame, result=Readback(out), lp=lp, n_lp=len(lp),
                            q_pred=frame.q_cw.copy(), t_pred=frame.t_cw.copy(),
                            packed=True)

    def invalidate_chain(self) -> None:
        """Drop the device-chained state (rewind, synchronous frame)."""
        self._chain = None

    def fused_dispatch_chained(self, frame: Frame) -> FusedPending:
        """Dispatch `frame` from the chain state: no read-back of the
        previous frame; pose prediction, landmark table and temporal
        points come from the device (fused.fused_track_step_chained). The
        only per-frame upload is the frame's packed table. Raises if the
        chain is not primed or there is no device-world mirror."""
        ch, dw = self._chain, self.dev_world
        if ch is None or dw is None:
            raise RuntimeError("the chained dispatch needs a primed chain and the "
                               "device-world mirror")
        tk = self.cfg.tracking
        w = self.world
        t_prep = Timer("track/chain_prep").start()
        lp = self.local_points
        lp = lp[w.pt_valid[lp]] if len(lp) else lp
        map_dev, lp = self._cached_map(lp[:tk.fused_local_map_cap], True)
        gmm_tab, scales = self._dev_static()
        cur_dev = frame._dev_cur = self._upload(self._pack_frame(frame))
        pt_pos, pt_valid, pt_comp = dw.read_for_tracking()
        t_prep.stop()
        with Timer("track/chain_enqueue"):
            out_ext, dyn_new, vel_new, pose_prev = fused.fused_track_step_chained(
                self.cam, ch["out"], ch["cur"], ch["dyn"], ch["map_tab"],
                ch["pose_prev"], ch["vel"], pt_pos, pt_valid, pt_comp,
                cur_dev, map_dev, gmm_tab, scales, float(self.log_sf), self.num_levels,
                velocity_ema=float(tk.velocity_ema),
                velocity_damping=float(tk.velocity_damping),
                th_depth=float(self.th_depth), temp_cap=int(tk.temporal_points_cap),
                motion_radius=float(tk.motion_search_radius),
                local_radius=float(tk.local_search_radius), **self._anchor_kw())
        self._chain = dict(out=out_ext, cur=cur_dev, dyn=dyn_new, map_tab=map_dev,
                           vel=vel_new, pose_prev=pose_prev)
        self.n_chained += 1
        return FusedPending(frame=frame, result=Readback(out_ext), lp=lp, n_lp=len(lp),
                            q_pred=None, t_pred=None, packed=True, chained=True)

    def fused_complete(self, pend: FusedPending) -> Optional[TrackStat]:
        """Read the dispatched step back and do the host bookkeeping.
        Returns the TrackStat, or None to request the classic fallback
        (too few inliers)."""
        w = self.world
        frame = pend.frame
        if pend.chained:
            # the chained dispatch skipped the last-frame prep: run it now,
            # so last.mappoint holds the temporal points the device made
            # (fused._chain_prep follows _create_temporal_points' rule)
            self._update_last_frame()
            if not self.last_frame.is_keyframe:
                self._create_temporal_points()
        last = self.last_frame
        lp, n_lp = pend.lp, pend.n_lp
        with Timer("track/fused_fetch"):
            if pend.packed:
                out = pend.result.get()
                if pend.chained:
                    # the +7 extension carries the device's pose prediction
                    pend.q_pred = out[-7:-3].astype(np.float64)
                    pend.t_pred = out[-3:].astype(np.float64)
                    out = out[:-7]
                rq, rt, fp, fl, r_out, n_inl, n_mot, in_view, n_anc = fused.unpack_result(
                    out, frame.feat_cap, self.cfg.tracking.fused_local_map_cap)
            else:
                r = fused.FusedTrackResult(*(x.cpu().numpy() for x in pend.result))
                rq, rt, fp, fl, r_out = (r.q, r.t, r.feat_point, r.feat_from_local,
                                         r.is_outlier)
                n_inl, n_mot, in_view, n_anc = (r.num_inliers, r.n_motion_matches,
                                                r.map_in_view, r.num_anchors)
        t_book = Timer("track/fused_book").start()
        if int(n_inl) < self.cfg.tracking.min_matches_track:
            frame.mappoint[:] = -1
            t_book.stop()
            return None
        frame.set_pose(rq.astype(np.float64), rt.astype(np.float64))
        frame.is_outlier = r_out.copy()
        frame.mappoint[:] = -1
        m_local = (fp >= 0) & fl
        m_last = (fp >= 0) & ~fl
        if n_lp:
            frame.mappoint[m_local] = lp[np.clip(fp[m_local], 0, n_lp - 1)]
        frame.mappoint[m_last] = last.mappoint[fp[m_last]]

        if n_lp:
            in_view = in_view[:n_lp]
            w.pt_num_visible[lp[in_view]] += 1
            w.pt_last_visible_idx[lp[in_view]] = frame.idx
        has = (frame.mappoint >= 0) & frame.valid
        inl = has & ~frame.is_outlier
        np.add.at(w.pt_num_found, frame.mappoint[inl], 1)
        frame.mappoint[has & frame.is_outlier] = -1
        frame.is_outlier[:] = False

        self.stat = TrackStat(res=True)
        selg = frame.mappoint[frame.mappoint >= 0]
        self.stat.num_match_inliers = int((w.pt_n_obs[selg] > 0).sum())
        self.dbg = {
            "path": "fused",
            "n_motion_match": int(n_mot),
            "n_gmm_inliers": int((w.pt_assoc_comp[selg] >= 0).sum()),
            "n_anchors": int(n_anc),
            "q_pred": pend.q_pred,
            "t_pred": pend.t_pred,
        }
        self._plausibility_gate(frame)
        self._update_local_map(frame)
        self.stat.ratio_map = self._ratio_map(frame)
        self._cleanup(frame)
        self.last_frame = frame
        t_book.stop()
        return self.stat
