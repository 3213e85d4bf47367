"""System orchestrator: the tracking + mapping loop on one device.

PyTorch port of `gmmloc_tpu/pipeline/system.py` (ref gmmloc.cpp spin
:123-197, needNewKeyFrame :324-364) for the offline protocol: the back-end
runs synchronously after each keyframe insertion. With the default
`pipelined_track`, `step` enqueues the frame's fused track step and
returns the PREVIOUS frame's stat (its read-back, keyframe decision and
mapping run on the next call); `flush` drains the last frame. Completion
order, and hence every computed value, is that of the synchronous loop.

Not ported here (they raise): online threaded mapping, the device-world
mirror, the packed and device-chained track steps, relocalization and
loop closing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gmmloc_tpu.mapping import map_state as ms
from gmmloc_tpu.tracking.frame import Frame
from gmmloc_tpu.utils.timing import Timer

from ..config import SystemConfig
from ..geometry import camera as cam_mod
from ..gmm import mixture
from ..mapping.association import GMMAssociator
from ..mapping.localization import Localization
from ..tracking.tracker import Tracker, TrackStat


def set_numerics() -> None:
    """Full float32 matrix products (TF32 off): the counterpart of the JAX
    package's matmul_precision="highest" -- reduced-precision f32
    products corrupt the small solver contractions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class GMMLocSystem:
    def __init__(self, cfg: SystemConfig, gmap: mixture.GMMMap, device):
        if cfg.online:
            raise ValueError("online (threaded) mapping is not ported; set online=False")
        if not cfg.loc.fused_kf_assoc:
            raise ValueError("only the fused keyframe association is ported")
        set_numerics()
        self.cfg = cfg
        self.device = torch.device(device)
        self.cam = cam_mod.CameraParams.from_config(cfg.camera)
        self.gmap = gmap
        self.world = ms.MapState(cfg)
        self.assoc = GMMAssociator(cfg, self.cam, gmap, self.device)
        self.tracker = Tracker(cfg, self.cam, self.world, self.device,
                               gmm_views=mixture.host_view(gmap))
        self.localizer = Localization(cfg, self.cam, self.world, self.assoc,
                                      self.device)
        self.initialized = False
        self._pending = None
        self.curr_frame: Optional[Frame] = None
        self.last_frame: Optional[Frame] = None
        self.curr_keyframe: int = -1
        self.n_tracked = 0
        self.vel_q: Optional[np.ndarray] = None
        self.vel_t: Optional[np.ndarray] = None
        self.track_failed = False

    @classmethod
    def from_gmm_file(cls, cfg: SystemConfig, path: str, device) -> "GMMLocSystem":
        gmap = mixture.load(
            path, device, pad_to=cfg.caps.gmm_components_pad,
            neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
            neighbor_cap=cfg.gmm.neighbor_cap,
            degenerate_eig_thresh=cfg.gmm.degenerate_eig_thresh,
            salient_eig_thresh=cfg.gmm.salient_eig_thresh,
        )
        return cls(cfg, gmap, device)

    # ------------------------------------------------------------------

    def init_pose_guess(self, frame: Frame, gt_q_wc=None, gt_t_wc=None) -> None:
        """Pose initialization (gmmloc.cpp:269-292): frame 0 from ground
        truth, frame 1 copies, else the damped EMA constant-velocity model;
        the previous frame is re-anchored to its (possibly BA-refined)
        reference keyframe first."""
        if self.curr_frame is not None and self.curr_frame.ref_kf >= 0:
            info = self.world.frame_infos[-1] if self.world.frame_infos else None
            if info is not None:
                q_cr, t_cr = ms._inverse(info.q_cr, info.t_cr)
                q, t = ms._compose(q_cr, t_cr, self.world.kf_q[info.ref_kf],
                                   self.world.kf_t[info.ref_kf])
                self.curr_frame.set_pose(q, t)
        if frame.idx == 0 or not self.initialized:
            q_cw = gt_q_wc * np.array([1.0, -1, -1, -1])
            frame.set_pose(q_cw, -ms._quat_to_mat(q_cw) @ gt_t_wc)
            self.vel_q = self.vel_t = None
        elif self.last_frame is None or frame.idx == 1:
            frame.set_pose(self.curr_frame.q_cw, self.curr_frame.t_cw)
            self.vel_q = self.vel_t = None
        else:
            dq, dt = self._advance_velocity(self.curr_frame, self.last_frame)
            frame.set_pose(*ms._compose(dq, dt, self.curr_frame.q_cw,
                                        self.curr_frame.t_cw))
        self.last_frame = self.curr_frame
        self.curr_frame = frame

    def _advance_velocity(self, curr: Frame, last: Frame):
        """EMA-smoothed, damped constant-velocity delta (TrackingConfig
        velocity_ema / velocity_damping)."""
        ql_wc, tl_wc = ms._inverse(last.q_cw, last.t_cw)
        dq, dt = ms._compose(curr.q_cw, curr.t_cw, ql_wc, tl_wc)
        a = self.cfg.tracking.velocity_ema
        if a < 1.0 and self.vel_q is not None:
            if np.dot(self.vel_q, dq) < 0:
                dq = -dq
            dq = (1.0 - a) * self.vel_q + a * dq
            dq /= np.linalg.norm(dq)
            dt = (1.0 - a) * self.vel_t + a * dt
        g = self.cfg.tracking.velocity_damping
        if g < 1.0:
            dt = dt * g
            dq = dq.copy()
            dq[1:] *= g
            dq /= np.linalg.norm(dq)
        self.vel_q, self.vel_t = dq.copy(), dt.copy()
        return dq, dt

    # ------------------------------------------------------------------

    def process_keyframe(self, frame: Frame, is_first: bool = False) -> int:
        """Ref processKeyFrame (gmmloc_opt.cpp:19-34)."""
        frame.is_keyframe = True
        kf = self.world.alloc_keyframe(frame)
        frame.ref_kf = kf
        idx = np.where(frame.mappoint >= 0)[0]
        p = frame.mappoint[idx]
        ok = self.world.pt_valid[p]
        self.world.kf_obs_point[kf, idx[ok]] = p[ok]
        self.assoc.associate_and_check_keyframe(self.world, kf)
        self.assoc.create_map_points_from_stereo(self.world, frame, kf,
                                                 check_depth=not is_first)
        return kf

    def need_new_keyframe(self, stat: TrackStat) -> bool:
        """Ref needNewKeyFrame (gmmloc.cpp:324-364)."""
        w = self.world
        cfg = self.cfg.tracking
        num_kfs = w.n_keyframes()
        th_ref_ratio = cfg.kf_ref_ratio_few if num_kfs < 2 else cfg.kf_ref_ratio
        th_map_ratio = (cfg.kf_map_ratio_many if stat.num_match_inliers > 300
                        else cfg.kf_map_ratio)
        num_obs = 2 if num_kfs <= 2 else 3
        obs = w.kf_obs_point[self.tracker.ref_keyframe]
        pts = obs[obs >= 0]
        num_ref = int((w.pt_n_obs[pts] >= num_obs).sum()) if len(pts) else 0
        c1a = self.curr_frame.idx >= w.kf_frame_idx[self.curr_keyframe] + self.cfg.camera.fps
        c1b = stat.num_match_inliers < num_ref * 0.25 or stat.ratio_map < 0.3
        c2 = (stat.num_match_inliers < num_ref * th_ref_ratio
              or stat.ratio_map < th_map_ratio) and stat.num_match_inliers > cfg.kf_min_inliers
        mapper = self.localizer
        if (c1a or c1b or mapper.is_idle) and c2:
            if mapper.is_idle:
                return True
            mapper.abort_ba = True
            return mapper.count_queue() < cfg.kf_queue_cap
        return False

    # ------------------------------------------------------------------

    def step(self, frame: Frame, gt_q_wc=None, gt_t_wc=None) -> Optional[TrackStat]:
        """One iteration of the main loop (gmmloc.cpp:128-195). In
        pipelined mode the returned stat belongs to the previous frame
        (None until one completes); call flush() after the last frame."""
        tk = self.cfg.tracking
        if not (tk.pipelined_track and tk.use_fused_track):
            return self._step_sync(frame, gt_q_wc, gt_t_wc)
        stat_prev = self.drain()
        if self.track_failed:
            return stat_prev
        if not self.initialized:
            return self._step_sync(frame, gt_q_wc, gt_t_wc)
        self.init_pose_guess(frame, gt_q_wc, gt_t_wc)
        pend = self.tracker.fused_dispatch(frame)
        if pend is None:
            # too few carried landmarks: the synchronous path (as the
            # reference package does, it re-runs the dispatch prep)
            return self._track_and_map(frame)
        self._pending = pend
        return stat_prev

    def drain(self) -> Optional[TrackStat]:
        """Complete the in-flight frame: read-back, keyframe policy,
        mapping, trajectory record. No-op without a pending dispatch."""
        if self._pending is None:
            return None
        pend, self._pending = self._pending, None
        stat = self.tracker.fused_complete(pend)
        if stat is None:
            # under-matched: the classic path for this frame
            return self._track_and_map(pend.frame, classic_only=True)
        return self._track_and_map(pend.frame, pre_stat=stat)

    def flush(self) -> Optional[TrackStat]:
        """Drain the in-flight frame (end of sequence)."""
        return self.drain()

    def _step_sync(self, frame: Frame, gt_q_wc=None, gt_t_wc=None) -> TrackStat:
        self.init_pose_guess(frame, gt_q_wc, gt_t_wc)
        if not self.initialized:
            kf = self.process_keyframe(frame, is_first=True)
            self.localizer.insert_keyframe(kf)
            self.localizer.spin_once()
            frame.ref_kf = kf
            self.curr_keyframe = kf
            self.tracker.initialize(frame)
            self.initialized = True
            self.world.update_frame_info(frame)
            return TrackStat(res=True, num_match_inliers=0, ratio_map=1.0)
        return self._track_and_map(frame)

    def _track_and_map(self, frame: Frame, pre_stat: Optional[TrackStat] = None,
                       classic_only: bool = False) -> TrackStat:
        """Post-track half of the loop: failure, keyframe policy + mapping,
        trajectory record."""
        if pre_stat is None:
            with Timer("track"):
                stat = (self.tracker.track_classic_fallback(frame) if classic_only
                        else self.tracker.track(frame))
        else:
            stat = pre_stat
        if not stat.res:
            self.track_failed = True   # the reference terminates here
            return stat
        if self.need_new_keyframe(stat) and not self.tracker.dbg.get("coasted"):
            with Timer("kf/process"):
                kf = self.process_keyframe(frame)
            self.curr_keyframe = kf
            self.localizer.insert_keyframe(kf)
            self.localizer.spin_once()
        self.n_tracked += 1
        if frame.ref_kf < 0:
            frame.ref_kf = self.tracker.ref_keyframe
        self.world.update_frame_info(frame)
        return stat

    def export_trajectory(self, path: Optional[str] = None):
        """(timestamps (N,), q_wc (N,4), t_wc (N,3)) of every tracked
        frame, anchored to its (BA-refined) reference keyframe."""
        if path is not None:
            self.world.save_trajectory_tum(path)
        return self.world.export_trajectory()
