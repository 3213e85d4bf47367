"""System orchestrator: the tracking + mapping loop on one device.

PyTorch port of `gmmloc_tpu/pipeline/system.py` (ref gmmloc.cpp spin
:123-197, needNewKeyFrame :324-364).

  - Offline (`online=False`): the back-end runs synchronously after each
    keyframe insertion. Online: a mapper thread consumes the keyframe
    queue (`mapping/online.py`), as the reference's two-thread split
    (gmmloc.cpp:56-59).
  - `pipelined_track` (the default), depth 1: `step` enqueues the
    frame's fused track step and returns the PREVIOUS frame's stat (its
    read-back, keyframe decision and mapping run on the next call);
    completion order, and hence every value, is the synchronous loop's.
  - `pipeline_depth` > 1 (with packed IO and the device-world mirror):
    frames are dispatched from device-chained state and drained that
    many frames late; an anomaly at drain (an under-match, a coasted
    pose) re-runs the frames still in flight synchronously.
  - `flush` drains every frame in flight; `stop` also drains and joins
    the mapper thread.
  - `run` is the offline batch loop over a frame iterable, gated by the
    run-control flags (`utils/control.py`: pause, single-step, stop).
  - With a vocabulary (`vocabulary=`, `enable_relocalization`), a frame
    whose track fails puts the system in the LOST state instead of ending
    the run: it keeps consuming frames synchronously and tries BoW
    relocalization on each (`tracking/relocalize.py`). With
    `enable_loop_closing` as well, each new keyframe is checked for a loop
    after its mapping (`mapping/loop_closing.py`).
  - `fused_kf_assoc=False` selects the host-orchestrated keyframe
    association (`GMMAssociator.associate_keyframe`).

  - `ba_schur_impl` picks the local BA's layout ("flatpm", "flat",
    "blockdiag", each at its own bfloat16 rounding points); `pose_impl`
    the fused track step's pose solver (`tracking/fused.pose_solvers`).
    An unknown name of either raises.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..mapping import map_state as ms
from ..tracking.frame import Frame
from ..utils.control import control
from ..utils.device import resolve
from ..utils.timing import Timer

from ..config import SystemConfig
from ..geometry import camera as cam_mod
from ..gmm import mixture
from ..mapping.association import GMMAssociator
from ..mapping.localization import Localization
from ..mapping.loop_closing import LoopCloser
from ..mapping.online import OnlineLocalization
from ..solver.local_ba import check_schur_impl
from ..tracking.relocalize import Relocalizer
from ..tracking.tracker import Tracker, TrackStat


def set_numerics() -> None:
    """Full float32 matrix products (TF32 off): the counterpart of the JAX
    package's matmul_precision="highest" -- reduced-precision f32
    products corrupt the small solver contractions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class GMMLocSystem:
    def __init__(self, cfg: SystemConfig, gmap: mixture.GMMMap, device="cuda",
                 vocabulary=None):
        check_schur_impl(cfg.loc.ba_schur_impl)
        set_numerics()
        self.cfg = cfg
        self.device = resolve(device)
        self.cam = cam_mod.CameraParams.from_config(cfg.camera)
        self.gmap = gmap
        self.world = ms.MapState(cfg)
        self.assoc = GMMAssociator(cfg, self.cam, gmap, self.device)
        self.tracker = Tracker(cfg, self.cam, self.world, self.device,
                               gmm_views=mixture.host_view(gmap))
        self.localizer = Localization(cfg, self.cam, self.world, self.assoc,
                                      self.device)
        self.relocalizer = None
        self.loop_closer = None
        if vocabulary is not None and cfg.enable_relocalization:
            # the vocabulary's descent moves to the system's device
            self.relocalizer = Relocalizer(
                cfg, self.cam, self.world, vocabulary,
                gmm_views=mixture.host_view(gmap), gmap=gmap, device=self.device)
            if cfg.enable_loop_closing:
                self.loop_closer = LoopCloser(cfg, self.world, self.relocalizer.db,
                                              device=self.device)
        self.initialized = False
        self._pending = None            # the in-flight frame at depth 1
        self._pendq = deque()           # the in-flight frames at depth > 1
        tk = cfg.tracking
        self._depth = max(1, tk.pipeline_depth)
        if self._depth > 1:
            # the chained mode needs packed IO, keyframe-cadence map
            # refresh and the device-world mirror
            if not (tk.use_fused_track and tk.pipelined_track and tk.fused_packed_io):
                self._depth = 1
            elif tk.fused_map_refresh != "kf":
                self.cfg = cfg = cfg.replace(
                    tracking=dataclasses.replace(tk, fused_map_refresh="kf"))
                self.tracker.cfg = cfg
        self.tracker.dev_world = self.localizer.dev_world
        if self.localizer.dev_world is None:
            self._depth = 1
        self._last_done = None          # the frame the latest stat belongs to
        self.online = None
        if cfg.online:
            self.online = OnlineLocalization(self.localizer)
            self.online.start()
        self.curr_frame: Optional[Frame] = None
        self.last_frame: Optional[Frame] = None
        self.curr_keyframe: int = -1
        self.n_tracked = 0
        self.vel_q: Optional[np.ndarray] = None
        self.vel_t: Optional[np.ndarray] = None
        self.track_failed = False   # fatal: no recovery path available
        self.lost = False           # recoverable: awaiting relocalization
        self.n_lost = 0             # lifetime count of lost frames
        # frame indices where relocalization re-anchored the run
        self.recovery_frames: list = []
        # chained-pipeline health counters
        self.n_primes = 0
        self.n_rewinds = 0
        self.n_rewound_frames = 0

    @classmethod
    def from_gmm_file(cls, cfg: SystemConfig, path: str, device="cuda") -> "GMMLocSystem":
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
        if self.cfg.loc.fused_kf_assoc:
            self.assoc.associate_and_check_keyframe(self.world, kf)
        else:
            self.assoc.associate_keyframe(self.world, kf)
        self.assoc.create_map_points_from_stereo(self.world, frame, kf,
                                                 check_depth=not is_first)
        if self.relocalizer is not None:
            self.relocalizer.add_keyframe(kf)
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
        mapper = self.online if self.online is not None else self.localizer
        if (c1a or c1b or mapper.is_idle) and c2:
            if mapper.is_idle:
                return True
            if self.online is not None:
                self.online.interrupt_ba()
            else:
                self.localizer.abort_ba = True
            if mapper.count_queue() < cfg.kf_queue_cap:
                return True
            if self.online is not None and cfg.kf_wait_ms > 0:
                # bounded back-pressure wait (TrackingConfig.kf_wait_ms)
                deadline = time.monotonic() + cfg.kf_wait_ms * 1e-3
                while time.monotonic() < deadline:
                    time.sleep(0.002)
                    if mapper.count_queue() < cfg.kf_queue_cap:
                        return True
            return False
        return False

    # ------------------------------------------------------------------

    def _recover(self, frame: Frame) -> bool:
        """Relocalize, then reset the motion model and the tracker state."""
        with Timer("reloc/relocalize"):
            ok = self.relocalizer.relocalize(frame)
        if not ok:
            return False
        self.recovery_frames.append(int(frame.idx))
        self.tracker.last_frame = frame
        self.tracker.ref_keyframe = frame.ref_kf
        self.tracker.temp_points.clear()
        # break the constant-velocity chain across the gap
        self.last_frame = None
        self.curr_frame = frame
        self.vel_q = self.vel_t = None
        self.lost = False
        return True

    def step(self, frame: Frame, gt_q_wc=None, gt_t_wc=None) -> Optional[TrackStat]:
        """One iteration of the main loop (gmmloc.cpp:128-195). In
        pipelined mode the returned stat belongs to the previous frame
        (None until one completes); call flush() after the last frame.
        Raises the mapper thread's exception, if it died of one. Host time
        in the `system/step` timer."""
        with Timer("system/step"):
            return self._step(frame, gt_q_wc, gt_t_wc)

    def _step(self, frame: Frame, gt_q_wc=None, gt_t_wc=None) -> Optional[TrackStat]:
        if self.online is not None:
            self.online.check()
        tk = self.cfg.tracking
        if not (tk.pipelined_track and tk.use_fused_track):
            return self._step_sync(frame, gt_q_wc, gt_t_wc)
        if self._depth > 1:
            return self._step_chained(frame, gt_q_wc, gt_t_wc)
        stat_prev = self.drain()
        if self.track_failed:
            return stat_prev
        if self.lost or not self.initialized:
            # lost recovery and bootstrap run synchronously
            return self._step_sync(frame, gt_q_wc, gt_t_wc)
        self.init_pose_guess(frame, gt_q_wc, gt_t_wc)
        with Timer("system/dispatch"):
            pend = self.tracker.fused_dispatch(frame)
        if pend is None:
            # too few carried landmarks: the synchronous path (as the
            # reference package does, it re-runs the dispatch prep)
            return self._track_and_map(frame)
        self._pending = pend
        return stat_prev

    # ---------------- the deep device-chained pipeline ------------------

    def _step_chained(self, frame: Frame, gt_q_wc=None, gt_t_wc=None):
        """step() at pipeline_depth > 1: frames are dispatched from the
        device-chained state (tracker.fused_dispatch_chained) and drained
        `pipeline_depth` frames late. The returned stat belongs to the
        frame drained in this call (None while the pipeline fills)."""
        stat_prev = None
        if len(self._pendq) >= self._depth:
            stat_prev = self._drain_one()
            if self.track_failed:
                return stat_prev
        if self.lost or not self.initialized:
            self._drain_all()
            if self.track_failed:
                return stat_prev
            return self._step_sync(frame, gt_q_wc, gt_t_wc)
        if self.tracker._chain is None or not self._pendq:
            # prime: the previous frame must be drained, so the host can
            # build the first link's inputs itself
            st = self._drain_all()
            stat_prev = st if st is not None else stat_prev
            if self.track_failed or self.lost or not self.initialized:
                # as the JAX package: this frame is not tracked
                return stat_prev
            self.init_pose_guess(frame, gt_q_wc, gt_t_wc)
            self.tracker.host_vel = (self.vel_q, self.vel_t)
            self.n_primes += 1
            with Timer("system/dispatch"):
                pend = self.tracker.fused_dispatch(frame, prime_chain=True)
            if pend is None:
                return self._track_and_map(frame)
            self._pendq.append(pend)
            return stat_prev
        with Timer("system/dispatch"):
            self._pendq.append(self.tracker.fused_dispatch_chained(frame))
        return stat_prev

    def _drain_one(self) -> Optional[TrackStat]:
        """Drain the oldest in-flight frame: read-back, host bookkeeping,
        keyframe policy and mapping. An anomaly re-runs the frames still
        in flight synchronously (their device results assumed a pose
        chain it invalidated). Host time in the `system/drain` timer."""
        pend = self._pendq.popleft()
        with Timer("system/drain"):
            stat = self.tracker.fused_complete(pend)
            # the system's frame chain rotates at drain time (poses are final
            # here; init_pose_guess rotates it on the synchronous paths)
            self.last_frame = self.curr_frame
            self.curr_frame = pend.frame
            if stat is None:
                # under-match: the classic path for this frame, then rewind
                st = self._track_and_map(pend.frame, classic_only=True)
                self._update_host_vel()
                return self._rewind_rest(st)
            st = self._track_and_map(pend.frame, pre_stat=stat)
            self._update_host_vel()
            if self.track_failed or self.lost or self.tracker.dbg.get("coasted"):
                # a loss, or a coasted pose that replaced the solved one the
                # device chain continued from
                return self._rewind_rest(st)
            return st

    def _drain_all(self) -> Optional[TrackStat]:
        st = None
        while self._pendq:
            s = self._drain_one()
            st = s if s is not None else st
            if self.track_failed:
                break
        return st

    def _rewind_rest(self, stat_first) -> Optional[TrackStat]:
        """Re-run the frames still in flight synchronously (re-priming the
        chain); each costs one synchronous frame, timed inside the drain
        that rewound it (not as a `system/step` of its own)."""
        frames = [p.frame for p in self._pendq]
        self._pendq.clear()
        self.tracker.invalidate_chain()
        self.n_rewinds += 1
        self.n_rewound_frames += len(frames)
        st = stat_first
        for f in frames:
            f._dev_cur = None        # its pose and assignments are reset
            f.mappoint[:] = -1
            f.is_outlier[:] = False
            s = self._step(f)
            st = s if s is not None else st
            if self.track_failed:
                break
        return st

    def _update_host_vel(self) -> None:
        """The host's velocity state from the drained poses (the device
        chain advances its own copy; the host's seeds primes and
        rewinds)."""
        if self.last_frame is not None and self.curr_frame is not None:
            self._advance_velocity(self.curr_frame, self.last_frame)

    def drain(self) -> Optional[TrackStat]:
        """Complete the in-flight frame: read-back, keyframe policy,
        mapping, trajectory record. No-op without a pending dispatch."""
        if self._pending is None:
            return None
        pend, self._pending = self._pending, None
        with Timer("system/drain"):
            stat = self.tracker.fused_complete(pend)
            if stat is None:
                # under-matched: the classic path for this frame
                return self._track_and_map(pend.frame, classic_only=True)
            return self._track_and_map(pend.frame, pre_stat=stat)

    def flush(self) -> Optional[TrackStat]:
        """Drain every in-flight frame (end of sequence)."""
        with Timer("system/flush"):
            st = self.drain()
            st2 = self._drain_all()
        return st2 if st2 is not None else st

    def run(self, frames: Iterable, gt_q_wc=None, gt_t_wc=None,
            on_frame: Optional[Callable] = None):
        """Offline batch run (ref gmmloc.cpp spin :123-197). `frames`
        yields Frames; the optional ground-truth arrays give the frame-0
        pose anchor. Before each frame the run-control gate waits while
        paused (a single step lets one frame through) and a stop ends the
        loop; a fatal tracking failure ends it too. In pipelined mode a
        stat belongs to an earlier frame: `on_frame(i, frame, stat)` gets
        the frame it was computed for (`_last_done`) and `i`, the index
        of the latest frame stepped; the flush's stat goes through the
        same call. Returns `self.world`."""
        self._last_done = None
        i = -1
        for i, frame in enumerate(frames):
            while not control.should_run() and not control.stop:
                time.sleep(0.001)
            control.consume_step()
            if control.stop:
                break
            g_q = gt_q_wc[i] if gt_q_wc is not None else None
            g_t = gt_t_wc[i] if gt_t_wc is not None else None
            stat = self.step(frame, g_q, g_t)
            if self.track_failed:
                break
            if stat is not None and stat.res and on_frame is not None:
                on_frame(i, self._last_done or frame, stat)
        stat = self.flush()
        if stat is not None and stat.res and on_frame is not None:
            on_frame(i, self._last_done, stat)
        return self.world

    def stop(self) -> None:
        """Drain the in-flight frames, then the mapper thread's queue, and
        join it (ref gmmloc.cpp:366). Raises the mapper's exception, or if
        it does not finish in time. A second call does nothing more."""
        self.flush()
        if self.online is not None:
            self.online.stop()

    def _step_sync(self, frame: Frame, gt_q_wc=None, gt_t_wc=None) -> TrackStat:
        if self.lost:
            # LOST: keep consuming frames and retry place recognition on
            # each (the reference terminates here, gmmloc.cpp:157-159)
            self.n_lost += 1
            if self._recover(frame):
                self.world.update_frame_info(frame)
                self._last_done = frame
                return TrackStat(res=True, num_match_inliers=30, ratio_map=0.3)
            return TrackStat(res=False)
        self.init_pose_guess(frame, gt_q_wc, gt_t_wc)
        if not self.initialized:
            kf = self.process_keyframe(frame, is_first=True)
            self._map_keyframe(kf)
            frame.ref_kf = kf
            self.curr_keyframe = kf
            self.tracker.initialize(frame)
            self.initialized = True
            self.world.update_frame_info(frame)
            self._last_done = frame
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
        if not stat.res and self.relocalizer is not None:
            # relocalize instead of terminating (the reference ends the run
            # here, gmmloc.cpp:157-159)
            if self._recover(frame):
                stat = TrackStat(res=True, num_match_inliers=30, ratio_map=0.3)
            else:
                self.lost = True
                self.n_lost += 1
                return stat
        if not stat.res:
            self.track_failed = True   # the reference terminates here
            return stat
        if self.need_new_keyframe(stat) and not self.tracker.dbg.get("coasted"):
            with Timer("kf/process"):
                kf = self.process_keyframe(frame)
            self.curr_keyframe = kf
            self._map_keyframe(kf)
            if self.loop_closer is not None and self.world.kf_valid[kf]:
                with Timer("loop/close"):
                    self.loop_closer.close(kf)
        self.n_tracked += 1
        if frame.ref_kf < 0:
            frame.ref_kf = self.tracker.ref_keyframe
        self.world.update_frame_info(frame)
        self._last_done = frame
        return stat

    def _map_keyframe(self, kf: int) -> None:
        """Queue the keyframe for the mapper thread, or map it now."""
        with Timer("system/map_keyframe"):
            if self.online is not None:
                self.online.insert_keyframe(kf)
            else:
                self.localizer.insert_keyframe(kf)
                self.localizer.spin_once()

    def export_trajectory(self, path: Optional[str] = None):
        """(timestamps (N,), q_wc (N,4), t_wc (N,3)) of every tracked
        frame, anchored to its (BA-refined) reference keyframe."""
        if path is not None:
            self.world.save_trajectory_tum(path)
        return self.world.export_trajectory()
