"""Relocalization: BoW place recognition + pose recovery from the map.

PyTorch port of `gmmloc_tpu/tracking/relocalize.py`. The reference has
DBoW2 in-tree but no keyframe database: a tracking failure ends its run
(gmmloc.cpp:157-159). Here: query the inverted-index database, then per
candidate keyframe match the frame's descriptors mutually-best against
the keyframe's landmarks (`features/matching.mutual_best_match`: kernel
K3 on the card), solve the pose seeded at the keyframe's pose
(`solver/cuda_pose.optimize_pose`: kernel K1 on the card), and accept on
the inlier count and on the recovered pose's consistency with the prior
GMM map.

Host timers: `reloc/query` (the database query), `reloc/attempt` (one
candidate: match, pose solve, the GMM check).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..features import matching
from ..geometry import camera as cam_mod
from ..gmm import render as render_mod
from ..mapping import map_state as ms
from ..mapping.map_state import MapState
from ..solver import cuda_pose
from ..utils.device import resolve
from ..utils.timing import Timer
from ..vocab.bow import KeyFrameDatabase, Vocabulary
from .frame import Frame


class Relocalizer:
    def __init__(
        self,
        cfg: SystemConfig,
        cam: cam_mod.CameraParams,
        world: MapState,
        voc: Vocabulary,
        min_inliers: int = 30,
        gmm_views: Optional[dict] = None,
        gmap=None,
        gmm_consistency_min: float = 0.25,
        device="cuda",
    ):
        self.cfg = cfg
        self.cam = cam
        self.world = world
        self.device = resolve(device)
        self.db = KeyFrameDatabase(voc.to(self.device))
        self.min_inliers = min_inliers
        # prior-map consistency check of a recovered pose: the database can
        # hold drift-corrupted keyframes, so the inlier count alone can
        # accept a pose metres off. The prior GMM is globally fixed: a
        # minimum share of the frame's stereo points must be Mahalanobis-
        # consistent with their nearest component at the recovered pose.
        self.gmm_views = gmm_views
        self.gmap = gmap
        self.gmm_consistency_min = gmm_consistency_min
        self.sigma2_inv = world.pyr["sigma2_inv"]
        self.last_stats: list = []  # per candidate (kf, n_match, n_inlier)

    def _t(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _gmm_consistent(self, frame: Frame, q_cw, t_cw) -> bool:
        if self.gmap is None or self.gmm_views is None:
            return True
        sel = np.where(frame.valid & (frame.depth > 0))[0]
        if len(sel) < 20:
            return True  # not enough stereo evidence to judge
        if len(sel) > 512:
            sel = sel[:: len(sel) // 512 + 1]
        z = frame.depth[sel]
        uv = frame.uv[sel]
        pc = np.stack(
            [
                (uv[:, 0] - self.cam.cx) / self.cam.fx * z,
                (uv[:, 1] - self.cam.cy) / self.cam.fy * z,
                z,
            ],
            -1,
        )
        q_wc, t_wc = ms._inverse(q_cw, t_cw)
        pw = pc @ ms._quat_to_mat(q_wc).T + t_wc
        nearest = render_mod.query_point_3d(
            self.gmap, self._t(pw), torch.ones(len(pw), dtype=torch.bool,
                                               device=self.device)).cpu().numpy()
        k = np.maximum(nearest, 0)
        d = pw - self.gmm_views["means"][k]
        chi2 = np.einsum("ni,nij,nj->n", d, self.gmm_views["cov_inv"][k], d)
        frac = float((chi2 < 16.0).mean())
        self.last_stats.append(("gmm_frac", round(frac, 3)))
        return frac >= self.gmm_consistency_min

    def add_keyframe(self, kf: int) -> None:
        w = self.world
        self.db.add(kf, w.kf_feat_desc[kf], w.kf_feat_valid[kf])

    def remove_keyframe(self, kf: int) -> None:
        self.db.remove(kf)

    def relocalize(self, frame: Frame) -> bool:
        """Try to recover the frame pose from the map. Returns success."""
        w = self.world
        self.last_stats = []
        with Timer("reloc/query"):
            cands = self.db.query(frame.desc, frame.valid, top=5)
        desc = self._t(frame.desc, torch.uint8)
        valid = self._t(frame.valid, torch.bool)
        for kf, score in cands:
            if not w.kf_valid[kf]:
                continue
            with Timer("reloc/attempt"):
                ok = self._attempt(frame, kf, desc, valid)
            if ok:
                return True
        return False

    def _attempt(self, frame: Frame, kf: int, desc, valid) -> bool:
        """One candidate keyframe: match, pose solve, acceptance."""
        w = self.world
        match, _ = matching.mutual_best_match(
            desc, valid, self._t(w.kf_feat_desc[kf], torch.uint8),
            self._t(w.kf_feat_valid[kf] & (w.kf_obs_point[kf] >= 0), torch.bool),
            max_dist=matching.TH_LOW,
        )
        match = match.cpu().numpy()
        frame.mappoint[:] = -1
        mi = np.where(match >= 0)[0]
        p = w.kf_obs_point[kf, match[mi]]
        okm = (p >= 0) & w.pt_valid[np.maximum(p, 0)]
        frame.mappoint[mi[okm]] = p[okm]
        n = int(okm.sum())
        if n < 15:
            self.last_stats.append((int(kf), n, -1))
            return False
        frame.set_pose(w.kf_q[kf], w.kf_t[kf])

        has_pt = frame.mappoint >= 0
        x_w = np.zeros((frame.feat_cap, 3), np.float32)
        idx = np.where(has_pt)[0]
        x_w[idx] = w.pt_pos[frame.mappoint[idx]]
        obs = np.concatenate([frame.uv, frame.ur[:, None]], -1)
        res = cuda_pose.optimize_pose(
            self.cam,
            self._t(frame.q_cw), self._t(frame.t_cw),
            self._t(x_w), self._t(obs),
            self._t(frame.ur >= 0, torch.bool),
            self._t(self.sigma2_inv[frame.octave]),
            self._t(has_pt & frame.valid, torch.bool),
        )
        q_new, t_new, n_inl, is_out = (
            x.cpu().numpy() for x in (res.q, res.t, res.num_inliers, res.is_outlier))
        q_new = q_new.astype(np.float64)
        t_new = t_new.astype(np.float64)
        pose_ok = bool(np.isfinite(q_new).all() and np.isfinite(t_new).all())
        self.last_stats.append((int(kf), n, int(n_inl)))
        if not (pose_ok and int(n_inl) >= self.min_inliers):
            return False
        if not self._gmm_consistent(frame, q_new, t_new):
            return False
        frame.set_pose(q_new, t_new)
        frame.is_outlier = is_out.copy()
        for i in np.where(frame.mappoint >= 0)[0]:
            if frame.is_outlier[i]:
                frame.mappoint[i] = -1
                frame.is_outlier[i] = False
        frame.ref_kf = kf
        return True
