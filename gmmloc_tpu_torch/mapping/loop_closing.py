"""Loop closing: BoW candidate detection + 3D-3D closure + pose-graph fix.

PyTorch port of `gmmloc_tpu/mapping/loop_closing.py` (the reference ends
its run on tracking loss and never closes loops). Pipeline:

  1. detection (`loop/detect`): a keyframe-database query, excluding the
     current covisible neighbourhood and keyframes less than three
     seconds apart, with a minimum-similarity gate;
  2. verification (`loop/verify`): mutual-best descriptor matches between
     the two keyframes' landmarks (kernel K3 on the card), then Umeyama
     3D-3D alignment with inlier consensus on the host, giving a relative
     pose measurement;
  3. correction (`loop/pgo`, `loop/writeback`): a pose graph
     (covisibility odometry edges at the current relative poses, the
     loop edge from step 2) optimized on the device
     (`solver/pose_graph.py`), keyframe poses written back, and the
     correction carried to the landmarks through their reference
     keyframes. Poses and `pt_pos` move in place: `map_version` goes up
     (the device-world mirror re-uploads the poses on a version change)
     and the moved points are marked dirty.

`close` runs where the JAX package runs it: on the tracking thread,
after the keyframe's mapping. In online mode the mapper thread may write
the same poses meanwhile (the reference has the same unsynchronized
write).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import map_state as ms
from ..config import SystemConfig
from ..eval.ate import umeyama_alignment
from ..features import matching
from ..geometry import se3
from ..solver import pose_graph as pg
from ..utils.device import resolve
from ..utils.timing import Timer
from ..vocab.bow import KeyFrameDatabase


class LoopCloser:
    def __init__(self, cfg: SystemConfig, world: ms.MapState,
                 db: KeyFrameDatabase, min_score: float = 0.05,
                 min_inliers: int = 20, device="cuda"):
        self.cfg = cfg
        self.world = world
        self.db = db
        self.min_score = min_score
        self.min_inliers = min_inliers
        self.device = resolve(device)
        self.closures: List[Tuple[int, int]] = []
        # per closure: the graph (on the device) and its optimized
        # (q, t, cost) read back to the host
        self.graphs: list = []

    def _t(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------

    def detect(self, kf: int) -> Optional[Tuple[int, float]]:
        """Best loop candidate for kf outside its covisible neighborhood."""
        w = self.world
        neighborhood = set(int(k) for k in w.best_covisible(kf)) | {kf}
        cands = self.db.query(w.kf_feat_desc[kf], w.kf_feat_valid[kf], top=10)
        for cand, score in cands:
            if cand in neighborhood or not w.kf_valid[cand]:
                continue
            # temporal separation: require a real revisit, not a neighbor
            if abs(int(w.kf_frame_idx[kf]) - int(w.kf_frame_idx[cand])) < 3 * self.cfg.camera.fps:
                continue
            if score >= self.min_score:
                return cand, score
        return None

    def verify(self, kf_a: int, kf_b: int):
        """3D-3D consensus alignment between the KFs' landmark sets.

        Returns (q_ab, t_ab, n_inliers) with T_ab = T_a_w * T_w_b measured,
        or None.
        """
        w = self.world
        match, _ = matching.mutual_best_match(
            self._t(w.kf_feat_desc[kf_a], torch.uint8),
            self._t(w.kf_feat_valid[kf_a] & (w.kf_obs_point[kf_a] >= 0), torch.bool),
            self._t(w.kf_feat_desc[kf_b], torch.uint8),
            self._t(w.kf_feat_valid[kf_b] & (w.kf_obs_point[kf_b] >= 0), torch.bool),
            max_dist=matching.TH_LOW,
        )
        match = match.cpu().numpy()
        pa, pb = [], []
        for i in np.where(match >= 0)[0]:
            p1 = w.kf_obs_point[kf_a, i]
            p2 = w.kf_obs_point[kf_b, match[i]]
            if p1 >= 0 and p2 >= 0 and w.pt_valid[p1] and w.pt_valid[p2]:
                pa.append(w.pt_pos[p1])
                pb.append(w.pt_pos[p2])
        if len(pa) < self.min_inliers:
            return None
        pa = np.array(pa).T
        pb = np.array(pb).T
        # both point sets live in the same (drifted) world frame; a loop
        # appears as a rigid offset between the corresponded sets.
        r, t, _ = umeyama_alignment(pb, pa, with_scale=False)
        resid = np.linalg.norm((r @ pb + t[:, None]) - pa, axis=0)
        inliers = resid < 0.25
        if inliers.sum() < self.min_inliers:
            return None
        r, t, _ = umeyama_alignment(pb[:, inliers], pa[:, inliers], with_scale=False)
        # world-frame correction W' = (r, t) as a relative pose measurement
        # between the two keyframes: T_ab_meas = T_a_w * corr * T_w_b
        Ra = ms._quat_to_mat(w.kf_q[kf_a])
        Rb = ms._quat_to_mat(w.kf_q[kf_b])
        T_a = np.eye(4)
        T_a[:3, :3], T_a[:3, 3] = Ra, w.kf_t[kf_a]
        T_corr = np.eye(4)
        T_corr[:3, :3], T_corr[:3, 3] = r, t
        T_b_inv = np.eye(4)
        T_b_inv[:3, :3], T_b_inv[:3, 3] = Rb.T, -Rb.T @ w.kf_t[kf_b]
        T_ab = T_a @ T_corr @ T_b_inv
        # as the JAX package: the rotation goes through float32
        q_ab = se3.matrix_to_quat(torch.tensor(T_ab[:3, :3], dtype=torch.float32)).numpy()
        return q_ab, T_ab[:3, 3], int(inliers.sum())

    # ------------------------------------------------------------------

    def close(self, kf: int) -> bool:
        """Detect + verify + correct. Returns True if a loop was closed."""
        w = self.world
        with Timer("loop/detect"):
            det = self.detect(kf)
        if det is None:
            return False
        cand, score = det
        with Timer("loop/verify"):
            ver = self.verify(kf, cand)
        if ver is None:
            return False
        q_loop, t_loop, n_in = ver

        kfs = [int(k) for k in np.where(w.kf_valid)[0]]
        slot = {k: i for i, k in enumerate(kfs)}
        N = len(kfs)

        edge_i, edge_j, eq, et, info = [], [], [], [], []
        # covisibility odometry edges (current relative poses)
        for a in kfs:
            for b in w.best_covisible(a, 5):
                b = int(b)
                if b <= a or b not in slot:
                    continue
                dq, dt = ms._compose(
                    w.kf_q[a], w.kf_t[a], *ms._inverse(w.kf_q[b], w.kf_t[b])
                )
                edge_i.append(slot[a])
                edge_j.append(slot[b])
                eq.append(dq)
                et.append(dt)
                info.append(np.full(6, 100.0))
        # the loop edge
        edge_i.append(slot[kf])
        edge_j.append(slot[cand])
        eq.append(q_loop)
        et.append(t_loop)
        info.append(np.full(6, 400.0))

        E = len(edge_i)
        fixed = np.zeros(N, bool)
        fixed[slot[kfs[0]]] = True
        g = pg.PoseGraph(
            q=self._t(w.kf_q[kfs]), t=self._t(w.kf_t[kfs]),
            valid=torch.ones(N, dtype=torch.bool, device=self.device),
            fixed=self._t(fixed, torch.bool),
            edge_i=self._t(edge_i, torch.int64),
            edge_j=self._t(edge_j, torch.int64),
            edge_q=self._t(np.stack(eq)),
            edge_t=self._t(np.stack(et)),
            edge_info=self._t(np.stack(info)),
            edge_valid=torch.ones(E, dtype=torch.bool, device=self.device),
        )
        with Timer("loop/pgo"):
            out = pg.optimize_pose_graph(g, iters=15, device=self.device)
            q_new, t_new, cost = (x.cpu().numpy() for x in out)
        self.graphs.append((g, q_new, t_new, cost))
        q_new = q_new.astype(np.float64)
        t_new = t_new.astype(np.float64)

        with Timer("loop/writeback"):
            # write back + propagate landmarks via their reference keyframes:
            # x' = T_w_ref_new * (T_ref_w_old x)
            old_q = {k: w.kf_q[k].copy() for k in kfs}
            old_t = {k: w.kf_t[k].copy() for k in kfs}
            for k in kfs:
                i = slot[k]
                nq = q_new[i] / np.linalg.norm(q_new[i])
                w.kf_q[k], w.kf_t[k] = nq, t_new[i]

            pts = np.where(w.pt_valid)[0]
            refs = w.pt_ref_kf[pts]
            for k in kfs:
                sel = pts[refs == k]
                if len(sel) == 0:
                    continue
                R_old = ms._quat_to_mat(old_q[k])
                R_new = ms._quat_to_mat(w.kf_q[k])
                # x_cam = R_old x + t_old ; x' = R_new^T (x_cam - t_new)
                x_cam = w.pt_pos[sel] @ R_old.T + old_t[k]
                w.pt_pos[sel] = (x_cam - w.kf_t[k]) @ R_new
                w.dirty_pt.update(sel.tolist())
            w.map_version += 1  # poses/points moved in place (cache tokens)
        self.closures.append((kf, cand))
        return True
