"""World state: fixed-capacity keyframe / landmark registries.

TPU-native redesign of the reference's pointer-graph world model
(ref: gmmloc/src/types/{map,keyframe,mappoint}.cpp).
Objects + mutexes + unordered_maps become capacity-bounded struct-of-arrays
with free-lists and masks (SURVEY.md §7 hard part 1):

  - observations: per-KF feature->point table (kf_obs_point) mirrored by a
    per-point (kf, feat) list — both updated together, invariant-checked.
  - covisibility: a dense (MK, MK) shared-observation count matrix
    (updateConnections, keyframe.cpp:243-316).
  - frame trajectory: per-frame (timestamp, ref KF, T_ref_cam) records so
    late BA refinements retroactively improve all frame poses at export
    (map.cpp:23-38, 89-104, 162-188).

Host-side numpy is the system of record (it is bookkeeping, not compute);
the heavy math consumes flat array views of this state on device.

The port's own copy of `gmmloc_tpu/mapping/map_state.py` (numpy only, copied unchanged
so that the port imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..config import SystemConfig, derived_pyramid

# MapPoint provenance (ref: mappoint.h:38-47)
PT_FROM_DEPTH = 0
PT_FROM_DEPTH_GMM = 1
PT_FROM_TRI_MONO = 2
PT_FROM_TRI_MONO_GMM = 3
PT_FROM_TRI_STEREO = 4
PT_FROM_TRI_STEREO_GMM = 5

GMM_TYPES = (PT_FROM_DEPTH_GMM, PT_FROM_TRI_MONO_GMM, PT_FROM_TRI_STEREO_GMM)

# byte popcount LUT for Hamming distances on host (descriptor selection)
_POPCNT = np.array([bin(i).count("1") for i in range(256)], np.uint8)
DOWNGRADE = {
    PT_FROM_DEPTH_GMM: PT_FROM_DEPTH,
    PT_FROM_TRI_MONO_GMM: PT_FROM_TRI_MONO,
    PT_FROM_TRI_STEREO_GMM: PT_FROM_TRI_STEREO,
}


@dataclass
class FrameInfo:
    """Per-frame pose record relative to a reference KF (map.h:20-28)."""

    timestamp: float
    ref_kf: int
    q_cr: np.ndarray  # T_ref_cam? stored as Trc = T_ref_w * T_w_cam
    t_cr: np.ndarray


class MapState:
    """Fixed-capacity world state. All ids are slot indices."""

    def __init__(self, cfg: SystemConfig):
        self.cfg = cfg
        caps = cfg.caps
        MK, MP = caps.max_keyframes, caps.max_points
        F = cfg.frame.feat_cap
        MO = caps.max_obs_per_point
        self.MK, self.MP, self.F, self.MO = MK, MP, F, MO
        knn = cfg.gmm.assoc_knn

        # --- keyframes -----------------------------------------------------
        self.kf_valid = np.zeros(MK, bool)
        self.kf_q = np.zeros((MK, 4))          # T_cw rotation (w,x,y,z)
        self.kf_t = np.zeros((MK, 3))
        self.kf_frame_idx = np.full(MK, -1, np.int64)
        self.kf_timestamp = np.zeros(MK)
        self.kf_feat_uv = np.zeros((MK, F, 2), np.float32)
        self.kf_feat_ur = np.full((MK, F), -1.0, np.float32)
        self.kf_feat_depth = np.full((MK, F), -1.0, np.float32)
        self.kf_feat_octave = np.zeros((MK, F), np.int32)
        self.kf_feat_angle = np.zeros((MK, F), np.float32)
        self.kf_feat_desc = np.zeros((MK, F, 32), np.uint8)
        self.kf_feat_valid = np.zeros((MK, F), bool)
        self.kf_obs_point = np.full((MK, F), -1, np.int32)
        self.kf_comp_cand = np.full((MK, F, knn), -1, np.int32)
        self.covis = np.zeros((MK, MK), np.int32)        # shared-point counts
        self.covis_link = np.zeros((MK, MK), bool)       # "connected" edges
        self._kf_order: List[int] = []                   # insertion order

        # --- map points ----------------------------------------------------
        self.pt_valid = np.zeros(MP, bool)
        self.pt_pos = np.zeros((MP, 3))
        self.pt_normal = np.zeros((MP, 3))
        self.pt_min_dist = np.zeros(MP)
        self.pt_max_dist = np.zeros(MP)
        self.pt_desc = np.zeros((MP, 32), np.uint8)
        self.pt_ref_kf = np.full(MP, -1, np.int32)
        self.pt_created_kf_idx = np.full(MP, -1, np.int64)  # KF idx at creation
        self.pt_num_found = np.zeros(MP, np.int32)
        self.pt_num_visible = np.zeros(MP, np.int32)
        self.pt_n_obs = np.zeros(MP, np.int32)      # weighted (stereo=2)
        self.pt_obs_kf = np.full((MP, MO), -1, np.int32)
        self.pt_obs_feat = np.full((MP, MO), -1, np.int32)
        self.pt_assoc_comp = np.full(MP, -1, np.int32)   # GMM 3D comp id
        # association survived >=1 joint-BA pass (anchor-trust gate: the
        # async mapping thread may not have vetted a fresh KF's
        # associations yet; per-frame pose anchors only use vetted ones)
        self.pt_assoc_vetted = np.zeros(MP, bool)
        self.pt_type = np.full(MP, PT_FROM_DEPTH, np.int8)
        self.pt_replaced_by = np.full(MP, -1, np.int32)
        self.pt_last_visible_idx = np.full(MP, -1, np.int64)
        self.pt_fuse_tgt_kf = np.full(MP, -1, np.int64)

        self._free_kf = list(range(MK - 1, -1, -1))
        self._free_pt = list(range(MP - 1, -1, -1))

        self.frame_infos: List[FrameInfo] = []
        self.max_kf_frame_idx = 0
        self.pyr = derived_pyramid(cfg)
        # Monotonic persistent-map mutation counter: bumped on KF alloc/
        # removal, persistent-point alloc/removal, replacement, and BA
        # write-back — NOT on temporal-point churn (ref_kf < 0). Cache
        # tokens (e.g. the tracker's kf-cadence local-map snapshot) key on
        # this instead of raw counts, which can collide when BA moves
        # pt_pos without changing counts (ADVICE r2 medium).
        self.map_version = 0
        # Dirty-row sets consumed by DeviceWorld.sync(): rows whose
        # mirrored attributes (kf feature tables; pt pos/normal/dists/
        # descriptor) changed since the last device sync.
        self.dirty_kf: set = set()
        self.dirty_pt: set = set()

    # ------------------------------------------------------------------ kfs

    def n_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    def n_points(self) -> int:
        return int(self.pt_valid.sum())

    def keyframe_ids(self) -> np.ndarray:
        return np.where(self.kf_valid)[0]

    def alloc_keyframe(self, frame) -> int:
        """Create a KeyFrame snapshot from a Frame (keyframe.cpp:96)."""
        kf = self._free_kf.pop()
        self.kf_valid[kf] = True
        self.kf_q[kf] = frame.q_cw
        self.kf_t[kf] = frame.t_cw
        self.kf_frame_idx[kf] = frame.idx
        self.kf_timestamp[kf] = frame.timestamp
        n = len(frame.uv)
        self.kf_feat_uv[kf, :n] = frame.uv
        self.kf_feat_ur[kf, :n] = frame.ur
        self.kf_feat_depth[kf, :n] = frame.depth
        self.kf_feat_octave[kf, :n] = frame.octave
        self.kf_feat_angle[kf, :n] = frame.angle
        self.kf_feat_desc[kf, :n] = frame.desc
        self.kf_feat_valid[kf, :n] = frame.valid
        self.kf_feat_valid[kf, n:] = False
        self.kf_obs_point[kf] = -1
        self.kf_comp_cand[kf] = -1
        self.covis[kf] = 0
        self.covis[:, kf] = 0
        self.covis_link[kf] = False
        self.covis_link[:, kf] = False
        self._kf_order.append(kf)
        self.max_kf_frame_idx = max(self.max_kf_frame_idx, frame.idx)
        self.map_version += 1
        self.dirty_kf.add(kf)
        return kf

    # ----------------------------------------------------------- points

    def alloc_point(self, pos, ref_kf: int, created_kf_idx: int) -> int:
        p = self._free_pt.pop()
        self.pt_valid[p] = True
        self.pt_pos[p] = pos
        self.pt_normal[p] = 0.0
        self.pt_min_dist[p] = 0.0
        self.pt_max_dist[p] = 0.0
        self.pt_ref_kf[p] = ref_kf
        self.pt_created_kf_idx[p] = created_kf_idx
        self.pt_num_found[p] = 1
        self.pt_num_visible[p] = 1
        self.pt_n_obs[p] = 0
        self.pt_obs_kf[p] = -1
        self.pt_obs_feat[p] = -1
        self.pt_assoc_comp[p] = -1
        self.pt_assoc_vetted[p] = False
        self.pt_type[p] = PT_FROM_DEPTH
        self.pt_replaced_by[p] = -1
        self.pt_last_visible_idx[p] = -1
        self.pt_fuse_tgt_kf[p] = -1
        if ref_kf >= 0:  # persistent points only; temporal churn excluded
            self.map_version += 1
        self.dirty_pt.add(p)
        return p

    def resolve_replaced(self, p: int) -> int:
        """Follow the replacement chain (mappoint getReplaced)."""
        seen = 0
        while p >= 0 and self.pt_replaced_by[p] >= 0 and seen < 32:
            p = self.pt_replaced_by[p]
            seen += 1
        return p

    # ------------------------------------------------------- observations

    def add_observation(self, p: int, kf: int, feat: int) -> None:
        """Bind point p to (kf, feat). Mirrors MapPoint::addObservation +
        KeyFrame::addObservation; weighted count (stereo=2, mappoint.cpp:72)."""
        if self.kf_obs_point[kf, feat] == p:
            return
        slots = self.pt_obs_kf[p]
        if (slots == kf).any():
            return  # already observed by this KF
        free = np.where(slots < 0)[0]
        if len(free) == 0:
            return  # capacity exceeded: drop (bounded-obs approximation)
        s = free[0]
        self.pt_obs_kf[p, s] = kf
        self.pt_obs_feat[p, s] = feat
        self.pt_n_obs[p] += 2 if self.kf_feat_ur[kf, feat] >= 0 else 1
        self.kf_obs_point[kf, feat] = p
        self.dirty_pt.add(p)  # mirror holds the obs tables (BA assembly)

    def remove_observation(self, p: int, kf: int) -> bool:
        """Returns True if the point became bad (weighted obs <= 2,
        mappoint.cpp removeObservation)."""
        slots = np.where(self.pt_obs_kf[p] == kf)[0]
        if len(slots) == 0:
            return False
        s = slots[0]
        feat = self.pt_obs_feat[p, s]
        self.pt_n_obs[p] -= 2 if self.kf_feat_ur[kf, feat] >= 0 else 1
        self.pt_obs_kf[p, s] = -1
        self.pt_obs_feat[p, s] = -1
        self.dirty_pt.add(p)
        if self.kf_obs_point[kf, feat] == p:
            self.kf_obs_point[kf, feat] = -1
        if self.pt_ref_kf[p] == kf:
            rem = self.pt_obs_kf[p][self.pt_obs_kf[p] >= 0]
            self.pt_ref_kf[p] = rem[0] if len(rem) else -1
        return self.pt_n_obs[p] <= 2 and self.pt_valid[p]

    def add_observations_batch(self, pids: np.ndarray, kf: int, feats: np.ndarray) -> None:
        """Vectorized add_observation for many points observed by ONE KF.

        `pids` must be unique. Semantics identical to looping
        add_observation(p, kf, feat): skip already-observed, first free
        slot, weighted count.
        """
        pids = np.asarray(pids, np.int64)
        feats = np.asarray(feats, np.int64)
        if len(pids) == 0:
            return
        keep = ~(self.pt_obs_kf[pids] == kf).any(axis=1)
        keep &= self.kf_obs_point[kf, feats] != pids
        pids, feats = pids[keep], feats[keep]
        if len(pids) == 0:
            return
        slots_free = self.pt_obs_kf[pids] < 0                 # (n, MO)
        has_free = slots_free.any(axis=1)
        pids, feats = pids[has_free], feats[has_free]
        if len(pids) == 0:
            return
        s = np.argmax(slots_free[has_free], axis=1)
        self.pt_obs_kf[pids, s] = kf
        self.pt_obs_feat[pids, s] = feats
        self.pt_n_obs[pids] += np.where(self.kf_feat_ur[kf, feats] >= 0, 2, 1)
        self.kf_obs_point[kf, feats] = pids
        self.dirty_pt.update(pids.tolist())

    def point_observations(self, p: int):
        m = self.pt_obs_kf[p] >= 0
        return self.pt_obs_kf[p][m], self.pt_obs_feat[p][m]

    def remove_point(self, p: int) -> None:
        """Ref: Map::removeMapPoint (map.cpp:40-57)."""
        if not self.pt_valid[p]:
            return
        kfs, feats = self.point_observations(p)
        if self.pt_ref_kf[p] >= 0 or len(kfs):
            self.map_version += 1
        for kf, ft in zip(kfs, feats):
            if self.kf_obs_point[kf, ft] == p:
                self.kf_obs_point[kf, ft] = -1
        self.pt_obs_kf[p] = -1
        self.pt_obs_feat[p] = -1
        self.pt_n_obs[p] = 0
        self.pt_valid[p] = False
        self.dirty_pt.add(p)  # validity is a scattered mirror field
        self._free_pt.append(p)

    def replace_point(self, src: int, tgt: int) -> None:
        """Ref: Map::replaceMapPoint (map.cpp:112-150)."""
        if src == tgt or not self.pt_valid[src]:
            return
        self.map_version += 1
        kfs, feats = self.point_observations(src)
        self.pt_obs_kf[src] = -1
        self.pt_obs_feat[src] = -1
        self.pt_valid[src] = False
        self.pt_replaced_by[src] = tgt
        self.dirty_pt.add(src)  # validity is a scattered mirror field
        self.dirty_pt.add(tgt)  # tgt may inherit observations below
        for kf, ft in zip(kfs, feats):
            if (self.pt_obs_kf[tgt] == kf).any():
                if self.kf_obs_point[kf, ft] == src:
                    self.kf_obs_point[kf, ft] = -1
            else:
                self.kf_obs_point[kf, ft] = tgt
                free = np.where(self.pt_obs_kf[tgt] < 0)[0]
                if len(free):
                    s = free[0]
                    self.pt_obs_kf[tgt, s] = kf
                    self.pt_obs_feat[tgt, s] = ft
                    self.pt_n_obs[tgt] += 2 if self.kf_feat_ur[kf, ft] >= 0 else 1
        self.pt_num_visible[tgt] += self.pt_num_visible[src]
        self.pt_num_found[tgt] += self.pt_num_found[src]
        self.pt_n_obs[src] = 0
        self.compute_distinctive_descriptor(tgt)
        self._free_pt.append(src)

    # ------------------------------------------------------- derived attrs

    def compute_distinctive_descriptor(self, p: int) -> None:
        """Median-of-medians descriptor selection (mappoint.cpp:126-191)."""
        kfs, feats = self.point_observations(p)
        if len(kfs) == 0:
            return
        self.dirty_pt.add(p)
        descs = self.kf_feat_desc[kfs, feats]           # (n, 32)
        if len(descs) == 1:
            self.pt_desc[p] = descs[0]
            return
        dist = _POPCNT[descs[:, None, :] ^ descs[None, :, :]].sum(-1)
        med = np.sort(dist, axis=1)[:, (len(descs) - 1) // 2]
        self.pt_desc[p] = descs[int(np.argmin(med))]

    def compute_distinctive_descriptor_batch(self, pids: np.ndarray) -> None:
        """Vectorized median-of-medians over many points at once.

        One (n, MO, MO, 32) popcount pass replaces n Python calls — the
        per-point loop was a measured host hotspot in the KF path
        (VERDICT r1 weak #3)."""
        pids = np.asarray(pids, np.int64)
        pids = pids[self.pt_valid[pids]]
        if len(pids) == 0:
            return
        self.dirty_pt.update(pids.tolist())
        okf = self.pt_obs_kf[pids]                       # (n, MO)
        oft = self.pt_obs_feat[pids]
        m = okf >= 0                                     # (n, MO)
        descs = self.kf_feat_desc[np.maximum(okf, 0), np.maximum(oft, 0)]
        # uint64-word popcount: 4 words/descriptor instead of a 32-byte
        # LUT gather (this pass runs over every touched point per KF and
        # was a measured host hotspot of the fuse/proc_kf stages)
        d64 = np.ascontiguousarray(descs).view(np.uint64)   # (n, MO, 4)
        dist = (
            np.bitwise_count(d64[:, :, None, :] ^ d64[:, None, :, :])
            .sum(-1, dtype=np.int32)
        )
        BIG = np.int32(1 << 20)
        dist = np.where(m[:, :, None] & m[:, None, :], dist.astype(np.int32), BIG)
        cnt = m.sum(1)                                   # obs per point
        dist_sorted = np.sort(dist, axis=2)              # (n, MO, MO)
        med_idx = np.maximum(cnt - 1, 0) // 2
        med = np.take_along_axis(
            dist_sorted, med_idx[:, None, None].repeat(dist.shape[1], 1), axis=2
        )[..., 0]                                        # (n, MO)
        med = np.where(m, med, BIG)
        best = np.argmin(med, axis=1)
        has = cnt > 0
        sel = pids[has]
        self.pt_desc[sel] = descs[np.arange(len(pids)), best][has]

    def update_normal_and_depth(self, p: int) -> None:
        """Ref: mappoint.cpp:211-255."""
        kfs, feats = self.point_observations(p)
        if len(kfs) == 0:
            return
        self.dirty_pt.add(p)
        pos = self.pt_pos[p]
        # camera centers: t_wc = -R_cw^T t_cw
        normals = []
        for kf in kfs:
            R = _quat_to_mat(self.kf_q[kf])
            owi = -R.T @ self.kf_t[kf]
            v = pos - owi
            n = np.linalg.norm(v)
            normals.append(v / max(n, 1e-12))
        self.pt_normal[p] = np.mean(normals, axis=0)
        ref = self.pt_ref_kf[p]
        if ref < 0 or not self.kf_valid[ref]:
            ref = kfs[0]
            self.pt_ref_kf[p] = ref
        R = _quat_to_mat(self.kf_q[ref])
        owr = -R.T @ self.kf_t[ref]
        dist = np.linalg.norm(pos - owr)
        ref_slot = np.where(self.pt_obs_kf[p] == ref)[0]
        level = int(self.kf_feat_octave[ref, self.pt_obs_feat[p, ref_slot[0]]]) if len(ref_slot) else 0
        sf = self.pyr["scale_factors"]
        self.pt_max_dist[p] = dist * sf[level]
        self.pt_min_dist[p] = self.pt_max_dist[p] / sf[-1]

    def update_normal_and_depth_batch(self, pids: np.ndarray) -> None:
        """Vectorized update_normal_and_depth over many points."""
        pids = np.asarray(pids)
        pids = pids[self.pt_valid[pids]]
        if len(pids) == 0:
            return
        self.dirty_pt.update(pids.tolist())
        # camera centers for all valid KFs (batched R^T t)
        t_wc = np.zeros((self.MK, 3))
        kfs_valid = np.where(self.kf_valid)[0]
        if len(kfs_valid):
            R = _quat_to_mat_batch(self.kf_q[kfs_valid])   # (n,3,3)
            t_wc[kfs_valid] = -np.einsum(
                "nji,nj->ni", R, self.kf_t[kfs_valid]
            )

        obs_kf = self.pt_obs_kf[pids]                      # (n, MO)
        mask = obs_kf >= 0
        centers = t_wc[np.maximum(obs_kf, 0)]              # (n, MO, 3)
        v = self.pt_pos[pids][:, None, :] - centers
        norm = np.linalg.norm(v, axis=-1, keepdims=True)
        v = np.where(mask[..., None], v / np.clip(norm, 1e-12, None), 0.0)
        cnt = np.clip(mask.sum(1), 1, None)
        self.pt_normal[pids] = v.sum(1) / cnt[:, None]

        ref = self.pt_ref_kf[pids].copy()
        bad_ref = (ref < 0) | ~self.kf_valid[np.maximum(ref, 0)]
        if bad_ref.any():
            first = np.where(mask, obs_kf, self.MK).min(1)
            ref = np.where(bad_ref, np.where(first < self.MK, first, 0), ref)
            self.pt_ref_kf[pids] = ref
        dist = np.linalg.norm(self.pt_pos[pids] - t_wc[ref], axis=-1)
        # octave of the observation in the ref KF
        ref_slot = np.argmax(obs_kf == ref[:, None], axis=1)
        feat = self.pt_obs_feat[pids, ref_slot]
        level = np.where(
            (obs_kf[np.arange(len(pids)), ref_slot] == ref) & (feat >= 0),
            self.kf_feat_octave[ref, np.maximum(feat, 0)],
            0,
        )
        sf = self.pyr["scale_factors"]
        self.pt_max_dist[pids] = dist * sf[level]
        self.pt_min_dist[pids] = self.pt_max_dist[pids] / sf[-1]

    # ------------------------------------------------------- covisibility

    def update_connections(self, kf: int) -> int:
        """Recompute covisibility links of `kf` (keyframe.cpp:243-316).
        Returns the best-covisible KF (or -1)."""
        pts = self.kf_obs_point[kf]
        pts = pts[pts >= 0]
        okfs = self.pt_obs_kf[pts].ravel()               # (n*MO,)
        okfs = okfs[okfs >= 0]
        counts = np.bincount(okfs, minlength=self.MK).astype(np.int64)
        counts[kf] = 0
        counts[~self.kf_valid] = 0
        self.covis[kf] = counts
        self.covis[:, kf] = counts
        th = self.cfg.loc.covis_weight_thresh
        link = counts >= th
        if not link.any() and counts.max() > 0:
            link[np.argmax(counts)] = True
        self.covis_link[kf] = link
        self.covis_link[:, kf] = link
        return int(np.argmax(counts)) if counts.max() > 0 else -1

    def best_covisible(self, kf: int, n: Optional[int] = None) -> np.ndarray:
        """Top-n connected KFs by weight (keyframe.cpp:163-170)."""
        w = np.where(self.covis_link[kf] & self.kf_valid, self.covis[kf], 0)
        order = np.argsort(-w, kind="stable")
        order = order[w[order] > 0]
        return order[:n] if n is not None else order

    def remove_keyframe(self, kf: int) -> None:
        """Ref: Map::removeKeyFrame (map.cpp:60-104) incl. FrameInfo
        re-anchoring to the best covisible KF."""
        if self.kf_frame_idx[kf] == 0 or not self.kf_valid[kf]:
            return
        covis = self.best_covisible(kf)
        if len(covis) == 0:
            return  # keep: nothing to re-anchor to
        tgt = int(covis[0])

        pts = np.unique(self.kf_obs_point[kf][self.kf_obs_point[kf] >= 0])
        for p in pts:
            if self.remove_observation(p, kf):
                self.remove_point(p)

        # re-anchor frame infos: Trc' = (T_tgt_w * T_w_kf) * Trc
        q_tr, t_tr = _compose(
            self.kf_q[tgt], self.kf_t[tgt], *_inverse(self.kf_q[kf], self.kf_t[kf])
        )
        for info in self.frame_infos:
            if info.ref_kf == kf:
                info.ref_kf = tgt
                info.q_cr, info.t_cr = _compose(q_tr, t_tr, info.q_cr, info.t_cr)

        self.covis[kf] = 0
        self.covis[:, kf] = 0
        self.covis_link[kf] = False
        self.covis_link[:, kf] = False
        self.kf_valid[kf] = False
        self.kf_feat_valid[kf] = False
        self.kf_obs_point[kf] = -1
        self._kf_order.remove(kf)
        self._free_kf.append(kf)
        self.map_version += 1
        self.dirty_kf.add(kf)

    # ------------------------------------------------------- trajectory

    def update_frame_info(self, frame) -> None:
        """Record frame pose relative to its reference KF (map.cpp:23-38)."""
        ref = frame.ref_kf
        q_rc, t_rc = _compose(
            self.kf_q[ref], self.kf_t[ref], *_inverse(frame.q_cw, frame.t_cw)
        )
        self.frame_infos.append(
            FrameInfo(frame.timestamp, ref, q_rc, t_rc)
        )

    def export_trajectory(self):
        """All frame poses T_wc via ref-KF anchoring (map.cpp:162-188).
        Returns (timestamps (N,), q_wc (N,4), t_wc (N,3))."""
        ts, qs, ts_ = [], [], []
        for info in self.frame_infos:
            q_wr, t_wr = _inverse(self.kf_q[info.ref_kf], self.kf_t[info.ref_kf])
            q, t = _compose(q_wr, t_wr, info.q_cr, info.t_cr)
            ts.append(info.timestamp)
            qs.append(q)
            ts_.append(t)
        return np.array(ts), np.array(qs), np.array(ts_)

    def save_trajectory_tum(self, path: str) -> None:
        """TUM format: t x y z qx qy qz qw (map.cpp summarize)."""
        ts, qs, trs = self.export_trajectory()
        with open(path, "w") as f:
            for i in range(len(ts)):
                w, x, y, z = qs[i]
                tx, ty, tz = trs[i]
                f.write(
                    f"{ts[i]:.6f} {tx:.9f} {ty:.9f} {tz:.9f} "
                    f"{x:.9f} {y:.9f} {z:.9f} {w:.9f}\n"
                )

    # ------------------------------------------------------- invariants

    def check_invariants(self) -> None:
        """Cross-check the two observation tables (tests only)."""
        for p in np.where(self.pt_valid)[0]:
            kfs, feats = self.point_observations(p)
            for kf, ft in zip(kfs, feats):
                assert self.kf_valid[kf], (p, kf)
                assert self.kf_obs_point[kf, ft] == p, (p, kf, ft)
        for kf in np.where(self.kf_valid)[0]:
            feats = np.where(self.kf_obs_point[kf] >= 0)[0]
            for ft in feats:
                p = self.kf_obs_point[kf, ft]
                assert self.pt_valid[p], (kf, ft, p)
                assert (self.pt_obs_kf[p] == kf).any(), (kf, ft, p)


# --------------------------------------------------------------------------
# tiny host-side quaternion helpers (float64 numpy)
# --------------------------------------------------------------------------


def _quat_to_mat_batch(q):
    """(n,4) wxyz -> (n,3,3) rotation matrices (vectorized _quat_to_mat)."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty(q.shape[:1] + (3, 3), q.dtype)
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def _quat_rotate(q, v):
    return _quat_to_mat(q) @ v


def _compose(qa, ta, qb, tb):
    return _quat_mul(qa, qb), _quat_rotate(qa, tb) + ta


def _inverse(q, t):
    qi = q * np.array([1.0, -1.0, -1.0, -1.0])
    return qi, -_quat_rotate(qi, t)
