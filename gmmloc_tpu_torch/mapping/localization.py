"""Back-end: keyframe processing, culling, triangulation, fusion, local BA.

PyTorch port of `gmmloc_tpu/mapping/localization.py`. One keyframe's
pipeline (spinOnce, localization.cpp:65-122):

  processNewKeyFrame -> removeMapPoints -> createMapPoints ->
  searchInNeighbors -> jointOptimization -> removeKeyFrames

Triangulation search and solve, fusion matching and the staged local BA
run as batched tensor programs on the device; map surgery stays on the
host registry (`MapState`). With `LocConfig.use_device_world` (the
default) the device problems gather from the card mirror
(`device_world.DeviceWorld`): the fused triangulation
(`tri_kernel.triangulate_kernel`), the fusion gather
(`matching.fuse_project_match_gather`) and the BA assembly
(`ba_assemble.assemble_and_solve`); without it the host assembles and
uploads them.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import map_state as ms
from ..utils.timing import Timer

from ..config import SystemConfig
from ..features import matching
from ..geometry import camera as cam_mod
from ..solver import local_ba, point_solver
from . import ba_assemble, tri_kernel
from .association import GMMAssociator, bucket_size
from .device_world import DeviceWorld

TRI_NEIGHBORS = 10   # covisible keyframes a new keyframe triangulates against
FUSE_CHUNK = 2048    # landmarks per device fusion job; larger query sets take more jobs


class Localization:
    def __init__(self, cfg: SystemConfig, cam: cam_mod.CameraParams,
                 world: ms.MapState, associator: GMMAssociator, device):
        self.cfg = cfg
        self.cam = cam
        self.world = world
        self.assoc = associator
        self.device = torch.device(device)
        self.queue: List[int] = []
        self.candidate_points: List[int] = []
        self.ba_stats: List[dict] = []
        # per-KF fused-triangulation match counts (budget sizing record)
        self.tri_stats: List[int] = []
        self.curr_kf: int = -1
        self.is_idle = True
        self.abort_ba = False
        self._ba_graphs = {}     # the BA's kept LM-iteration graphs (joint_optimization)
        self._K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
        self.dev_world = (DeviceWorld(world, self.device) if cfg.loc.use_device_world
                          else None)

    def _t(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------

    def insert_keyframe(self, kf: int) -> None:
        self.queue.append(kf)
        self.abort_ba = True

    def count_queue(self) -> int:
        return len(self.queue)

    def spin_once(self) -> None:
        """Ref spinOnce (localization.cpp:65-122)."""
        if not self.queue:
            return
        self.is_idle = False
        with Timer("loc"):
            with Timer("loc/proc_kf"):
                self.process_new_keyframe()
            with Timer("loc/cull_pts"):
                self.remove_map_points()
            with Timer("loc/triangulate"):
                self.create_map_points()
            if not self.queue:
                with Timer("loc/fuse"):
                    self.search_in_neighbors()
            self.abort_ba = False
            if not self.queue:
                if self.world.n_keyframes() > 2:
                    with Timer("loc/ba"):
                        self.joint_optimization()
                with Timer("loc/cull_kfs"):
                    self.remove_keyframes()
        self.is_idle = True

    # ------------------------------------------------------------------

    def process_new_keyframe(self) -> None:
        """Bind observations, update covisibility (localization.cpp:412-447)."""
        w = self.world
        kf = self.queue.pop(0)
        self.curr_kf = kf
        obs = w.kf_obs_point[kf]
        idx = np.where(obs >= 0)[0]
        p = obs[idx]
        bad = ~w.pt_valid[p]
        w.kf_obs_point[kf, idx[bad]] = -1
        idx, p = idx[~bad], p[~bad]
        already = (w.pt_obs_kf[p] == kf).any(axis=1)
        # duplicate bindings of one point within this KF: first wins
        _, first = np.unique(p, return_index=True)
        dup = np.ones(len(p), bool)
        dup[first] = False
        self.candidate_points.extend(p[already | dup].tolist())
        keep = ~already & ~dup
        new_pts, new_idx = p[keep], idx[keep]
        w.kf_obs_point[kf, new_idx] = -1
        w.add_observations_batch(new_pts, kf, new_idx)
        w.compute_distinctive_descriptor_batch(new_pts)
        w.update_normal_and_depth_batch(new_pts)
        w.update_connections(kf)

    def remove_map_points(self) -> None:
        """Cull recent map points (localization.cpp:127-150)."""
        w = self.world
        curr_idx = w.kf_frame_idx[self.curr_kf]
        cand = np.array(sorted(set(self.candidate_points)), np.int64)
        if len(cand) == 0:
            return
        cand = cand[w.pt_valid[cand]]
        found_ratio = w.pt_num_found[cand] / np.maximum(1, w.pt_num_visible[cand])
        age = curr_idx - w.pt_created_kf_idx[cand]
        cull = (found_ratio < self.cfg.loc.cull_found_ratio) | (
            (age >= 2) & (w.pt_n_obs[cand] <= self.cfg.loc.cull_min_obs))
        for p in cand[cull]:
            w.remove_point(p)
        self.candidate_points = cand[~cull & (age < 3)].tolist()

    # ------------------------------------------------------------------

    def _fundamental_np(self, q1, t1, q2, t2) -> np.ndarray:
        """F with l2 = F^T p1 (ref math_utils.cpp:17-44), on the host."""
        q12, t12 = ms._compose(q1, t1, *ms._inverse(q2, t2))
        R12 = ms._quat_to_mat(q12)
        tx = np.array([[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]],
                       [-t12[1], t12[0], 0]])
        Kinv = np.linalg.inv(self._K)
        return Kinv.T @ (tx @ R12) @ Kinv

    def create_map_points(self) -> int:
        """Triangulate new points with covisible KFs
        (localization_opt.cpp:206-455): one batched epipolar search over
        all neighbour pairs and one batched GMM-constrained solve over all
        candidate matches, first-wins by covisibility order."""
        w = self.world
        cfg = self.cfg
        kf1 = self.curr_kf
        neigh = w.best_covisible(kf1, TRI_NEIGHBORS)
        sigma2 = w.pyr["sigma2"]
        ratio_factor = 1.5 * cfg.frame.scale_factor
        q1, t1 = w.kf_q[kf1], w.kf_t[kf1]
        _, t1_wc = ms._inverse(q1, t1)
        baseline_min = self.cam.bf / self.cam.fx

        kf2s, fmats, eps = [], [], []
        for kf2 in neigh:
            R2 = ms._quat_to_mat(w.kf_q[kf2])
            t2 = w.kf_t[kf2]
            if np.linalg.norm(-R2.T @ t2 - t1_wc) < baseline_min:
                continue  # too-short baseline (:259-262)
            fmats.append(self._fundamental_np(q1, t1, w.kf_q[kf2], t2))
            C2 = R2 @ t1_wc + t2
            eps.append([self.cam.fx * C2[0] / C2[2] + self.cam.cx,
                        self.cam.fy * C2[1] / C2[2] + self.cam.cy])
            kf2s.append(int(kf2))
        if not kf2s:
            return 0
        free1 = w.kf_feat_valid[kf1] & (w.kf_obs_point[kf1] < 0)
        free2 = w.kf_feat_valid[kf2s] & (w.kf_obs_point[kf2s] < 0)
        t = self._t
        dv = self.dev_world
        if dv is not None:
            with Timer("loc/tri_sync"):
                dv.sync()
            if cfg.loc.fused_tri:
                return self._triangulate_fused(kf1, kf2s, free1, free2, fmats, eps,
                                               ratio_factor)
            with Timer("loc/tri_search"):
                match = matching.search_for_triangulation_gather(
                    kf1, t(kf2s, torch.int64), t(free1, torch.bool), t(free2, torch.bool),
                    t(np.stack(fmats)), t(np.array(eps)), t(sigma2),
                    dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_desc,
                    dv.kf_feat_octave, dv.kf_feat_angle).cpu().numpy()
            return self._triangulate_table(kf1, kf2s, match, ratio_factor)
        with Timer("loc/tri_search"):
            match = matching.search_for_triangulation_batch(
                t(w.kf_feat_uv[kf1]), t(w.kf_feat_ur[kf1]),
                t(w.kf_feat_desc[kf1], torch.uint8),
                t(w.kf_feat_octave[kf1], torch.int64), t(w.kf_feat_angle[kf1]),
                t(free1, torch.bool),
                t(w.kf_feat_uv[kf2s]), t(w.kf_feat_ur[kf2s]),
                t(w.kf_feat_desc[kf2s], torch.uint8),
                t(w.kf_feat_octave[kf2s], torch.int64), t(w.kf_feat_angle[kf2s]),
                t(free2, torch.bool),
                t(np.stack(fmats)), t(np.array(eps)), t(sigma2),
            ).cpu().numpy()                                   # (T, F)
        return self._triangulate_table(kf1, kf2s, match, ratio_factor)

    def _triangulate_table(self, kf1, kf2s, match, ratio_factor) -> int:
        """_triangulate_matches on a (T, F) match table, pair-major."""
        pair_t, idx1 = np.nonzero(match >= 0)
        if len(idx1) == 0:
            return 0
        idx2 = match[pair_t, idx1]
        kf2_of = np.array(kf2s)[pair_t]
        return self._triangulate_matches(kf1, kf2_of, idx1, idx2, ratio_factor)

    def _triangulate_fused(self, kf1, kf2s, free1, free2, fmats, eps,
                           ratio_factor) -> int:
        """Fused triangulation (tri_kernel.py): search, init, candidate
        solve, gates and first-wins selection enqueued as one device
        program on the mirror; one packed read of the per-match records,
        then the map surgery for the winners."""
        w = self.world
        cfg = self.cfg
        dv = self.dev_world
        t = self._t
        gm = self.assoc.gmap
        with Timer("loc/tri_solve"):
            (win, idx1, idx2, pair_t, pts, hstr, str_comp, from_mono,
             n_m) = tri_kernel.triangulate_kernel(
                self.cam, kf1, t(kf2s, torch.int64),
                torch.ones(len(kf2s), dtype=torch.bool, device=self.device),
                t(free1, torch.bool), t(free2, torch.bool), t(np.stack(fmats)),
                t(np.array(eps)), t(w.pyr["sigma2"]), t(w.pyr["sigma2_inv"]),
                t(w.pyr["scale_factors"]),
                dv.kf_q, dv.kf_t, dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_desc,
                dv.kf_feat_octave, dv.kf_feat_angle, dv.kf_feat_depth,
                dv.kf_comp_cand, gm.means, gm.normal, gm.is_degenerated,
                m_tri=cfg.caps.tri_match_budget, tri_lambda2=cfg.loc.tri_lambda2,
                tri_opt_iters=cfg.loc.tri_opt_iters,
                tri_check_str_chi2=cfg.loc.tri_check_str_chi2,
                tri_str_thresh=cfg.loc.tri_str_thresh, ratio_factor=ratio_factor)
            # one read: every record is exact in float32 (ids < 2^24)
            rec = torch.cat([
                torch.stack([win, hstr, from_mono]).to(torch.float32),
                torch.stack([idx1, idx2, pair_t, str_comp]).to(torch.float32),
                pts.T.to(torch.float32),
                n_m.to(torch.float32).expand(1, win.shape[0]),
            ]).cpu().numpy()
        win, hstr, from_mono = rec[0] > 0.5, rec[1] > 0.5, rec[2] > 0.5
        idx1, idx2, pair_t, str_comp = (rec[i].astype(np.int64) for i in range(3, 7))
        pts = rec[7:10].T.astype(np.float64)
        n_m = int(rec[10, 0]) if rec.shape[1] else 0
        self.tri_stats.append(n_m)
        if n_m > cfg.caps.tri_match_budget:
            # no silent truncation: the budget dropped candidate matches
            print(f"[tri] match budget bound at kf{kf1}: {n_m} matches > "
                  f"budget {cfg.caps.tri_match_budget}", flush=True)
        wi = np.where(win)[0]
        if len(wi) == 0:
            return 0
        kf2_of = np.array(kf2s)[pair_t[wi]]
        pids = np.array([
            w.alloc_point(pts[j], ref_kf=kf1, created_kf_idx=w.kf_frame_idx[kf1])
            for j in wi
        ], np.int64)
        return self._bind_new_points(kf1, pids, from_mono[wi], hstr[wi], str_comp[wi],
                                     idx1[wi], kf2_of, idx2[wi])

    def _bind_new_points(self, kf1, pids, mono, hstr, str_comp, idx1, kf2_of, idx2) -> int:
        """Type, association and observations of freshly triangulated
        points (one per match: kf1 feature idx1, keyframe kf2_of feature
        idx2)."""
        w = self.world
        w.pt_type[pids] = np.where(
            mono, np.where(hstr, ms.PT_FROM_TRI_MONO_GMM, ms.PT_FROM_TRI_MONO),
            np.where(hstr, ms.PT_FROM_TRI_STEREO_GMM, ms.PT_FROM_TRI_STEREO),
        ).astype(w.pt_type.dtype)
        w.pt_assoc_comp[pids[hstr]] = str_comp[hstr]
        w.add_observations_batch(pids, kf1, idx1)
        for k2 in np.unique(kf2_of):
            g = kf2_of == k2
            w.add_observations_batch(pids[g], int(k2), idx2[g])
        w.compute_distinctive_descriptor_batch(pids)
        w.update_normal_and_depth_batch(pids)
        self.candidate_points.extend(pids.tolist())
        return len(pids)

    def _triangulate_matches(self, kf1, kf2_of, idx1, idx2, ratio_factor) -> int:
        """DLT / stereo initialisation, the batched GMM-constrained solve
        and the acceptance gates (localization_opt.cpp:283-445) over the
        matches of all neighbour pairs at once (`kf2_of` per match, in
        pair-major covisibility order, which drives first-wins)."""
        w = self.world
        cfg = self.cfg
        cam = self.cam
        kf2_of = np.asarray(kf2_of)
        M = len(idx1)
        sigma2 = w.pyr["sigma2"]
        sigma2_inv = w.pyr["sigma2_inv"]
        sf = w.pyr["scale_factors"]

        q1, t1 = w.kf_q[kf1], w.kf_t[kf1]
        q2, t2 = w.kf_q[kf2_of], w.kf_t[kf2_of]
        R1 = ms._quat_to_mat(q1)
        R2 = ms._quat_to_mat_batch(q2)
        T1 = np.eye(4)
        T1[:3, :3], T1[:3, 3] = R1, t1
        T2 = np.tile(np.eye(4), (M, 1, 1))
        T2[:, :3, :3], T2[:, :3, 3] = R2, t2
        t1_wc = -R1.T @ t1
        t2_wc = -np.einsum("mji,mj->mi", R2, t2)

        uv1 = w.kf_feat_uv[kf1][idx1]
        uv2 = w.kf_feat_uv[kf2_of, idx2]
        ur1 = w.kf_feat_ur[kf1][idx1]
        ur2 = w.kf_feat_ur[kf2_of, idx2]
        z1 = w.kf_feat_depth[kf1][idx1]
        z2 = w.kf_feat_depth[kf2_of, idx2]
        oct1 = w.kf_feat_octave[kf1][idx1]
        oct2 = w.kf_feat_octave[kf2_of, idx2]
        st1 = ur1 >= 0
        st2 = ur2 >= 0

        xn1 = np.stack([(uv1[:, 0] - cam.cx) / cam.fx, (uv1[:, 1] - cam.cy) / cam.fy,
                        np.ones(M)], -1)
        xn2 = np.stack([(uv2[:, 0] - cam.cx) / cam.fx, (uv2[:, 1] - cam.cy) / cam.fy,
                        np.ones(M)], -1)
        ray1 = xn1 @ R1
        ray2 = np.einsum("mi,mij->mj", xn2, R2)
        cos_rays = np.einsum("mi,mi->m", ray1, ray2) / (
            np.linalg.norm(ray1, axis=1) * np.linalg.norm(ray2, axis=1))
        b = cam.bf / cam.fx
        cos_st1 = np.where(st1, np.cos(2 * np.arctan2(b / 2, np.maximum(z1, 1e-6))),
                           cos_rays + 1)
        cos_st2 = np.where(st2, np.cos(2 * np.arctan2(b / 2, np.maximum(z2, 1e-6))),
                           cos_rays + 1)
        cos_stereo = np.minimum(cos_st1, cos_st2)
        use_dlt = (cos_rays < cos_stereo) & (cos_rays > 0) & (
            st1 | st2 | (cos_rays < 0.9998))
        use_s1 = ~use_dlt & st1 & (cos_st1 < cos_st2)
        use_s2 = ~use_dlt & st2 & (cos_st2 <= cos_st1) & ~use_s1
        usable = use_dlt | use_s1 | use_s2
        from_mono = use_dlt

        pts0 = np.zeros((M, 3))
        di = np.where(use_dlt)[0]
        if len(di):  # DLT (SVD on 4x4, :320-341)
            A = np.stack([
                xn1[di, 0, None] * T1[2] - T1[0],
                xn1[di, 1, None] * T1[2] - T1[1],
                xn2[di, 0, None] * T2[di, 2] - T2[di, 0],
                xn2[di, 1, None] * T2[di, 2] - T2[di, 1],
            ], axis=1)
            _, _, Vt = np.linalg.svd(A)
            v = Vt[:, 3]
            bad = np.abs(v[:, 3]) < 1e-12
            usable[di[bad]] = False
            pts0[di] = v[:, :3] / np.where(bad[:, None], 1.0, v[:, 3:4])
        s1i = np.where(use_s1)[0]
        if len(s1i):
            pts0[s1i] = (xn1[s1i] * z1[s1i, None] - t1) @ R1
        s2i_ = np.where(use_s2)[0]
        if len(s2i_):
            pts0[s2i_] = np.einsum("mi,mij->mj", xn2[s2i_] * z2[s2i_, None] - t2[s2i_],
                                   R2[s2i_])
        mi = np.where(usable)[0]
        if len(mi) == 0:
            return 0

        # candidate degenerate components: union of both features' candidates
        cands = np.concatenate([w.kf_comp_cand[kf1][idx1],
                                w.kf_comp_cand[kf2_of, idx2]], axis=1)
        deg = self.assoc._deg
        cands = np.where((cands >= 0) & deg[np.maximum(cands, 0)], cands, -1)
        obs1 = np.concatenate([uv1, ur1[:, None]], -1)
        obs2 = np.concatenate([uv2, ur2[:, None]], -1)
        s2i1 = sigma2_inv[oct1]   # the reference uses sigma2_inv1 for both edges

        CK = cands.shape[1]
        flat_c = cands[mi].reshape(-1)
        n_flat = len(flat_c)
        B = bucket_size(n_flat)

        def padb(a, fill=0.0):
            a = np.asarray(a)
            out = np.full((B,) + a.shape[1:], fill, a.dtype)
            out[:n_flat] = a
            return out

        safe_c = np.maximum(padb(flat_c, 0), 0)
        rep = lambda a: np.repeat(a[mi], CK, axis=0)
        t = self._t
        with Timer("loc/tri_solve"):
            x_opt, c1o, c2o, cso = point_solver.optimize_triangulation(
                cam,
                t(padb(rep(pts0))),
                t(q1).expand(B, 4), t(t1).expand(B, 3),
                t(padb(rep(obs1))), t(padb(rep(st1), False), torch.bool),
                t(padb(rep(s2i1), 1.0)),
                t(padb(rep(q2))), t(padb(rep(t2))), t(padb(rep(obs2))),
                t(padb(rep(st2), False), torch.bool), t(padb(rep(s2i1), 1.0)),
                t(self.assoc._normal[safe_c]), t(self.assoc._means[safe_c]),
                tri_lambda2=cfg.loc.tri_lambda2, iters=cfg.loc.tri_opt_iters,
            )
            x_opt, c1o, c2o, cso = (a.cpu().numpy()[:n_flat] for a in (x_opt, c1o, c2o, cso))
        x_opt = x_opt.reshape(len(mi), CK, 3)
        c1o = c1o.reshape(len(mi), CK)
        c2o = c2o.reshape(len(mi), CK)
        cso = cso.reshape(len(mi), CK)

        th1 = np.where(st1[mi], 7.8, 5.991)[:, None]
        th2 = np.where(st2[mi], 7.8, 5.991)[:, None]
        ok = (flat_c.reshape(len(mi), CK) >= 0) & (c1o <= th1) & (c2o <= th2)
        if cfg.loc.tri_check_str_chi2:
            ok &= cso <= cfg.loc.tri_str_thresh * cfg.loc.tri_lambda2
        err_sum = np.where(ok, c1o + c2o, np.inf)
        best = np.argmin(err_sum, axis=1)
        ar = np.arange(len(mi))
        has_str = np.isfinite(err_sum[ar, best])
        str_comp = np.where(has_str, cands[mi][ar, best], -1)
        pts = np.where(has_str[:, None], x_opt[ar, best], pts0[mi])

        def reproj_ok(pc, uvk, urk, stk):
            z = pc[:, 2]
            zs = np.where(np.abs(z) < 1e-12, 1e-12, z)
            u = cam.fx * pc[:, 0] / zs + cam.cx
            v = cam.fy * pc[:, 1] / zs + cam.cy
            err = (u - uvk[:, 0]) ** 2 + (v - uvk[:, 1]) ** 2
            e = np.where(stk, err + (u - cam.bf / zs - urk) ** 2, err)
            th = np.where(stk, 7.8, 5.991)
            # the reference scales both gates by sigma2[kp1.octave] (:371,:382)
            return (z > 0) & (e <= th * sigma2[oct1[mi]])

        ok_pt = reproj_ok(pts @ R1.T + t1, uv1[mi], ur1[mi], st1[mi])
        pc2 = np.einsum("mij,mj->mi", R2[mi], pts) + t2[mi]
        ok_pt &= reproj_ok(pc2, uv2[mi], ur2[mi], st2[mi])
        d1 = np.linalg.norm(pts - t1_wc, axis=1)
        d2 = np.linalg.norm(pts - t2_wc[mi], axis=1)
        ok_pt &= (d1 >= 1e-9) & (d2 >= 1e-9)
        ratio_dist = d2 / np.maximum(d1, 1e-9)
        ratio_oct = sf[oct1[mi]] / sf[oct2[mi]]
        ok_pt &= (ratio_dist * ratio_factor >= ratio_oct) & (
            ratio_dist <= ratio_oct * ratio_factor)

        win = np.where(ok_pt)[0]
        if len(win) == 0:
            return 0
        # first wins per kf1 feature across pairs (mi is pair-major)
        _, first = np.unique(idx1[mi[win]], return_index=True)
        win = win[np.sort(first)]
        m_sel = mi[win]
        pids = np.array([
            w.alloc_point(pts[j], ref_kf=kf1, created_kf_idx=w.kf_frame_idx[kf1])
            for j in win
        ], np.int64)
        return self._bind_new_points(kf1, pids, from_mono[m_sel], has_str[win],
                                     str_comp[win], idx1[m_sel], kf2_of[m_sel],
                                     idx2[m_sel])

    # ------------------------------------------------------------------

    def search_in_neighbors(self) -> None:
        """Fuse duplicated landmarks with the 1st+2nd-ring covisible KFs
        (localization.cpp:154-223)."""
        w = self.world
        kf = self.curr_kf
        tgt = []
        seen = set()
        for kf1 in w.best_covisible(kf, 10):
            if kf1 in seen or not w.kf_valid[kf1]:
                continue
            seen.add(kf1)
            tgt.append(kf1)
            for kf2 in w.best_covisible(kf1, 5):
                if kf2 in seen or kf2 == kf or not w.kf_valid[kf2]:
                    continue
                seen.add(kf2)
                tgt.append(kf2)
        obs = w.kf_obs_point[kf]
        curr_pts = np.unique(obs[obs >= 0])
        all_tgt = w.kf_obs_point[tgt].ravel() if tgt else np.zeros(0, np.int32)
        all_tgt = np.unique(all_tgt[all_tgt >= 0])
        stamp = w.kf_frame_idx[kf]
        fc = all_tgt[w.pt_valid[all_tgt] & (w.pt_fuse_tgt_kf[all_tgt] != stamp)]
        w.pt_fuse_tgt_kf[fc] = stamp
        # forward jobs (the current KF's landmarks against each target)
        # and the reverse job (2nd-ring landmarks against the current KF)
        jobs = [(int(k), curr_pts) for k in tgt]
        if len(fc):
            jobs.append((kf, fc))
        if self.dev_world is not None:
            self._fuse_device_jobs(jobs)
        else:
            self._fuse_jobs(jobs)
        o = w.kf_obs_point[kf]
        upd = np.unique(o[o >= 0])
        w.compute_distinctive_descriptor_batch(upd)
        w.update_normal_and_depth_batch(upd)
        w.update_connections(kf)

    def _fuse_prepare(self, kf: int, pids: np.ndarray, th: float = 3.0):
        """Host gating for fuseObservations (localization.cpp:226-325):
        projection, scale/view-cos gates, predicted level."""
        w = self.world
        cam = self.cam
        pids = pids[w.pt_valid[pids]]
        if len(pids) == 0:
            return None
        pids = pids[~(w.pt_obs_kf[pids] == kf).any(axis=1)]
        if len(pids) == 0:
            return None
        R = ms._quat_to_mat(w.kf_q[kf])
        t = w.kf_t[kf]
        t_wc = -R.T @ t
        pos = w.pt_pos[pids]
        pc = pos @ R.T + t
        z = pc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v = cam.fy * pc[:, 1] / zs + cam.cy
        ur = u - cam.bf / zs
        inside = (z > 0) & (u >= 0) & (v >= 0) & (u < cam.width) & (v < cam.height)
        vdir = pos - t_wc
        dist = np.linalg.norm(vdir, axis=-1)
        ok = inside & (dist >= 0.8 * w.pt_min_dist[pids]) & (
            dist <= 1.2 * w.pt_max_dist[pids]) & (dist > 1e-9)
        vc = np.einsum("ni,ni->n", vdir, w.pt_normal[pids]) / np.clip(dist, 1e-9, None)
        ok &= vc >= 0.5
        lvl = np.ceil(
            np.log(np.clip(w.pt_max_dist[pids] / np.clip(dist, 1e-9, None), 1e-9, None))
            / w.pyr["log_scale_factor"]).astype(np.int32)
        lvl = np.clip(lvl, 0, self.cfg.frame.num_levels - 1)
        pids, u, v, ur, lvl = pids[ok], u[ok], v[ok], ur[ok], lvl[ok]
        if len(pids) == 0:
            return None
        return (pids, np.stack([u, v], -1), ur, lvl, th * w.pyr["scale_factors"][lvl])

    def _fuse_jobs(self, jobs) -> int:
        """fuseObservations over (target KF, query set) jobs: one batched
        device matching pass, then the host's add-or-replace surgery."""
        w = self.world
        prepped = []
        for k, pids in jobs:
            pr = self._fuse_prepare(k, pids)
            if pr is not None:
                prepped.append((k,) + pr)
        if not prepped:
            return 0
        B = bucket_size(max(len(p[1]) for p in prepped))

        def pad(a, fill, dtype):
            a = np.asarray(a)
            out = np.full((B,) + a.shape[1:], fill, dtype)
            out[: len(a)] = a
            return out

        kfs = [p[0] for p in prepped]
        t = self._t
        with Timer("loc/fuse_match"):
            match = matching.fuse_match_batch(
                t(np.stack([pad(p[2], 0.0, np.float32) for p in prepped])),
                t(np.stack([pad(p[3], -1.0, np.float32) for p in prepped])),
                t(np.stack([pad(w.pt_desc[p[1]], 0, np.uint8) for p in prepped]),
                  torch.uint8),
                t(np.stack([pad(p[4], 0, np.int64) for p in prepped]), torch.int64),
                t(np.stack([pad(p[5], 1.0, np.float32) for p in prepped])),
                t(np.stack([pad(np.ones(len(p[1]), bool), False, bool)
                            for p in prepped]), torch.bool),
                t(w.kf_feat_uv[kfs]), t(w.kf_feat_ur[kfs]),
                t(w.kf_feat_desc[kfs], torch.uint8),
                t(w.kf_feat_octave[kfs], torch.int64),
                t(w.kf_feat_valid[kfs], torch.bool),
                t(w.pyr["sigma2_inv"]),
            ).cpu().numpy()
        num_fused = 0
        for ti, (k, pids, *_rest) in enumerate(prepped):
            m = match[ti][: len(pids)]
            for j in np.where(m >= 0)[0]:
                num_fused += self._fuse_one(k, pids[j], int(m[j]))
        return num_fused

    def _fuse_one(self, k: int, p: int, ft: int) -> int:
        """Add-or-replace surgery for one match of landmark p to feature ft
        of keyframe k (localization.cpp:300-318). Returns 1 if it fused."""
        w = self.world
        if not w.pt_valid[p]:
            return 0
        existing = w.kf_obs_point[k, ft]
        if existing >= 0 and w.pt_valid[existing]:
            if w.pt_n_obs[existing] > w.pt_n_obs[p]:
                w.replace_point(p, existing)
            else:
                w.replace_point(existing, p)
        else:
            w.add_observation(p, k, ft)
        return 1

    def _fuse_device_jobs(self, jobs, th: float = 3.0) -> int:
        """fuseObservations over (target KF, query set) jobs with the world
        on the card: projection, gating and matching gather from the
        mirror (matching.fuse_project_match_gather); the host uploads only
        the query ids, target ids and the per-row already-observed mask.
        Query sets over FUSE_CHUNK landmarks are split into more rows. Surgery
        as _fuse_jobs: the non-interacting majority (free feature slot, no
        duplicate claims) in one batch, the collisions one by one in the
        original order."""
        w = self.world
        rows = []
        for k, pids in jobs:
            pids = np.asarray(pids, np.int64)
            pids = pids[w.pt_valid[pids]]
            for i in range(0, len(pids), FUSE_CHUNK):
                rows.append((int(k), pids[i:i + FUSE_CHUNK]))
        if not rows:
            return 0
        dv = self.dev_world
        with Timer("loc/fuse_sync"):
            dv.sync()
        T = len(rows)
        B = max(len(p) for _, p in rows)
        with Timer("loc/fuse_prep"):
            kf_arr = np.array([k for k, _ in rows], np.int64)
            pid_pad = np.zeros((T, B), np.int64)
            q_ok = np.zeros((T, B), bool)
            for ti, (_, p) in enumerate(rows):
                pid_pad[ti, :len(p)] = p
                q_ok[ti, :len(p)] = True
            # landmark already observed by the target (host registry)
            skip = (w.pt_obs_kf[pid_pad] == kf_arr[:, None, None]).any(-1)
        t = self._t
        with Timer("loc/fuse_match"):
            match = matching.fuse_project_match_gather(
                self.cam, t(kf_arr, torch.int64),
                torch.ones(T, dtype=torch.bool, device=self.device),
                t(pid_pad, torch.int64), t(q_ok, torch.bool), t(skip, torch.bool),
                dv.kf_q, dv.kf_t, dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_desc,
                dv.kf_feat_octave, dv.kf_feat_valid,
                dv.pt_pos, dv.pt_normal, dv.pt_min_dist, dv.pt_max_dist,
                dv.pt_desc, dv.pt_valid,
                t(w.pyr["sigma2_inv"]), t(w.pyr["scale_factors"]),
                float(w.pyr["log_scale_factor"]), th=th,
            ).cpu().numpy()
        num_fused = 0
        for ti in range(T):
            k = int(kf_arr[ti])
            pids = rows[ti][1]
            m = match[ti][:len(pids)]
            js = np.where(m >= 0)[0]
            if len(js) == 0:
                continue
            p = pids[js]
            ft = np.asarray(m[js], np.int64)
            existing = w.kf_obs_point[k, ft]
            uft, cnt = np.unique(ft, return_counts=True)
            easy = w.pt_valid[p] & (existing < 0) & ~np.isin(ft, uft[cnt > 1])
            if easy.any():
                w.add_observations_batch(p[easy], k, ft[easy])
                num_fused += int(easy.sum())
            for j in js[~easy]:
                num_fused += self._fuse_one(k, pids[j], int(m[j]))
        return num_fused

    # ------------------------------------------------------------------

    def joint_optimization(self) -> None:
        """Gather the local window, run the staged Schur BA, write back
        (localization_opt.cpp:456-925). On the card the BA's LM-iteration
        graphs are kept per window tier for this localizer's later solves
        (`local_ba.reuse_graphs`)."""
        with local_ba.reuse_graphs(self._ba_graphs):
            return self._joint_optimization()

    def _joint_optimization(self) -> None:
        w = self.world
        cfg = self.cfg
        caps = cfg.caps
        kf0 = self.curr_kf
        local = [kf0] + [int(k) for k in w.best_covisible(kf0)]
        local_all = [k for k in local if w.kf_valid[k]]
        local = local_all[: caps.local_ba_kfs]
        local_set = set(local)
        pts = set()
        for k in local:
            o = w.kf_obs_point[k]
            pts.update(o[o >= 0].tolist())
        pts_all = [p for p in pts if w.pt_valid[p]]
        pts = pts_all[: caps.local_ba_points]
        dropped_local = len(local_all) - len(local)
        dropped_pts = len(pts_all) - len(pts)

        fixed = []
        fixed_set = set()
        for p in pts:
            kfs = w.pt_obs_kf[p]
            for k in kfs[kfs >= 0]:
                if k not in local_set and k not in fixed_set and w.kf_valid[k]:
                    fixed_set.add(int(k))
                    fixed.append(int(k))
        fixed = fixed[: caps.fixed_ba_kfs]

        # the prior acts on camera slot 0: the first map KF moves to the
        # front of the local list when it is in the window
        first_kf = w._kf_order[0] if w._kf_order else -1
        has_prior = cfg.loc.ba_first_as_prior and (first_kf in local_set)
        if has_prior:
            local.remove(first_kf)
            local.insert(0, first_kf)
        elif not cfg.loc.ba_first_as_prior and first_kf in local_set:
            local.remove(first_kf)
            fixed.insert(0, first_kf)
            local_set.discard(first_kf)
        # gauge guard: no fixed camera and no prior -> hold the oldest
        if not fixed and not has_prior and len(local) > 1:
            oldest = min(local, key=lambda k: w.kf_frame_idx[k])
            local.remove(oldest)
            fixed.insert(0, oldest)
            local_set.discard(oldest)

        n_local = len(local)
        n_pts = len(pts)
        tiers = [(8, 16, 2048), (16, 32, 4096),
                 (caps.local_ba_kfs, caps.fixed_ba_kfs, caps.local_ba_points)]
        for (tl, tf, tp) in tiers:
            if n_local <= tl and n_pts <= tp:
                L, F_CAP, P = tl, tf, tp
                break
        else:
            L, F_CAP, P = tiers[-1]
        C = L + F_CAP
        dropped_fixed = max(0, len(fixed) - F_CAP)
        fixed = fixed[:F_CAP]
        dropped = (dropped_local, dropped_pts, dropped_fixed)
        if cfg.loc.ba_device_assembly and self.dev_world is not None:
            return self._joint_opt_device(local, fixed, pts, has_prior, first_kf, L,
                                          F_CAP, P, dropped, kf0)

        cam_q = np.tile(np.array([1.0, 0, 0, 0]), (C, 1))
        cam_t = np.zeros((C, 3))
        cam_valid = np.zeros(C, bool)
        slot_lut = np.full(w.MK, -1, np.int32)
        for i, k in enumerate(local):
            cam_q[i], cam_t[i] = w.kf_q[k], w.kf_t[k]
            cam_valid[i] = True
            slot_lut[k] = i
        for i, k in enumerate(fixed):
            cam_q[L + i], cam_t[L + i] = w.kf_q[k], w.kf_t[k]
            cam_valid[L + i] = True
            slot_lut[k] = L + i

        pts_np = np.array(pts, np.int64)
        n_act = len(pts)
        pts_arr = np.zeros((P, 3))
        pt_valid = np.zeros(P, bool)
        str_type = np.zeros(P, np.int64)
        str_normal = np.zeros((P, 3))
        str_normal[:, 2] = 1.0
        str_mean = np.zeros((P, 3))
        str_sqrt = np.tile(np.eye(3), (P, 1, 1))
        deg = self.assoc._deg
        pts_arr[:n_act] = w.pt_pos[pts_np]
        pt_valid[:n_act] = True
        comp = w.pt_assoc_comp[pts_np]
        has_c = comp >= 0
        cs = np.maximum(comp, 0)
        is_deg = has_c & deg[cs]
        is_nd = has_c & ~deg[cs]
        str_type[:n_act] = np.where(is_deg, local_ba.STR_DEG,
                                    np.where(is_nd, local_ba.STR_NONDEG, 0))
        str_normal[:n_act][is_deg] = self.assoc._normal[cs[is_deg]]
        str_mean[:n_act][has_c] = self.assoc._means[cs[has_c]]
        str_sqrt[:n_act][is_nd] = self.assoc._sqrt_info[cs[is_nd]]

        # per-point observation tables: KF ids -> window slots, surviving
        # observations compacted to the first MO columns
        MO = caps.ba_obs_per_point
        obs_cam = np.full((P, MO), -1, np.int64)
        obs_uvr = np.zeros((P, MO, 3), np.float32)
        obs_st = np.zeros((P, MO), bool)
        obs_s2i = np.ones((P, MO), np.float32)
        obs_valid = np.zeros((P, MO), bool)
        obs_kfid = np.full((P, MO), -1, np.int32)
        sigma2_inv = w.pyr["sigma2_inv"]
        okf = w.pt_obs_kf[pts_np]
        oslot = np.where(okf >= 0, slot_lut[np.maximum(okf, 0)], -1)
        use = (okf >= 0) & (oslot >= 0)
        order = np.argsort(~use, axis=1, kind="stable")[:, :MO]
        use_c = np.take_along_axis(use, order, axis=1)
        okf_c = np.where(use_c, np.take_along_axis(okf, order, axis=1), 0)
        oft_c = np.where(use_c, np.take_along_axis(w.pt_obs_feat[pts_np], order, axis=1), 0)
        obs_cam[:n_act] = np.where(use_c, np.take_along_axis(oslot, order, axis=1), -1)
        uv = w.kf_feat_uv[okf_c, oft_c]
        urr = w.kf_feat_ur[okf_c, oft_c]
        obs_uvr[:n_act] = np.concatenate([uv, urr[..., None]], -1)
        obs_st[:n_act] = use_c & (urr >= 0)
        obs_s2i[:n_act] = np.where(use_c, sigma2_inv[w.kf_feat_octave[okf_c, oft_c]], 1.0)
        obs_valid[:n_act] = use_c
        obs_kfid[:n_act] = np.where(use_c, okf_c, -1)
        obs_per_cam = np.bincount(obs_cam[:n_act][use_c], minlength=C)
        n_obs_pt = use_c.sum(1)
        self._record_ba(L, P, n_local, len(fixed), n_obs_pt, dropped, kf0)

        # a local KF with almost no observations is held fixed (invalid
        # free slot), its observations still constrain the points
        weak = (np.arange(C) < L) & cam_valid & (obs_per_cam < 10)
        if weak[0] and has_prior:
            weak[0] = False
        cam_valid[weak] = False

        t = self._t
        prob = local_ba.BAProblem(
            cam_q=t(cam_q), cam_t=t(cam_t), cam_valid=t(cam_valid, torch.bool),
            pts=t(pts_arr), pt_valid=t(pt_valid, torch.bool),
            obs_cam=t(obs_cam, torch.int64), obs_uvr=t(obs_uvr),
            obs_stereo=t(obs_st, torch.bool), obs_sigma2_inv=t(obs_s2i),
            obs_valid=t(obs_valid, torch.bool), str_type=t(str_type, torch.int64),
            str_normal=t(str_normal), str_mean=t(str_mean),
            str_sqrt_info=t(str_sqrt),
            prior_q=t(w.kf_q[first_kf] if first_kf >= 0 else cam_q[0]),
            prior_t=t(w.kf_t[first_kf] if first_kf >= 0 else cam_t[0]),
            has_prior=t(bool(has_prior), torch.bool),
        )
        res = local_ba.solve_local_ba(self.cam, prob, n_free=L, **self._ba_solve_kw())
        new_q, new_t, new_pts, drop_all, bad_all = (
            x.cpu().numpy() for x in (res.cam_q, res.cam_t, res.pts, res.str_drop,
                                      res.obs_bad))
        self.ba_stats[-1]["n_iters"] = res.n_iters
        self._ba_writeback(local, pts_np, n_act, new_q, new_t, new_pts, drop_all,
                           bad_all, obs_kfid)

    def _ba_solve_kw(self) -> dict:
        lc = self.cfg.loc
        sig_rot = np.deg2rad(lc.prior_sigma_rot_deg)
        return dict(
            ba_lambda2=lc.ba_lambda2, tri_str_thresh=lc.tri_str_thresh,
            prior_rot_info=1.0 / sig_rot ** 2,
            prior_trans_info=1.0 / lc.prior_sigma_trans ** 2,
            iters1=lc.ba_iters_stage1, iters2=lc.ba_iters_stage2,
            iters3=lc.ba_iters_stage3, term_gain=lc.ba_term_gain,
            schur_impl=lc.ba_schur_impl, linear_solver=lc.ba_linear_solver,
            cg_iters=lc.ba_cg_iters)

    def _record_ba(self, L, P, n_local, n_fixed, n_obs_pt, dropped, kf0) -> None:
        MO = self.cfg.caps.ba_obs_per_point
        n_act = len(n_obs_pt)
        self.ba_stats.append({
            "L": L, "P": P, "MO": MO, "n_local": n_local,
            "n_fixed": n_fixed, "n_pts": n_act,
            "obs_mean": float(n_obs_pt.mean()) if n_act else 0.0,
            "obs_p95": float(np.percentile(n_obs_pt, 95)) if n_act else 0.0,
            "obs_max_hit": int((n_obs_pt >= MO).sum()),
            "n_obs": int(n_obs_pt.sum()),
            "dropped_local": dropped[0], "dropped_pts": dropped[1],
            "dropped_fixed": dropped[2],
        })
        if any(dropped):
            print(f"[ba] cap bound at kf{kf0}: dropped local={dropped[0]} "
                  f"pts={dropped[1]} fixed={dropped[2]}", flush=True)

    def _joint_opt_device(self, local, fixed, pts, has_prior, first_kf, L, F_CAP, P,
                          dropped, kf0) -> None:
        """Local BA assembled on the card from the mirror
        (ba_assemble.py): the host uploads only the window's slot lists."""
        w = self.world
        dv = self.dev_world
        with Timer("loc/ba_sync"):
            dv.sync()
        n_act = len(pts)
        pts_np = np.array(pts, np.int64)
        local_arr = np.full(L, -1, np.int64)
        local_arr[:len(local)] = local
        fixed_arr = np.full(F_CAP, -1, np.int64)
        fixed_arr[:len(fixed)] = fixed
        pts_ids = np.full(P, -1, np.int64)
        pts_ids[:n_act] = pts_np
        slot_lut = np.full(w.MK, -1, np.int64)
        slot_lut[local] = np.arange(len(local))
        slot_lut[fixed] = L + np.arange(len(fixed))
        t = self._t
        gm = self.assoc.gmap
        i64 = torch.int64
        res, obs_kfid, n_obs_pt = ba_assemble.assemble_and_solve(
            self.cam, t(local_arr, i64), t(fixed_arr, i64), t(pts_ids, i64),
            t(slot_lut, i64), bool(has_prior), int(first_kf),
            dv.kf_q, dv.kf_t, dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_octave,
            dv.pt_pos, dv.pt_obs_kf, dv.pt_obs_feat, dv.pt_acomp,
            gm.means, gm.normal, gm.sqrt_info, gm.is_degenerated,
            t(w.pyr["sigma2_inv"]),
            n_free=L, n_cams=L + F_CAP, mo=self.cfg.caps.ba_obs_per_point,
            **self._ba_solve_kw())
        new_q, new_t, new_pts, drop_all, bad_all, obs_kfid, n_obs_pt = (
            x.cpu().numpy() for x in (res.cam_q, res.cam_t, res.pts, res.str_drop,
                                      res.obs_bad, obs_kfid, n_obs_pt))
        self._record_ba(L, P, len(local), len(fixed), n_obs_pt[:n_act], dropped, kf0)
        self.ba_stats[-1]["n_iters"] = res.n_iters
        self._ba_writeback(local, pts_np, n_act, new_q, new_t, new_pts, drop_all,
                           bad_all, obs_kfid)

    def _ba_writeback(self, local, pts_np, n_act, new_q, new_t, new_pts, drop_all,
                      bad_all, obs_kfid) -> None:
        w = self.world
        new_q = new_q.astype(np.float64)
        new_t = new_t.astype(np.float64)
        for i, k in enumerate(local):
            # a step moving a keyframe by decimetres is divergence, not
            # refinement: keep the tracked pose then
            if np.linalg.norm(new_t[i] - w.kf_t[k]) > 0.3:
                continue
            w.kf_q[k], w.kf_t[k] = new_q[i] / np.linalg.norm(new_q[i]), new_t[i]
        w.pt_pos[pts_np] = new_pts[:n_act].astype(np.float64)
        w.map_version += 1
        w.dirty_pt.update(pts_np.tolist())

        # association downgrade (:837-855)
        drop = drop_all[:n_act]
        dg_lut = np.arange(128, dtype=np.int16)
        for src, dst in ms.DOWNGRADE.items():
            dg_lut[src] = dst
        dgm = drop & np.isin(w.pt_type[pts_np], list(ms.DOWNGRADE.keys()))
        sel = pts_np[dgm]
        w.pt_type[sel] = dg_lut[w.pt_type[sel]].astype(w.pt_type.dtype)
        w.pt_assoc_comp[sel] = -1
        w.pt_assoc_vetted[sel] = False
        # associations that survived this BA are vetted for pose anchoring
        w.pt_assoc_vetted[pts_np[w.pt_assoc_comp[pts_np] >= 0]] = True

        # erase outlier observations (:857-894)
        bad = bad_all[:n_act] & (obs_kfid[:n_act] >= 0)
        for i, oi in np.argwhere(bad):
            p = pts_np[i]
            if w.pt_valid[p] and w.remove_observation(p, int(obs_kfid[i, oi])):
                w.remove_point(p)
        w.update_normal_and_depth_batch(pts_np)

    # ------------------------------------------------------------------

    def remove_keyframes(self) -> None:
        """Cull redundant KFs (localization.cpp:334-397): > 90% of the
        near-depth points seen >= 3 times elsewhere at the same or a finer
        scale."""
        w = self.world
        cfg = self.cfg
        th_depth = w.pyr["th_depth"]
        for kf in w.best_covisible(self.curr_kf):
            if w.kf_frame_idx[kf] == 0 or not w.kf_valid[kf]:
                continue
            obs = w.kf_obs_point[kf]
            d = w.kf_feat_depth[kf]
            near = (obs >= 0) & w.pt_valid[np.maximum(obs, 0)] & (d >= 0) & (d <= th_depth)
            pts = obs[near]
            num_mps = len(pts)
            if num_mps == 0:
                continue
            lvl = w.kf_feat_octave[kf, near]
            okf = w.pt_obs_kf[pts]
            oft = np.maximum(w.pt_obs_feat[pts], 0)
            other = (okf >= 0) & (okf != kf)
            oct_other = w.kf_feat_octave[np.maximum(okf, 0), oft]
            n_obs = np.sum(other & (oct_other <= lvl[:, None] + 1), axis=1)
            redundant = (w.pt_n_obs[pts] > cfg.loc.cull_min_obs) & (
                n_obs >= cfg.loc.cull_min_obs)
            if redundant.sum() > cfg.loc.kf_cull_redundancy * num_mps:
                w.remove_keyframe(kf)
