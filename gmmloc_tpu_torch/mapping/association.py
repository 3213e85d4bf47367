"""Keyframe-side GMM association: render, candidate search, batched
point-to-component optimization with neighbour refinement.

PyTorch port of `gmmloc_tpu/mapping/association.py`: the fused
`associate_and_check_kernel` (ref GMMLoc::associateMapElements +
checkMapAssociation + queryPoint, gmmloc_opt.cpp:115-258), which the
default `fused_kf_assoc=True` runs as one device pass per keyframe, and
the `GMMAssociator` methods around it, including createMapPointsFromStereo
(gmmloc_opt.cpp:36-113). With `fused_kf_assoc=False` the keyframe takes
the host-orchestrated chain instead: `associate_keyframe` (render +
candidate search) and, for the features that need a point,
`check_map_association_batch` (batched point solves on the device, the
argmin selection, neighbour refinement and the queryPoint fallback on
the host).
"""

from __future__ import annotations

import numpy as np
import torch

from . import map_state as ms
from ..utils.timing import Timer

from ..config import SystemConfig
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..gmm import mixture, render as render_mod
from ..solver import point_solver


def bucket_size(n: int, lo: int = 256) -> int:
    """Round batch sizes up to powers of two (kept for the shapes it
    gives the batched solves)."""
    b = lo
    while b < n:
        b <<= 1
    return b


def associate_and_check_kernel(
    gmap, cam: cam_mod.CameraParams, q_cw, t_cw, uv, ur, octave, valid, depth,
    sigma2_inv_tab, *, knn: int, mdist2_thresh: float, view_cos_deg: float,
    cov2d_scale_thresh: float, occlusion_bh_thresh: float, tri_lambda2: float,
    chi2_stereo: float, str_chi2_thresh: float, chi2_assoc_3d: float,
    iters: int, tri_check_str_chi2: bool,
):
    """The per-keyframe association chain on one device: renderView +
    searchCorrespondence + checkMapAssociation for every (feature x
    candidate) pair, the neighbour-refinement switch and the 3-D
    queryPoint fallback. Returns (cand (F,knn), assoc (F,) or -1,
    pt_out (F,3))."""
    F = uv.shape[0]
    r2d = render_mod.render_view(
        gmap, cam, q_cw, t_cw, view_cos_deg=view_cos_deg,
        cov2d_scale_thresh=cov2d_scale_thresh,
        occlusion_bh_thresh=occlusion_bh_thresh)
    cand = render_mod.search_correspondence(r2d, uv, valid, knn=knn,
                                            mdist2_thresh=mdist2_thresh)

    feat_ok = valid & (depth > 0)
    z = torch.where(feat_ok, depth, 1.0)
    xn = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy,
                      torch.ones_like(z)], -1)
    q_wc, t_wc = se3.inverse(q_cw, t_cw)
    pts0 = se3.apply(q_wc, t_wc, xn * z[:, None])
    obs_uvr = torch.cat([uv, ur[:, None]], -1)
    s2i = sigma2_inv_tab[octave]
    str_info = tri_lambda2 * torch.clamp(z, min=1.0) ** 2

    def chi2_comp(comp, pts):
        safe = torch.clamp(comp, min=0)
        d = pts - gmap.means[safe]
        return torch.einsum("...i,...ij,...j->...", d, gmap.cov_inv[safe], d)

    def run_opt(comp, pts_init):
        safe = torch.clamp(comp, min=0)
        lead = pts_init.shape[:-1]
        if pts_init.dim() == 3:
            obs, s2, si = obs_uvr[:, None, :], s2i[:, None], str_info[:, None]
        else:
            obs, s2, si = obs_uvr, s2i, str_info
        res = point_solver.optimize_point_stereo(
            cam, pts_init, q_cw, t_cw, obs.expand(lead + (3,)), s2.expand(lead),
            gmap.normal[safe], gmap.means[safe], si.expand(lead),
            chi2_proj_thresh=chi2_stereo, str_chi2_thresh=str_chi2_thresh,
            iters=iters, tri_check_str_chi2=tri_check_str_chi2)
        return res.x, res.chi2_proj, res.ok & (comp >= 0)

    # pass 1: all (feature x candidate) pairs
    x1, c1, ok1 = run_opt(cand, pts0[:, None, :].expand(F, knn, 3))
    c1 = torch.where(ok1 & feat_ok[:, None], c1, float("inf"))
    best = torch.argmin(c1, dim=1)
    found = torch.isfinite(torch.gather(c1, 1, best[:, None])[:, 0])
    best_comp = torch.gather(cand, 1, best[:, None])[:, 0]
    best_pt = x1[torch.arange(F, device=uv.device), best]

    # neighbour refinement (gmmloc_opt.cpp:209-228)
    g = torch.clamp(best_comp, min=0)
    ll = chi2_comp(g, best_pt)
    nbs = gmap.neighbors[g]
    ln = chi2_comp(torch.clamp(nbs, min=0), best_pt[:, None, :])
    ln = torch.where(nbs >= 0, ln, float("inf"))
    nb_best = torch.argmin(ln, dim=1)
    nb_ll = torch.gather(ln, 1, nb_best[:, None])[:, 0]
    switch = found & (nb_ll < ll)
    nb_comp = torch.gather(nbs, 1, nb_best[:, None])[:, 0]
    chosen = torch.where(switch, nb_comp, best_comp)
    x2, _, ok2 = run_opt(torch.where(switch, chosen, -1), pts0)
    best_pt = torch.where((switch & ok2)[:, None], x2, best_pt)
    chosen = torch.where(switch & ~ok2, best_comp, chosen)

    ll_final = chi2_comp(torch.clamp(chosen, min=0), best_pt)
    accept = found & (ll_final <= chi2_assoc_3d)
    assoc = torch.where(accept, chosen, -1)
    pt_out = torch.where(accept[:, None], best_pt, pts0)

    # 3-D queryPoint fallback for all-candidates-failed features: refines
    # the position, keeps assoc = -1 (gmmloc_opt.cpp:237-254)
    has_cand = (cand >= 0).any(dim=1)
    miss = feat_ok & has_cand & ~found
    nearest = render_mod.query_point_3d(gmap, pts0, miss)
    deg_ok = miss & (nearest >= 0) & gmap.is_degenerated[torch.clamp(nearest, min=0)]
    x3, _, ok3 = run_opt(torch.where(deg_ok, nearest, -1), pts0)
    pt_out = torch.where((deg_ok & ok3)[:, None], x3, pt_out)
    return cand, assoc, pt_out


class GMMAssociator:
    """Keyframe association against the prior map on `device`."""

    def __init__(self, cfg: SystemConfig, cam: cam_mod.CameraParams,
                 gmap: mixture.GMMMap, device):
        self.cfg = cfg
        self.cam = cam
        self.gmap = gmap
        self.device = torch.device(device)
        hv = mixture.host_view(gmap)
        self._means = hv["means"]
        self._cov_inv = hv["cov_inv"]
        self._normal = hv["normal"]
        self._sqrt_info = hv["sqrt_info"]
        self._neighbors = hv["neighbors"]
        self._deg = hv["is_degenerated"]
        # per-KF device results of associate_and_check_keyframe, read by
        # create_map_points_from_stereo
        self._fused_check: dict = {}

    def _t(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def associate_and_check_keyframe(self, world: ms.MapState, kf: int) -> None:
        """Enqueue the fused association of keyframe `kf`; the result is
        read back by create_map_points_from_stereo."""
        g = self.cfg.gmm
        lc = self.cfg.loc
        with Timer("kf/assoc_check"):
            self._fused_check[kf] = associate_and_check_kernel(
                self.gmap, self.cam,
                self._t(world.kf_q[kf]), self._t(world.kf_t[kf]),
                self._t(world.kf_feat_uv[kf]), self._t(world.kf_feat_ur[kf]),
                self._t(world.kf_feat_octave[kf], torch.int64),
                self._t(world.kf_feat_valid[kf], torch.bool),
                self._t(world.kf_feat_depth[kf]),
                self._t(world.pyr["sigma2_inv"]),
                knn=g.assoc_knn, mdist2_thresh=g.assoc_mdist2_thresh,
                view_cos_deg=g.view_cos_deg,
                cov2d_scale_thresh=g.cov2d_scale_thresh,
                occlusion_bh_thresh=g.occlusion_bh_thresh,
                tri_lambda2=lc.tri_lambda2, chi2_stereo=lc.chi2_stereo,
                str_chi2_thresh=lc.tri_str_thresh * lc.tri_lambda2,
                chi2_assoc_3d=lc.chi2_assoc_3d, iters=lc.point_opt_iters,
                tri_check_str_chi2=lc.tri_check_str_chi2,
            )

    def _consume_fused_check(self, world: ms.MapState, kf: int):
        ent = self._fused_check.pop(kf, None)
        if ent is None:
            return None
        with Timer("kf/assoc_fetch"):
            cand, assoc, pt_out = (x.cpu().numpy() for x in ent)
        world.kf_comp_cand[kf] = cand
        world.dirty_kf.add(kf)
        return assoc.astype(np.int32), pt_out.astype(np.float64)

    def associate_keyframe(self, world: ms.MapState, kf: int) -> None:
        """renderView + searchCorrespondence -> kf_comp_cand
        (ref associateMapElements, gmmloc_opt.cpp:115-153)."""
        g = self.cfg.gmm
        with Timer("loc/render_view"):
            r2d = render_mod.render_view(
                self.gmap, self.cam, self._t(world.kf_q[kf]), self._t(world.kf_t[kf]),
                view_cos_deg=g.view_cos_deg, cov2d_scale_thresh=g.cov2d_scale_thresh,
                occlusion_bh_thresh=g.occlusion_bh_thresh)
        with Timer("map/search_corr"):
            cand = render_mod.search_correspondence(
                r2d, self._t(world.kf_feat_uv[kf]),
                self._t(world.kf_feat_valid[kf], torch.bool),
                knn=g.assoc_knn, mdist2_thresh=g.assoc_mdist2_thresh)
            world.kf_comp_cand[kf] = cand.cpu().numpy()
        world.dirty_kf.add(kf)  # the mirror row must carry the candidate table

    def _chi2_np(self, comp_ids, pts):
        """Host-side component chi2 (Mahalanobis^2) of selected comps."""
        d = pts - self._means[comp_ids]
        return np.einsum("ni,nij,nj->n", d, self._cov_inv[comp_ids], d)

    def check_map_association_batch(self, world: ms.MapState, kf: int,
                                    feat_idx: np.ndarray, pts0: np.ndarray):
        """Batched checkMapAssociation (gmmloc_opt.cpp:156-258).

        feat_idx: (M,) feature indices with stereo depth and >= 1
        candidate; pts0: (M,3) their unprojected world points. Returns
        (assoc_comp (M,) int32 or -1, pt_out (M,3))."""
        cfg = self.cfg.loc
        M = len(feat_idx)
        K = self.cfg.gmm.assoc_knn
        cand = world.kf_comp_cand[kf][feat_idx]            # (M, K) comp ids
        q_cw = self._t(world.kf_q[kf])
        t_cw = self._t(world.kf_t[kf])
        uv = world.kf_feat_uv[kf][feat_idx]
        ur = world.kf_feat_ur[kf][feat_idx]
        obs_uvr = np.concatenate([uv, ur[:, None]], -1)
        sigma2_inv = world.pyr["sigma2_inv"][world.kf_feat_octave[kf][feat_idx]]
        # proj_z^2 with z clamped at >= 1 (gmmloc_opt.cpp:171-174)
        R = ms._quat_to_mat(world.kf_q[kf])
        z = np.maximum((pts0 @ R.T + world.kf_t[kf])[:, 2], 1.0)
        str_info = cfg.tri_lambda2 * z * z

        def run_opt(comp_ids, pts, obs, s2i, sinfo):
            safe = np.maximum(comp_ids, 0)
            with Timer("kf/point_opt"):
                res = point_solver.optimize_point_stereo(
                    self.cam, self._t(pts), q_cw, t_cw, self._t(obs), self._t(s2i),
                    self._t(self._normal[safe]), self._t(self._means[safe]),
                    self._t(sinfo), chi2_proj_thresh=cfg.chi2_stereo,
                    str_chi2_thresh=cfg.tri_str_thresh * cfg.tri_lambda2,
                    iters=cfg.point_opt_iters, tri_check_str_chi2=cfg.tri_check_str_chi2)
                x, c, ok = (v.cpu().numpy() for v in (res.x, res.chi2_proj, res.ok))
            return x, c, ok & (comp_ids >= 0)

        # pass 1: all (feature x candidate) pairs
        x1, c1, ok1 = run_opt(cand.reshape(-1), np.repeat(pts0, K, axis=0),
                              np.repeat(obs_uvr, K, axis=0), np.repeat(sigma2_inv, K),
                              np.repeat(str_info, K))
        x1 = x1.reshape(M, K, 3)
        c1 = np.where(ok1, c1, np.inf).reshape(M, K)
        best = np.argmin(c1, axis=1)
        found = np.isfinite(c1[np.arange(M), best])
        best_comp = cand[np.arange(M), best]
        best_pt = x1[np.arange(M), best]
        assoc = np.full(M, -1, np.int32)
        pt_out = pts0.copy()

        # neighbour refinement (gmmloc_opt.cpp:209-228): switch to a
        # neighbour with lower chi2 at the solution, re-optimize with it
        fi = np.where(found)[0]
        if len(fi):
            g = best_comp[fi]
            ll = self._chi2_np(g, best_pt[fi])
            nbs = self._neighbors[g]                      # (m, NB)
            nb_safe = np.maximum(nbs, 0)
            d = best_pt[fi][:, None, :] - self._means[nb_safe]
            ln = np.einsum("mki,mkij,mkj->mk", d, self._cov_inv[nb_safe], d)
            ln = np.where(nbs >= 0, ln, np.inf)
            nb_best = np.argmin(ln, axis=1)
            nb_ll = ln[np.arange(len(fi)), nb_best]
            switch = nb_ll < ll
            chosen = np.where(switch, nbs[np.arange(len(fi)), nb_best], g)
            if switch.any():
                si = np.where(switch)[0]
                x2, _, ok2 = run_opt(chosen[si], pts0[fi][si], obs_uvr[fi][si],
                                     sigma2_inv[fi][si], str_info[fi][si])
                # failed re-opts fall back to the original comp/solution
                for j, sj in enumerate(si):
                    if ok2[j]:
                        best_pt[fi[sj]] = x2[j]
                    else:
                        chosen[sj] = g[sj]
            ll_final = self._chi2_np(chosen, best_pt[fi])
            accept = ll_final <= cfg.chi2_assoc_3d
            assoc[fi[accept]] = chosen[accept]
            pt_out[fi[accept]] = best_pt[fi[accept]]

        # 3-D queryPoint fallback for features whose candidates all failed
        # (gmmloc_opt.cpp:237-254): the refined position, assoc stays -1
        miss = np.where(~found)[0]
        if len(miss):
            with Timer("kf/query3d"):
                nearest = render_mod.query_point_3d(
                    self.gmap, self._t(pts0[miss]),
                    torch.ones(len(miss), dtype=torch.bool, device=self.device)
                ).cpu().numpy()
            deg_ok = self._deg[np.maximum(nearest, 0)] & (nearest >= 0)
            di = miss[deg_ok]
            if len(di):
                x3, _, ok3 = run_opt(nearest[deg_ok], pts0[di], obs_uvr[di],
                                     sigma2_inv[di], str_info[di])
                upd = np.where(ok3)[0]
                pt_out[di[upd]] = x3[upd]
        return assoc, pt_out

    def create_map_points_from_stereo(self, world: ms.MapState, frame, kf: int,
                                      check_depth: bool = True) -> int:
        """Ref createMapPointsFromStereo (gmmloc_opt.cpp:36-113): depth-
        sorted stereo features; a feature with GMM candidates needs an
        accepted association, else no point; near-depth quota 100. The
        association comes from the fused pass where one was enqueued,
        else from check_map_association_batch."""
        staged = self._consume_fused_check(world, kf)
        th_depth = world.pyr["th_depth"]
        depth = frame.depth.copy()
        depth[~frame.valid] = -1
        order = np.argsort(np.where(depth > 0, depth, np.inf), kind="stable")
        order = order[depth[order] > 0]
        if len(order) == 0:
            return 0
        p_all = frame.mappoint[order]
        need_mask = (p_all < 0) | (world.pt_n_obs[np.maximum(p_all, 0)] < 1)
        frame.mappoint[order[need_mask & (p_all >= 0)]] = -1
        if check_depth:
            zo = depth[order]
            stop = (zo > th_depth) & (np.arange(1, len(order) + 1) > 100)
            n_proc = int(np.argmax(stop)) + 1 if stop.any() else len(order)
        else:
            n_proc = len(order)
        kept = order[:n_proc][need_mask[:n_proc]]
        if len(kept) == 0:
            return 0

        q_wc, t_wc = ms._inverse(world.kf_q[kf], world.kf_t[kf])
        R_wc = ms._quat_to_mat(q_wc)
        uv = world.kf_feat_uv[kf][kept]
        zs = depth[kept]
        pc = np.stack([(uv[:, 0] - self.cam.cx) / self.cam.fx * zs,
                       (uv[:, 1] - self.cam.cy) / self.cam.fy * zs, zs], -1)
        pw = pc @ R_wc.T + t_wc
        has_cand = (world.kf_comp_cand[kf][kept] >= 0).any(axis=1)
        assoc = np.full(len(kept), -1, np.int32)
        pts = pw.copy()
        ci = np.where(has_cand)[0]
        if len(ci) and staged is not None:
            a_all, p_out = staged
            assoc[ci] = a_all[kept[ci]]
            pts[ci] = p_out[kept[ci]]
        elif len(ci):
            assoc[ci], pts[ci] = self.check_map_association_batch(
                world, kf, kept[ci], pw[ci])
        ok = ~(has_cand & (assoc < 0))   # gated out (gmmloc_opt.cpp:79-81)
        sel = np.where(ok)[0]
        if len(sel) == 0:
            return 0
        pids = np.array([
            world.alloc_point(pts[j], ref_kf=kf, created_kf_idx=world.kf_frame_idx[kf])
            for j in sel
        ], np.int64)
        a = assoc[sel]
        world.pt_assoc_comp[pids[a >= 0]] = a[a >= 0]
        world.pt_type[pids] = np.where(
            a >= 0, ms.PT_FROM_DEPTH_GMM, ms.PT_FROM_DEPTH).astype(world.pt_type.dtype)
        world.add_observations_batch(pids, kf, kept[sel])
        world.compute_distinctive_descriptor_batch(pids)
        world.update_normal_and_depth_batch(pids)
        frame.mappoint[kept[sel]] = pids
        return len(pids)
