"""Descriptor matching: Hamming distances + guided search strategies.

PyTorch port of `gmmloc_tpu/features/matching.py` (ref ORBmatcher,
orb_matcher.cpp). Per-query grid scans become dense masked (N x M) passes
over one Hamming matrix, which comes from the hand-written CUDA kernel K3
on the card (`features/cuda_kernels.py`). Index outputs are int64.

Ties resolve as JAX's top_k/argmin do: the lowest index wins.
Thresholds TH_LOW=50 / TH_HIGH=100 (orb_matcher.cpp:20-22).
"""

from __future__ import annotations

import torch

from .cuda_kernels import hamming_matrix  # noqa: F401  (K3 on the card)

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = 1 << 20


def fundamental_matrix(q1, t1, q2, t2, K1, K2):
    """F with l2 = F^T p1 for poses T_c1_w, T_c2_w (ref
    MathUtils::computeFundamentalMatrix, math_utils.cpp:17-44):
    E = skew(t_c1_c2) @ R_c1_c2, F = K1^-T E K2^-1."""
    from ..geometry import se3

    q12 = se3.quat_mul(q1, se3.quat_conj(q2))
    t12 = -se3.quat_rotate(q12, t2) + t1
    E = se3.skew(t12) @ se3.quat_to_matrix(q12)
    return torch.linalg.inv(K1).T @ E @ torch.linalg.inv(K2)


def _two_smallest(dist):
    """(N,M) int -> (values (N,2), indices (N,2)) of the two smallest per
    row, lowest index first among ties (jax.lax.top_k(-dist, 2))."""
    i0 = torch.argmin(dist, dim=1)
    d0 = torch.gather(dist, 1, i0[:, None])[:, 0]
    masked = dist.scatter(1, i0[:, None], torch.iinfo(dist.dtype).max)
    i1 = torch.argmin(masked, dim=1)
    d1 = torch.gather(dist, 1, i1[:, None])[:, 0]
    return torch.stack([d0, d1], 1), torch.stack([i0, i1], 1)


def rotation_consistency_mask(angle_a, angle_b, matched, bins: int = HISTO_LENGTH):
    """Keep matches whose angle difference falls in the 3 dominant
    histogram bins (ref ComputeThreeMaxima, orb_matcher.cpp:544-576)."""
    rot = angle_a - angle_b
    rot = torch.where(rot < 0.0, rot + 360.0, rot)
    factor = 1.0 / (360.0 / bins)
    bin_idx = torch.round(rot * factor).to(torch.int64)
    bin_idx = torch.where(bin_idx == bins, 0, bin_idx)
    counts = torch.zeros(bins, dtype=torch.int32, device=angle_a.device)
    counts = counts.scatter_add(0, bin_idx, matched.to(torch.int32))
    top3 = torch.topk(counts, 3).values
    keep = top3 > 0.1 * top3[0]
    cb = counts[bin_idx]
    good_bin = (
        (cb == top3[0])
        | ((cb == top3[1]) & keep[1])
        | ((cb == top3[2]) & keep[2])
    )
    return matched & good_bin


def _unique_targets(matched, best, d0, n_feat):
    """Resolve duplicate targets: keep the query with the smallest
    distance, then the lowest query index."""
    N = best.shape[0]
    dev = best.device
    d0m = torch.where(matched, d0, BIG)
    best_for = torch.full((n_feat,), BIG, dtype=d0m.dtype, device=dev)
    best_for = best_for.scatter_reduce(0, best, d0m, reduce="amin")
    winner = matched & (d0m == best_for[best])
    qidx = torch.arange(N, device=dev)
    first_q = torch.full((n_feat,), N, dtype=torch.int64, device=dev)
    first_q = first_q.scatter_reduce(
        0, torch.where(winner, best, n_feat - 1),
        torch.where(winner, qidx, N), reduce="amin")
    return winner & (first_q[best] == qidx), d0m


def search_by_projection(
    proj_uv, proj_ur, query_desc, query_octave, query_angle, query_valid,
    radius, level_lo, level_hi,
    feat_uv, feat_ur, feat_desc, feat_octave, feat_angle, feat_valid,
    feat_taken,
    desc_thresh: int = TH_HIGH, nn_ratio: float = 1.0,
    use_rotation: bool = False, dist_precomputed=None,
):
    """Guided projection search (map-point-to-frame, orb_matcher.cpp:27-110,
    and the frame-to-frame motion model, :410-542).

    Returns (match_idx (N,) int64 feature index or -1, best_dist (N,))."""
    d_uv = feat_uv[None, :, :] - proj_uv[:, None, :]
    in_window = (
        (torch.abs(d_uv[..., 0]) < radius[:, None])
        & (torch.abs(d_uv[..., 1]) < radius[:, None])
    )
    in_level = (feat_octave[None, :] >= level_lo[:, None]) & (
        feat_octave[None, :] <= level_hi[:, None]
    )
    both_st = (proj_ur[:, None] >= 0.0) & (feat_ur[None, :] >= 0.0)
    stereo_ok = ~both_st | (torch.abs(proj_ur[:, None] - feat_ur[None, :]) < radius[:, None])
    cand = (
        in_window & in_level & stereo_ok & feat_valid[None, :]
        & ~feat_taken[None, :] & query_valid[:, None]
    )
    dist = hamming_matrix(query_desc, feat_desc) if dist_precomputed is None \
        else dist_precomputed
    dist = torch.where(cand, dist, BIG)

    best_dist, best_idx = _two_smallest(dist)
    best = best_idx[:, 0]
    # ratio test when best and runner-up sit on the same octave (:96-104)
    same_level = feat_octave[best_idx[:, 0]] == feat_octave[best_idx[:, 1]]
    ratio_ok = ~(same_level & (best_dist[:, 1] < (1 << 19))) | (
        best_dist[:, 0].to(torch.float32)
        <= nn_ratio * best_dist[:, 1].to(torch.float32)
    )
    matched = (best_dist[:, 0] <= desc_thresh) & ratio_ok & query_valid
    if use_rotation:
        matched = rotation_consistency_mask(query_angle, feat_angle[best], matched)

    winner, d0 = _unique_targets(matched, best, best_dist[:, 0], feat_uv.shape[0])
    return torch.where(winner, best, -1), torch.where(winner, d0, -1)


def mutual_best_match(desc_a, valid_a, desc_b, valid_b, max_dist: int = TH_LOW):
    """Mutual nearest neighbours over full descriptor sets (the BoW-free
    searchByBoW replacement). Returns (N,) index into b or -1."""
    dist = hamming_matrix(desc_a, desc_b)
    dist = torch.where(valid_a[:, None] & valid_b[None, :], dist, BIG)
    best_b = torch.argmin(dist, dim=1)
    best_a = torch.argmin(dist, dim=0)
    d = torch.gather(dist, 1, best_b[:, None])[:, 0]
    mutual = best_a[best_b] == torch.arange(desc_a.shape[0], device=dist.device)
    ok = mutual & (d <= max_dist) & valid_a
    return torch.where(ok, best_b, -1), torch.where(ok, d, -1)


def search_for_triangulation(
    dist, uv1, ur1, angle1, free1, uv2, ur2, octave2, angle2, free2,
    fmat, epipole2, sigma2, use_rotation: bool = False,
):
    """Epipolar-constrained matching for triangulation
    (ref searchForTriangulation, orb_matcher.cpp:141-293) on the (N1, N2)
    Hamming distances `dist` of KF1's and KF2's descriptors. fmat is F
    with l2 = F^T p1. Returns (N1,) index into KF2 or -1."""
    p1h = torch.cat([uv1, torch.ones_like(uv1[:, :1])], dim=-1)
    line = p1h @ fmat
    num = (line[:, None, 0] * uv2[None, :, 0] + line[:, None, 1] * uv2[None, :, 1]
           + line[:, None, 2])
    den = line[:, 0] ** 2 + line[:, 1] ** 2
    dsqr = num * num / torch.clamp(den[:, None], min=1e-12)
    epi_ok = (den[:, None] > 0) & (dsqr < 3.84 * sigma2[octave2][None, :])
    stereo1 = ur1 >= 0
    stereo2 = ur2 >= 0
    d_epi = torch.sum((uv2 - epipole2[None, :]) ** 2, dim=-1)
    sf2 = torch.sqrt(sigma2)[octave2]
    mono_pair = (~stereo1[:, None]) & (~stereo2[None, :])
    epipole_ok = ~mono_pair | (d_epi[None, :] >= 100.0 * sf2[None, :])
    cand = free1[:, None] & free2[None, :] & epi_ok & epipole_ok & (dist <= TH_LOW)
    dist = torch.where(cand, dist, BIG)
    best2 = torch.argmin(dist, dim=1)
    d0 = torch.gather(dist, 1, best2[:, None])[:, 0]
    matched = d0 <= TH_LOW
    if use_rotation:
        matched = rotation_consistency_mask(angle1, angle2[best2], matched)
    winner, _ = _unique_targets(matched, best2, d0, uv2.shape[0])
    return torch.where(winner, best2, -1)


def search_for_triangulation_batch(uv1, ur1, desc1, octave1, angle1, free1,
                                   uv2, ur2, desc2, octave2, angle2, free2,
                                   fmat, epipole2, sigma2):
    """search_for_triangulation over T neighbour KFs (leading axis of the
    KF2 arguments, fmat and epipole2). One Hamming launch of
    N1 x (T*N2) against the stacked KF2 descriptors, cut per pair.
    Returns (T, N1)."""
    T, N2 = desc2.shape[:2]
    dist = hamming_matrix(desc1, desc2.reshape(T * N2, 32))
    return torch.stack([
        search_for_triangulation(
            dist[:, i * N2:(i + 1) * N2], uv1, ur1, angle1, free1,
            uv2[i], ur2[i], octave2[i], angle2[i], free2[i], fmat[i], epipole2[i], sigma2)
        for i in range(T)
    ])


def fuse_match(dist, proj_uv, proj_ur, pred_level, radius, pt_valid,
               feat_uv, feat_ur, feat_octave, feat_valid, sigma2_inv):
    """Landmark -> keyframe fusion matching (ref fuseObservations,
    localization.cpp:226-325) on the (..., P, M) Hamming distances `dist`
    of the landmarks' and the keyframe's descriptors: window + level gate
    [pred-1, pred], per-candidate reprojection chi2 gate (5.99 mono / 7.8
    stereo), Hamming argmin <= TH_LOW. Duplicate targets are kept (the
    host merges them). Every argument but sigma2_inv carries the same
    leading job axes. Returns (..., P) feature index or -1."""
    du = feat_uv[..., None, :, 0] - proj_uv[..., :, None, 0]
    dv = feat_uv[..., None, :, 1] - proj_uv[..., :, None, 1]
    rad = radius[..., :, None]
    in_window = (torch.abs(du) < rad) & (torch.abs(dv) < rad)
    in_level = (feat_octave[..., None, :] >= pred_level[..., :, None] - 1) & (
        feat_octave[..., None, :] <= pred_level[..., :, None]
    )
    is_st = feat_ur[..., None, :] >= 0
    err2 = du * du + dv * dv
    dur = feat_ur[..., None, :] - proj_ur[..., :, None]
    e = torch.where(is_st, err2 + dur * dur, err2) * sigma2_inv[feat_octave][..., None, :]
    chi2_ok = e <= torch.where(is_st, 7.8, 5.99)
    cand = (in_window & in_level & chi2_ok & feat_valid[..., None, :]
            & pt_valid[..., :, None])
    dist = torch.where(cand, dist, BIG)
    best = torch.argmin(dist, dim=-1)
    d0 = torch.gather(dist, -1, best[..., None])[..., 0]
    matched = (d0 <= TH_LOW) & pt_valid
    return torch.where(matched, best, -1)


def _job_dists(pt_desc, feat_desc):
    """(T,P,32) x (T,M,32) -> (T,P,M): one Hamming launch per job."""
    T, P = pt_desc.shape[:2]
    out = torch.empty(T, P, feat_desc.shape[1], dtype=torch.int32, device=pt_desc.device)
    for i in range(T):
        hamming_matrix(pt_desc[i], feat_desc[i], out=out[i])
    return out


def fuse_match_batch(proj_uv, proj_ur, pt_desc, pred_level, radius, pt_valid,
                     feat_uv, feat_ur, feat_desc, feat_octave, feat_valid,
                     sigma2_inv):
    """fuse_match over T (target KF, query set) jobs (leading axis of every
    argument but sigma2_inv). Returns (T, P)."""
    return fuse_match(_job_dists(pt_desc, feat_desc), proj_uv, proj_ur, pred_level,
                      radius, pt_valid, feat_uv, feat_ur, feat_octave, feat_valid,
                      sigma2_inv)


# ---------------------------------------------------------------------------
# gathers from the device-world mirror (mapping/device_world.py)
# ---------------------------------------------------------------------------


def search_for_triangulation_gather(kf1, kf2_idx, free1, free2, fmat, epipole2, sigma2,
                                    kf_uv, kf_ur, kf_desc, kf_oct, kf_angle):
    """search_for_triangulation_batch with the KF feature tables gathered
    from the mirror: kf1 an int, kf2_idx (T,) int64 neighbour keyframes.
    Returns (T, F) match tables."""
    return search_for_triangulation_batch(
        kf_uv[kf1], kf_ur[kf1], kf_desc[kf1], kf_oct[kf1], kf_angle[kf1], free1,
        kf_uv[kf2_idx], kf_ur[kf2_idx], kf_desc[kf2_idx], kf_oct[kf2_idx],
        kf_angle[kf2_idx], free2, fmat, epipole2, sigma2)


def fuse_project_match_gather(cam, kf_idx, job_ok, q_pid, q_ok, skip, kf_q, kf_t,
                              kf_uv, kf_ur, kf_desc, kf_oct, kf_fvalid,
                              pt_pos, pt_normal, pt_mind, pt_maxd, pt_desc, pt_valid,
                              sigma2_inv, scale_factors, log_sf: float, th: float = 3.0):
    """fuseObservations with the world on the card (ref
    localization.cpp:226-325): per job (target keyframe kf_idx[j], query
    landmark ids q_pid[j]) the projection, scale/view-cos gates and level
    prediction run on gathered mirror rows, then fuse_match. q_ok masks
    padded queries, skip the landmarks the target already observes.
    Returns (T, B) feature index into each target KF, or -1."""
    n_levels = scale_factors.shape[0]
    pos, nrm = pt_pos[q_pid], pt_normal[q_pid]                   # (T,B,3)
    dmin, dmax = pt_mind[q_pid], pt_maxd[q_pid]
    ok0 = q_ok & pt_valid[q_pid]
    q, t = kf_q[kf_idx], kf_t[kf_idx]                            # (T,4),(T,3)
    w_, x_, y_, z_ = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = torch.stack([
        torch.stack([1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - w_ * z_),
                     2 * (x_ * z_ + w_ * y_)], -1),
        torch.stack([2 * (x_ * y_ + w_ * z_), 1 - 2 * (x_ * x_ + z_ * z_),
                     2 * (y_ * z_ - w_ * x_)], -1),
        torch.stack([2 * (x_ * z_ - w_ * y_), 2 * (y_ * z_ + w_ * x_),
                     1 - 2 * (x_ * x_ + y_ * y_)], -1),
    ], -2)                                                       # (T,3,3)
    pc = pos @ R.transpose(1, 2) + t[:, None, :]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    ur = u - cam.bf / zs
    inside = (z > 0) & (u >= 0) & (v >= 0) & (u < cam.width) & (v < cam.height)
    t_wc = -(R.transpose(1, 2) @ t[:, :, None])[..., 0]          # (T,3)
    vdir = pos - t_wc[:, None, :]
    dist = torch.linalg.norm(vdir, dim=-1)
    ok = ok0 & ~skip & inside
    ok = ok & (dist >= 0.8 * dmin) & (dist <= 1.2 * dmax) & (dist > 1e-9)
    vc = torch.sum(vdir * nrm, -1) / torch.clamp(dist, min=1e-9)
    ok = ok & (vc >= 0.5)
    lvl = torch.ceil(torch.log(torch.clamp(dmax / torch.clamp(dist, min=1e-9), min=1e-9))
                     / log_sf).to(torch.int64)
    lvl = torch.clamp(lvl, 0, n_levels - 1)
    m = fuse_match(_job_dists(pt_desc[q_pid], kf_desc[kf_idx]), torch.stack([u, v], -1),
                   ur, lvl, th * scale_factors[lvl], ok, kf_uv[kf_idx], kf_ur[kf_idx],
                   kf_oct[kf_idx], kf_fvalid[kf_idx], sigma2_inv)
    return torch.where(job_ok[:, None], m, -1)
