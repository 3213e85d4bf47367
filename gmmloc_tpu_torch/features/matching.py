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
    uv1, ur1, desc1, octave1, angle1, free1,
    uv2, ur2, desc2, octave2, angle2, free2,
    fmat, epipole2, sigma2, use_rotation: bool = False,
):
    """Epipolar-constrained matching for triangulation
    (ref searchForTriangulation, orb_matcher.cpp:141-293). fmat is F with
    l2 = F^T p1. Returns (N1,) index into KF2 or -1."""
    dist = hamming_matrix(desc1, desc2)
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
    KF2 arguments, fmat and epipole2). Returns (T, N1)."""
    return torch.stack([
        search_for_triangulation(
            uv1, ur1, desc1, octave1, angle1, free1,
            uv2[i], ur2[i], desc2[i], octave2[i], angle2[i], free2[i],
            fmat[i], epipole2[i], sigma2)
        for i in range(uv2.shape[0])
    ])


def fuse_match(proj_uv, proj_ur, pt_desc, pred_level, radius, pt_valid,
               feat_uv, feat_ur, feat_desc, feat_octave, feat_valid, sigma2_inv):
    """Landmark -> keyframe fusion matching (ref fuseObservations,
    localization.cpp:226-325): window + level gate [pred-1, pred],
    per-candidate reprojection chi2 gate (5.99 mono / 7.8 stereo), Hamming
    argmin <= TH_LOW. Duplicate targets are kept (the host merges them).
    Returns (P,) feature index or -1."""
    du = feat_uv[None, :, 0] - proj_uv[:, None, 0]
    dv = feat_uv[None, :, 1] - proj_uv[:, None, 1]
    in_window = (torch.abs(du) < radius[:, None]) & (torch.abs(dv) < radius[:, None])
    in_level = (feat_octave[None, :] >= pred_level[:, None] - 1) & (
        feat_octave[None, :] <= pred_level[:, None]
    )
    is_st = feat_ur[None, :] >= 0
    err2 = du * du + dv * dv
    dur = feat_ur[None, :] - proj_ur[:, None]
    e = torch.where(is_st, err2 + dur * dur, err2) * sigma2_inv[feat_octave][None, :]
    chi2_ok = e <= torch.where(is_st, 7.8, 5.99)
    cand = in_window & in_level & chi2_ok & feat_valid[None, :] & pt_valid[:, None]
    dist = torch.where(cand, hamming_matrix(pt_desc, feat_desc), BIG)
    best = torch.argmin(dist, dim=1)
    d0 = torch.gather(dist, 1, best[:, None])[:, 0]
    matched = (d0 <= TH_LOW) & pt_valid
    return torch.where(matched, best, -1)


def fuse_match_batch(proj_uv, proj_ur, pt_desc, pred_level, radius, pt_valid,
                     feat_uv, feat_ur, feat_desc, feat_octave, feat_valid,
                     sigma2_inv):
    """fuse_match over T (target KF, query set) jobs (leading axis of every
    argument but sigma2_inv). Returns (T, P)."""
    return torch.stack([
        fuse_match(proj_uv[i], proj_ur[i], pt_desc[i], pred_level[i], radius[i],
                   pt_valid[i], feat_uv[i], feat_ur[i], feat_desc[i],
                   feat_octave[i], feat_valid[i], sigma2_inv)
        for i in range(proj_uv.shape[0])
    ])
