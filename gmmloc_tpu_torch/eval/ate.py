"""Trajectory evaluation: APE translation RMSE after Umeyama alignment.

The port's own copy of `gmmloc_tpu/eval/ate.py` (numpy only). It follows
the reference's evo-based scoring protocol (gmmloc_ros
scripts/evo_euroc.py:35-57): associate by timestamp, SE3 + scale Umeyama
alignment, APE on the translation part, report mean/RMSE.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x, y, with_scale=True):
    """Least-squares similarity transform aligning x -> y. x, y: (3, N).

    Returns (r (3,3), t (3,), c scalar) with y ≈ c * r @ x + t.
    """
    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    n = x.shape[1]
    cov = yc @ xc.T / n
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    r = U @ S @ Vt
    if with_scale:
        var_x = (xc**2).sum() / n
        c = np.trace(np.diag(d) @ S) / var_x
    else:
        c = 1.0
    t = my[:, 0] - c * r @ mx[:, 0]
    return r, t, c


def associate_by_timestamp(t_est, t_ref, max_diff=0.02):
    """Greedy nearest-timestamp association (evo's default behavior)."""
    i_est, i_ref = [], []
    j = 0
    for i, t in enumerate(t_est):
        j = int(np.searchsorted(t_ref, t))
        best, bd = -1, max_diff
        for cand in (j - 1, j):
            if 0 <= cand < len(t_ref):
                d = abs(t_ref[cand] - t)
                if d <= bd:
                    best, bd = cand, d
        if best >= 0:
            i_est.append(i)
            i_ref.append(best)
    return np.array(i_est, int), np.array(i_ref, int)


def ate_rmse(t_est, p_est, t_ref, p_ref, with_scale=True, max_diff=0.02):
    """APE translation stats after alignment. Positions are (N,3).

    Returns dict(rmse, mean, median, n).
    """
    t_est = np.asarray(t_est)
    p_est = np.asarray(p_est)
    # drop non-finite estimates (a rescued-but-diverged frame must not
    # poison the SVD for the whole run)
    fin = np.isfinite(p_est).all(axis=1)
    t_est, p_est = t_est[fin], p_est[fin]
    ie, ir = associate_by_timestamp(t_est, np.asarray(t_ref), max_diff)
    if len(ie) < 3:
        return {"rmse": float("inf"), "mean": float("inf"), "median": float("inf"), "n": 0}
    x = np.asarray(p_est)[ie].T
    y = np.asarray(p_ref)[ir].T
    r, t, c = umeyama_alignment(x, y, with_scale)
    x_aligned = c * r @ x + t[:, None]
    err = np.linalg.norm(x_aligned - y, axis=0)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "n": len(ie),
    }


def load_tum(path: str):
    """TUM trajectory: t x y z qx qy qz qw -> (timestamps, positions, quats_wxyz)."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    ts = data[:, 0]
    pos = data[:, 1:4]
    q = data[:, [7, 4, 5, 6]]
    return ts, pos, q
