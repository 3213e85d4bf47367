"""The harness's arithmetic: window rate, percentiles, the trajectory
error, the spread of a set of runs.

`ate` is a copy of the port's `eval/ate.py` (Umeyama alignment with
scale, as the upstream protocol's evo call aligns, greedy nearest
timestamp association); `window_fps` is the rate of the port's
`eval/bench.window_stats` (all frames over all the time of the window).
"""

from __future__ import annotations

import statistics

import numpy as np


def window_fps(n_frames: int, seconds: float) -> float:
    return n_frames / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by nearest rank at round((n - 1) q)."""
    v = sorted(values)
    return float(v[round((len(v) - 1) * q / 100.0)])


def spread(values) -> float:
    """(third quartile - first quartile) / median, by
    `statistics.quantiles(values, n=4)`."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def umeyama_alignment(x, y, with_scale=True):
    """Least-squares similarity transform aligning x -> y (both (3, N)):
    (r, t, c) with y ~ c r x + t."""
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
        var_x = (xc ** 2).sum() / n
        c = np.trace(np.diag(d) @ S) / var_x
    else:
        c = 1.0
    t = my[:, 0] - c * r @ mx[:, 0]
    return r, t, c


def associate_by_timestamp(t_est, t_ref, max_diff=0.02):
    i_est, i_ref = [], []
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
    """RMSE (m) of the positions after alignment, and the frames
    compared: (rmse, n)."""
    t_est, p_est = np.asarray(t_est), np.asarray(p_est)
    fin = np.isfinite(p_est).all(axis=1)
    t_est, p_est = t_est[fin], p_est[fin]
    ie, ir = associate_by_timestamp(t_est, np.asarray(t_ref), max_diff)
    if len(ie) < 3:
        return float("inf"), 0
    x, y = p_est[ie].T, np.asarray(p_ref)[ir].T
    r, t, c = umeyama_alignment(x, y, with_scale)
    err = np.linalg.norm(c * r @ x + t[:, None] - y, axis=0)
    return float(np.sqrt((err ** 2).mean())), len(ie)
