"""Offline visualization: trajectories, GMM ellipsoids, map state.

The port's own copy of `gmmloc_tpu/pipeline/visualizer.py`. Replaces the
reference's ROS visualization stack (visualizer.cpp -- keyframe frustums,
covisibility edges and the landmark cloud coloured by GMM association;
gmm_visualizer.cpp -- component ellipsoids; campose_visualizer.cpp --
camera frustums) with matplotlib figures written to disk. matplotlib is
imported only inside the functions (`_require_mpl`), so importing this
module needs none.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .html_viewer import _host


def _require_mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory_top(
    out_path: str,
    t_est: np.ndarray,
    t_gt: Optional[np.ndarray] = None,
    kf_t_wc: Optional[np.ndarray] = None,
    title: str = "trajectory (top view)",
):
    """Top-down (x, y) trajectory plot: estimate vs GT + keyframes."""
    plt = _require_mpl()
    fig, ax = plt.subplots(figsize=(8, 8))
    if t_gt is not None:
        ax.plot(t_gt[:, 0], t_gt[:, 1], "-", color="0.6", lw=1.5, label="GT")
    ax.plot(t_est[:, 0], t_est[:, 1], "-", color="tab:blue", lw=1.0, label="estimate")
    if kf_t_wc is not None and len(kf_t_wc):
        ax.scatter(kf_t_wc[:, 0], kf_t_wc[:, 1], s=14, c="tab:red",
                   marker="^", label="keyframes", zorder=3)
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_gmm_map_top(
    out_path: str,
    means: np.ndarray,
    covs: np.ndarray,
    valid: Optional[np.ndarray] = None,
    deg: Optional[np.ndarray] = None,
    pts: Optional[np.ndarray] = None,
    pt_assoc: Optional[np.ndarray] = None,
    title: str = "GMM map (top view)",
):
    """Component 1-sigma ellipses in (x, y) + optional landmark cloud
    colored by association (ref: visualizer.cpp drawMapPoints coloring)."""
    plt = _require_mpl()
    from matplotlib.patches import Ellipse

    fig, ax = plt.subplots(figsize=(9, 9))
    K = len(means)
    valid = np.ones(K, bool) if valid is None else np.asarray(valid)
    deg = np.zeros(K, bool) if deg is None else np.asarray(deg)
    for k in np.where(valid)[0]:
        c2 = covs[k][:2, :2]
        w, V = np.linalg.eigh(c2)
        ang = np.degrees(np.arctan2(V[1, 1], V[0, 1]))
        e = Ellipse(
            means[k, :2], 2 * np.sqrt(max(w[1], 1e-9)),
            2 * np.sqrt(max(w[0], 1e-9)),
            angle=ang, alpha=0.25,
            color="tab:green" if deg[k] else "tab:orange",
        )
        ax.add_patch(e)
    if pts is not None and len(pts):
        colors = None
        if pt_assoc is not None:
            colors = np.where(np.asarray(pt_assoc) >= 0, "tab:blue", "0.4")
        ax.scatter(pts[:, 0], pts[:, 1], s=1.0, c=colors)
    ax.set_aspect("equal")
    ax.autoscale_view()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_covisibility(
    out_path: str, world, title: str = "covisibility graph"
):
    """Keyframe positions + covisibility edges (visualizer.cpp:223-249)."""
    plt = _require_mpl()
    from ..mapping.map_state import _quat_to_mat

    fig, ax = plt.subplots(figsize=(8, 8))
    kfs = np.where(world.kf_valid)[0]
    pos = {}
    for k in kfs:
        pos[k] = -_quat_to_mat(world.kf_q[k]).T @ world.kf_t[k]
    for a in kfs:
        for b in kfs:
            if b > a and world.covis_link[a, b]:
                ax.plot(
                    [pos[a][0], pos[b][0]], [pos[a][1], pos[b][1]],
                    "-", color="0.8", lw=0.5,
                )
    p = np.array([pos[k] for k in kfs])
    if len(p):
        ax.scatter(p[:, 0], p[:, 1], s=18, c="tab:red", marker="^", zorder=3)
    ax.set_aspect("equal")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def dump_run_report(out_dir: str, system, t_gt: Optional[np.ndarray] = None):
    """Write the full figure set for a finished run."""
    os.makedirs(out_dir, exist_ok=True)
    w = system.world
    ts, q_est, t_est = w.export_trajectory()
    from ..mapping.map_state import _quat_to_mat

    kfs = np.where(w.kf_valid)[0]
    kf_t_wc = np.array(
        [-_quat_to_mat(w.kf_q[k]).T @ w.kf_t[k] for k in kfs]
    ) if len(kfs) else np.zeros((0, 3))
    plot_trajectory_top(
        os.path.join(out_dir, "trajectory.png"), t_est, t_gt, kf_t_wc
    )
    pts = w.pt_pos[w.pt_valid]
    assoc = w.pt_assoc_comp[w.pt_valid]
    plot_gmm_map_top(
        os.path.join(out_dir, "map.png"),
        _host(system.gmap.means),
        _host(system.gmap.covs),
        _host(system.gmap.valid),
        _host(system.gmap.is_degenerated),
        pts, assoc,
    )
    plot_covisibility(os.path.join(out_dir, "covisibility.png"), w)
