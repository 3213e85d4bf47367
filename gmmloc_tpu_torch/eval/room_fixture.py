"""Seeded room-scale GMM map and ground-truth trajectory (numpy only).

A stand-in for the EuRoC V1 Vicon-room assets (the prior `.gmm` map and a
`gt_sync` trajectory), generated from a seed so that end-to-end runs need
no download:

  - the map: flat (degenerate) Gaussian tiles on the four walls, the floor
    and the ceiling of a box room of about the V1 room's size, plus some
    full-rank clutter blobs near the walls. It is written with the
    reference's varint-framed protobuf stream
    (`gmmloc_tpu.utils.proto.save_gmm_file`), so both packages load it
    through the same parser.
  - the trajectory: 20 Hz, about 0.4 m/s along a wobbling ellipse around
    the room centre, the camera yawing to look at the walls, written in
    the `gt_sync` text format (`t x y z qx qy qz qw`, T_w_c) that
    `eval/synthetic.load_gt_trajectory` reads.

Run as a script to write both files:

    python -m gmmloc_tpu_torch.eval.room_fixture OUT_DIR [--components N]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gmmloc_tpu.utils import proto

# V1-room-sized box (metres, z up): the walls bound the Vicon volume
ROOM_X = (-4.0, 4.0)
ROOM_Y = (-3.5, 3.5)
ROOM_Z = (0.0, 3.2)
PLANE_VAR = 1e-6        # normal-direction variance: < 1e-4 -> degenerate
CLUTTER_FRAC = 0.1


def _frame_from_normal(n):
    """Orthonormal basis (t1, t2, n) with n the third column."""
    a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
    t1 = np.cross(n, a)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(n, t1)
    return np.stack([t1, t2, n], 1)


def _surfaces():
    """(origin, u_axis, v_axis, u_len, v_len, inward normal) per surface."""
    x0, x1 = ROOM_X
    y0, y1 = ROOM_Y
    z0, z1 = ROOM_Z
    ex, ey, ez = np.eye(3)
    return [
        (np.array([x0, y0, z0]), ex, ey, x1 - x0, y1 - y0, ez),     # floor
        (np.array([x0, y0, z1]), ex, ey, x1 - x0, y1 - y0, -ez),    # ceiling
        (np.array([x0, y0, z0]), ey, ez, y1 - y0, z1 - z0, ex),     # x0 wall
        (np.array([x1, y0, z0]), ey, ez, y1 - y0, z1 - z0, -ex),    # x1 wall
        (np.array([x0, y0, z0]), ex, ez, x1 - x0, z1 - z0, ey),     # y0 wall
        (np.array([x0, y1, z0]), ex, ez, x1 - x0, z1 - z0, -ey),    # y1 wall
    ]


def make_room_gmm(n_components: int = 3300, seed: int = 0):
    """Returns (means (K,3), covs (K,3,3), is_degenerate (K,)) with K ==
    n_components: planar tiles spread over the surfaces by area, the rest
    full-rank clutter blobs."""
    rng = np.random.default_rng(seed)
    n_clutter = int(round(CLUTTER_FRAC * n_components))
    n_planar = n_components - n_clutter
    surf = _surfaces()
    area = np.array([s[3] * s[4] for s in surf])
    per = np.floor(n_planar * area / area.sum()).astype(int)
    per[: n_planar - per.sum()] += 1

    means, covs = [], []
    for (o, u, v, lu, lv, n), k in zip(surf, per):
        # jittered grid: cells sized so k tiles cover the surface
        nu = max(1, int(round(np.sqrt(k * lu / lv))))
        nv = int(np.ceil(k / nu))
        cells = rng.permutation(nu * nv)[:k]
        cu = (cells % nu + rng.uniform(0.2, 0.8, k)) / nu * lu
        cv = (cells // nu + rng.uniform(0.2, 0.8, k)) / nv * lv
        means.append(o + cu[:, None] * u + cv[:, None] * v)
        cell = min(lu / nu, lv / nv)
        for _ in range(k):
            s1, s2 = rng.uniform(0.25, 0.45, 2) * cell
            ang = rng.uniform(0, np.pi)
            d1 = np.cos(ang) * u + np.sin(ang) * v
            d2 = -np.sin(ang) * u + np.cos(ang) * v
            B = np.stack([d1, d2, n], 1)
            covs.append(B @ np.diag([s1 * s1, s2 * s2, PLANE_VAR]) @ B.T)

    # clutter: full-rank blobs 0.3-1.2 m in front of a random wall
    cm = np.stack([
        rng.uniform(ROOM_X[0] + 0.3, ROOM_X[1] - 0.3, n_clutter),
        rng.uniform(ROOM_Y[0] + 0.3, ROOM_Y[1] - 0.3, n_clutter),
        rng.uniform(ROOM_Z[0] + 0.2, ROOM_Z[1] - 0.6, n_clutter),
    ], -1)
    side = rng.integers(0, 4, n_clutter)
    off = rng.uniform(0.3, 1.2, n_clutter)
    cm[side == 0, 0] = ROOM_X[0] + off[side == 0]
    cm[side == 1, 0] = ROOM_X[1] - off[side == 1]
    cm[side == 2, 1] = ROOM_Y[0] + off[side == 2]
    cm[side == 3, 1] = ROOM_Y[1] - off[side == 3]
    for _ in range(n_clutter):
        axis = rng.normal(size=3)
        B = _frame_from_normal(axis / np.linalg.norm(axis))
        sd = rng.uniform(0.05, 0.2, 3)
        covs.append(B @ np.diag(sd * sd) @ B.T)
    means.append(cm)

    means = np.concatenate(means)
    covs = np.stack(covs)
    covs = 0.5 * (covs + covs.transpose(0, 2, 1))
    is_deg = np.linalg.eigvalsh(covs)[:, 0] < 1e-4
    return means, covs, is_deg


def _rot_to_quat(R):
    """Rotation matrix -> (w, x, y, z), Shepperd's method (float64)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
        q = [0.0] * 4
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    q = np.array(q)
    return q / np.linalg.norm(q)


def make_room_trajectory(n_frames: int = 600, seed: int = 0, hz: float = 20.0,
                         speed: float = 0.4):
    """Returns (ts (N,), t_wc (N,3), q_wc (N,4) as w,x,y,z): a smooth loop
    around the room centre at ~`speed` m/s, the optical axis yawing to
    face the walls with a slow sweep and a slight downward pitch."""
    rng = np.random.default_rng(seed + 1)
    ts = np.arange(n_frames) / hz
    ra, rb = 1.4, 1.0                      # ellipse semi-axes (m)
    circ = np.pi * (3 * (ra + rb) - np.sqrt((3 * ra + rb) * (ra + 3 * rb)))
    phase = rng.uniform(0, 2 * np.pi)
    sweep_f = rng.uniform(0.05, 0.08)
    th = phase + 2 * np.pi * speed * ts / circ
    pos = np.stack([
        ra * np.cos(th) + 0.15 * np.sin(0.31 * ts),
        rb * np.sin(th) + 0.1 * np.sin(0.23 * ts + 1.0),
        1.3 + 0.12 * np.sin(0.4 * ts),
    ], -1)
    # look outward (towards the nearest walls), sweeping +-35 degrees
    yaw = th + np.radians(35.0) * np.sin(2 * np.pi * sweep_f * ts)
    pitch = np.radians(-8.0 + 4.0 * np.sin(0.3 * ts))
    roll = np.radians(2.0 * np.sin(0.5 * ts))
    qs = []
    for ps, yw, pt, rl in zip(pos, yaw, pitch, roll):
        d = np.array([np.cos(yw) * np.cos(pt), np.sin(yw) * np.cos(pt), np.sin(pt)])
        up = np.array([0.0, 0.0, 1.0])
        x_c = np.cross(d, up)
        x_c /= np.linalg.norm(x_c)
        y_c = np.cross(d, x_c)
        # roll about the optical axis
        c, s = np.cos(rl), np.sin(rl)
        x_r, y_r = c * x_c + s * y_c, -s * x_c + c * y_c
        R_wc = np.stack([x_r, y_r, d], 1)
        qs.append(_rot_to_quat(R_wc))
    return ts, pos, np.array(qs)


def write_room_fixture(out_dir: str, n_components: int = 3300,
                       n_frames: int = 600, seed: int = 0):
    """Write `room.gmm` and `room_gt.txt` under out_dir; returns their
    paths (gmm_path, gt_path)."""
    os.makedirs(out_dir, exist_ok=True)
    means, covs, deg = make_room_gmm(n_components, seed)
    gmm_path = os.path.join(out_dir, "room.gmm")
    proto.save_gmm_file(gmm_path, means, covs, deg, np.zeros(len(means), bool))
    ts, t_wc, q_wc = make_room_trajectory(n_frames, seed)
    gt_path = os.path.join(out_dir, "room_gt.txt")
    rows = np.concatenate([ts[:, None], t_wc, q_wc[:, [1, 2, 3, 0]]], 1)
    np.savetxt(gt_path, rows, fmt="%.9f")
    return gmm_path, gt_path


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--components", type=int, default=3300)
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    print(*write_room_fixture(a.out_dir, a.components, a.frames, a.seed))
