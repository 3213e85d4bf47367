"""The benchmark's inputs, made from the seed: one general generator.

Everything a cell feeds the program comes from here, driven by the
numbers of its configuration file (camera, map size) and its traffic
file (frame kind, landmark count, noise, warm-up, ceiling rate):

  - the room: a prior GMM map of a V1-sized box room (planar tiles on the
    walls, floor and ceiling, full-rank clutter blobs) and a 20 Hz
    ground-truth trajectory looping the room at about 0.4 m/s; a copy of
    the port's seeded room fixture (`eval/room_fixture.py`), its tile
    draws taken in one call;
  - the landmark world sampled from the map (`sample_world`, a copy of
    `eval/synthetic.sample_world_from_gmm` with its draws taken in one
    call);
  - feature frames (`feature_frames`): the port's synthetic stereo
    feature front end (`eval/synthetic.SyntheticFrontend`: temporally
    correlated AR(1) pixel, disparity and detection noise, response-ranked
    budget with dropout, stereo failures, descriptor bit flips, spurious
    detections), made in batches of frames on the device from noise drawn
    with a `torch.Generator` (`draw_feature_noise`); `make_feature_frames`
    is the arithmetic, and fed the port's own draws it gives the port's
    frames; a traffic's camera dropouts make some of them dark
    (`dark_mask`: every landmark detection dropped, the draws unchanged);
  - the descriptors a configuration's vocabulary is trained on
    (`vocabulary_descs`);
  - stereo pairs (`render_pairs`): the port's sprite renderer
    (`eval/image_synthetic.SpriteRenderer`: additive Gaussian splats of
    the landmark world, uint8), in float64 on the device.

Imports nothing of the program; the frames are returned as plain arrays.
"""

from __future__ import annotations

import io
import math
from dataclasses import dataclass

import numpy as np
import torch

# V1-room-sized box (metres, z up)
ROOM_X = (-4.0, 4.0)
ROOM_Y = (-3.5, 3.5)
ROOM_Z = (0.0, 3.2)
PLANE_VAR = 1e-6
CLUTTER_FRAC = 0.1
SPRITE_PATCH_R = 24        # the renderer's patch radius (px)


def quat_to_mat(q):
    """(..., 4) w, x, y, z -> (..., 3, 3), numpy float64."""
    q = np.asarray(q, np.float64)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


# ---------------------------------------------------------------------------
# the room: map and trajectory
# ---------------------------------------------------------------------------


def _frame_from_normal(n):
    a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
    t1 = np.cross(n, a)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(n, t1)
    return np.stack([t1, t2, n], 1)


def _surfaces():
    (x0, x1), (y0, y1), (z0, z1) = ROOM_X, ROOM_Y, ROOM_Z
    ex, ey, ez = np.eye(3)
    return [
        (np.array([x0, y0, z0]), ex, ey, x1 - x0, y1 - y0, ez),
        (np.array([x0, y0, z1]), ex, ey, x1 - x0, y1 - y0, -ez),
        (np.array([x0, y0, z0]), ey, ez, y1 - y0, z1 - z0, ex),
        (np.array([x1, y0, z0]), ey, ez, y1 - y0, z1 - z0, -ex),
        (np.array([x0, y0, z0]), ex, ez, x1 - x0, z1 - z0, ey),
        (np.array([x0, y1, z0]), ex, ez, x1 - x0, z1 - z0, -ey),
    ]


def room_gmm(n_components: int, seed: int):
    """(means (K,3), covs (K,3,3)): planar tiles spread over the surfaces
    by area, the rest full-rank clutter blobs in front of the walls."""
    rng = np.random.default_rng(seed)
    n_clutter = int(round(CLUTTER_FRAC * n_components))
    n_planar = n_components - n_clutter
    surf = _surfaces()
    area = np.array([s[3] * s[4] for s in surf])
    per = np.floor(n_planar * area / area.sum()).astype(int)
    per[: n_planar - per.sum()] += 1
    means, covs = [], []
    for (o, u, v, lu, lv, n), k in zip(surf, per):
        nu = max(1, int(round(np.sqrt(k * lu / lv))))
        nv = int(np.ceil(k / nu))
        cells = rng.permutation(nu * nv)[:k]
        cu = (cells % nu + rng.uniform(0.2, 0.8, k)) / nu * lu
        cv = (cells // nu + rng.uniform(0.2, 0.8, k)) / nv * lv
        means.append(o + cu[:, None] * u + cv[:, None] * v)
        cell = min(lu / nu, lv / nv)
        # per tile: two axis lengths, then an angle (the draws in the
        # order the per-tile loop takes them)
        r = rng.random((k, 3))
        s = (0.25 + (0.45 - 0.25) * r[:, :2]) * cell
        ang = 0.0 + (np.pi - 0.0) * r[:, 2]
        d1 = np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * v
        d2 = -np.sin(ang)[:, None] * u + np.cos(ang)[:, None] * v
        B = np.stack([d1, d2, np.broadcast_to(n, d1.shape)], 2)
        lam = np.stack([s[:, 0] * s[:, 0], s[:, 1] * s[:, 1],
                        np.full(k, PLANE_VAR)], 1)
        covs.append(np.einsum("kij,kj,klj->kil", B, lam, B))
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
    clutter = []
    for _ in range(n_clutter):
        axis = rng.normal(size=3)
        B = _frame_from_normal(axis / np.linalg.norm(axis))
        sd = rng.uniform(0.05, 0.2, 3)
        clutter.append(B @ np.diag(sd * sd) @ B.T)
    means.append(cm)
    means = np.concatenate(means)
    covs = np.concatenate(covs + [np.stack(clutter)]) if clutter else np.concatenate(covs)
    covs = 0.5 * (covs + covs.transpose(0, 2, 1))
    return means, covs


def _rot_to_quat(R):
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


def room_trajectory(n_frames: int, seed: int, hz: float = 20.0, speed: float = 0.4):
    """(ts (N,), q_wc (N,4) w,x,y,z, t_wc (N,3)): a smooth loop around the
    room centre at ~`speed` m/s, yawing to face the walls."""
    rng = np.random.default_rng(seed + 1)
    ts = np.arange(n_frames) / hz
    ra, rb = 1.4, 1.0
    circ = np.pi * (3 * (ra + rb) - np.sqrt((3 * ra + rb) * (ra + 3 * rb)))
    phase = rng.uniform(0, 2 * np.pi)
    sweep_f = rng.uniform(0.05, 0.08)
    th = phase + 2 * np.pi * speed * ts / circ
    pos = np.stack([
        ra * np.cos(th) + 0.15 * np.sin(0.31 * ts),
        rb * np.sin(th) + 0.1 * np.sin(0.23 * ts + 1.0),
        1.3 + 0.12 * np.sin(0.4 * ts),
    ], -1)
    yaw = th + np.radians(35.0) * np.sin(2 * np.pi * sweep_f * ts)
    pitch = np.radians(-8.0 + 4.0 * np.sin(0.3 * ts))
    roll = np.radians(2.0 * np.sin(0.5 * ts))
    qs = []
    for yw, pt, rl in zip(yaw, pitch, roll):
        d = np.array([np.cos(yw) * np.cos(pt), np.sin(yw) * np.cos(pt), np.sin(pt)])
        x_c = np.cross(d, np.array([0.0, 0.0, 1.0]))
        x_c /= np.linalg.norm(x_c)
        y_c = np.cross(d, x_c)
        c, s = np.cos(rl), np.sin(rl)
        qs.append(_rot_to_quat(np.stack([c * x_c + s * y_c, -s * x_c + c * y_c, d], 1)))
    # through the gt_sync text (t x y z qx qy qz qw, 9 decimals) the
    # port's runs read, the quaternion normalised after it
    buf = io.StringIO()
    qs = np.array(qs)
    np.savetxt(buf, np.concatenate([ts[:, None], pos, qs[:, [1, 2, 3, 0]]], 1), fmt="%.9f")
    buf.seek(0)
    rows = np.loadtxt(buf)
    q = rows[:, [7, 4, 5, 6]]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return rows[:, 0], q, rows[:, 1:4]


# ---------------------------------------------------------------------------
# the landmark world
# ---------------------------------------------------------------------------


@dataclass
class World:
    landmarks: np.ndarray      # (N,3)
    desc: np.ndarray           # (N,32) uint8
    base_angle: np.ndarray     # (N,) degrees, float32
    ref_dist: np.ndarray       # (N,) scale-reference distance
    response: np.ndarray       # (N,) float32 persistent corner strength


def sample_world(means, covs, n_landmarks: int, seed: int) -> World:
    """Landmarks sampled from the components (planar ones exactly on
    their plane), with descriptors, base angles, scale references and
    responses."""
    rng = np.random.default_rng(seed)
    K = len(means)
    per = np.full(K, n_landmarks // K)
    per[: n_landmarks - per.sum()] += 1
    evals, evecs = np.linalg.eigh(covs)
    w = evals.copy()
    w[w[:, 0] < 1e-4, 0] = 0.0
    comp = np.repeat(np.arange(K), per)
    z = rng.standard_normal((len(comp), 3)) * np.sqrt(np.clip(w[comp], 0, None))
    pts = means[comp] + np.einsum("nj,nij->ni", z, evecs[comp])
    N = len(pts)
    return World(
        landmarks=pts,
        desc=rng.integers(0, 256, size=(N, 32), dtype=np.uint8),
        base_angle=rng.uniform(0, 360, N).astype(np.float32),
        ref_dist=rng.uniform(1.5, 12.0, N),
        response=rng.uniform(0.0, 1.0, N).astype(np.float32),
    )


# ---------------------------------------------------------------------------
# feature frames
# ---------------------------------------------------------------------------


def noise_rho(q_wc, t_wc):
    """The AR(1) coefficient of each frame's noise: exp(-(dt / 1 cm +
    dangle / 5 mrad)) of the motion from the previous frame, 0 for the
    first."""
    rho = np.zeros(len(t_wc))
    for k in range(1, len(t_wc)):
        dt = np.linalg.norm(t_wc[k] - t_wc[k - 1])
        dq = abs(float(np.dot(q_wc[k], q_wc[k - 1])))
        dang = 2.0 * np.arccos(min(1.0, dq))
        rho[k] = float(np.exp(-(dt / 0.01 + dang / 0.005)))
    return rho


def feature_budget(p: dict) -> tuple:
    """(landmark slots, spurious detections) per frame."""
    n_spur = int(p["num_features"] * p["spurious_frac"])
    return p["num_features"] - n_spur, n_spur


def draw_feature_noise(gen: torch.Generator, K: int, N: int, p: dict, device) -> dict:
    """Every random number K frames take, in fixed shapes, from `gen`."""
    B, S = feature_budget(p)
    f64 = dict(dtype=torch.float64, device=device, generator=gen)
    margin = p["margin_px"]
    return dict(
        fresh_uv=torch.randn((K, N, 2), **f64), fresh_d=torch.randn((K, N), **f64),
        fresh_det=torch.randn((K, N), **f64), stereo_u=torch.rand((K, B), **f64),
        flips=torch.randint(0, 256, (K, B, p["desc_flip_bits"]), device=device, generator=gen),
        su=margin + (p["width"] - margin - margin) * torch.rand((K, S), **f64),
        sv=margin + (p["height"] - margin - margin) * torch.rand((K, S), **f64),
        sdesc=torch.randint(0, 256, (K, S, 32), device=device, generator=gen).to(torch.uint8),
        soct=torch.randint(0, 3, (K, S), device=device, generator=gen),
        sang=360.0 * torch.rand((K, S), **f64))


def make_feature_frames(world: World, q_wc, t_wc, rho, noise: dict, state, p: dict,
                        device, dark=None) -> tuple:
    """The frames at poses (q_wc, t_wc) (K of them), from `noise`
    (`draw_feature_noise`'s shapes) and the AR(1) noise `state` left by
    the previous frame (None before the first). Returns (frames, state):
    each frame a dict of numpy arrays uv (n,2) f64, ur, depth (n,) f32,
    octave (n,) i64, angle (n,) f64, desc (n,32) u8, in the order the
    port's synthetic front end lists them. A frame whose `dark` (K,) is
    true has every landmark detection dropped (the port's front end at
    `drop_frac` 1.0) and keeps its spurious ones; the draws are the same
    either way."""
    f64 = torch.float64
    T = lambda a, dt=f64: torch.as_tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    K = len(t_wc)
    fx, fy, cx, cy, bf = (p[k] for k in ("fx", "fy", "cx", "cy", "bf"))
    W, H, margin = p["width"], p["height"], p["margin_px"]
    B, S = feature_budget(p)
    R_cw = np.swapaxes(quat_to_mat(q_wc), -1, -2)
    t_cw = -np.einsum("kij,kj->ki", R_cw, t_wc)
    lm = T(world.landmarks)
    # the AR(1) states frame by frame
    if state is None:
        state = tuple(torch.zeros_like(noise[k][0]) for k in ("fresh_uv", "fresh_d", "fresh_det"))
    n_uv, n_d, n_det = state
    states = []
    for k in range(K):
        r = float(rho[k])
        c = math.sqrt(max(0.0, 1.0 - r * r))
        n_uv = r * n_uv + c * noise["fresh_uv"][k]
        n_d = r * n_d + c * noise["fresh_d"][k]
        n_det = r * n_det + c * noise["fresh_det"][k]
        states.append((n_uv, n_d, n_det))
    nuv = torch.stack([s[0] for s in states])
    nd = torch.stack([s[1] for s in states])
    ndet = torch.stack([s[2] for s in states])
    # projection of every landmark in every frame (the per-frame product
    # as the port takes it: landmarks @ R_cw.T + t_cw)
    pc = torch.matmul(lm[None], T(R_cw).transpose(-1, -2)) + T(t_cw)[:, None, :]
    z = pc[..., 2]
    vis = z > 0.3
    zs = torch.where(vis, z, torch.ones_like(z))
    u = torch.where(vis, fx * pc[..., 0] / zs + cx, torch.full_like(z, -1.0))
    v = torch.where(vis, fy * pc[..., 1] / zs + cy, torch.full_like(z, -1.0))
    vis &= (u >= margin) & (v >= margin) & (u < W - margin) & (v < H - margin)
    vis &= z < 45.0
    keep = vis & (torch.special.ndtr(ndet) > p["drop_frac"])
    if dark is not None:
        keep &= ~torch.as_tensor(np.asarray(dark, bool), device=device)[:, None]
    count = keep.sum(1)
    ids_all = torch.arange(lm.shape[0], device=device, dtype=f64).expand_as(z)
    score = T(world.response, torch.float32)[None].to(f64) + 0.02 * ndet
    # over budget: the B best by response (descending); else every kept
    # landmark in id order
    over = (count > B)[:, None]
    key = torch.where(over, -score, ids_all)
    key = torch.where(keep, key, torch.full_like(key, math.inf))
    order = torch.argsort(key, dim=1)[:, :B]
    n_take = torch.clamp(count, max=B)
    slot_ok = torch.arange(B, device=device)[None] < n_take[:, None]
    ids = torch.where(slot_ok, order, torch.zeros_like(order))
    g = lambda a: torch.gather(a, 1, ids)  # noqa: E731
    tw = T(t_wc)
    dist = torch.linalg.norm(lm[ids] - tw[:, None, :], dim=-1)
    log_sf = math.log(p["scale_factor"])
    octave = torch.clamp(torch.round(torch.log(T(world.ref_dist)[ids]
                                               / torch.clamp(dist, min=0.1)) / log_sf),
                         0, p["num_levels"] - 1).to(torch.int32)
    sf = T(p["scale_factor"] ** np.arange(p["num_levels"], dtype=np.float64))[octave.long()]
    nuv_i = torch.gather(nuv, 1, ids[..., None].expand(K, B, 2))
    uu = g(u) + nuv_i[..., 0] * p["pixel_noise"] * sf
    vv = g(v) + nuv_i[..., 1] * p["pixel_noise"] * sf
    disp = bf / g(z) + g(nd) * p["disp_noise"] * sf
    has_st = (noise["stereo_u"] < p["stereo_frac"]) & (disp > 0.3)
    ur = torch.where(has_st, uu - disp, torch.full_like(uu, -1.0)).to(torch.float32)
    depth = torch.where(has_st, bf / torch.clamp(disp, min=0.3),
                        torch.full_like(uu, -1.0)).to(torch.float32)
    desc = T(world.desc, torch.uint8)[ids]
    for b in range(p["desc_flip_bits"]):
        fl = noise["flips"][..., b]
        byte, bit = fl >> 3, fl & 7
        mask = torch.zeros_like(desc).scatter_(
            2, byte[..., None], (1 << bit).to(torch.uint8)[..., None])
        desc = desc ^ mask
    yaw = np.degrees(np.arctan2(R_cw[:, 0, 1], R_cw[:, 0, 0]))
    angle = torch.remainder(T(world.base_angle, torch.float32)[ids].to(f64) - T(yaw)[:, None],
                            360.0)
    host = {k: a.cpu().numpy() for k, a in dict(
        uu=uu, vv=vv, ur=ur, depth=depth, octave=octave.to(torch.int64), angle=angle,
        desc=desc, n=n_take, su=noise["su"], sv=noise["sv"], sdesc=noise["sdesc"],
        soct=noise["soct"], sang=noise["sang"]).items()}
    frames = []
    for k in range(K):
        n = int(host["n"][k])
        frames.append(dict(
            uv=np.concatenate([np.stack([host["uu"][k, :n], host["vv"][k, :n]], -1),
                               np.stack([host["su"][k], host["sv"][k]], -1)]),
            ur=np.concatenate([host["ur"][k, :n], np.full(S, -1.0, np.float32)]),
            depth=np.concatenate([host["depth"][k, :n], np.full(S, -1.0, np.float32)]),
            octave=np.concatenate([host["octave"][k, :n], host["soct"][k]]),
            angle=np.concatenate([host["angle"][k, :n], host["sang"][k]]),
            desc=np.concatenate([host["desc"][k, :n], host["sdesc"][k]])))
    return frames, (n_uv, n_d, n_det)


def feature_frames(world: World, q_wc, t_wc, seed: int, p: dict, device,
                   chunk: int = 32, dark=None) -> list:
    """Every frame along (q_wc, t_wc), made `chunk` frames at a time on
    `device` from a generator seeded with `seed`; the frames where `dark`
    (one flag per pose, or None) is true are dark (`make_feature_frames`)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rho = noise_rho(q_wc, t_wc)
    N = len(world.landmarks)
    frames, state = [], None
    for k0 in range(0, len(t_wc), chunk):
        sl = slice(k0, min(k0 + chunk, len(t_wc)))
        noise = draw_feature_noise(gen, sl.stop - sl.start, N, p, device)
        out, state = make_feature_frames(world, q_wc[sl], t_wc[sl], rho[sl], noise, state,
                                         p, device, None if dark is None else dark[sl])
        frames += out
    return frames


def dark_mask(n_frames: int, n_warm: int, traffic: dict):
    """(n_frames,) bool: the dark frames of a traffic with dropouts, None
    for one without. A dropout of `dark_frames` frames starts every
    `dark_every` frames from the window's frame `dark_from` (frame
    `n_warm` of the traffic); the warm-up is never dark."""
    if "dark_every" not in traffic:
        return None
    k = np.arange(n_frames) - n_warm - traffic["dark_from"]
    return (k >= 0) & (k % traffic["dark_every"] < traffic["dark_frames"])


def vocabulary_descs(train: str, means, covs, n_landmarks: int, room_seed: int):
    """The descriptors a configuration's vocabulary is trained on:
    "landmark_desc_every_<n>" is every n-th descriptor of the room's
    landmark world (drawn from the room's seed)."""
    prefix = "landmark_desc_every_"
    if not train.startswith(prefix):
        raise ValueError(f"unknown vocabulary training set {train!r}")
    world = sample_world(means, covs, n_landmarks, room_seed)
    return world.desc[::int(train[len(prefix):])]


# ---------------------------------------------------------------------------
# stereo pairs
# ---------------------------------------------------------------------------


def sprite_looks(n: int, seed: int):
    """(contrast (n,), radius in metres (n,)) of the sprites."""
    rng = np.random.default_rng(seed)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    contrast = rng.uniform(60, 170, n) * sign
    size_m = rng.uniform(0.010, 0.03, n)
    return contrast, size_m


def render(world: World, contrast, size_m, q_wc, t_wc, p: dict, right: bool, device,
           bg: float = 40.0):
    """One (H, W) uint8 image of the sprite world at the camera pose
    T_wc (the right camera displaced by the baseline), in float64 on
    `device`."""
    f64 = torch.float64
    fx, fy, cx, cy, bf = (p[k] for k in ("fx", "fy", "cx", "cy", "bf"))
    W, H, RR = p["width"], p["height"], SPRITE_PATCH_R
    R_cw = quat_to_mat(q_wc).T
    t_cw = -R_cw @ np.asarray(t_wc)
    if right:
        t_cw = t_cw - np.array([bf / fx, 0.0, 0.0])
    T = lambda a, dt=f64: torch.as_tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    pc = T(world.landmarks) @ T(R_cw).T + T(t_cw)
    z = pc[:, 2]
    vis = z > 0.3
    zs = torch.where(vis, z, torch.ones_like(z))
    u = fx * pc[:, 0] / zs + cx
    v = fy * pc[:, 1] / zs + cy
    r_px = T(size_m) * fx / zs
    vis &= (u > -10) & (u < W + 10) & (v > -10) & (v < H + 10)
    vis &= r_px > 0.6
    img = torch.full((H, W), bg, dtype=torch.float32, device=device)
    idx = torch.nonzero(vis)[:, 0]
    if len(idx):
        ui, vi, ri = u[idx], v[idx], r_px[idx]
        s = torch.clamp(ri, min=0.8).to(torch.float32)
        rr = torch.clamp((3 * ri).to(torch.int32), 2, RR)
        off = torch.arange(-RR, RR + 1, device=device, dtype=torch.int32)
        gx = torch.round(ui).to(torch.int32)[:, None] + off[None]
        gy = torch.round(vi).to(torch.int32)[:, None] + off[None]
        dx = gx.to(f64) - ui[:, None]
        dy = gy.to(f64) - vi[:, None]
        inv2s2 = (1.0 / (2.0 * s * s))[:, None].to(f64)
        ex = torch.exp(-(dx * dx) * inv2s2).to(torch.float32)
        ey = torch.exp(-(dy * dy) * inv2s2).to(torch.float32)
        in_rr = off.abs()[None] <= rr[:, None]
        ex = torch.where(in_rr & (gx >= 0) & (gx < W), ex, torch.zeros_like(ex))
        ey = torch.where(in_rr & (gy >= 0) & (gy < H), ey, torch.zeros_like(ey))
        blob = (T(contrast)[idx][:, None, None] * ey[:, :, None].to(f64)
                * ex[:, None, :].to(f64)).to(torch.float32)
        flat = (torch.clamp(gy, 0, H - 1)[:, :, None].to(torch.int64) * W
                + torch.clamp(gx, 0, W - 1)[:, None, :].to(torch.int64)).reshape(-1)
        acc = torch.zeros(H * W, dtype=f64, device=device)
        acc.index_add_(0, flat, blob.reshape(-1).to(f64))
        img += acc.reshape(H, W).to(torch.float32)
    img = torch.clamp(img, 0.0, 255.0)
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def render_pairs(world: World, contrast, size_m, q_wc, t_wc, p: dict, device) -> list:
    """[(left, right)] uint8 numpy pairs along the poses."""
    pairs = []
    for q, t in zip(q_wc, t_wc):
        lr = [render(world, contrast, size_m, q, t, p, right, device) for right in (False, True)]
        pairs.append(tuple(im.cpu().numpy() for im in lr))
    return pairs
