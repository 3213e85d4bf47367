"""Relocalization and loop-closure scenarios on synthetic feature frames.

The scenario functions take any system with the `GMMLocSystem` interface (`step`,
`flush`, `lost`, `n_lost`, `recovery_frames`, `world`, `track_failed`)
and any synthetic front end with `make_frame` and a settable `drop_frac`,
so one function runs the port and, in the tests, the JAX package on the
same frames. Everything they compute is numpy.

  - `blackout`: frames `start .. start + n - 1` of the trajectory; the
    frames whose index is in `dark` are made with every detection
    dropped (`drop_frac=1.0`), so tracking fails, the system goes LOST
    and has to relocalize when detections come back.
  - `kidnap`: map `mapped` frames from `start`, then `black` dark frames
    while the camera is carried back to frame `start + back`, then
    `after` frames from there: the system must relocalize into the map
    it built.
  - a lap for loop closure is `blackout_frames` with no dark frame (the
    room fixture's ellipse closes after about 380 frames at 20 Hz).

Each returns the frames in step order with their trajectory index, and
`summary` reads what the run did: the frames that were not tracked, the
recovery frames, the lost count and the camera-centre errors.

`revisit_scenario` builds the world of the JAX package's
`tests/test_loop_closing.py` in the port: a place seen by keyframe 0 and
revisited by keyframe 4 with accumulated drift, its landmarks duplicated
as drifted map points, three keyframes elsewhere in between.
"""

from __future__ import annotations

import time

import numpy as np


def _make(fe, idx, stamp, fi, q_wc, t_wc, dark: bool):
    saved = fe.drop_frac
    if dark:
        fe.drop_frac = 1.0
    f = fe.make_frame(idx, stamp, q_wc[fi], t_wc[fi])
    fe.drop_frac = saved
    return f


def blackout_frames(fe, ts, q_wc, t_wc, start: int, n: int, dark):
    """[(trajectory index, Frame)] of the blackout scenario."""
    return [(start + i, _make(fe, i, ts[start + i], start + i, q_wc, t_wc, i in dark))
            for i in range(n)]


def kidnap_frames(fe, ts, q_wc, t_wc, start: int, mapped: int, black: int,
                  back: int, after: int):
    """[(trajectory index, Frame)] of the kidnap scenario. Timestamps go on
    at the camera rate through the jump, so every step has its own."""
    fis = ([start + i for i in range(mapped)] + [start + back] * black
           + [start + back + j for j in range(after)])
    dt = ts[1] - ts[0]
    return [(fi, _make(fe, k, ts[start] + k * dt, fi, q_wc, t_wc,
                       mapped <= k < mapped + black))
            for k, fi in enumerate(fis)]


def drive(system, frames, q_wc, t_wc) -> dict:
    """Step every frame (then flush); raises on a fatal tracking failure.
    Returns the host seconds of each step call."""
    step_s = []
    for k, (fi, f) in enumerate(frames):
        t0 = time.perf_counter()
        system.step(f, q_wc[fi], t_wc[fi])
        step_s.append(time.perf_counter() - t0)
        if system.track_failed:
            raise RuntimeError(f"fatal tracking failure at step {k}")
    t0 = time.perf_counter()
    system.flush()
    step_s[-1] += time.perf_counter() - t0
    if system.track_failed:
        raise RuntimeError("fatal tracking failure at the flush")
    return dict(step_s=np.array(step_s))


def _center(q, t):
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return -R.T @ t


def summary(system, frames, t_wc) -> dict:
    """What the run did. `untracked`: the step indices of frames with no
    trajectory record (lost, or dropped while the pipeline re-primed);
    `recovery_frames`: the frame indices relocalization re-anchored;
    `errors_tracked`: camera-centre error (m) of every tracked frame;
    `errors`: those after the first recovery (all when there was none);
    `recovered_poses`: {frame index: (q_cw, t_cw)} of the recovery frames."""
    recorded = {info.timestamp for info in system.world.frame_infos}
    tracked = [f.timestamp in recorded for _, f in frames]
    rec = [int(r) for r in system.recovery_frames]
    first = rec[0] if rec else -1
    errs = np.array([float(np.linalg.norm(_center(f.q_cw, f.t_cw) - t_wc[fi]))
                     if ok else np.nan for (fi, f), ok in zip(frames, tracked)])
    after = np.array([ok and f.idx > first for (_, f), ok in zip(frames, tracked)], bool)
    by_idx = {f.idx: f for _, f in frames}
    return dict(
        untracked=[k for k, ok in enumerate(tracked) if not ok],
        recovery_frames=rec, n_lost=int(system.n_lost), lost=bool(system.lost),
        errors=errs[after], errors_tracked=errs[np.array(tracked, bool)],
        recovered_poses={r: (by_idx[r].q_cw.copy(), by_idx[r].t_cw.copy()) for r in rec})


REVISIT_FEATURES = 48


def revisit_frame(make_frame, idx, n=64, seed=0):
    """The JAX package's tests/test_world_model.py make_test_frame, built
    with the given package's `make_frame`."""
    rng = np.random.default_rng(seed + idx)
    uv = rng.uniform([0, 0], [752, 480], (n, 2))
    return make_frame(idx, idx * 0.05, uv, uv[:, 0] - 8.0, np.full(n, 6.0),
                      rng.integers(0, 8, n), rng.uniform(0, 360, n),
                      rng.integers(0, 256, (n, 32), dtype=np.uint8), 64)


def revisit_scenario(cfg, device, seed: int = 42, drift=(0.3, 0.1, 0.0)):
    """The loop-closing world in the port on `device` (cfg: caps of at
    least 5 keyframes and 240 points, feat_cap 64). Returns (world,
    database, loop closer, keyframe of the revisit, keyframe of the first
    visit). The seeded draws come in the JAX test's order."""
    from ..mapping import map_state as ms
    from ..mapping.loop_closing import LoopCloser
    from ..tracking.frame import make_frame
    from ..vocab.bow import KeyFrameDatabase, Vocabulary

    n = REVISIT_FEATURES
    rng = np.random.default_rng(seed)
    w = ms.MapState(cfg)
    voc = Vocabulary.train(rng.integers(0, 256, (1500, 32), dtype=np.uint8), k=8,
                           depth=3, device=device)
    db = KeyFrameDatabase(voc)
    place_desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    lm_pos = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                       np.full(n, 5.0)], -1)

    def add_kf(frame_idx, t_cw, desc, off=np.zeros(3)):
        f = revisit_frame(make_frame, frame_idx)
        f.desc[:n] = desc
        f.set_pose(np.array([1.0, 0, 0, 0]), np.asarray(t_cw))
        kf = w.alloc_keyframe(f)
        for i in range(n):
            p = w.alloc_point(lm_pos[i] + off, kf, frame_idx)
            w.add_observation(p, kf, i)
        db.add(kf, w.kf_feat_desc[kf], w.kf_feat_valid[kf])
        return kf

    kf0 = add_kf(0, [0.0, 0, 0], place_desc)
    for i in range(1, 4):
        add_kf(i * 40, [i * 0.5, 0, 0], rng.integers(0, 256, (n, 32), dtype=np.uint8))
    drift = np.asarray(drift)
    kf_re = add_kf(200, drift, place_desc, off=drift)
    lc = LoopCloser(cfg, w, db, min_score=0.01, min_inliers=15, device=device)
    return w, db, lc, kf_re, kf0
