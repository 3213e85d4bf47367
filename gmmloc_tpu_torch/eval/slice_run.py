"""The port's main path as a run: configuration, seeded inputs, the loop.

The slice configuration is `euroc_v1_config()` on the offline protocol
with the velocity damping of the reference's end-to-end tests, pipeline
depth 1, the unpacked fused track step and host-assembled mapping
(`use_device_world=False`). Inputs are the seeded room fixture
(`room_fixture`) and the synthetic feature frontend (`synthetic`).
Used by `chip_smoke.py`, `tools/torch_profile.py` and the tests.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..config import SystemConfig, euroc_v1_config
from ..gmm import mixture
from . import room_fixture, synthetic


def slice_config(feat_cap: int | None = None, num_features: int | None = None,
                 local_map_cap: int | None = None) -> SystemConfig:
    """The slice configuration; the optional arguments cut widths for
    small CPU runs."""
    cfg = euroc_v1_config()
    tk = dict(velocity_damping=0.9, pipeline_depth=1, fused_packed_io=False)
    if local_map_cap is not None:
        tk["fused_local_map_cap"] = local_map_cap
    fr = {}
    if feat_cap is not None:
        fr["feat_cap"] = feat_cap
    if num_features is not None:
        fr["num_features"] = num_features
    return cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, **tk),
        loc=dataclasses.replace(cfg.loc, use_device_world=False),
        frame=dataclasses.replace(cfg.frame, **fr),
        online=False,
    )


def make_inputs(cfg: SystemConfig, device, out_dir: str, n_frames: int,
                n_components: int = 3300, n_landmarks: int = 30000, seed: int = 0):
    """Write the room fixture under out_dir, load the map on `device` and
    generate every frame up front (the harness stays off the clock).
    Returns (gmap, frames, q_wc, t_wc)."""
    gmm_path, gt_path = room_fixture.write_room_fixture(
        out_dir, n_components=n_components, n_frames=n_frames + 50, seed=seed)
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, gt_path=gt_path, gmm_path=gmm_path, n_landmarks=n_landmarks,
        seed=seed, disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1)
    gmap = mixture.load(gmm_path, device,
                        pad_to=cfg.caps.gmm_components_pad,
                        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
                        neighbor_cap=cfg.gmm.neighbor_cap)
    frames = [fe.make_frame(i, ts[i], q_wc[i], t_wc[i]) for i in range(n_frames)]
    return gmap, frames, q_wc[:n_frames], t_wc[:n_frames]


def default_fixture_dir() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "build", "gmmloc_tpu_torch", "fixture")


def run(system, frames, q_wc, t_wc, device) -> dict:
    """Step every frame through `system` (then flush). Returns `step_s`,
    the host wall time of each step call in seconds, and `n_anchors`, the
    GMM anchors that survived the pose solve of each frame the tracker
    completed. Raises on a tracking failure. On a CUDA device the clock
    stops after a synchronize."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    step_s, n_anchors = [], []
    dbg = system.tracker.dbg

    def record_completed():
        # the tracker replaces its debug dict once per completed frame
        nonlocal dbg
        if system.tracker.dbg is not dbg:
            dbg = system.tracker.dbg
            n_anchors.append(dbg.get("n_anchors", 0))

    sync()
    for i, f in enumerate(frames):
        t1 = time.perf_counter()
        st = system.step(f, q_wc[i], t_wc[i])
        step_s.append(time.perf_counter() - t1)
        if system.track_failed or (st is not None and not st.res):
            raise RuntimeError(f"tracking failed at frame {i}")
        record_completed()
    t1 = time.perf_counter()
    system.flush()
    sync()
    step_s[-1] += time.perf_counter() - t1
    if system.track_failed:
        raise RuntimeError("tracking failed at the final frame")
    record_completed()
    return dict(step_s=np.array(step_s), n_anchors=np.array(n_anchors))


def timing_table(reset: bool = True) -> str:
    """The host timer registry's table (per-stage wall times: track/*,
    kf/*, loc/*), optionally cleared."""
    from gmmloc_tpu.utils import timing

    s = timing.print_table()
    if reset:
        timing.reset()
    return s


def pose_errors(frames, t_wc) -> np.ndarray:
    """Per-frame camera-centre error (m) of the tracked poses."""
    from ..geometry import se3

    q = torch.tensor(np.stack([f.q_cw for f in frames]), dtype=torch.float64)
    t = torch.tensor(np.stack([f.t_cw for f in frames]), dtype=torch.float64)
    return np.linalg.norm(se3.inverse(q, t)[1].numpy() - t_wc[: len(frames)], axis=1)
