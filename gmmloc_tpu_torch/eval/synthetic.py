"""Synthetic stereo feature sequences for end-to-end runs.

Port of `gmmloc_tpu/eval/synthetic.py` (the feature-level tier): per-frame
feature arrays rendered along a ground-truth trajectory against landmarks
sampled from a prior GMM map -- projected landmarks with temporally
correlated noise, descriptor bit flips, dropout and spurious detections.
The code is the reference harness's, numpy only; the port carries this
copy (and its own `Frame` container and map parser), held frame-for-frame
equal to the original by tests/test_torch_system.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import SystemConfig
from ..geometry import camera as cam_mod
from ..mapping.map_state import _quat_to_mat
from ..tracking.frame import Frame, make_frame
from ..utils import proto


def load_gt_trajectory(path: str):
    """gt_sync format: t x y z qx qy qz qw, T_w_c per frame
    (ref: dataloader.cpp:118-138)."""
    data = np.loadtxt(path)
    ts = data[:, 0]
    t_wc = data[:, 1:4]
    q_wc = data[:, [7, 4, 5, 6]]  # -> (w,x,y,z)
    q_wc /= np.linalg.norm(q_wc, axis=-1, keepdims=True)
    return ts, q_wc, t_wc


@dataclass
class SyntheticWorld:
    landmarks: np.ndarray      # (N,3)
    desc: np.ndarray           # (N,32) uint8
    base_angle: np.ndarray     # (N,) degrees
    ref_dist: np.ndarray       # (N,) scale-reference distance A_l
    comp_id: np.ndarray        # (N,) source GMM component (or -1)
    response: np.ndarray       # (N,) persistent corner strength — per-frame
    # selection ranks by response so the detected set is stable across
    # frames (real detectors re-find the same strong corners), with churn
    # entering only through per-frame response jitter + dropout.


def sample_world_from_gmm(
    means: np.ndarray,
    covs: np.ndarray,
    n_landmarks: int = 12000,
    seed: int = 0,
    flatten_degenerate: bool = True,
) -> SyntheticWorld:
    """Sample landmarks from GMM components (planar comps -> on-plane)."""
    rng = np.random.default_rng(seed)
    K = len(means)
    per = np.full(K, n_landmarks // K)
    per[: n_landmarks - per.sum()] += 1
    pts, comp_ids = [], []
    evals, evecs = np.linalg.eigh(covs)
    for k in range(K):
        n = per[k]
        if n == 0:
            continue
        w = evals[k].copy()
        if flatten_degenerate and w[0] < 1e-4:
            w[0] = 0.0  # exact on-plane samples for degenerate comps
        z = rng.standard_normal((n, 3)) * np.sqrt(np.clip(w, 0, None))
        pts.append(means[k] + z @ evecs[k].T)
        comp_ids.append(np.full(n, k))
    pts = np.concatenate(pts)
    comp_ids = np.concatenate(comp_ids)
    N = len(pts)
    return SyntheticWorld(
        landmarks=pts,
        desc=rng.integers(0, 256, size=(N, 32), dtype=np.uint8),
        base_angle=rng.uniform(0, 360, N).astype(np.float32),
        ref_dist=rng.uniform(1.5, 12.0, N),
        comp_id=comp_ids.astype(np.int32),
        response=rng.uniform(0.0, 1.0, N).astype(np.float32),
    )


class SyntheticFrontend:
    """Feature-level frontend: GT pose -> Frame with noisy observations."""

    def __init__(
        self,
        world: SyntheticWorld,
        cfg: SystemConfig,
        pixel_noise: float = 0.3,
        disp_noise: float = 0.25,
        desc_flip_bits: int = 8,
        stereo_frac: float = 0.9,
        spurious_frac: float = 0.08,
        drop_frac: float = 0.05,
        seed: int = 1,
    ):
        self.world = world
        self.cfg = cfg
        self.cam = cam_mod.CameraParams.from_config(cfg.camera)
        self.pixel_noise = pixel_noise
        self.disp_noise = disp_noise
        self.desc_flip_bits = desc_flip_bits
        self.stereo_frac = stereo_frac
        self.spurious_frac = spurious_frac
        self.drop_frac = drop_frac
        self.rng = np.random.default_rng(seed)
        self.log_sf = np.log(cfg.frame.scale_factor)
        self.num_levels = cfg.frame.num_levels
        self.last_landmark_ids: Optional[np.ndarray] = None
        # Temporally-correlated observation noise: a static camera sees the
        # SAME image, so detections repeat almost exactly (iid per-frame
        # noise would inject drift energy a real sensor never produces).
        # Per-landmark AR(1) noise states, refreshed in proportion to the
        # actual camera motion between frames.
        N = len(world.landmarks)
        self._noise_uv = self.rng.standard_normal((N, 2))
        self._noise_disp = self.rng.standard_normal(N)
        self._noise_det = self.rng.standard_normal(N)
        self._prev_q: Optional[np.ndarray] = None
        self._prev_t: Optional[np.ndarray] = None

    def _advance_noise(self, q_wc, t_wc):
        if self._prev_t is not None:
            dt = np.linalg.norm(t_wc - self._prev_t)
            dq = abs(float(np.dot(q_wc, self._prev_q)))
            dang = 2.0 * np.arccos(min(1.0, dq))
            rho = float(np.exp(-(dt / 0.01 + dang / 0.005)))
        else:
            rho = 0.0
        self._prev_q, self._prev_t = q_wc.copy(), t_wc.copy()
        N = len(self.world.landmarks)
        fresh_uv = self.rng.standard_normal((N, 2))
        fresh_d = self.rng.standard_normal(N)
        c = np.sqrt(max(0.0, 1.0 - rho * rho))
        self._noise_uv = rho * self._noise_uv + c * fresh_uv
        self._noise_disp = rho * self._noise_disp + c * fresh_d
        self._noise_det = rho * self._noise_det + c * self.rng.standard_normal(N)

    def make_frame(self, idx: int, timestamp: float, q_wc, t_wc) -> Frame:
        cam = self.cam
        w = self.world
        self._advance_noise(np.asarray(q_wc), np.asarray(t_wc))
        R_wc = _quat_to_mat(q_wc)
        R_cw = R_wc.T
        t_cw = -R_cw @ t_wc

        pc = w.landmarks @ R_cw.T + t_cw
        z = pc[:, 2]
        vis = z > 0.3
        u = np.where(vis, cam.fx * pc[:, 0] / np.where(vis, z, 1.0) + cam.cx, -1)
        v = np.where(vis, cam.fy * pc[:, 1] / np.where(vis, z, 1.0) + cam.cy, -1)
        margin = 8.0
        vis &= (u >= margin) & (v >= margin) & (u < cam.width - margin) & (v < cam.height - margin)
        vis &= z < 45.0
        ids = np.where(vis)[0]

        # detection dropout + budget: rank by persistent response with small
        # per-frame jitter, so the detected set is stable across frames
        from scipy.stats import norm as _norm
        keep = _norm.cdf(self._noise_det[ids]) > self.drop_frac
        ids = ids[keep]
        n_budget = self.cfg.frame.num_features
        n_spur = int(n_budget * self.spurious_frac)
        if len(ids) > n_budget - n_spur:
            score = w.response[ids] + 0.02 * self._noise_det[ids]
            ids = ids[np.argsort(-score)[: n_budget - n_spur]]
        n = len(ids)

        dist = np.linalg.norm(w.landmarks[ids] - t_wc, axis=-1)
        octave = np.clip(
            np.round(np.log(w.ref_dist[ids] / np.clip(dist, 0.1, None)) / self.log_sf),
            0,
            self.num_levels - 1,
        ).astype(np.int32)

        sf = self.cfg.frame.scale_factors()[octave]
        uu = u[ids] + self._noise_uv[ids, 0] * self.pixel_noise * sf
        vv = v[ids] + self._noise_uv[ids, 1] * self.pixel_noise * sf

        # stereo: disparity with noise; a fraction fails stereo matching
        disp = cam.bf / z[ids] + self._noise_disp[ids] * self.disp_noise * sf
        has_st = (self.rng.random(n) < self.stereo_frac) & (disp > 0.3)
        ur = np.where(has_st, uu - disp, -1.0).astype(np.float32)
        depth = np.where(has_st, cam.bf / np.clip(disp, 0.3, None), -1.0).astype(np.float32)

        # descriptors: landmark signature + per-observation bit flips
        desc = w.desc[ids].copy()
        flips = self.rng.integers(0, 256, size=(n, self.desc_flip_bits))
        for b in range(self.desc_flip_bits):
            byte, bit = flips[:, b] >> 3, flips[:, b] & 7
            desc[np.arange(n), byte] ^= (1 << bit).astype(np.uint8)

        # orientation: base angle minus camera yaw (deterministic, smooth)
        yaw = np.degrees(np.arctan2(R_cw[0, 1], R_cw[0, 0]))
        angle = (w.base_angle[ids] - yaw) % 360.0

        # spurious detections
        su = self.rng.uniform(margin, cam.width - margin, n_spur)
        sv = self.rng.uniform(margin, cam.height - margin, n_spur)
        sdesc = self.rng.integers(0, 256, (n_spur, 32), dtype=np.uint8)

        uv = np.concatenate([np.stack([uu, vv], -1), np.stack([su, sv], -1)])
        ur_all = np.concatenate([ur, np.full(n_spur, -1.0, np.float32)])
        depth_all = np.concatenate([depth, np.full(n_spur, -1.0, np.float32)])
        oct_all = np.concatenate([octave, self.rng.integers(0, 3, n_spur)])
        ang_all = np.concatenate([angle, self.rng.uniform(0, 360, n_spur)])
        desc_all = np.concatenate([desc, sdesc])

        frame = make_frame(
            idx, timestamp, uv, ur_all, depth_all, oct_all, ang_all, desc_all,
            self.cfg.frame.feat_cap,
        )
        lm = np.full(frame.feat_cap, -1, np.int64)
        lm[:n] = ids
        self.last_landmark_ids = lm
        return frame


def make_sequence(
    cfg: SystemConfig,
    gt_path: str,
    gmm_path: str,
    n_frames: Optional[int] = None,
    stride: int = 1,
    n_landmarks: int = 12000,
    seed: int = 0,
    **frontend_kw,
):
    """Build (frontend, timestamps, q_wc, t_wc) for a synthetic run."""
    means, covs, _, _ = proto.load_gmm_file(gmm_path)
    world = sample_world_from_gmm(means, covs, n_landmarks=n_landmarks, seed=seed)
    ts, q_wc, t_wc = load_gt_trajectory(gt_path)
    sl = slice(0, None if n_frames is None else n_frames * stride, stride)
    fe = SyntheticFrontend(world, cfg, seed=seed + 1, **frontend_kw)
    return fe, ts[sl], q_wc[sl], t_wc[sl]
