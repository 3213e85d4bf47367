"""Image-level synthetic rendering: sprite worlds for the ORB front-end.

The port's copy of `gmmloc_tpu/eval/image_synthetic.py` (numpy only, off
the clock); it uses the port's own camera and map-state modules.

Renders stereo image pairs of a landmark sprite world along GT
trajectories so the FULL pipeline (pyramid/FAST/BRIEF/stereo matching ->
tracking -> mapping) can be exercised end-to-end without the EuRoC image
assets. Landmarks are drawn as Gaussian intensity blobs with per-landmark
contrast/size (stable appearance -> repeatable detections + descriptors).
"""

from __future__ import annotations

import numpy as np

from ..config import SystemConfig
from ..geometry import camera as cam_mod
from ..mapping.map_state import _quat_to_mat
from .synthetic import SyntheticWorld


class SpriteRenderer:
    def __init__(self, world: SyntheticWorld, cfg: SystemConfig, seed: int = 0,
                 bg: float = 40.0):
        self.world = world
        self.cfg = cfg
        self.cam = cam_mod.CameraParams.from_config(cfg.camera)
        rng = np.random.default_rng(seed)
        n = len(world.landmarks)
        sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
        self.contrast = rng.uniform(60, 170, n) * sign
        self.size_m = rng.uniform(0.010, 0.03, n)  # physical sprite radius
        self.bg = bg

    def render(self, q_wc, t_wc, right: bool = False) -> np.ndarray:
        cam = self.cam
        R_cw = _quat_to_mat(q_wc).T
        t_cw = -R_cw @ np.asarray(t_wc)
        if right:
            # right camera displaced by +baseline along camera x
            t_cw = t_cw - np.array([cam.bf / cam.fx, 0.0, 0.0])
        pc = self.world.landmarks @ R_cw.T + t_cw
        z = pc[:, 2]
        vis = z > 0.3
        zs = np.where(vis, z, 1.0)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v = cam.fy * pc[:, 1] / zs + cam.cy
        # projected sprite radius in px
        r_px = self.size_m * cam.fx / zs
        vis &= (u > -10) & (u < cam.width + 10) & (v > -10) & (v < cam.height + 10)
        vis &= r_px > 0.6

        img = np.full((cam.height, cam.width), self.bg, np.float32)
        # additive gaussian splatting, fully vectorized: one bincount
        # scatter-add over fixed-size patches (the original per-sprite
        # python loop was ~100x slower and capped the image-level
        # benchmark at ~25-frame smokes; additive blending makes paint
        # order irrelevant). Patch radius caps at RR px — for the sprite
        # sizes in use the truncated tail is <3% of peak amplitude.
        RR = 24
        idx = np.where(vis)[0]
        if len(idx) == 0:
            return img
        ui, vi, zi = u[idx], v[idx], z[idx]
        s = np.maximum(r_px[idx], 0.8).astype(np.float32)
        rr = np.clip((3 * r_px[idx]).astype(np.int32), 2, RR)
        off = np.arange(-RR, RR + 1)
        # (N, 2RR+1) per-axis offsets around the rounded center
        cx = np.round(ui).astype(np.int32)
        cy = np.round(vi).astype(np.int32)
        gx = cx[:, None] + off[None, :]
        gy = cy[:, None] + off[None, :]
        dx = gx - ui[:, None]
        dy = gy - vi[:, None]
        # separable gaussian: blob = contrast * gx_term ⊗ gy_term
        inv2s2 = 1.0 / (2.0 * s * s)
        ex = np.exp(-(dx * dx) * inv2s2[:, None]).astype(np.float32)
        ey = np.exp(-(dy * dy) * inv2s2[:, None]).astype(np.float32)
        in_rr = np.abs(off)[None, :] <= rr[:, None]
        ex = np.where(in_rr & (gx >= 0) & (gx < cam.width), ex, 0.0)
        ey = np.where(in_rr & (gy >= 0) & (gy < cam.height), ey, 0.0)
        blob = (
            self.contrast[idx][:, None, None] * ey[:, :, None] * ex[:, None, :]
        ).astype(np.float32)
        gxc = np.clip(gx, 0, cam.width - 1)
        gyc = np.clip(gy, 0, cam.height - 1)
        flat = (
            gyc[:, :, None] * cam.width + gxc[:, None, :]
        ).astype(np.int64).ravel()
        img += np.bincount(
            flat, weights=blob.ravel(), minlength=cam.height * cam.width
        ).reshape(cam.height, cam.width).astype(np.float32)
        return np.clip(img, 0.0, 255.0)

    def render_stereo(self, q_wc, t_wc):
        return self.render(q_wc, t_wc, False), self.render(q_wc, t_wc, True)
