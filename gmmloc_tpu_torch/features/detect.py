"""ORB detection over the image pyramid.

PyTorch port of `gmmloc_tpu/features/detect.py` (ref ORBextractor::detect,
orb_extractor.cpp:988-1054): pyramid -> FAST + NMS over the stacked level
atlas -> per-level cell distribution -> IC-angle -> steered BRIEF on the
blurred levels; keypoints scaled back to level-0 coordinates. The
per-level quotas follow the reference's geometric split (:418-434):
n_l ~ (1/1.2)^l, remainder to the coarsest level.

FAST + NMS is kernel K4 (`fast_kernels.fast_score_nms`): one launch per
atlas, and for a stereo pair one launch over both images' atlases
stacked (2 x 2210 = 4420 rows at 752x480).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import fast, fast_kernels, orb, pyramid
from ..utils.device import resolve


class Detections(NamedTuple):
    uv: torch.Tensor       # (N,2) level-0 pixel coords
    octave: torch.Tensor   # (N,) int64
    angle: torch.Tensor    # (N,) degrees
    response: torch.Tensor  # (N,)
    desc: torch.Tensor     # (N,32) uint8
    valid: torch.Tensor    # (N,) bool


def level_quotas(num_features: int, num_levels: int, scale: float):
    inv = 1.0 / scale
    factor = num_features * (1 - inv) / (1 - inv**num_levels)
    quotas = [int(round(factor * inv**l)) for l in range(num_levels - 1)]
    quotas.append(max(0, num_features - sum(quotas)))
    return quotas


class ORBDetector:
    """Detection for one image geometry on one device."""

    def __init__(self, height: int, width: int, num_features: int = 1200,
                 num_levels: int = 8, scale: float = 1.2, cell: int = 24,
                 distribution: str = "quota", device="cuda"):
        if distribution not in ("quota", "octree"):
            raise ValueError(f"unknown keypoint distribution {distribution!r}")
        self.device = resolve(device)
        self.shapes = tuple(pyramid.level_shapes(height, width, num_levels, scale))
        self.quotas = level_quotas(num_features, num_levels, scale)
        self.num_levels = num_levels
        self.scale_factors = scale ** np.arange(num_levels)
        self.cell = cell
        self.distribution = distribution
        self.resize_weights = pyramid.resize_weights(self.shapes, self.device)
        heights = [s[0] for s in self.shapes]
        self.widths = [s[1] for s in self.shapes]
        self.heights = heights
        self.offsets = [0] + list(np.cumsum(heights[:-1]))
        self.atlas_height = int(sum(heights))
        t = lambda v, dt: torch.tensor(v, dtype=dt, device=self.device)
        self._offs = t(self.offsets, torch.int64)
        self._heights = t(heights, torch.int64)
        self._widths = t(self.widths, torch.int64)
        self._sf = t(self.scale_factors, torch.float32)

    def build_pyramid(self, img):
        return pyramid.build_pyramid(img, self.shapes, self.resize_weights)

    def _build_atlases(self, levels):
        """The raw and the per-level-blurred pyramid stacked into atlases
        (each level blurred before stacking, so the blur cannot bleed
        across level boundaries)."""
        W0 = self.widths[0]
        raw = levels[0].new_zeros(self.atlas_height, W0)
        blur = levels[0].new_zeros(self.atlas_height, W0)
        for l, im in enumerate(levels):
            y0 = self.offsets[l]
            h, w = im.shape
            raw[y0:y0 + h, :w] = im
            blur[y0:y0 + h, :w] = pyramid.gaussian_blur7(im)
        return raw, blur

    def _score_atlas(self, atlas_raw):
        """One FAST + NMS over the whole stacked atlas: K4 on a CUDA
        tensor, its plain version on a CPU one. Exact at every selectable
        pixel: candidates are >= 16 px inside their level band, and their
        scores and NMS neighbours read ring pixels >= 12 px inside it."""
        return fast_kernels.fast_score_nms(atlas_raw.contiguous())

    def _select_levels(self, score_atlas, base_off: int):
        """Per-level keypoint selection from the atlas bands."""
        uvs, octs, resps, valids = [], [], [], []
        for l in range(self.num_levels):
            y0 = base_off + self.offsets[l]
            band = score_atlas[y0:y0 + self.heights[l], :self.widths[l]]
            if self.distribution == "octree":
                uv, resp, valid = fast.select_keypoints_octree(
                    band, quota=self.quotas[l], edge=16)
            else:
                uv, resp, valid = fast.select_keypoints(
                    band, cell=self.cell, quota=self.quotas[l], edge=16)
            uvs.append(uv)
            octs.append(torch.full((uv.shape[0],), l, dtype=torch.int64, device=uv.device))
            resps.append(resp)
            valids.append(valid)
        return torch.cat(uvs), torch.cat(octs), torch.cat(resps), torch.cat(valids)

    def _angle_desc(self, atlas_raw, atlas_blur, uv, octave, extra_off=0):
        """Orientation + descriptors as one atlas gather across levels."""
        y_off = self._offs[octave] + extra_off
        h_v, w_v = self._heights[octave], self._widths[octave]
        ang = orb.ic_angle_atlas(atlas_raw, uv, y_off, h_v, w_v)
        desc = orb.brief_descriptors_atlas(atlas_blur, uv, ang, y_off, h_v, w_v)
        return ang, desc

    def detect_from_levels(self, levels) -> Detections:
        """Detection given a built pyramid (shared with stereo refinement)."""
        raw, blur = self._build_atlases(levels)
        score = self._score_atlas(raw)
        uv, octave, resp, valid = self._select_levels(score, 0)
        ang, desc = self._angle_desc(raw, blur, uv, octave)
        return Detections(uv=uv * self._sf[octave][:, None], octave=octave, angle=ang,
                          response=resp, desc=desc, valid=valid)

    def stacked_atlases(self, levels_l, levels_r):
        """The raw and the blurred atlases of both stereo images, stacked
        vertically: (2 * atlas_height, W) each."""
        raw_l, blur_l = self._build_atlases(levels_l)
        raw_r, blur_r = self._build_atlases(levels_r)
        return torch.cat([raw_l, raw_r]), torch.cat([blur_l, blur_r])

    def detect_pair_from_levels(self, levels_l, levels_r):
        """Both stereo images with one FAST + NMS launch and one
        orientation/descriptor pass: the two atlases stack vertically
        (each level band keeps its own border exclusion, so stacking adds
        no interaction)."""
        H = self.atlas_height
        raw, blur = self.stacked_atlases(levels_l, levels_r)
        score = self._score_atlas(raw)
        uv_l, oct_l, resp_l, val_l = self._select_levels(score, 0)
        uv_r, oct_r, resp_r, val_r = self._select_levels(score, H)
        n_l = uv_l.shape[0]
        uv = torch.cat([uv_l, uv_r])
        octave = torch.cat([oct_l, oct_r])
        extra = torch.cat([torch.zeros_like(oct_l), torch.full_like(oct_r, H)])
        ang, desc = self._angle_desc(raw, blur, uv, octave, extra)
        uv0 = uv * self._sf[octave][:, None]
        resp = torch.cat([resp_l, resp_r])
        valid = torch.cat([val_l, val_r])

        def mk(sl):
            return Detections(uv=uv0[sl], octave=octave[sl], angle=ang[sl],
                              response=resp[sl], desc=desc[sl], valid=valid[sl])

        return mk(slice(0, n_l)), mk(slice(n_l, None))

    def __call__(self, img) -> Detections:
        """img: (H,W) float32 in [0,255] on the detector's device."""
        return self.detect_from_levels(self.build_pyramid(img))
