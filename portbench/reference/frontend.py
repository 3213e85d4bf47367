"""The ORB front end of one rectified uint8 stereo pair, plain: the
pyramid, FAST + NMS over the stacked atlases, per-level selection,
orientation, steered BRIEF and the stereo matching with its subpixel
refinement, on the CPU in float32.

`store` (a dtype) rounds every pyramid level and blurred level to it
before use: the lower-precision control of the check.
"""

from __future__ import annotations

import numpy as np
import torch

from . import detect, stereo


class _Detector(detect.ORBDetector):
    store = None

    def _round(self, x):
        return x if self.store is None else x.to(self.store).to(x.dtype)

    def build_pyramid(self, img):
        return [self._round(l) for l in super().build_pyramid(img)]

    def _build_atlases(self, levels):
        raw, blur = super()._build_atlases(levels)
        return raw, self._round(blur)


def features(left, right, cam: dict, store=None):
    """(table (N, 8) float32: u, v, u_right, depth, octave, angle, valid,
    response; desc (N, 32) uint8) of the left image."""
    det = _Detector(cam["height"], cam["width"], num_features=cam["num_features"],
                    num_levels=cam["num_levels"], scale=cam["scale_factor"],
                    distribution=cam["detect_distribution"], device="cpu")
    det.store = store
    up = lambda im: torch.as_tensor(np.asarray(im, np.uint8)).to(torch.float32)  # noqa: E731
    pyr_l, pyr_r = det.build_pyramid(up(left)), det.build_pyramid(up(right))
    det_l, det_r = det.detect_pair_from_levels(pyr_l, pyr_r)
    sf = torch.tensor(cam["scale_factor"] ** np.arange(cam["num_levels"]), dtype=torch.float32)
    u_right, depth = stereo.compute_stereo_matches(
        pyr_l, pyr_r, det_l.uv, det_l.octave, det_l.desc, det_l.valid,
        det_r.uv, det_r.octave, det_r.desc, det_r.valid, sf,
        bf=cam["bf"], baseline=cam["bf"] / cam["fx"])
    table = torch.cat([
        det_l.uv, u_right[:, None], depth[:, None],
        det_l.octave.to(torch.float32)[:, None], det_l.angle[:, None],
        det_l.valid.to(torch.float32)[:, None], det_l.response[:, None]], dim=1)
    return table.numpy(), det_l.desc.numpy()
