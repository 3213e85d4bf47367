"""Stereo rectification: precomputed remap grids + bilinear gather.

PyTorch port of `gmmloc_tpu/pipeline/rectify.py` (ref cv_utils::Rectify,
cv_utils.cpp:9-54, config gmmloc_ros/cfg/euroc_rect.yaml): the
undistort+rectify maps are computed once on the host in numpy (radtan
model), and each frame is a bilinear gather on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve


def compute_rectify_map(K, D, R, P, width: int, height: int):
    """Per-pixel source coordinates for undistort+rectify (the math of
    cv::initUndistortRectifyMap): x_n = P^-1 [u v 1], rotated back by
    R^-1, radtan-distorted, projected through K. Returns map_x, map_y
    float32 (H, W)."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    D = np.asarray(D, np.float64).ravel()
    R = np.asarray(R, np.float64).reshape(3, 3)
    P = np.asarray(P, np.float64).reshape(3, -1)[:, :3]

    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    x = (us - P[0, 2]) / P[0, 0]
    y = (vs - P[1, 2]) / P[1, 1]
    pts = np.stack([x, y, np.ones_like(x)], axis=-1) @ np.linalg.inv(R).T
    xp = pts[..., 0] / pts[..., 2]
    yp = pts[..., 1] / pts[..., 2]

    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if len(D) > 4 else 0.0
    r2 = xp * xp + yp * yp
    radial = 1.0 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    xd = xp * radial + 2 * p1 * xp * yp + p2 * (r2 + 2 * xp * xp)
    yd = yp * radial + p1 * (r2 + 2 * yp * yp) + 2 * p2 * xp * yp

    map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img, map_x, map_y):
    """Bilinear remap (cv::remap), border = clamp."""
    h, w = img.shape
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0 = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y0 = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def equalize_hist(img):
    """Histogram equalisation (cv::equalizeHist) of a [0,255] image."""
    i8 = torch.clamp(img, 0, 255).to(torch.int64)
    hist = torch.bincount(i8.reshape(-1), minlength=256).to(torch.float32)
    cdf = torch.cumsum(hist, 0)
    n = float(img.numel())
    cdf_min = cdf[torch.argmax((hist > 0).to(torch.int32))]   # first non-empty bin
    lut = torch.clamp(
        torch.round((cdf - cdf_min) / torch.clamp(n - cdf_min, min=1.0) * 255.0), 0, 255)
    return lut[i8]


class Rectifier:
    """Reads the reference's euroc_rect.yaml schema (OpenCV FileStorage)
    and rectifies frames on `device`."""

    def __init__(self, yaml_path: str, device="cuda"):
        import yaml

        self.device = resolve(device)
        with open(yaml_path) as f:
            txt = f.read()
        # OpenCV FileStorage yaml is not valid YAML ("%YAML:1.0" directive,
        # "!!opencv-matrix" tags, "data:[..." without a space)
        txt = txt.replace("%YAML:1.0", "").replace("!!opencv-matrix", "")
        txt = txt.replace("data:[", "data: [")
        cfg = yaml.safe_load(txt)

        def mat(side, name):
            node = cfg[f"{side}.{name}"]
            return np.array(node["data"], np.float64).reshape(node["rows"], node["cols"])

        w, h = int(cfg["LEFT.width"]), int(cfg["LEFT.height"])
        self.width, self.height = w, h
        self.maps = {}
        for side in ("LEFT", "RIGHT"):
            mx, my = compute_rectify_map(mat(side, "K"), mat(side, "D"), mat(side, "R"),
                                         mat(side, "P"), w, h)
            self.maps[side] = (torch.from_numpy(mx).to(self.device),
                               torch.from_numpy(my).to(self.device))

    def rectify_left(self, img):
        return remap_bilinear(img.to(torch.float32), *self.maps["LEFT"])

    def rectify_right(self, img):
        return remap_bilinear(img.to(torch.float32), *self.maps["RIGHT"])
