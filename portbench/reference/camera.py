"""Batched pinhole/stereo camera model with Jacobians.

PyTorch port of `gmmloc_tpu/geometry/camera.py`: shape-polymorphic over
leading dims; visibility is a boolean mask.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class CameraParams(NamedTuple):
    """Static pinhole intrinsics; bf = baseline*fx for the stereo model."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    bf: float = 0.0

    @classmethod
    def from_config(cls, cam) -> "CameraParams":
        return cls(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, cam.bf)


def _z_safe(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: CameraParams, pc):
    """Camera-frame points (...,3) -> pixel uv (...,2) + visibility
    (z > 0 and inside the image)."""
    z = pc[..., 2]
    zs = _z_safe(z)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    uv = torch.stack([u, v], dim=-1)
    visible = (z > 0.0) & (u >= 0.0) & (v >= 0.0) & (u < cam.width) & (v < cam.height)
    return uv, visible


def project_jacobian(cam: CameraParams, pc):
    """d(uv)/d(pc): (...,2,3)."""
    x, y, z = pc.unbind(-1)
    iz = 1.0 / _z_safe(z)
    iz2 = iz * iz
    zr = torch.zeros_like(x)
    row0 = torch.stack([cam.fx * iz, zr, -cam.fx * x * iz2], dim=-1)
    row1 = torch.stack([zr, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def project_stereo(cam: CameraParams, pc):
    """Camera-frame points -> (u, v, u_right) (...,3) + visibility,
    u_right = u - bf/z."""
    uv, visible = project(cam, pc)
    ur = uv[..., 0] - cam.bf / _z_safe(pc[..., 2])
    return torch.cat([uv, ur[..., None]], dim=-1), visible


def unproject(cam: CameraParams, uv, depth):
    """Pixels (...,2) + depth (...,) -> camera-frame points (...,3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def disparity_to_depth(cam: CameraParams, disparity):
    """Depth bf / disparity; 0 where the disparity is <= 0."""
    d = torch.where(disparity <= 0.0, torch.full_like(disparity, math.inf), disparity)
    return cam.bf / d


def depth_to_uright(cam: CameraParams, u, depth):
    """The right-image column of a point at `depth` seen at column u (u
    itself where depth <= 0)."""
    z = torch.where(depth <= 0.0, torch.full_like(depth, math.inf), depth)
    return u - cam.bf / z
