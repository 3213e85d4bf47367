"""Per-frame feature container with static-capacity arrays.

TPU-native replacement for Frame/Feature (ref:
gmmloc/src/types/frame.cpp, include/gmmloc/types/
{frame.h,feature.h}). All arrays are padded to cfg.frame.feat_cap so the
device kernels see static shapes; the 64x48 feature grid disappears —
windowed search is a dense masked pass (features/matching.py).

The port's own copy of `gmmloc_tpu/tracking/frame.py` (numpy only, copied unchanged
so that the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Frame:
    idx: int
    timestamp: float
    uv: np.ndarray        # (F,2) float32
    ur: np.ndarray        # (F,) float32, -1 if mono
    depth: np.ndarray     # (F,) float32, -1 if unknown
    octave: np.ndarray    # (F,) int32
    angle: np.ndarray     # (F,) float32 degrees
    desc: np.ndarray      # (F,32) uint8
    valid: np.ndarray     # (F,) bool
    q_cw: np.ndarray = field(default_factory=lambda: np.array([1.0, 0, 0, 0]))
    t_cw: np.ndarray = field(default_factory=lambda: np.zeros(3))
    ref_kf: int = -1
    is_keyframe: bool = False
    mappoint: np.ndarray = None   # (F,) int32, -1 = none
    is_outlier: np.ndarray = None  # (F,) bool

    def __post_init__(self):
        F = len(self.uv)
        if self.mappoint is None:
            self.mappoint = np.full(F, -1, np.int32)
        if self.is_outlier is None:
            self.is_outlier = np.zeros(F, bool)

    @property
    def feat_cap(self) -> int:
        return len(self.uv)

    def num_features(self) -> int:
        return int(self.valid.sum())

    def set_pose(self, q_cw, t_cw):
        # Renormalize at the host boundary: device solvers (f32/bf16
        # staging) return quaternions with up to ~0.5% norm error, and
        # quat_to_mat/_inverse assume unit norm — un-normalized poses
        # compound into ~1% rotation-matrix error and phantom
        # rotation-error readings in the diagnostics.
        q = np.asarray(q_cw, dtype=np.float64)
        self.q_cw = q / np.linalg.norm(q)
        self.t_cw = np.asarray(t_cw, dtype=np.float64)


def make_frame(idx, timestamp, uv, ur, depth, octave, angle, desc, feat_cap):
    """Pad raw per-frame feature arrays up to feat_cap."""
    n = len(uv)
    assert n <= feat_cap, (n, feat_cap)

    def pad(a, fill, dtype):
        out = np.full((feat_cap,) + np.asarray(a).shape[1:], fill, dtype)
        out[:n] = a
        return out

    return Frame(
        idx=idx,
        timestamp=timestamp,
        uv=pad(uv, 0.0, np.float32),
        ur=pad(ur, -1.0, np.float32),
        depth=pad(depth, -1.0, np.float32),
        octave=pad(octave, 0, np.int32),
        angle=pad(angle, 0.0, np.float32),
        desc=pad(desc, 0, np.uint8),
        valid=pad(np.ones(n, bool), False, bool),
    )
