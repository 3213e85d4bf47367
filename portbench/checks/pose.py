"""The per-frame pose solves K1 and K2 (with their GMM anchors).

Captures a sample of the calls of `solver.cuda_pose.optimize_pose` and
`optimize_pose_anchored` (the tracker looks them up at each call): their
inputs, the matched landmarks and observations and the anchors as the
guided matching and the GMM association left them, and the pose they
returned. The reference (`reference/pose_solver.py`) solves each again
in float64 on the CPU; the numbers are the largest gaps over the sample.
The control solves in bfloat16.
"""

from __future__ import annotations

import math

import torch

from ..capture import Reservoir, clone
from ..reference import pose_solver
from ..reference.camera import CameraParams

PER_KIND = 4          # solves kept of each of K1 and K2
LIMITS = {"pose_t_gap_mm": 0.5, "pose_r_gap_mrad": 0.15}
CONTROLS = ("bf16",)


def install(patch, seed: int, program) -> dict:
    from gmmloc_tpu_torch.solver import cuda_pose

    kept = {}
    for i, name in enumerate(("optimize_pose", "optimize_pose_anchored")):
        res = kept[name] = Reservoir(PER_KIND, seed * 2 + i)

        def make(orig, res=res):
            def solve(cam, *args, **kw):
                slot = res.offer()
                if slot is None:
                    return orig(cam, *args, **kw)
                inputs = [clone(a) for a in args]
                out = orig(cam, *args, **kw)
                res.put(slot, dict(inputs=inputs, kw=dict(kw), q=clone(out.q), t=clone(out.t)))
                return out
            return solve

        patch.set(cuda_pose, name, make)
    return kept


def _gap(q, t, q_ref, t_ref):
    """Translation gap (mm) and rotation gap (mrad); inf for a pose that
    is not finite."""
    if not (torch.isfinite(q).all() and torch.isfinite(t).all()):
        return math.inf, math.inf
    t_mm = float(torch.linalg.norm(t.double() - t_ref)) * 1e3
    dot = abs(float(torch.dot(q.double() / torch.linalg.norm(q.double()),
                              q_ref / torch.linalg.norm(q_ref))))
    return t_mm, 2.0 * math.acos(min(1.0, dot)) * 1e3


def solve(item: dict, cam: CameraParams, dtype, anchored: bool):
    args = [a.to("cpu") if isinstance(a, torch.Tensor) else a for a in item["inputs"]]
    args = [a.to(dtype) if isinstance(a, torch.Tensor) and a.is_floating_point() else a
            for a in args]
    fn = pose_solver.optimize_pose_anchored if anchored else pose_solver.optimize_pose
    out = fn(cam, *args, **item["kw"])
    return out.q.double(), out.t.double()


def numbers(kept: dict, ref: dict, control: str | None = None) -> dict:
    cam = ref["cam"]
    t_gap, r_gap, n = 0.0, 0.0, 0
    for name, res in kept.items():
        anchored = name == "optimize_pose_anchored"
        for item in res.kept():
            q_ref, t_ref = solve(item, cam, torch.float64, anchored)
            if control:
                q, t = solve(item, cam, torch.bfloat16, anchored)
            else:
                q, t = item["q"].cpu(), item["t"].cpu()
            a, b = _gap(q, t, q_ref, t_ref)
            t_gap, r_gap, n = max(t_gap, a), max(r_gap, b), n + 1
    if n == 0:
        return {}
    return {"pose_t_gap_mm": t_gap, "pose_r_gap_mrad": r_gap}
