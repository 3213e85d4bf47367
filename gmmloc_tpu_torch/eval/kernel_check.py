"""Kernel-against-plain-version checks on the card.

Seeded problems at the main path's shapes, the comparison of each CUDA
kernel (K1, K2, K3) with its plain PyTorch version on the same inputs, and
CUDA-event timing. Used by `chip_smoke.py` and the card tests.

Gates (stated with their reason): the pose kernels sum the 27 normal-
equation terms in another order than the plain version, so they agree to
float tolerance -- rotation < 0.01 deg (K2: 0.02), translation < 1e-3 m
(K2: 2e-3), outlier-flag difference <= 2 (K2: 3, anchor flags <= 3),
inlier-count difference <= 2; flags may differ only at the chi2 gate.
The Hamming kernel is integer arithmetic and must be exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solver import cuda_pose, pose_solver
from ..features import cuda_kernels

K1_GATES = dict(rot_deg=0.01, trans=1e-3, outlier_diff=2, inlier_diff=2)
K2_GATES = dict(rot_deg=0.02, trans=2e-3, outlier_diff=3, inlier_diff=3,
                anchor_diff=3)


def pose_problem(cam, n: int, seed: int = 0, anchored: bool = False,
                 outlier_frac: float = 0.12, noise: float = 0.4):
    """A seeded pose-only problem of n features (numpy): landmarks seen
    from a perturbed identity pose, 12% gross outliers, 80% stereo; with
    `anchored`, GMM anchors on ~70% of the features (half degenerate)."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform([40, 40], [cam.width - 40, cam.height - 40], (n, 2))
    z = rng.uniform(1.0, 12.0, n)
    x_w = np.stack([(uv[:, 0] - cam.cx) / cam.fx * z,
                    (uv[:, 1] - cam.cy) / cam.fy * z, z], -1)
    obs = np.concatenate([uv, (uv[:, 0] - cam.bf / z)[:, None]], -1)
    obs += rng.normal(0, noise, obs.shape)
    n_out = int(outlier_frac * n)
    obs[:n_out] += rng.normal(0, 30.0, obs[:n_out].shape)
    q0 = np.array([1.0, 0.004, -0.006, 0.002])
    p = dict(
        q0=q0 / np.linalg.norm(q0), t0=np.array([0.02, -0.015, 0.01]),
        x_w=x_w, obs_uvr=obs, is_stereo=rng.random(n) < 0.8,
        sigma2_inv=1.0 / 1.2 ** (2 * rng.integers(0, 8, n)),
        valid=rng.random(n) < 0.95,
    )
    if anchored:
        disp = obs[:, 0] - obs[:, 2]
        zs = np.where(np.abs(disp) < 1e-6, 1e9, cam.bf / np.clip(disp, 1e-6, None))
        nrm = rng.normal(size=(n, 3))
        a_type = np.where(
            rng.random(n) < 0.3, pose_solver.ANCHOR_NONE,
            np.where(rng.random(n) < 0.5, pose_solver.ANCHOR_DEG,
                     pose_solver.ANCHOR_NONDEG))
        a_type = np.where((zs > 0) & (zs < 1e3), a_type, pose_solver.ANCHOR_NONE)
        p.update(
            anc_xc=np.stack([(obs[:, 0] - cam.cx) / cam.fx * zs,
                             (obs[:, 1] - cam.cy) / cam.fy * zs, zs], -1),
            anc_mean=x_w + rng.normal(0, 0.01, (n, 3)),
            anc_normal=nrm / np.linalg.norm(nrm, axis=1, keepdims=True),
            anc_sqrt_info=np.tile(np.eye(3) * 3.0, (n, 1, 1)),
            anc_type=a_type.astype(np.int32),
            anc_weight=np.where(a_type == pose_solver.ANCHOR_DEG,
                                400.0 * np.maximum(zs, 1.0) ** 2, 1.0),
            anc_chi2_th=2.56,
        )
    return p


POSE_ORDER = ("q0", "t0", "x_w", "obs_uvr", "is_stereo", "sigma2_inv", "valid")
ANC_ORDER = ("anc_xc", "anc_mean", "anc_normal", "anc_sqrt_info", "anc_type",
             "anc_weight")


def pose_args(p, device, anchored: bool):
    """Problem dict -> positional tensor args (float32/bool/int32)."""
    def t(v):
        a = np.asarray(v)
        if a.dtype == bool:
            return torch.tensor(a, device=device)
        if a.dtype.kind in "iu":
            return torch.tensor(a, dtype=torch.int32, device=device)
        return torch.tensor(a, dtype=torch.float32, device=device)

    args = [t(p[k]) for k in POSE_ORDER]
    if anchored:
        args += [t(p[k]) for k in ANC_ORDER] + [float(p["anc_chi2_th"])]
    return args


def angle_deg(qa, qb) -> float:
    """Rotation angle between two quaternions, each renormalized in
    float64 first (a float32 unit quaternion is off by ~1e-7 in norm,
    which arccos near 1 would read as ~0.02 degrees)."""
    qa = np.asarray(qa, np.float64)
    qb = np.asarray(qb, np.float64)
    d = abs(float(np.dot(qa / np.linalg.norm(qa), qb / np.linalg.norm(qb))))
    return float(np.degrees(2 * np.arccos(min(d, 1.0))))


def compare_pose(ref, out, anchored: bool) -> dict:
    """Gate quantities between two pose results (any device)."""
    g = lambda x: x.detach().cpu().numpy()
    m = dict(
        rot_deg=angle_deg(g(ref.q), g(out.q)),
        trans=float(np.linalg.norm(g(ref.t) - g(out.t))),
        outlier_diff=int((g(ref.is_outlier) != g(out.is_outlier)).sum()),
        inlier_diff=abs(int(ref.num_inliers) - int(out.num_inliers)),
        max_abs_err=float(max(np.abs(g(ref.q) - g(out.q)).max(),
                              np.abs(g(ref.t) - g(out.t)).max())),
    )
    if anchored:
        m["anchor_diff"] = int((g(ref.anc_outlier) != g(out.anc_outlier)).sum())
    return m


def within(m: dict, gates: dict) -> bool:
    return all(m[k] < v if isinstance(v, float) else m[k] <= v
               for k, v in gates.items())


def time_cuda(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn() on the current stream, by CUDA
    events around `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def check_pose_kernel(cam, n: int, anchored: bool, device, seed: int = 0,
                      timing: bool = True) -> dict:
    """Run K1 (or K2) and its plain version on the card on one seeded
    problem; returns the gate quantities, `ok`, and both times."""
    p = pose_problem(cam, n, seed=seed, anchored=anchored)
    args = pose_args(p, device, anchored)
    if anchored:
        kern, plain, gates = (cuda_pose.optimize_pose_anchored,
                              pose_solver.optimize_pose_anchored, K2_GATES)
    else:
        kern, plain, gates = (cuda_pose.optimize_pose, pose_solver.optimize_pose,
                              K1_GATES)
    n0 = kern.launches
    out = kern(cam, *args)
    torch.cuda.synchronize()
    if kern.launches != n0 + 1:
        raise RuntimeError(f"{kern.__name__} did not launch its kernel")
    ref = plain(cam, *args)
    m = compare_pose(ref, out, anchored)
    m["ok"] = within(m, gates)
    if timing:
        m["ms"] = time_cuda(lambda: kern(cam, *args))
        m["plain_ms"] = time_cuda(lambda: plain(cam, *args), reps=5, warmup=1)
    return m


def check_hamming_kernel(n: int, m: int, device, seed: int = 0,
                         timing: bool = True) -> dict:
    """K3 against its plain version on the card: must be exact."""
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.integers(0, 256, (n, 32), dtype=np.uint8), device=device)
    b = torch.tensor(rng.integers(0, 256, (m, 32), dtype=np.uint8), device=device)
    n0 = cuda_kernels.hamming_matrix.launches
    out = cuda_kernels.hamming_matrix(a, b)
    torch.cuda.synchronize()
    if cuda_kernels.hamming_matrix.launches != n0 + 1:
        raise RuntimeError("hamming_matrix did not launch its kernel")
    ref = cuda_kernels.hamming_matrix_plain(a, b)
    r = dict(max_abs_err=int((out - ref).abs().max()) if out.numel() else 0,
             shape=[n, m])
    r["ok"] = r["max_abs_err"] == 0 and out.dtype == torch.int32
    if timing:
        r["ms"] = time_cuda(lambda: cuda_kernels.hamming_matrix(a, b))
        r["plain_ms"] = time_cuda(lambda: cuda_kernels.hamming_matrix_plain(a, b))
    return r
