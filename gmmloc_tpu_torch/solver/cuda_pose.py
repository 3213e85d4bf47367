"""Staged pose solves K1/K2 as one hand-written CUDA kernel launch each.

Wrappers of `csrc/pose_solver.cu`, which replaces the Pallas kernels of
`gmmloc_tpu/solver/pallas_pose.py` (`optimize_pose`, `optimize_pose_anchored`).
Same signatures and results as the plain versions in `pose_solver.py`:

  - tensors on the CPU go to the plain version;
  - tensors on a CUDA device launch the kernel, or raise: there is no
    fallback from the card.

Each wrapper counts its kernel launches in `<wrapper>.launches`. A solve
on the card is that one launch and one allocation: q0 and t0 go to the
kernel as they are (float32, contiguous), and the kernel writes the pose,
the int32 counts, chi2 and the flags into views of one buffer.
"""

from __future__ import annotations

import torch

from . import pose_solver
from ..utils import cuda_build

_POSE_ARGS = ("x_w", "obs_uvr", "is_stereo", "sigma2_inv", "valid")


def _check(name, x, n, dtype, tail=()):
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != (n,) + tuple(tail):
        raise ValueError(f"{name}: expected shape {(n,) + tuple(tail)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _device_of(x_w):
    if x_w.device.type == "cpu":
        return None
    if x_w.device.type != "cuda":
        raise ValueError(f"no pose-solver kernel for device {x_w.device}")
    return x_w.device


def _outputs(n: int, dev):
    """One allocation for every output of a solve, cut into views: pose
    (8,) f32 [q, t, 0], counts (4,) int32 [inliers, anchors, GN steps, 0],
    chi2 (n,) f32, outlier and anchor-outlier flags (n,) bool."""
    buf = torch.empty(48 + 6 * n, dtype=torch.uint8, device=dev)
    return (buf[:32].view(torch.float32), buf[32:48].view(torch.int32),
            buf[48:48 + 4 * n].view(torch.float32),
            buf[48 + 4 * n:48 + 5 * n].view(torch.bool),
            buf[48 + 5 * n:].view(torch.bool))


def _launch(cam, q0, t0, x_w, obs_uvr, is_stereo, sigma2_inv, valid, anc,
            rounds, iters, step_tol, lib=None):
    """One kernel launch on the current stream, no other device work.
    `lib` is the kernel library (default: the package's own build)."""
    dev = x_w.device
    n = x_w.shape[0]
    tensors = dict(zip(_POSE_ARGS, (x_w, obs_uvr, is_stereo, sigma2_inv, valid)))
    for name, x in [("q0", q0), ("t0", t0)] + list(tensors.items()):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, x_w on {dev}")
    _check("q0", q0, 4, torch.float32)
    _check("t0", t0, 3, torch.float32)
    _check("x_w", x_w, n, torch.float32, (3,))
    _check("obs_uvr", obs_uvr, n, torch.float32, (3,))
    _check("is_stereo", is_stereo, n, torch.bool)
    _check("sigma2_inv", sigma2_inv, n, torch.float32)
    _check("valid", valid, n, torch.bool)
    lib = lib or cuda_build.load()
    if n > lib.gmmloc_pose_max_features():
        raise ValueError(f"{n} features: one solve takes at most "
                         f"{lib.gmmloc_pose_max_features()}")
    pose, counts, chi2, outlier, anc_out = _outputs(n, dev)
    if anc is None:
        null = x_w   # never read by the K1 instantiation
        aptrs = [null.data_ptr()] * 6
        gate = 0.0
    else:
        anc_xc, anc_mean, anc_normal, anc_sqi, anc_type, anc_w, gate = anc
        for name, x, dt, tail in [
            ("anc_xc", anc_xc, torch.float32, (3,)),
            ("anc_mean", anc_mean, torch.float32, (3,)),
            ("anc_normal", anc_normal, torch.float32, (3,)),
            ("anc_sqrt_info", anc_sqi, torch.float32, (3, 3)),
            ("anc_type", anc_type, torch.int32, ()),
            ("anc_weight", anc_w, torch.float32, ()),
        ]:
            if x.device != dev:
                raise ValueError(f"{name} is on {x.device}, x_w on {dev}")
            _check(name, x, n, dt, tail)
        aptrs = [x.data_ptr() for x in (anc_xc, anc_mean, anc_normal, anc_sqi,
                                         anc_type, anc_w)]
        gate = float(gate)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gmmloc_pose_solve(
            q0.data_ptr(), t0.data_ptr(), x_w.data_ptr(), obs_uvr.data_ptr(),
            is_stereo.data_ptr(), sigma2_inv.data_ptr(), valid.data_ptr(),
            *aptrs, gate, n, int(anc is not None), rounds, iters, step_tol,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            pose.data_ptr(), counts.data_ptr(), chi2.data_ptr(),
            outlier.data_ptr(), anc_out.data_ptr(), stream,
        )
    cuda_build.check(err, "gmmloc_pose_solve")
    return pose, counts, chi2, outlier, anc_out


def optimize_pose(cam, q0, t0, x_w, obs_uvr, is_stereo, sigma2_inv, valid,
                  rounds: int = 4, iters: int = 10,
                  step_tol: float = 1e-8) -> pose_solver.PoseOptResult:
    """K1: the staged pose-only solve (drop-in for pose_solver.optimize_pose)."""
    if _device_of(x_w) is None:
        return pose_solver.optimize_pose(
            cam, q0, t0, x_w, obs_uvr, is_stereo, sigma2_inv, valid,
            rounds=rounds, iters=iters, step_tol=step_tol)
    pose, counts, chi2, outlier, _ = _launch(
        cam, q0, t0, x_w, obs_uvr, is_stereo, sigma2_inv, valid, None,
        rounds, iters, step_tol)
    cuda_build.count_launch(optimize_pose)
    return pose_solver.PoseOptResult(
        q=pose[:4], t=pose[4:7], is_outlier=outlier, num_inliers=counts[0],
        chi2=chi2, gn_iters=counts[2])


optimize_pose.launches = 0


def optimize_pose_anchored(cam, q0, t0, x_w, obs_uvr, is_stereo, sigma2_inv,
                           valid, anc_xc, anc_mean, anc_normal, anc_sqrt_info,
                           anc_type, anc_weight, anc_chi2_th,
                           rounds: int = 4, iters: int = 10,
                           step_tol: float = 1e-8) -> pose_solver.PoseAnchorResult:
    """K2: the anchored staged solve (drop-in for
    pose_solver.optimize_pose_anchored). anc_chi2_th is a Python float."""
    if _device_of(x_w) is None:
        return pose_solver.optimize_pose_anchored(
            cam, q0, t0, x_w, obs_uvr, is_stereo, sigma2_inv, valid,
            anc_xc, anc_mean, anc_normal, anc_sqrt_info, anc_type, anc_weight,
            anc_chi2_th, rounds=rounds, iters=iters, step_tol=step_tol)
    anc = (anc_xc, anc_mean, anc_normal, anc_sqrt_info, anc_type, anc_weight,
           anc_chi2_th)
    pose, counts, chi2, outlier, anc_out = _launch(
        cam, q0, t0, x_w, obs_uvr, is_stereo, sigma2_inv, valid, anc,
        rounds, iters, step_tol)
    cuda_build.count_launch(optimize_pose_anchored)
    return pose_solver.PoseAnchorResult(
        q=pose[:4], t=pose[4:7], is_outlier=outlier, num_inliers=counts[0],
        chi2=chi2, anc_outlier=anc_out, num_anchors=counts[1],
        gn_iters=counts[2])


optimize_pose_anchored.launches = 0
