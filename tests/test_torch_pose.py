"""Plain versions of the pose kernels K1/K2 against the JAX package.

The same seeded problems (numpy) go through the port's plain staged
solves and through both JAX forms: `pose_solver` (XLA) and the Pallas
kernels of `pallas_pose` in interpret mode. Gates (reduction order
differs): K1 rotation < 0.01 deg, translation < 1e-3 m, outlier-flag and
inlier-count differences <= 2; K2 rotation < 0.02 deg, translation
< 2e-3 m, outlier and anchor-flag differences <= 3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmmloc_tpu.config import euroc_v1_config
from gmmloc_tpu.geometry import camera as jcam
from gmmloc_tpu.solver import pallas_pose, pose_solver as jps

from gmmloc_tpu_torch.eval import kernel_check
from gmmloc_tpu_torch.geometry import camera as tcam
from gmmloc_tpu_torch.solver import cuda_pose, pose_solver as tps

torch.set_num_threads(1)

F = 256  # lane-aligned for the Pallas reference


@pytest.fixture
def cams():
    c = euroc_v1_config().camera
    return jcam.CameraParams.from_config(c), tcam.CameraParams.from_config(c)


def _jax_args(p, anchored):
    def j(v):
        a = np.asarray(v)
        if a.dtype == bool:
            return jnp.asarray(a)
        if a.dtype.kind in "iu":
            return jnp.asarray(a, jnp.int32)
        return jnp.asarray(a, jnp.float32)

    args = [j(p[k]) for k in kernel_check.POSE_ORDER]
    if anchored:
        args += [j(p[k]) for k in kernel_check.ANC_ORDER] + [jnp.float32(p["anc_chi2_th"])]
    return args


class _JaxView:
    """A JAX result read through the port's comparison helper."""

    def __init__(self, r):
        for k, v in r._asdict().items():
            setattr(self, k, torch.tensor(np.asarray(v)))


@pytest.mark.parametrize("ref_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_plain_pose_matches_reference(cams, ref_impl, anchored, seed):
    jc, tc = cams
    p = kernel_check.pose_problem(tc, F, seed=seed, anchored=anchored)
    jargs = _jax_args(p, anchored)
    if ref_impl == "xla":
        fn = jps.optimize_pose_anchored if anchored else jps.optimize_pose
        ref = fn(jc, *jargs)
    else:
        fn = pallas_pose.optimize_pose_anchored if anchored else pallas_pose.optimize_pose
        ref = fn(jc, *jargs, interpret=True)
    plain = tps.optimize_pose_anchored if anchored else tps.optimize_pose
    out = plain(tc, *kernel_check.pose_args(p, "cpu", anchored))
    m = kernel_check.compare_pose(_JaxView(ref), out, anchored)
    gates = kernel_check.K2_GATES if anchored else kernel_check.K1_GATES
    assert kernel_check.within(m, gates), m


@pytest.mark.parametrize("anchored", [False, True])
def test_wrapper_uses_plain_version_on_cpu(cams, anchored):
    _, tc = cams
    p = kernel_check.pose_problem(tc, 128, seed=1, anchored=anchored)
    args = kernel_check.pose_args(p, "cpu", anchored)
    wrap = cuda_pose.optimize_pose_anchored if anchored else cuda_pose.optimize_pose
    plain = tps.optimize_pose_anchored if anchored else tps.optimize_pose
    n0 = wrap.launches
    a, b = wrap(tc, *args), plain(tc, *args)
    assert wrap.launches == n0        # no kernel launch on the CPU
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_wrapper_raises_on_a_device_without_kernel(cams):
    _, tc = cams
    p = kernel_check.pose_problem(tc, 64)
    args = kernel_check.pose_args(p, "meta", anchored=False)
    with pytest.raises(ValueError):
        cuda_pose.optimize_pose(tc, *args)


def test_plain_pose_converges_to_truth(cams):
    """Independent of the reference: a noise-free problem recovers identity."""
    _, tc = cams
    rng = np.random.default_rng(7)
    uv = rng.uniform([40, 40], [tc.width - 40, tc.height - 40], (F, 2))
    z = rng.uniform(1.0, 10.0, F)
    x_w = np.stack([(uv[:, 0] - tc.cx) / tc.fx * z, (uv[:, 1] - tc.cy) / tc.fy * z, z], -1)
    obs = np.concatenate([uv, (uv[:, 0] - tc.bf / z)[:, None]], -1)
    q0 = np.array([1.0, 0.01, -0.01, 0.005])
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    out = tps.optimize_pose(tc, f(q0 / np.linalg.norm(q0)), f([0.03, -0.02, 0.01]),
                            f(x_w), f(obs), torch.ones(F, dtype=torch.bool),
                            torch.ones(F), torch.ones(F, dtype=torch.bool))
    assert kernel_check.angle_deg(out.q.numpy(), [1, 0, 0, 0]) < 0.01
    assert float(torch.linalg.norm(out.t)) < 1e-3
    assert int(out.num_inliers) == F
