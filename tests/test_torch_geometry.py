"""Port against the JAX package: SE(3), camera (projection, stereo depth
helpers) and factor terms on random batches (numpy seed, the same inputs
to both), to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmmloc_tpu.config import euroc_v1_config
from gmmloc_tpu.geometry import camera as jcam
from gmmloc_tpu.geometry import se3 as jse3
from gmmloc_tpu.solver import factors as jfac

from gmmloc_tpu_torch.geometry import camera as tcam
from gmmloc_tpu_torch.geometry import se3 as tse3
from gmmloc_tpu_torch.solver import factors as tfac

torch.set_num_threads(1)

TOL = 1e-5
N = 64


def _rand(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(
        q=q, q2=np.roll(q, 1, 0), t=rng.normal(size=(N, 3)),
        t2=rng.normal(size=(N, 3)), x=rng.normal(size=(N, 3)) + [0, 0, 5.0],
        xi=rng.normal(scale=0.3, size=(N, 6)),
        xi_small=rng.normal(scale=1e-7, size=(N, 6)),
        R=np.linalg.qr(rng.normal(size=(N, 3, 3)))[0],
    )


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(a, b, tol=TOL):
    a = [np.asarray(x) for x in (a if isinstance(a, tuple) else (a,))]
    b = [x.numpy() for x in (b if isinstance(b, tuple) else (b,))]
    for u, v in zip(a, b):
        np.testing.assert_allclose(u, v, atol=tol, rtol=tol)


CASES = {
    "quat_mul": (lambda m, d: m.quat_mul(d["q"], d["q2"]), ("q", "q2")),
    "quat_rotate": (lambda m, d: m.quat_rotate(d["q"], d["x"]), ("q", "x")),
    "quat_to_matrix": (lambda m, d: m.quat_to_matrix(d["q"]), ("q",)),
    "compose": (lambda m, d: m.compose(d["q"], d["t"], d["q2"], d["t2"]),
                ("q", "t", "q2", "t2")),
    "inverse": (lambda m, d: m.inverse(d["q"], d["t"]), ("q", "t")),
    "apply": (lambda m, d: m.apply(d["q"], d["t"], d["x"]), ("q", "t", "x")),
    "skew": (lambda m, d: m.skew(d["x"]), ("x",)),
    "exp": (lambda m, d: m.exp(d["xi"]), ("xi",)),
    "exp_small": (lambda m, d: m.exp(d["xi_small"]), ("xi_small",)),
    "log": (lambda m, d: m.log(d["q"], d["t"]), ("q", "t")),
    "boxplus": (lambda m, d: m.boxplus(d["q"], d["t"], d["xi"]), ("q", "t", "xi")),
    "adjoint": (lambda m, d: m.adjoint(d["q"], d["t"]), ("q", "t")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_se3_matches_reference(name):
    fn, keys = CASES[name]
    d = _rand(1)
    ref = fn(jse3, {k: _j(d[k]) for k in keys})
    out = fn(tse3, {k: _t(d[k]) for k in keys})
    _close(ref, out, tol=1e-4 if name == "log" else TOL)


def test_matrix_to_quat_matches_reference():
    d = _rand(2)
    ref = np.asarray(jse3.matrix_to_quat(_j(d["R"] * np.sign(np.linalg.det(d["R"]))[:, None, None])))
    out = tse3.matrix_to_quat(_t(d["R"] * np.sign(np.linalg.det(d["R"]))[:, None, None])).numpy()
    # q and -q are one rotation
    np.testing.assert_allclose(np.abs(np.sum(ref * out, -1)), 1.0, atol=TOL)


def _cams():
    c = euroc_v1_config().camera
    return jcam.CameraParams.from_config(c), tcam.CameraParams.from_config(c)


@pytest.mark.parametrize("fn", ["project", "project_jacobian", "project_stereo"])
def test_camera_matches_reference(fn):
    jc, tc = _cams()
    rng = np.random.default_rng(3)
    pc = rng.normal(size=(N, 3)) * [2, 1.5, 2] + [0, 0, 4]
    pc[:3, 2] = [-1.0, 0.0, 1e-12]   # behind, on and near the image plane
    ref = getattr(jcam, fn)(jc, _j(pc))
    out = getattr(tcam, fn)(tc, _t(pc))
    if isinstance(ref, tuple):
        np.testing.assert_array_equal(np.asarray(ref[1]), out[1].numpy())
        ref, out = ref[0], out[0]
    ok = np.abs(pc[:, 2]) > 1e-6
    np.testing.assert_allclose(np.asarray(ref)[ok], out.numpy()[ok], rtol=TOL, atol=1e-3)


def test_camera_unproject_matches_reference():
    jc, tc = _cams()
    rng = np.random.default_rng(4)
    uv = rng.uniform([0, 0], [752, 480], (N, 2))
    depth = rng.uniform(0.5, 20, N)
    _close(jcam.unproject(jc, _j(uv), _j(depth)), tcam.unproject(tc, _t(uv), _t(depth)),
           tol=1e-4)


def test_factor_terms_match_reference():
    jc, tc = _cams()
    d = _rand(5)
    rng = np.random.default_rng(5)
    obs = rng.uniform([0, 0, 0], [752, 480, 700], (N, 3))
    st = rng.random(N) < 0.7
    q, t = d["q"][0], np.array([0.1, -0.2, 0.3])
    x = d["x"]
    jr = jfac.reproj_residual(jc, _j(q), _j(t), _j(x), _j(obs), jnp.asarray(st))
    tr = tfac.reproj_residual(tc, _t(q), _t(t), _t(x), _t(obs), torch.tensor(st))
    _close(jr[0], tr[0], tol=1e-3)
    _close(jfac.stereo_proj_jac_pose(jc, jr[1], jnp.asarray(st)),
           tfac.stereo_proj_jac_pose(tc, tr[1], torch.tensor(st)), tol=1e-3)
    _close(jfac.stereo_proj_jac_point(jc, _j(q), jr[1], jnp.asarray(st)),
           tfac.stereo_proj_jac_point(tc, _t(q), tr[1], torch.tensor(st)), tol=1e-3)
    L = np.tril(rng.normal(size=(N, 3, 3)))
    _close(jfac.pt2gaussian_residual(_j(x), _j(d["t"]), _j(L)),
           tfac.pt2gaussian_residual(_t(x), _t(d["t"]), _t(L)))
    _close(jfac.pt2plane_residual(_j(x), _j(d["t"]), _j(d["t2"])),
           tfac.pt2plane_residual(_t(x), _t(d["t"]), _t(d["t2"])))
    xw, Rwc = jfac.anchor_point_world(_j(q), _j(t), _j(x))
    xw_t, Rwc_t = tfac.anchor_point_world(_t(q), _t(t), _t(x))
    _close((xw, Rwc), (xw_t, Rwc_t))
    _close(jfac.anchor_jac_pose(Rwc, _j(x)), tfac.anchor_jac_pose(Rwc_t, _t(x)))
    _close(jfac.se3_prior_residual(_j(q), _j(t), _j(d["q2"][0]), _j(d["t2"][0])),
           tfac.se3_prior_residual(_t(q), _t(t), _t(d["q2"][0]), _t(d["t2"][0])), tol=1e-4)
    _close(jfac.se3_prior_jacobian(_j(q), _j(t), _j(d["q2"][0]), _j(d["t2"][0])),
           tfac.se3_prior_jacobian(_t(q), _t(t), _t(d["q2"][0]), _t(d["t2"][0])), tol=1e-4)
    chi2 = rng.uniform(0, 20, N)
    _close(jfac.huber_weight(_j(chi2), 2.5), tfac.huber_weight(_t(chi2), 2.5))


@pytest.mark.parametrize("fn", ["disparity_to_depth", "depth_to_uright"])
def test_camera_stereo_helpers_match_reference(fn):
    """disparity_to_depth and depth_to_uright, with non-positive
    disparities and depths among the inputs."""
    jc, tc = _cams()
    rng = np.random.default_rng(5)
    v = rng.uniform(-2, 60, N)
    v[:3] = [0.0, -1.0, 1e-3]
    if fn == "disparity_to_depth":
        ref, out = jcam.disparity_to_depth(jc, _j(v)), tcam.disparity_to_depth(tc, _t(v))
    else:
        u = rng.uniform(0, 752, N)
        ref = jcam.depth_to_uright(jc, _j(u), _j(v))
        out = tcam.depth_to_uright(tc, _t(u), _t(v))
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=TOL, atol=1e-4)
