"""GMM map, rendering and keyframe association against the JAX package,
on the seeded room fixture (400 components padded to 512): the loaded map
equal field by field, `render_view`'s visibility and
`search_correspondence`'s candidates exact, and the fused
`associate_and_check_kernel` exact in its component ids. The Gaussian
helpers of `gaussian.py` on seeded covariances."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmmloc_tpu.config import euroc_v1_config
from gmmloc_tpu.eval import synthetic as jsyn
from gmmloc_tpu.geometry import camera as jcam
from gmmloc_tpu.gmm import mixture as jmix, render as jren
from gmmloc_tpu.mapping import association as jassoc

from gmmloc_tpu_torch.eval import room_fixture
from gmmloc_tpu_torch.geometry import camera as tcam
from gmmloc_tpu_torch.gmm import mixture as tmix, render as tren
from gmmloc_tpu_torch.mapping import association as tassoc

torch.set_num_threads(1)

PAD = 512


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("room")
    gmm_path, gt_path = room_fixture.write_room_fixture(str(d), 400, 40, seed=0)
    cfg = euroc_v1_config()
    cfg = cfg.replace(frame=dataclasses.replace(cfg.frame, feat_cap=256, num_features=240))
    kw = dict(pad_to=PAD, neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
              neighbor_cap=cfg.gmm.neighbor_cap)
    fe, ts, q_wc, t_wc = jsyn.make_sequence(cfg, gt_path=gt_path, gmm_path=gmm_path,
                                            n_landmarks=4000, seed=0)
    frames = [fe.make_frame(i, ts[i], q_wc[i], t_wc[i]) for i in (0, 20)]
    poses = []
    for i in (0, 20):
        q_cw = q_wc[i] * np.array([1.0, -1, -1, -1])
        w, x, y, z = q_cw
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        poses.append((q_cw, -R @ t_wc[i]))
    return dict(cfg=cfg, jmap=jmix.load(gmm_path, **kw),
                tmap=tmix.load(gmm_path, "cpu", **kw), frames=frames, poses=poses,
                jcam=jcam.CameraParams.from_config(cfg.camera),
                tcam=tcam.CameraParams.from_config(cfg.camera))


def test_map_loads_equal(world):
    jm, tm = world["jmap"], world["tmap"]
    for k in tmix.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jm, k)),
                                      getattr(tm, k).numpy(), err_msg=k)
    jh = jmix.host_view(jm)
    for k, v in tmix.host_view(tm).items():
        np.testing.assert_array_equal(jh[k], v, err_msg=k)
    assert (tm.neighbors[:400] >= 0).any(1).float().mean() > 0.5


def test_from_jax_map(world):
    jm = world["jmap"]
    fields = {k: np.asarray(getattr(jm, k)) for k in tmix.FIELDS}
    out = tmix.from_jax_map(fields, "cpu")
    for k in tmix.FIELDS:
        np.testing.assert_array_equal(fields[k], getattr(out, k).numpy(), err_msg=k)


@pytest.mark.parametrize("view", [0, 1])
def test_render_and_search_correspondence_exact(world, view):
    q, t = world["poses"][view]
    f = world["frames"][view]
    rj = jren.render_view(world["jmap"], world["jcam"], jnp.asarray(q, jnp.float32),
                          jnp.asarray(t, jnp.float32))
    rt = tren.render_view(world["tmap"], world["tcam"], torch.tensor(q, dtype=torch.float32),
                          torch.tensor(t, dtype=torch.float32))
    np.testing.assert_array_equal(np.asarray(rj.visible), rt.visible.numpy())
    assert rt.visible.sum() > 10
    vis = rt.visible.numpy()
    np.testing.assert_allclose(np.asarray(rj.mean2d)[vis], rt.mean2d.numpy()[vis], rtol=1e-5)
    cj = jren.search_correspondence(rj, jnp.asarray(f.uv), jnp.asarray(f.valid))
    ct = tren.search_correspondence(rt, torch.tensor(f.uv), torch.tensor(f.valid))
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    assert (ct >= 0).sum() > 50
    pts = torch.tensor(np.random.default_rng(view).uniform(-3, 3, (64, 3)), dtype=torch.float32)
    ok = torch.ones(64, dtype=torch.bool)
    np.testing.assert_array_equal(
        np.asarray(jren.query_point_3d(world["jmap"], jnp.asarray(pts.numpy()), jnp.asarray(ok.numpy()))),
        tren.query_point_3d(world["tmap"], pts, ok).numpy())


@pytest.mark.parametrize("view", [0, 1])
def test_associate_and_check_kernel_exact(world, view):
    cfg = world["cfg"]
    g, lc = cfg.gmm, cfg.loc
    q, t = world["poses"][view]
    f = world["frames"][view]
    s2i = (1.0 / 1.2 ** (2 * np.arange(8))).astype(np.float32)
    kw = dict(knn=g.assoc_knn, mdist2_thresh=g.assoc_mdist2_thresh,
              view_cos_deg=g.view_cos_deg, cov2d_scale_thresh=g.cov2d_scale_thresh,
              occlusion_bh_thresh=g.occlusion_bh_thresh, tri_lambda2=lc.tri_lambda2,
              chi2_stereo=lc.chi2_stereo, str_chi2_thresh=lc.tri_str_thresh * lc.tri_lambda2,
              chi2_assoc_3d=lc.chi2_assoc_3d, iters=lc.point_opt_iters,
              tri_check_str_chi2=lc.tri_check_str_chi2)
    j = jassoc.associate_and_check_kernel(
        world["jmap"], world["jcam"], jnp.asarray(q, jnp.float32), jnp.asarray(t, jnp.float32),
        jnp.asarray(f.uv), jnp.asarray(f.ur), jnp.asarray(f.octave), jnp.asarray(f.valid),
        jnp.asarray(f.depth), jnp.asarray(s2i), **kw)
    o = tassoc.associate_and_check_kernel(
        world["tmap"], world["tcam"], torch.tensor(q, dtype=torch.float32),
        torch.tensor(t, dtype=torch.float32), torch.tensor(f.uv), torch.tensor(f.ur),
        torch.tensor(f.octave.astype(np.int64)), torch.tensor(f.valid),
        torch.tensor(f.depth), torch.tensor(s2i), **kw)
    np.testing.assert_array_equal(np.asarray(j[0]), o[0].numpy())       # candidates
    np.testing.assert_array_equal(np.asarray(j[1]), o[1].numpy())       # component ids
    assert (o[1] >= 0).sum() > 20
    np.testing.assert_allclose(np.asarray(j[2]), o[2].numpy(), atol=1e-4)


@pytest.mark.parametrize("fn", ["decompose", "degenerate_flags", "sqrt_info", "chi2", "pdf",
                                "bhattacharyya_3d", "bhattacharyya_2d"])
def test_gaussian_helpers_match_reference(fn):
    """The 3-D and 2-D component helpers against the JAX package's on
    seeded float32 covariances (some degenerate), to 1e-5 relative; the
    eigenvalues within 8 eps of each matrix's largest, its inverse and
    determinant within 8 eps times its condition number, the eigenvectors
    up to sign, the flags equal."""
    from gmmloc_tpu.gmm import gaussian as jg

    from gmmloc_tpu_torch.gmm import gaussian as tg

    rng = np.random.default_rng(9)
    n = 32
    A = rng.normal(size=(n, 3, 3))
    scale = np.stack([rng.uniform(1e-6, 1e-3, n), rng.uniform(0.1, 0.5, n),
                      rng.uniform(0.3, 1.0, n)], -1)
    R = np.linalg.qr(A)[0]
    covs = np.einsum("nij,nj,nkj->nik", R, scale, R).astype(np.float32)
    covs_b = np.roll(covs, 1, 0) + np.eye(3, dtype=np.float32) * 0.01
    mean, mean_b = rng.normal(size=(2, n, 3)).astype(np.float32)
    x = (mean + rng.normal(scale=0.3, size=(n, 3))).astype(np.float32)
    j, t = jnp.asarray, torch.tensor
    inv = np.linalg.inv(covs.astype(np.float64)).astype(np.float32)
    det = np.linalg.det(covs.astype(np.float64)).astype(np.float32)
    det_b = np.linalg.det(covs_b.astype(np.float64)).astype(np.float32)
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        np.asarray(b), np.asarray(a), rtol=1e-5, atol=1e-5 * np.abs(np.asarray(a)).max())
    if fn == "decompose":
        a, b = jg.decompose(j(covs)), tg.decompose(t(covs))
        # two float32 solvers part by ~eps times the largest eigenvalue in
        # the eigenvalues and by ~eps times the condition number in the
        # inverse and the determinant
        eps = np.finfo(np.float32).eps
        cond = np.linalg.cond(covs.astype(np.float64))
        ia, ib = np.asarray(a["cov_inv"]), b["cov_inv"].numpy()
        assert (np.abs(ia - ib).max((1, 2)) <= 8 * eps * cond * np.abs(ia).max((1, 2))).all()
        sa, sb = np.asarray(a["scale"]), b["scale"].numpy()
        assert (np.abs(sa - sb) <= 8 * eps * sa[:, 2:]).all()
        da, db = np.asarray(a["det"]), b["det"].numpy()
        assert (np.abs(da - db) <= 8 * eps * cond * np.abs(da)).all()
        dots = np.abs(np.sum(np.asarray(a["axis"]) * b["axis"].numpy(), axis=-2))
        np.testing.assert_allclose(dots, 1.0, atol=1e-3)
        np.testing.assert_allclose(np.abs(np.sum(np.asarray(a["normal"]) * b["normal"].numpy(),
                                                 -1)), 1.0, atol=1e-3)
    elif fn == "degenerate_flags":
        for a, b in zip(jg.degenerate_flags(j(scale)), tg.degenerate_flags(t(scale))):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(jg.degenerate_flags(j(scale))[0]).any()
    elif fn == "sqrt_info":
        spd = inv + np.eye(3, dtype=np.float32) * 1e-2
        close(jg.sqrt_info(j(spd)), tg.sqrt_info(t(spd)))
    elif fn == "chi2":
        close(jg.chi2(j(mean), j(inv), j(x)), tg.chi2(t(mean), t(inv), t(x)))
    elif fn == "pdf":
        c2 = covs_b.astype(np.float32)
        i2 = np.linalg.inv(c2.astype(np.float64)).astype(np.float32)
        close(jg.pdf(j(mean), j(i2), j(det_b), j(x)), tg.pdf(t(mean), t(i2), t(det_b), t(x)))
    elif fn == "bhattacharyya_3d":
        args = (mean, covs, det, mean_b, covs_b, det_b)
        close(jg.bhattacharyya_3d(*map(j, args)), tg.bhattacharyya_3d(*map(t, args)))
        # broadcast pairwise, as the neighbour graph calls it
        pa = (mean[:, None], covs[:, None], det[:, None], mean_b[None], covs_b[None],
              det_b[None])
        close(jg.bhattacharyya_3d(*map(j, pa)), tg.bhattacharyya_3d(*map(t, pa)))
    else:
        c2a, c2b = covs[:, :2, :2] * 100, covs_b[:, :2, :2] * 100
        args = (mean[:, :2], c2a, mean_b[:, :2], c2b)
        close(jg.bhattacharyya_2d(*map(j, args)), tg.bhattacharyya_2d(*map(t, args)))
