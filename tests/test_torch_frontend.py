"""The port's image front end against the JAX package, module by module, on the CPU.

Inputs are made from numpy seeds and go through both packages:

  - pyramid: levels within 1e-4 abs on [0,255] (the antialiased resize
    weights agree with XLA's compiled ones to an ulp; the two products
    sum in another order); the blur given the same level within 1e-4;
  - FAST + NMS: the plain version of K4 bit-equal to
    `fast.nms3x3(fast.fast_score(.))` and to the Pallas kernel in
    interpret mode, on (480,752) and (96,130);
  - keypoint selection (per cell and octree): identical outputs, ties
    included, on integer score maps;
  - detection given the same pyramid levels: keypoints and octaves
    identical, angles within 1e-2 deg, descriptors bit-identical on >= 99%
    of valid keypoints and within Hamming 8 on the rest;
  - stereo given the same detections: `match_stereo` identical,
    `refine_subpixel` within 1e-3 px, the median cut as `jnp.nanmedian`;
  - equalisation, remap and `Rectifier` (from a yaml the test writes);
  - `ImageFrontend.process_packed` on a sprite pair: the shares of
    keypoints and of stereo matches that agree.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmmloc_tpu.features import detect as jdetect, fast as jfast, orb as jorb
from gmmloc_tpu.features import pallas_kernels, pyramid as jpyr, stereo as jstereo
from gmmloc_tpu.pipeline import frontend as jfrontend, rectify as jrect

from gmmloc_tpu_torch.eval import slice_run, synthetic
from gmmloc_tpu_torch.eval.image_synthetic import SpriteRenderer
from gmmloc_tpu_torch.features import detect, fast, fast_kernels, orb, pyramid, stereo
from gmmloc_tpu_torch.pipeline import frontend, rectify

from test_torch_system import jax_config

torch.set_num_threads(1)

H, W = 480, 752


def _sprite_world(n=3000, seed=7):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(2.0, 10.0, n)], -1)
    return synthetic.SyntheticWorld(
        landmarks=pts, desc=rng.integers(0, 256, (n, 32), dtype=np.uint8),
        base_angle=rng.uniform(0, 360, n).astype(np.float32),
        ref_dist=np.linalg.norm(pts, axis=1).astype(np.float32),
        comp_id=np.full(n, -1, np.int32),
        response=rng.uniform(20, 80, n).astype(np.float32))


def _pair(cfg):
    left, right = SpriteRenderer(_sprite_world(), cfg, seed=1).render_stereo(
        np.array([1.0, 0, 0, 0]), np.zeros(3))
    to8 = lambda im: np.clip(np.round(im), 0, 255).astype(np.uint8)
    return to8(left), to8(right)


@pytest.fixture(scope="module")
def sprite_levels():
    """Both images of a full-size sprite pair and the JAX package's
    pyramids of them (numpy)."""
    cfg = slice_run.image_config()
    left, right = _pair(cfg)
    shapes = tuple(jpyr.level_shapes(H, W, 8, 1.2))
    lv = lambda im: [np.asarray(x) for x in jpyr.build_pyramid(jnp.asarray(im, jnp.float32), shapes)]
    return dict(cfg=cfg, left=left, right=right, levels_l=lv(left), levels_r=lv(right))


def _t(levels):
    return [torch.from_numpy(np.array(x)) for x in levels]


def test_pyramid_and_blur_match_reference():
    img = np.random.default_rng(0).uniform(0, 255, (H, W)).astype(np.float32)
    shapes = tuple(jpyr.level_shapes(H, W, 8, 1.2))
    assert tuple(pyramid.level_shapes(H, W, 8, 1.2)) == shapes
    ref = jpyr.build_pyramid(jnp.asarray(img), shapes)
    out = pyramid.build_pyramid(torch.from_numpy(img), shapes)
    for l, (a, b) in enumerate(zip(ref, out)):
        err = np.abs(np.asarray(a) - b.numpy()).max()
        assert err < 1e-4, (l, err)
        blur_err = np.abs(np.asarray(jpyr.gaussian_blur7(a))
                          - pyramid.gaussian_blur7(torch.from_numpy(np.array(a))).numpy()).max()
        assert blur_err < 1e-4, (l, blur_err)


@pytest.mark.parametrize("shape", [(480, 752), (96, 130)])
def test_fast_nms_plain_bit_equal(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.float32)
    ref = np.asarray(jfast.nms3x3(jfast.fast_score(jnp.asarray(img))))
    pallas = np.asarray(pallas_kernels.fast_score_nms_pallas(jnp.asarray(img), interpret=True))
    out = fast_kernels.fast_score_nms(torch.from_numpy(img)).numpy()   # CPU: the plain version
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, pallas)
    assert (out > 0).sum() > 100


def _integer_scores(seed):
    """NMS'd FAST scores of an integer image (integer-valued, many ties)
    plus a block of equal scores."""
    img = np.random.default_rng(seed).integers(0, 256, (H, W)).astype(np.float32)
    s = np.asarray(jfast.nms3x3(jfast.fast_score(jnp.asarray(img)))).copy()
    s[100:140:3, 200:300:3] = 25.0
    return s


@pytest.mark.parametrize("mode", ["quota", "octree"])
def test_select_keypoints_identical_with_ties(mode):
    s = _integer_scores(3)
    assert np.array_equal(s, np.round(s))
    if mode == "quota":
        ref = jfast.select_keypoints(jnp.asarray(s), cell=24, quota=256, edge=16)
        out = fast.select_keypoints(torch.from_numpy(s), cell=24, quota=256, edge=16)
    else:
        ref = jfast.select_keypoints_octree(jnp.asarray(s), quota=200)
        out = fast.select_keypoints_octree(torch.from_numpy(s), quota=200)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert out[2].sum() > 100


def test_orb_pattern_and_tables_equal():
    np.testing.assert_array_equal(orb.PATTERN, jorb.PATTERN)
    np.testing.assert_array_equal(orb._UMAX, jorb._UMAX)
    np.testing.assert_array_equal(orb.CIRCLE, jorb.CIRCLE)
    assert detect.level_quotas(1200, 8, 1.2) == jdetect.level_quotas(1200, 8, 1.2)


def _check_detections(ref, out, min_valid=300):
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(v, out.valid.numpy())
    np.testing.assert_array_equal(np.asarray(ref.uv), out.uv.numpy())
    np.testing.assert_array_equal(np.asarray(ref.octave), out.octave.numpy())
    np.testing.assert_array_equal(np.asarray(ref.response), out.response.numpy())
    d_ang = np.abs(np.asarray(ref.angle) - out.angle.numpy())[v]
    assert np.minimum(d_ang, 360 - d_ang).max() < 1e-2
    da, db = np.asarray(ref.desc)[v], out.desc.numpy()[v]
    same = (da == db).all(1)
    assert same.mean() >= 0.99, same.mean()
    ham = np.unpackbits(da ^ db, axis=1).sum(1)
    assert ham.max() <= 8
    assert v.sum() > min_valid


def test_detection_given_same_levels(sprite_levels):
    jd = jdetect.ORBDetector(H, W, num_features=1200)
    td = detect.ORBDetector(H, W, num_features=1200, device="cpu")
    ref = jd.detect_from_levels(tuple(jnp.asarray(x) for x in sprite_levels["levels_l"]))
    _check_detections(ref, td.detect_from_levels(_t(sprite_levels["levels_l"])))


def test_pair_detection_given_same_levels(sprite_levels):
    jd = jdetect.ORBDetector(H, W, num_features=1200)
    td = detect.ORBDetector(H, W, num_features=1200, device="cpu")
    jl = [tuple(jnp.asarray(x) for x in sprite_levels[k]) for k in ("levels_l", "levels_r")]
    ref = jd.detect_pair_from_levels(*jl)
    out = td.detect_pair_from_levels(_t(sprite_levels["levels_l"]), _t(sprite_levels["levels_r"]))
    for r, o in zip(ref, out):
        _check_detections(r, o)


def test_stereo_given_same_detections(sprite_levels):
    jd = jdetect.ORBDetector(H, W, num_features=1200)
    jl = [tuple(jnp.asarray(x) for x in sprite_levels[k]) for k in ("levels_l", "levels_r")]
    dl, dr = jd.detect_pair_from_levels(*jl)
    sf = (1.2 ** np.arange(8)).astype(np.float32)
    cam = sprite_levels["cfg"].camera
    bf, base = cam.bf, cam.bf / cam.fx
    best_j, _ = jstereo.match_stereo(dl.uv, dl.octave, dl.desc, dl.valid, dr.uv, dr.octave,
                                     dr.desc, dr.valid, jnp.asarray(sf), bf=bf, min_z=base)
    t = lambda a: torch.from_numpy(np.array(a))
    tl = [t(x) for x in (dl.uv, dl.octave, dl.desc, dl.valid)]
    tr = [t(x) for x in (dr.uv, dr.octave, dr.desc, dr.valid)]
    tl[1], tr[1] = tl[1].to(torch.int64), tr[1].to(torch.int64)
    best_t, _ = stereo.match_stereo(*tl, *tr, torch.from_numpy(sf), bf=bf, min_z=base)
    np.testing.assert_array_equal(np.asarray(best_j), best_t.numpy())
    matched = np.asarray(best_j) >= 0
    assert matched.sum() > 300

    u_r0 = np.where(matched, np.asarray(dr.uv)[np.clip(np.asarray(best_j), 0, None), 0], 0.0)
    u_r0 = u_r0.astype(np.float32)
    rj = jstereo.refine_subpixel(jl[0], jl[1], dl.uv, dl.octave, jnp.asarray(u_r0),
                                 jnp.asarray(matched), jnp.asarray(sf), bf=bf, min_z=base,
                                 n_levels=8)
    rt = stereo.refine_subpixel(_t(sprite_levels["levels_l"]), _t(sprite_levels["levels_r"]),
                                tl[0], tl[1], torch.from_numpy(u_r0), torch.from_numpy(matched),
                                torch.from_numpy(sf), bf=bf, min_z=base)
    good_j, good_t = np.asarray(rj[2]), rt[2].numpy()
    assert (good_j != good_t).sum() <= 2
    both = good_j & good_t
    assert np.abs(np.asarray(rj[0])[both] - rt[0].numpy()[both]).max() < 1e-3
    np.testing.assert_allclose(np.asarray(rj[3]), rt[3].numpy(), rtol=1e-5, atol=1e-3)

    uj, _ = jstereo.compute_stereo_matches(jl[0], jl[1], dl.uv, dl.octave, dl.desc, dl.valid,
                                           dr.uv, dr.octave, dr.desc, dr.valid, sf, bf=bf,
                                           baseline=base, n_levels=8)
    ut, _ = stereo.compute_stereo_matches(_t(sprite_levels["levels_l"]),
                                          _t(sprite_levels["levels_r"]), *tl, *tr, sf,
                                          bf=bf, baseline=base)
    mj, mt = np.asarray(uj) >= 0, ut.numpy() >= 0
    assert (mj != mt).sum() <= 3 and mj.sum() > 300


@pytest.mark.parametrize("n", [0, 1, 6, 7])
def test_masked_median_is_jnp_nanmedian(n):
    rng = np.random.default_rng(n)
    x = rng.uniform(0, 100, 12).astype(np.float32)
    mask = np.zeros(12, bool)
    mask[rng.permutation(12)[:n]] = True
    ref = jnp.nanmedian(jnp.where(jnp.asarray(mask), jnp.asarray(x), jnp.nan))
    ref = float(jnp.where(jnp.isfinite(ref), ref, 0.0))
    out = float(stereo.masked_median(torch.from_numpy(x), torch.from_numpy(mask)))
    assert out == ref


def _write_rect_yaml(path, w=160, h=120):
    """An OpenCV FileStorage yaml of a synthetic stereo calibration."""
    def mat(rows, cols, data):
        vals = ", ".join(f"{v:.10f}" for v in np.ravel(data))
        return f"   !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n   dt: d\n   data:[ {vals} ]\n"
    K = np.array([[150.0, 0, 81.0], [0, 151.0, 59.0], [0, 0, 1]])
    c, s = np.cos(0.02), np.sin(0.02)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    P = np.array([[140.0, 0, 80.0, 0], [0, 140.0, 60.0, 0], [0, 0, 1, 0]])
    txt = "%YAML:1.0\n"
    for side, d in (("LEFT", [-0.28, 0.07, 2e-4, 1.7e-5, 0.0]), ("RIGHT", [-0.27, 0.065, -1e-4, 3e-5])):
        txt += f"{side}.height: {h}\n{side}.width: {w}\n"
        txt += f"{side}.D:{mat(1, len(d), d)}{side}.K:{mat(3, 3, K)}"
        txt += f"{side}.R:{mat(3, 3, R if side == 'LEFT' else R.T)}{side}.P:{mat(3, 4, P)}"
    with open(path, "w") as f:
        f.write(txt)


def test_equalize_remap_and_rectifier(tmp_path):
    rng = np.random.default_rng(5)
    img = np.clip(rng.normal(90, 30, (H, W)), 0, 255).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jrect.equalize_hist(jnp.asarray(img))),
                                  rectify.equalize_hist(torch.from_numpy(img)).numpy())
    path = str(tmp_path / "rect.yaml")
    _write_rect_yaml(path)
    jr, tr = jrect.Rectifier(path), rectify.Rectifier(path, device="cpu")
    small = np.clip(rng.uniform(0, 255, (120, 160)), 0, 255).astype(np.float32)
    for side in ("LEFT", "RIGHT"):
        for a, b in zip(jr.maps[side], tr.maps[side]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        mx, my = tr.maps[side]
        assert float((mx - torch.arange(160)).abs().max()) > 0.5   # a real warp
        ref = np.asarray(jrect.remap_bilinear(jnp.asarray(small), *jr.maps[side]))
        out = rectify.remap_bilinear(torch.from_numpy(small), mx, my).numpy()
        assert np.abs(ref - out).max() < 1e-3
    np.testing.assert_allclose(np.asarray(jr.rectify_left(small)),
                               tr.rectify_left(torch.from_numpy(small)).numpy(), atol=1e-3)


def test_process_packed_matches_reference():
    """The one-pass front end of both packages on one sprite pair, with
    histogram equalisation on. The pyramids differ in the last ulps (the
    resize products' summation order), which moves angles and flips some
    descriptor bits, so the tolerance is a share: >= 98% of keypoints
    equal, stereo matched/unmatched agreeing on >= 97%, and the agreeing
    matches' u_right within 0.05 px. The port's per-stage path equals its
    own one-pass path."""
    cfg = slice_run.image_config(feat_cap=640, num_features=600)
    cfg = cfg.replace(camera=dataclasses.replace(cfg.camera, do_equalization=True))
    left, right = _pair(cfg)
    ref = jfrontend.ImageFrontend(jax_config(cfg)).process_packed(0, 0.0, left, right)
    fe = frontend.ImageFrontend(cfg, device="cpu")
    out = fe.process_packed(0, 0.0, left, right)
    n = cfg.frame.num_features
    assert out.valid[:n].sum() > 400
    same = (np.abs(ref.uv[:n] - out.uv[:n]).max(1) < 1e-3) & ref.valid[:n]
    assert same.sum() >= 0.98 * ref.valid[:n].sum()
    mr, mo = ref.ur[:n] >= 0, out.ur[:n] >= 0
    assert mr.sum() > 100 and (mr == mo).mean() >= 0.97
    both = mr & mo & same
    assert np.abs(ref.ur[:n][both] - out.ur[:n][both]).max() < 0.05
    per_stage = fe.process(0, 0.0, left, right)
    for k in ("uv", "ur", "depth", "octave", "desc", "valid"):
        np.testing.assert_array_equal(getattr(per_stage, k), getattr(out, k), err_msg=k)
    # atan2 over another tensor length takes another vector/scalar split
    # on the CPU: angles may move by an ulp
    np.testing.assert_allclose(per_stage.angle, out.angle, atol=1e-4)
