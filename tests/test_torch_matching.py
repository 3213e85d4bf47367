"""Matching against the JAX package: the Hamming matrix (K3's plain
version) bit-exact against `matching._hamming_matrix_xla`, every guided
search the slice runs exact in its indices, on seeded scenes, and the
fundamental matrix."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmmloc_tpu.features import matching as jm

from gmmloc_tpu_torch.features import cuda_kernels, matching as tm

torch.set_num_threads(1)


def _desc_pair(rng, n, m, flips=8):
    """m feature descriptors; the n queries copy some of them with bit
    flips, the rest are random."""
    b = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    a = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    src = rng.integers(0, m, n)
    near = rng.random(n) < 0.7
    a[near] = b[src[near]]
    for _ in range(flips):
        byte = rng.integers(0, 32, n)
        a[np.arange(n), byte] ^= (1 << rng.integers(0, 8, n)).astype(np.uint8)
    return a, b, src


@pytest.mark.parametrize("shape", [(1, 1), (37, 100), (256, 256), (1024, 256)])
def test_hamming_plain_bit_exact(shape):
    rng = np.random.default_rng(shape[0])
    a, b, _ = _desc_pair(rng, *shape)
    ref = np.asarray(jm._hamming_matrix_xla(jnp.asarray(a), jnp.asarray(b)))
    out = cuda_kernels.hamming_matrix(torch.tensor(a), torch.tensor(b))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(ref, out.numpy())


def test_hamming_wrapper_raises_without_kernel():
    a = torch.zeros(4, 32, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        cuda_kernels.hamming_matrix(a, a)


def _scene(seed, n=300, m=256):
    rng = np.random.default_rng(seed)
    a, b, src = _desc_pair(rng, n, m)
    f_uv = rng.uniform([0, 0], [752, 480], (m, 2))
    q_uv = f_uv[src] + rng.normal(0, 3.0, (n, 2))
    f_ur = np.where(rng.random(m) < 0.8, f_uv[:, 0] - rng.uniform(2, 40, m), -1.0)
    q_ur = np.where(rng.random(n) < 0.8, f_ur[src] + rng.normal(0, 2, n), -1.0)
    f_oct = rng.integers(0, 8, m)
    q_oct = np.clip(f_oct[src] + rng.integers(-1, 2, n), 0, 7)
    f_ang = rng.uniform(0, 360, m)
    q_ang = (f_ang[src] + 12.0 + rng.normal(0, 4, n)) % 360.0
    return dict(
        proj_uv=q_uv.astype(np.float32), proj_ur=q_ur.astype(np.float32),
        query_desc=a, query_octave=q_oct.astype(np.int32),
        query_angle=q_ang.astype(np.float32), query_valid=rng.random(n) < 0.95,
        radius=(7.0 * 1.2 ** q_oct).astype(np.float32),
        level_lo=(q_oct - 1).astype(np.int32), level_hi=(q_oct + 1).astype(np.int32),
        feat_uv=f_uv.astype(np.float32), feat_ur=f_ur.astype(np.float32),
        feat_desc=b, feat_octave=f_oct.astype(np.int32),
        feat_angle=f_ang.astype(np.float32), feat_valid=rng.random(m) < 0.97,
        feat_taken=rng.random(m) < 0.1,
    )


def _both(d):
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {}
    for k, v in d.items():
        v = np.asarray(v)
        t[k] = torch.tensor(v.astype(np.int64) if v.dtype == np.int32 else v)
    return j, t


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["motion", "local"])
def test_search_by_projection_exact(seed, mode):
    d = _scene(seed)
    kw = (dict(desc_thresh=jm.TH_HIGH, nn_ratio=1.0, use_rotation=True)
          if mode == "motion" else
          dict(desc_thresh=jm.TH_HIGH, nn_ratio=0.8, use_rotation=False))
    j, t = _both(d)
    rm, rd = jm.search_by_projection(**j, **kw)
    om, od = tm.search_by_projection(**t, **kw)
    np.testing.assert_array_equal(np.asarray(rm), om.numpy())
    np.testing.assert_array_equal(np.asarray(rd), od.numpy())
    assert (om >= 0).sum() > 20


def test_search_by_projection_with_shared_distance_matrix():
    d = _scene(5)
    j, t = _both(d)
    dist_j = jm._hamming_matrix_xla(j["query_desc"], j["feat_desc"])
    dist_t = tm.hamming_matrix(t["query_desc"], t["feat_desc"])
    rm, _ = jm.search_by_projection(**j, use_rotation=True, dist_precomputed=dist_j)
    om, _ = tm.search_by_projection(**t, use_rotation=True, dist_precomputed=dist_t)
    np.testing.assert_array_equal(np.asarray(rm), om.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_consistency_mask_exact(seed):
    rng = np.random.default_rng(seed)
    n = 500
    a = rng.uniform(0, 360, n).astype(np.float32)
    b = ((a - np.where(rng.random(n) < 0.7, 25.0, rng.uniform(0, 360, n))) % 360).astype(np.float32)
    matched = rng.random(n) < 0.8
    ref = jm.rotation_consistency_mask(jnp.asarray(a), jnp.asarray(b), jnp.asarray(matched))
    out = tm.rotation_consistency_mask(torch.tensor(a), torch.tensor(b), torch.tensor(matched))
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


def test_mutual_best_match_exact():
    rng = np.random.default_rng(3)
    a, b, _ = _desc_pair(rng, 256, 200, flips=4)
    va, vb = rng.random(256) < 0.9, rng.random(200) < 0.9
    r = jm.mutual_best_match(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb))
    o = tm.mutual_best_match(torch.tensor(a), torch.tensor(va), torch.tensor(b), torch.tensor(vb))
    for x, y in zip(r, o):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def _tri_scene(seed, n=256, t=3):
    rng = np.random.default_rng(seed)
    a, b, _ = _desc_pair(rng, n, n, flips=3)
    kf2 = dict(
        uv2=rng.uniform([0, 0], [752, 480], (t, n, 2)).astype(np.float32),
        ur2=np.where(rng.random((t, n)) < 0.5, 300.0, -1.0).astype(np.float32),
        desc2=np.stack([np.roll(b, i, 0) for i in range(t)]),
        octave2=rng.integers(0, 8, (t, n)).astype(np.int32),
        angle2=rng.uniform(0, 360, (t, n)).astype(np.float32),
        free2=rng.random((t, n)) < 0.9,
        fmat=(rng.normal(size=(t, 3, 3)) * [1e-6, 1e-6, 1e-3]).astype(np.float32),
        epipole2=rng.uniform(0, 700, (t, 2)).astype(np.float32),
    )
    kf1 = dict(
        uv1=rng.uniform([0, 0], [752, 480], (n, 2)).astype(np.float32),
        ur1=np.where(rng.random(n) < 0.5, 300.0, -1.0).astype(np.float32),
        desc1=a, octave1=rng.integers(0, 8, n).astype(np.int32),
        angle1=rng.uniform(0, 360, n).astype(np.float32), free1=rng.random(n) < 0.9,
    )
    sigma2 = (1.2 ** (2 * np.arange(8))).astype(np.float32)
    return kf1, kf2, sigma2


def test_search_for_triangulation_batch_exact():
    kf1, kf2, sigma2 = _tri_scene(0)
    order = ["uv1", "ur1", "desc1", "octave1", "angle1", "free1", "uv2", "ur2",
             "desc2", "octave2", "angle2", "free2", "fmat", "epipole2"]
    d = {**kf1, **kf2, "sigma2": sigma2}
    j, t = _both(d)
    ref = jm.search_for_triangulation_batch(*[j[k] for k in order], j["sigma2"])
    out = tm.search_for_triangulation_batch(*[t[k] for k in order], t["sigma2"])
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    assert (out >= 0).sum() > 0


def test_fuse_match_batch_exact():
    rng = np.random.default_rng(4)
    T, P, M = 3, 256, 256
    scenes = [_scene(10 + i, n=P, m=M) for i in range(T)]
    st = lambda k: np.stack([s[k] for s in scenes])
    d = dict(
        proj_uv=st("proj_uv"), proj_ur=st("proj_ur"), pt_desc=st("query_desc"),
        pred_level=st("query_octave"), radius=st("radius"), pt_valid=st("query_valid"),
        feat_uv=st("feat_uv"), feat_ur=st("feat_ur"), feat_desc=st("feat_desc"),
        feat_octave=st("feat_octave"), feat_valid=st("feat_valid"),
        sigma2_inv=(1.0 / 1.2 ** (2 * np.arange(8))).astype(np.float32),
    )
    d["proj_uv"] = (d["proj_uv"] + rng.normal(0, 0.5, d["proj_uv"].shape)).astype(np.float32)
    j, t = _both(d)
    ref = jm.fuse_match_batch(*j.values())
    out = tm.fuse_match_batch(*t.values())
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    assert (out >= 0).sum() > 0


def test_fundamental_matrix_matches_reference():
    """F with l2 = F^T p1 on seeded pose pairs, to 1e-5 relative; the
    epipolar constraint holds on a projected point pair."""
    from gmmloc_tpu.config import euroc_v1_config

    rng = np.random.default_rng(7)
    c = euroc_v1_config().camera
    K = np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1]], np.float32)
    for _ in range(4):
        q = rng.normal(size=(2, 4))
        q[:, 0] += 4.0
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        t = rng.normal(scale=0.3, size=(2, 3))
        args = [q[0], t[0], q[1], t[1], K, K]
        ref = np.asarray(jm.fundamental_matrix(*(jnp.asarray(np.float32(a)) for a in args)))
        out = tm.fundamental_matrix(*(torch.tensor(np.float32(a)) for a in args)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
