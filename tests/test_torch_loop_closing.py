"""The port's loop closer against the JAX package, on the CPU.

The scenario of `tests/test_loop_closing.py` (a place revisited with
0.3 m of accumulated drift, its landmarks duplicated as drifted map
points) is built twice from the same seed, once in each package's
`MapState`, and both packages' `LoopCloser`s run `detect`, `verify` and
`close` on it. Gates: the same loop candidate, inlier counts within 1,
keyframe poses after the closure within 1e-4 m (and 1e-4 in the
quaternion) and landmark positions within 1e-4 m. Then the device-world
mirror equals the host tables after the sync that follows a closure.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gmmloc_tpu import config as jax_config_mod
from gmmloc_tpu.mapping import loop_closing as jlc, map_state as jms
from gmmloc_tpu.tracking import frame as jframe
from gmmloc_tpu.vocab import bow as jbow
from tests.test_world_model import small_cfg

from gmmloc_tpu_torch import config as config_mod
from gmmloc_tpu_torch.eval import reloc_run
from gmmloc_tpu_torch.mapping.device_world import DeviceWorld

torch.set_num_threads(1)


def port_config(jcfg):
    """The port's `SystemConfig` with the field values of the JAX one."""
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(config_mod, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return config_mod.SystemConfig(**kw)


def build(port: bool, seed: int = 42, drift=(0.3, 0.1, 0.0)):
    """The loop-closing scenario in one package. Returns (world, db,
    loop closer, keyframe of the revisit, keyframe of the first visit)."""
    jcfg = small_cfg()
    if port:
        return reloc_run.revisit_scenario(port_config(jcfg), "cpu", seed, drift)
    n = reloc_run.REVISIT_FEATURES
    rng = np.random.default_rng(seed)
    w = jms.MapState(jcfg)
    voc = jbow.Vocabulary.train(rng.integers(0, 256, (1500, 32), dtype=np.uint8),
                                k=8, depth=3)
    db = jbow.KeyFrameDatabase(voc)
    place_desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    lm_pos = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                       np.full(n, 5.0)], -1)

    def add_kf(frame_idx, t_cw, desc, off=np.zeros(3)):
        f = reloc_run.revisit_frame(jframe.make_frame, frame_idx)
        f.desc[:n] = desc
        f.set_pose(np.array([1.0, 0, 0, 0]), np.asarray(t_cw))
        kf = w.alloc_keyframe(f)
        for i in range(n):
            p = w.alloc_point(lm_pos[i] + off, kf, frame_idx)
            w.add_observation(p, kf, i)
        db.add(kf, w.kf_feat_desc[kf], w.kf_feat_valid[kf])
        return kf

    kf0 = add_kf(0, [0.0, 0, 0], place_desc)
    for i in range(1, 4):
        add_kf(i * 40, [i * 0.5, 0, 0], rng.integers(0, 256, (n, 32), dtype=np.uint8))
    drift = np.asarray(drift)
    kf_re = add_kf(200, drift, place_desc, off=drift)
    return w, db, jlc.LoopCloser(jcfg, w, db, min_score=0.01, min_inliers=15), kf_re, kf0


def test_port_config_round_trips():
    cfg = port_config(small_cfg())
    assert isinstance(cfg, config_mod.SystemConfig)
    assert cfg.caps.max_keyframes == 16 and cfg.frame.feat_cap == 64
    assert not isinstance(small_cfg(), config_mod.SystemConfig)
    assert isinstance(small_cfg(), jax_config_mod.SystemConfig)


@pytest.mark.parametrize("drift", [(0.3, 0.1, 0.0), (0.2, -0.15, 0.05)])
def test_loop_closure_matches_reference(drift):
    jw, _, jl, jre, jk0 = build(False, drift=drift)
    tw, _, tl, tre, tk0 = build(True, drift=drift)
    assert (jre, jk0) == (tre, tk0)
    det_j, det_t = jl.detect(jre), tl.detect(tre)
    assert det_j is not None and det_t is not None
    assert det_t[0] == det_j[0] == tk0
    assert abs(det_t[1] - det_j[1]) < 1e-12
    ver_j, ver_t = jl.verify(jre, jk0), tl.verify(tre, tk0)
    assert abs(ver_t[2] - ver_j[2]) <= 1 and ver_t[2] >= 15
    np.testing.assert_allclose(ver_t[0], np.asarray(ver_j[0]), atol=1e-6)
    np.testing.assert_allclose(ver_t[1], ver_j[1], atol=1e-9)

    t_before = tw.kf_t[tre].copy()
    version = tw.map_version
    assert jl.close(jre) and tl.close(tre)
    assert tl.closures == jl.closures == [(tre, tk0)]
    assert tw.map_version == version + 1
    # the revisit keyframe moved by about the drift (the JAX test's check)
    assert np.linalg.norm(tw.kf_t[tre] - t_before) > 0.1
    kfs = np.where(jw.kf_valid)[0]
    np.testing.assert_array_equal(np.where(tw.kf_valid)[0], kfs)
    np.testing.assert_allclose(tw.kf_t[kfs], jw.kf_t[kfs], atol=1e-4)
    np.testing.assert_allclose(tw.kf_q[kfs], jw.kf_q[kfs], atol=1e-4)
    pts = np.where(jw.pt_valid)[0]
    np.testing.assert_array_equal(np.where(tw.pt_valid)[0], pts)
    np.testing.assert_allclose(tw.pt_pos[pts], jw.pt_pos[pts], atol=1e-4)
    assert tw.dirty_pt >= set(pts.tolist())


def test_no_loop_without_a_revisit():
    """Keyframes too close in time (< 3 s) are not loop candidates."""
    tw, _, tl, tre, _ = build(True)
    assert tl.detect(tre) is not None
    version = tw.map_version
    tw.kf_frame_idx[tw.kf_valid] = np.arange(tw.n_keyframes()) * 10
    assert tl.detect(tre) is None and not tl.close(tre)
    assert tl.closures == [] and tw.map_version == version


def test_mirror_equals_host_after_closure_sync():
    """close() moves keyframe poses and points in place and bumps
    map_version; the next sync brings the mirror's pose and point tables
    to the host's."""
    tw, _, tl, tre, _ = build(True)
    mirror = DeviceWorld(tw, "cpu")
    mirror.sync()
    n0 = mirror.n_syncs
    before = mirror.kf_t.clone()
    assert tl.close(tre)
    mirror.sync()
    assert mirror.n_syncs == n0 + 1
    assert not torch.equal(before, mirror.kf_t)
    np.testing.assert_array_equal(mirror.kf_q.numpy(), tw.kf_q.astype(np.float32))
    np.testing.assert_array_equal(mirror.kf_t.numpy(), tw.kf_t.astype(np.float32))
    pts = np.where(tw.pt_valid)[0]
    np.testing.assert_array_equal(mirror.pt_pos.numpy()[pts],
                                  tw.pt_pos[pts].astype(np.float32))
    assert mirror.pt_valid.numpy()[pts].all()
