"""The port's checkpoint/resume against the JAX package's, on the CPU.

`tests/test_checkpoint.py::test_checkpoint_roundtrip`'s world in the
port; files cross-load between the packages (one format: an `.npz` of
the world's tables and a JSON side record) with every array equal; and
after a load, a `DeviceWorld` mirror re-uploads every live row at its
next sync.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gmmloc_tpu import config as jax_config_mod
from gmmloc_tpu.mapping import map_state as jms
from gmmloc_tpu.pipeline import checkpoint as jax_checkpoint
from gmmloc_tpu.tracking import frame as jframe
from tests.test_world_model import small_cfg

from gmmloc_tpu_torch import config as config_mod
from gmmloc_tpu_torch.mapping import map_state as ms
from gmmloc_tpu_torch.mapping.device_world import DeviceWorld
from gmmloc_tpu_torch.pipeline import checkpoint
from gmmloc_tpu_torch.tracking import frame as tframe

torch.set_num_threads(1)


def port_config(jcfg):
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(config_mod, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return config_mod.SystemConfig(**kw)


def _test_frame(frame_mod, idx, n=32):
    """`tests/test_world_model.make_test_frame` in either package."""
    rng = np.random.default_rng(idx)
    uv = rng.uniform([0, 0], [752, 480], (n, 2))
    return frame_mod.make_frame(
        idx, idx * 0.05, uv, uv[:, 0] - 8.0, np.full(n, 6.0), rng.integers(0, 8, n),
        rng.uniform(0, 360, n), rng.integers(0, 256, (n, 32), dtype=np.uint8), 64)


def _world(port: bool):
    """The round-trip test's world: two keyframes, 20 points seen by both,
    one tracked frame; some associations, one vetted."""
    mod, fmod = (ms, tframe) if port else (jms, jframe)
    cfg = port_config(small_cfg()) if port else small_cfg()
    w = mod.MapState(cfg)
    kf0 = w.alloc_keyframe(_test_frame(fmod, 0))
    kf1 = w.alloc_keyframe(_test_frame(fmod, 1))
    for i in range(20):
        p = w.alloc_point([i, 0.0, 5.0], kf0, 0)
        w.add_observation(p, kf0, i)
        w.add_observation(p, kf1, i)
    w.pt_assoc_comp[:5] = np.arange(5)
    w.pt_assoc_vetted[:3] = True
    w.update_connections(kf0)
    fr = _test_frame(fmod, 2)
    fr.ref_kf = kf0
    w.update_frame_info(fr)
    return w


def _assert_worlds_equal(a, b, vetted=True):
    for f in checkpoint._ARRAY_FIELDS + (["pt_assoc_vetted"] if vetted else []):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert list(a._free_kf) == list(b._free_kf) and list(a._free_pt) == list(b._free_pt)
    assert a._kf_order == b._kf_order and a.max_kf_frame_idx == b.max_kf_frame_idx
    assert len(a.frame_infos) == len(b.frame_infos)
    for x, y in zip(a.frame_infos, b.frame_infos):
        assert (x.timestamp, x.ref_kf) == (y.timestamp, y.ref_kf)
        np.testing.assert_array_equal(x.q_cr, y.q_cr)
        np.testing.assert_array_equal(x.t_cr, y.t_cr)


def test_checkpoint_roundtrip(tmp_path):
    w = _world(port=True)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_checkpoint(path, w, frame_cursor=3, extra={"seq": "V1"})
    w2 = ms.MapState(w.cfg)
    cursor, extra = checkpoint.load_checkpoint(path, w2)
    assert cursor == 3 and extra["seq"] == "V1"
    np.testing.assert_array_equal(w.kf_obs_point, w2.kf_obs_point)
    np.testing.assert_array_equal(w.pt_pos, w2.pt_pos)
    np.testing.assert_array_equal(w.covis, w2.covis)
    assert w._kf_order == w2._kf_order
    assert len(w2.frame_infos) == 1
    w2.check_invariants()
    _assert_worlds_equal(w, w2)
    np.testing.assert_allclose(w.export_trajectory()[2], w2.export_trajectory()[2])
    # the loaded world goes on: a new keyframe takes the next free slot
    assert w2.alloc_keyframe(_test_frame(tframe, 3)) == w.alloc_keyframe(_test_frame(tframe, 3))


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoint_cross_loads(tmp_path, saver):
    """A file written by either package loads into the other's MapState
    with every array equal. The JAX package does not write
    `pt_assoc_vetted`, so a JAX file leaves those flags as they were."""
    src = _world(port=saver == "port")
    path = str(tmp_path / "ckpt.npz")
    (checkpoint if saver == "port" else jax_checkpoint).save_checkpoint(
        path, src, frame_cursor=7)
    for port in (True, False):
        dst = (ms if port else jms).MapState(port_config(small_cfg()) if port else small_cfg())
        cursor, _ = (checkpoint if port else jax_checkpoint).load_checkpoint(path, dst)
        assert cursor == 7
        _assert_worlds_equal(src, dst, vetted=saver == "port" and port)
        if not (saver == "port" and port):
            assert not dst.pt_assoc_vetted.any()
        for a, b in zip(src.export_trajectory(), dst.export_trajectory()):
            np.testing.assert_array_equal(a, b)


def test_load_reuploads_the_mirror(tmp_path):
    """After a load every live row is dirty and the map version moved on,
    so the next sync writes the whole world into a mirror that had seen
    another state."""
    w = _world(port=True)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_checkpoint(path, w, frame_cursor=3)

    w2 = ms.MapState(w.cfg)
    mirror = DeviceWorld(w2, "cpu")
    mirror.sync()
    version = w2.map_version
    checkpoint.load_checkpoint(path, w2)
    assert w2.map_version == version + 1
    assert w2.dirty_kf == set(np.where(w.kf_valid)[0].tolist())
    assert w2.dirty_pt == set(np.where(w.pt_valid)[0].tolist())
    mirror.sync()
    assert not w2.dirty_kf and not w2.dirty_pt
    kfs, pts = np.where(w.kf_valid)[0], np.where(w.pt_valid)[0]
    host = lambda a: a.cpu().numpy()
    np.testing.assert_array_equal(host(mirror.kf_q)[kfs], w.kf_q[kfs].astype(np.float32))
    np.testing.assert_array_equal(host(mirror.kf_t)[kfs], w.kf_t[kfs].astype(np.float32))
    for name in ("kf_feat_uv", "kf_feat_ur", "kf_feat_desc", "kf_feat_octave",
                 "kf_feat_angle", "kf_feat_depth", "kf_comp_cand", "kf_feat_valid"):
        np.testing.assert_array_equal(host(getattr(mirror, name))[kfs],
                                      getattr(w, name)[kfs], err_msg=name)
    for name in ("pt_pos", "pt_normal", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_array_equal(host(getattr(mirror, name))[pts],
                                      getattr(w, name)[pts].astype(np.float32), err_msg=name)
    for name in ("pt_desc", "pt_obs_kf", "pt_obs_feat", "pt_valid"):
        np.testing.assert_array_equal(host(getattr(mirror, name))[pts],
                                      getattr(w, name)[pts], err_msg=name)
    np.testing.assert_array_equal(host(mirror.pt_acomp)[pts], w.pt_assoc_comp[pts])
    comp = np.where(w.pt_assoc_vetted, w.pt_assoc_comp, -1).astype(np.float32)
    np.testing.assert_array_equal(host(mirror.pt_comp)[pts], comp[pts])
    assert (host(mirror.pt_comp)[pts] >= 0).sum() == 3
