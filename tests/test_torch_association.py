"""The non-fused keyframe association (`fused_kf_assoc=False`) of the port
against the JAX package, on the CPU.

Both `GMMLocSystem`s run the slice (feat_cap 256 / 240 features, the
room fixture, 30 frames, float32 BA) with `fused_kf_assoc=False`, so
every keyframe takes `associate_keyframe` and
`check_map_association_batch`. Gates: the run as `test_torch_system.py`
holds it (per-frame |dt| < 5 mm and rotation < 0.05 deg, the same
keyframe frames, points within 2%); on the JAX run's last keyframe, the
port's candidate table equals the JAX one exactly, and its association
decisions are equal with points within 1e-4 m. Then the case of
`tests/test_fused_assoc.py` on the port: its fused kernel against its
host chain on its own run.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from gmmloc_tpu.gmm import mixture as jax_mixture
from gmmloc_tpu.mapping import map_state as jms
from gmmloc_tpu.pipeline.system import GMMLocSystem as JaxSystem
from tests.test_torch_system import (_ba_in_f32, _frames, _inverse, _run, jax_config,
                                     slice_config)

from gmmloc_tpu.eval import synthetic as jax_synthetic
from gmmloc_tpu_torch.eval import room_fixture, synthetic
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.mapping.association import GMMAssociator
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

torch.set_num_threads(1)

N_FRAMES = 30


def host_config():
    cfg = slice_config()
    return cfg.replace(loc=dataclasses.replace(cfg.loc, fused_kf_assoc=False))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both systems after N_FRAMES frames with the non-fused association."""
    paths = room_fixture.write_room_fixture(str(tmp_path_factory.mktemp("room")),
                                            n_components=400, n_frames=60, seed=0)
    cfg = host_config()
    kw = dict(pad_to=512, neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
              neighbor_cap=cfg.gmm.neighbor_cap)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _ba_in_f32(mp)
        jcfg = jax_config(cfg)
        frames, q_wc, t_wc = _frames(jax_synthetic, jcfg, paths, N_FRAMES)
        js = JaxSystem(jcfg, jax_mixture.load(paths[0], **kw))
        out["jax"] = (js, _run(js, frames, q_wc, t_wc))
        frames, q_wc, t_wc = _frames(synthetic, cfg, paths, N_FRAMES)
        ts = GMMLocSystem(cfg, mixture.load(paths[0], "cpu", **kw), "cpu")
        out["port"] = (ts, _run(ts, frames, q_wc, t_wc))
    return out


def test_host_association_run_matches_reference(runs):
    (_, ref), (system, out) = runs["jax"], runs["port"]
    assert not system.assoc._fused_check          # nothing went the fused way
    for i, ((qa, ta), (qb, tb)) in enumerate(zip(ref[0], out[0])):
        dt = np.linalg.norm(_inverse(qa, ta)[1] - _inverse(qb, tb)[1])
        drot = np.degrees(2 * np.arccos(min(1.0, abs(float(np.dot(qa, qb))))))
        assert dt < 5e-3 and drot < 0.05, (i, dt, drot)
    assert ref[1] == out[1] and len(ref[1]) > 1
    assert abs(out[2] - ref[2]) <= 0.02 * ref[2], (ref[2], out[2])


def _checkable(w, kf, cam):
    """The features create_map_points_from_stereo would check, and their
    unprojected world points (tests/test_fused_assoc.py's selection)."""
    depth = w.kf_feat_depth[kf]
    sel = np.where(w.kf_feat_valid[kf] & (depth > 0)
                   & (w.kf_comp_cand[kf] >= 0).any(axis=1))[0]
    q_wc, t_wc = jms._inverse(w.kf_q[kf], w.kf_t[kf])
    uv, zs = w.kf_feat_uv[kf][sel], depth[sel]
    pc = np.stack([(uv[:, 0] - cam.cx) / cam.fx * zs,
                   (uv[:, 1] - cam.cy) / cam.fy * zs, zs], -1)
    return sel, pc @ jms._quat_to_mat(q_wc).T + t_wc


def test_association_functions_equal_reference(runs):
    """Both packages' associate_keyframe and check_map_association_batch on
    the same keyframe of the same (JAX) world."""
    js, _ = runs["jax"]
    system, _ = runs["port"]
    kf = js.curr_keyframe
    wj, wt = js.world, copy.deepcopy(js.world)
    port_assoc = GMMAssociator(system.cfg, system.cam, system.gmap, "cpu")
    js.assoc.associate_keyframe(wj, kf)
    port_assoc.associate_keyframe(wt, kf)
    np.testing.assert_array_equal(wt.kf_comp_cand[kf], wj.kf_comp_cand[kf])
    assert kf in wt.dirty_kf
    sel, pw = _checkable(wj, kf, js.cam)
    assert len(sel) > 50, "too few checkable features"
    a_ref, p_ref = js.assoc.check_map_association_batch(wj, kf, sel, pw)
    a_out, p_out = port_assoc.check_map_association_batch(wt, kf, sel, pw)
    np.testing.assert_array_equal(a_out, a_ref)
    np.testing.assert_allclose(p_out, p_ref, atol=1e-4)
    assert (a_ref >= 0).mean() > 0.3 and (a_ref < 0).any()


def test_fused_assoc_matches_host_chain_on_port(runs):
    """tests/test_fused_assoc.py on the port: the fused kernel's candidate
    table is bit-exact with the host chain's, decisions agree on > 97% of
    the features and refined points within 1e-3 m."""
    system, _ = runs["port"]
    w, assoc = system.world, system.assoc
    kf = system.curr_keyframe
    assert kf >= 0 and w.kf_valid[kf]
    assoc.associate_keyframe(w, kf)
    cand_a = w.kf_comp_cand[kf].copy()
    sel, pw = _checkable(w, kf, system.cam)
    assert len(sel) > 50, "degenerate fixture: too few checkable features"
    a_host, p_host = assoc.check_map_association_batch(w, kf, sel, pw)
    assoc.associate_and_check_keyframe(w, kf)
    a_dev, p_dev = assoc._consume_fused_check(w, kf)
    np.testing.assert_array_equal(cand_a, w.kf_comp_cand[kf])
    agree = a_host == a_dev[sel]
    assert agree.mean() > 0.97, agree.mean()
    both = agree & (a_host >= 0)
    assert both.any()
    np.testing.assert_allclose(p_host[both], p_dev[sel][both], atol=1e-3)
