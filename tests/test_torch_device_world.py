"""The device-world mirror and the mapping programs that gather from it,
against the JAX package on the CPU.

  - the mirror: after seeded mutations of one `MapState` (new keyframes,
    new points, a BA-style write-back, association vetting, culling) the
    port's `DeviceWorld` equals the host tables and the JAX package's
    `DeviceWorld` on the same state, field by field and exactly;
  - the gathers, `triangulate_kernel` and `assemble_and_solve` on inputs
    captured from the port's own production run (offline, depth 4,
    feat_cap=256, the 400-component room fixture): the triangulation and
    fusion searches exactly; the fused triangulation's winners exactly,
    its points within 1e-4 m; the BA problem's gathered tables exactly,
    and with float32 BA products on both sides the solved cameras within
    1 mm / 0.01 deg and the points within 1 mm;
  - `_dlt_null` against an SVD null vector.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmmloc_tpu.geometry import camera as jcam
from gmmloc_tpu.features import matching as jmatching
from gmmloc_tpu.mapping import ba_assemble as jba
from gmmloc_tpu.mapping import tri_kernel as jtri
from gmmloc_tpu.mapping.device_world import DeviceWorld as JaxDeviceWorld
from gmmloc_tpu.solver import local_ba as jlocal_ba

from gmmloc_tpu_torch.config import euroc_v1_config
from gmmloc_tpu_torch.eval import room_fixture, slice_run, synthetic
from gmmloc_tpu_torch.features import matching
from gmmloc_tpu_torch.geometry import camera as cam_mod
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.mapping import ba_assemble, map_state as ms, tri_kernel
from gmmloc_tpu_torch.mapping.device_world import DeviceWorld
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
from gmmloc_tpu_torch.solver import local_ba
from gmmloc_tpu_torch.tracking.frame import make_frame

torch.set_num_threads(1)

FIELDS = ("kf_feat_uv", "kf_feat_ur", "kf_feat_desc", "kf_feat_octave", "kf_feat_angle",
          "kf_feat_valid", "kf_feat_depth", "kf_comp_cand", "pt_pos", "pt_normal",
          "pt_min_dist", "pt_max_dist", "pt_desc", "pt_obs_kf", "pt_obs_feat",
          "pt_valid", "pt_comp", "pt_acomp", "kf_q", "kf_t")


# ---------------------------------------------------------------------------
# the mirror
# ---------------------------------------------------------------------------


def _small_cfg():
    cfg = euroc_v1_config()
    return cfg.replace(caps=dataclasses.replace(cfg.caps, max_keyframes=16,
                                                max_points=2048),
                       frame=dataclasses.replace(cfg.frame, feat_cap=128))


def _add_keyframe(w, cam, rng, k, n=100):
    uv = rng.uniform([20, 20], [cam.width - 20, cam.height - 20], (n, 2))
    z = rng.uniform(2.0, 9.0, n).astype(np.float32)
    ur = (uv[:, 0] - cam.bf / z).astype(np.float32)
    ur[rng.random(n) < 0.2] = -1.0
    f = make_frame(k, float(k), uv, ur, z, rng.integers(0, 8, n), rng.uniform(0, 360, n),
                   rng.integers(0, 256, (n, 32), dtype=np.uint8), w.F)
    q = np.array([1.0, *rng.normal(0, 0.02, 3)])
    f.set_pose(q / np.linalg.norm(q), rng.normal(0, 0.3, 3))
    kf = w.alloc_keyframe(f)
    w.kf_comp_cand[kf, :n] = rng.integers(-1, 50, (n, w.kf_comp_cand.shape[2]))
    w.dirty_kf.add(kf)
    return kf


def _add_points(w, rng, kfs, n):
    pids = []
    for _ in range(n):
        p = w.alloc_point(rng.normal(0, 2, 3), ref_kf=kfs[0], created_kf_idx=0)
        w.pt_desc[p] = rng.integers(0, 256, 32, dtype=np.uint8)
        for k in rng.choice(kfs, size=min(2, len(kfs)), replace=False):
            w.add_observation(p, int(k), int(rng.integers(0, 100)))
        pids.append(p)
    pids = np.array(pids)
    w.update_normal_and_depth_batch(pids)
    return pids


def _check_mirror(w, port, ref):
    for name in FIELDS:
        a = getattr(port, name).numpy()
        b = np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # and the host tables themselves
    np.testing.assert_array_equal(port.pt_pos.numpy(), w.pt_pos.astype(np.float32))
    np.testing.assert_array_equal(port.kf_feat_desc.numpy(), w.kf_feat_desc)
    np.testing.assert_array_equal(port.pt_valid.numpy(), w.pt_valid)
    np.testing.assert_array_equal(
        port.pt_comp.numpy(),
        np.where(w.pt_assoc_vetted, w.pt_assoc_comp, -1).astype(np.float32))


def _sync_both(w, port, ref):
    """Both mirrors consume the same dirty rows."""
    dk, dp = set(w.dirty_kf), set(w.dirty_pt)
    port.sync()
    assert not w.dirty_kf and not w.dirty_pt
    w.dirty_kf |= dk
    w.dirty_pt |= dp
    ref.sync()
    _check_mirror(w, port, ref)


def test_mirror_matches_host_and_reference():
    cfg = _small_cfg()
    cam = cam_mod.CameraParams.from_config(cfg.camera)
    rng = np.random.default_rng(3)
    w = ms.MapState(cfg)
    port, ref = DeviceWorld(w, "cpu"), JaxDeviceWorld(w)
    kfs = [_add_keyframe(w, cam, rng, k) for k in range(3)]
    pids = _add_points(w, rng, kfs, 300)
    _sync_both(w, port, ref)
    n = port.n_syncs
    port.sync()
    assert port.n_syncs == n            # nothing dirty, same map version: no-op

    # a new keyframe and new points observed by it
    kfs.append(_add_keyframe(w, cam, rng, 3))
    pids = np.concatenate([pids, _add_points(w, rng, kfs[-2:], 150)])
    _sync_both(w, port, ref)
    # BA-style write-back: poses and positions in place, associations vetted
    sel = pids[rng.random(len(pids)) < 0.3]
    w.pt_pos[sel] += rng.normal(0, 0.01, (len(sel), 3))
    w.kf_q[kfs[1]] = [0.999, 0.01, -0.02, 0.03]
    w.pt_assoc_comp[sel] = rng.integers(0, 50, len(sel))
    w.pt_assoc_vetted[sel[::2]] = True
    w.map_version += 1
    w.dirty_pt.update(sel.tolist())
    _sync_both(w, port, ref)
    # culling: points and a keyframe go
    for p in pids[:40]:
        w.remove_point(int(p))
    w.remove_keyframe(kfs[2])
    _sync_both(w, port, ref)
    # the tracker's view is the published state
    pos, valid, comp = port.read_for_tracking()
    assert pos is port.pt_pos and valid is port.pt_valid and comp is port.pt_comp


# ---------------------------------------------------------------------------
# captured mapping inputs
# ---------------------------------------------------------------------------


def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    return copy.deepcopy(v)


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    """The last call of each mapping program in a 20-frame production
    run of the port (offline, depth 4), with every argument cloned."""
    from test_torch_system import _frames

    d = tmp_path_factory.mktemp("room")
    paths = room_fixture.write_room_fixture(str(d), 400, 40, seed=0)
    cfg = slice_run.production_config(False, feat_cap=256, num_features=240,
                                      local_map_cap=1024)
    frames, q_wc, t_wc = _frames(synthetic, cfg, paths, 20)
    gmap = mixture.load(paths[0], "cpu", pad_to=512,
                        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
                        neighbor_cap=cfg.gmm.neighbor_cap)
    system = GMMLocSystem(cfg, gmap, "cpu")
    calls = {}

    def recorder(mod, name):
        orig = getattr(mod, name)

        def record(*args, **kw):
            calls[name] = ([_clone(a) for a in args], {k: _clone(v) for k, v in kw.items()})
            return orig(*args, **kw)

        return record

    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((tri_kernel, "triangulate_kernel"),
                          (matching, "search_for_triangulation_gather"),
                          (matching, "fuse_project_match_gather"),
                          (ba_assemble, "assemble_and_solve")):
            mp.setattr(mod, name, recorder(mod, name))
        for i, f in enumerate(frames):
            system.step(f, q_wc[i], t_wc[i])
        system.flush()
    assert sorted(calls) == ["assemble_and_solve", "fuse_project_match_gather",
                             "search_for_triangulation_gather", "triangulate_kernel"]
    return calls


def _jx(v):
    if isinstance(v, torch.Tensor):
        a = v.numpy()
        return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
    if isinstance(v, bool):
        return jnp.asarray(v)
    if isinstance(v, int):
        return jnp.int32(v)
    return v


def test_triangulation_search_gather_matches_reference(captured):
    args, kw = captured["search_for_triangulation_gather"]
    out = matching.search_for_triangulation_gather(*args, **kw).numpy()
    ref = np.asarray(jmatching.search_for_triangulation_gather(*map(_jx, args)))
    np.testing.assert_array_equal(out, ref)
    assert (out >= 0).sum() > 20


def test_fuse_gather_matches_reference(captured):
    args, kw = captured["fuse_project_match_gather"]
    cam = args[0]
    out = matching.fuse_project_match_gather(*args, **kw).numpy()
    ref = np.asarray(jmatching.fuse_project_match_gather(
        jcam.CameraParams(*cam), *map(_jx, args[1:-1]), jnp.float32(args[-1]), **kw))
    np.testing.assert_array_equal(out, ref)
    assert (out >= 0).sum() > 20


def test_triangulate_kernel_matches_reference(captured):
    args, kw = captured["triangulate_kernel"]
    out = [x.numpy() for x in tri_kernel.triangulate_kernel(*args, **kw)]
    ref = [np.asarray(x) for x in jtri.triangulate_kernel(
        jcam.CameraParams(*args[0]), *map(_jx, args[1:]), **kw)]
    win, idx1, idx2, pair_t, pts, has_str, str_comp, from_mono, n_m = out
    assert int(n_m) == int(ref[8]) and int(n_m) > 10
    for name, a, b in (("win", win, ref[0]), ("idx1", idx1, ref[1]),
                       ("idx2", idx2, ref[2]), ("pair_t", pair_t, ref[3]),
                       ("from_mono", from_mono, ref[7])):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(has_str[win], ref[5][win])
    np.testing.assert_array_equal(str_comp[win], ref[6][win])
    np.testing.assert_allclose(pts[win], ref[4][win], rtol=0, atol=1e-4)
    assert win.sum() > 5


def test_dlt_null_matches_svd():
    """The adjugate null vector against the float64 SVD's on realistic
    two-view systems, and against the JAX package's on the same float32
    systems."""
    from test_fused_tri import _make_dlt_systems

    A, X = _make_dlt_systems(np.random.default_rng(0), 256)
    v = tri_kernel._dlt_null(torch.tensor(A, dtype=torch.float32)).numpy()
    pts = v[:, :3] / v[:, 3:4]
    _, _, Vt = np.linalg.svd(A)
    vs = Vt[:, 3]
    pts_svd = vs[:, :3] / vs[:, 3:4]
    err = np.linalg.norm(pts - pts_svd, axis=1)
    assert np.median(err) < 2e-2 and (err < 8e-2).mean() > 0.95
    e_adj = np.median(np.linalg.norm(pts - X, axis=1))
    e_svd = np.median(np.linalg.norm(pts_svd - X, axis=1))
    assert e_adj < 1.2 * e_svd + 5e-3, (e_adj, e_svd)
    vj = np.asarray(jtri._dlt_null(jnp.asarray(A, jnp.float32)))
    pj = vj[:, :3] / vj[:, 3:4]
    np.testing.assert_allclose(pts, pj, rtol=0, atol=1e-3)


def _jax_ba_args(args, kw, P):
    cam = jcam.CameraParams(*args[0])
    jargs = [_jx(a) for a in args[1:]]
    jkw = dict(kw, n_pts=P, cg_iters=48)
    return cam, jargs, jkw


def test_assemble_and_solve_matches_reference(captured, monkeypatch):
    args, kw = captured["assemble_and_solve"]
    P = args[3].shape[0]
    prob, obs_kfid, n_obs_pt = ba_assemble.assemble_problem(
        *args[1:], n_free=kw["n_free"], n_cams=kw["n_cams"], mo=kw["mo"])

    # the JAX package's problem, as its assemble_and_solve builds it
    grabbed = {}
    monkeypatch.setattr(jlocal_ba, "solve_local_ba",
                        lambda cam, prob, **k: grabbed.setdefault("prob", prob))
    cam, jargs, jkw = _jax_ba_args(args, kw, P)
    with jax.disable_jit():
        _, j_obs_kfid, j_n_obs = jba.assemble_and_solve(cam, *jargs, **jkw)
    monkeypatch.undo()
    jprob = grabbed["prob"]
    np.testing.assert_array_equal(obs_kfid.numpy(), np.asarray(j_obs_kfid))
    np.testing.assert_array_equal(n_obs_pt.numpy(), np.asarray(j_n_obs))
    for name in prob._fields:
        a = getattr(prob, name).numpy()
        b = np.asarray(getattr(jprob, name))
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)
    assert int(prob.pt_valid.sum()) > 100 and int(prob.obs_valid.sum()) > 300

    # the solve, float32 products on both sides
    solve_kw = {k: v for k, v in kw.items() if k not in ("n_free", "n_cams", "mo")}
    res = local_ba.solve_local_ba(args[0], prob, n_free=kw["n_free"], use_bf16=False,
                                  **solve_kw)
    jres = jlocal_ba.solve_local_ba(cam, jprob, n_free=kw["n_free"], use_bf16=False,
                                    **solve_kw)
    ok = prob.cam_valid.numpy()[:kw["n_free"]]
    qa, qb = res.cam_q.numpy()[:kw["n_free"]][ok], np.asarray(jres.cam_q)[:kw["n_free"]][ok]
    dq = np.abs(np.sum(qa * qb, 1)) / np.linalg.norm(qa, axis=1) / np.linalg.norm(qb, axis=1)
    assert np.degrees(2 * np.arccos(np.minimum(1.0, dq))).max() < 0.01
    np.testing.assert_allclose(res.cam_t.numpy()[:kw["n_free"]][ok],
                               np.asarray(jres.cam_t)[:kw["n_free"]][ok], rtol=0, atol=1e-3)
    pv = prob.pt_valid.numpy()
    np.testing.assert_allclose(res.pts.numpy()[pv], np.asarray(jres.pts)[pv], rtol=0,
                               atol=1e-3)
