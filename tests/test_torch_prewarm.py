"""The port's prewarm (`gmmloc_tpu_torch/pipeline/prewarm.py`) against the
JAX package's `gmmloc_tpu/pipeline/prewarm.py`, on the CPU.

  - `ba_tiers` and `_dummy_ba_problem` equal the JAX functions' at every
    tier, array for array;
  - `prewarm` returns the JAX function's count on small configurations of
    each branch (the device-world mirror or not, fused triangulation and
    association or not, device BA assembly or not). The JAX count is taken
    with the functions it would compile replaced by stubs, so no XLA
    program is built: the count is the JAX module's own loop structure;
  - a system stepped 20 frames after `prewarm` gives the poses, keyframes
    and points of one stepped without it, bit for bit, and prewarm draws
    no random numbers and starts no host timer; so does the online
    configuration, its mapper paced (`slice_run.pace_mapper`).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import gmmloc_tpu.pipeline.prewarm as jax_prewarm
from gmmloc_tpu.mapping.device_world import DeviceWorld as JaxDeviceWorld

from gmmloc_tpu_torch.eval import room_fixture, slice_run, synthetic
from gmmloc_tpu_torch.geometry import camera as cam_mod
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.pipeline import prewarm
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
from gmmloc_tpu_torch.utils import timing

from test_torch_system import _frames, _run, jax_config

torch.set_num_threads(1)

WIDTHS = dict(feat_cap=256, num_features=240, local_map_cap=1024)


def _small(cfg, **loc):
    return cfg.replace(caps=dataclasses.replace(cfg.caps, gmm_components_pad=512),
                       loc=dataclasses.replace(cfg.loc, **loc))


CONFIGS = {
    "production": lambda: _small(slice_run.production_config(False, **WIDTHS)),
    "slice": lambda: _small(slice_run.slice_config(**WIDTHS)),
    "host_tri_assoc": lambda: _small(slice_run.production_config(False, **WIDTHS),
                                     fused_tri=False, fused_kf_assoc=False),
    "host_ba": lambda: _small(slice_run.production_config(True, **WIDTHS),
                              ba_device_assembly=False),
}


@pytest.mark.parametrize("tier", [0, 1, 2])
def test_ba_tiers_and_dummy_problem_equal_jax(tier):
    cfg = slice_run.production_config(False)
    tiers = prewarm.ba_tiers(cfg)
    assert tiers == jax_prewarm.ba_tiers(jax_config(cfg))
    L, F_CAP, P = tiers[tier]
    MO = cfg.caps.ba_obs_per_point
    mine = prewarm._dummy_ba_problem(L, F_CAP, P, MO, "cpu")
    ref = jax_prewarm._dummy_ba_problem(L, F_CAP, P, MO)
    assert mine._fields == ref._fields
    for name in ref._fields:
        a, b = getattr(mine, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


class _Stub:
    """What the JAX prewarm reads of a result (fields, items, a 3-tuple
    to unpack), without computing it."""
    n_iters = ok = 0

    def __getitem__(self, i):
        return self

    def __iter__(self):
        return iter((self, self, self))


def _stub(*a, **kw):
    return _Stub()


def _jax_count(monkeypatch, cfg) -> int:
    """The JAX prewarm's count on `cfg`, its compiled calls stubbed."""
    import gmmloc_tpu.mapping.association as jassoc
    import gmmloc_tpu.mapping.ba_assemble as jba
    import gmmloc_tpu.mapping.tri_kernel as jtri
    import gmmloc_tpu.solver.local_ba as jlba
    import gmmloc_tpu.solver.point_solver as jps
    import gmmloc_tpu.tracking.fused as jfused
    import gmmloc_tpu.utils.fetch as jfetch

    for mod, name in ((jlba, "solve_local_ba"), (jax_prewarm.matching, "fuse_match_batch"),
                      (jax_prewarm.matching, "fuse_project_match_gather"),
                      (jax_prewarm.matching, "search_for_triangulation_gather"),
                      (jps, "optimize_point_stereo"), (jps, "optimize_triangulation"),
                      (jtri, "triangulate_kernel"), (jassoc, "associate_and_check_kernel"),
                      (jba, "assemble_and_solve"), (jfused, "fused_track_step_chained")):
        monkeypatch.setattr(mod, name, _stub)
    monkeypatch.setattr(jfetch, "fetch", lambda *a, **kw: None)
    monkeypatch.setattr(JaxDeviceWorld, "prewarm_scatters", lambda self, **kw: None)
    jcfg = jax_config(cfg)
    jcam = types.SimpleNamespace(**cam_mod.CameraParams.from_config(cfg.camera)._asdict())
    return jax_prewarm.prewarm(jcfg, jcam)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prewarm_count_equals_jax(monkeypatch, name):
    cfg = CONFIGS[name]()
    cam = cam_mod.CameraParams.from_config(cfg.camera)
    stats = {}
    n = prewarm.prewarm(cfg, cam, "cpu", stats=stats)
    assert n == _jax_count(monkeypatch, cfg)
    # every BA tier ran (on the CPU no graph is captured)
    assert set(stats["ba_graph_captures"]) == {
        f"L={L} P={P}" for L, _, P in prewarm.ba_tiers(cfg)}


@pytest.fixture(scope="module")
def fixture_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("room")
    return room_fixture.write_room_fixture(str(d), n_components=400, n_frames=60, seed=0)


def test_system_after_prewarm_equals_system_without(fixture_paths):
    cfg = CONFIGS["production"]()
    kw = dict(pad_to=512, neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
              neighbor_cap=cfg.gmm.neighbor_cap)
    runs = []
    for with_prewarm in (False, True):
        system = GMMLocSystem(cfg, mixture.load(fixture_paths[0], "cpu", **kw), "cpu")
        if with_prewarm:
            timing.reset()
            torch_rng, np_rng = torch.get_rng_state(), np.random.get_state()
            assert prewarm.prewarm(cfg, system.cam, "cpu") > 0
            assert torch.equal(torch.get_rng_state(), torch_rng)
            assert all(np.array_equal(a, b) for a, b in zip(np.random.get_state(), np_rng))
            assert not timing.REGISTRY.accs
            assert system.world.map_version == 0
        frames, q_wc, t_wc = _frames(synthetic, cfg, fixture_paths, 20)
        runs.append(_run(system, frames, q_wc, t_wc))
    (poses_a, kf_a, n_a, pts_a), (poses_b, kf_b, n_b, pts_b) = runs
    for (qa, ta), (qb, tb) in zip(poses_a, poses_b):
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(ta, tb)
    assert kf_a == kf_b and len(kf_a) > 1
    assert (n_a, pts_a) == (n_b, pts_b)


def test_online_system_after_prewarm_equals_system_without(fixture_paths):
    """The online configuration (the mapper on its own thread), paced so
    that the mapper finishes each keyframe before the next frame: prewarm
    leaves the mapper thread's BA, and so every pose, unchanged."""
    cfg = _small(slice_run.production_config(True, **WIDTHS))
    kw = dict(pad_to=512, neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
              neighbor_cap=cfg.gmm.neighbor_cap)
    runs = []
    for with_prewarm in (False, True):
        system = GMMLocSystem(cfg, mixture.load(fixture_paths[0], "cpu", **kw), "cpu")
        if with_prewarm:
            assert prewarm.prewarm(cfg, system.cam, "cpu") > 0
        frames, q_wc, t_wc = _frames(synthetic, cfg, fixture_paths, 20)
        for i, f in enumerate(frames):
            system.step(f, q_wc[i], t_wc[i])
            assert not system.track_failed, f"tracking failed at {i}"
            slice_run.pace_mapper(system)
        system.flush()
        system.stop()
        kf = sorted(int(x) for x in system.world.kf_frame_idx[system.world.kf_valid])
        runs.append(([(f.q_cw.copy(), f.t_cw.copy()) for f in frames], kf,
                     len(system.localizer.ba_stats)))
    (poses_a, kf_a, ba_a), (poses_b, kf_b, ba_b) = runs
    for (qa, ta), (qb, tb) in zip(poses_a, poses_b):
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(ta, tb)
    assert kf_a == kf_b and len(kf_a) > 1 and ba_a == ba_b > 0
