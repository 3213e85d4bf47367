"""LOST-state relocalization of the port against the JAX package.

The two scenarios of `tests/test_relocalize.py` need the EuRoC assets, so
they run here on the seeded room fixture, in both packages, on the same
frames (`gmmloc_tpu_torch/eval/reloc_run.py` drives both systems):

  - the detection blackout: 40 frames, frames 20-23 with every detection
    dropped;
  - the kidnapped robot: 30 frames mapped, 3 dark frames while the camera
    is carried back to frame 5, then 18 frames from there.

Widths: the slice configuration at feat_cap 64 / 60 features, the
smallest at which the JAX package recovers in both scenarios (at 48 it
keeps one keyframe and never recovers; `tools/torch_reloc_reference.py`
runs the scenarios at any width). The vocabulary is trained as
the JAX tests train it (`desc[::4]`, k=10, depth 3, seed 0), and both
packages run the local BA in float32 (`_ba_in_f32`).

Gates: the same untracked frames, lost count and recovery frames; each
recovered pose within 1 mm and 0.05 deg of the JAX one; post-recovery
max camera-centre error under the JAX test's 10 cm in both packages.
"""

import numpy as np
import pytest
import torch

from gmmloc_tpu.eval import synthetic as jax_synthetic
from gmmloc_tpu.gmm import mixture as jax_mixture
from gmmloc_tpu.pipeline.system import GMMLocSystem as JaxSystem
from gmmloc_tpu.vocab.bow import Vocabulary as JaxVocabulary
from tests.test_torch_system import _ba_in_f32, jax_config

from gmmloc_tpu_torch.eval import reloc_run, room_fixture, slice_run, synthetic
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
from gmmloc_tpu_torch.vocab.bow import Vocabulary

torch.set_num_threads(1)

MAX_ERR_M = 0.10


@pytest.fixture(scope="module")
def fixture_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("room")
    return room_fixture.write_room_fixture(str(d), n_components=400, n_frames=120,
                                           seed=0)


def run_both(paths, cfg, make_frames):
    """Each package's system, vocabulary and frames from the same seeds;
    returns {package: reloc_run.summary}."""
    gmm_path, gt_path = paths
    kw = dict(pad_to=512, neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
              neighbor_cap=cfg.gmm.neighbor_cap)
    seq = dict(gt_path=gt_path, gmm_path=gmm_path, n_landmarks=4000, seed=0,
               disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1)
    out = {}
    jcfg = jax_config(cfg)
    fe, ts, q_wc, t_wc = jax_synthetic.make_sequence(jcfg, **seq)
    voc = JaxVocabulary.train(fe.world.desc[::4], k=10, depth=3, seed=0)
    system = JaxSystem(jcfg, jax_mixture.load(gmm_path, **kw), vocabulary=voc)
    frames = make_frames(fe, ts, q_wc, t_wc)
    reloc_run.drive(system, frames, q_wc, t_wc)
    out["jax"] = reloc_run.summary(system, frames, t_wc)

    fe, ts, q_wc, t_wc = synthetic.make_sequence(cfg, **seq)
    voc = Vocabulary.train(fe.world.desc[::4], k=10, depth=3, seed=0, device="cpu")
    system = GMMLocSystem(cfg, mixture.load(gmm_path, "cpu", **kw), "cpu",
                          vocabulary=voc)
    assert system.relocalizer is not None and system.loop_closer is None
    frames = make_frames(fe, ts, q_wc, t_wc)
    reloc_run.drive(system, frames, q_wc, t_wc)
    out["port"] = reloc_run.summary(system, frames, t_wc)
    return out


def check_recovery(out):
    ref, got = out["jax"], out["port"]
    for r in (ref, got):
        assert r["n_lost"] > 0, "the blackout never triggered the LOST state"
        assert not r["lost"] and r["recovery_frames"], "never relocalized"
        assert len(r["errors"]) >= 10, "too few tracked frames after recovery"
        assert r["errors"].max() < MAX_ERR_M, r["errors"].max()
    assert got["untracked"] == ref["untracked"]
    assert got["n_lost"] == ref["n_lost"]
    assert got["recovery_frames"] == ref["recovery_frames"]
    for idx, (qa, ta) in ref["recovered_poses"].items():
        qb, tb = got["recovered_poses"][idx]
        ca, cb = reloc_run._center(qa, ta), reloc_run._center(qb, tb)
        rot = np.degrees(2 * np.arccos(min(1.0, abs(float(np.dot(qa, qb))))))
        assert np.linalg.norm(ca - cb) < 1e-3 and rot < 0.05, (idx, ca - cb, rot)


def depth1_config():
    return slice_run.slice_config(feat_cap=64, num_features=60, local_map_cap=256)


def test_detection_blackout_recovers_as_reference(fixture_paths, monkeypatch):
    _ba_in_f32(monkeypatch)
    out = run_both(fixture_paths, depth1_config(), lambda fe, ts, q, t: (
        reloc_run.blackout_frames(fe, ts, q, t, 0, 40, range(20, 24))))
    check_recovery(out)
    assert out["port"]["untracked"][:4] == [20, 21, 22, 23]


def test_kidnapped_robot_relocalizes_as_reference(fixture_paths, monkeypatch):
    _ba_in_f32(monkeypatch)
    out = run_both(fixture_paths, depth1_config(), lambda fe, ts, q, t: (
        reloc_run.kidnap_frames(fe, ts, q, t, 0, 30, 3, 5, 18)))
    check_recovery(out)
    assert out["port"]["untracked"][:3] == [30, 31, 32]
