"""Online mapping (the mapper thread) on the CPU.

Online results depend on thread timing, so they are held to gates, not to
the JAX package: `production_config(online=True)` tracks 30 frames of the
seeded room fixture with a camera-centre error under 8 cm, and after
`stop()` the keyframe queue is empty, the thread has finished and mapped
at least two keyframes. A mapper that raises makes `step()` and `stop()`
raise; a mapper that does not finish makes `stop()` raise at its time
limit; a second `stop()` does nothing more. Every join has a time limit
of its own, so a hang fails the test rather than the suite.
"""

import threading

import pytest
import torch

from gmmloc_tpu_torch.eval import room_fixture, slice_run, synthetic
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

from test_torch_system import _frames

torch.set_num_threads(1)

JOIN_S = 120.0


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("room")
    paths = room_fixture.write_room_fixture(str(d), n_components=400, n_frames=60, seed=0)
    cfg = slice_run.production_config(True, feat_cap=256, num_features=240,
                                      local_map_cap=1024)
    gmap = mixture.load(paths[0], "cpu", pad_to=512,
                        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
                        neighbor_cap=cfg.gmm.neighbor_cap)
    return cfg, gmap, paths


def _system(inputs):
    cfg, gmap, _ = inputs
    s = GMMLocSystem(cfg, gmap, "cpu")
    s.online.join_timeout_s = JOIN_S
    return s


def test_online_production_tracks_and_drains(inputs):
    cfg, _, paths = inputs
    frames, q_wc, t_wc = _frames(synthetic, cfg, paths, 30)
    s = _system(inputs)
    assert s.online is not None and s._depth == 4
    for i, f in enumerate(frames):
        st = s.step(f, q_wc[i], t_wc[i])
        assert not s.track_failed and (st is None or st.res), f"failed at {i}"
    s.stop()
    assert s.online.count_queue() == 0 and s.localizer.is_finished
    assert s.online._thread is None
    assert s.world.n_keyframes() >= 2 and len(s.localizer.ba_stats) >= 1
    assert s.localizer.dev_world.n_syncs > 0 and s.tracker.n_chained > 10
    errs = slice_run.pose_errors(frames, t_wc)
    assert errs.max() < 0.08, errs.max()
    s.stop()                               # a second stop does nothing more
    assert s.online.count_queue() == 0


def test_mapper_exception_reaches_step_and_stop(inputs):
    cfg, _, paths = inputs
    frames, q_wc, t_wc = _frames(synthetic, cfg, paths, 2)
    s = _system(inputs)

    def boom():
        raise ValueError("mapper fault")

    s.localizer.spin_once = boom
    s.step(frames[0], q_wc[0], t_wc[0])    # the first keyframe goes to the mapper
    s.online._thread.join(timeout=JOIN_S)
    assert not s.online._thread.is_alive()
    with pytest.raises(RuntimeError, match="mapping thread failed") as e:
        s.step(frames[1], q_wc[1], t_wc[1])
    assert isinstance(e.value.__cause__, ValueError)
    with pytest.raises(RuntimeError, match="mapping thread failed"):
        s.stop()


def test_stop_raises_when_the_mapper_hangs(inputs):
    cfg, _, paths = inputs
    frames, q_wc, t_wc = _frames(synthetic, cfg, paths, 1)
    s = _system(inputs)
    release = threading.Event()
    s.localizer.spin_once = lambda: release.wait(JOIN_S)
    s.step(frames[0], q_wc[0], t_wc[0])
    s.online.join_timeout_s = 0.5
    with pytest.raises(RuntimeError, match="did not finish"):
        s.stop()
    release.set()
    s.localizer.queue.clear()
    s.online.join_timeout_s = JOIN_S
    s.stop()
    assert s.online._thread is None
