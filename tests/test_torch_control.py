"""The port's run control against the JAX package's, on the CPU.

The flag semantics of `tests/test_control.py` on both packages' control
singletons; then the port's `GMMLocSystem.run` on the seeded room
fixture (small widths, feature frames): with stop set it consumes one
frame and steps none (the JAX package's asset-gated case), and a paused
run advances exactly one frame per `request_step`.
"""

import threading
import time

import numpy as np
import pytest
import torch

from gmmloc_tpu.utils import control as jax_control

from gmmloc_tpu_torch.eval import room_fixture, synthetic
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
from gmmloc_tpu_torch.utils import control

from test_torch_system import slice_config

torch.set_num_threads(1)


def _reset(ctl):
    ctl.pause = ctl.step = ctl.stop = False


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_control_flag_semantics(pkg):
    c = (jax_control if pkg == "jax" else control).control
    _reset(c)
    try:
        assert c.should_run()                 # free-running by default
        c.toggle_pause()
        assert not c.should_run()             # paused blocks
        c.request_step()
        assert c.should_run()                 # single-step releases once
        assert c.consume_step()               # ...and is consumed
        assert not c.consume_step()
        assert not c.should_run()             # still paused after the step
        c.toggle_pause()
        assert c.should_run()
        c.request_stop()
        assert c.stop
    finally:
        _reset(c)
    assert c.should_run() and not c.stop


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    cfg = slice_config()
    gmm_path, gt_path = room_fixture.write_room_fixture(
        str(tmp_path_factory.mktemp("room")), n_components=400, n_frames=30, seed=0)
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, gt_path=gt_path, gmm_path=gmm_path, n_landmarks=4000, seed=0,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1)
    gmap = mixture.load(gmm_path, "cpu", pad_to=512,
                        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
                        neighbor_cap=cfg.gmm.neighbor_cap)
    frames = [fe.make_frame(i, ts[i], q_wc[i], t_wc[i]) for i in range(8)]
    return cfg, gmap, frames, q_wc, t_wc


def _system(room):
    cfg, gmap, *_ = room
    return GMMLocSystem(cfg, gmap, "cpu")


def test_stop_breaks_main_loop(room):
    """With stop requested, run() exits before stepping any frame (ref
    gmmloc.cpp:130 `if (global::stop) break;`)."""
    s = _system(room)
    consumed = []

    def frames():
        for i in range(5):
            consumed.append(i)
            yield None              # would fail in step(): must never get there

    control.control.request_stop()
    try:
        world = s.run(frames())
    finally:
        control.control.reset()
    assert world is s.world
    assert consumed == [0]          # the generator pulled once, then stop broke
    assert s.world.n_keyframes() == 0 and not s.world.frame_infos


def test_paused_run_single_steps(room):
    """Paused, the run steps exactly one frame per `request_step`; then a
    stop ends it after its flush."""
    _, _, frames, q_wc, t_wc = room
    s = _system(room)
    stepped = []
    inner = s.step

    def step(frame, *a):
        stepped.append(frame.idx)
        return inner(frame, *a)

    s.step = step
    done = []
    ctl = control.control
    ctl.toggle_pause()
    th = threading.Thread(target=lambda: done.append(s.run(frames, q_wc, t_wc)),
                          daemon=True)
    try:
        th.start()
        time.sleep(0.2)
        assert stepped == []                  # paused: nothing runs
        for k in range(1, 4):
            ctl.request_step()
            deadline = time.monotonic() + 60
            while len(stepped) < k and time.monotonic() < deadline:
                time.sleep(0.005)
            time.sleep(0.2)                   # no second frame slips through
            assert stepped == list(range(k)), stepped
        ctl.request_stop()
        th.join(timeout=60)
        assert not th.is_alive() and done and done[0] is s.world
    finally:
        ctl.request_stop()
        th.join(timeout=60)
        ctl.reset()
    assert stepped == [0, 1, 2]
    # the flush completed the frames in flight: every stepped frame tracked
    assert len(s.world.frame_infos) == 3
    np.testing.assert_array_equal([fi.timestamp for fi in s.world.frame_infos],
                                  [f.timestamp for f in frames[:3]])
