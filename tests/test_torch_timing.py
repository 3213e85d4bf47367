"""The port's span registry (`gmmloc_tpu_torch/utils/timing.py`).

A span records its wall time, its self time (less the spans opened inside
it on the same thread) and its off-CPU time (less the thread's CPU time),
and opens a function-scope "gl:<tag>" profiler range while the thread
has a profiler on. Held here: self time of nested spans and across two
threads, off-CPU time of a sleep and a spin, the ranges under a
profiler (nested in the caller's range, on its clock) and their absence
from a user-scope trace, nothing beyond the three keys and no range with
the profiler off, one table line per tag; then the spans the system and
the image front end open on a short CPU run, and the idle split of
`tools/torch_profile.py`.
"""

import threading
import time

import numpy as np
import pytest
import torch

from gmmloc_tpu_torch.eval import room_fixture, slice_run, synthetic
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
from gmmloc_tpu_torch.utils import timing
from gmmloc_tpu_torch.utils.timing import Timer

from test_torch_system import _frames

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _empty_registry():
    timing.reset()
    yield
    timing.reset()


def _total(tag):
    return timing.REGISTRY.accs[tag].total


def _spin(s):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < s:
        pass


def test_self_time_of_nested_spans():
    with Timer("outer"):
        _spin(0.01)
        with Timer("outer/a"):
            time.sleep(0.02)
            with Timer("outer/a/b"):
                time.sleep(0.01)
        with Timer("outer/c"):
            time.sleep(0.01)
    assert _total("outer:self") == pytest.approx(
        _total("outer") - _total("outer/a") - _total("outer/c"), abs=1e-9)
    assert _total("outer/a:self") == pytest.approx(
        _total("outer/a") - _total("outer/a/b"), abs=1e-9)
    assert _total("outer/a/b:self") == _total("outer/a/b")
    assert 0.009 < _total("outer:self") < _total("outer") - 0.04


def test_imperative_spans_nest_and_an_abandoned_one_is_dropped():
    outer = Timer("outer").start()
    Timer("outer/left_open").start()      # never stopped (as after an exception)
    inner = Timer("outer/inner").start()
    time.sleep(0.01)
    inner.stop()
    outer.stop()
    assert "outer/left_open" not in timing.REGISTRY.accs
    # the open span took the inner one's time; the outer kept its own
    assert _total("outer:self") == pytest.approx(_total("outer"), abs=1e-9)
    with Timer("after"):
        with Timer("after/x"):
            pass
    assert _total("after:self") == pytest.approx(_total("after") - _total("after/x"),
                                                 abs=1e-9)


def test_spans_nest_per_thread():
    """The other thread's span, inside this one's in time, is no child."""
    opened, done = threading.Event(), threading.Event()

    def other():
        opened.wait(10)
        with Timer("mapper/work"):
            time.sleep(0.03)
        done.set()

    th = threading.Thread(target=other)
    th.start()
    with Timer("tracker/step"):
        opened.set()
        assert done.wait(10)
        with Timer("tracker/step/inner"):
            time.sleep(0.005)
    th.join(10)
    assert not th.is_alive()
    assert _total("tracker/step") > _total("mapper/work") >= 0.03
    assert _total("tracker/step:self") == pytest.approx(
        _total("tracker/step") - _total("tracker/step/inner"), abs=1e-9)
    assert _total("mapper/work:self") == _total("mapper/work")


def test_offcpu_of_sleep_and_spin():
    with Timer("sleep"):
        time.sleep(0.1)
    with Timer("spin"):
        _spin(0.1)
    assert 0.095 <= _total("sleep:offcpu") <= _total("sleep")
    # a spinning thread is on the CPU unless preempted
    assert _total("spin:offcpu") < 0.5 * _total("spin")
    assert _total("spin") >= 0.1


def _cpu_events(res):
    """{name: [(start, end)]} of a profiler result's CPU events."""
    from torch.autograd import DeviceType

    ev = {}
    for e in res.events():
        if e.device_type() == DeviceType.CPU:
            ev.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return ev


def _step_body():
    with Timer("system/step"):
        for _ in range(2):
            with Timer("system/dispatch"):
                torch.ones(64).add_(1)


def test_ranges_under_a_profiler_nest_on_its_clock():
    """Under a profiler that records every scope, the spans' ranges nest
    inside the caller's range and inside each other."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("pb:step"):
            _step_body()
    ev = _cpu_events(prof.profiler.kineto_results)
    (step,) = ev["pb:step"]
    (gl_step,) = ev["gl:system/step"]
    dispatch = ev["gl:system/dispatch"]
    assert len(dispatch) == 2
    assert step[0] <= gl_step[0] <= gl_step[1] <= step[1]
    for s, e in dispatch:
        assert gl_step[0] <= s <= e <= gl_step[1]
    # the registry records under the profiler as without it
    assert timing.REGISTRY.accs["system/dispatch"].count == 2


def test_ranges_under_the_harness_profiler():
    """A profiler that records only the user scope, as the benchmark's
    tracer enables it (so that its device trace holds the benchmark's
    annotations and no range of the program's), records the caller's
    range and none of the spans' ranges."""
    import torch.autograd.profiler as P
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import ProfilerActivity, RecordScope
    from torch.profiler import record_function

    acts = {ProfilerActivity.CPU}
    kw = {"create_trace_id": False} if "create_trace_id" in P.profile.config.__code__.co_varnames \
        else {}
    cfg = P.profile().config(**kw)
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    try:
        with record_function("pb:step"):
            _step_body()
    finally:
        res = _disable_profiler()
    ev = _cpu_events(res)
    assert len(ev["pb:step"]) == 1
    assert not [n for n in ev if n.startswith("gl:")]
    assert timing.REGISTRY.accs["system/step"].count == 1


def test_no_range_and_three_keys_with_the_profiler_off(monkeypatch):
    opened = []
    monkeypatch.setattr(timing, "_RecordFunctionFast", lambda *a: opened.append(a))
    with Timer("a"):
        with Timer("a/b"):
            pass
    assert opened == []
    assert set(timing.REGISTRY.accs) == {"a", "a:self", "a:offcpu", "a/b", "a/b:self",
                                         "a/b:offcpu"}
    assert all(a.count == 1 for a in timing.REGISTRY.accs.values())


def test_print_table_one_line_per_tag():
    with Timer("x"):
        with Timer("x/y"):
            time.sleep(0.002)
    timing.REGISTRY.get("plain")            # a tag with no span behind it
    lines = timing.print_table().splitlines()
    assert lines[0] == "Timing statistics:"
    assert [ln.split()[0] for ln in lines[1:]] == ["plain", "x", "x/y"]
    assert all(" self=" in ln and " offcpu=" in ln for ln in lines[1:])


# ---------------------------------------------------------------------------
# the spans of the system and the image front end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def offline_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("room")
    paths = room_fixture.write_room_fixture(str(d), n_components=400, n_frames=60, seed=0)
    cfg = slice_run.production_config(False, feat_cap=256, num_features=240,
                                      local_map_cap=1024)
    gmap = mixture.load(paths[0], "cpu", pad_to=512,
                        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
                        neighbor_cap=cfg.gmm.neighbor_cap)
    return cfg, gmap, paths


def test_system_spans(offline_inputs):
    """The depth-4 step: one `system/step` per call, the dispatches and
    drains inside it, keyframes mapped inside the
    drains, the flush's drains inside `system/flush`; the step's own time
    a sliver of it."""
    cfg, gmap, paths = offline_inputs
    frames, q_wc, t_wc = _frames(synthetic, cfg, paths, 14)
    system = GMMLocSystem(cfg, gmap, "cpu")
    system.step(frames[0], q_wc[0], t_wc[0])
    timing.reset()
    for i in range(1, len(frames)):
        system.step(frames[i], q_wc[i], t_wc[i])
        assert not system.track_failed
    n_drain = timing.REGISTRY.accs["system/drain"].count
    system.flush()
    acc = timing.REGISTRY.accs
    assert acc["system/step"].count == len(frames) - 1
    assert acc["system/flush"].count == 1
    assert acc["system/drain"].count == n_drain + cfg.tracking.pipeline_depth
    assert acc["system/dispatch"].count == len(frames) - 1
    assert acc["system/map_keyframe"].count >= 1
    step, own = acc["system/step"].total, acc["system/step:self"].total
    assert own < 0.1 * step
    assert acc["system/drain:self"].total < acc["system/drain"].total
    # the step's children: its dispatches and every drain but the flush's
    in_flush = acc["system/flush"].total - acc["system/flush:self"].total
    inside = acc["system/dispatch"].total + acc["system/drain"].total - in_flush
    assert step - own == pytest.approx(inside, rel=1e-6)


def test_frontend_spans():
    cfg = slice_run.image_config(feat_cap=640, num_features=600)
    rng = np.random.default_rng(0)
    h, w = cfg.camera.height, cfg.camera.width
    left = rng.integers(0, 256, (h, w), dtype=np.uint8)
    right = np.roll(left, -4, axis=1)
    ImageFrontend(cfg, device="cpu").process_packed(0, 0.0, left, right)
    acc = timing.REGISTRY.accs
    stages = ("frontend/prepare", "frontend/pyramid", "frontend/detect", "frontend/stereo")
    assert all(acc[t].count == 1 for t in stages + ("frontend/dispatch", "frontend/complete"))
    assert acc["frontend/dispatch:self"].total == pytest.approx(
        acc["frontend/dispatch"].total - sum(acc[t].total for t in stages), abs=1e-9)
    assert acc["frontend/dispatch:self"].total < acc["frontend/dispatch"].total


def test_profile_tool_splits_idle_time_by_the_innermost_range():
    """`tools/torch_profile.py`: the idle share from the union of the
    card's intervals, the window's own annotation on the card left out,
    each idle gap split by the innermost range of the window's thread."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "torch_profile.py")
    spec = importlib.util.spec_from_file_location("torch_profile", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    events = [  # (on the card, name, start, end, thread); ns
        (False, tool.WINDOW, 0, 100, 1),
        (False, "gl:system/step", 10, 60, 1),
        (False, "gl:system/dispatch", 20, 30, 1),
        (False, "gl:system/drain", 40, 55, 1),
        (False, "gl:loc/ba", 0, 100, 2),                  # another thread
        (True, "pose_solve_kernel", 22, 25, 0),
        (True, "elementwise_kernel", 24, 26, 0),          # another stream, overlapping
        (True, "hamming_kernel", 50, 52, 0),
        (True, "Memcpy DtoH", 95, 105, 0),                # past the window
        (True, tool.WINDOW, 22, 100, 0),
    ]
    red = tool.reduce_trace(events)
    assert red["window_s"] == pytest.approx(100e-9)
    assert red["busy_s"] == pytest.approx(11e-9)          # [22, 26) [50, 52) [95, 100)
    assert set(red["kernels"]) == {"pose_solve_kernel", "elementwise_kernel", "hamming_kernel",
                               "Memcpy DtoH"}
    idle = dict(red["idle_gaps"])
    assert idle == pytest.approx({tool.OUTSIDE: 45e-9, "system/step": 25e-9,
                                  "system/dispatch": 6e-9, "system/drain": 13e-9})
    assert sum(idle.values()) == pytest.approx(red["window_s"] - red["busy_s"])
