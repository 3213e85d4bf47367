"""The readers of the program's own spans (`gmmloc_tpu_torch/utils/timing.py`:
each span's wall, `:self` and `:offcpu` totals over the window), on a
recorded timer table and on one traced CPU run of a cell."""

import pytest

from portbench import run


def _readings(**kw):
    r = run.Readings()
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def _read(name, r):
    return run.load_reader("metrics", name).read(r)


TIMERS = {
    "system/step": (10, 1.0), "system/step:self": (10, 0.02), "system/step:offcpu": (10, 0.1),
    "frontend/dispatch": (10, 1.5), "frontend/dispatch:offcpu": (10, 0.3),
    "frontend/complete": (11, 0.15), "frontend/complete:offcpu": (11, 0.03),
    "track/chain_prep:offcpu": (8, 0.004), "track/chain_enqueue:offcpu": (8, 0.02),
    "track/fused_prep:offcpu": (2, 0.001), "track/fused_enqueue:offcpu": (2, 0.005),
    "system/map_keyframe": (3, 0.9),
}


def test_step_readers():
    r = _readings(timers=TIMERS, frames=10)
    assert _read("system.step_span_ms", r) == pytest.approx(100.0)
    assert _read("system.step_self_ms", r) == pytest.approx(2.0)
    # a program without the spans (the parent of this change): no reading
    for name in ("system.step_span_ms", "system.step_self_ms"):
        assert _read(name, _readings(timers={"track/chain_prep": (3, 0.1)})) is None


def test_frontend_readers():
    r = _readings(timers=TIMERS, frames=10)
    # each span over its own count: the window completes the warm-up's last pair too
    assert _read("frontend.span_ms_per_frame", r) == pytest.approx(1e3 * (1.5 / 10 + 0.15 / 11))
    assert _read("frontend.offcpu_ms_per_frame", r) == pytest.approx(1e3 * (0.3 / 10 + 0.03 / 11))
    # the dispatch span alone (the parent's) is no reading
    only_dispatch = _readings(timers={"frontend/dispatch": (10, 1.5)}, frames=10)
    assert _read("frontend.span_ms_per_frame", only_dispatch) is None
    assert _read("frontend.offcpu_ms_per_frame", only_dispatch) is None


def test_enqueue_offcpu_reader():
    r = _readings(timers=TIMERS, frames=10)
    assert _read("tracking.enqueue_offcpu_ms", r) == pytest.approx(3.0)
    walls_only = {"track/chain_prep": (10, 0.1), "track/chain_enqueue": (10, 0.2)}
    assert _read("tracking.enqueue_offcpu_ms", _readings(timers=walls_only, frames=10)) is None
    assert _read("tracking.enqueue_offcpu_ms", _readings(timers=TIMERS, frames=0)) is None


def test_inline_mapping_reader():
    r = _readings(timers=TIMERS, frames=10, online=False)
    assert _read("mapping.inline_ms_per_frame", r) == pytest.approx(90.0)
    r.online = True
    assert _read("mapping.inline_ms_per_frame", r) is None
    assert _read("mapping.inline_ms_per_frame", _readings(timers={}, frames=10)) is None


NEW = ("system.step_span_ms", "system.step_self_ms", "tracking.enqueue_offcpu_ms",
       "mapping.inline_ms_per_frame")


def test_a_traced_cpu_run_reads_the_program_spans():
    """The offline cell for a second on the CPU at a cut width, traced: the
    new metrics are in the line, the step's own time under its span, and
    the span within a frame's worth of the harness's time around the
    same calls."""
    result, _, r = run.run_cell(
        "v1_offline_features", 2**31 + 7, 1.0, True, "cpu", prewarm=False, warmup=3,
        overrides=dict(frame=dict(feat_cap=256, num_features=240),
                       port={"frame.feat_cap": 256, "frame.num_features": 240,
                             "tracking.fused_local_map_cap": 1024}))
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(NEW) <= set(m)
    assert "frontend.span_ms_per_frame" not in m         # not in this cell
    assert 0 <= m["system.step_self_ms"] < m["system.step_span_ms"]
    assert m["system.step_span_ms"] == pytest.approx(m["system.step_ms"], rel=0.03)
    assert r.timers["system/step"][0] == len(r.spans["step"])
