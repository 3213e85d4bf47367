"""The harness's arithmetic and the metric readers, on recorded
readings: a small device trace and a timer table."""

import os

import numpy as np
import pytest

from gmmloc_tpu_torch.eval import ate, bench, kernel_check
from gmmloc_tpu_torch.features import detect
from portbench import arith, peaks, run, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = run.load_json(os.path.join(ROOT, "portbench", "configs", "euroc_v1_online.json"))

# (device type, name, start ns, end ns): two streams whose kernels
# overlap, the window, the harness's spans
RECORDED = [
    ("CPU", "pb:window", 1_000, 101_000),
    ("CPU", "pb:step", 1_000, 40_000),
    ("CPU", "pb:frontend.dispatch", 50_000, 90_000),
    ("DeviceType.CUDA", "fast_nms_kernel(float const*, int, int, float*)", 10_000, 20_000),
    ("DeviceType.CUDA", "pose_solve_kernel(Inputs, Outputs)", 15_000, 30_000),   # other stream
    ("DeviceType.CUDA", "hamming_kernel(uint4 const*, uint4 const*, int, int, int*)",
     60_000, 70_000),
    ("DeviceType.CUDA", "fast_nms_kernel(float const*, int, int, float*)", 95_000, 99_000),
    ("DeviceType.CUDA", "Memcpy DtoH", 100_500, 102_000),   # runs past the window
    ("CPU", "aten::add", 0, 500),
]


def _readings(**kw):
    r = run.Readings()
    r.config = CONFIG
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_idle_is_the_union_over_streams():
    tr = trace.reduce_events(RECORDED)
    assert tr["window_s"] == pytest.approx(100e-6)
    # [10, 30) + [60, 70) + [95, 99) + [100.5, 101) us: the overlap counted once
    assert tr["busy_s"] == pytest.approx((20 + 10 + 4 + 0.5) * 1e-6)
    idle = run.load_reader("metrics", "device.idle_pct").read(_readings(trace=tr))
    assert idle == pytest.approx(100 * (1 - 34.5 / 100))
    # the summed kernel time would read 39.5 us busy, the union 34.5
    assert sum(t for _, t in tr["kernels"].values()) == pytest.approx(39.5e-6)


def test_idle_gaps_are_labelled_by_span():
    gaps = dict(trace.reduce_events(RECORDED)["idle_gaps"])
    # [1, 10) and [30, 40) in step; [40, 50) between spans; [50, 60) and
    # [70, 90) in dispatch, [90, 95) and [99, 100.5) between spans again
    assert gaps["step"] == pytest.approx(19e-6)
    assert gaps["frontend.dispatch"] == pytest.approx(30e-6)
    assert gaps["harness"] == pytest.approx(16.5e-6)


def test_k4_roofline_matches_kernel_check():
    rows, cols = peaks.atlas_shape(CONFIG)
    d = detect.ORBDetector(CONFIG["camera"]["height"], CONFIG["camera"]["width"], device="cpu")
    assert (rows, cols) == (2 * d.atlas_height, d.widths[0]) == (4420, 752)
    img = kernel_check.random_image(rows, cols, "cpu")
    b = kernel_check.fast_bound(img)
    assert b["bytes"] == peaks.fast_nms_bytes(rows, cols)
    assert peaks.fast_nms_bound_s(CONFIG) * 1e3 == pytest.approx(b["bytes_ms"], rel=1e-12)
    tr = trace.reduce_events(RECORDED)
    got = run.load_reader("metrics", "K4_roofline").read(_readings(trace=tr))
    assert got == pytest.approx(100 * 2 * b["bytes_ms"] * 1e-3 / 14e-6)


def test_kernel_ms_per_frame():
    tr = trace.reduce_events(RECORDED)
    got = run.load_reader("metrics", "kernels.device_ms_per_frame").read(
        _readings(trace=tr, frames=5, trace_frames=2))
    # per frame handed in while the trace ran, not per frame of the window
    assert got == pytest.approx((10 + 15 + 10 + 4) * 1e-3 / 2)


def test_timer_readers():
    timers = {"track/chain_prep": (10, 0.1), "track/chain_enqueue": (10, 0.2),
              "track/fused_prep": (2, 0.05), "loc/ba": (4, 1.2), "kf/process": (4, 9.0)}
    r = _readings(timers=timers, frames=10, online=False)
    assert run.load_reader("metrics", "tracking.enqueue_ms").read(r) == pytest.approx(35.0)
    assert run.load_reader("metrics", "mapping.ba_ms.offline").read(r) == pytest.approx(300.0)
    assert run.load_reader("metrics", "mapping.ba_ms.online").read(r) is None
    r.online = True
    assert run.load_reader("metrics", "mapping.ba_ms.online").read(r) == pytest.approx(300.0)
    assert run.load_reader("metrics", "mapping.ba_ms.offline").read(r) is None
    assert run.load_reader("metrics", "tracking.enqueue_ms").read(_readings(frames=3)) is None


def test_span_and_anchor_readers():
    r = _readings(spans={"step": [0.01, 0.03], "frontend": [0.1]}, anchors=[3, 0, 5, 7])
    assert run.load_reader("metrics", "system.step_ms").read(r) == pytest.approx(20.0)
    assert run.load_reader("metrics", "frontend.ms_per_frame").read(r) == pytest.approx(100.0)
    assert run.load_reader("metrics", "mapping.anchored_pct").read(r) == pytest.approx(75.0)
    assert run.load_reader("metrics", "frontend.ms_per_frame").read(_readings()) is None


def test_window_arithmetic_matches_the_port_bench():
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(0.05, 0.3, 200))
    rows = [(i, float(x)) for i, x in enumerate(t)]
    w = bench.window_stats(rows, 0)
    # the bench's rate: frames after the first over the time between the
    # first and the last completion
    assert arith.window_fps(len(rows) - 1, t[-1] - t[0]) == pytest.approx(w["fps"])
    dts = [b - a for a, b in zip(t[:-1], t[1:])]
    assert round(arith.percentile(dts, 95) * 1e3, 2) == w["e2e_frame_ms_p95"]
    assert round(arith.percentile(dts, 50) * 1e3, 2) == w["e2e_frame_ms_p50"]


def test_ate_matches_the_port():
    rng = np.random.default_rng(1)
    ts = np.arange(300) / 20.0
    p_ref = np.cumsum(rng.normal(0, 0.02, (300, 3)), 0)
    p_est = 1.01 * p_ref @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]).T + 0.3 \
        + rng.normal(0, 0.01, (300, 3))
    got, n = arith.ate_rmse(ts[5:], p_est[5:], ts, p_ref)
    want = ate.ate_rmse(ts[5:], p_est[5:], ts, p_ref)
    assert got == want["rmse"] and n == want["n"] == 295


def test_anchor_log_matches_the_port():
    """The harness's reading of the anchors (after each call, when the
    tracker replaced its debug dict) is `_AnchorLog`'s."""
    from gmmloc_tpu_torch.eval.slice_run import _AnchorLog

    class Tracker:
        dbg = {}

    class World:
        frame_infos = []

    class System:
        tracker = Tracker()
        world = World()

    sysm = System()
    log = _AnchorLog(sysm)
    loop = run.Loop(sysm, trace.Tracer(False), ((), None, None))
    loop.readings, loop.recording = run.Readings(), True
    for d in ({"n_anchors": 4}, None, {"path": "classic"}, {"n_anchors": 0}, None):
        if d is not None:
            sysm.tracker.dbg = d
        log.record()
        loop._after_call(0.0)
    assert loop.readings.anchors == log.n_anchors == [4, 0, 0]


def test_spread():
    assert arith.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((5.25 - 1.75) / 3.5)


def test_recovery_and_relocalization_readers():
    timers = {"reloc/relocalize": (8, 0.4), "reloc/attempt": (12, 0.3)}
    r = _readings(timers=timers, recovery_s=[0.2, 0.05, 0.1, 0.4], recoveries=3)
    assert run.load_reader("end_to_end", "recovery_ms_p50").read(r) == pytest.approx(150.0)
    assert run.load_reader("metrics", "reloc.relocalize_ms").read(r) == pytest.approx(50.0)
    assert run.load_reader("metrics", "reloc.attempts_per_recovery").read(r) == pytest.approx(4.0)
    # a run with no dropout, or no relocalization, has nothing to read
    empty = _readings()
    for kind, name in (("end_to_end", "recovery_ms_p50"), ("metrics", "reloc.relocalize_ms"),
                       ("metrics", "reloc.attempts_per_recovery")):
        assert run.load_reader(kind, name).read(empty) is None
