"""The harness on a traffic with camera dropouts, and the cells without
them under the same harness, at a size a CPU run holds (feat_cap 256,
three warm-up frames, one dropout of three dark frames; the program's
plain versions stand in for the kernels).

A dark frame keeps only its spurious detections, so the track fails,
the system goes LOST and relocalizes on a lit frame after it; the
harness counts a frame as tracked only once its pose is recorded, times
the recovery and holds the dropouts to `recover_within`. The `reloc`
check's reference (`reference/bow.py`) is held against the program's
vocabulary and database directly too.

The blackout cell (`euroc_v1_online_reloc` x `feature_blackouts`) is not
in `BENCHMARK.json` while the program's relocalizer refuses right poses
at the cell's size (PERF.md, open questions); `BENCH` adds it as a
later change would.
"""

import os

import numpy as np
import pytest

from gmmloc_tpu_torch.vocab import bow as prog_bow
from portbench import run
from portbench.reference import bow as ref_bow

CUT = dict(frame=dict(feat_cap=256, num_features=240),
           port={"frame.feat_cap": 256, "frame.num_features": 240,
                 "tracking.fused_local_map_cap": 1024})
# one dropout early in the window (at this width the room's map takes a
# relocalized pose only near where it was built)
ONE_DROPOUT = dict(dark_every=1000, dark_frames=3, dark_from=4, recover_within=6, min_dropouts=1)
SEED = 2**31 + 98
BENCH = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
BENCH["workloads"].append(dict(name="v1_online_blackouts", config="euroc_v1_online_reloc",
                               traffic="feature_blackouts", chips=1))
BENCH["end_to_end"].append(dict(name="recovery_ms_p50", unit="ms", better="lower", bound=0.25,
                                source="host_clock", workloads=["v1_online_blackouts"]))


def run_blackouts(port=None, **kw):
    """The blackout cell with one dropout, on the CPU at the cut width."""
    ov = dict(CUT, traffic=ONE_DROPOUT)
    if port:
        ov["port"] = dict(CUT["port"], **port)
    return run.run_cell("v1_online_blackouts", SEED, 12.0, False, "cpu", overrides=ov,
                        bench=BENCH, prewarm=False, warmup=3, **kw)


@pytest.fixture(scope="module")
def sound():
    kept = {}
    res, compared, r = run_blackouts(kept_out=kept)
    return res, compared, r, kept


def test_goes_lost_recovers_and_reports_the_recovery(sound):
    res, compared, r, _ = sound
    assert res["correct"], compared
    assert r.dropouts == 1 and len(r.recovery_s) == 1 and r.recoveries >= 1
    assert compared["unrecovered_dropouts"] == (0, 0) and compared["failed_frames"] == (0, 0)
    assert res["metrics"]["recovery_ms_p50"]["value"] == pytest.approx(r.recovery_s[0] * 1e3)
    # dark frames are handed in and counted neither as tracked nor as failed
    assert res["attempted"] == r.attempted and res["failed"] == r.attempted - r.frames
    assert r.timers["reloc/relocalize"][0] >= 3          # the three dark frames, then a lit one
    for name in ("reloc.relocalize_ms", "reloc.attempts_per_recovery"):
        assert run.load_reader("metrics", name).read(r) > 0


@pytest.mark.parametrize("control", ["ties_last", "f16"])
def test_reloc_controls_fail(sound, control):
    """Each control, on the sound run's captured sample, reads past a
    limit that the sound run keeps."""
    _, compared, _, kept = sound
    mod = run.load_reader("checks", "reloc")
    got = mod.numbers(kept["reloc"], kept["ref"], control=control)
    assert all(compared[k][0] <= lim for k, lim in mod.LIMITS.items())
    assert any(got[k] > lim for k, lim in mod.LIMITS.items()), got


def test_without_relocalization_the_dropout_is_unrecovered():
    """The same run with `enable_relocalization` off: the first dark
    frame ends tracking; `correct` reads false through the unrecovered
    dropout, and the run ends with a result."""
    res, compared, r = run_blackouts(port={"enable_relocalization": False})
    assert not res["correct"]
    assert compared["unrecovered_dropouts"][0] == 1 and r.recovery_s == []
    assert "recovery_ms_p50" not in res["metrics"]


def _drained_frames(monkeypatch):
    """Keeps, after each call of each Loop, the frame the system drained
    last (`_last_done`), from which `drained()` gives the frames the
    earlier harness counted: every frame of the window up to the last
    drained one, at the first call after which it was drained."""
    calls, orig = [], run.Loop._after_call

    def after(self, t):
        orig(self, t)
        last = self.system._last_done
        calls.append((self, t, -1 if last is None else last.idx))

    def drained(loop):
        done, upto = {}, -1
        for lp, t, idx in calls:
            if lp is loop and idx > upto:
                done.update((i, t) for i in range(upto + 1, idx + 1)
                            if i in loop.t_in and i not in done)
                upto = idx
        return done

    monkeypatch.setattr(run.Loop, "_after_call", after)
    return calls, drained


@pytest.mark.parametrize("cell,seconds", [("v1_offline_features", 8.0),
                                          ("v1_online_features", 8.0),
                                          ("v1_online_images", 6.0)])
def test_cells_without_dropouts_read_as_before(monkeypatch, cell, seconds):
    """A cell without dark stretches reads as under the earlier harness,
    which counted the drained frames: every frame handed in is tracked,
    each at the call that drained it, so the frames, the latencies and
    `failed_frames` are the same."""
    calls, drained = _drained_frames(monkeypatch)
    res, compared, r = run.run_cell(cell, 2**31 + 23, seconds, False, "cpu", overrides=CUT,
                                    prewarm=False, warmup=3)
    loop = calls[-1][0]
    assert r.attempted == len(loop.t_in) > 0
    assert loop.t_done == drained(loop)
    assert r.latency_s == [loop.t_done[k] - loop.t_in[k] for k in sorted(loop.t_done)]
    assert r.frames == len(loop.t_done) == r.attempted and res["failed"] == 0
    assert compared["failed_frames"] == (0, 0)
    assert "unrecovered_dropouts" not in compared and r.recovery_s == [] and r.dropouts == 0
    assert set(res["metrics"]) == {m["name"] for m in run.cell_metrics(BENCH, cell, False)}


def test_dropout_readings():
    """The count of a window of 60 frames (5 warm-up), dropouts of 2 dark
    frames every 20 from the window's frame 3 (frames 8-9, 28-29, 48-49),
    4 lit frames allowed after each."""
    traffic = dict(dark_every=20, dark_frames=2, dark_from=3, recover_within=4)
    from portbench import generate

    dark = generate.dark_mask(60, 5, traffic)
    t_in = {i: float(i) for i in range(5, 53)}
    tracked = set(range(5, 8)) | {11, 12} | set(range(14, 28)) - {20} | set(range(34, 48))
    t_done = {i: i + 0.5 for i in tracked}
    got = run.dropout_readings(traffic, dark, 5, t_in, t_done, False)
    # the first dropout recovers at frame 11, its first lit frame being 10
    assert got["recovery_s"] == [1.5] and got["dropouts"] == 3
    # the second never within 30-33; the third's allowance (50-53) is not over
    assert got["unrecovered"] == 1
    # lit and not tracked outside the allowances (10-13, 30-33, 50-53): 20
    assert got["failed_frames"] == 1
    assert set(got["lit"]) == set(t_in) - {8, 9, 28, 29, 48, 49}
    # a fatal failure before the allowance is over counts the dropout
    assert run.dropout_readings(traffic, dark, 5, t_in, t_done, True)["unrecovered"] == 2


def test_reference_bow_equals_the_program():
    """The reference's vocabulary is the program's (the same words for
    every descriptor); its database, fed the same keyframes, a keyframe
    slot reused, scores the program's candidates within float32
    rounding; taking ties last moves words."""
    rng = np.random.default_rng(5)
    centres = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    flips = rng.integers(0, 256, (3000, 8))
    descs = centres[rng.integers(0, 40, 3000)].copy()
    for b in range(8):
        byte, bit = flips[:, b] >> 3, flips[:, b] & 7
        descs[np.arange(3000), byte] ^= (1 << bit).astype(np.uint8)
    prog = prog_bow.Vocabulary.train(descs[::3], k=6, depth=3, seed=2, device="cpu")
    ref = ref_bow.train(descs[::3], 6, 3, 2)
    assert np.array_equal(prog.transform_words(descs), ref.descend(descs))
    np.testing.assert_array_equal(prog.word_weight.astype(np.float64), ref.weight)
    assert (ref.descend(descs, "last") != ref.descend(descs)).any()
    db, rdb = prog_bow.KeyFrameDatabase(prog), ref_bow.Database()
    for kf, sl in ((0, slice(0, 200)), (1, slice(150, 350)), (2, slice(400, 600)),
                   (1, slice(700, 900)), (3, slice(100, 300))):     # slot 1 reused
        valid = rng.random(200) > 0.1
        db.add(kf, descs[sl], valid)
        rdb.add(kf, ref.bow_vector(ref.descend(descs[sl]), valid))
        words, vals = db.bow[kf]
        want = rdb.bow[kf]
        assert sorted(want) == words.tolist()
        np.testing.assert_allclose([want[w] for w in words], vals, rtol=1e-6, atol=0)
    q = descs[120:320]
    valid = np.ones(200, bool)
    got = db.query(q, valid, top=5)
    want = rdb.query(ref.bow_vector(ref.descend(q), valid), 5)
    assert [k for k, _ in got] == [k for k, _ in want] and len(got) >= 3
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=1e-7)
    half = rdb.query(ref.bow_vector(ref.descend(q), valid, np.float16), 5, np.float16)
    assert max(abs(a - b) for (_, a), (_, b) in zip(half, want)) > 1e-5
