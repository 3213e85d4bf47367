"""The port's bench (`gmmloc_tpu_torch/eval/bench.py`) against the JAX
package's root `bench.py`, on the CPU.

  - (a) the window statistics: the JAX bench's `e2e_fps` / `img_e2e_fps`
    read a prepared child log (their `subprocess.Popen` replaced by a
    fake child that writes it) and the port's `read_log` + `window_stats`
    read the same rows: the same fps, p50, p95 and frame counts, and both
    refuse a window that is too short;
  - (b) a `--cpu` run at feat_cap 256 with a few frames per line: the
    detail line on stderr has every `detail[...]` key `bench.py` sets
    (read from its source with `ast`) and the window percentiles, the
    headline on stdout exactly `bench.py`'s four keys;
  - (c) the offline child at feat_cap 256, 40 frames from frame 150, on
    the bench's fixture gives the poses of the JAX `GMMLocSystem` at the
    same depth-4 configuration on the same frames, with float32 BA
    products in both, within `test_torch_chained.py`'s 5 mm / 0.05 deg;
  - (d) a child that fails, or stalls, makes `main` return no result and
    print no headline;
  - (e) a child run with `--no-prewarm` skips prewarm and still writes
    every `stats` key the parent reads.
"""

import ast
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from gmmloc_tpu.eval import synthetic as jax_synthetic
from gmmloc_tpu.gmm import mixture as jax_mixture
from gmmloc_tpu.mapping.map_state import _inverse
from gmmloc_tpu.pipeline.system import GMMLocSystem as JaxSystem

from gmmloc_tpu_torch.eval import bench

from test_torch_system import _ba_in_f32, jax_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_bench():
    sys.path.insert(0, ROOT)
    import bench as jb   # the root bench.py; its tpuenv import acts only under __main__

    return jb


def _bench_py_keys():
    """(detail keys, headline keys) that the root bench.py writes."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    detail, head = set(), set()
    for n in ast.walk(tree):
        if (isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name)
                and n.value.id == "detail" and isinstance(n.slice, ast.Constant)):
            detail.add(n.slice.value)
        if isinstance(n, ast.Dict) and any(isinstance(k, ast.Constant) and k.value == "metric"
                                           for k in n.keys):
            head = {k.value for k in n.keys if isinstance(k, ast.Constant)} - {"error"}
    return detail, head


def _rows(seed: int, n: int, spikes: bool):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.03, 0.12, n)
    if spikes:
        dt[rng.integers(0, n, n // 8)] += rng.uniform(0.2, 0.9, n // 8)
    t = 1000.0 + np.cumsum(dt)
    return [(i, float(f"{t[i]:.6f}")) for i in range(n)]


class _FakeChild:
    """Stands in for bench.py's child process: writes the prepared log to
    the path the parent passes and has exited."""

    def __init__(self, text):
        self.text = text

    def __call__(self, args, **kw):
        with open(args[4], "w") as f:
            f.write(self.text)
        return self

    def poll(self):
        return 0

    def wait(self):
        return 0


WINDOWS = {  # (rows, warm-up, seed, spikes)
    "feature": (120, 25, 0, False),
    "feature_spikes": (175, 25, 1, True),
    "image": (90, 40, 2, True),
    "too_short": (44, 25, 3, False),
}


@pytest.mark.parametrize("case", list(WINDOWS))
def test_window_stats_equal_bench_py(jax_bench, monkeypatch, tmp_path, case):
    n, warm, seed, spikes = WINDOWS[case]
    rows = _rows(seed, n, spikes)
    text = "".join(f"{i} {t:.6f} 1\n" for i, t in rows) + "done\n"
    path = tmp_path / "frames.log"
    path.write_text(text)
    mine_rows, stats, done = bench.read_log(str(path))
    assert mine_rows == rows and stats is None and done
    mine = bench.window_stats(mine_rows, warm)
    monkeypatch.setattr(jax_bench.subprocess, "Popen", _FakeChild(text))
    monkeypatch.setattr(jax_bench, "fast_tpu_child_env", lambda: {})
    if case == "image":
        fps, n_done = jax_bench.img_e2e_fps(n_frames=n, warm=warm)
        assert n_done == mine["frames"] == n and fps == mine["fps"]
        return
    fps, n_done, pct = jax_bench.e2e_fps(n_frames=n, warm=warm)
    if case == "too_short":
        assert fps is None and mine is None and n_done == n
        return
    assert fps == mine["fps"] and n_done == mine["frames"] == n
    assert pct == {k: mine[k] for k in pct} and set(pct) == set(bench.PERCENTILE_KEYS[:3])


def test_detail_keys_are_bench_py_keys():
    detail, head = _bench_py_keys()
    assert set(bench.DETAIL_KEYS) == detail and len(detail) == 18
    assert set(bench.HEADLINE_KEYS) == head


SMALL = ["--cpu", "--feat-cap", "256", "--online-frames", "22", "--online-warm", "2",
         "--offline-frames", "22", "--offline-warm", "2", "--image-frames", "22",
         "--image-warm", "2"]


def test_cpu_bench_prints_bench_py_lines(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")     # the children's CPU threads
    res = bench.main(SMALL + ["--fixture", str(tmp_path / "fx")])
    out, err = capsys.readouterr()
    assert res is not None, err[-3000:]
    head = json.loads(out.strip().splitlines()[-1])
    detail = json.loads([x for x in err.splitlines() if x.startswith("{")][-1])
    want_detail, want_head = _bench_py_keys()
    assert set(head) == want_head and head["metric"] == bench.METRIC
    assert head["vs_baseline"] == round(head["value"] / 20.0, 2)
    assert want_detail | set(bench.PERCENTILE_KEYS) <= set(detail)
    assert detail["e2e_status"] == "ok" and detail["timer"] == bench.TIMER_CPU
    assert detail["e2e_frames_completed"] == detail["e2e_offline_frames"] == 22
    # the per-line additions are there and sane (the online lines' values
    # follow the mapper thread's timing, so no accuracy gate here)
    for k in ("e2e", "e2e_offline", "image_path"):
        assert 0 < detail[f"{k}_max_err_m"] < 0.5 and 0 <= detail[f"{k}_anchored_share"] <= 1
    for line, st in res["lines"].items():
        assert st["drained"] and st["depth"] == 4 and st["frames"] == 22, (line, st)
        assert st["online"] == (line != "offline")
        assert st["prewarm_calls"] > 0


def test_offline_child_matches_jax_system(tmp_path, monkeypatch):
    n = 40
    fx = str(tmp_path / "fx")
    bench.write_fixture(fx, bench.START + n + 50)
    _ba_in_f32(monkeypatch)
    stats, system, frames = bench.run_child("offline", fx, n, 0, io.StringIO(), "cpu",
                                            feat_cap=256)
    assert stats["frames"] == n and not stats["track_failed"] and system._depth == 4

    jcfg = jax_config(bench.line_config("offline", 256))
    gmm, gt = os.path.join(fx, "room.gmm"), os.path.join(fx, "gt", "V1_01_easy.txt")
    fe, ts, q_wc, t_wc = jax_synthetic.make_sequence(
        jcfg, gt_path=gt, gmm_path=gmm, n_landmarks=bench.N_LANDMARKS, seed=0,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1)
    js = JaxSystem(jcfg, jax_mixture.load(gmm, pad_to=jcfg.caps.gmm_components_pad,
                                          neighbor_dist_thresh=jcfg.gmm.neighbor_dist_thresh,
                                          neighbor_cap=jcfg.gmm.neighbor_cap))
    s = bench.START
    jframes = [fe.make_frame(i, ts[s + i], q_wc[s + i], t_wc[s + i]) for i in range(n)]
    for i, f in enumerate(jframes):
        js.step(f, q_wc[s + i], t_wc[s + i])
        assert not js.track_failed, i
    js.flush()
    for i, (a, b) in enumerate(zip(jframes, frames)):
        dt = np.linalg.norm(_inverse(a.q_cw, a.t_cw)[1] - _inverse(b.q_cw, b.t_cw)[1])
        drot = np.degrees(2 * np.arccos(min(1.0, abs(float(np.dot(a.q_cw, b.q_cw))))))
        assert dt < 5e-3 and drot < 0.05, f"frame {i}: {dt * 1e3:.2f} mm, {drot:.4f} deg"
    kf = lambda w: sorted(int(x) for x in w.kf_frame_idx[w.kf_valid])  # noqa: E731
    assert kf(js.world) == kf(system.world) and len(kf(js.world)) > 1


FAILING = {
    "raises": "import sys; sys.stderr.write('child failed on purpose\\n'); raise SystemExit(3)",
    "raises_after_rows": (
        "import sys, time\n"
        "f = open(sys.argv[1], 'w', buffering=1)\n"
        "for i in range(5):\n"
        "    f.write('%d %.6f 1\\n' % (i, time.perf_counter()))\n"
        "raise RuntimeError('child failed on purpose')\n"),
    "stalls": (
        "import sys, time\n"
        "f = open(sys.argv[1], 'w', buffering=1)\n"
        "f.write('0 %.6f 1\\n' % time.perf_counter())\n"
        "print('child failed on purpose', flush=True)\n"
        "time.sleep(60)\n"),
}


@pytest.mark.parametrize("case", list(FAILING))
def test_failed_child_gives_no_headline(tmp_path, monkeypatch, capsys, case):
    monkeypatch.setattr(bench, "child_command",
                        lambda line, log_path, *a: [sys.executable, "-c", FAILING[case],
                                                    log_path])
    monkeypatch.setattr(bench, "STALL_S", 2.0)
    res = bench.main(SMALL + ["--fixture", str(tmp_path / "fx")])
    out, err = capsys.readouterr()
    assert res is None
    assert "metric" not in out and bench.METRIC not in out
    assert "child failed on purpose" in err and "[bench] online child" in err
    if case == "stalls":
        assert "no frame for 2 s" in err


def test_child_without_prewarm_reports_its_stats(tmp_path):
    """`--child LINE --no-prewarm` (the first-frame comparison's child):
    no prewarm, and the `stats` line has every key the parent reads."""
    fx, log = str(tmp_path / "fx"), str(tmp_path / "frames.log")
    n = 22
    bench.write_fixture(fx, bench.START + n + 50)
    assert bench.main(["--child", "offline", "--cpu", "--no-prewarm", "--log", log,
                       "--frames", str(n), "--warm", "2", "--fixture", fx,
                       "--feat-cap", "256"]) == 0
    rows, stats, done = bench.read_log(log)
    assert done and len(rows) == n and [r[0] for r in rows] == list(range(n))
    assert stats["prewarm_s"] is None and "prewarm_calls" not in stats
    assert stats["frames"] == n and stats["drained"] and not stats["track_failed"]
    assert stats["k3_shapes"] == [] and stats["launches"] == dict(K1=0, K2=0, K3=0, K4=0)
    assert 0 < stats["max_err_m"] < 0.5 and stats["keyframes"] > 1
