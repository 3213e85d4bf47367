"""The port's evaluation protocol (`gmmloc_tpu_torch/eval/evaluate.py`)
against the JAX package's `tools/evaluate.py`, on the CPU.

The JAX tools read their data through `gmmloc_tpu.eval.synthetic`'s
GT_DIR / V1_GMM / V2_GMM and the port's modules through their own copy
of those names; both are pointed at one seeded room fixture (400
components, its trajectory as `GT_DIR/V1_01_easy.txt`) with
`monkeypatch`, and both tools' `euroc_v1_config` is cut to a small width
(feat_cap 256, 240 features, a 1024-slot local map, the map padded to
512). Both packages' local BA runs with float32 products
(`test_torch_system._ba_in_f32`).

Gates, as `test_torch_system.test_slice_end_to_end_matches_reference`
holds the slice: the same frames, tracked, lost, keyframes, completion
and integer BA statistics; per-frame camera centres within 5 mm; the
rmse within 1 mm; the run record's keys those of the JAX tool but
`fetches_per_frame`; every BA statistic of the JAX package's BA record,
key for key, on the same windows. The helpers here are shared by the
port's other entry-layer tests.

Run as a script, the module compares the two protocols over a longer
segment, on the fixture and frames of `chip_smoke.py` `[eval]` (a):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_eval_protocol.py
        [--package jax,port] [--runs 2] [--frames 200] [--start 150]
        [--feat-cap 256] [--depth 1] [--out DIR]

It writes the room fixture as `[eval]` does (3300 components, seed 0, a
trajectory of start + frames + 50 frames), points both packages' asset
names at it and runs each package's `run_once` at the JAX defaults
(depth 1, pipelined, mirror, packed; `--depth 4` the device-chained
pipeline of the bench's offline line) with `--damping 0.9 --reloc 1`, at
`--feat-cap` (features: feat_cap - 16, local map: 4 x feat_cap). It
prints one JSON line per run: the max and mean camera-centre error
against the ground truth from the run's TUM file (as
`chip_smoke._tum_check` reads it), the frame of the max, the rmse,
keyframes and BA solves.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from gmmloc_tpu import config as jax_config_mod
from gmmloc_tpu.eval import synthetic as jax_synthetic

from gmmloc_tpu_torch import config as config_mod
from gmmloc_tpu_torch.eval import ate, evaluate, room_fixture, synthetic

from test_torch_system import _ba_in_f32, jax_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 30
N_COMPONENTS = 400


def load_tool(name: str):
    """The JAX package's `tools/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_eval_fixture(d: str, n_frames: int = 300) -> dict:
    """A room fixture laid out as the tools read it: `gt/V1_01_easy.txt`
    and `room.gmm`."""
    gmm_path, gt_path = room_fixture.write_room_fixture(d, n_components=N_COMPONENTS,
                                                        n_frames=n_frames, seed=0)
    gt_dir = os.path.join(d, "gt")
    os.makedirs(gt_dir, exist_ok=True)
    shutil.copy(gt_path, os.path.join(gt_dir, "V1_01_easy.txt"))
    return dict(dir=d, gt_dir=gt_dir, gmm=gmm_path)


def point_assets(monkeypatch, fx: dict) -> None:
    """Both packages' asset names at the fixture."""
    for mod in (synthetic, jax_synthetic):
        monkeypatch.setattr(mod, "GT_DIR", fx["gt_dir"])
        monkeypatch.setattr(mod, "V1_GMM", fx["gmm"])
        monkeypatch.setattr(mod, "V2_GMM", fx["gmm"])


def small(cfg):
    """`cfg` cut to the tests' width."""
    return cfg.replace(
        frame=dataclasses.replace(cfg.frame, feat_cap=256, num_features=240),
        tracking=dataclasses.replace(cfg.tracking, fused_local_map_cap=1024),
        caps=dataclasses.replace(cfg.caps, gmm_components_pad=512))


def small_v1_config():
    return small(config_mod.euroc_v1_config())


def small_jax_v1_config():
    return jax_config(small_v1_config())


def cut_configs(monkeypatch, port_mods, jax_mods, cut=small_v1_config) -> None:
    """`euroc_v1_config` of the port's modules and the JAX tools cut to
    the same small width (`cut` returns the port's config)."""
    for mod in port_mods:
        monkeypatch.setattr(mod, "euroc_v1_config", cut)
    for mod in jax_mods:
        monkeypatch.setattr(mod, "euroc_v1_config", lambda: jax_config(cut()))


def capture_systems(monkeypatch, *mods) -> list:
    """Every `GMMLocSystem` the given modules construct, in order."""
    made = []
    for mod in mods:
        cls = mod.GMMLocSystem

        def make(*a, _cls=cls, **kw):
            made.append(_cls(*a, **kw))
            return made[-1]

        monkeypatch.setattr(mod, "GMMLocSystem", make)
    return made


def assert_tum_close(path_a: str, path_b: str, tol_m: float, tol_deg=None) -> None:
    """Two TUM trajectories: the same timestamps, camera centres within
    tol_m (and rotations within tol_deg) frame by frame."""
    ta, pa, qa = ate.load_tum(path_a)
    tb, pb, qb = ate.load_tum(path_b)
    np.testing.assert_array_equal(ta, tb)
    d = np.linalg.norm(pa - pb, axis=1)
    assert d.max() < tol_m, f"frame {int(d.argmax())}: {d.max() * 1e3:.3f} mm"
    if tol_deg is not None:
        dot = np.clip(np.abs(np.sum(qa * qb, axis=1)), 0, 1)
        rot = np.degrees(2 * np.arccos(dot))
        assert rot.max() < tol_deg, f"frame {int(rot.argmax())}: {rot.max():.4f} deg"


def assert_runs_match(m, ref) -> None:
    assert set(m) == set(ref) - {"fetches_per_frame"}
    assert set(evaluate.RUN_KEYS) <= set(m)
    for k in ("frames", "tracked", "lost", "kfs", "completed", "target"):
        assert m[k] == ref[k], (k, m[k], ref[k])
    assert abs(m["rmse"] - ref["rmse"]) < 1e-3
    assert set(m["ba_stats"]) == set(ref["ba_stats"]) == set(evaluate.BA_STATS_KEYS)
    for k in ("n_solves", "tiers", "caps_bound"):
        assert m["ba_stats"][k] == ref["ba_stats"][k], k


def assert_ba_stats_equal(port_sys, jax_sys) -> None:
    """`localizer.ba_stats` entry for entry: every key the JAX package
    records, with its value (the BA windows are equal)."""
    a, b = port_sys.localizer.ba_stats, jax_sys.localizer.ba_stats
    assert len(a) == len(b) > 0
    for ea, eb in zip(a, b):
        for k, v in eb.items():
            assert k in ea, k
            if isinstance(v, float):
                assert ea[k] == pytest.approx(v, abs=1e-12), k
            else:
                assert ea[k] == v, k


@pytest.fixture(scope="module")
def eval_fixture(tmp_path_factory):
    return write_eval_fixture(str(tmp_path_factory.mktemp("eval_room")))


@pytest.fixture(scope="module")
def jax_evaluate():
    return load_tool("evaluate")


def test_asset_constants_as_in_the_jax_package():
    for name, tail in (("GT_DIR", "gt_sync"), ("V1_GMM", "v1.gmm"), ("V2_GMM", "v2.gmm")):
        mine, theirs = getattr(synthetic, name), getattr(jax_synthetic, name)
        assert os.path.basename(mine) == os.path.basename(theirs) == tail
        # the same place inside the reference repository's data tree
        rel = lambda p: p[p.index(os.path.join("reference", "gmmloc_ros")):]
        assert rel(mine) == rel(theirs), (mine, theirs)
    assert evaluate.ALL_SEQS == load_tool("evaluate").ALL_SEQS


def test_evaluate_main_matches_jax_run_once(eval_fixture, jax_evaluate, monkeypatch,
                                            tmp_path):
    """The default (fused, pipelined) path: the port's `main` against the
    JAX tool's `run_once` on the same configuration."""
    _ba_in_f32(monkeypatch)
    point_assets(monkeypatch, eval_fixture)
    cut_configs(monkeypatch, [evaluate], [jax_evaluate])
    made = capture_systems(monkeypatch, evaluate)
    jax_made = capture_systems(monkeypatch, jax_evaluate)
    argv = ["--runs", "1", "--frames", str(N_FRAMES), "--start", "0", "--reloc", "0",
            "--out", str(tmp_path / "port"), "--cpu"]
    summary = evaluate.main(argv)
    with open(tmp_path / "port" / "summary.json") as f:
        written = json.load(f)
    assert set(written) == {"V1_01_easy"}
    assert set(written["V1_01_easy"]) == {"rmse_mean", "rmse_std", "completion", "runs"}
    m = summary["V1_01_easy"]["runs"][0]

    args = evaluate.build_parser().parse_args(argv)
    jcfg = jax_config(evaluate.make_config(args))
    gmap = jax_evaluate.mixture.load(
        eval_fixture["gmm"], pad_to=jcfg.caps.gmm_components_pad,
        neighbor_dist_thresh=jcfg.gmm.neighbor_dist_thresh,
        neighbor_cap=jcfg.gmm.neighbor_cap)
    ref_path = str(tmp_path / "jax.txt")
    ref = jax_evaluate.run_once(jcfg, "V1_01_easy", 0, N_FRAMES, 0, gmap, ref_path)

    assert_runs_match(m, ref)
    assert m["completed"] and m["frames"] == N_FRAMES and m["lost"] == 0
    assert_tum_close(str(tmp_path / "port" / "V1_01_easy0.txt"), ref_path, 5e-3)
    assert len(made) == len(jax_made) == 1
    assert_ba_stats_equal(made[0], jax_made[0])
    assert made[0].tracker.dbg["path"] == jax_made[0].tracker.dbg["path"] == "fused"


def test_evaluate_refexact_matches_jax(eval_fixture, jax_evaluate, monkeypatch, tmp_path):
    """`--refexact`: the classic track path, no anchors, the raw
    constant-velocity model."""
    _ba_in_f32(monkeypatch)
    point_assets(monkeypatch, eval_fixture)
    cut_configs(monkeypatch, [evaluate], [jax_evaluate])
    made = capture_systems(monkeypatch, evaluate)
    jax_made = capture_systems(monkeypatch, jax_evaluate)
    args = evaluate.build_parser().parse_args(["--refexact"])
    cfg = evaluate.make_config(args)
    assert args.reloc == 0 and not cfg.tracking.use_fused_track
    assert not cfg.tracking.use_gmm_pose_anchor and cfg.tracking.velocity_damping == 1.0
    gmap = evaluate.load_map(cfg, "V1_01_easy", "cpu")
    m = evaluate.run_once(cfg, "V1_01_easy", 0, N_FRAMES, 0, gmap,
                          str(tmp_path / "port.txt"), device="cpu")
    jcfg = jax_config(cfg)
    jgmap = jax_evaluate.mixture.load(
        eval_fixture["gmm"], pad_to=jcfg.caps.gmm_components_pad,
        neighbor_dist_thresh=jcfg.gmm.neighbor_dist_thresh,
        neighbor_cap=jcfg.gmm.neighbor_cap)
    ref = jax_evaluate.run_once(jcfg, "V1_01_easy", 0, N_FRAMES, 0, jgmap,
                                str(tmp_path / "jax.txt"))
    assert_runs_match(m, ref)
    assert_tum_close(str(tmp_path / "port.txt"), str(tmp_path / "jax.txt"), 5e-3)
    assert made[0].tracker.dbg["path"] == jax_made[0].tracker.dbg["path"] == "classic"
    assert_ba_stats_equal(made[0], jax_made[0])


def test_sequence_vocab_one_per_map(eval_fixture, jax_evaluate, monkeypatch):
    """`_sequence_vocab`: one vocabulary per map, trained once (cached),
    the JAX tool's tree."""
    point_assets(monkeypatch, eval_fixture)
    monkeypatch.setattr(evaluate, "_VOCAB_CACHE", {})
    monkeypatch.setattr(jax_evaluate, "_VOCAB_CACHE", {})
    desc = np.random.default_rng(3).integers(0, 256, (3000, 32), dtype=np.uint8)
    fe = types.SimpleNamespace(world=types.SimpleNamespace(desc=desc))
    voc = evaluate._sequence_vocab("V1_01_easy", fe, "cpu")
    other = types.SimpleNamespace(world=types.SimpleNamespace(desc=desc[::-1].copy()))
    assert evaluate._sequence_vocab("V1_02_medium", other, "cpu") is voc
    ref = jax_evaluate._sequence_vocab("V1_01_easy", fe)
    np.testing.assert_array_equal(voc.node_desc, ref.node_desc)
    np.testing.assert_array_equal(voc.children, ref.children)
    np.testing.assert_array_equal(voc.word_id, ref.word_id)


def test_evaluate_config_overrides_as_jax(jax_evaluate, monkeypatch):
    """Every tracking/loc/caps override of the command line lands where
    the JAX tool puts it."""
    argv = ["--fused", "1", "--pipelined", "0", "--depth", "4", "--qcap", "3",
            "--anchor", "0", "--ema", "0.5", "--jump", "0.7", "--ba_impl", "flat",
            "--mo", "6", "--online", "--damping", "0.8"]
    cfg = evaluate.make_config(evaluate.build_parser().parse_args(argv))
    ref = {}

    def capture(cfg_, *a, **kw):
        ref["cfg"] = cfg_
        raise SystemExit(0)

    monkeypatch.setattr(jax_evaluate, "run_once", capture)
    monkeypatch.setattr(jax_evaluate.mixture, "load", lambda *a, **kw: None)
    monkeypatch.setattr(jax_evaluate, "install_signal_handlers", lambda: None,
                        raising=False)
    import gmmloc_tpu.utils.control as jax_control

    monkeypatch.setattr(jax_control, "install_signal_handlers", lambda *a: None)
    monkeypatch.setattr(sys, "argv", ["evaluate.py", "--out", "/dev/null/x"] + argv)
    monkeypatch.setattr(os, "makedirs", lambda *a, **kw: None)
    with pytest.raises(SystemExit):
        jax_evaluate.main()
    assert dataclasses.asdict(jax_config(cfg)) == dataclasses.asdict(ref["cfg"])
    assert isinstance(ref["cfg"], jax_config_mod.SystemConfig)


def protocol_reference(package: str, a, fx: dict, traj) -> list:
    """`a.runs` runs of one package's `run_once` on the fixture `fx`
    (the script's arguments `a`); prints and returns their records."""
    import time

    args = evaluate.build_parser().parse_args(["--damping", "0.9", "--reloc", "1",
                                               "--depth", str(a.depth)])
    cfg = evaluate.make_config(args)
    if a.feat_cap < 1280:
        cfg = cfg.replace(
            frame=dataclasses.replace(cfg.frame, feat_cap=a.feat_cap,
                                      num_features=a.feat_cap - 16),
            tracking=dataclasses.replace(cfg.tracking, fused_local_map_cap=4 * a.feat_cap))
    for mod in (synthetic, jax_synthetic):
        mod.GT_DIR, mod.V1_GMM, mod.V2_GMM = fx["gt_dir"], fx["gmm"], fx["gmm"]
    if package == "jax":
        tool, cfg = load_tool("evaluate"), jax_config(cfg)
        gmap = tool.mixture.load(fx["gmm"], pad_to=cfg.caps.gmm_components_pad,
                                 neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
                                 neighbor_cap=cfg.gmm.neighbor_cap)
        run = lambda r, path: tool.run_once(cfg, "V1_01_easy", r, a.frames, a.start,  # noqa: E731
                                            gmap, path, vocabulary="train")
    else:
        evaluate._VOCAB_CACHE.clear()
        gmap = evaluate.load_map(cfg, "V1_01_easy", "cpu")
        run = lambda r, path: evaluate.run_once(cfg, "V1_01_easy", r, a.frames, a.start,  # noqa: E731
                                                gmap, path, vocabulary="train",
                                                device="cpu")
    _, _, t_wc = traj
    out = []
    for r in range(a.runs):
        t0 = time.perf_counter()
        path = os.path.join(a.out, f"{package}{r}_depth{a.depth}.txt")
        m = run(r, path)
        _, p_est, _ = ate.load_tum(path)
        err = np.linalg.norm(p_est - t_wc[a.start:a.start + len(p_est)], axis=1)
        out.append(dict(package=package, run=r, feat_cap=a.feat_cap, depth=a.depth,
                        start=a.start, frames=m["frames"], lost=m["lost"],
                        max_err_m=float(err.max()), max_err_frame=a.start + int(err.argmax()),
                        mean_err_m=float(err.mean()), rmse_m=float(m["rmse"]),
                        kfs=int(m["kfs"]), ba_solves=m.get("ba_stats", {}).get("n_solves"),
                        seconds=time.perf_counter() - t0, device="cpu"))
        print(json.dumps(out[-1]), flush=True)
    return out


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="the evaluation protocol of both packages")
    ap.add_argument("--package", default="jax,port")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--start", type=int, default=150)
    ap.add_argument("--feat-cap", type=int, default=256)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "protocol_reference"))
    a = ap.parse_args()
    gmm_path, gt_path = room_fixture.write_room_fixture(
        a.out, n_components=3300, n_frames=a.start + a.frames + 50)
    gt_dir = os.path.join(a.out, "gt")
    os.makedirs(gt_dir, exist_ok=True)
    shutil.copy(gt_path, os.path.join(gt_dir, "V1_01_easy.txt"))
    traj = synthetic.load_gt_trajectory(gt_path)
    for package in a.package.split(","):
        protocol_reference(package, a, dict(gt_dir=gt_dir, gmm=gmm_path), traj)
    return 0


if __name__ == "__main__":
    sys.exit(main())
