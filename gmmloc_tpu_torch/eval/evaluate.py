"""Evaluation harness: the reference's evaluate_euroc.sh protocol.

Twin of the JAX package's `tools/evaluate.py` (ref gmmloc_ros
scripts/evaluate_euroc.sh: runs per sequence, offline single-thread,
TUM trajectory export; scripts/evo_euroc.py: APE translation mean/RMSE
after SE3+scale Umeyama alignment). Runs the full system on feature-level
synthetic sequences (`synthetic`) generated along the EuRoC ground-truth
trajectories under `synthetic.GT_DIR` against landmarks sampled from the
prior maps (`synthetic.V1_GMM` for V1_*, `V2_GMM` for V2_*). Where those
assets are absent, point the three names at a room fixture
(`room_fixture.write_room_fixture`, its trajectory copied to
`GT_DIR/<seq>.txt`), as the tests and `chip_smoke.py` do.

    python -m gmmloc_tpu_torch.eval.evaluate [--runs 5] [--frames 500]
        [--start 150] [--seqs V1_01_easy,V1_02_medium,...] [--out expr/]
        [--cpu]

Writes `<out>/<seq><run>.txt` (TUM) per run and `<out>/summary.json`.
Runs on the card unless `--cpu` is given; the JAX tool's `--prec` has no
counterpart (the port keeps TF32 off) and its `fetches_per_frame` field
none either (there is no tunnel fetch to count).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from ..config import euroc_v1_config
from ..gmm import mixture
from ..pipeline.system import GMMLocSystem
from . import ate, synthetic
from .slice_run import stream_sync

ALL_SEQS = [
    "V1_01_easy", "V1_02_medium", "V1_03_difficult",
    "V2_01_easy", "V2_02_medium", "V2_03_difficult",
]

# the keys of one run's record in summary.json (those of the JAX tool but
# `fetches_per_frame`); `ba_stats` is there when a BA ran
RUN_KEYS = ("rmse", "mean", "median", "n", "frames", "tracked", "lost", "target",
            "fps", "kfs", "pts", "completed")
BA_STATS_KEYS = ("n_solves", "pts_p50", "pts_p95", "local_p95", "obs_mean", "obs_p95",
                 "tiers", "caps_bound")

_VOCAB_CACHE = {}


def gmm_path_of(seq: str) -> str:
    return synthetic.V2_GMM if seq.startswith("V2") else synthetic.V1_GMM


def _sequence_vocab(seq, fe, device="cuda"):
    """One vocabulary per map, trained once from the first run's landmark
    signatures and cached: the reference uses one fixed vocabulary for
    every run (evaluate_euroc.sh voc/ORBvoc.bin; ORBvoc.bin is not in the
    reference repository)."""
    from ..vocab.bow import Vocabulary

    key = ("V2" if seq.startswith("V2") else "V1", gmm_path_of(seq))
    if key not in _VOCAB_CACHE:
        sub = fe.world.desc[:: max(1, len(fe.world.desc) // 20000)]
        _VOCAB_CACHE[key] = Vocabulary.train(sub, k=10, depth=4, seed=0, device=device)
    return _VOCAB_CACHE[key]


def load_map(cfg, seq: str, device="cuda"):
    return mixture.load(gmm_path_of(seq), device, pad_to=cfg.caps.gmm_components_pad,
                        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
                        neighbor_cap=cfg.gmm.neighbor_cap)


def ba_summary(bs) -> dict:
    """The BA window occupancy of a run's `localizer.ba_stats`."""
    return {
        "n_solves": len(bs),
        "pts_p50": float(np.median([s["n_pts"] for s in bs])),
        "pts_p95": float(np.percentile([s["n_pts"] for s in bs], 95)),
        "local_p95": float(np.percentile([s["n_local"] for s in bs], 95)),
        "obs_mean": float(np.mean([s["obs_mean"] for s in bs])),
        "obs_p95": float(np.mean([s["obs_p95"] for s in bs])),
        "tiers": sorted(set((s["L"], s["P"]) for s in bs)),
        # solves where a window cap dropped constraints (no silent
        # truncation: should be 0)
        "caps_bound": int(sum(1 for s in bs if s.get("dropped_local")
                              or s.get("dropped_pts") or s.get("dropped_fixed"))),
    }


def run_once(cfg, seq: str, run_idx: int, n_frames: int, start: int, gmap,
             out_path=None, vocabulary=None, pace_hz: float = 0.0, viewer=None,
             device="cuda"):
    """One run of `seq` (noise seed `run_idx`) over `n_frames` from
    `start`. `vocabulary="train"` trains (or takes the cached) vocabulary
    of the sequence's map. Returns the run's record (`RUN_KEYS`, and
    `ba_stats` when a BA ran)."""
    from ..utils.control import control as ctl

    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, gt_path=f"{synthetic.GT_DIR}/{seq}.txt", gmm_path=gmm_path_of(seq),
        n_landmarks=30000, seed=run_idx, disp_noise=0.1, pixel_noise=0.25,
        drop_frac=0.1)
    if vocabulary == "train":
        vocabulary = _sequence_vocab(seq, fe, device)
    N = min(n_frames, len(ts) - start)
    sys_ = GMMLocSystem(cfg, gmap, device, vocabulary=vocabulary)
    sync = stream_sync(sys_.device)
    # the harness stays off the clock: every frame made before the timed
    # window (the synthetic front end is not the system under measurement)
    frames = [fe.make_frame(i, ts[start + i], q_wc[start + i], t_wc[start + i])
              for i in range(N)]
    sync()
    t0 = time.time()
    done = tracked = 0
    for i in range(N):
        # run-control gate (ref gmmloc.cpp:128-131)
        while not ctl.should_run() and not ctl.stop:
            time.sleep(0.001)
        ctl.consume_step()
        if ctl.stop:
            break
        if pace_hz > 0:
            # camera-rate pacing (ref gmmloc.cpp:124 ros::Rate(20)): frame
            # i is not available before i / pace_hz; the mapper uses the
            # slack
            t_due = t0 + i / pace_hz
            now = time.time()
            if now < t_due:
                time.sleep(t_due - now)
        fi = start + i
        st = sys_.step(frames[i], q_wc[fi], t_wc[fi])
        if sys_.track_failed:
            break
        done += 1
        tracked += int(st.res) if st is not None else 0
        if viewer is not None:
            viewer.maybe_update(sys_.world)
        if done % 200 == 0:
            print(f"  [{seq} r{run_idx}] {done}/{N} frames "
                  f"({done / (time.time() - t0):.1f} fps)", flush=True)
    st = sys_.flush()
    tracked += int(st.res) if st is not None else 0
    # the caller's stream only: online, the mapper may be capturing a
    # CUDA graph on its own stream (a device-wide synchronize would fail)
    sync()
    wall = time.time() - t0
    sys_.stop()   # drain the mapper before the export (no-op offline)
    ts_est, _, t_est = sys_.export_trajectory()
    if out_path:
        sys_.world.save_trajectory_tum(out_path)
    m = ate.ate_rmse(ts_est, t_est, ts[start:start + done], t_wc[start:start + done])
    m.update(frames=done, tracked=tracked, lost=sys_.n_lost, target=N,
             fps=done / wall if wall > 0 else 0.0, kfs=sys_.world.n_keyframes(),
             pts=sys_.world.n_points(), completed=done == N)
    bs = sys_.localizer.ba_stats
    if bs:
        m["ba_stats"] = ba_summary(bs)
    return m


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--start", type=int, default=150)
    ap.add_argument("--seqs", default="V1_01_easy")
    ap.add_argument("--out", default="expr")
    ap.add_argument("--damping", type=float, default=0.9)
    ap.add_argument("--reloc", type=int, default=1,
                    help="1: BoW relocalization rescue; 0: reference parity "
                         "(terminate on loss)")
    ap.add_argument("--fused", type=int, default=None,
                    help="override tracking.use_fused_track")
    ap.add_argument("--pipelined", type=int, default=None,
                    help="override tracking.pipelined_track")
    ap.add_argument("--depth", type=int, default=None,
                    help="override tracking.pipeline_depth (> 1: the device-chained "
                         "pipeline)")
    ap.add_argument("--pace", type=float, default=0.0,
                    help="pace the frame loop at this camera rate in Hz (0: free "
                         "running; the reference's online mode runs at 20 Hz)")
    ap.add_argument("--qcap", type=int, default=None,
                    help="override tracking.kf_queue_cap")
    ap.add_argument("--anchor", type=int, default=None,
                    help="override tracking.use_gmm_pose_anchor")
    ap.add_argument("--ema", type=float, default=None,
                    help="override tracking.velocity_ema")
    ap.add_argument("--jump", type=float, default=None,
                    help="override tracking.max_jump_trans (m/frame)")
    ap.add_argument("--ba_impl", default=None,
                    help="override loc.ba_schur_impl (flatpm|flat|blockdiag)")
    ap.add_argument("--mo", type=int, default=None,
                    help="override caps.ba_obs_per_point")
    ap.add_argument("--refexact", action="store_true",
                    help="reference-exact tracking contract: classic path, no GMM "
                         "pose anchors, raw constant-velocity model, plausibility "
                         "gate off, terminate on loss")
    ap.add_argument("--online", action="store_true",
                    help="mapping and BA on the mapper thread")
    ap.add_argument("--timing", action="store_true",
                    help="print the host timer table per run")
    ap.add_argument("--viewer", default=None,
                    help="HTML file re-exported every --viewer-interval seconds "
                         "from the running system")
    ap.add_argument("--viewer-interval", type=float, default=2.0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def make_config(args):
    """`euroc_v1_config()` with the command line's overrides (`--refexact`
    sets its defaults into `args` first)."""
    cfg = euroc_v1_config()
    if args.refexact:
        args.reloc = 0
        args.damping = 1.0
        args.ema = 1.0 if args.ema is None else args.ema
        args.anchor = 0 if args.anchor is None else args.anchor
        args.fused = 0 if args.fused is None else args.fused
        args.jump = 1e9 if args.jump is None else args.jump
    tk = dict(velocity_damping=args.damping)
    for name, field, conv in (("fused", "use_fused_track", bool),
                              ("pipelined", "pipelined_track", bool),
                              ("depth", "pipeline_depth", int),
                              ("qcap", "kf_queue_cap", int),
                              ("anchor", "use_gmm_pose_anchor", bool),
                              ("ema", "velocity_ema", float),
                              ("jump", "max_jump_trans", float)):
        if getattr(args, name) is not None:
            tk[field] = conv(getattr(args, name))
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, **tk))
    if args.online:
        cfg = cfg.replace(online=True)
    if args.ba_impl is not None:
        cfg = cfg.replace(loc=dataclasses.replace(cfg.loc, ba_schur_impl=args.ba_impl))
    if args.mo is not None:
        cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, ba_obs_per_point=args.mo))
    return cfg


def main(argv=None) -> dict:
    """The protocol over `--seqs`; returns the summary (as written to
    summary.json). From the command line (`argv` None) it installs the
    run-control signal handlers: SIGUSR1 pause, SIGUSR2 step, SIGTERM
    stop."""
    args = build_parser().parse_args(argv)
    if argv is None:
        from ..utils.control import install_signal_handlers

        install_signal_handlers()
    device = "cpu" if args.cpu else "cuda"
    os.makedirs(args.out, exist_ok=True)
    cfg = make_config(args)
    seqs = args.seqs.split(",") if args.seqs != "all" else ALL_SEQS

    results, gmaps = {}, {}
    for seq in seqs:
        gmm_path = gmm_path_of(seq)
        if gmm_path not in gmaps:
            gmaps[gmm_path] = load_map(cfg, seq, device)
        viewer = None
        if args.viewer:
            from ..pipeline.live_viewer import LiveViewer
            from ..utils import proto

            means, covs, _, _ = proto.load_gmm_file(gmm_path)
            viewer = LiveViewer(args.viewer, interval=args.viewer_interval,
                                gmm={"means": means, "covs": covs})
        runs = []
        for r in range(args.runs):
            m = run_once(cfg, seq, r, args.frames, args.start, gmaps[gmm_path],
                         os.path.join(args.out, f"{seq}{r}.txt"),
                         vocabulary="train" if args.reloc else None,
                         pace_hz=args.pace, viewer=viewer, device=device)
            runs.append(m)
            print(f"{seq} run{r}: rmse={m['rmse'] * 100:.2f}cm "
                  f"mean={m['mean'] * 100:.2f}cm frames={m['frames']}/{m['target']} "
                  f"lost={m['lost']} fps={m['fps']:.2f} kfs={m['kfs']}", flush=True)
            if args.timing:
                from ..utils import timing

                print(timing.print_table(), flush=True)
                timing.reset()
        rmses = [m["rmse"] for m in runs]
        results[seq] = {
            "rmse_mean": float(np.mean(rmses)),
            "rmse_std": float(np.std(rmses)),
            "completion": float(np.mean([m["completed"] for m in runs])),
            "runs": runs,
        }

    print("\n=== summary ===")
    for seq, r in results.items():
        print(f"{seq}: ATE rmse {r['rmse_mean'] * 100:.2f} ± {r['rmse_std'] * 100:.2f} cm "
              f"(completion {r['completion'] * 100:.0f}%)")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    return results


if __name__ == "__main__":
    main()
