"""Image-level evaluation: sprite-rendered stereo -> the ORB front end ->
tracking and mapping -> ATE.

Twin of the JAX package's `tools/evaluate_image.py`. Renders stereo
pairs of a sprite world sampled from the prior map (`synthetic.V1_GMM`
or `V2_GMM`) along the ground-truth trajectory under `synthetic.GT_DIR`
and drives the whole pipeline through them: detection (FAST + NMS, the
K4 kernel), descriptors, stereo matching, tracking and mapping. The
rendering stays off the clock. With `--packed 1` (the default) the front
end runs one pass per frame, double-buffered: frame i's pass is
dispatched before frame i - 1 is completed and stepped.

    python -m gmmloc_tpu_torch.eval.evaluate_image [--seqs V1_01_easy]
        [--runs 1] [--frames 600] [--start 0] [--out expr_img] [--cpu]

Writes `<out>/<seq><run>.txt` (TUM) per run and `<out>/summary.json`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from ..config import euroc_v1_config
from ..pipeline.frontend import ImageFrontend
from ..pipeline.system import GMMLocSystem
from ..utils import proto
from . import ate, synthetic
from .evaluate import gmm_path_of, load_map
from .image_synthetic import SpriteRenderer
from .slice_run import stream_sync

# the keys of one run's record in summary.json (the JAX tool's); a run
# with a recovery also has `segments` and, where one segment starts at a
# recovery, `post_recovery_rmse`
RUN_KEYS = ("rmse", "mean", "median", "n", "frames", "target", "fps", "kfs", "pts",
            "completed", "lost", "recoveries")


def render_pairs(cfg, seq: str, run_idx: int, n_frames: int, start: int,
                 n_landmarks: int = 9000):
    """The sprite world of run `run_idx` and its uint8 stereo pairs for
    frames start .. start + N - 1. Returns (world, pairs, ts, q_wc, t_wc)
    with the whole trajectory."""
    ts, q_wc, t_wc = synthetic.load_gt_trajectory(f"{synthetic.GT_DIR}/{seq}.txt")
    means, covs, _, _ = proto.load_gmm_file(gmm_path_of(seq))
    world = synthetic.sample_world_from_gmm(means, covs, n_landmarks=n_landmarks,
                                            seed=run_idx)
    renderer = SpriteRenderer(world, cfg, seed=run_idx)
    to8 = lambda im: np.clip(np.round(im), 0, 255).astype(np.uint8)
    pairs = []
    for i in range(min(n_frames, len(ts) - start)):
        left, right = renderer.render_stereo(q_wc[start + i], t_wc[start + i])
        pairs.append((to8(left), to8(right)))
    return world, pairs, ts, q_wc, t_wc


def run_once(cfg, seq, run_idx, n_frames, start, gmap, out_path=None, packed=True,
             reloc=False, n_landmarks=9000, device="cuda"):
    """One run; returns its record (the JAX tool's keys, with
    `post_recovery_rmse` and `segments` after a recovery)."""
    world, imgs, ts, q_wc, t_wc = render_pairs(cfg, seq, run_idx, n_frames, start,
                                               n_landmarks)
    frontend = ImageFrontend(cfg, device=device)
    voc = None
    if reloc:
        from ..vocab.bow import Vocabulary

        voc = Vocabulary.train(world.desc[:: max(1, len(world.desc) // 20000)],
                               k=10, depth=4, seed=0, device=device)
    sys_ = GMMLocSystem(cfg, gmap, device, vocabulary=voc)
    sync = stream_sync(sys_.device)
    N = len(imgs)
    sync()
    t0 = time.time()
    done = 0
    pend, i_prev = None, -1
    for i in range(N + 1):
        # double-buffered front end: frame i's pass runs on the device
        # while the tracker steps frame i - 1 (ref gmmloc.cpp:241-249)
        pend_new = None
        if i < N and packed:
            pend_new = frontend.dispatch(i, ts[start + i], *imgs[i])
        if packed:
            if pend is None:
                pend, i_prev = pend_new, i
                continue
            frame = frontend.complete(pend)
            step_i = i_prev
            pend, i_prev = pend_new, i
        else:
            if i >= N:
                break
            frame = frontend.process(i, ts[start + i], *imgs[i])
            step_i = i
        fi = start + step_i
        sys_.step(frame, q_wc[fi], t_wc[fi])
        if sys_.track_failed:
            break
        done += 1
        if done % 100 == 0:
            print(f"  [{seq} r{run_idx}] {done}/{N} frames "
                  f"({done / (time.time() - t0):.1f} fps)", flush=True)
    sys_.flush()
    sync()
    wall = time.time() - t0
    sys_.stop()
    ts_est, _, t_est = sys_.export_trajectory()
    if out_path:
        sys_.world.save_trajectory_tum(out_path)
    m = ate.ate_rmse(ts_est, t_est, ts[start:start + done], t_wc[start:start + done])
    m.update(frames=done, target=N, fps=done / wall if wall > 0 else 0.0,
             kfs=sys_.world.n_keyframes(), pts=sys_.world.n_points(),
             completed=done == N, lost=sys_.n_lost,
             recoveries=len(sys_.recovery_frames))
    # split-at-recovery scoring: each segment between recoveries is scored
    # with its own alignment; post_recovery_rmse pools the segments that
    # start at a recovery
    if sys_.recovery_frames and len(ts_est):
        rec_ts = [ts[start + ri] for ri in sys_.recovery_frames if start + ri < len(ts)]
        bounds = [ts_est[0] - 1.0] + rec_ts + [ts_est[-1] + 1.0]
        segs = []
        for si, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            sel = (ts_est >= a) & (ts_est < b)
            if sel.sum() < 30:
                continue
            sm = ate.ate_rmse(ts_est[sel], t_est[sel], ts[start:start + done],
                              t_wc[start:start + done])
            segs.append({"segment": si, "n": int(sel.sum()), "rmse": float(sm["rmse"]),
                         "post_recovery": si > 0})
        post = [s for s in segs if s["post_recovery"]]
        if post:
            n_tot = sum(s["n"] for s in post)
            m["post_recovery_rmse"] = float(
                np.sqrt(sum(s["n"] * s["rmse"] ** 2 for s in post) / n_tot))
        m["segments"] = segs
    return m


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--seqs", default="V1_01_easy")
    ap.add_argument("--out", default="expr_img")
    ap.add_argument("--damping", type=float, default=0.9)
    ap.add_argument("--refexact", action="store_true",
                    help="reference-exact tracking contract: raw constant-velocity "
                         "model, GMM pose anchors off, plausibility gate off, no "
                         "relocalization")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--reloc", type=int, default=0,
                    help="1: arm the BoW relocalization rescue; 0: terminate on loss")
    ap.add_argument("--packed", type=int, default=1,
                    help="1: one front-end pass per frame, double-buffered against "
                         "the tracker; 0: the per-stage path")
    ap.add_argument("--depth", type=int, default=None,
                    help="override tracking.pipeline_depth")
    ap.add_argument("--distribution", default=None,
                    help="keypoint distribution: quota (default) | octree")
    ap.add_argument("--landmarks", type=int, default=9000,
                    help="sprite-world landmark count")
    return ap


def make_config(args):
    cfg = euroc_v1_config()
    tk = dict(velocity_damping=args.damping, use_fused_track=True, pipelined_track=True)
    if args.refexact:
        tk.update(velocity_damping=1.0, velocity_ema=1.0, use_gmm_pose_anchor=False,
                  max_jump_trans=1e9)
    if args.depth is not None:
        tk["pipeline_depth"] = args.depth
    fr = {}
    if args.distribution:
        fr["detect_distribution"] = args.distribution
    return cfg.replace(
        camera=dataclasses.replace(cfg.camera, do_rectify=False, do_equalization=False),
        tracking=dataclasses.replace(cfg.tracking, **tk),
        frame=dataclasses.replace(cfg.frame, **fr))


def main(argv=None) -> dict:
    """The image-level protocol over `--seqs`; returns the summary (as
    written to summary.json)."""
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    os.makedirs(args.out, exist_ok=True)
    cfg = make_config(args)
    results, gmaps = {}, {}
    for seq in args.seqs.split(","):
        gmm_path = gmm_path_of(seq)
        if gmm_path not in gmaps:
            gmaps[gmm_path] = load_map(cfg, seq, device)
        runs = []
        for r in range(args.runs):
            m = run_once(cfg, seq, r, args.frames, args.start, gmaps[gmm_path],
                         os.path.join(args.out, f"{seq}{r}.txt"),
                         packed=bool(args.packed), reloc=bool(args.reloc),
                         n_landmarks=args.landmarks, device=device)
            runs.append(m)
            post = (f" post_rec={m['post_recovery_rmse'] * 100:.2f}cm"
                    if "post_recovery_rmse" in m else "")
            print(f"{seq} run{r}: rmse={m['rmse'] * 100:.2f}cm "
                  f"frames={m['frames']}/{m['target']} fps={m['fps']:.2f} "
                  f"kfs={m['kfs']} rec={m.get('recoveries', 0)}{post}", flush=True)
        results[seq] = {
            "rmse_mean": float(np.mean([m["rmse"] for m in runs])),
            "completion": float(np.mean([m["completed"] for m in runs])),
            "runs": runs,
        }
    print("\n=== image-level summary ===")
    for seq, r in results.items():
        print(f"{seq}: ATE rmse {r['rmse_mean'] * 100:.2f} cm "
              f"(completion {r['completion'] * 100:.0f}%)")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    return results


if __name__ == "__main__":
    main()
