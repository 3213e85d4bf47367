#!/usr/bin/env python3
"""The bench's online line with the mapper free and paced, through the
port and (on the CPU) the JAX package.

    python tools/torch_online_drift.py [--cpu] [--package port,jax]
        [--pace free,paced] [--feat-cap N] [--frames 600] [--warm 60]
        [--fixture DIR]

Writes the bench's room fixture (`eval.bench.write_fixture`: 3300
components) and makes the online line's feature frames from frame 150
(`eval.bench.feature_frames`: 30000 landmarks), as the bench's online
child does. Each run steps them through one package's `GMMLocSystem` in
the bench's online configuration (`slice_run.production_config(True)`:
depth 4, the mapper on its own thread) with the mapper either `free` (as
the bench runs it: the tracker goes on while the mapper works, so the
result follows the two threads' pace) or `paced` (`slice_run.pace_mapper`
after each step: the mapper finishes each keyframe before the next frame,
so the run repeats bit for bit). Prints one JSON line per run: frames
tracked, max and mean camera-centre error, the first frame over 8 cm,
the share of the frames after `--warm` whose pose solve kept GMM anchors
(overall and per 100 frames), keyframes, local-BA solves, frames per
second. The port runs on the card unless `--cpu` is given; the JAX
package runs only with `--cpu` (its CPU backend).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_M = 0.08


def build(package: str, cfg, n_frames: int, device):
    """(system, frames, q_wc, t_wc) of one package on the fixture."""
    from gmmloc_tpu_torch.eval import bench

    if package == "jax":
        from gmmloc_tpu.eval import synthetic as jsynthetic
        from gmmloc_tpu.gmm import mixture as jmixture
        from gmmloc_tpu.pipeline.system import GMMLocSystem as JaxSystem
        from gmmloc_tpu_torch.eval import synthetic
        from torch_image_reference import jax_config

        jcfg = jax_config(cfg)
        system = JaxSystem(jcfg, jmixture.load(synthetic.V1_GMM, **bench.map_kwargs(jcfg)))
        return (system, *bench.feature_frames(jcfg, n_frames, jsynthetic.make_sequence))
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

    system = GMMLocSystem(cfg, bench.load_map(cfg, device), device)
    return (system, *bench.feature_frames(cfg, n_frames))


def run_one(package: str, pace: str, a, device) -> dict:
    import numpy as np

    from gmmloc_tpu_torch.eval import bench, slice_run

    cfg = bench.line_config("online", a.feat_cap)
    system, frames, q_wc, t_wc = build(package, cfg, a.frames, device)
    sync = slice_run.stream_sync(device) if package == "port" else (lambda: None)
    anchors = slice_run._AnchorLog(system)
    sync()
    t0 = time.perf_counter()
    n_done = 0
    for i, f in enumerate(frames):
        system.step(f, q_wc[bench.START + i], t_wc[bench.START + i])
        if system.track_failed:
            break
        if pace == "paced":
            slice_run.pace_mapper(system)
        n_done += 1
        anchors.record()
    system.flush()
    system.stop()
    anchors.record()
    sync()
    seconds = time.perf_counter() - t0
    errs = slice_run.pose_errors(frames[:n_done], t_wc[bench.START:bench.START + n_done])
    meas = np.array(anchors.n_anchors[a.warm:n_done]) > 0
    over = np.nonzero(errs > GATE_M)[0]
    return dict(
        package=package, pace=pace, device=str(device), feat_cap=cfg.frame.feat_cap,
        frames=n_done, frames_asked=a.frames, track_failed=bool(system.track_failed),
        max_err_m=float(errs.max()), mean_err_m=float(errs.mean()),
        argmax_err_frame=int(errs.argmax()),
        first_over_8cm=int(over[0]) if len(over) else None,
        anchored_share=float(meas.mean()) if len(meas) else None,
        anchored_share_per_100=[round(float(meas[k:k + 100].mean()), 3)
                                for k in range(0, len(meas), 100)],
        keyframes=int(system.world.n_keyframes()), ba_solves=len(system.localizer.ba_stats),
        fps=n_done / seconds, seconds=seconds)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run the port on the CPU")
    ap.add_argument("--package", default="port")
    ap.add_argument("--pace", default="free,paced")
    ap.add_argument("--feat-cap", type=int, default=None,
                    help="features per frame (default: the configuration's 1280)")
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--warm", type=int, default=60)
    ap.add_argument("--fixture", default=os.path.join(ROOT, "build", "online_drift"))
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from gmmloc_tpu_torch.eval import bench

    packages = a.package.split(",")
    if "jax" in packages and not a.cpu:
        ap.error("the JAX package runs here only with --cpu")
    device = torch.device("cpu" if a.cpu else "cuda")
    bench.write_fixture(a.fixture, bench.START + a.frames + 50)
    bench.point_assets(a.fixture)
    if device.type == "cuda":
        print(json.dumps({"device": bench.card_name(device)}), flush=True)
    ok = True
    for package in packages:
        for pace in a.pace.split(","):
            r = run_one(package, pace, a, device)
            print(json.dumps(r), flush=True)
            ok = ok and not r["track_failed"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
