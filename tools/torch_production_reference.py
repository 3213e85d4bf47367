#!/usr/bin/env python3
"""The production configuration's feature frames through the JAX package and
the port, on the CPU, at a small width.

    JAX_PLATFORMS=cpu python tools/torch_production_reference.py
        [--package jax,port] [--runs slice,offline,online] [--frames 120]
        [--warmup 25] [--out DIR]

Writes the seeded room fixture (400 components, as the parity tests use)
and makes the synthetic feature frames of `tests/test_torch_system.py`
(4000 landmarks, feat_cap 256, 240 features, a local-map cap of 1024).
Each run steps them through one package's `GMMLocSystem` on one
configuration: `slice` (`slice_run.slice_config`), `offline` and `online`
(`slice_run.production_config(online)`, the configuration of the JAX
package's `bench.py`: depth 4, the device-world mirror, online mapping
as asked), then flushes and stops the mapper. Prints one JSON line per run:
max and mean camera-centre error against the fixture's ground truth,
keyframes, local-BA solves (the port also their LM iterations), and the share of the
frames after `--warmup` whose pose solve kept GMM anchors (the anchor
term needs associations a BA has vetted, so the share follows the
mapper's BA cadence). Online results depend on thread timing and differ
from run to run. `chip_smoke.py` takes its production error gate and its
online anchor gate from these readings.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configs(name: str):
    from gmmloc_tpu_torch.eval import slice_run

    widths = dict(feat_cap=256, num_features=240, local_map_cap=1024)
    if name == "slice":
        return slice_run.slice_config(**widths)
    return slice_run.production_config(name == "online", **widths)


def build(package: str, cfg, gmm_path, gt_path):
    """(system, frames, q_wc, t_wc) of one package."""
    from gmmloc_tpu_torch.eval import synthetic
    from gmmloc_tpu_torch.gmm import mixture
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

    gkw = dict(pad_to=512, neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
               neighbor_cap=cfg.gmm.neighbor_cap)
    if package == "jax":
        from gmmloc_tpu.eval import synthetic as jsynthetic
        from gmmloc_tpu.gmm import mixture as jmixture
        from gmmloc_tpu.pipeline.system import GMMLocSystem as JaxSystem
        from torch_image_reference import jax_config

        jcfg = jax_config(cfg)
        mod, system = jsynthetic, JaxSystem(jcfg, jmixture.load(gmm_path, **gkw))
        cfg = jcfg
    else:
        mod, system = synthetic, GMMLocSystem(cfg, mixture.load(gmm_path, "cpu", **gkw),
                                              "cpu")
    fe, ts, q_wc, t_wc = mod.make_sequence(
        cfg, gt_path=gt_path, gmm_path=gmm_path, n_landmarks=4000, seed=0,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1)
    return system, fe, ts, q_wc, t_wc


def run_one(package: str, name: str, a, gmm_path, gt_path) -> dict:
    import numpy as np

    from gmmloc_tpu_torch.eval import slice_run

    t0 = time.perf_counter()
    system, fe, ts, q_wc, t_wc = build(package, configs(name), gmm_path, gt_path)
    frames = [fe.make_frame(i, ts[i], q_wc[i], t_wc[i]) for i in range(a.frames)]
    n_anchors, dbg = [], system.tracker.dbg
    for i, f in enumerate(frames):
        system.step(f, q_wc[i], t_wc[i])
        if system.track_failed:
            break
        if system.tracker.dbg is not dbg:      # one new dict per completed frame
            dbg = system.tracker.dbg
            n_anchors.append(dbg.get("n_anchors", 0))
    system.flush()
    if system.tracker.dbg is not dbg:
        n_anchors.append(system.tracker.dbg.get("n_anchors", 0))
    system.stop()
    errs = slice_run.pose_errors(frames, t_wc)
    meas = np.array(n_anchors[a.warmup:])
    stats = system.localizer.ba_stats
    iters = [s["n_iters"] for s in stats if "n_iters" in s]   # the port's record
    return dict(package=package, config=name, frames=a.frames,
                track_failed=bool(system.track_failed),
                max_err_m=float(errs.max()), mean_err_m=float(errs.mean()),
                keyframes=int(system.world.n_keyframes()), ba_solves=len(stats),
                ba_iters_mean=float(np.mean(iters)) if iters else None,
                anchored_frames=int((meas > 0).sum()), measured_frames=len(meas),
                anchored_share=float((meas > 0).mean()) if len(meas) else 0.0,
                anchors_mean=float(meas.mean()) if len(meas) else 0.0,
                seconds=time.perf_counter() - t0, device="cpu")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", default="jax,port")
    ap.add_argument("--runs", default="slice,offline,online")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--warmup", type=int, default=25)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "production_reference"))
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from gmmloc_tpu_torch.eval import room_fixture

    torch.set_num_threads(1)
    gmm_path, gt_path = room_fixture.write_room_fixture(
        a.out, n_components=400, n_frames=a.frames + 50, seed=0)
    ok = True
    for package in a.package.split(","):
        for name in a.runs.split(","):
            r = run_one(package, name, a, gmm_path, gt_path)
            print(json.dumps(r), flush=True)
            ok = ok and not r["track_failed"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
