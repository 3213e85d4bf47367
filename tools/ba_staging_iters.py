#!/usr/bin/env python3
"""LM iterations of the local BA with and without bfloat16 staging, in the
port and in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/ba_staging_iters.py [--frames 30]

Runs both packages' `GMMLocSystem` over the same seeded room-fixture
feature frames (the reduced slice of tests/test_torch_system.py:
feat_cap 256, 240 features, a 400-component map, 4000 landmarks) once
with the local BA at its default (`use_bf16=True`) and once in float32,
and prints, for each run, the LM iterations of every BA solve and the
keyframe frames. Iteration counts are counts, not times: they say how
much more work the staging asks of the BA on any device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _jax_config(cfg):
    from gmmloc_tpu import config as jax_config_mod

    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(jax_config_mod, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return jax_config_mod.SystemConfig(**kw)


def _run(package, use_bf16, cfg, paths, n_frames):
    if package == "jax":
        from gmmloc_tpu.eval import synthetic
        from gmmloc_tpu.gmm import mixture
        from gmmloc_tpu.mapping import localization
        from gmmloc_tpu.pipeline.system import GMMLocSystem
        cfg = _jax_config(cfg)
    else:
        from gmmloc_tpu_torch.eval import synthetic
        from gmmloc_tpu_torch.gmm import mixture
        from gmmloc_tpu_torch.mapping import localization
        from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

    iters = []
    solve = localization.local_ba.solve_local_ba

    def counted(*args, **kw):
        res = solve(*args, use_bf16=use_bf16, **kw)
        iters.append(int(res.n_iters))
        return res

    gmm_path, gt_path = paths
    kw = dict(pad_to=512, neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
              neighbor_cap=cfg.gmm.neighbor_cap)
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, gt_path=gt_path, gmm_path=gmm_path, n_landmarks=4000, seed=0,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1)
    gmap = mixture.load(gmm_path, **kw) if package == "jax" else \
        mixture.load(gmm_path, "cpu", **kw)
    system = GMMLocSystem(cfg, gmap) if package == "jax" else GMMLocSystem(cfg, gmap, "cpu")
    frames = [fe.make_frame(i, ts[i], q_wc[i], t_wc[i]) for i in range(n_frames)]
    localization.local_ba.solve_local_ba = counted
    try:
        kf_frames, n_kf = [], 0
        for i, frame in enumerate(frames):
            system.step(frame, q_wc[i], t_wc[i])
            if system.world.n_keyframes() != n_kf:
                n_kf = system.world.n_keyframes()
                kf_frames.append(i)
        system.flush()
    finally:
        localization.local_ba.solve_local_ba = solve
    return dict(package=package, use_bf16=use_bf16, ba_iters=iters,
                keyframe_frames=kf_frames)


def main() -> int:
    import torch

    from gmmloc_tpu_torch.eval import room_fixture, slice_run

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    a = ap.parse_args()
    torch.set_num_threads(1)
    cfg = slice_run.slice_config(feat_cap=256, num_features=240, local_map_cap=1024)
    with tempfile.TemporaryDirectory() as d:
        paths = room_fixture.write_room_fixture(d, n_components=400, n_frames=60, seed=0)
        for package in ("jax", "port"):
            for use_bf16 in (True, False):
                print(json.dumps(_run(package, use_bf16, cfg, paths, a.frames)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
