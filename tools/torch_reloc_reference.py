#!/usr/bin/env python3
"""The relocalization scenarios through the JAX package and the port, on the
CPU, at chosen widths.

    JAX_PLATFORMS=cpu python tools/torch_reloc_reference.py
        [--package jax,port] [--widths 48,64] [--depth 1|4]
        [--scenarios blackout,kidnap] [--ba bf16|f32] [--out DIR]

The runs of `tests/test_torch_relocalize.py` on the seeded room fixture
(400 components, 4000 landmarks): the blackout (40 frames, frames 20-23
dark) and the kidnap (30 frames mapped, 3 dark, then 18 from frame 5),
at `slice_run.slice_config` (depth 1) or `production_config` (depth 4)
with feat_cap W and 0.94 W features, a vocabulary trained as the JAX tests
train theirs. Prints one JSON line per run: the untracked steps, the
lost count, the recovery frames, whether the run ended LOST, the max
camera-centre error after the recovery and the keyframes. The tests'
widths come from these readings: the smallest at which the JAX package
recovers in both scenarios.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(width: int, depth: int):
    from gmmloc_tpu_torch.eval import slice_run

    widths = dict(feat_cap=width, num_features=round(0.9375 * width),
                  local_map_cap=4 * width)
    if depth == 1:
        return slice_run.slice_config(**widths)
    return slice_run.production_config(False, **widths)


def run_one(package, scenario, width, depth, gmm_path, gt_path) -> dict:
    from gmmloc_tpu_torch.eval import reloc_run, synthetic
    from gmmloc_tpu_torch.gmm import mixture
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
    from gmmloc_tpu_torch.vocab.bow import Vocabulary

    t0 = time.perf_counter()
    cfg = config(width, depth)
    gkw = dict(pad_to=512, neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
               neighbor_cap=cfg.gmm.neighbor_cap)
    skw = dict(gt_path=gt_path, gmm_path=gmm_path, n_landmarks=4000, seed=0,
               disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1)
    if package == "jax":
        from gmmloc_tpu.eval import synthetic as jsynthetic
        from gmmloc_tpu.gmm import mixture as jmixture
        from gmmloc_tpu.pipeline.system import GMMLocSystem as JaxSystem
        from gmmloc_tpu.vocab.bow import Vocabulary as JaxVocabulary
        from torch_image_reference import jax_config

        jcfg = jax_config(cfg)
        fe, ts, q_wc, t_wc = jsynthetic.make_sequence(jcfg, **skw)
        voc = JaxVocabulary.train(fe.world.desc[::4], k=10, depth=3, seed=0)
        system = JaxSystem(jcfg, jmixture.load(gmm_path, **gkw), vocabulary=voc)
    else:
        fe, ts, q_wc, t_wc = synthetic.make_sequence(cfg, **skw)
        voc = Vocabulary.train(fe.world.desc[::4], k=10, depth=3, seed=0, device="cpu")
        system = GMMLocSystem(cfg, mixture.load(gmm_path, "cpu", **gkw), "cpu",
                              vocabulary=voc)
    if scenario == "blackout":
        frames = reloc_run.blackout_frames(fe, ts, q_wc, t_wc, 0, 40, range(20, 24))
    else:
        frames = reloc_run.kidnap_frames(fe, ts, q_wc, t_wc, 0, 30, 3, 5, 18)
    reloc_run.drive(system, frames, q_wc, t_wc)
    r = reloc_run.summary(system, frames, t_wc)
    return dict(package=package, scenario=scenario, feat_cap=width, depth=depth,
                untracked=r["untracked"], n_lost=r["n_lost"],
                recovery_frames=r["recovery_frames"], lost_at_end=r["lost"],
                max_err_after_m=float(r["errors"].max()) if len(r["errors"]) else None,
                keyframes=int(system.world.n_keyframes()),
                seconds=time.perf_counter() - t0, device="cpu")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", default="jax,port")
    ap.add_argument("--widths", default="48,64")
    ap.add_argument("--depth", type=int, choices=(1, 4), default=1)
    ap.add_argument("--scenarios", default="blackout,kidnap")
    ap.add_argument("--ba", choices=("bf16", "f32"), default="f32")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "reloc_reference"))
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from gmmloc_tpu_torch.eval import room_fixture

    torch.set_num_threads(1)
    if a.ba == "f32":
        # both packages' local BA with float32 products, as the tests run it
        import gmmloc_tpu_torch.mapping.localization as localization

        mods = [localization.local_ba]
        if "jax" in a.package:
            import gmmloc_tpu.mapping.localization as jax_localization

            mods.append(jax_localization.local_ba)
        for mod in mods:
            solve = mod.solve_local_ba
            mod.solve_local_ba = (lambda *args, _solve=solve, **kw:
                                  _solve(*args, use_bf16=False, **kw))
    gmm_path, gt_path = room_fixture.write_room_fixture(
        a.out, n_components=400, n_frames=120, seed=0)
    for package in a.package.split(","):
        for scenario in a.scenarios.split(","):
            for width in (int(w) for w in a.widths.split(",")):
                print(json.dumps(run_one(package, scenario, width, a.depth, gmm_path,
                                         gt_path)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
