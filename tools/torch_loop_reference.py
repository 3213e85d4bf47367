#!/usr/bin/env python3
"""One lap of the room fixture with loop closing, through the JAX package
and the port, on the CPU, at a small width.

    JAX_PLATFORMS=cpu python tools/torch_loop_reference.py
        [--package jax,port] [--frames 440] [--ba bf16|f32] [--trace]
        [--out DIR]

Writes the seeded room fixture (400 components, as the parity tests use;
the trajectory is the one every fixture of seed 0 has: its ellipse
closes after about 380 frames at 20 Hz) and makes synthetic feature
frames of 4000 landmarks at feat_cap 256, 240 features, a local-map cap
of 1024. Each package runs `slice_run.production_config(False)` (depth
4, offline) with `enable_loop_closing=True` and a vocabulary trained as
the JAX tests train theirs (`desc[::4]` of the landmarks, k=10, depth 3,
seed 0). Prints one JSON line per package: the loops closed (keyframe
pairs and the frames of the pair), max and mean camera-centre error
against the ground truth, keyframes, lost frames and recoveries.
`--ba f32` runs both packages' local BA with float32 products (as the
parity tests do); at the default bfloat16 staging the two packages part
on keyframes within the lap (ROADMAP queue 3 f), so only float32 runs
are comparable frame by frame. `--trace` prints one line per `close`
call: the keyframe and its frame, the database's top candidates (slot,
score, frame, covisible or not), what `detect` returned and the inliers
`verify` found.
`chip_smoke.py`'s `[loop]` phase takes its gates from the JAX line: a
loop closed here means the card run must close one, and its error gate
is the larger of 8 cm and this max error + 1 cm.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(package: str, a, gmm_path, gt_path) -> dict:
    from gmmloc_tpu_torch.eval import reloc_run, slice_run, synthetic
    from gmmloc_tpu_torch.gmm import mixture
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
    from gmmloc_tpu_torch.vocab.bow import Vocabulary

    t0 = time.perf_counter()
    cfg = slice_run.production_config(False, feat_cap=256, num_features=240,
                                      local_map_cap=1024)
    cfg = cfg.replace(enable_loop_closing=True)
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
    assert system.loop_closer is not None
    if a.trace:
        _trace(system)
    frames = reloc_run.blackout_frames(fe, ts, q_wc, t_wc, 0, a.frames, ())
    reloc_run.drive(system, frames, q_wc, t_wc)
    system.stop()
    r = reloc_run.summary(system, frames, t_wc)
    w = system.world
    closures = [(int(k), int(c)) for k, c in system.loop_closer.closures]
    return dict(package=package, frames=a.frames, ba=a.ba, closures=closures,
                closure_frames=[(int(w.kf_frame_idx[k]), int(w.kf_frame_idx[c]))
                                for k, c in closures],
                max_err_m=float(r["errors_tracked"].max()),
                mean_err_m=float(r["errors_tracked"].mean()),
                keyframes=int(w.n_keyframes()), untracked=len(r["untracked"]),
                n_lost=r["n_lost"], recovery_frames=r["recovery_frames"],
                seconds=time.perf_counter() - t0, device="cpu")


def _trace(system) -> None:
    """Print what each `close` call sees before it runs."""
    lc, w = system.loop_closer, system.world
    inner = lc.close

    def close(kf):
        neigh = {int(k) for k in w.best_covisible(kf)} | {int(kf)}
        cands = lc.db.query(w.kf_feat_desc[kf], w.kf_feat_valid[kf], top=10)
        det = lc.detect(kf)
        ver = lc.verify(kf, det[0]) if det is not None else None
        print(json.dumps(dict(
            kf=int(kf), frame=int(w.kf_frame_idx[kf]),
            top=[(int(c), round(float(sc), 3), int(w.kf_frame_idx[c]), int(c) in neigh)
                 for c, sc in cands[:6]],
            detect=None if det is None else (int(det[0]), round(float(det[1]), 3)),
            verify_inliers=None if ver is None else int(ver[2]))), flush=True)
        return inner(kf)

    lc.close = close


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", default="jax,port")
    ap.add_argument("--frames", type=int, default=440)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "loop_reference"))
    ap.add_argument("--ba", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--trace", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if a.ba == "f32":
        import gmmloc_tpu_torch.mapping.localization as localization

        mods = [localization.local_ba]
        if "jax" in a.package:
            import gmmloc_tpu.mapping.localization as jax_localization

            mods.append(jax_localization.local_ba)
        for mod in mods:
            solve = mod.solve_local_ba
            mod.solve_local_ba = (lambda *args, _solve=solve, **kw:
                                  _solve(*args, use_bf16=False, **kw))

    from gmmloc_tpu_torch.eval import room_fixture

    torch.set_num_threads(1)
    gmm_path, gt_path = room_fixture.write_room_fixture(
        a.out, n_components=400, n_frames=a.frames + 50, seed=0)
    for package in a.package.split(","):
        print(json.dumps(run_one(package, a, gmm_path, gt_path)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
