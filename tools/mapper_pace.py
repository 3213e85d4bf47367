"""The production image online run (`chip_smoke.py`'s `[production]`
image run, 170 frames, closed loop) repeated, with the mapper's keyframe
timeline: when each keyframe was queued, when the mapper took it up and
finished it, and whether its local BA ran or was skipped for a keyframe
queued meanwhile. Prints one JSON line per run: the pose errors against
the smoke's 8 cm gate, frames/s, keyframes, BA solves and the mapper's
stage spans (count, total and uncharged seconds).

Usage, from the root of a checkout (of this repo or an older commit,
which the script imports from the working directory):

    python3 <this repo>/tools/mapper_pace.py --runs 4 [--sleep-s 0.12]

`--sleep-s` sleeps after every step, slowing the tracker against the
mapper. Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _timeline(system, t0):
    """Wraps the localizer's `insert_keyframe` and `spin_once` to record
    each keyframe's queue, start and end times (seconds after `t0`) and
    whether its BA ran. Returns the list the records go to and a function
    that takes the wrappers off again (they close over the localizer, so
    left on they would keep it, and the CUDA graphs it keeps, for the
    cyclic collector)."""
    loc = system.localizer
    rows, by_kf = [], {}
    insert, spin = loc.insert_keyframe, loc.spin_once

    def insert_keyframe(kf):
        by_kf[kf] = dict(kf=int(kf), queued=time.perf_counter() - t0)
        rows.append(by_kf[kf])
        insert(kf)

    def spin_once():
        if not loc.queue:
            return spin()
        row = by_kf.get(loc.queue[0], {})
        n_ba = len(loc.ba_stats)
        row["start"] = time.perf_counter() - t0
        spin()
        row["end"] = time.perf_counter() - t0
        row["ba"] = len(loc.ba_stats) > n_ba
        row["queued_after"] = len(loc.queue)

    loc.insert_keyframe, loc.spin_once = insert_keyframe, spin_once

    def undo():
        del loc.insert_keyframe, loc.spin_once
    return rows, undo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--sleep-s", type=float, default=0.0)
    ap.add_argument("--switch-ms", type=float, default=0.0,
                    help="> 0: the interpreter's thread switch interval (default 5 ms)")
    ap.add_argument("--timeline", type=int, default=0,
                    help="1: print each keyframe's record too")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem, set_numerics
    from gmmloc_tpu_torch.utils import timing

    if args.switch_ms > 0:
        sys.setswitchinterval(args.switch_ms * 1e-3)
    device = torch.device("cuda", 0)
    set_numerics()
    igmap, images, ts, iq, it = slice_run.make_image_inputs(
        slice_run.image_config(), os.path.join(slice_run.default_fixture_dir(), "image"),
        cs.IMG_WARMUP + cs.IMG_MEASURED, n_components=cs.N_COMPONENTS,
        n_landmarks=cs.IMG_LANDMARKS, device=device)
    cfg = slice_run.image_config(slice_run.production_config(True))
    for r in range(args.runs):
        system = GMMLocSystem(cfg, igmap, device)
        frontend = ImageFrontend(cfg, device=device)
        if args.sleep_s > 0:
            step = system.step

            def slow(*a, _step=step, **k):
                out = _step(*a, **k)
                time.sleep(args.sleep_s)
                return out
            system.step = slow
        timing.reset()
        t0 = time.perf_counter()
        rows, undo = _timeline(system, t0)
        ran = slice_run.run_image(system, frontend, images, ts, iq, it)
        wall = time.perf_counter() - t0
        system.stop()
        undo()
        if args.sleep_s > 0:
            del system.step
        errs = slice_run.pose_errors(ran["frames"], it)
        spans = {}
        for tag, acc in sorted(timing.REGISTRY.accs.items()):
            if tag.startswith("loc") and not tag.endswith(timing.SELF):
                spans[tag] = [acc.count, round(acc.total, 4)]
        done = [x for x in rows if "end" in x]
        gaps = np.diff([x["queued"] for x in rows]) if len(rows) > 1 else np.zeros(1)
        out = dict(
            run=r, sleep_s=args.sleep_s, switch_ms=sys.getswitchinterval() * 1e3,
            max_err_cm=100 * float(errs.max()),
            mean_err_cm=100 * float(errs.mean()), gate_cm=100 * cs.PROD_MAX_ERR_M,
            fps=len(ran["frames"]) / wall, keyframes=system.world.n_keyframes(),
            queued=len(rows), ba_solves=len(system.localizer.ba_stats),
            ba_skipped=sum(1 for x in done if not x["ba"]),
            kf_gap_s_median=float(np.median(gaps)),
            mapper_s_per_kf_median=float(np.median([x["end"] - x["start"] for x in done]))
            if done else None,
            wait_s_median=float(np.median([x["start"] - x["queued"] for x in done]))
            if done else None,
            spans=spans)
        if args.timeline:
            out["timeline"] = [{k: (round(v, 3) if isinstance(v, float) else v)
                                for k, v in x.items()} for x in rows]
        print(json.dumps(out), flush=True)
        del system, frontend
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
