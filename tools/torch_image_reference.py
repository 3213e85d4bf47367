#!/usr/bin/env python3
"""The image path's frames through the JAX package (or the port), on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_image_reference.py [--package jax|port]
        [--frames 170] [--out DIR]

Renders the same seeded stereo pairs as the port's image path
(`gmmloc_tpu_torch.eval.slice_run.make_image_inputs`: room fixture, 9000
sprite landmarks, 752x480) and runs them through the JAX package's
`ImageFrontend` and `GMMLocSystem` with the same configuration
(`slice_run.image_config`), in the same double-buffered order; with
`--package port`, through the port's (`slice_run.run_image` on the CPU).
Prints one JSON line: frames tracked, max and mean camera-centre error
against the fixture's ground truth, keyframes, and the stereo matches of
frame 0. `chip_smoke.py`'s image phase holds the port to the JAX max
error + 1 cm when that is above 5 cm.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_config(cfg):
    """The JAX package's SystemConfig with the field values of the port's."""
    from gmmloc_tpu import config as jc

    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(jc, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return jc.SystemConfig(**kw)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--frames", type=int, default=170)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "image_reference"))
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    from gmmloc_tpu_torch.eval import slice_run

    t0 = time.perf_counter()
    cfg = slice_run.image_config()
    gmap_t, images, ts, q_wc, t_wc = slice_run.make_image_inputs(
        cfg, a.out, a.frames, device="cpu")
    if a.package == "port":
        from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend as TorchFrontend
        from gmmloc_tpu_torch.pipeline.system import GMMLocSystem as TorchSystem

        system = TorchSystem(cfg, gmap_t, "cpu")
        frames = slice_run.run_image(system, TorchFrontend(cfg, device="cpu"), images,
                                     ts, q_wc, t_wc)["frames"]
        return report(a, frames, system, t_wc, t0)

    from gmmloc_tpu.gmm import mixture as jmix
    from gmmloc_tpu.pipeline.frontend import ImageFrontend
    from gmmloc_tpu.pipeline.system import GMMLocSystem

    jcfg = jax_config(cfg)
    gmap = jmix.load(os.path.join(a.out, "room.gmm"), pad_to=jcfg.caps.gmm_components_pad,
                     neighbor_dist_thresh=jcfg.gmm.neighbor_dist_thresh,
                     neighbor_cap=jcfg.gmm.neighbor_cap)
    fe = ImageFrontend(jcfg)
    system = GMMLocSystem(jcfg, gmap)
    frames, pend, i_prev = [], None, -1
    for i in range(len(images) + 1):
        new = fe.dispatch(i, ts[i], *images[i]) if i < len(images) else None
        if pend is not None:
            frames.append(fe.complete(pend))
            system.step(frames[-1], q_wc[i_prev], t_wc[i_prev])
            if system.track_failed:
                break
        pend, i_prev = new, i
    system.flush()
    return report(a, frames, system, t_wc, t0)


def report(a, frames, system, t_wc, t0) -> int:
    import numpy as np

    from gmmloc_tpu_torch.eval import slice_run

    errs = slice_run.pose_errors(frames, t_wc)
    print(json.dumps(dict(
        package=a.package, frames=len(frames), track_failed=bool(system.track_failed),
        max_err_m=float(errs.max()), mean_err_m=float(errs.mean()),
        keyframes=int(system.world.n_keyframes()),
        stereo_frame0=int((frames[0].ur >= 0).sum()),
        features_frame0=int(frames[0].num_features()),
        seconds=time.perf_counter() - t0, device="cpu")), flush=True)
    return 0 if not system.track_failed and np.isfinite(errs).all() else 1


if __name__ == "__main__":
    sys.exit(main())
