#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's main paths on one GPU.

    python3 tools/torch_profile.py [--path feature|image] [--warmup 25] [--frames 60]

Runs the slice (`gmmloc_tpu_torch.eval.slice_run`) at full width on the
seeded V1-scale room fixture -- the feature path (synthetic feature
frames) or the image path (rendered stereo pairs through the ORB front
end) -- and profiles `--frames` frames after the warm-up with
`torch.profiler`: wall time, summed device (kernel) time, the device's
idle share over the window, the host-timer table per stage, and the top
kernels by device time. Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("feature", "image"), default="feature")
    ap.add_argument("--warmup", type=int, default=25)
    ap.add_argument("--frames", type=int, default=60)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

    dev = torch.device("cuda", 0)
    n = a.warmup + a.frames
    w = a.warmup
    if a.path == "feature":
        cfg = slice_run.slice_config()
        gmap, frames, q_wc, t_wc = slice_run.make_inputs(
            cfg, slice_run.default_fixture_dir(), n, device=dev)
        system = GMMLocSystem(cfg, gmap, dev)
        slice_run.run(system, frames[:w], q_wc, t_wc, dev)
        go = lambda: slice_run.run(system, frames[w:], q_wc[w:], t_wc[w:], dev)
    else:
        from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend

        cfg = slice_run.image_config()
        gmap, images, ts, q_wc, t_wc = slice_run.make_image_inputs(
            cfg, os.path.join(slice_run.default_fixture_dir(), "image"), n, device=dev)
        frontend = ImageFrontend(cfg, device=dev)
        system = GMMLocSystem(cfg, gmap, dev)
        slice_run.run_image(system, frontend, images[:w], ts, q_wc, t_wc)
        # the loop runs on: frame w is stepped after frame w - 1 (the flush
        # above completed it), with the motion model carried over
        go = lambda: slice_run.run_image(system, frontend, images[w:], ts[w:], q_wc[w:],
                                         t_wc[w:], first_idx=w)
    slice_run.timing_table(reset=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = go()
        wall = time.perf_counter() - t0
    print(slice_run.timing_table(), flush=True)
    # kernels (and copies) as the device ran them: one stream, no overlap
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    rows = [dict(name=e.key[:90], calls=e.count, device_ms=e.self_device_time_total / 1e3)
            for e in sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)[:25]]
    summary = dict(
        path=a.path, frames=a.frames, wall_s=wall, fps=a.frames / wall,
        frame_ms_p50=float(1e3 * torch.tensor(steps["step_s"]).median()),
        device_ms=dev_us / 1e3, device_busy_share=dev_us / 1e6 / wall,
        idle_share=1.0 - dev_us / 1e6 / wall, n_kernel_kinds=len(kern),
        card=torch.cuda.get_device_name(0),
    )
    for r in rows:
        print(f"  {r['device_ms']:10.3f} ms  {r['calls']:6d}  {r['name']}")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
