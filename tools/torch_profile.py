#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's main paths on one GPU.

    python3 tools/torch_profile.py [--path feature|image] [--config slice|production]
                                   [--online] [--warmup 25] [--frames 60]

Runs a configuration of `gmmloc_tpu_torch.eval.slice_run` at full width on
the seeded V1-scale room fixture -- the slice (depth 1, unpacked, host
mapping, offline) or the production configuration (the JAX package's
defaults at pipeline depth 4; `--online` adds the mapper thread) -- on the
feature path (synthetic feature frames) or the image path (rendered
stereo pairs through the ORB front end), and profiles `--frames` frames
after the warm-up with `torch.profiler`. Prints the host-timer table per
span (wall, self and off-CPU totals), the top device operations by device
time, the device's idle time split by the innermost program range
("gl:<tag>", `utils/timing.py`) the profiling thread was in meanwhile,
and a JSON summary: wall time, summed operation time, the idle share (one
minus the union of the device intervals over every stream, so the
mapper's stream and the tracker's overlapping count once) and the idle
seconds per range. The union and the idle split are the benchmark's own
(`portbench.trace.reduce_events`); this tool only cuts the program's
nested ranges into the innermost segments that reducer splits over.
Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.trace import WINDOW, reduce_events  # noqa: E402

OUTSIDE = "(outside gl:)"


def innermost(ranges):
    """Properly nested (start, end, name) ranges of one thread -> disjoint
    (start, end, name) segments, each labelled by the innermost range open
    over it; time outside every range gets no segment."""
    out, stack, t = [], [], None

    def close_until(s):
        nonlocal t
        while stack and stack[-1][1] <= s:
            _, end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end

    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        close_until(s)
        if stack and s > t:
            out.append((t, s, stack[-1][2]))
        stack.append((s, e, name))
        t = s
    close_until(float("inf"))
    return out


def reduce_trace(events):
    """`events`: (on the card, name, start ns, end ns, thread id). Hands the
    card's operations, the window and the innermost segments of the "gl:*"
    ranges of the thread that opened the window to the benchmark's reducer
    (`portbench.trace.reduce_events`, whose idle split runs over the
    segments as over its own spans) and returns its reduction, the idle
    time outside every range under `OUTSIDE`."""
    ((w0, w1, tid),) = [(s, e, t) for card, n, s, e, t in events if n == WINDOW and not card]
    out = [("CPU", WINDOW, w0, w1)]
    # the window's own range shows on the card as a user annotation: no operation
    out += [("CUDA", n, s, e) for card, n, s, e, _ in events if card and n != WINDOW]
    ranges = [(s, e, n[3:]) for card, n, s, e, t in events
              if not card and n.startswith("gl:") and t == tid]
    out += [("CPU", "pb:" + n, s, e) for s, e, n in innermost(ranges)]
    red = reduce_events(out)
    red["idle_gaps"] = [[OUTSIDE if k == "harness" else k, v] for k, v in red["idle_gaps"]]
    return red


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("feature", "image"), default="feature")
    ap.add_argument("--config", choices=("slice", "production"), default="slice")
    ap.add_argument("--online", action="store_true", help="production: the mapper thread")
    ap.add_argument("--warmup", type=int, default=25)
    ap.add_argument("--frames", type=int, default=60)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device available", file=sys.stderr)
        return 2
    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

    dev = torch.device("cuda", 0)
    n = a.warmup + a.frames
    w = a.warmup
    base = (slice_run.production_config(a.online) if a.config == "production"
            else slice_run.slice_config())
    if a.path == "feature":
        cfg = base
        gmap, frames, q_wc, t_wc = slice_run.make_inputs(
            cfg, slice_run.default_fixture_dir(), n, device=dev)
        system = GMMLocSystem(cfg, gmap, dev)
        slice_run.run(system, frames[:w], q_wc, t_wc, dev)
        go = lambda: slice_run.run(system, frames[w:], q_wc[w:], t_wc[w:], dev)
    else:
        from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend

        cfg = slice_run.image_config(base)
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
        with record_function(WINDOW):
            steps = go()
        wall = time.perf_counter() - t0
        # the profiler's exit synchronizes the device, which fails while
        # the mapper thread captures a CUDA graph: join the mapper first
        system.stop()
    print(slice_run.timing_table(), flush=True)
    events = [(e.device_type() == DeviceType.CUDA, e.name(), e.start_ns(), e.end_ns(),
               getattr(e, "start_thread_id", int)())
              for e in prof.profiler.kineto_results.events()]
    red = reduce_trace(events)
    op_s = sum(t for _, t in red["kernels"].values())
    for name, (calls, t) in sorted(red["kernels"].items(), key=lambda kv: -kv[1][1])[:25]:
        print(f"  {t * 1e3:10.3f} ms  {calls:6d}  {name[:90]}")
    print("idle seconds by the innermost program range (the ten largest):")
    for name, t in red["idle_gaps"]:
        print(f"  {t:9.4f} s  {name}")
    summary = dict(
        path=a.path, config=a.config, online=a.online, frames=a.frames, wall_s=wall,
        fps=a.frames / wall, frame_ms_p50=float(1e3 * torch.tensor(steps["step_s"]).median()),
        window_s=red["window_s"], device_op_s=op_s, busy_s=red["busy_s"],
        idle_share=1.0 - red["busy_s"] / red["window_s"], n_op_kinds=len(red["kernels"]),
        idle_s_by_range=dict(red["idle_gaps"]), card=torch.cuda.get_device_name(0),
    )
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
