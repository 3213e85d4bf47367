#!/usr/bin/env python3
"""What two host threads that launch eager CUDA ops cost each other, and
what that does to the online mapper (one GPU).

    python3 tools/gil_probe.py [--intervals 0.005,0.001,0.0002]
        [--frames 225] [--warmup 25] [--skip-system]

[ops]: one thread times `--ops` small eager ops (an add on a 1024-float
CUDA tensor) alone and beside a peer thread that runs, until told to
stop, the same CUDA ops, the same ops on CPU tensors (they release and
re-take the GIL the same way but never enter the CUDA driver), or a pure
Python loop (holds the GIL; it changes hands only when the interpreter's
switch interval forces it). Each at every `sys.setswitchinterval` of
`--intervals`. Prints one JSON line per case: microseconds per op.

[system]: `slice_run.production_config` on the full-width feature frames of
`chip_smoke.py` (the seeded room fixture, 1280 features, 30000
landmarks): offline, online at each switch interval, and online with the
tracker waiting after each step until the mapper is idle ("mapper
alone": the same mapper code without a second thread launching beside
it). Prints one JSON line per run: tracked frames/s and p50 over the
frames after `--warmup`, keyframes, BA solves, LM iterations, `loc/ba` ms
per solve and per LM iteration, `track/chain_enqueue` ms per frame, and
the share of the measured frames whose pose solve kept GMM anchors.

[ba]: the first BA windows of the offline run solved again alone, eagerly
and with the LM iterations replayed from CUDA graphs: host ms per solve
and per LM iteration of each, and the kernels per eager LM iteration
(`torch.profiler`; null where it records no device activity).
"""

import argparse
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(obj):
    print(json.dumps(obj), flush=True)


def time_ops(x, n: int) -> float:
    """Microseconds per eager add on x."""
    import torch

    t0 = time.perf_counter()
    for _ in range(n):
        torch.add(x, 1.0)
    return (time.perf_counter() - t0) / n * 1e6


def peer(kind: str, stop: threading.Event):
    import torch

    if kind == "cuda":
        x = torch.zeros(1024, device="cuda")
    elif kind == "cpu":
        x = torch.zeros(1024)
    while not stop.is_set():
        if kind == "python":
            sum(range(200))
        else:
            for _ in range(64):
                torch.add(x, 1.0)
            if kind == "cuda":
                torch.cuda.current_stream().synchronize()   # bound the queue


def probe_ops(intervals, n_ops: int):
    import torch

    x = torch.zeros(1024, device="cuda")
    time_ops(x, 1000)                                      # warm the allocator
    torch.cuda.synchronize()
    for iv in intervals:
        sys.setswitchinterval(iv)
        for kind in ("none", "cuda", "cpu", "python"):
            stop = threading.Event()
            th = None
            if kind != "none":
                th = threading.Thread(target=peer, args=(kind, stop), daemon=True)
                th.start()
                time.sleep(0.05)
            # beside a Python peer an op can take the whole interval
            us = time_ops(x, n_ops // 10 if kind == "python" else n_ops)
            torch.cuda.synchronize()
            if th is not None:
                stop.set()
                th.join()
            log(dict(probe="ops", switch_interval_s=iv, peer=kind, us_per_op=us))


def probe_ba(windows):
    """[ba] on recorded (cam, prob, n_free, kw) windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gmmloc_tpu_torch.solver import local_ba

    for cam, prob, n_free, kw in windows:
        row = dict(probe="ba", n_free=n_free, points=int(prob.pts.shape[0]))
        for graph in (False, True):
            local_ba.solve_local_ba(cam, prob, n_free, cuda_graph=graph, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = local_ba.solve_local_ba(cam, prob, n_free, cuda_graph=graph, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            key = "graph" if graph else "eager"
            row.update({f"{key}_ms": ms, f"{key}_ms_per_iter": ms / res.n_iters,
                        "n_iters": res.n_iters})
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = local_ba.solve_local_ba(cam, prob, n_free, cuda_graph=False, **kw)
            torch.cuda.synchronize()
        n_dev = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        row["kernels_per_iter"] = n_dev / res.n_iters if n_dev else None
        log(row)


def run_system(variant: str, inputs, warmup: int, device, windows=None):
    import copy

    import numpy as np
    import torch

    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
    from gmmloc_tpu_torch.solver import local_ba
    from gmmloc_tpu_torch.utils import timing

    solve = local_ba.solve_local_ba
    if windows is not None:                     # record the BA windows
        def record(cam, prob, n_free, **kw):
            windows.append((cam, prob, n_free, kw))
            return solve(cam, prob, n_free, **kw)

        local_ba.solve_local_ba = record
    gmap, frames, q_wc, t_wc = inputs
    frames = copy.deepcopy(frames)
    online = variant != "offline"
    system = GMMLocSystem(slice_run.production_config(online), gmap, device)
    timing.reset()
    n_anchors, dbg, step_s = [], system.tracker.dbg, []
    torch.cuda.synchronize()
    for i, f in enumerate(frames):
        t1 = time.perf_counter()
        system.step(f, q_wc[i], t_wc[i])
        if variant == "mapper_alone":
            while system.online.count_queue() or not system.online.is_idle:
                time.sleep(0.001)
        step_s.append(time.perf_counter() - t1)
        if system.track_failed:
            raise RuntimeError(f"[{variant}] tracking failed at frame {i}")
        if system.tracker.dbg is not dbg:
            dbg = system.tracker.dbg
            n_anchors.append(dbg.get("n_anchors", 0))
    system.flush()
    if system.tracker.dbg is not dbg:
        n_anchors.append(system.tracker.dbg.get("n_anchors", 0))
    system.stop()
    torch.cuda.synchronize()
    local_ba.solve_local_ba = solve
    acc = timing.REGISTRY.accs
    ba = acc.get("loc/ba")
    iters = [s["n_iters"] for s in system.localizer.ba_stats]
    meas = np.array(n_anchors[-(len(frames) - warmup):])
    st = np.array(step_s[warmup:])
    enq = acc.get("track/chain_enqueue")
    return dict(probe="system", variant=variant, switch_interval_s=sys.getswitchinterval(),
                frames=len(frames), fps=len(st) / float(st.sum()),
                p50_ms=float(np.percentile(st, 50) * 1e3),
                max_err_m=float(slice_run.pose_errors(frames, t_wc).max()),
                keyframes=int(system.world.n_keyframes()), ba_solves=len(iters),
                ba_iters_mean=float(np.mean(iters)) if iters else 0.0,
                ba_ms_per_solve=ba.mean() * 1e3 if ba else None,
                ba_ms_per_iter=ba.total * 1e3 / max(1, sum(iters)) if ba else None,
                chain_enqueue_ms=enq.mean() * 1e3 if enq else None,
                anchored_share=float((meas > 0).mean()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--intervals", default="0.005,0.001,0.0002")
    ap.add_argument("--ops", type=int, default=20000)
    ap.add_argument("--frames", type=int, default=225)
    ap.add_argument("--warmup", type=int, default=25)
    ap.add_argument("--skip-system", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("gil_probe: no CUDA device", file=sys.stderr)
        return 2
    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.pipeline.system import set_numerics
    from gmmloc_tpu_torch.utils import cuda_build

    intervals = [float(v) for v in a.intervals.split(",")]
    default_iv = sys.getswitchinterval()
    probe_ops(intervals, a.ops)
    sys.setswitchinterval(default_iv)
    if a.skip_system:
        return 0
    device = torch.device("cuda", 0)
    set_numerics()
    cuda_build.load()
    inputs = slice_run.make_inputs(slice_run.slice_config(), slice_run.default_fixture_dir(),
                                   a.frames, n_components=3300, n_landmarks=30000,
                                   device=device)
    windows = []
    log(run_system("offline", inputs, a.warmup, device, windows))
    for iv in intervals:
        sys.setswitchinterval(iv)
        log(run_system("online", inputs, a.warmup, device))
    sys.setswitchinterval(default_iv)
    log(run_system("mapper_alone", inputs, a.warmup, device))
    probe_ba(windows[:3])
    return 0


if __name__ == "__main__":
    sys.exit(main())
