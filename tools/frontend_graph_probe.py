"""The image front end's pass eager against replayed from its CUDA graph,
on 24 seeded 752x480 pairs of the production image configuration. Prints
one JSON line:

  - `eager_ms_median`: host ms of one eager pass (`ImageFrontend._packed`
    on a prepared pair, synchronised each pair);
  - `capture_and_first_replay_s`: the second `dispatch` + `complete` of a
    new front end, which captures the graph and replays it once;
  - `pool_reserved_mb`, `pool_allocated_mb`: what the capture added to the
    caching allocator's reserved and allocated memory (the graph's
    private pool and its static buffers);
  - `graph_dispatch_ms_median`, `graph_host_ms_median`: host ms of a
    replayed `dispatch`, and of `dispatch(i + 1)` plus `complete(i)`;
  - `replay_device_ms`: device ms of one replay (CUDA events around 20
    replays back to back);
  - `launches_per_replay`: the hand kernels launched inside the graph.

Usage: python3 tools/frontend_graph_probe.py (card only).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gmmloc_tpu_torch.eval import slice_run  # noqa: E402
from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend  # noqa: E402
from gmmloc_tpu_torch.pipeline.system import set_numerics  # noqa: E402


def _pairs(h, w, n=24):
    """Blocky random images with noise; the right one shifted 5 pixels."""
    pairs = []
    for seed in range(n):
        rng = np.random.default_rng(1000 + seed)
        img = np.kron(rng.uniform(0, 255, (h // 8, w // 8)), np.ones((8, 8)))
        img = np.clip(img + rng.normal(0, 4, (h, w)), 0, 255).astype(np.uint8)
        pairs.append((img, np.roll(img, -5, axis=1)))
    return pairs


def main() -> int:
    set_numerics()
    dev = torch.device("cuda", 0)
    cfg = slice_run.image_config(slice_run.production_config(True))
    pairs = _pairs(cfg.camera.height, cfg.camera.width)
    out = {"card": torch.cuda.get_device_name(0)}

    fe = ImageFrontend(cfg, device=dev)
    eager = []
    for p in pairs[:12]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table, _ = fe._packed(*fe._prepare(*p))
        table.cpu()
        eager.append(time.perf_counter() - t0)
    out["eager_ms_median"] = 1e3 * statistics.median(eager[2:])

    fe = ImageFrontend(cfg, device=dev)
    fe.complete(fe.dispatch(0, 0.0, *pairs[0]))        # the eager first pair
    torch.cuda.synchronize()
    a1, r1 = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    fe.complete(fe.dispatch(1, 0.0, *pairs[1]))        # capture, first replay
    out["capture_and_first_replay_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    a2, r2 = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
    out["pool_reserved_mb"] = (r2 - r1) / 2**20
    out["pool_allocated_mb"] = (a2 - a1) / 2**20

    host, disp, pend = [], [], None
    for i, p in enumerate(pairs * 2):
        t0 = time.perf_counter()
        new = fe.dispatch(i, 0.0, *p)
        t1 = time.perf_counter()
        if pend is not None:
            fe.complete(pend)
        host.append(time.perf_counter() - t0)
        disp.append(t1 - t0)
        pend = new
    fe.complete(pend)
    out["graph_host_ms_median"] = 1e3 * statistics.median(host[2:])
    out["graph_dispatch_ms_median"] = 1e3 * statistics.median(disp[2:])

    g = next(iter(fe._graphs.values()))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(20):
        g.graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    out["replay_device_ms"] = ev[0].elapsed_time(ev[1]) / 20
    out["launches_per_replay"] = {k.__name__: n for k, n in g.launches.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
