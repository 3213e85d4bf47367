"""A job-sharded sweep of the feature path over ranks.

Twin of the worker of the JAX package's `tools/sweep_multihost.py`. A job
is (seed, run): the room fixture (`room_fixture`) made from `seed`, its
synthetic feature frames drawn with noise seed 1000 * seed + run, run
through `GMMLocSystem.step` for `--frames` frames on the slice
configuration. Jobs go round-robin over the ranks (`shard_jobs`); rank 0
merges every rank's results (`barrier_and_gather_json`) into
`summary.json` and prints the summary. The JAX tool's EuRoC sequences are
not in the repository, so the fixture stands in for them.

    python -m gmmloc_tpu_torch.eval.sweep --spawn 2 --seeds 0 --runs 2 \\
        --frames 40 --out build/sweep

`--spawn N` starts N local ranks (`parallel.distributed.spawn`, gloo: the
ranks exchange files, not tensors); without it the process is one rank of
the environment contract (GMMLOC_COORDINATOR, GMMLOC_NUM_PROCESSES,
GMMLOC_PROCESS_ID), a no-op group at one process.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..parallel import distributed as dist


def _launches() -> dict:
    from ..features import cuda_kernels
    from ..solver import cuda_pose

    return {"K1": cuda_pose.optimize_pose.launches,
            "K2": cuda_pose.optimize_pose_anchored.launches,
            "K3": cuda_kernels.hamming_matrix.launches}


def run_job(cfg, out_dir: str, seed: int, run: int, frames: int, device) -> dict:
    """One (seed, run) job: frames/s, the max and mean camera-centre
    error, keyframes and the kernel launches of the run."""
    from ..pipeline.system import GMMLocSystem
    from . import slice_run

    gmap, fr, q_wc, t_wc = slice_run.make_inputs(
        cfg, os.path.join(out_dir, f"seed{seed}"), frames, seed=seed,
        sequence_seed=1000 * seed + run, device=device)
    system = GMMLocSystem(cfg, gmap, device)
    before = _launches()
    ran = slice_run.run(system, fr, q_wc, t_wc, device)
    errs = slice_run.pose_errors(fr, t_wc)
    return dict(seed=seed, run=run, frames=len(fr),
                fps=len(fr) / float(ran["step_s"].sum()),
                max_err_m=float(errs.max()), mean_err_m=float(errs.mean()),
                keyframes=system.world.n_keyframes(),
                launches={k: n - before[k] for k, n in _launches().items()})


def worker(seeds, runs: int, frames: int, out: str, device="cuda") -> dict:
    """One rank of the sweep (a process group of the environment contract
    exists, or this is the only rank). Returns the merged summary on rank
    0, None elsewhere."""
    import torch.distributed as tdist

    from . import slice_run

    if tdist.is_available() and tdist.is_initialized():
        pid, nproc = tdist.get_rank(), tdist.get_world_size()
    else:
        pid, nproc = dist.init_distributed(device, backend="gloo")
    jobs = [(s, r) for s in seeds for r in range(runs)]
    mine = dist.shard_jobs(jobs, pid, nproc)
    cfg = slice_run.slice_config()
    results = []
    t0 = time.time()
    for seed, r in mine:
        m = run_job(cfg, os.path.join(out, f"rank{pid}"), seed, r, frames, device)
        results.append(m)
        print(f"[rank {pid}] seed {seed} run {r}: max error {m['max_err_m'] * 100:.2f} cm, "
              f"{m['frames']} frames at {m['fps']:.2f} frames/s", flush=True)
    wall = time.time() - t0
    merged = dist.barrier_and_gather_json(
        out, "sweep", {"pid": pid, "wall_s": wall, "runs": results}, pid, nproc)
    if merged is None:
        return None
    if any(h is None for h in merged):
        raise RuntimeError(f"missing results of ranks "
                           f"{[i for i, h in enumerate(merged) if h is None]}")
    all_runs = [r for h in merged for r in h["runs"]]
    walls = [h["wall_s"] for h in merged]
    summary = {
        "n_ranks": nproc,
        "rank_wall_s": walls,
        "jobs": [[r["seed"], r["run"]] for r in all_runs],
        "total_frames": sum(r["frames"] for r in all_runs),
        "agg_fps": sum(r["frames"] for r in all_runs) / max(walls),
        # against one rank running every job: from the per-job rates
        "scaling_efficiency": (sum(r["frames"] / max(r["fps"], 1e-9) for r in all_runs)
                               / (nproc * max(walls))),
        "max_err_m": float(np.max([r["max_err_m"] for r in all_runs])),
        "launches": {k: sum(r["launches"][k] for r in all_runs)
                     for k in ("K1", "K2", "K3")},
    }
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump({"summary": summary, "runs": all_runs}, f, indent=2, default=float)
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--spawn", type=int, default=0,
                    help="start N local ranks (one machine)")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--out", default="build/sweep")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds each spawned rank may take")
    a = ap.parse_args(argv)
    kw = dict(seeds=[int(s) for s in a.seeds.split(",")], runs=a.runs, frames=a.frames,
              out=os.path.abspath(a.out), device=a.device)
    os.makedirs(kw["out"], exist_ok=True)
    if a.spawn > 0:
        return dist.spawn("gmmloc_tpu_torch.eval.sweep:worker", a.spawn, a.device,
                          "gloo", kw, timeout_s=a.timeout)[0]
    return worker(**kw)


if __name__ == "__main__":
    main()
