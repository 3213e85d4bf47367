"""Multi-process runtime: `torch.distributed` from the environment, job
sharding for the eval sweep, and local ranks spawned as processes.

PyTorch port of `gmmloc_tpu/parallel/distributed.py`. PyTorch runs one
process per device, so a rank is one process bound to one card (or to the
CPU), and the group of all ranks is what the JAX package's global mesh
is.

Environment contract (set by the launcher, one process per rank):
  GMMLOC_COORDINATOR   host:port of rank 0 (default 127.0.0.1:9911), or a
                       URL torch.distributed takes as `init_method`
                       (`file:///path` for ranks on one machine)
  GMMLOC_NUM_PROCESSES total rank count (default 1 -> no-op)
  GMMLOC_PROCESS_ID    this rank

With GMMLOC_NUM_PROCESSES <= 1 everything is single-process behaviour.

`spawn` starts local ranks as fresh interpreters on this contract, each
with its own time limit; a rank that fails or runs out of time fails the
call and the other ranks are killed.

    python -m gmmloc_tpu_torch.parallel.distributed MODULE:FUNCTION WORK_DIR

is the rank's entry point that `spawn` runs.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def env_spec() -> Tuple[str, int, int]:
    return (
        os.environ.get("GMMLOC_COORDINATOR", "127.0.0.1:9911"),
        int(os.environ.get("GMMLOC_NUM_PROCESSES", "1")),
        int(os.environ.get("GMMLOC_PROCESS_ID", "0")),
    )


def init_distributed(device="cuda", backend: Optional[str] = None) -> Tuple[int, int]:
    """Initialize the default process group from the environment contract.

    Returns (rank, world size); a no-op (0, 1) at one process. On a CUDA
    device the rank is bound to card rank % cards and the backend is NCCL
    (which takes one rank per card), on the CPU gloo; `backend` overrides
    that (gloo also takes CUDA tensors in the collectives the sharded
    paths use). The JAX package's `local_device_count` has no counterpart:
    a process here drives one device."""
    coord, nproc, pid = env_spec()
    if nproc <= 1:
        return 0, 1
    _init_group(coord, nproc, pid, device, backend)
    return pid, nproc


def _init_group(coord: str, nproc: int, pid: int, device, backend: Optional[str]) -> None:
    import torch.distributed as dist

    dev = torch.device(device)
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", pid % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=coord if "://" in coord else f"tcp://{coord}",
                            world_size=nproc, rank=pid, **kw)


def global_group():
    """The group of every rank (the JAX package's `global_mesh`)."""
    import torch.distributed as dist

    return dist.group.WORLD


def shard_jobs(jobs: Sequence, pid: int, nproc: int) -> List:
    """Round-robin job sharding for the sweep (deterministic: every rank
    derives the same global assignment)."""
    return list(jobs[pid::nproc])


def barrier_and_gather_json(out_dir: str, name: str, payload: dict,
                            pid: int, nproc: int, timeout_s: float = 600.0):
    """Filesystem results exchange for the sweep: each rank writes
    `<name>.host<pid>.json`; rank 0 waits for all and returns the merged
    list in rank order (None for a rank whose file never came; None on the
    other ranks)."""
    os.makedirs(out_dir, exist_ok=True)
    mine = os.path.join(out_dir, f"{name}.host{pid}.json")
    with open(mine + ".tmp", "w") as f:
        json.dump(payload, f, indent=2, default=float)
    os.replace(mine + ".tmp", mine)
    if pid != 0:
        return None
    t0 = time.time()
    want = [os.path.join(out_dir, f"{name}.host{i}.json") for i in range(nproc)]
    while time.time() - t0 < timeout_s:
        if all(os.path.exists(p) for p in want):
            break
        time.sleep(0.5)
    merged = []
    for p in want:
        try:
            with open(p) as f:
                merged.append(json.load(f))
        except OSError:
            merged.append(None)
    return merged


def spawn(target: str, n: int, device="cpu", backend: Optional[str] = None,
          kwargs: Optional[dict] = None, timeout_s: float = 600.0) -> list:
    """Run `target` ("module:function") as n local ranks, each a fresh
    interpreter that joins a process group of n ranks as
    `init_distributed(device, backend)` would (a real group at n = 1 too,
    over a file store in a temporary directory) and then calls
    `function(**kwargs)`. Returns the n return values in rank order (each
    pickled by its rank). Every rank has `timeout_s` from the start; a
    rank that exits non-zero or outlives it fails the call with the tail
    of its output, and the ranks still running are killed. The ranks
    inherit the environment (OMP_NUM_THREADS caps their CPU threads)."""
    work_dir = tempfile.mkdtemp(prefix="gmmloc_spawn_")
    with open(os.path.join(work_dir, "kwargs.pkl"), "wb") as f:
        pickle.dump(kwargs or {}, f)
    store = os.path.join(work_dir, "store")
    env = dict(os.environ)
    env.update(GMMLOC_COORDINATOR=f"file://{store}", GMMLOC_NUM_PROCESSES=str(n),
               GMMLOC_SPAWN_DEVICE=str(device), GMMLOC_SPAWN_BACKEND=backend or "",
               PYTHONPATH=os.pathsep.join([_ROOT] + [p for p in [env.get("PYTHONPATH")] if p]))
    procs, logs = [], []
    try:
        for rank in range(n):
            log = open(os.path.join(work_dir, f"rank{rank}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-u", "-m", "gmmloc_tpu_torch.parallel.distributed",
                 target, work_dir], env=dict(env, GMMLOC_PROCESS_ID=str(rank)),
                stdout=log, stderr=subprocess.STDOUT, cwd=_ROOT))
        deadline = time.monotonic() + timeout_s
        while True:
            rcs = [p.poll() for p in procs]
            bad = [(r, rc) for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if not bad and time.monotonic() > deadline:
                bad = [(rcs.index(None), f"killed after {timeout_s} s")]
            if bad:
                # a rank that failed leaves the others waiting in a collective
                rank, rc = bad[0]
                raise RuntimeError(f"{target}: rank {rank} of {n} failed ({rc}):\n"
                                   + _tail(os.path.join(work_dir, f"rank{rank}.log")))
            if all(rc == 0 for rc in rcs):
                break
            time.sleep(0.05)
        out = []
        for rank in range(n):
            with open(os.path.join(work_dir, f"result{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(work_dir, ignore_errors=True)


def _tail(path: str, n: int = 4000) -> str:
    with open(path) as f:
        return f.read()[-n:]


def _rank_main(target: str, work_dir: str) -> None:
    import importlib

    import torch.distributed as dist

    mod, fn = target.split(":")
    coord, nproc, pid = env_spec()
    # a real group at one rank too
    _init_group(coord, nproc, pid, os.environ["GMMLOC_SPAWN_DEVICE"],
                os.environ.get("GMMLOC_SPAWN_BACKEND") or None)
    with open(os.path.join(work_dir, "kwargs.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    try:
        result = getattr(importlib.import_module(mod), fn)(**kwargs)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    path = os.path.join(work_dir, f"result{pid}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)


if __name__ == "__main__":
    _rank_main(*sys.argv[1:3])
