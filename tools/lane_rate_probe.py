#!/usr/bin/env python3
"""Measured issue rates of four instruction classes on one NVIDIA GPU.

    python3 tools/lane_rate_probe.py [--out chiprun_out/lane_rates.json]

Builds `tools/lane_rate_probe.cu` with nvcc (as the package's kernels are
built: sm_90a, a plain C interface, ctypes) and runs, for float32 add,
float32 min/max, 32-bit integer xor/add, population count, 32-bit integer
min/max and a mix of float32 min with integer max (which shows whether
the two share a pipe), a kernel of dependent-free chains that fills every
SM with 2048 threads. Prints
per class the instructions per second (CUDA events around queued
launches), the SM clock during the run (cycle counter against the global
nanosecond timer), the results per SM and clock that follow, and beside
them the table values `eval/kernel_check.py` rates its bounds with
(`OPS_PER_SM_CLOCK`, from NVIDIA's CUDA C++ programming manual) and the rate
they give at the data sheet's boost clock. Where the toolkit has
`cuobjdump`, prints the machine instructions each probe kernel came to
(the compiler may issue an integer add on the multiply-add pipe, which
doubles what an xor/add mix can issue). Prints the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CLASSES = ("fadd", "fminmax", "int", "popc", "iminmax", "fmin_imax_mix")
TRIPS = 2000
BLOCKS_PER_SM = 8


def build(build_dir: str) -> str:
    from gmmloc_tpu_torch.utils import cuda_build

    os.makedirs(build_dir, exist_ok=True)
    lib = os.path.join(build_dir, "liblane_probe.so")
    src = os.path.join(ROOT, "tools", "lane_rate_probe.cu")
    res = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o", lib, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    return lib


def sass_histogram(lib: str) -> dict:
    """kernel class -> the most frequent machine instructions of its
    probe kernel, or {} without cuobjdump."""
    import collections
    import re
    import shutil

    from gmmloc_tpu_torch.utils import cuda_build

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(cuda_build._nvcc()),
                                                     "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : .*probe_kernelILi(\d)E", line)
        if m:
            name = CLASSES[int(m.group(1))]
            out[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)", line)
        if m and name:
            out[name][m.group(1)] += 1
    return {k: dict(v.most_common(5)) for k, v in out.items()}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "lane_rates.json"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("lane_rate_probe: no CUDA device", file=sys.stderr)
        return 2
    from gmmloc_tpu_torch.eval import kernel_check as kc
    from gmmloc_tpu_torch.utils import cuda_build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    lib = build(os.path.join(ROOT, "build", "lane_probe"))
    sass = sass_histogram(lib)
    dll = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.gmmloc_lane_probe.argtypes = [I, I, I, P, P, P]
    dll.gmmloc_lane_probe.restype = I
    dll.gmmloc_probe_ops_per_thread.argtypes = [I]
    dll.gmmloc_probe_ops_per_thread.restype = I

    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    sink = torch.empty(blocks * 256, dtype=torch.float32, device=device)
    clocks = torch.zeros(2, dtype=torch.int64, device=device)
    n_ops = blocks * 256 * dll.gmmloc_probe_ops_per_thread(TRIPS)
    results = []
    for cls, name in enumerate(CLASSES):
        def launch():
            stream = torch.cuda.current_stream(device).cuda_stream
            cuda_build.check(dll.gmmloc_lane_probe(cls, blocks, TRIPS, sink.data_ptr(),
                                                   clocks.data_ptr(), stream),
                             "gmmloc_lane_probe")

        ms = kc.time_cuda(launch, reps=5, warmup=2, queued=True)
        cycles, ns = (int(v) for v in clocks.cpu())
        sm_hz = cycles / ns * 1e9
        ops_s = n_ops / (ms * 1e-3)
        r = dict(instruction_class=name, ms=ms, ops_per_s=ops_s, sm_clock_hz=sm_hz, sms=sms,
                 per_sm_clock=ops_s / (sms * sm_hz),
                 table_per_sm_clock=kc.OPS_PER_SM_CLOCK.get(name),
                 table_ops_per_s=kc.OPS_S.get(name), sass=sass.get(name), card=card)
        print(json.dumps(r), flush=True)
        results.append(r)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(results, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
