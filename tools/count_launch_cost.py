"""Host cost of one `cuda_build.count_launch` call (what a hand kernel's
wrapper pays per launch to count it), in ns: the median of 7 rounds of
200000 calls, with and without a shape. Run from the root of a checkout
(it imports that checkout's package) to compare two versions on one
host: python3 tools/count_launch_cost.py
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time


def main() -> int:
    sys.path.insert(0, os.getcwd())
    from gmmloc_tpu_torch.utils import cuda_build

    def wrapper():
        pass
    wrapper.launches, wrapper.shapes = 0, set()
    n, out = 200_000, {}
    for name, shape in (("ns_per_call", None), ("ns_per_call_with_shape", (1280, 1280))):
        rounds = []
        for _ in range(7):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                cuda_build.count_launch(wrapper, shape)
            rounds.append((time.perf_counter_ns() - t0) / n)
        out[name] = statistics.median(rounds)
    out["launches"] = wrapper.launches
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
