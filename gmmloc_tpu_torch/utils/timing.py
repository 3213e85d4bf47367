"""Named-scope timing registry with windowed statistics.

TPU-native replacement for the voxblox-derived timing utility
(ref: gmmloc/src/utils/timing.cpp, include/gmmloc/utils/
timing.h:20-183): a global registry of named accumulators (windowed
mean/min/max/stddev), RAII-style timers, and a table printer. Hierarchy
by tag convention ("loc/ba"). Device work is made observable by passing
a `block` callable (torch.cuda.synchronize) to the timer.

The port's own copy of `gmmloc_tpu/utils/timing.py` (numpy only, so that
the port imports nothing of the JAX package), with one change: a sample
is added under the registry's lock, so the tracker and the mapper thread
can time at once while another thread prints the table.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, Optional


class Accumulator:
    """Windowed statistics (ref: timing.h Accumulator, window=50)."""

    def __init__(self, window: int = 50):
        self.window = deque(maxlen=window)
        self.total = 0.0
        self.count = 0
        self.min = math.inf
        self.max = 0.0

    def add(self, v: float) -> None:
        self.window.append(v)
        self.total += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def rolling_mean(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0

    def stddev(self) -> float:
        n = len(self.window)
        if n < 2:
            return 0.0
        m = self.rolling_mean()
        return math.sqrt(sum((x - m) ** 2 for x in self.window) / (n - 1))


class _Registry:
    def __init__(self):
        self.lock = threading.Lock()
        self.accs: Dict[str, Accumulator] = {}

    def get(self, tag: str) -> Accumulator:
        with self.lock:
            if tag not in self.accs:
                self.accs[tag] = Accumulator()
            return self.accs[tag]

    def add(self, tag: str, v: float) -> None:
        with self.lock:
            if tag not in self.accs:
                self.accs[tag] = Accumulator()
            self.accs[tag].add(v)

    def reset(self) -> None:
        with self.lock:
            self.accs.clear()


REGISTRY = _Registry()


class Timer:
    """Context-manager timer: `with Timer("loc/ba"): ...`.

    Also usable imperatively (start/stop) like the reference's RAII timer.
    """

    def __init__(self, tag: str, block=None):
        self.tag = tag
        self.block = block  # optional callable to sync device work
        self._t0: Optional[float] = None

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._t0 is None:
            return 0.0
        if self.block is not None:
            self.block()
        dt = time.perf_counter() - self._t0
        REGISTRY.add(self.tag, dt)
        self._t0 = None
        return dt

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def print_table(out=None) -> str:
    """Ref: Timing::Print (timing.cpp:151+)."""
    lines = ["Timing statistics:"]
    with REGISTRY.lock:
        tags = sorted(REGISTRY.accs)
        for tag in tags:
            a = REGISTRY.accs[tag]
            lines.append(
                f"  {tag:<28s} n={a.count:<6d} total={a.total:8.3f}s "
                f"mean={a.mean()*1e3:8.2f}ms roll={a.rolling_mean()*1e3:8.2f}ms "
                f"min={a.min*1e3:7.2f}ms max={a.max*1e3:8.2f}ms "
                f"std={a.stddev()*1e3:7.2f}ms"
            )
    s = "\n".join(lines)
    if out is not None:
        print(s, file=out)
    return s


def reset() -> None:
    REGISTRY.reset()
