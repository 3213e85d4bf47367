"""Named-scope timing registry with windowed statistics.

TPU-native replacement for the voxblox-derived timing utility
(ref: gmmloc/src/utils/timing.cpp, include/gmmloc/utils/
timing.h:20-183): a global registry of named accumulators (windowed
mean/min/max/stddev), RAII-style timers, and a table printer. Hierarchy
by tag convention ("loc/ba").

A span (`Timer`) records three numbers under the registry's lock, taken
once per span:

  - `<tag>`: its wall time (`time.perf_counter`);
  - `<tag>:self`: its wall time less the wall time of the spans opened
    inside it on the same thread (each thread keeps its own stack of
    open spans, so the mapper thread's spans are never children of the
    tracker's);
  - `<tag>:offcpu`: its wall time less the thread's CPU time over it
    (`time.thread_time_ns`): the time the thread was not charged CPU
    inside the span. That is an upper bound on its wait for the GIL: it
    also holds time blocked in the OS or preempted, and, where a sandbox
    charges no CPU for the system calls it traps (gVisor: the ioctls
    of a CUDA launch), the launch work itself. A wait on the card in
    which the CUDA runtime spins counts as CPU time. Where the thread's
    CPU clock advances in coarse steps (10 ms in a gVisor sandbox), one
    span reads up to a step off either way, so a reading can be
    negative; it is kept as it is, so that the total over many spans
    stays unbiased.

While the calling thread has a profiler on, a span also opens the range
"gl:<tag>" on the trace's clock, nested in the caller's ranges. It is a
function-scope range (`_RecordFunctionFast`, the host range PyTorch's
own generated code opens), not a user-scope one (`record_function`): a
user-scope range is copied onto the card's timeline as a GPU user
annotation, which a reducer of device events would count as a device
operation. So a profiler that records only the user scope records none
of these ranges; one that records every scope (`torch.profiler.profile`,
`tools/torch_profile.py`) does. The profiler is thread-local: a thread
started before the profiler was enabled (the mapper thread under a
trace started later) records no ranges. With the profiler off a span
pays one check for it.

The port's own copy of `gmmloc_tpu/utils/timing.py` (no JAX, so that
the port imports nothing of the JAX package), with a sample added under
the registry's lock, so the tracker and the mapper thread can time at
once while another thread prints the table.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, Optional

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

SELF, OFFCPU = ":self", ":offcpu"


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
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

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
        self._spans: Dict[str, tuple] = {}     # tag -> its three accumulators

    def get(self, tag: str) -> Accumulator:
        with self.lock:
            if tag not in self.accs:
                self.accs[tag] = Accumulator()
            return self.accs[tag]

    def add_span(self, tag: str, wall: float, self_s: float, offcpu: float) -> None:
        """One span's wall, self and off-CPU seconds, under one lock."""
        with self.lock:
            accs = self._spans.get(tag)
            if accs is None:
                accs = self._spans[tag] = tuple(
                    self.accs.setdefault(k, Accumulator()) for k in (tag, tag + SELF, tag + OFFCPU))
            accs[0].add(wall)
            accs[1].add(self_s)
            accs[2].add(offcpu)

    def reset(self) -> None:
        with self.lock:
            self.accs.clear()
            self._spans.clear()


REGISTRY = _Registry()
_OPEN = threading.local()      # .stack: this thread's open spans, innermost last


class Timer:
    """Context-manager timer: `with Timer("loc/ba"): ...`.

    Also usable imperatively (start/stop) like the reference's RAII timer;
    spans opened on one thread close in the reverse order.
    """

    __slots__ = ("tag", "_t0", "_c0", "_child", "_range")

    def __init__(self, tag: str):
        self.tag = tag
        self._t0: Optional[int] = None

    def start(self) -> "Timer":
        self._range = None
        if _profiler_enabled():
            self._range = _RecordFunctionFast("gl:" + self.tag)
            self._range.__enter__()
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        stack.append(self)
        self._child = 0
        self._c0 = time.thread_time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def stop(self) -> float:
        if self._t0 is None:
            return 0.0
        wall = time.perf_counter_ns() - self._t0
        cpu = time.thread_time_ns() - self._c0
        self._t0 = None
        stack = _OPEN.stack
        if stack[-1] is self:
            stack.pop()
        else:                       # an inner span left open by an exception
            del stack[stack.index(self):]
        if stack:
            stack[-1]._child += wall
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        REGISTRY.add_span(self.tag, wall * 1e-9, (wall - self._child) * 1e-9,
                          (wall - cpu) * 1e-9)
        return wall * 1e-9

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def print_table(out=None) -> str:
    """Ref: Timing::Print (timing.cpp:151+). One line per tag; its self and
    off-CPU totals as columns."""
    lines = ["Timing statistics:"]
    with REGISTRY.lock:
        accs = REGISTRY.accs
        for tag in sorted(t for t in accs if not t.endswith((SELF, OFFCPU))):
            a = accs[tag]
            own = accs.get(tag + SELF)
            off = accs.get(tag + OFFCPU)
            lines.append(
                f"  {tag:<28s} n={a.count:<6d} total={a.total:8.3f}s "
                f"self={own.total if own else a.total:8.3f}s "
                f"offcpu={off.total if off else 0.0:8.3f}s "
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
