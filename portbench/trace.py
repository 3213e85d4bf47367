"""The device trace of the measured window (`--trace 1`) and its reduction.

`Tracer` runs the profiler over the window's last `TRACE_SECONDS` (the
card's operations, and on the host only the harness's spans, marked as
ranges "pb:<span>"). `reduce_events` turns the trace into what the per-layer
readers and the breakdown read:

  - `busy_s`: the union of the intervals in which an operation ran on the
    card, on any stream (so two streams' overlapping kernels count once),
    within the traced window;
  - `window_s`: the traced window's length on the trace's clock;
  - `kernels`: per device operation name, (count, seconds);
  - `device_ops`: the ten names that took the most device time;
  - `idle_gaps`: the idle time between busy intervals, split over the
    harness spans the host was in meanwhile ("harness" outside them) and
    summed per span, the ten largest.
"""

from __future__ import annotations

import bisect
import contextlib
import time

WINDOW = "pb:window"
NAME_CHARS = 120
# the trace covers the measured window's last seconds: reading a trace
# takes about twice as long as it ran
TRACE_SECONDS = 10.0


class Tracer:
    """The profiler over the window: the card's operations (CUDA activity)
    and, on the host, only the ranges the harness marks (the user scope):
    the program's own operations are not recorded on the host, which
    keeps the profiler's cost per launch and the trace small."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.on = False
        self._window = None
        self.read_s = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function("pb:" + name)

    def warm(self) -> None:
        """One empty trace in the set-up, so the window's start of the
        profiler finds its libraries loaded."""
        if self.enabled:
            self.start()
            self.stop()

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        import torch.autograd.profiler as P
        from torch._C._autograd import _enable_profiler, _prepare_profiler
        from torch._C._profiler import ProfilerActivity, RecordScope

        acts = {ProfilerActivity.CPU}
        if torch.cuda.is_available():
            acts.add(ProfilerActivity.CUDA)
        prof = P.profile(use_device="cuda" if torch.cuda.is_available() else None)
        kw = {"create_trace_id": False} if "create_trace_id" in P.profile.config.__code__.co_varnames \
            else {}
        cfg = prof.config(**kw)
        _prepare_profiler(cfg, acts)
        _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
        self.on = True
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self):
        """Ends the trace; returns its reduction (None when not tracing)."""
        if not self.on:
            return None
        from torch._C._autograd import _disable_profiler
        from torch.autograd import DeviceType

        self._window.__exit__(None, None, None)
        self.on = False
        # no device-wide synchronize: the mapper thread may be capturing a
        # CUDA graph (the window's flush waited for the caller's stream)
        t0 = time.perf_counter()
        res = _disable_profiler()
        t1 = time.perf_counter()
        events = []
        for e in res.events():
            on_card = e.device_type() == DeviceType.CUDA
            name = e.name()
            if name.startswith("pb:"):
                # a range the harness marked shows on the card's timeline
                # too (a GPU user annotation): it is no device operation
                if not on_card:
                    events.append(("CPU", name, e.start_ns(), e.end_ns()))
            elif on_card:
                events.append(("CUDA", name, e.start_ns(), e.end_ns()))
        self.read_s = (t1 - t0, time.perf_counter() - t1)
        return reduce_events(events)


def merge(intervals):
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events) -> dict:
    """`events`: (device type, name, start ns, end ns). Device events are
    those whose device type names CUDA; spans are the CPU ranges named
    "pb:*"."""
    win = [(s, e) for dev, name, s, e in events if name == WINDOW]
    if not win:
        raise RuntimeError("the trace has no window range")
    w0, w1 = win[0]
    dev, kernels, spans = [], {}, []
    for d, name, s, e in events:
        if "CUDA" in d:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            dev.append((s, e))
            n, t = kernels.get(name, (0, 0.0))
            kernels[name] = (n + 1, t + (e - s) * 1e-9)
        elif name.startswith("pb:") and name != WINDOW:
            spans.append((s, e, name[3:]))
    busy = merge(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    spans.sort()
    ends = [e for _, e, _ in spans]
    idle = {}

    def add(label, ns):
        if ns > 0:
            idle[label] = idle.get(label, 0.0) + ns * 1e-9

    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            # split the gap [prev, s) over the spans it meets (the
            # harness's spans do not nest); the rest is the harness's own
            covered = 0
            for j in range(bisect.bisect_right(ends, prev), len(spans)):
                a, b, label = spans[j]
                if a >= s:
                    break
                ov = min(b, s) - max(a, prev)
                add(label, ov)
                covered += max(ov, 0)
            add("harness", s - prev - covered)
        prev = max(prev, e)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return dict(
        busy_s=busy_s, window_s=(w1 - w0) * 1e-9, kernels=kernels,
        device_ops=[[name[:NAME_CHARS], t] for name, (_, t) in top],
        idle_gaps=sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10])
