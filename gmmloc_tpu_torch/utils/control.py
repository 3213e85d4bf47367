"""Run-control flags: pause / step / stop.

The port's own copy of `gmmloc_tpu/utils/control.py` (stdlib only).
Ref: the reference's `global` namespace atomics (global.cpp:8-10,
global.h:9-14) -- UI-to-main-loop control. A small thread-safe singleton
usable from any driver (CLI signal handlers, notebooks, the viewer);
`GMMLocSystem.run` reads it before each frame.
"""

from __future__ import annotations

import threading


class _Control:
    def __init__(self):
        self._lock = threading.Lock()
        self.pause = False
        self.step = False
        self.stop = False

    def request_stop(self):
        with self._lock:
            self.stop = True

    def toggle_pause(self):
        with self._lock:
            self.pause = not self.pause

    def request_step(self):
        with self._lock:
            self.step = True

    def consume_step(self) -> bool:
        with self._lock:
            s = self.step
            self.step = False
            return s

    def should_run(self) -> bool:
        """Main-loop gate (ref: gmmloc.cpp:128 `!pause || step`)."""
        with self._lock:
            return (not self.pause) or self.step

    def reset(self):
        """Back to free-running: no pause, no pending step, no stop."""
        with self._lock:
            self.pause = self.step = self.stop = False


control = _Control()


def install_signal_handlers(ctl: _Control = control) -> None:
    """Map POSIX signals onto the control flags for headless drivers (the
    reference's keyboard handler, visualizer.cpp:205-221, is a GUI affair;
    a CLI process takes signals instead):

      SIGUSR1 -> toggle pause     SIGUSR2 -> single-step
      SIGTERM -> graceful stop (finish frame, export trajectory)
    """
    import signal

    signal.signal(signal.SIGUSR1, lambda *_: ctl.toggle_pause())
    signal.signal(signal.SIGUSR2, lambda *_: ctl.request_step())
    signal.signal(signal.SIGTERM, lambda *_: ctl.request_stop())
