"""Online (concurrent) mapping: the tracking/mapping thread pair.

PyTorch port of `gmmloc_tpu/mapping/online.py`. The reference's mapping
thread consumes a keyframe queue (localization.cpp spin:23-63), a new
keyframe sets an abort flag meant to preempt a running BA
(insertKeyFrame:401-405), and the tracker throttles keyframe creation on
the queue length and the mapper's idleness (gmmloc.cpp:349-361).

A host worker thread drives the same `Localization` pipeline; the device
calls release the GIL, so tracking (the caller's thread) overlaps mapping.
Only the queue has a lock; the host registry is shared as the reference
shares it. On the card the worker enqueues its device work on a stream
of its own; the device-world mirror's rule for the tables the tracker
reads is in `device_world.py`.

Failures are not swallowed: an exception in the worker ends it, and
`check()` (called by `GMMLocSystem.step`) and `stop()` raise it.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import torch

from .localization import Localization


class OnlineLocalization:
    """Wraps a Localization with the reference's spin() thread lifecycle."""

    def __init__(self, localizer: Localization, poll_s: float = 0.003):
        self.loc = localizer
        self.poll_s = poll_s  # ref: 3 ms sleep (localization.cpp:61)
        self.join_timeout_s = 300.0
        self._shutdown = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._stream = None

    # queue API (ref insertKeyFrame / countKFsInQueue)

    @property
    def is_idle(self) -> bool:
        return self.loc.is_idle

    def insert_keyframe(self, kf: int) -> None:
        with self._lock:
            self.loc.insert_keyframe(kf)  # sets abort_ba

    def count_queue(self) -> int:
        with self._lock:
            return self.loc.count_queue()

    def interrupt_ba(self) -> None:
        self.loc.abort_ba = True

    # lifecycle (ref spin/stop, localization.cpp:23-63)

    def start(self) -> None:
        dev = self.loc.device
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(dev)
            # the mirror and the map were created on the caller's stream
            self._stream.wait_stream(torch.cuda.current_stream(dev))
        self._shutdown = False
        self._thread = threading.Thread(target=self._run, name="gmmloc-mapper",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            if self._stream is not None:
                with torch.cuda.device(self.loc.device), torch.cuda.stream(self._stream):
                    self._spin()
            else:
                self._spin()
        except BaseException as e:   # reported by check() and stop()
            self._error = e
        finally:
            self.loc.is_finished = True

    def _spin(self) -> None:
        self.loc.is_finished = False
        while True:
            with self._lock:
                has_kf = bool(self.loc.queue)
            if self._shutdown and not has_kf:
                break
            if has_kf:
                self.loc.spin_once()
            time.sleep(self.poll_s)

    def check(self) -> None:
        """Raise the worker's exception, if it died of one."""
        if self._error is not None:
            raise RuntimeError("the mapping thread failed") from self._error

    def stop(self) -> None:
        """Drain the queue, then join (ref GMMLoc::stop, gmmloc.cpp:366).
        Raises if the worker failed or is still running after the time
        limit."""
        self._shutdown = True
        if self._thread is not None:
            self._thread.join(timeout=self.join_timeout_s)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"the mapping thread did not finish within {self.join_timeout_s} s")
            self._thread = None
            if self._stream is not None:
                # the caller's later device work sees the mapper's writes
                torch.cuda.current_stream(self.loc.device).wait_stream(self._stream)
        self.check()
