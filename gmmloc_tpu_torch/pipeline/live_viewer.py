"""Live during-run visualization.

The port's own copy of `gmmloc_tpu/pipeline/live_viewer.py` (stdlib
only). The reference runs a 30 Hz viewer thread publishing keyframes,
map, trajectory and TF to RViz with keyboard pause/step
(visualizer.cpp:150-221). Here a throttled writer re-exports the
self-contained HTML viewer (`pipeline/html_viewer.py`) from the RUNNING
system every `interval` seconds, with an auto-refresh tag, so a browser
tab follows the map as it grows. Pause, single-step and stop of the run
ride the run-control flags (`utils/control.py`: SIGUSR1 pause/resume,
SIGUSR2 step, SIGTERM stop).

Writes are atomic (temp + rename) so a browser never reads a torn file.
"""

from __future__ import annotations

import os
import time


class LiveViewer:
    def __init__(self, path: str, interval: float = 2.0, gmm=None,
                 refresh_s: float = 2.0):
        self.path = path
        self.interval = interval
        self.gmm = gmm
        self.refresh_s = refresh_s
        self._last = 0.0
        self.n_writes = 0

    def maybe_update(self, world, force: bool = False) -> bool:
        now = time.monotonic()
        if not force and now - self._last < self.interval:
            return False
        self._last = now
        from . import html_viewer

        tmp = self.path + ".tmp"
        html_viewer.export_html(world, tmp, gmm=self.gmm)
        # inject an auto-refresh tag so a plain browser tab follows the run
        with open(tmp) as f:
            html = f.read()
        html = html.replace(
            "<head>",
            f'<head><meta http-equiv="refresh" content="{self.refresh_s}">',
            1,
        )
        with open(tmp, "w") as f:
            f.write(html)
        os.replace(tmp, self.path)
        self.n_writes += 1
        return True
