"""The device an entry point runs on.

Entry points (`GMMLocSystem`, `mixture.load`/`from_arrays`,
`ImageFrontend`, `slice_run.make_inputs`/`make_image_inputs`) take
`device="cuda"` by default and run on the CPU only when the caller passes
"cpu". A CUDA device that is not there raises; nothing falls back.
"""

from __future__ import annotations

import contextlib
import gc
import threading

import torch


def resolve(device) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and no CUDA
    device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available "
            "(pass device='cpu' to run on the CPU)")
    return dev


_gc_lock = threading.Lock()
_gc_pause = {"depth": 0, "was_enabled": True}


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic garbage collector held off, in every thread, while
    the block runs: around a CUDA graph's capture. A collection that ran
    inside a capture could free, on the capturing thread, a CUDA graph
    some cycle kept alive (a finished system's kept BA graphs), a call the
    capture forbids: the capture fails with
    cudaErrorStreamCaptureInvalidated. Blocks may nest and overlap across
    threads; the collector runs again after the last one ends, if it ran
    before the first."""
    with _gc_lock:
        if _gc_pause["depth"] == 0:
            _gc_pause["was_enabled"] = gc.isenabled()
            gc.disable()
        _gc_pause["depth"] += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_pause["depth"] -= 1
            if _gc_pause["depth"] == 0 and _gc_pause["was_enabled"]:
                gc.enable()
