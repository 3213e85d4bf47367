"""The device an entry point runs on.

Entry points (`GMMLocSystem`, `mixture.load`/`from_arrays`,
`ImageFrontend`, `slice_run.make_inputs`/`make_image_inputs`) take
`device="cuda"` by default and run on the CPU only when the caller passes
"cpu". A CUDA device that is not there raises; nothing falls back.
"""

from __future__ import annotations

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
