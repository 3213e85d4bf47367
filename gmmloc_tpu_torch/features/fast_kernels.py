"""FAST-16 score + strict 3x3 NMS, K4: hand-written CUDA kernel and plain version.

`fast_score_nms` wraps `csrc/fast_nms.cu`, which replaces the Pallas
kernel `gmmloc_tpu/features/pallas_kernels.py::fast_score_nms_pallas`.
Tensors on the CPU go to `fast_score_nms_plain`
(`fast.nms3x3(fast.fast_score(img))`); tensors on a CUDA device launch
the kernel or raise. The two are equal bit for bit. Launches are counted
in `fast_score_nms.launches`.
"""

from __future__ import annotations

import torch

from . import fast
from ..utils import cuda_build


def fast_score_nms_plain(img):
    """(H,W) float32 image -> (H,W) float32 NMS'd FAST scores."""
    return fast.nms3x3(fast.fast_score(img))


def fast_score_nms(img, out=None):
    """(H,W) float32 image in [0,255] -> (H,W) float32 FAST scores that
    are strict 3x3 maxima (0 elsewhere and in the 3 px border), written
    into `out` where one is given (a contiguous (H,W) float32 tensor on
    the image's device that shares no memory with it)."""
    dev = img.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no FAST+NMS kernel for device {dev}")
    if dev.type == "cuda":
        if img.dtype != torch.float32 or img.dim() != 2:
            raise ValueError(f"img: expected (H,W) float32, got {tuple(img.shape)} {img.dtype}")
        if not img.is_contiguous():
            raise ValueError("img: must be contiguous")
    if out is not None:
        if (out.dtype != torch.float32 or out.shape != img.shape or out.device != dev
                or not out.is_contiguous()):
            raise ValueError(f"out: expected a contiguous {tuple(img.shape)} float32 tensor "
                             f"on {dev}, got {tuple(out.shape)} {out.dtype} on {out.device}")
        if out.untyped_storage().data_ptr() == img.untyped_storage().data_ptr():
            raise ValueError("out: must not share memory with img (blocks read their "
                             "neighbours' pixels)")
    if dev.type == "cpu":
        plain = fast_score_nms_plain(img)
        return plain if out is None else out.copy_(plain)
    if out is None:
        out = torch.empty_like(img)
    h, w = img.shape
    if h == 0 or w == 0:
        return out
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gmmloc_fast_nms(img.data_ptr(), h, w, out.data_ptr(), stream)
    cuda_build.check(err, "gmmloc_fast_nms")
    fast_score_nms.launches += 1
    return out


fast_score_nms.launches = 0
