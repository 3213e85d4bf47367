"""Hamming-distance matrix K3: hand-written CUDA kernel and plain version.

`hamming_matrix` wraps `csrc/hamming.cu`, which replaces the Pallas kernel
`gmmloc_tpu/features/pallas_kernels.py::hamming_matrix_pallas`. Tensors on
the CPU go to `hamming_matrix_plain` (XOR + popcount on tensors); tensors
on a CUDA device launch the kernel or raise. Launches are counted in
`hamming_matrix.launches`.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def _words(desc):
    """(N,32) uint8 -> (N,8) int64 holding the 8 little-endian uint32
    words (non-negative, so shifts are logical)."""
    return desc.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def hamming_matrix_plain(desc_a, desc_b):
    """(N,32)x(M,32) uint8 -> (N,M) int32 Hamming distances, one SWAR
    popcount per 32-bit word (PyTorch has no popcount op)."""
    a, b = _words(desc_a), _words(desc_b)
    out = torch.zeros(a.shape[0], b.shape[0], dtype=torch.int32, device=a.device)
    for w in range(8):
        x = a[:, None, w] ^ b[None, :, w]
        x = x - ((x >> 1) & _M1)
        x = (x & _M2) + ((x >> 2) & _M2)
        x = (x + (x >> 4)) & _M4
        out += ((x * 0x01010101) >> 24 & 0xFF).to(torch.int32)
    return out


def _check(name, d, dev):
    if d.dtype != torch.uint8 or d.dim() != 2 or d.shape[1] != 32:
        raise ValueError(f"{name}: expected (N,32) uint8, got {tuple(d.shape)} {d.dtype}")
    if d.device != dev:
        raise ValueError(f"{name} is on {d.device}, expected {dev}")
    if not d.is_contiguous() or d.data_ptr() % 4:
        raise ValueError(f"{name}: must be contiguous and 4-byte aligned")


def hamming_matrix(desc_a, desc_b):
    """(N,32)x(M,32) uint8 descriptors -> (N,M) int32 Hamming distances."""
    dev = desc_a.device
    if dev.type == "cpu":
        return hamming_matrix_plain(desc_a, desc_b)
    if dev.type != "cuda":
        raise ValueError(f"no Hamming kernel for device {dev}")
    _check("desc_a", desc_a, dev)
    _check("desc_b", desc_b, dev)
    n, m = desc_a.shape[0], desc_b.shape[0]
    out = torch.empty(n, m, dtype=torch.int32, device=dev)
    if n == 0 or m == 0:
        return out
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gmmloc_hamming(desc_a.data_ptr(), desc_b.data_ptr(), n, m,
                                 out.data_ptr(), stream)
    cuda_build.check(err, "gmmloc_hamming")
    hamming_matrix.launches += 1
    return out


hamming_matrix.launches = 0
