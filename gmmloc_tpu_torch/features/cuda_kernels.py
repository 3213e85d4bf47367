"""Hamming-distance matrix K3: hand-written CUDA kernel and plain version.

`hamming_matrix` wraps `csrc/hamming.cu`, which replaces the Pallas kernel
`gmmloc_tpu/features/pallas_kernels.py::hamming_matrix_pallas`. Tensors on
the CPU go to `hamming_matrix_plain` (XOR + popcount on tensors); tensors
on a CUDA device launch the kernel or raise. Launches are counted in
`hamming_matrix.launches`, their distinct (N, M) in `hamming_matrix.shapes`.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def _words(desc):
    """(N,32) uint8 -> (N,8) int64 holding the 8 little-endian uint32
    words (non-negative, so shifts are logical)."""
    return desc.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _popc32(x):
    """Population count of 32-bit words held in int64 (SWAR: PyTorch has
    no popcount op)."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return ((x * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def hamming_matrix_plain(desc_a, desc_b):
    """(N,32)x(M,32) uint8 -> (N,M) int32 Hamming distances, one
    popcount per 32-bit word of the XOR."""
    a, b = _words(desc_a), _words(desc_b)
    out = torch.zeros(a.shape[0], b.shape[0], dtype=torch.int32, device=a.device)
    for w in range(8):
        out += _popc32(a[:, None, w] ^ b[None, :, w])
    return out


def hamming_matrix_and_popc(desc_a, desc_b):
    """The identity under the kernel's tensor-core form:
    hamming(a, b) = popc(a) + popc(b) - 2 popc(a & b). For the tests."""
    a, b = _words(desc_a), _words(desc_b)
    both = sum(_popc32(a[:, None, w] & b[None, :, w]) for w in range(8))
    pa = _popc32(a).sum(1, dtype=torch.int32)
    pb = _popc32(b).sum(1, dtype=torch.int32)
    return pa[:, None] + pb[None, :] - 2 * both


def _check(name, d, dev):
    if d.dtype != torch.uint8 or d.dim() != 2 or d.shape[1] != 32:
        raise ValueError(f"{name}: expected (N,32) uint8, got {tuple(d.shape)} {d.dtype}")
    if d.device != dev:
        raise ValueError(f"{name} is on {d.device}, expected {dev}")
    if dev.type == "cuda" and (not d.is_contiguous() or d.data_ptr() % 16):
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def hamming_matrix(desc_a, desc_b, out=None):
    """(N,32)x(M,32) uint8 descriptors -> (N,M) int32 Hamming distances,
    written into `out` where one is given (a contiguous (N,M) int32 tensor
    on the descriptors' device)."""
    dev = desc_a.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no Hamming kernel for device {dev}")
    _check("desc_a", desc_a, dev)
    _check("desc_b", desc_b, dev)
    n, m = desc_a.shape[0], desc_b.shape[0]
    if out is not None and (out.dtype != torch.int32 or tuple(out.shape) != (n, m)
                            or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out: expected a contiguous ({n},{m}) int32 tensor on {dev}, "
                         f"got {tuple(out.shape)} {out.dtype} on {out.device}")
    if dev.type == "cpu":
        plain = hamming_matrix_plain(desc_a, desc_b)
        return plain if out is None else out.copy_(plain)
    if out is None:
        out = torch.empty(n, m, dtype=torch.int32, device=dev)
    if n == 0 or m == 0:
        return out
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gmmloc_hamming(desc_a.data_ptr(), desc_b.data_ptr(), n, m,
                                 out.data_ptr(), stream)
    cuda_build.check(err, "gmmloc_hamming")
    cuda_build.count_launch(hamming_matrix, (n, m))
    return out


hamming_matrix.launches = 0
hamming_matrix.shapes = set()   # the (N, M) of the launches, for the card checks
