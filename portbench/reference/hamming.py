"""Hamming-distance matrix, plain PyTorch (XOR and a SWAR popcount).

Frozen copy of the port's `hamming_matrix_plain`: the reference for K3
and for the stereo matching of the reference front end.
"""

from __future__ import annotations

import torch

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def _words(desc):
    """(N,32) uint8 -> (N,8) int64 holding the 8 little-endian uint32
    words (non-negative, so shifts are logical)."""
    return desc.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _popc32(x):
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return ((x * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def hamming_matrix(desc_a, desc_b, out=None):
    """(N,32)x(M,32) uint8 -> (N,M) int32 Hamming distances."""
    a, b = _words(desc_a), _words(desc_b)
    res = torch.zeros(a.shape[0], b.shape[0], dtype=torch.int32, device=a.device)
    for w in range(8):
        res += _popc32(a[:, None, w] ^ b[None, :, w])
    if out is not None:
        out.copy_(res)
        return out
    return res
