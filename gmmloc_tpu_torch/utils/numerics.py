"""Float32 arithmetic in the JAX package's compiled order.

XLA's CPU compiler contracts a float32 multiply feeding an add into one
fused multiply-add (one rounding). Where a result feeds a comparison of
near-equal values (a BRIEF test on a flat blurred background) or a long
prefix sum (IC-angle moments), one rounding more or less changes the
answer, so the port reproduces those contractions with `fma32`.
"""

from __future__ import annotations

import torch


def fma32(a, b, c):
    """round_f32(a * b + c) with one rounding: the float32 product is
    exact in float64 and the sum is rounded to float64 and then to
    float32 (the double rounding differs from a true fma only when the
    float64 sum lands exactly half-way between two float32 values)."""
    a = a.to(torch.float64) if isinstance(a, torch.Tensor) else float(a)
    return (a * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)
