"""Image pyramid + Gaussian blur.

PyTorch port of `gmmloc_tpu/features/pyramid.py` (ref
ORBextractor::ComputePyramid, orb_extractor.cpp:1056-1080): 8 levels,
scale factor 1.2, linear resize; descriptors are computed on a 7x7
sigma=2 Gaussian-blurred copy (:1028-1034).

Images are float32 (H, W) in [0, 255]. Levels have static shapes
H_l = round(H / 1.2^l).

The JAX package resizes with `jax.image.resize(..., "linear")`, which
antialiases when it downscales: a triangle kernel widened by 1/scale,
with weights normalised per output pixel. `F.interpolate` is another
filter, so the port builds the same (in, out) weight matrices in numpy
with JAX's `scale_and_translate` formula (float32) and applies them as two
float32 matrix products (TF32 off, `pipeline.system.set_numerics`).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import fma32


def level_shapes(h: int, w: int, num_levels: int, scale: float):
    return [
        (int(round(h / scale**l)), int(round(w / scale**l)))
        for l in range(num_levels)
    ]


@functools.lru_cache(maxsize=64)
def _weight_mat(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of an antialiased linear resize
    (jax._src.image.scale.compute_weight_mat, triangle kernel,
    translation 0), with the arithmetic XLA's CPU compiler gives it: the
    weights are 1 - |s - i| / kernel_scale (as a product with the
    reciprocal) from the sample position s rounded once as a fused
    multiply-add, and their column totals are summed from weights whose
    s was rounded twice (product, then subtract: another fusion). The
    weights then agree with the JAX package's to an ulp."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    recip_ks = f32(1.0) / max(inv_scale, f32(1.0))
    pos = np.arange(n_out, dtype=f32) + f32(0.5)
    rows = np.arange(n_in, dtype=f32)[:, None]

    def tri(sample):
        x = np.abs(sample[None, :] - rows) * recip_ks
        return np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)

    sample_f = (pos.astype(np.float64) * np.float64(inv_scale) - 0.5).astype(f32)
    w = tri(sample_f)
    tot = tri(pos * inv_scale - f32(0.5)).sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(tot != 0, tot, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_weights(shapes: Sequence[Tuple[int, int]], device) -> List[tuple]:
    """Per level l >= 1, the pair (rows (h_l, h_{l-1}), cols (w_{l-1}, w_l))
    of float32 weight tensors on `device` that `build_pyramid` applies."""
    out = []
    for (h0, w0), (h1, w1) in zip(shapes[:-1], shapes[1:]):
        out.append((torch.from_numpy(_weight_mat(h0, h1).T.copy()).to(device),
                    torch.from_numpy(_weight_mat(w0, w1)).to(device)))
    return out


def build_pyramid(img, shapes: Sequence[Tuple[int, int]], weights=None):
    """Linear-resized pyramid, each level from the one before. img (H,W)
    float32; `weights` from `resize_weights` (built here if omitted)."""
    if weights is None:
        weights = resize_weights(shapes, img.device)
    levels = [img]
    for rows, cols in weights:
        levels.append(torch.matmul(torch.matmul(rows, levels[-1]), cols))
    return tuple(levels)


def _gauss_kernel(ksize: int = 7, sigma: float = 2.0):
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


_K7 = [float(v) for v in _gauss_kernel()]


def _taps7(tap):
    """sum_i K7[i] * tap(i) as the JAX package's compiled blur sums it:
    fma(k0, t0, k1 * t1), then one fused multiply-add per further tap."""
    acc = fma32(_K7[0], tap(0), _K7[1] * tap(1))
    for i in range(2, 7):
        acc = fma32(_K7[i], tap(i), acc)
    return acc


def gaussian_blur7(img):
    """Separable 7x7 sigma=2 blur, reflect-101 borders (`jnp.pad(mode=
    "reflect")` is `F.pad(mode="reflect")`). Equal to the JAX package's
    blur bit for bit, which the BRIEF tests need: on a flat background
    two samples differ only in their rounding."""
    h, w = img.shape
    xp = F.pad(img[None], (0, 0, 3, 3), mode="reflect")[0]
    x = _taps7(lambda i: xp[i:i + h])
    xp = F.pad(x[None], (3, 3, 0, 0), mode="reflect")[0]
    return _taps7(lambda i: xp[:, i:i + w])
