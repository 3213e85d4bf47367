"""The card's published peaks and the kernels' least times (the
yardstick of the roofline shares), copied from the port's
`eval/kernel_check.py`.

H100 SXM, NVIDIA's data sheet, at the 700 W limit: HBM at 3.35 TB/s.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12


def level_shapes(h: int, w: int, num_levels: int, scale: float):
    """The pyramid's (height, width) per level."""
    return [(int(round(h / scale ** l)), int(round(w / scale ** l))) for l in range(num_levels)]


def atlas_shape(config: dict) -> tuple:
    """(rows, cols) of the atlas K4 scores once per stereo pair: each
    image's levels stacked (rows = the sum of the level heights, cols =
    the level-0 width), the two images one above the other."""
    cam, fr = config["camera"], config["frame"]
    shapes = level_shapes(cam["height"], cam["width"], fr["num_levels"], fr["scale_factor"])
    return 2 * sum(h for h, _ in shapes), shapes[0][1]


def fast_nms_bytes(rows: int, cols: int) -> int:
    """K4's bytes: the float32 atlas read once and the float32 scores
    written once."""
    return rows * cols * 8


def fast_nms_bound_s(config: dict) -> float:
    """K4's least time per launch: its bytes at the HBM rate (the bytes
    bound it; the operations no exact kernel avoids take less, as
    `kernel_check.fast_bound` counts them)."""
    return fast_nms_bytes(*atlas_shape(config)) / HBM_BYTES_S
