"""The disk-driven image path: an ASL tree on disk, read back by the loader.

The reference reads recorded EuRoC sequences from disk (mav0/cam0 and
cam1 PNG trees with a data.csv each). No recorded images ship with the
repository, so this harness writes rendered stereo pairs as such a tree
and drives the system from it:

  - `encode_png_gray` / `write_asl_tree`: numpy + stdlib (zlib, struct)
    8-bit grayscale PNGs. Row filters cycle by row over all five PNG
    filter types (None, Sub, Up, Average, Paeth), so the decoder's
    un-filtering is exercised on every kind; `cam{0,1}/data.csv` holds
    the frames' timestamps in integer nanoseconds.
  - `stereo_frames`: the double-buffered frame generator `GMMLocSystem.run`
    consumes: the loader's decode ring, then `ImageFrontend.dispatch` of
    pair i before `complete` of pair i - 1, as `slice_run.run_image` does
    from memory.
  - `run`: `GMMLocSystem.run` over that generator, with the records
    `slice_run.run_image` returns (per-frame host times, GMM anchors per
    completed frame, the tracked frames).

Used by `chip_smoke.py`'s `[disk]` phase and the tests.
"""

from __future__ import annotations

import os
import struct
import time
import zlib

import numpy as np

from ..pipeline.dataloader import EuRoCDataloader
from .slice_run import _AnchorLog, stream_sync

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
FILTERS = ("none", "sub", "up", "average", "paeth")


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def filter_rows(img: np.ndarray, bpp: int = 1) -> np.ndarray:
    """The PNG-filtered scanlines of (H, row bytes) uint8 image data with
    `bpp` bytes per pixel, each prefixed by its filter type byte; row y
    uses filter type y % 5. Returns (H, row bytes + 1) uint8."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)                       # the byte one pixel to the left
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)                       # the byte above
    b[1:] = x[:-1]
    c = np.zeros_like(x)                       # the byte above and one pixel left
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) // 2, paeth])
    kind = np.arange(img.shape[0]) % len(FILTERS)
    out = np.empty((img.shape[0], img.shape[1] + 1), np.uint8)
    out[:, 0] = kind
    out[:, 1:] = ((x - preds[kind, np.arange(img.shape[0])]) % 256).astype(np.uint8)
    return out


def encode_png_gray(img: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit grayscale, non-interlaced PNG of an (H, W) uint8 image."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    idat = zlib.compress(filter_rows(img).tobytes(), level)
    return _PNG_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) + _chunk(b"IEND", b"")


def write_asl_tree(root: str, images, ts) -> int:
    """Write stereo pairs [(left, right) uint8] as `<root>/mav0/cam{0,1}`
    (data/<ns>.png and data.csv) at timestamps `ts` (seconds). Returns
    the bytes written."""
    n_bytes = 0
    names = [f"{int(round(t * 1e9))}.png" for t in ts]
    for side, cam in enumerate(("cam0", "cam1")):
        d = os.path.join(root, "mav0", cam, "data")
        os.makedirs(d, exist_ok=True)
        for name, pair in zip(names, images):
            png = encode_png_gray(pair[side])
            with open(os.path.join(d, name), "wb") as f:
                f.write(png)
            n_bytes += len(png)
        csv = "#timestamp [ns],filename\n" + "".join(
            f"{name[:-4]},{name}\n" for name in names)
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write(csv)
        n_bytes += len(csv)
    return n_bytes


def write_rect_filestorage(path: str, width: int = 752, height: int = 480) -> None:
    """A synthetic stereo calibration in the reference's euroc_rect.yaml
    schema (OpenCV FileStorage: `%YAML:1.0`, `!!opencv-matrix` nodes with
    `data:[...]`): EuRoC-like radtan intrinsics for `width` x `height`,
    rectifying rotations of +-1.1 deg about y and a shared projection."""
    sx, sy = width / 752.0, height / 480.0

    def mat(rows, cols, data):
        vals = ", ".join(f"{v:.10f}" for v in np.ravel(data))
        return (f"   !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n   dt: d\n"
                f"   data:[ {vals} ]\n")

    c, s = np.cos(0.02), np.sin(0.02)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    P = np.array([[435.2 * sx, 0, 367.5 * sx, 0], [0, 435.2 * sy, 252.2 * sy, 0],
                  [0, 0, 1, 0]])
    txt = "%YAML:1.0\n"
    for side, k, d in (
            ("LEFT", (458.654, 457.296, 367.215, 248.375),
             (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)),
            ("RIGHT", (457.587, 456.134, 379.999, 255.238),
             (-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05))):
        K = np.array([[k[0] * sx, 0, k[2] * sx], [0, k[1] * sy, k[3] * sy], [0, 0, 1]])
        txt += f"{side}.height: {height}\n{side}.width: {width}\n"
        txt += f"{side}.D:{mat(1, len(d), d)}{side}.K:{mat(3, 3, K)}"
        txt += f"{side}.R:{mat(3, 3, R if side == 'LEFT' else R.T)}{side}.P:{mat(3, 4, P)}"
    with open(path, "w") as f:
        f.write(txt)


def stereo_frames(loader: EuRoCDataloader, frontend, n: int | None = None):
    """Frames of the first `n` pairs (all by default) of `loader`, double
    buffered: pair i is dispatched to the front end before pair i - 1 is
    completed and yielded."""
    pairs = loader.pairs(n)
    pend = None
    try:
        for i, left, right in pairs:
            new = frontend.dispatch(i, loader.timestamps[i], left, right)
            if pend is not None:
                yield frontend.complete(pend)
            pend = new
        if pend is not None:
            yield frontend.complete(pend)
    finally:
        pairs.close()


def run(system, frontend, loader: EuRoCDataloader, n: int | None = None,
        on_frame=None) -> dict:
    """`system.run` over `stereo_frames(loader, frontend, n)` with the
    loader's ground truth as the pose anchor. Returns `step_s`, the host
    time per frame (from one frame handed to `run` to the next: the
    system's step, the take and dispatch of the next pair and the
    completion of this one; the last also holds the flush), `n_anchors` as
    `slice_run.run_image` records them, `frames`, the frames handed to
    `run`, `seconds`, the wall time of the whole run, and `world`, what
    `run` returned. On a CUDA device the clock stops after the caller's
    stream is synchronized."""
    sync = stream_sync(frontend.device)
    log = _AnchorLog(system)
    marks, frames = [], []
    gen = stereo_frames(loader, frontend, n)

    def counted():
        for f in gen:
            log.record()                    # the consumer's previous step is done
            marks.append(time.perf_counter())
            frames.append(f)
            yield f

    sync()
    t0 = time.perf_counter()
    try:
        world = system.run(counted(), loader.gt_q, loader.gt_t, on_frame=on_frame)
    finally:
        gen.close()
    sync()
    t1 = time.perf_counter()
    log.record()
    step_s = np.diff(np.array([t0] + marks[1:] + [t1]))
    return dict(step_s=step_s, n_anchors=np.array(log.n_anchors), frames=frames,
                seconds=t1 - t0, world=world)
