"""Dataset loader: EuRoC ASL stereo sequences + synced GT trajectories.

PyTorch port's copy of `gmmloc_tpu/pipeline/dataloader.py` (ref
Dataloader/DataloaderEuRoC, dataloader.cpp, dataloader.h:15-105). The
reference reads mav0/cam0/data.csv and the cam0/cam1 image directories
(cam1 rides in the "depth" slot: it is the right stereo image) and a
TUM-style ground-truth file in sync with cam0.

Images decode only through the port's native PNG decoder and its
threaded prefetch ring (`utils/native.py`, built from
`gmmloc_tpu_torch/native/png_ring.cpp`): there is no other decoder, and
a library that does not build raises. Frames come out as float32 (H, W)
arrays; the host's wait on the ring is timed as `data/take`.
"""

from __future__ import annotations

import csv
import os
import struct
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..utils import native
from ..utils.timing import Timer

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


@dataclass
class DataFrame:
    """Ref: dataloader.h DataFrame -- mono = left, depth slot = right."""

    idx: int
    timestamp: float
    left: Optional[np.ndarray] = None
    right: Optional[np.ndarray] = None
    q_wc: Optional[np.ndarray] = None  # GT rotation (w,x,y,z)
    t_wc: Optional[np.ndarray] = None


def png_size(path: str):
    """(width, height) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != _PNG_SIG or head[12:16] != b"IHDR":
        raise IOError(f"not a PNG file: {path}")
    return struct.unpack(">II", head[16:24])


class EuRoCDataloader:
    """EuRoC ASL layout: <root>/mav0/cam{0,1}/data.csv + data/*.png.

    GT trajectory file: TUM format `t x y z qx qy qz qw`, one line per
    frame in sync with the cam0 timestamps (ref loadTrajectory,
    dataloader.cpp:118); its quaternions come out as (w, x, y, z)."""

    def __init__(self, data_path: str, gt_path: Optional[str] = None,
                 prefetch: int = 4, n_threads: int = 2):
        self.root = data_path
        cam0 = os.path.join(data_path, "mav0", "cam0")
        cam1 = os.path.join(data_path, "mav0", "cam1")
        if not os.path.isdir(cam0):
            raise FileNotFoundError(f"EuRoC cam0 dir missing: {cam0}")
        self.timestamps = []
        self.files_left = []
        self.files_right = []
        with open(os.path.join(cam0, "data.csv")) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ns, fname = row[0].strip(), row[1].strip()
                self.timestamps.append(int(ns) * 1e-9)
                self.files_left.append(os.path.join(cam0, "data", fname))
                self.files_right.append(os.path.join(cam1, "data", fname))
        self.gt_q = self.gt_t = None
        if gt_path:
            data = np.loadtxt(gt_path)
            self.gt_t = data[:, 1:4]
            q = data[:, [7, 4, 5, 6]]
            self.gt_q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        self._prefetch = prefetch
        self._n_threads = n_threads

    def __len__(self) -> int:
        return len(self.timestamps)

    def _frame(self, i: int, left, right) -> DataFrame:
        f = DataFrame(idx=i, timestamp=self.timestamps[i],
                      left=left.astype(np.float32), right=right.astype(np.float32))
        if self.gt_q is not None and i < len(self.gt_q):
            f.q_wc, f.t_wc = self.gt_q[i], self.gt_t[i]
        return f

    def get_frame(self, i: int) -> DataFrame:
        return self._frame(i, native.decode_png_gray(self.files_left[i]),
                           native.decode_png_gray(self.files_right[i]))

    def pairs(self, n: Optional[int] = None) -> Iterator:
        """(index, left uint8, right uint8) of the first `n` pairs (all by
        default) in order, decoded ahead by the native ring; the wait on
        the ring is timed as `data/take`. The ring's slots hold the
        largest image of those pairs (from the PNG headers)."""
        n = len(self) if n is None else min(n, len(self))
        if n <= 0:
            return
        left, right = self.files_left[:n], self.files_right[:n]
        slot = max(w * h for p in left + right for w, h in [png_size(p)])
        with native.NativePrefetcher(left, right, capacity=max(2, self._prefetch),
                                     n_threads=self._n_threads, max_pixels=slot) as pf:
            for i in range(n):
                with Timer("data/take"):
                    pair = pf.take()
                if pair is None:
                    return
                yield (i, *pair)

    def __iter__(self) -> Iterator[DataFrame]:
        """Prefetching iterator of float32 DataFrames."""
        for i, left, right in self.pairs():
            yield self._frame(i, left, right)
