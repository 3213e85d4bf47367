"""Image front end: a stereo pair of images -> Frame.

PyTorch port of `gmmloc_tpu/pipeline/frontend.py` (ref the image block of
GMMLoc::processFrame, gmmloc.cpp:199-267): rectify -> equalise -> ORB on
both images -> stereo matching -> Frame.

- `process()`: the per-stage path (each image detected on its own, the
  pyramids built again for stereo), for tests and debugging.
- `dispatch()` / `complete()`: the main path. `dispatch` uploads the two
  uint8 images, enqueues one pass per frame -- one pyramid per image
  shared by detection and stereo refinement, one FAST + NMS launch (K4)
  over both images' stacked atlases, one Hamming matrix (K3) for stereo
  -- then enqueues copies of a float (N, 8) table and the (N, 32) uint8
  descriptors into pinned host buffers and records a CUDA event. It does
  not wait. `complete` waits on that event alone and builds the Frame.
  Calling dispatch(i + 1) before complete(i) double-buffers the front end
  against the tracker, as the reference overlaps its extractor threads
  with the main loop (gmmloc.cpp:241-249).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..features import detect, stereo
from ..tracking.frame import Frame, make_frame
from ..utils.device import resolve
from ..utils.timing import Timer
from .rectify import Rectifier, equalize_hist

@dataclass
class FrontendPending:
    idx: int
    timestamp: float
    table: torch.Tensor    # (N, 8) float32 on the host: uv(2) u_right depth
                           # octave angle valid response
    desc: torch.Tensor     # (N, 32) uint8 on the host
    event: Optional[torch.cuda.Event]
    n: int


class ImageFrontend:
    def __init__(self, cfg: SystemConfig, rectifier: Optional[Rectifier] = None,
                 device="cuda"):
        from .system import set_numerics

        set_numerics()
        self.cfg = cfg
        self.rect = rectifier
        self.device = resolve(device)
        cam = cfg.camera
        self.detector = detect.ORBDetector(
            cam.height, cam.width,
            num_features=cfg.frame.num_features,
            num_levels=cfg.frame.num_levels,
            scale=cfg.frame.scale_factor,
            distribution=cfg.frame.detect_distribution,
            device=self.device,
        )
        self.scale_factors = torch.tensor(cfg.frame.scale_factors(), dtype=torch.float32,
                                          device=self.device)
        self.baseline = cam.bf / cam.fx
        self.bf = cam.bf

    def _prepare(self, left, right):
        """Images -> float32 (H,W) on the device, rectified and equalised
        as the configuration asks."""
        def up(img):
            t = torch.as_tensor(np.asarray(img))
            return t.to(self.device, non_blocking=True).to(torch.float32)

        left, right = up(left), up(right)
        cam = self.cfg.camera
        if cam.do_rectify and self.rect is not None:
            left = self.rect.rectify_left(left)
            right = self.rect.rectify_right(right)
        if cam.do_equalization:
            left = equalize_hist(left)
            right = equalize_hist(right)
        return left, right

    # ---------------- per-stage path (tests / debugging) ---------------

    def process(self, idx: int, timestamp: float, left, right) -> Frame:
        left, right = self._prepare(left, right)
        det = self.detector
        det_l, det_r = det(left), det(right)
        u_right, depth = stereo.compute_stereo_matches(
            det.build_pyramid(left), det.build_pyramid(right),
            det_l.uv, det_l.octave, det_l.desc, det_l.valid,
            det_r.uv, det_r.octave, det_r.desc, det_r.valid,
            self.scale_factors, bf=self.bf, baseline=self.baseline)
        valid = det_l.valid.cpu().numpy()
        n = len(valid)
        frame = make_frame(
            idx, timestamp, det_l.uv.cpu().numpy(), u_right.cpu().numpy(),
            depth.cpu().numpy(), det_l.octave.cpu().numpy(), det_l.angle.cpu().numpy(),
            det_l.desc.cpu().numpy(), max(self.cfg.frame.feat_cap, n))
        frame.valid[:n] = valid
        return frame

    # ---------------- one pass per frame (main path) -------------------

    def _packed(self, left, right):
        det = self.detector
        pyr_l, pyr_r = det.build_pyramid(left), det.build_pyramid(right)
        det_l, det_r = det.detect_pair_from_levels(pyr_l, pyr_r)
        u_right, depth = stereo.compute_stereo_matches(
            pyr_l, pyr_r, det_l.uv, det_l.octave, det_l.desc, det_l.valid,
            det_r.uv, det_r.octave, det_r.desc, det_r.valid,
            self.scale_factors, bf=self.bf, baseline=self.baseline)
        table = torch.cat([
            det_l.uv, u_right[:, None], depth[:, None],
            det_l.octave.to(torch.float32)[:, None], det_l.angle[:, None],
            det_l.valid.to(torch.float32)[:, None], det_l.response[:, None],
        ], dim=1)
        return table, det_l.desc

    def dispatch(self, idx: int, timestamp: float, left, right) -> FrontendPending:
        """Enqueue the front end of one uint8 stereo pair and the copy of
        its result to the host; returns without waiting. Host time in
        the `frontend/dispatch` timer."""
        with Timer("frontend/dispatch"):
            table, desc = self._packed(*self._prepare(np.asarray(left, np.uint8),
                                                      np.asarray(right, np.uint8)))
            event = None
            if self.device.type == "cuda":
                host_t = torch.empty(table.shape, dtype=table.dtype, pin_memory=True)
                host_d = torch.empty(desc.shape, dtype=desc.dtype, pin_memory=True)
                host_t.copy_(table, non_blocking=True)
                host_d.copy_(desc, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                table, desc = host_t, host_d
        return FrontendPending(idx=idx, timestamp=timestamp, table=table, desc=desc,
                               event=event, n=table.shape[0])

    def complete(self, pend: FrontendPending) -> Frame:
        """Wait for one dispatched frame and build its Frame (the wait in
        the `frontend/wait` timer)."""
        if pend.event is not None:
            with Timer("frontend/wait"):
                pend.event.synchronize()
        out = pend.table.numpy()
        n = pend.n
        frame = make_frame(
            pend.idx, pend.timestamp, out[:, 0:2], out[:, 2], out[:, 3],
            out[:, 4].astype(np.int32), out[:, 5], pend.desc.numpy(),
            max(self.cfg.frame.feat_cap, n))
        frame.valid[:n] = out[:, 6] > 0.5
        return frame

    def process_packed(self, idx: int, timestamp: float, left, right) -> Frame:
        """The main-path pass, completed at once."""
        return self.complete(self.dispatch(idx, timestamp, left, right))
