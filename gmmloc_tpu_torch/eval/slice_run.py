"""The port's main paths as runs: configuration, seeded inputs, the loops.

Two configurations:

  - the production configuration (`production_config`) is what the JAX
    package's `bench.py` runs: `euroc_v1_config()` with its defaults (the
    device-world mirror, fused triangulation, device BA assembly, packed
    IO), the velocity damping of the reference's end-to-end tests and the
    device-chained pipeline at depth 4, offline or online;
  - the slice configuration (`slice_config`) is the first slice's:
    offline, pipeline depth 1, the unpacked fused track step and
    host-assembled mapping (`use_device_world=False`).

Two main paths run them on the seeded room fixture (`room_fixture`):

  - the feature path (`make_inputs`, `run`): synthetic feature frames
    (`synthetic`) straight into `GMMLocSystem.step`;
  - the image path (`image_config`, `make_image_inputs`, `run_image`):
    rendered uint8 stereo pairs (`image_synthetic`) through the ORB front
    end (`pipeline.frontend.ImageFrontend`) into `GMMLocSystem.step`, as
    the JAX package's image bench line runs it.

Used by `chip_smoke.py`, `tools/torch_profile.py` and the tests.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..config import SystemConfig, euroc_v1_config
from ..gmm import mixture
from ..utils import proto, timing
from . import room_fixture, synthetic
from .image_synthetic import SpriteRenderer


def slice_config(feat_cap: int | None = None, num_features: int | None = None,
                 local_map_cap: int | None = None) -> SystemConfig:
    """The slice configuration; the optional arguments cut widths for
    small CPU runs."""
    cfg = euroc_v1_config()
    tk = dict(velocity_damping=0.9, pipeline_depth=1, fused_packed_io=False)
    if local_map_cap is not None:
        tk["fused_local_map_cap"] = local_map_cap
    fr = {}
    if feat_cap is not None:
        fr["feat_cap"] = feat_cap
    if num_features is not None:
        fr["num_features"] = num_features
    return cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, **tk),
        loc=dataclasses.replace(cfg.loc, use_device_world=False),
        frame=dataclasses.replace(cfg.frame, **fr),
        online=False,
    )


def production_config(online: bool, feat_cap: int | None = None,
                      num_features: int | None = None,
                      local_map_cap: int | None = None) -> SystemConfig:
    """`euroc_v1_config()` as `bench.py` runs it: velocity_damping=0.9,
    pipeline_depth=4, `online` as given, every other option at its
    default; the optional arguments cut widths for small CPU runs."""
    cfg = euroc_v1_config()
    tk = dict(velocity_damping=0.9, pipeline_depth=4)
    if local_map_cap is not None:
        tk["fused_local_map_cap"] = local_map_cap
    fr = {}
    if feat_cap is not None:
        fr["feat_cap"] = feat_cap
    if num_features is not None:
        fr["num_features"] = num_features
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, **tk),
                       frame=dataclasses.replace(cfg.frame, **fr), online=online)


def make_world(cfg: SystemConfig, out_dir: str, n_frames: int,
               n_components: int = 3300, n_landmarks: int = 30000, seed: int = 0,
               device="cuda", sequence_seed: int | None = None):
    """Write the room fixture under out_dir (a trajectory of n_frames + 50
    frames) and load the map on `device`. The synthetic landmarks and
    noise are drawn from `sequence_seed` (default `seed`). Returns (gmap,
    the synthetic front end, ts, q_wc, t_wc)."""
    gmm_path, gt_path = room_fixture.write_room_fixture(
        out_dir, n_components=n_components, n_frames=n_frames + 50, seed=seed)
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, gt_path=gt_path, gmm_path=gmm_path, n_landmarks=n_landmarks,
        seed=seed if sequence_seed is None else sequence_seed, disp_noise=0.1,
        pixel_noise=0.25, drop_frac=0.1)
    gmap = mixture.load(gmm_path, device,
                        pad_to=cfg.caps.gmm_components_pad,
                        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
                        neighbor_cap=cfg.gmm.neighbor_cap)
    return gmap, fe, ts, q_wc, t_wc


def make_inputs(cfg: SystemConfig, out_dir: str, n_frames: int,
                n_components: int = 3300, n_landmarks: int = 30000, seed: int = 0,
                device="cuda", sequence_seed: int | None = None):
    """`make_world`, then every frame generated up front (the harness
    stays off the clock). Returns (gmap, frames, q_wc, t_wc)."""
    gmap, fe, ts, q_wc, t_wc = make_world(cfg, out_dir, n_frames, n_components,
                                          n_landmarks, seed, device, sequence_seed)
    frames = [fe.make_frame(i, ts[i], q_wc[i], t_wc[i]) for i in range(n_frames)]
    return gmap, frames, q_wc[:n_frames], t_wc[:n_frames]


def default_fixture_dir() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "build", "gmmloc_tpu_torch", "fixture")


def image_config(cfg: SystemConfig | None = None, **widths) -> SystemConfig:
    """`cfg` (default `slice_config(**widths)`) for rendered images: no
    rectification and no histogram equalisation (the images are synthetic
    and already rectified), as the JAX package's image bench line runs
    it."""
    cfg = slice_config(**widths) if cfg is None else cfg
    return cfg.replace(camera=dataclasses.replace(
        cfg.camera, do_rectify=False, do_equalization=False))


def make_image_inputs(cfg: SystemConfig, out_dir: str, n_frames: int,
                      n_components: int = 3300, n_landmarks: int = 9000,
                      seed: int = 0, device="cuda"):
    """Write the room fixture under out_dir, load the map on `device`,
    sample a sprite world of `n_landmarks` from the map's components and
    render every stereo pair up front as uint8 (the harness stays off the
    clock). Returns (gmap, images [(left, right)], ts, q_wc, t_wc)."""
    gmm_path, gt_path = room_fixture.write_room_fixture(
        out_dir, n_components=n_components, n_frames=n_frames + 50, seed=seed)
    means, covs, _, _ = proto.load_gmm_file(gmm_path)
    world = synthetic.sample_world_from_gmm(means, covs, n_landmarks=n_landmarks,
                                            seed=seed)
    renderer = SpriteRenderer(world, cfg, seed=seed)
    ts, q_wc, t_wc = synthetic.load_gt_trajectory(gt_path)
    to8 = lambda im: np.clip(np.round(im), 0, 255).astype(np.uint8)
    images = []
    for i in range(n_frames):
        left, right = renderer.render_stereo(q_wc[i], t_wc[i])
        images.append((to8(left), to8(right)))
    gmap = mixture.load(gmm_path, device, pad_to=cfg.caps.gmm_components_pad,
                        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
                        neighbor_cap=cfg.gmm.neighbor_cap)
    return gmap, images, ts[:n_frames], q_wc[:n_frames], t_wc[:n_frames]


class _AnchorLog:
    """The GMM anchors kept by the pose solve of each completed frame (the
    tracker replaces its debug dict once per completed frame)."""

    def __init__(self, system):
        self.system = system
        self.dbg = system.tracker.dbg
        self.n_anchors = []

    def record(self):
        if self.system.tracker.dbg is not self.dbg:
            self.dbg = self.system.tracker.dbg
            self.n_anchors.append(self.dbg.get("n_anchors", 0))


class _ChainLog:
    """After each step: the chained dispatches so far and the frames
    rewound so far (their chained results were dropped), so a caller can
    count the frames of a window that ran chained."""

    def __init__(self, system):
        self.system = system
        self.chained, self.rewound = [], []

    def record(self):
        self.chained.append(self.system.tracker.n_chained)
        self.rewound.append(self.system.n_rewound_frames)

    def arrays(self) -> dict:
        return dict(chained=np.array(self.chained), rewound=np.array(self.rewound))


def chained_share(ran: dict, warmup: int) -> float:
    """Share of the steps after `warmup` whose frame ran chained (a
    chained dispatch not rewound), from `run`/`run_image`'s counters."""
    c, r = ran["chained"], ran["rewound"]
    n = len(c) - warmup
    c0, r0 = (c[warmup - 1], r[warmup - 1]) if warmup else (0, 0)
    return float((c[-1] - c0) - (r[-1] - r0)) / max(1, n)


def stream_sync(device):
    """A function that waits for the work queued on the calling thread's
    current CUDA stream (nothing on the CPU). Not a device-wide
    synchronize: in online mode the mapper thread may be capturing a CUDA
    graph on its own stream, and a device-wide synchronize during a
    capture fails (cudaErrorStreamCaptureUnsupported)."""
    if torch.device(device).type != "cuda":
        return lambda: None
    return lambda: torch.cuda.current_stream().synchronize()


def pace_mapper(system) -> None:
    """Wait until the mapper thread has finished every keyframe queued so
    far, then order the caller's stream after the mapper's. Called after
    each step, it fixes the two threads' order (the tracker never runs
    ahead of the mapper), so an online run repeats bit for bit. Nothing
    to wait for offline. Works on the JAX package's system as well."""
    mapper = system.online
    if mapper is None:
        return
    timeout_s = 300.0          # a bound for a stuck mapper, not a pace
    deadline = time.monotonic() + timeout_s
    while mapper.count_queue() or not mapper.is_idle:
        getattr(mapper, "check", lambda: None)()     # the port's: raise its failure
        if time.monotonic() > deadline:
            raise RuntimeError(f"the mapper did not finish its keyframes in {timeout_s} s")
        time.sleep(0.001)
    stream = getattr(mapper, "_stream", None)
    if stream is not None:
        torch.cuda.current_stream(stream.device).wait_stream(stream)


def _check_tracked(system, st, i):
    if system.track_failed or (st is not None and not st.res):
        raise RuntimeError(f"tracking failed at frame {i}")


def run_image(system, frontend, images, ts, q_wc, t_wc, first_idx: int = 0) -> dict:
    """The double-buffered image loop: dispatch the front end of frame i,
    complete frame i - 1 and step it, then flush. Returns `step_s`, the
    host wall time per frame (the loop iteration that completes it, the
    first also holding the first dispatch, the last the flush), `n_anchors`
    as `run` records them, `frontend_ms`, the time between CUDA events
    around each frame's dispatch (its device time plus any wait of the
    device for the host to enqueue; None on the CPU), `frames`, the
    tracked Frames, and the chain counters per step (`chained_share`).
    Frame indices start at `first_idx` (a run that goes on
    from an earlier one). Stats lag by the pipeline depth (None while it
    fills). Raises on a tracking failure."""
    cuda = frontend.device.type == "cuda"
    sync = stream_sync(frontend.device)
    log = _AnchorLog(system)
    chain = _ChainLog(system)
    step_s, marks, frames = [], [], []
    pend, i_prev = None, -1
    sync()
    t_carry = 0.0
    for i in range(len(images) + 1):
        t1 = time.perf_counter()
        pend_new = None
        if i < len(images):
            if cuda:
                marks.append([torch.cuda.Event(enable_timing=True) for _ in range(2)])
                marks[-1][0].record()
            pend_new = frontend.dispatch(first_idx + i, ts[i], *images[i])
            if cuda:
                marks[-1][1].record()
        if pend is not None:
            frames.append(frontend.complete(pend))
            st = system.step(frames[-1], q_wc[i_prev], t_wc[i_prev])
            _check_tracked(system, st, i_prev)
            log.record()
            chain.record()
        dt = time.perf_counter() - t1
        if pend is None:
            t_carry += dt
        else:
            step_s.append(dt + t_carry)
            t_carry = 0.0
        pend, i_prev = pend_new, i
    t1 = time.perf_counter()
    system.flush()
    sync()
    step_s[-1] += time.perf_counter() - t1
    if system.track_failed:
        raise RuntimeError("tracking failed at the final frame")
    log.record()
    fe_ms = np.array([a.elapsed_time(b) for a, b in marks]) if cuda else None
    return dict(step_s=np.array(step_s), n_anchors=np.array(log.n_anchors),
                frontend_ms=fe_ms, frames=frames, **chain.arrays())


def run(system, frames, q_wc, t_wc, device) -> dict:
    """Step every frame through `system` (then flush). Returns `step_s`,
    the host wall time of each step call in seconds, and `n_anchors`, the
    GMM anchors that survived the pose solve of each frame the tracker
    completed, and the chain counters per step (`chained_share`). Stats
    lag by the pipeline depth (None while it fills); the
    last step's time holds the flush. Raises on a tracking failure. On a
    CUDA device the clock stops after the caller's stream is
    synchronized (`stream_sync`)."""
    sync = stream_sync(device)
    log = _AnchorLog(system)
    chain = _ChainLog(system)
    step_s = []
    sync()
    for i, f in enumerate(frames):
        t1 = time.perf_counter()
        st = system.step(f, q_wc[i], t_wc[i])
        step_s.append(time.perf_counter() - t1)
        _check_tracked(system, st, i)
        log.record()
        chain.record()
    t1 = time.perf_counter()
    system.flush()
    sync()
    step_s[-1] += time.perf_counter() - t1
    if system.track_failed:
        raise RuntimeError("tracking failed at the final frame")
    log.record()
    return dict(step_s=np.array(step_s), n_anchors=np.array(log.n_anchors),
                **chain.arrays())


def timing_table(reset: bool = True) -> str:
    """The host timer registry's table (per-stage wall times: track/*,
    kf/*, loc/*), optionally cleared."""
    s = timing.print_table()
    if reset:
        timing.reset()
    return s


def pose_errors(frames, t_wc) -> np.ndarray:
    """Per-frame camera-centre error (m) of the tracked poses."""
    from ..geometry import se3

    q = torch.tensor(np.stack([f.q_cw for f in frames]), dtype=torch.float64)
    t = torch.tensor(np.stack([f.t_cw for f in frames]), dtype=torch.float64)
    return np.linalg.norm(se3.inverse(q, t)[1].numpy() - t_wc[: len(frames)], axis=1)
