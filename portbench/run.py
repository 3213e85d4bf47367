"""The port's benchmark: one cell of `BENCHMARK.json`, one run.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. The
cell names a configuration (`portbench/configs/<name>.json`) and a traffic
mix (`portbench/traffic/<name>.json`); the metrics are read by the
readers `portbench/end_to_end/<name>.py` and `portbench/metrics/<name>.py`
and `correct` by the checks `portbench/checks/<name>.py` the traffic file
lists, each found by its name.

A run: make the map, the trajectory and the frames from the seed
(`generate.py`), build the system of `gmmloc_tpu_torch` the configuration
describes, run the program's prewarm and the traffic's warm-up frames
(all of it set-up), then hand frames to the entry in a closed loop for
`--seconds` (the next frame when the call returns), flush, and stop. With
`--trace 1` the window's last `trace.TRACE_SECONDS` run under the
profiler and the line carries the per-layer metrics, the device's busy
and traced seconds and a breakdown; otherwise the end-to-end metrics. After the window the checks recompute a
sample of what the window produced with the plain reference
(`reference/`) on the CPU and `correct` says whether every number is
within its limit. The last line of stdout is the result's JSON; the last
lines of stderr the numbers compared and their limits.

A configuration with a `vocabulary` block gets the program's vocabulary
trained at set-up (the system then relocalizes after a tracking loss);
a traffic with camera dropouts (`dark_every`, `dark_frames`, `dark_from`)
has dark frames in the window, counted neither as tracked nor as failed,
and each dropout's time to re-anchor (`dropout_readings`).

Exits non-zero with no result when no CUDA card is there (or fewer than
the cell asks for), when the frames made run out inside the window, when
a window of a traffic with dropouts held fewer than its `min_dropouts`,
or when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# few threads per pool: the run is one process whose host work is Python
# and small arrays; the reference after the window takes every core again
THREADS = 2
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, str(THREADS))

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "gmmloc_tpu")


class BenchError(RuntimeError):
    pass


def set_cache_dirs() -> None:
    """Every compiler cache at a fixed directory inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_reader(kind: str, name: str):
    """The module `portbench/<kind>/<name>.py` (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, workload: str) -> dict:
    cells = [w for w in bench["workloads"] if w["name"] == workload]
    if not cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    return cells[0]


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics, or
    with `trace` its per-layer metrics."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload]) and m["moves"] in names]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the program's configuration
# ---------------------------------------------------------------------------


def port_config(config: dict):
    """The port's SystemConfig for this configuration: its defaults with
    the file's `port` settings ("section.field" or a top-level field),
    checked against the camera, frame and map numbers the file states."""
    from gmmloc_tpu_torch.config import euroc_v1_config

    cfg = euroc_v1_config()
    for key, val in config["port"].items():
        if "." in key:
            sec, field = key.split(".", 1)
            cfg = cfg.replace(**{sec: dataclasses.replace(getattr(cfg, sec), **{field: val})})
        else:
            cfg = cfg.replace(**{key: val})
    stated = [("camera", k, v) for k, v in config["camera"].items()]
    stated += [("frame", k, v) for k, v in config["frame"].items()]
    stated.append(("caps", "gmm_components_pad", config["map"]["pad_to"]))
    for sec, k, v in stated:
        got = getattr(getattr(cfg, sec), k)
        if got != v:
            raise BenchError(f"the program's {sec}.{k} is {got!r}, the configuration states {v!r}")
    return cfg


def generator_params(config: dict, traffic: dict) -> dict:
    p = dict(config["camera"], **config["frame"])
    p.update({k: v for k, v in traffic.items() if isinstance(v, (int, float))})
    return p


def reference_params(config: dict) -> dict:
    from .reference.camera import CameraParams

    c, f = config["camera"], config["frame"]
    return {"cam": CameraParams(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"],
                                c["bf"]),
            "frontend": dict(height=c["height"], width=c["width"], fx=c["fx"], bf=c["bf"],
                             num_features=f["num_features"], num_levels=f["num_levels"],
                             scale_factor=f["scale_factor"],
                             detect_distribution=f["detect_distribution"])}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


class Readings:
    """What the readers read."""

    def __init__(self):
        self.frames = 0                # handed in during the window and tracked
        self.trace_frames = 0          # of those, handed in while the trace ran
        self.attempted = 0             # handed in during the window
        self.window_s = 0.0
        self.setup_s = 0.0
        self.latency_s = []
        self.spans = {"step": [], "frontend": []}
        self.timers = {}
        self.anchors = []
        self.trace = None
        self.ate_rmse_m = None
        self.online = False
        self.config = None
        # a traffic with dropouts (dark frames): one time per dropout that
        # recovered, from the hand-in of its first lit frame to the return
        # of the call after which its first pose can be read
        self.recovery_s = []
        self.dropouts = 0              # dropouts whose last dark frame was handed in
        self.recoveries = 0            # the system's relocalizations in the window


class Loop:
    """Hands frames to the system in a closed loop and times each frame
    from its hand-in to the return of the call after which its pose can
    be read: the system has recorded it in the trajectory
    (`world.frame_infos`). A frame never tracked (a dark frame, a lost
    one) gets no record and no time."""

    def __init__(self, system, tracer, gt, images=None, frontend=None):
        self.system, self.tracer = system, tracer
        self.ts, self.q_wc, self.t_wc = gt
        self._frame_of = {t: i for i, t in enumerate(self.ts)}
        self._n_records = 0
        self.images, self.frontend = images, frontend
        self.pend = None              # the dispatched, not yet completed pair
        self.t_trace = None           # when the trace started
        self.t_in = {}                # frame index -> hand-in time (the window's frames)
        self.t_done = {}
        self.fe_s = {}                # frame index -> front-end host seconds
        self.recording = False
        self.readings = None
        self._dbg = system.tracker.dbg

    def _after_call(self, t):
        records = self.system.world.frame_infos[self._n_records:]
        self._n_records += len(records)
        for info in records:
            i = self._frame_of[info.timestamp]
            if i in self.t_in and i not in self.t_done:
                self.t_done[i] = t
        dbg = self.system.tracker.dbg
        if dbg is not self._dbg:
            self._dbg = dbg
            if self.recording:
                self.readings.anchors.append(dbg.get("n_anchors", 0))

    def _step(self, frame, q, t):
        t0 = time.perf_counter()
        with self.tracer.span("step"):
            self.system.step(frame, q, t)
        t1 = time.perf_counter()
        if self.recording:
            self.readings.spans["step"].append(t1 - t0)
        self._after_call(t1)

    def feed(self, i, frame):
        """Hand in feature frame i."""
        if self.recording:
            self.t_in[i] = time.perf_counter()
        self._step(frame, self.q_wc[i], self.t_wc[i])

    def feed_pair(self, i):
        """Hand in stereo pair i (None: no new pair), then complete and step
        the pair dispatched before it."""
        pend_new = None
        if i is not None:
            t0 = time.perf_counter()
            if self.recording:
                self.t_in[i] = t0
            with self.tracer.span("frontend.dispatch"):
                pend_new = self.frontend.dispatch(i, self.ts[i], *self.images[i])
            self.fe_s[i] = time.perf_counter() - t0
        if self.pend is not None:
            t0 = time.perf_counter()
            with self.tracer.span("frontend.complete"):
                frame = self.frontend.complete(self.pend)
            self.fe_s[frame.idx] = self.fe_s.get(frame.idx, 0.0) + time.perf_counter() - t0
            if frame.idx in self.t_in:
                self.readings.spans["frontend"].append(self.fe_s[frame.idx])
            self._step(frame, self.q_wc[frame.idx], self.t_wc[frame.idx])
        self.pend = pend_new

    def flush(self, sync):
        with self.tracer.span("flush"):
            self.system.flush()
            sync()
        self._after_call(time.perf_counter())


def make_inputs(config: dict, traffic: dict, seed: int, seconds: float, device):
    """(ground truth (ts, q_wc, t_wc) from the traffic's start frame, the
    map (means, covs), the frames or pairs, the warm-up count, the dark
    frames' mask or None)."""
    from . import generate

    n_warm = traffic["warmup_frames"]["online" if config["online"] else "offline"]
    n_total = n_warm + int(math.ceil(traffic["ceiling_fps"] * seconds)) + 1
    s0 = traffic["start_frame"]
    # the room (map and trajectory) from the traffic's own seed, so every
    # run follows the same path past the same walls; the landmarks and
    # their looks from the run's seed, or with `fixed_world` from the
    # room's too (every run then maps the same world, which sets how much
    # work a frame is); every noise from the run's seed
    room = traffic["room_seed"]
    ts, q_wc, t_wc = generate.room_trajectory(s0 + n_total, room)
    ts, q_wc, t_wc = ts[s0:], q_wc[s0:], t_wc[s0:]
    means, covs = generate.room_gmm(config["map"]["components"], room)
    world = generate.sample_world(means, covs, traffic["landmarks"],
                                  room if traffic.get("fixed_world") else seed)
    p = generator_params(config, traffic)
    dark = generate.dark_mask(n_total, n_warm, traffic)
    if traffic["input"] == "feature_frames":
        data = generate.feature_frames(world, q_wc, t_wc, seed, p, device, dark=dark)
    elif dark is not None:
        raise BenchError(f"dark frames are made for feature frames only, not "
                         f"{traffic['input']!r}")
    elif traffic["input"] == "stereo_images":
        contrast, size_m = generate.sprite_looks(len(world.landmarks), seed)
        data = generate.render_pairs(world, contrast, size_m, q_wc, t_wc, p, device)
    else:
        raise BenchError(f"unknown traffic input {traffic['input']!r}")
    return (ts, q_wc, t_wc), (means, covs), data, n_warm, dark


def make_vocabulary(spec: dict, means, covs, traffic: dict, device, log):
    """The program's vocabulary as a configuration's `vocabulary` block
    states it (k, depth, training set, seed), trained at set-up, and the
    descriptors it was trained on."""
    from gmmloc_tpu_torch.vocab.bow import Vocabulary

    from . import generate

    t0 = time.perf_counter()
    descs = generate.vocabulary_descs(spec["train"], means, covs, traffic["landmarks"],
                                      traffic["room_seed"])
    voc = Vocabulary.train(descs, k=spec["k"], depth=spec["depth"], seed=spec["seed"],
                           device=device)
    log(f"[setup] vocabulary {voc.n_words} words (k {spec['k']}, depth {spec['depth']}) from "
        f"{len(descs)} descriptors in {time.perf_counter() - t0:.2f}s")
    return voc, descs


def dropout_readings(traffic: dict, dark, n_warm: int, t_in: dict, t_done: dict,
                     failed_at_end: bool) -> dict:
    """What a window of a traffic with dropouts did, from the hand-in and
    pose times of its frames (frame index -> seconds): the lit frames
    handed in and tracked, the recovery time of each dropout that
    recovered, the dropouts counted (their last dark frame handed in),
    those that did not recover within `recover_within` lit frames (or
    before a fatal failure ended the window) and the lit frames not
    tracked outside each dropout's allowance of `recover_within` lit
    frames after it."""
    lit = [i for i in t_in if not dark[i]]
    tracked = [i for i in lit if i in t_done]
    within = traffic["recover_within"]
    excused, recovery_s, n_dropouts, unrecovered = set(), [], 0, 0
    first = n_warm + traffic["dark_from"]
    for start in range(first, len(dark), traffic["dark_every"]):
        back = start + traffic["dark_frames"]           # the first lit frame after it
        if back - 1 not in t_in:
            break
        n_dropouts += 1
        allowance = range(back, back + within)
        excused.update(allowance)
        pose = next((i for i in allowance if i in t_done), None)
        if pose is not None:
            recovery_s.append(t_done[pose] - t_in[back])
        elif failed_at_end or allowance[-1] in t_in:
            unrecovered += 1
    return dict(lit=lit, tracked=tracked, recovery_s=recovery_s, dropouts=n_dropouts,
                unrecovered=unrecovered,
                failed_frames=sum(1 for i in lit if i not in t_done and i not in excused))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: dict | None = None, bench: dict | None = None, prewarm: bool = True,
             control: bool | dict = False, warmup: int | None = None, before_window=None,
             log=None, kept_out: dict | None = None):
    """One run of a cell. Returns (result dict, the numbers compared
    {name: (value, limit)}, Readings). `overrides` changes the
    configuration's numbers for small CPU runs: {"frame": {...},
    "port": {...}}, and with "traffic" the traffic's. With `control` each
    check compares its control (the first of its `CONTROLS`, or {check:
    control name}) in the program's place, and `correct` is decided on
    those numbers. `warmup` replaces the traffic's warm-up count,
    `before_window()` runs just before the window (small CPU runs and the
    faults) and `kept_out`, when given, receives what the checks
    captured."""
    import torch

    from . import capture
    from .trace import TRACE_SECONDS, Tracer

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    torch.set_num_threads(THREADS)
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = find_cell(bench, workload)
    config = load_json(os.path.join(HERE, "configs", cell["config"] + ".json"))
    traffic = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    for sec, vals in (overrides or {}).items():
        if sec == "traffic":
            traffic.update(vals)
        else:
            config[sec] = dict(config[sec], **vals)
    dev = torch.device(device)
    seed = int(seed) % (1 << 63)

    from gmmloc_tpu_torch.eval.slice_run import stream_sync
    from gmmloc_tpu_torch.gmm import mixture
    from gmmloc_tpu_torch.pipeline import prewarm as prewarm_mod
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
    from gmmloc_tpu_torch.tracking.frame import make_frame
    from gmmloc_tpu_torch.utils import timing

    cfg = port_config(config)
    log(f"[setup] imports {time.perf_counter() - T_START:.2f}s")
    if warmup is not None:
        traffic["warmup_frames"] = {"online": warmup, "offline": warmup}
    (ts, q_wc, t_wc), (means, covs), data, n_warm, dark = make_inputs(config, traffic, seed,
                                                                     seconds, dev)
    log(f"[setup] inputs {time.perf_counter() - T_START:.2f}s")
    gmap = mixture.from_arrays(
        means, covs, dev, pad_to=cfg.caps.gmm_components_pad,
        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh, neighbor_cap=cfg.gmm.neighbor_cap,
        degenerate_eig_thresh=cfg.gmm.degenerate_eig_thresh,
        salient_eig_thresh=cfg.gmm.salient_eig_thresh)
    voc = voc_descs = None
    if "vocabulary" in config:
        voc, voc_descs = make_vocabulary(config["vocabulary"], means, covs, traffic, dev, log)
    # a check may follow the program from before the system is built
    # (`prepare`); every wrapper comes off once the window has closed
    patch = capture.Patch()
    checks = {name: load_reader("checks", name) for name in traffic["checks"]}
    prepared = {name: mod.prepare(patch, seed) for name, mod in checks.items()
                if hasattr(mod, "prepare")}
    system = GMMLocSystem(cfg, gmap, dev, vocabulary=voc)
    tracer = Tracer(trace)
    images = frontend = frames = None
    if traffic["input"] == "stereo_images":
        from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend

        images, frontend = data, ImageFrontend(cfg, device=dev)
    else:
        feat_cap = cfg.frame.feat_cap
        frames = [make_frame(i, ts[i], f["uv"], f["ur"], f["depth"], f["octave"], f["angle"],
                             f["desc"], feat_cap) for i, f in enumerate(data)]
    n_avail = len(data)
    log(f"[setup] map and system {time.perf_counter() - T_START:.2f}s")
    if prewarm:
        prewarm_mod.prewarm(cfg, system.cam, dev)
    log(f"[setup] prewarm {time.perf_counter() - T_START:.2f}s")
    sync = stream_sync(dev)
    tracer.warm()
    loop = Loop(system, tracer, (ts, q_wc, t_wc), images, frontend)
    r = loop.readings = Readings()
    r.online, r.config = bool(config["online"]), config

    def hand_in(i):
        if images is not None:
            loop.feed_pair(i)
        else:
            loop.feed(i, frames[i])

    # warm-up: the traffic's first frames, as set-up
    for i in range(n_warm):
        hand_in(i)
        if system.track_failed:
            patch.undo()
            raise BenchError(f"tracking failed at warm-up frame {i}")
    sync()

    # the window
    if before_window is not None:
        before_window()
    program = types.SimpleNamespace(frontend=frontend, images=images, gmm_means=means,
                                    gmm_covs=covs, config=config, system=system,
                                    vocabulary_descs=voc_descs, prepared=prepared)
    kept = {name: mod.install(patch, seed, program) for name, mod in checks.items()}
    timing.reset()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the harness's own objects (frames, images) out of the collector's
    # way for the window: a full collection would walk them at every pass
    gc.collect()
    gc.freeze()
    # the trace covers the window's last seconds (all of a short window)
    trace_at = max(0.0, seconds - TRACE_SECONDS) if trace else math.inf
    n_recoveries = len(system.recovery_frames)
    r.setup_s = time.perf_counter() - T_START
    log(f"[setup] warm-up {r.setup_s:.2f}s")
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    try:
        loop.recording = True
        t_w0 = time.perf_counter()
        i = n_warm
        while True:
            el = time.perf_counter() - t_w0
            if el >= seconds:
                break
            if el >= trace_at and loop.t_trace is None:
                tracer.start()
                loop.t_trace = time.perf_counter()
            if i >= n_avail:
                raise BenchError(f"the {n_avail} frames made ran out inside the window: the "
                                 f"traffic's ceiling of {traffic['ceiling_fps']} frames/s is "
                                 "too low")
            hand_in(i)
            i += 1
            if system.track_failed:
                break
        if images is not None and not system.track_failed:
            hand_in(None)                    # complete and step the last pair
        if not system.track_failed:
            loop.flush(sync)
        t_w1 = time.perf_counter()
        loop.recording = False
    finally:
        use1 = resource.getrusage(resource.RUSAGE_SELF)
        patch.undo()
        gc.unfreeze()
        r.trace = tracer.stop()
    log(f"[window] {t_w1 - t_w0:.2f}s, {i - n_warm} frames handed in; process cpu "
        f"{use1.ru_utime - use0.ru_utime:.2f}s user {use1.ru_stime - use0.ru_stime:.2f}s sys, "
        f"context switches {use1.ru_nvcsw - use0.ru_nvcsw} voluntary "
        f"{use1.ru_nivcsw - use0.ru_nivcsw} involuntary, load {os.getloadavg()[0]:.2f}; "
        f"trace read {time.perf_counter() - t_w1:.2f}s {tracer.read_s or ''}")
    r.window_s = t_w1 - t_w0
    with timing.REGISTRY.lock:
        r.timers = {k: (a.count, a.total) for k, a in timing.REGISTRY.accs.items()}
    kf, ba = r.timers.get("kf/process", (0, 0.0)), r.timers.get("loc/ba", (0, 0.0))
    log(f"[window] {kf[0]} keyframes made, {ba[0]} local BAs in {ba[1]:.2f}s")
    failed_at_end = bool(system.track_failed)
    attempted, tracked = list(loop.t_in), sorted(loop.t_done)
    if dark is not None:
        drop = dropout_readings(traffic, dark, n_warm, loop.t_in, loop.t_done, failed_at_end)
        attempted, tracked = drop["lit"], drop["tracked"]
        r.recovery_s, r.dropouts = drop["recovery_s"], drop["dropouts"]
        r.recoveries = len(system.recovery_frames) - n_recoveries
        log(f"[window] {r.dropouts} dropouts, {len(r.recovery_s)} recovered, recovery "
            f"{[round(x * 1e3, 1) for x in r.recovery_s]} ms; {len(attempted)} lit frames, "
            f"{len(tracked)} tracked; the system relocalized {r.recoveries} times")
    r.attempted = len(attempted)
    r.latency_s = [loop.t_done[k] - loop.t_in[k] for k in tracked]
    r.frames = len(r.latency_s)
    if loop.t_trace is not None:
        r.trace_frames = sum(1 for k in tracked if loop.t_in[k] >= loop.t_trace)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    system.stop()
    est_ts, _, est_t = system.export_trajectory()
    if len(est_ts) >= 3:
        from . import arith

        r.ate_rmse_m, _ = arith.ate_rmse(est_ts, est_t, ts, t_wc, with_scale=True)
    del system, frontend, gmap, frames, loop, voc, program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    if dark is not None and r.dropouts < traffic["min_dropouts"] and not failed_at_end:
        raise BenchError(f"the window held {r.dropouts} dropouts, fewer than the traffic's "
                         f"{traffic['min_dropouts']}")

    # correct: the sample of the window's answers against the reference
    # (with `control`, the control's answers in the program's place)
    t_ref = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or THREADS)
    ref = reference_params(config)
    compared, missing = {}, []
    for name, mod in checks.items():
        ctl = None
        if control:
            ctl = control.get(name) if isinstance(control, dict) else \
                (mod.CONTROLS[0] if mod.CONTROLS else None)
        got = mod.numbers(kept[name], ref, control=ctl)
        if not got:
            missing.append(name)
        for k, v in got.items():
            compared[k] = (v, mod.LIMITS[k])
    if kept_out is not None:
        kept_out.update(kept, ref=ref)
    if dark is None:
        compared["failed_frames"] = (r.attempted - r.frames, 0)
    else:
        compared["failed_frames"] = (drop["failed_frames"], 0)
        compared["unrecovered_dropouts"] = (drop["unrecovered"], 0)
    correct = (not missing and not failed_at_end
               and all(v <= lim for v, lim in compared.values()))
    if missing:
        log(f"checks that captured nothing in the window: {missing}")
    log(f"[reference] {time.perf_counter() - t_ref:.2f}s")

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        kind = "metrics" if trace else "end_to_end"
        val = load_reader(kind, m["name"]).read(r)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": r.attempted,
              "failed": r.attempted - r.frames, "metrics": metrics, "device": device_info}
    if r.trace is not None:
        device_info.update(busy_s=r.trace["busy_s"], window_s=r.trace["window_s"])
        result["breakdown"] = {"device_ops": r.trace["device_ops"],
                               "idle_gaps": r.trace["idle_gaps"]}
    if control:
        result["control"] = True
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result, compared, r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="compare the control (the checks' reference at a lower precision) in "
                         "the program's place: `correct` has to come out false")
    a = ap.parse_args(argv)
    set_cache_dirs()
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = find_cell(bench, a.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s); {n} found", file=sys.stderr)
        return 2
    try:
        result, compared, _ = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                                       bench=bench, control=a.control)
    except BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    for k, (v, lim) in compared.items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
