"""Benchmark: tracked frames per second through the port's real pipeline.

Twin of the JAX package's root `bench.py`, with its frozen headline
definition: `tracked_frames_per_sec_chip` is the mean end-to-end tracked
frames per second through `GMMLocSystem.step` on the synthetic feature
path (1280 features per frame, 752x480 geometry) in the production
operating configuration (`slice_run.production_config(True)`: online
mapping on the mapper thread, the device-chained pipeline at depth 4),
over 600 frames from frame 150 after 60 warm-up frames. `vs_baseline`
divides it by the reference's 20 Hz camera rate. Two more end-to-end
lines: offline at depth 4 (175 frames, 25 warm-up) and the image path
online (sprite-rendered stereo pairs through the ORB front end, 250
frames, 40 warm-up). The map is the seeded room fixture
(`room_fixture`, 3300 components), written once by the parent and read
by every child through `synthetic.GT_DIR` / `V1_GMM`, as the reference's
v1.gmm and EuRoC trajectory are read.

    python -m gmmloc_tpu_torch.eval.bench [--cpu] [--feat-cap N]
        [--online-frames 600 --online-warm 60] [--offline-frames 175
        --offline-warm 25] [--image-frames 250 --image-warm 40]

Each end-to-end line runs in a child process (`--child LINE`) that makes
or renders its frames off the clock, runs the port's `prewarm`, then
writes one `idx perf_counter res` line per completed frame, then after
`flush()` and `stop()` a `stats` line (launches of the four kernels over
the run and K3's distinct (N, M), the mapper drained, the max
camera-centre error, the share of measured frames whose pose solve kept
GMM anchors, what prewarm took) and `done`. The parent reads the window
statistics (`window_stats`, the definition of `bench.py`), then times
the components on the card: the guided match, the pose solve (K1), the
fused track step (K1, K2, K3), render and correspondence search on the
fixture map padded to 3328, and the local BA at the production window.

Prints the detail JSON (every key `bench.py` sets, with the percentile
keys, the per-line max error and anchored share, and the timer) on
stderr, then the headline JSON on stdout. A child that fails, stalls
(no frame for 180 s) or passes its time limit makes the bench exit
non-zero with the child's stderr tail and no headline. Runs on the card
unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

METRIC = "tracked_frames_per_sec_chip"
BASELINE_FPS = 20.0          # the reference's camera rate (cfg/v1.yaml fps: 20)
START = 150
N_COMPONENTS = 3300
N_LANDMARKS = 30000
IMG_LANDMARKS = 9000
STALL_S = 180.0
MIN_WINDOW = 20              # frames after warm-up a line needs for a value
# (frames, warm-up frames, time limit in seconds) per line, as bench.py
LINES = {"online": (600, 60, 1000.0), "offline": (175, 25, 700.0),
         "image": (250, 40, 700.0)}
KF_EVERY = 8.0               # keyframe cadence of the offline composite
# the keys of bench.py's detail line and headline (the detail also has the
# window percentiles of the online and offline lines)
DETAIL_KEYS = ("ba_schur_impl", "ba_solves_per_sec", "device", "e2e_config",
               "e2e_frames_completed", "e2e_offline_fps", "e2e_offline_frames", "e2e_status",
               "frame_core_ms", "fused_track_step_ms", "image_path_fps", "image_path_frames",
               "kernel_composite_fps", "local_ba_ms", "match_ms", "pose_opt_ms",
               "render_view_ms", "search_corr_ms")
PERCENTILE_KEYS = tuple(p + k for p in ("", "offline_")
                        for k in ("e2e_frame_ms_p50", "e2e_frame_ms_p95", "e2e_fps_p50"))
HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline")
TIMER_CUDA = ("CUDA events around back-to-back calls on the caller's stream, not "
              "queued: host reads inside a call stay in (eval/kernel_check.time_cuda)")
TIMER_CPU = "host clock around back-to-back calls (CPU)"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class BenchError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# window statistics (bench.py's definition)
# ---------------------------------------------------------------------------


def read_log(path: str):
    """(rows [(idx, perf_counter)], stats dict or None, done) of a child's
    log."""
    rows, stats, done = [], None, False
    with open(path) as f:
        for line in f:
            parts = line.split(None, 1)
            if not parts:
                continue
            if parts[0] == "done":
                done = True
            elif parts[0] == "stats":
                stats = json.loads(parts[1])
            else:
                idx, t = line.split()[:2]
                rows.append((int(idx), float(t)))
    return rows, stats, done


def window_stats(rows, warm: int):
    """fps over the frames after `warm` ((i1 - i0) / (t_b - t_a)) and
    p50 / p95 of the frame times there by nearest rank at
    round((n - 1) q), as `bench.py` computes them; None with fewer than
    warm + MIN_WINDOW rows."""
    if len(rows) < warm + MIN_WINDOW:
        return None
    (i0, t_a), (i1, t_b) = rows[warm], rows[-1]
    out = dict(fps=(i1 - i0) / max(t_b - t_a, 1e-9), frames=len(rows))
    dts = sorted(rows[k + 1][1] - rows[k][1] for k in range(warm, len(rows) - 1))
    if dts:
        p50 = dts[round((len(dts) - 1) * 0.50)]
        p95 = dts[round((len(dts) - 1) * 0.95)]
        out.update(e2e_frame_ms_p50=round(p50 * 1e3, 2),
                   e2e_frame_ms_p95=round(p95 * 1e3, 2),
                   e2e_fps_p50=round(1.0 / max(p50, 1e-9), 2))
    return out


# ---------------------------------------------------------------------------
# the child: one end-to-end line
# ---------------------------------------------------------------------------


def line_config(line: str, feat_cap=None):
    from . import slice_run

    widths = {} if feat_cap is None else dict(
        feat_cap=feat_cap, num_features=feat_cap - 16, local_map_cap=4 * feat_cap)
    cfg = slice_run.production_config(line != "offline", **widths)
    return slice_run.image_config(cfg) if line == "image" else cfg


def point_assets(fixture: str) -> None:
    """The port's asset names at the fixture written by `write_fixture`."""
    from . import synthetic

    gmm = os.path.join(fixture, "room.gmm")
    synthetic.GT_DIR = os.path.join(fixture, "gt")
    synthetic.V1_GMM = synthetic.V2_GMM = gmm


def write_fixture(fixture: str, n_traj: int) -> None:
    """The room fixture as the EuRoC assets: `room.gmm` and
    `gt/V1_01_easy.txt` with a trajectory of n_traj frames."""
    from . import room_fixture

    _, gt_path = room_fixture.write_room_fixture(fixture, n_components=N_COMPONENTS,
                                                 n_frames=n_traj)
    os.makedirs(os.path.join(fixture, "gt"), exist_ok=True)
    shutil.copy(gt_path, os.path.join(fixture, "gt", "V1_01_easy.txt"))


def kernel_wrappers() -> dict:
    from ..features import cuda_kernels, fast_kernels
    from ..solver import cuda_pose

    return {"K1": cuda_pose.optimize_pose, "K2": cuda_pose.optimize_pose_anchored,
            "K3": cuda_kernels.hamming_matrix, "K4": fast_kernels.fast_score_nms}


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
    kernel_wrappers()["K3"].shapes.clear()


def read_launches() -> dict:
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def read_k3_shapes() -> list:
    """The distinct (N, M) K3 was launched at since `reset_launches`."""
    return sorted(kernel_wrappers()["K3"].shapes)


def map_kwargs(cfg) -> dict:
    """`mixture.load`'s arguments for the lines' map."""
    return dict(pad_to=cfg.caps.gmm_components_pad,
                neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
                neighbor_cap=cfg.gmm.neighbor_cap)


def load_map(cfg, device):
    """The fixture's map (`point_assets`) on `device`, as the lines load it."""
    from ..gmm import mixture
    from . import synthetic

    return mixture.load(synthetic.V1_GMM, device, **map_kwargs(cfg))


def feature_frames(cfg, n_frames: int, make_sequence=None):
    """The feature lines' first n_frames frames from frame START
    (N_LANDMARKS landmarks, made up front) and the whole ground-truth
    trajectory: (frames, q_wc, t_wc), frame i at trajectory index
    START + i. The assets are the port's names (`point_assets`);
    `make_sequence` is the port's unless another is given."""
    from . import synthetic

    make_sequence = make_sequence or synthetic.make_sequence
    fe, ts, q_wc, t_wc = make_sequence(
        cfg, gt_path=f"{synthetic.GT_DIR}/V1_01_easy.txt", gmm_path=synthetic.V1_GMM,
        n_landmarks=N_LANDMARKS, seed=0, disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1)
    frames = [fe.make_frame(i, ts[START + i], q_wc[START + i], t_wc[START + i])
              for i in range(n_frames)]
    return frames, q_wc, t_wc


def run_child(line: str, fixture: str, n_frames: int, warm: int, out, device="cuda",
              feat_cap=None, prewarm: bool = True):
    """One end-to-end line, as bench.py's child: frames made (feature
    lines, 30000 landmarks) or rendered (image line, 9000 sprites) off the
    clock, the port's prewarm, then one `idx perf_counter res` row per
    completed frame written to `out`. Returns (stats, system, frames)."""
    from ..pipeline import prewarm as prewarm_mod
    from ..pipeline.system import GMMLocSystem
    from . import slice_run

    point_assets(fixture)
    cfg = line_config(line, feat_cap)
    gmap = load_map(cfg, device)
    if line == "image":
        from ..pipeline.frontend import ImageFrontend
        from .evaluate_image import render_pairs

        _, imgs, ts, q_wc, t_wc = render_pairs(cfg, "V1_01_easy", 0, n_frames, START,
                                               n_landmarks=IMG_LANDMARKS)
        frontend = ImageFrontend(cfg, device=device)
    else:
        frames, q_wc, t_wc = feature_frames(cfg, n_frames)
    system = GMMLocSystem(cfg, gmap, device)
    stats = dict(line=line, device=str(device), feat_cap=cfg.frame.feat_cap,
                 frames_asked=n_frames, warm=warm)
    t0 = time.perf_counter()
    if prewarm:
        pw = {}
        stats["prewarm_calls"] = prewarm_mod.prewarm(cfg, system.cam, device, stats=pw)
        stats["prewarm_ba_graph_captures"] = pw.get("ba_graph_captures", {})
    slice_run.stream_sync(device)()
    stats["prewarm_s"] = time.perf_counter() - t0 if prewarm else None
    anchors = slice_run._AnchorLog(system)
    reset_launches()
    t_loop = time.perf_counter()
    done = []
    if line == "image":
        frames = []
        pend, i_prev = None, -1
        for i in range(n_frames + 1):
            pend_new = None
            if i < n_frames:
                fi = START + i
                pend_new = frontend.dispatch(i, ts[fi], *imgs[i])
            if pend is not None:
                frames.append(frontend.complete(pend))
                fi = START + i_prev
                system.step(frames[-1], q_wc[fi], t_wc[fi])
                if system.track_failed:
                    break
                done.append(time.perf_counter())
                out.write("%d %.6f 1\n" % (i_prev, done[-1]))
                anchors.record()
            pend, i_prev = pend_new, i
    else:
        for i, f in enumerate(frames):
            fi = START + i
            st = system.step(f, q_wc[fi], t_wc[fi])
            if system.track_failed:
                break
            done.append(time.perf_counter())
            out.write("%d %.6f %d\n" % (i, done[-1], int(st.res) if st is not None else 1))
            anchors.record()
    out.flush()
    system.flush()
    system.stop()
    anchors.record()
    launches, k3_shapes = read_launches(), read_k3_shapes()
    mapper = system.online
    n_done = len(done)
    errs = slice_run.pose_errors(frames[:n_done], t_wc[START:START + n_done]) \
        if n_done else np.zeros(0)
    n_meas = n_done - warm
    meas = np.array(anchors.n_anchors[-n_meas:]) if n_meas > 0 else np.zeros(0)
    stats.update(
        frames=n_done, track_failed=bool(system.track_failed), launches=launches,
        k3_shapes=k3_shapes,
        first_frame_ms=(done[0] - t_loop) * 1e3 if done else None,
        drained=mapper is None or (mapper.count_queue() == 0 and mapper._thread is None),
        online=mapper is not None, depth=system._depth,
        max_err_m=float(errs.max()) if n_done else None,
        anchored_share=float((meas > 0).mean()) if len(meas) else None,
        keyframes=system.world.n_keyframes(), ba_solves=len(system.localizer.ba_stats))
    return stats, system, frames


def child_main(a) -> int:
    device = "cpu" if a.cpu else "cuda"
    with open(a.log, "w", buffering=1) as out:
        stats, _, _ = run_child(a.child, a.fixture, a.frames, a.warm, out, device,
                                a.feat_cap, prewarm=not a.no_prewarm)
        out.write("stats " + json.dumps(stats) + "\n")
        out.write("done\n")
    return 0


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def child_command(line: str, log_path: str, n_frames: int, warm: int, a) -> list:
    cmd = [sys.executable, "-u", "-m", "gmmloc_tpu_torch.eval.bench", "--child", line,
           "--log", log_path, "--frames", str(n_frames), "--warm", str(warm),
           "--fixture", a.fixture]
    if a.cpu:
        cmd.append("--cpu")
    if a.feat_cap is not None:
        cmd += ["--feat-cap", str(a.feat_cap)]
    return cmd


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def run_line(line: str, n_frames: int, warm: int, timeout_s: float, a, log=print) -> dict:
    """Run one line's child and read its window. Raises BenchError when
    the child fails, stalls, passes its time limit, or leaves too few
    frames for a window."""
    tmp = tempfile.mkdtemp(prefix=f"bench_{line}_")
    log_path = os.path.join(tmp, "frames.log")
    err_path = os.path.join(tmp, "stderr.log")
    log(f"[bench] {line}: {n_frames} frames, {warm} warm-up, child started")
    t0 = time.time()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(child_command(line, log_path, n_frames, warm, a), cwd=ROOT,
                                stdout=err, stderr=subprocess.STDOUT)
    last_n, last_progress, why = -1, time.time(), None
    try:
        while proc.poll() is None:
            time.sleep(0.5)
            try:
                with open(log_path) as f:
                    n = sum(1 for _ in f)
            except OSError:
                n = 0
            if n > last_n:
                last_n, last_progress = n, time.time()
            if last_n > 0 and time.time() - last_progress > STALL_S:
                why = f"no frame for {STALL_S:.0f} s"
            elif time.time() - t0 > timeout_s:
                why = f"over its time limit of {timeout_s:.0f} s"
            if why:
                break
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    try:
        rows, stats, done = read_log(log_path)
    except (OSError, ValueError):
        rows, stats, done = [], None, False
    if why is None and proc.returncode != 0:
        why = f"exited with code {proc.returncode}"
    if why is None and not (done and stats):
        why = "ended without its stats"
    win = window_stats(rows, warm)
    if why is None and (win is None or stats["track_failed"]):
        why = (f"tracking failed after {len(rows)} frames" if stats["track_failed"]
               else f"{len(rows)} frames, too few for a window after {warm}")
    if why is not None:
        tail = _tail(err_path)
        shutil.rmtree(tmp, ignore_errors=True)
        raise BenchError(f"[bench] {line} child {why}; its output ends:\n{tail}")
    shutil.rmtree(tmp, ignore_errors=True)
    out = dict(win, **stats, seconds=time.time() - t0)
    log(f"[bench] {line}: " + json.dumps(out))
    return out


def card_name(device) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def _timer(device):
    """time(fn, reps, warmup) -> ms per call."""
    if device.type == "cuda":
        from . import kernel_check

        return lambda fn, reps, warmup: kernel_check.time_cuda(fn, reps=reps, warmup=warmup)

    def host(fn, reps, warmup):
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    return host


def components(a, device, log=print) -> dict:
    """bench.py's component times on its inputs (np.random.default_rng(0)),
    on `device`; F = feat_cap (1280 at full width), the BA window's points
    scaled with it."""
    import torch

    from ..config import euroc_v1_config
    from ..entry import entry
    from ..features import matching
    from ..geometry import camera as cam_mod
    from ..gmm import mixture, render
    from ..solver import cuda_pose, local_ba

    cfg = euroc_v1_config()
    cam = cam_mod.CameraParams.from_config(cfg.camera)
    rng = np.random.default_rng(0)
    F = a.feat_cap or cfg.frame.feat_cap
    cuda = device.type == "cuda"
    time_ms = _timer(device)
    t = lambda v, dt=torch.float32: torch.as_tensor(np.asarray(v), dtype=dt, device=device)  # noqa: E731
    detail = {}

    # ---- per-frame tracking work
    uv = rng.uniform([40, 40], [cam.width - 40, cam.height - 40], (F, 2))
    z = rng.uniform(1.0, 12.0, F)
    x_w = np.stack([(uv[:, 0] - cam.cx) / cam.fx * z, (uv[:, 1] - cam.cy) / cam.fy * z, z], -1)
    obs = np.concatenate([uv, (uv[:, 0] - cam.bf / z)[:, None]], -1).astype(np.float32)
    desc = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    octv = rng.integers(0, 8, F).astype(np.int32)
    i64, u8, b = torch.int64, torch.uint8, torch.bool
    args_match = (t(uv), t(obs[:, 2]), t(desc, u8), t(octv, i64), t(np.zeros(F)),
                  t(np.ones(F), b), t(np.full(F, 15.0)), t(octv - 1, i64), t(octv + 1, i64),
                  t(uv), t(obs[:, 2]), t(desc, u8), t(octv, i64), t(np.zeros(F)),
                  t(np.ones(F), b), t(np.zeros(F), b))
    reps = (lambda n: n) if cuda else (lambda n: max(1, n // 10))
    log("[bench] components: match")
    detail["match_ms"] = time_ms(lambda: matching.search_by_projection(*args_match),
                                 reps(20), 2)
    q0 = np.array([1.0, 0.001, -0.002, 0.0005])
    q0 = q0 / np.linalg.norm(q0)
    args_pose = (t(q0), t([0.01, -0.02, 0.005]), t(x_w), t(obs), t(np.ones(F), b),
                 t(np.ones(F)), t(np.ones(F), b))
    log("[bench] components: pose_opt (K1)")
    detail["pose_opt_ms"] = time_ms(lambda: cuda_pose.optimize_pose(cam, *args_pose),
                                    reps(20), 2)
    log("[bench] components: fused track step (K1, K2, K3)")
    fused_fn, fused_args = entry(device)
    t_frame = time_ms(lambda: fused_fn(*fused_args), reps(20), 2)
    detail["fused_track_step_ms"] = t_frame

    # ---- per-keyframe GMM association on the fixture map padded to 3328
    log("[bench] components: render_view, search_correspondence")
    gmap = mixture.load(os.path.join(a.fixture, "room.gmm"), device, pad_to=3328)
    qr, tr = t([1.0, 0, 0, 0]), t(np.zeros(3))
    t_render = time_ms(lambda: render.render_view(gmap, cam, qr, tr), reps(10), 2)
    r2d = render.render_view(gmap, cam, qr, tr)
    feat_uv, ones = t(uv), t(np.ones(F), b)
    t_assoc = time_ms(lambda: render.search_correspondence(r2d, feat_uv, ones),
                      reps(10), 2)
    detail["render_view_ms"] = t_render
    detail["search_corr_ms"] = t_assoc

    # ---- per-keyframe local BA at the production window
    L, C, P, MO = 16, 48, 8192 * F // 1280, cfg.caps.ba_obs_per_point
    log(f"[bench] components: local BA L={L} C={C} P={P} MO={MO}")
    cam_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (C, 1))
    cam_t = np.zeros((C, 3), np.float32)
    cam_t[:, 0] = np.arange(C) * 0.05
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(3, 9, P)],
                   -1).astype(np.float32)
    obs_cam = rng.integers(0, C, (P, MO))
    pc = pts[:, None, :] + cam_t[obs_cam]
    uvr = np.stack([cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
                    cam.fy * pc[..., 1] / pc[..., 2] + cam.cy,
                    cam.fx * pc[..., 0] / pc[..., 2] + cam.cx - cam.bf / pc[..., 2]],
                   -1).astype(np.float32)
    # observation noise and a perturbed start: a noise-free window
    # converges in 1-2 LM iterations and under-reports the solve
    uvr += rng.normal(0, 0.5, uvr.shape).astype(np.float32)
    pts_init = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    prob = local_ba.BAProblem(
        cam_q=t(cam_q), cam_t=t(cam_t), cam_valid=t(np.ones(C), b), pts=t(pts_init),
        pt_valid=t(np.ones(P), b), obs_cam=t(obs_cam, i64), obs_uvr=t(uvr),
        obs_stereo=t(np.ones((P, MO)), b), obs_sigma2_inv=t(np.ones((P, MO))),
        obs_valid=t(np.ones((P, MO)), b),
        str_type=t(np.full(P, local_ba.STR_DEG), i64),
        str_normal=t(np.tile([0.0, 0, 1], (P, 1))), str_mean=t(pts),
        str_sqrt_info=t(np.tile(np.eye(3), (P, 1, 1))), prior_q=t(cam_q[0]),
        prior_t=t(cam_t[0]), has_prior=torch.tensor(True, device=device))
    schur = cfg.loc.ba_schur_impl
    t_ba = time_ms(lambda: local_ba.solve_local_ba(cam, prob, n_free=L, schur_impl=schur),
                   reps(3), 1)
    detail["local_ba_ms"] = t_ba
    detail["ba_solves_per_sec"] = 1e3 / t_ba
    detail["ba_schur_impl"] = schur
    # offline protocol: a keyframe (association + BA) inline every ~8 frames
    detail["frame_core_ms"] = t_frame
    detail["kernel_composite_fps"] = 1e3 / (t_frame + (t_render + t_assoc + t_ba) / KF_EVERY)
    detail["timer"] = TIMER_CUDA if cuda else TIMER_CPU
    return detail


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--feat-cap", type=int, default=None,
                    help="features per frame (default: the configuration's 1280)")
    for line, (n, warm, _) in LINES.items():
        ap.add_argument(f"--{line}-frames", type=int, default=n)
        ap.add_argument(f"--{line}-warm", type=int, default=warm)
    ap.add_argument("--fixture", default=os.path.join(ROOT, "build", "gmmloc_tpu_torch",
                                                      "bench"))
    # one end-to-end line (the parent starts these)
    ap.add_argument("--child", choices=tuple(LINES), default=None, help=argparse.SUPPRESS)
    ap.add_argument("--log", help=argparse.SUPPRESS)
    ap.add_argument("--frames", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--warm", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--no-prewarm", action="store_true", help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    """The bench. Prints the detail JSON on stderr and the headline on
    stdout and returns {headline, detail, lines, component_launches}; on
    a failed child prints the reason and returns None (no headline)."""
    a = build_parser().parse_args(argv)
    if a.child:
        return child_main(a)
    import torch

    device = torch.device("cpu" if a.cpu else "cuda")
    log = lambda *x: print(*x, file=sys.stderr, flush=True)  # noqa: E731
    frames = {line: (getattr(a, f"{line}_frames"), getattr(a, f"{line}_warm"), lim)
              for line, (_, _, lim) in LINES.items()}
    t0 = time.perf_counter()
    write_fixture(a.fixture, START + max(n for n, _, _ in frames.values()) + 50)
    if device.type == "cuda":
        from ..utils import cuda_build

        cuda_build.load()      # built once here; the children load it
    log(f"[bench] fixture and build {time.perf_counter() - t0:.1f}s")
    lines = {}
    try:
        for line, (n, warm, lim) in frames.items():
            lines[line] = run_line(line, n, warm, lim, a, log=log)
    except BenchError as e:
        log(str(e))
        return None

    from ..pipeline.system import set_numerics

    set_numerics()
    reset_launches()
    detail = components(a, device, log=log)
    comp_launches = read_launches()
    on, off, img = lines["online"], lines["offline"], lines["image"]
    detail["device"] = card_name(device)
    detail["e2e_frames_completed"] = on["frames"]
    detail.update({k: on[k] for k in on if k.startswith("e2e_")})
    detail["e2e_config"] = "online threaded mapping + pipeline_depth=4"
    detail["image_path_fps"] = round(img["fps"], 2)
    detail["image_path_frames"] = img["frames"]
    detail["e2e_offline_fps"] = round(off["fps"], 2)
    detail["e2e_offline_frames"] = off["frames"]
    detail.update({"offline_" + k: off[k] for k in off if k.startswith("e2e_")})
    for name, key in (("e2e", on), ("e2e_offline", off), ("image_path", img)):
        detail[f"{name}_max_err_m"] = key["max_err_m"]
        detail[f"{name}_anchored_share"] = key["anchored_share"]
    detail["e2e_status"] = "ok"
    fps = on["fps"]
    headline = {"metric": METRIC, "value": round(fps, 2), "unit": "fps",
                "vs_baseline": round(fps / BASELINE_FPS, 2)}
    print(json.dumps(detail), file=sys.stderr, flush=True)
    print(json.dumps(headline), flush=True)
    return dict(headline=headline, detail=detail, lines=lines,
                component_launches=comp_launches)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
