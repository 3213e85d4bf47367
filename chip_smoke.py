#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`gmmloc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

  1. the card: name and power limit (nvidia-smi);
  2. build: one nvcc per `gmmloc_tpu_torch/csrc/*.cu`, all started
     together, linked into `build/gmmloc_tpu_torch/`; prints the seconds;
  3. the image inputs: the seeded V1-scale room fixture and 170 rendered
     752x480 uint8 stereo pairs of a 9000-landmark sprite world (off the
     clock);
  4. kernels against their plain PyTorch versions on the card, at the
     main paths' shapes, with CUDA-event times, bounds and, where one
     PyTorch call computes the same function, its time: K1/K2 (staged
     pose solves, F=1280 and F=300, seeds 0 and 3) within the pose gates,
     bit-identical over three launches, and their step sweep (device ms
     over GN steps and over features: the per-step latency and the
     per-feature cost); K3 (Hamming matrix,
     1280x1280, 4096x1280, the stereo 1200x1200, a triangulation search
     1280 x 10*1280 and a fusion job 2048x1280) exact; K4 (FAST +
     NMS) exact on a (480,752) and a (96,130) random-integer image, on
     the stacked stereo atlas of the first rendered pair (4420x752) and
     on the densest-surviving image of the atlas's size, with the share
     of pixels that survive its exact reject; no kernel time may read
     under its bound;
  5. the feature path: `GMMLocSystem.step` over synthetic feature frames
     of the fixture (1280 features/frame, 3300 GMM components padded to
     5120, 30000 landmarks), 25 warm-up + 200 measured frames; checks no
     tracking failure, max camera-centre error < 5 cm, > 1 keyframe, >= 1
     local BA, K1, K2 and K3 each launched, and GMM anchors kept on at
     least 90% of the measured frames; prints tracked frames/s and p50/p95
     frame times;
  6. the image path: the rendered pairs through `ImageFrontend` (one
     front-end pass per frame, double-buffered) into `GMMLocSystem.step`
     at full width (752x480, 1200 features, 8 levels, scale 1.2,
     feat_cap 1280), 20 warm-up + 150 measured frames; checks no lost
     frame, max camera-centre error under the gate below, K4 launched at
     least once per frame, K1-K4 each launched, and GMM anchors kept on at
     least 90% of the measured frames; prints tracked frames/s, p50/p95
     frame times, the front end's ms per frame between CUDA events,
     keyframes and the launches;
  7. [production]: the JAX package's production configuration
     (`slice_run.production_config`: its defaults -- the device-world
     mirror, fused triangulation, device BA assembly, packed IO -- with
     the device-chained pipeline at depth 4), the three runs of its
     `bench.py`: the feature path offline and online (25 warm-up + 200
     measured frames each, the frames of phase 5) and the image path
     online (the rendered pairs of phase 6). Checks what phases 5 and 6
     check (the image path also K4) after `stop()` drained the mapper,
     at the error gate the JAX package sets its own depth-4 and online
     runs (8 cm, PROD_MAX_ERR_M), and that depth 4 was kept before and
     after the run, at least half the measured frames ran chained and
     the mirror synced; prints
     frames/s, p50/p95, the chain's primes and
     rewinds, BA solves and LM iterations and the host timers
     (`track/chain_*`, `loc/*_sync`).

  8. [reloc]: relocalization on the production feature configuration
     offline at depth 4, with a vocabulary trained off the clock from the
     fixture's landmark descriptors (`desc[::4]`, k=10, depth 3, seed 0,
     as the JAX tests train it; its descent on the card equal to the CPU
     descent word for word). Two runs (`eval/reloc_run.py`): a blackout
     (frames 125-130 of a 25 + 200 frame run with every detection
     dropped) and a kidnap (90 frames mapped, 5 dark frames while the
     camera is carried back to frame 10, then 40 frames from there). Each
     must go LOST and recover with no fatal failure, keep the camera
     centre within 10 cm after the recovery, and launch K1 and K3 inside
     `relocalize`; prints the lost frames, the recovery frames, the
     candidates tried and the ms per attempt.
  9. [loop]: one lap of the room (440 frames; the ellipse closes after
     about 380) on the same configuration with `enable_loop_closing`. If
     the JAX package closes a loop on the lap (`tools/torch_loop_reference.py`,
     CPU, small width) the card run must close one too; max camera-centre
     error under the larger of 8 cm and the JAX run's + 1 cm; the mirror's
     pose and point tables equal to the host's after the sync that follows
     each closure; each closure's pose graph solved twice more on the card
     with the same result, bit for bit. Then the JAX loop-closing test's
     revisit world (`reloc_run.revisit_scenario`) closed on the card: K3
     in `verify`, equal to the CPU's closure within 1e-4 m, the mirror
     equal after the sync, the graph bit-equal when solved again. Prints
     the closures, the ms per `close` and the pose graph's ms.
 10. [disk]: the disk-driven image path (`eval/disk_run.py`). Phase 3's
     pairs written as an EuRoC ASL tree of 8-bit PNGs (all five row
     filters) beside the fixture's ground truth; the native decode ring
     (the port's zlib PNG decoder, built with g++ from
     `gmmloc_tpu_torch/native/png_ring.cpp`) alone, every
     pair bit-equal to the written pixels, pairs/s; `GMMLocSystem.run`
     over the ring and the double-buffered front end with phase 6's
     configuration and checks, its trajectory equal to phase 6's (poses
     bit for bit; where not, two in-memory runs show how far the card's
     own runs part, and the disk run is held to that), frames/s, p50/p95
     and the host's wait on the ring (`data/take`); a stop requested from
     `on_frame` at frame 60 (no frame stepped after it); the run's world
     saved, loaded into a fresh system and mirrored on the card (every
     mirror table equal to the host's and to the original world's
     mirror, the trajectory equal, the HTML viewer holding every
     keyframe); the first 40 pairs with the "octree" keypoint
     distribution; the `Rectifier` on the card from a synthetic
     FileStorage calibration at 752x480 (maps equal to the CPU's, remap
     within 1e-3 of the CPU's, equalisation exact, ms per pair). Then no
     PIL, PyYAML or matplotlib may have been imported.
 11. [multi]: the multi-device paths (`gmmloc_tpu_torch/entry.py`,
     `parallel/`) at the production shapes of the JAX package's
     `dryrun_multichip` (association K=3328, F=1280; local BA L=16, C=48,
     P=8192, MO=8, 5/5/40, "flat" at bfloat16), and a second BA window,
     the dry run's with 0.3 px of noise on the observations and 1 cm on
     the points (`entry.noisy_window`: the dry run's starts at the truth
     and barely moves, so only a moving solve shows a sum left out of the
     reduction): (a) `dryrun_multichip(1)` and the noisy window on a real
     NCCL group of one rank, the sharded association equal to the
     unsharded port and both sharded BAs bit-equal to the unsharded
     solves; (b) both over two gloo ranks on the one card, association
     equal, each BA's points, camera positions and quaternions within
     1e-4 of the unsharded solve's, its cost within 1e-5 relatively and
     its LM iterations the same (`entry.ba_gap_fault`); (c)
     `eval/sweep.py --spawn 2`, one 40-frame feature-path job per rank,
     merged on rank 0; (d) `entry()` with K1, K2 and K3 launched. Prints
     ms per LM iteration sharded (eager) against unsharded (replayed),
     the collectives' ms, bytes and calls per iteration and the
     association's ms. Each rank is a process with its own time limit.
 12. [eval]: the entry layer (`gmmloc_tpu_torch/eval/`) through the
     `main` a user calls, on a room fixture written as the EuRoC assets
     (3300 components; `synthetic.GT_DIR`/`V1_GMM` pointed at it), each
     step logging `[eval] <step> start` first: (a) `evaluate.main`, the
     reference's evaluate_euroc.sh protocol, 2 runs x 200 frames from
     frame 150 at the JAX defaults with `--damping 0.9 --reloc 1` (one
     vocabulary, trained once), then one run `--online --pace 20` over
     120 frames: every run complete with no lost frame, its TUM file one
     row per frame at the ground truth's timestamps, the max camera-centre
     error under PROD_MAX_ERR_M, no BA window cap bound, summary.json with
     the JAX tool's keys, K1-K3 launched; (b) `evaluate_image.main`, one
     run of 120 rendered 752x480 pairs (1200 features, 8 levels) under
     the image gate, K4 at least once per frame and K1-K4 launched; (c)
     `diagnose.main` over 100 frames: the JAX header, a row per frame,
     the tracker's diagnostics on every tracked frame; (d) `view_map.main`
     from a checkpoint of (a)'s last world: every keyframe in the HTML,
     no PIL/PyYAML/matplotlib imported; (e) `stress.main` at 10x the
     components (33000, padded to 33024, no neighbour table): the map's
     device bytes, render and association timed with CUDA events on one
     device and over two gloo ranks on the card (equal to one device),
     then `reloc_under_stress(10)` (the neighbour graph built on the
     host, its seconds printed): lost; recovered with the median error
     after the recovery under RELOC_MAX_ERR_M, or, where the room
     fixture leaves the prior-map consistency share under the
     relocalizer's threshold, every candidate the pose solve found turned
     down by that check alone (`_reloc_gate`); and the same scenario on
     the 1x map: lost, recovered, under RELOC_MAX_ERR_M. Prints frames/s,
     p50/p95 of the host time per step and the rmse per run, the ms of
     render and association.
 13. [bench]: the port's bench (`eval/bench.py`, the twin of the JAX
     package's `bench.py`) through its `main`: each end-to-end line in
     its child process (online 160 frames / 60 warm-up, offline 100 / 25,
     image 90 / 40, all from frame 150 of the bench's own room fixture,
     each child after the port's `prewarm`), then the components at full
     width in this process. Checks the headline line has `bench.py`'s
     keys and the detail line every key `bench.py` sets plus the window
     percentiles, `e2e_status` "ok", each child's mapper drained, a graph
     captured at every BA tier of each child's prewarm, K1-K3 launched on
     every line and K4 at least once per frame of the image line, and
     K1-K3 by the components. Each step logs `[bench] ...` before it
     runs.
 14. K3 exact against its plain version at every (N, M) the paths
     launched it at (`hamming_matrix.shapes`; the bench's children
     report theirs in their `stats` line).

Launch counts are set to 0 just before each path and read just after
it; launches made to compare a kernel with its plain version do not
count. Kernel times are device time: the launches are queued behind a
spin kernel so the host's enqueue is off the clock
(`kernel_check.time_cuda(queued=True)`), and K3 and K4 write into a ring
of outputs larger than the L2 cache (`ms`; `ms_l2` is the time into one
re-used buffer). The line before the last is the
kernel table as JSON; the last line is `{"ok": true, "device": {...}}`. Without a CUDA device, or
outside the repository, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

WARMUP = 25
MEASURED = 200
N_COMPONENTS = 3300
N_LANDMARKS = 30000
MAX_ERR_M = 0.05
# of the measured frames, K2 keeps > 0 GMM anchors. Online too: the JAX
# package keeps them on every measured frame of its online runs
# (tools/torch_production_reference.py)
MIN_ANCHORED_SHARE = 0.9

IMG_WARMUP = 20
IMG_MEASURED = 150
IMG_LANDMARKS = 9000
# the JAX package's own max camera-centre error on the same 170 image
# frames, from a CPU run of tools/torch_image_reference.py; the image
# path's gate is the larger of MAX_ERR_M and this + 1 cm
JAX_IMG_MAX_ERR_M = 0.029363626255594893
# the production runs' gate: the JAX package's own for its depth-4 and
# online runs (tests/test_chained_pipeline.py:72, tests/test_online_mode.py:46).
# On the room fixture its production configuration is less accurate than
# the slice: 7.22 against 4.04 cm max over 120 frames at feat_cap 256, the
# port 7.16 against 4.17 (tools/torch_production_reference.py, on the CPU).
# The [eval] protocol runs at depth 1 (200 frames from frame 150) are held
# to it too: on those frames the JAX package's own max error is 6.95 / 6.62
# cm (runs 0 / 1, feat_cap 256), the port's 6.63 / 6.67
# (tests/test_torch_eval_protocol.py, on the CPU)
PROD_MAX_ERR_M = 0.08

# [reloc]: the runs of the JAX package's tests/test_relocalize.py on the
# fixture, and their error gate
RELOC_DARK = range(125, 131)
KIDNAP = dict(start=0, mapped=90, black=5, back=10, after=40)
RELOC_MAX_ERR_M = 0.10
# [loop]: one lap, and the JAX package's result on it from a CPU run of
# tools/torch_loop_reference.py (feat_cap 256, 400 components, 4000
# landmarks): loops closed and max camera-centre error
LOOP_FRAMES = 440
JAX_LOOP_CLOSURES = 0
JAX_LOOP_MAX_ERR_M = 0.08382604801750247

# [disk]: on_frame requests a stop when this frame's stat arrives; the
# octree run takes this many pairs from the tree
DISK_STOP_FRAME = 60
DISK_OCTREE_FRAMES = 40
# [multi]: frames of each sweep job
SWEEP_FRAMES = 40
# [eval]: the protocol's runs and frames (from frame EVAL_START of the
# fixture's trajectory, the JAX tool's default start), the online run's,
# the image-level run's (from frame 0), the diagnosis' frames and the
# stress run's factor on the fixture's components
EVAL_RUNS = 2
EVAL_FRAMES = 200
EVAL_START = 150
EVAL_ONLINE_FRAMES = 120
EVAL_IMG_FRAMES = 120
DIAG_FRAMES = 100
STRESS_FACTOR = 10
# [bench]: (frames, warm-up frames) of each end-to-end line
BENCH_LINES = dict(online=(160, 60), offline=(100, 25), image=(90, 40))


def k3_shapes():
    """K3's shapes on the paths: frame x local map (1280^2), the widened
    motion match (4096x1280), stereo (1200^2), a triangulation search of
    one keyframe against its TRI_NEIGHBORS neighbours stacked (1280 x
    10*1280) and a full device fusion job (FUSE_CHUNK landmarks x 1280)."""
    from gmmloc_tpu_torch.mapping.localization import FUSE_CHUNK, TRI_NEIGHBORS

    return ((1280, 1280), (4096, 1280), (1200, 1200), (1280, TRI_NEIGHBORS * 1280),
            (FUSE_CHUNK, 1280))


KERNELS = {
    "K1": ("optimize_pose", "gmmloc_tpu_torch/csrc/pose_solver.cu",
           "gmmloc_tpu/solver/pallas_pose.py:406"),
    "K2": ("optimize_pose_anchored", "gmmloc_tpu_torch/csrc/pose_solver.cu",
           "gmmloc_tpu/solver/pallas_pose.py:460"),
    "K3": ("hamming_matrix", "gmmloc_tpu_torch/csrc/hamming.cu",
           "gmmloc_tpu/features/pallas_kernels.py:44"),
    "K4": ("fast_score_nms", "gmmloc_tpu_torch/csrc/fast_nms.cu",
           "gmmloc_tpu/features/pallas_kernels.py:155"),
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def wrappers():
    """The launch-counting wrapper of each kernel."""
    from gmmloc_tpu_torch.features import cuda_kernels, fast_kernels
    from gmmloc_tpu_torch.solver import cuda_pose

    return {"K1": cuda_pose.optimize_pose, "K2": cuda_pose.optimize_pose_anchored,
            "K3": cuda_kernels.hamming_matrix, "K4": fast_kernels.fast_score_nms}


# every (N, M) the paths launched K3 at, checked exact after the paths
PATH_K3_SHAPES = set()


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0
    wrappers()["K3"].shapes.clear()


def read_launches() -> dict:
    PATH_K3_SHAPES.update(wrappers()["K3"].shapes)
    return {k: fn.launches for k, fn in wrappers().items()}


def first_pair_atlas(frontend, images, device):
    """The stacked raw atlas (both images' pyramids) of the first pair:
    K4's input on the image path."""
    import torch

    det = frontend.detector
    left, right = (torch.as_tensor(im).to(device).to(torch.float32) for im in images[0])
    return det.stacked_atlases(det.build_pyramid(left), det.build_pyramid(right))[0]


def check_kernels(device, card, atlas):
    from gmmloc_tpu_torch.config import euroc_v1_config
    from gmmloc_tpu_torch.eval import kernel_check
    from gmmloc_tpu_torch.geometry import camera as cam_mod

    cam = cam_mod.CameraParams.from_config(euroc_v1_config().camera)
    keep = ("ms", "plain_ms", "bound_ms", "bound_by")
    res = {}
    for key, anchored in (("K1", False), ("K2", True)):
        ms = []
        for n, seed in ((1280, 0), (1280, 3), (300, 0), (300, 3)):
            m = kernel_check.check_pose_kernel(cam, n, anchored, device, seed=seed,
                                               timing=(n, seed) == (1280, 0))
            log(f"[kernel] {key} seed={seed} F={n} {json.dumps(m)} on {card}")
            if not m["ok"]:
                raise RuntimeError(f"{key} disagrees with its plain version: {m}")
            ms.append(m)
        if not kernel_check.check_pose_repeatable(cam, 1280, anchored, device):
            raise RuntimeError(f"{key} is not bit-identical across launches")
        sweep = kernel_check.step_sweep(cam, anchored, device)
        log(f"[kernel] {key} step sweep {json.dumps(sweep)} on {card}")
        res[key] = dict(max_abs_err=max(m["max_abs_err"] for m in ms),
                        library_ms=None, shape="F=1280", gn_iters=ms[0]["gn_iters"],
                        step_us=sweep["step_us"],
                        feature_ns_per_step=sweep["feature_ns_per_step"],
                        **{k: ms[0][k] for k in keep})
    hs = {}
    for n, m in k3_shapes():
        r = kernel_check.check_hamming_kernel(n, m, device)
        log(f"[kernel] K3 {n}x{m} {json.dumps(r)} on {card}")
        if not r["ok"]:
            raise RuntimeError(f"K3 is not exact: {r}")
        hs[(n, m)] = r
    main = hs[(4096, 1280)]
    res["K3"] = dict(max_abs_err=max(r["max_abs_err"] for r in hs.values()),
                     library_ms=main["library_ms"], shape="4096x1280",
                     ms_l2=main["ms_l2"],
                     **{f"ms_{n}x{m}": r["ms"] for (n, m), r in hs.items()
                        if (n, m) != (4096, 1280)},
                     **{k: main[k] for k in keep})
    fs = {}
    for name, img in (("480x752", kernel_check.random_image(480, 752, device)),
                      ("96x130", kernel_check.random_image(96, 130, device, seed=1)),
                      ("dense", kernel_check.dense_image(*atlas.shape, device)),
                      ("atlas", atlas)):
        r = kernel_check.check_fast_kernel(img)
        log(f"[kernel] K4 {name} survivors {r['survivor_share']:.4f} of the pixels "
            f"{json.dumps(r)} on {card}")
        if not r["ok"]:
            raise RuntimeError(f"K4 is not bit-exact on {name}: {r}")
        fs[name] = r
    main = fs["atlas"]
    h, w = main["shape"]
    res["K4"] = dict(max_abs_err=max(r["max_abs_err"] for r in fs.values()),
                     library_ms=None, shape=f"{h}x{w}", ms_l2=main["ms_l2"],
                     survivor_share=main["survivor_share"],
                     ms_480x752=fs["480x752"]["ms"],
                     ms_dense_image=fs["dense"]["ms"],
                     dense_image_survivor_share=fs["dense"]["survivor_share"],
                     **{k: main[k] for k in keep})
    # a time under the bound is a fault of the count or of the clock
    for key, rows in (("K3", hs.values()), ("K4", fs.values())):
        for r in rows:
            if min(r["ms"], r["ms_l2"]) < r["bound_ms"]:
                raise RuntimeError(f"{key} {r['shape']}: {min(r['ms'], r['ms_l2'])} ms is "
                                   f"under its bound of {r['bound_ms']} ms")
    for key in ("K1", "K2"):
        if res[key]["ms"] < res[key]["bound_ms"]:
            raise RuntimeError(f"{key}: {res[key]['ms']} ms is under its bound")
    return res


def _summary(step_s, n_anchors, warmup, measured):
    import numpy as np

    meas = step_s[warmup:]
    return dict(
        fps=measured / float(meas.sum()),
        p50_ms=float(np.percentile(meas, 50) * 1e3),
        p95_ms=float(np.percentile(meas, 95) * 1e3),
        max_ms=float(meas.max() * 1e3), warmup_s=float(step_s[:warmup].sum()),
        anchored_frames=int((n_anchors > 0).sum()),
        anchors_mean=float(n_anchors.mean()), anchors_min=int(n_anchors.min()),
    )


def _ba_iters_mean(system) -> float:
    """LM iterations per local-BA solve over the run."""
    its = [s["n_iters"] for s in system.localizer.ba_stats]
    return float(sum(its) / len(its)) if its else 0.0


def _check_path(name, out, errs, gate, n_anchors, needed):
    if errs.max() >= gate:
        raise RuntimeError(f"[{name}] max translation error {errs.max():.4f} m >= {gate} m")
    for k in needed:
        if out["launches"][k] <= 0:
            raise RuntimeError(f"[{name}] {k} was not launched on the main path")
    # K2 launches on every frame, with or without anchors: the anchor
    # term ran only where the solve kept some
    if out["anchored_frames"] < MIN_ANCHORED_SHARE * len(n_anchors):
        raise RuntimeError(
            f"[{name}] the GMM anchor term ran on {out['anchored_frames']} of the "
            f"{len(n_anchors)} last completed frames (need {MIN_ANCHORED_SHARE:.0%})")


def run_feature_path(device, card):
    """The slice's feature path. Returns (out, the untouched inputs for the
    production runs: gmap, frames, q_wc, t_wc)."""
    import copy

    import numpy as np

    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

    n_frames = WARMUP + MEASURED
    t0 = time.perf_counter()
    cfg = slice_run.slice_config()
    gmap, frames, q_wc, t_wc = slice_run.make_inputs(
        cfg, slice_run.default_fixture_dir(), n_frames,
        n_components=N_COMPONENTS, n_landmarks=N_LANDMARKS, device=device)
    n_valid = int(np.mean([f.num_features() for f in frames]))
    log(f"[main] set-up {time.perf_counter() - t0:.1f}s: {N_COMPONENTS} components "
        f"(pad {cfg.caps.gmm_components_pad}), {N_LANDMARKS} landmarks, "
        f"{n_frames} frames, feat_cap {cfg.frame.feat_cap} "
        f"({n_valid} valid/frame), {cfg.camera.width}x{cfg.camera.height} on {card}")
    fresh = (gmap, copy.deepcopy(frames), q_wc, t_wc)

    system = GMMLocSystem(cfg, gmap, device)
    slice_run.timing_table(reset=True)
    reset_launches()
    ran = slice_run.run(system, frames, q_wc, t_wc, device)
    launches = read_launches()
    log(f"[main] host timers on {card}:\n{slice_run.timing_table()}")

    n_anchors = ran["n_anchors"][-MEASURED:]
    errs = slice_run.pose_errors(frames, t_wc)
    _, q_est, t_est = system.export_trajectory()
    out = dict(frames=n_frames, measured=MEASURED, tracked=system.n_tracked,
               max_err_m=float(errs.max()), mean_err_m=float(errs.mean()),
               keyframes=system.world.n_keyframes(), points=system.world.n_points(),
               ba_solves=len(system.localizer.ba_stats),
               ba_iters_mean=_ba_iters_mean(system), launches=launches,
               **_summary(ran["step_s"], n_anchors, WARMUP, MEASURED))
    log(f"[main] {json.dumps(out)} on {card}")
    if not (np.isfinite(q_est).all() and np.isfinite(t_est).all()
            and len(t_est) == n_frames):
        raise RuntimeError("exported trajectory is not finite or incomplete")
    if out["keyframes"] <= 1 or out["ba_solves"] < 1:
        raise RuntimeError(f"mapping did not run: {out['keyframes']} keyframes, "
                           f"{out['ba_solves']} BA solves")
    _check_path("main", out, errs, MAX_ERR_M, n_anchors, ("K1", "K2", "K3"))
    return out, fresh


def image_gate() -> float:
    if JAX_IMG_MAX_ERR_M is None:
        return MAX_ERR_M
    return max(MAX_ERR_M, JAX_IMG_MAX_ERR_M + 0.01)


def run_image_path(device, card, cfg, gmap, images, ts, q_wc, t_wc):
    import numpy as np

    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

    frontend = ImageFrontend(cfg, device=device)
    system = GMMLocSystem(cfg, gmap, device)
    slice_run.timing_table(reset=True)
    reset_launches()
    ran = slice_run.run_image(system, frontend, images, ts, q_wc, t_wc)
    launches = read_launches()
    log(f"[image] host timers on {card}:\n{slice_run.timing_table()}")

    n_frames = len(images)
    n_anchors = ran["n_anchors"][-IMG_MEASURED:]
    frames = ran["frames"]
    errs = slice_run.pose_errors(frames, t_wc)
    fe_ms = ran["frontend_ms"][IMG_WARMUP:]
    n_feat = [f.num_features() for f in frames]
    n_stereo = [int((f.ur[f.valid] >= 0).sum()) for f in frames]
    out = dict(frames=n_frames, measured=IMG_MEASURED, tracked=system.n_tracked,
               width=cfg.camera.width, height=cfg.camera.height,
               num_features=cfg.frame.num_features, levels=cfg.frame.num_levels,
               features_mean=float(np.mean(n_feat)), stereo_mean=float(np.mean(n_stereo)),
               stereo_min=int(np.min(n_stereo)),
               frontend_ms_mean=float(fe_ms.mean()),
               frontend_ms_p50=float(np.percentile(fe_ms, 50)),
               max_err_m=float(errs.max()), mean_err_m=float(errs.mean()),
               err_gate_m=image_gate(), keyframes=system.world.n_keyframes(),
               points=system.world.n_points(), ba_solves=len(system.localizer.ba_stats),
               ba_iters_mean=_ba_iters_mean(system), launches=launches,
               **_summary(ran["step_s"], n_anchors, IMG_WARMUP, IMG_MEASURED))
    log(f"[image] {json.dumps(out)} on {card}")
    if len(frames) != n_frames or system.n_tracked != n_frames - 1:
        raise RuntimeError(f"[image] {len(frames)} frames completed, "
                           f"{system.n_tracked} tracked, of {n_frames}")
    if launches["K4"] < n_frames:
        raise RuntimeError(f"[image] K4 launched {launches['K4']} times for "
                           f"{n_frames} frames")
    _check_path("image", out, errs, image_gate(), n_anchors, tuple(KERNELS))
    return out, system.export_trajectory()


def run_production(card, name, make_system, loop, t_wc, warmup, measured, gate, needed):
    """One production run: `loop(system)` drives the system that
    `make_system()` builds and returns `run`/`run_image`'s record with the
    tracked `frames`. Launches are counted from just before the loop to
    just after `stop()` (which drains the mapper)."""
    import numpy as np

    from gmmloc_tpu_torch.eval import slice_run

    system = make_system()
    if system._depth != 4:
        raise RuntimeError(f"[{name}] the chained pipeline dropped to depth {system._depth}")
    slice_run.timing_table(reset=True)
    reset_launches()
    ran = loop(system)
    system.stop()
    launches = read_launches()
    if system._depth != 4:
        raise RuntimeError(f"[{name}] the chained pipeline ran at depth {system._depth}")
    log(f"[{name}] host timers on {card}:\n{slice_run.timing_table()}")
    n_anchors = ran["n_anchors"][-measured:]
    errs = slice_run.pose_errors(ran["frames"], t_wc)
    loc = system.localizer
    out = dict(frames=len(ran["frames"]), measured=measured, tracked=system.n_tracked,
               depth=system._depth, online=system.online is not None,
               max_err_m=float(errs.max()), mean_err_m=float(errs.mean()),
               err_gate_m=gate, keyframes=system.world.n_keyframes(),
               points=system.world.n_points(), ba_solves=len(loc.ba_stats),
               ba_iters_mean=_ba_iters_mean(system), n_primes=system.n_primes,
               n_rewinds=system.n_rewinds, n_rewound_frames=system.n_rewound_frames,
               chained_share=slice_run.chained_share(ran, warmup),
               mirror_syncs=loc.dev_world.n_syncs,
               tri_matches_mean=float(np.mean(loc.tri_stats)) if loc.tri_stats else 0.0,
               launches=launches,
               **_summary(ran["step_s"], n_anchors, warmup, measured))
    if ran.get("frontend_ms") is not None:
        out["frontend_ms_mean"] = float(ran["frontend_ms"][warmup:].mean())
    log(f"[{name}] {json.dumps(out)} on {card}")
    if system.online is not None and (system.online.count_queue()
                                      or system.online._thread is not None):
        raise RuntimeError(f"[{name}] the mapper was not drained and joined")
    if out["keyframes"] <= 1 or out["ba_solves"] < 1:
        raise RuntimeError(f"[{name}] mapping did not run: {out['keyframes']} keyframes, "
                           f"{out['ba_solves']} BA solves")
    if out["chained_share"] < 0.5 or out["mirror_syncs"] <= 0:
        raise RuntimeError(f"[{name}] {out['chained_share']:.2f} of the measured frames "
                           f"ran chained, {out['mirror_syncs']} mirror syncs")
    _check_path(name, out, errs, gate, n_anchors, needed)
    log(f"[result] {name}: {out['fps']:.2f} tracked frames/s, p50 {out['p50_ms']:.1f} ms, "
        f"p95 {out['p95_ms']:.1f} ms per frame, max error {out['max_err_m'] * 100:.2f} cm, "
        f"{out['keyframes']} keyframes, {out['ba_solves']} BA solves at "
        f"{out['ba_iters_mean']:.1f} LM iterations, primes/rewinds/rewound frames "
        f"{out['n_primes']}/{out['n_rewinds']}/{out['n_rewound_frames']}, chained share "
        f"{out['chained_share']:.2f}, GMM anchors on {out['anchored_frames']} of "
        f"{measured} frames on {card}")
    return out


def run_production_phase(device, card, feature_inputs, img_inputs):
    """[production]: the JAX package's bench.py lines on the port. Returns
    {run name: out}."""
    import copy

    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

    gmap, frames, q_wc, t_wc = feature_inputs
    outs = {}
    for online in (False, True):
        name = f"production_feature_{'online' if online else 'offline'}"
        cfg = slice_run.production_config(online)
        fr = copy.deepcopy(frames)
        outs[name] = run_production(
            card, name, lambda: GMMLocSystem(cfg, gmap, device),
            lambda system: dict(slice_run.run(system, fr, q_wc, t_wc, device), frames=fr),
            t_wc, WARMUP, MEASURED, PROD_MAX_ERR_M, ("K1", "K2", "K3"))
    name = "production_image_online"
    igmap, images, ts, iq, it = img_inputs
    cfg = slice_run.image_config(slice_run.production_config(True))
    frontend = ImageFrontend(cfg, device=device)
    out = run_production(
        card, name, lambda: GMMLocSystem(cfg, igmap, device),
        lambda system: slice_run.run_image(system, frontend, images, ts, iq, it),
        it, IMG_WARMUP, IMG_MEASURED, PROD_MAX_ERR_M, tuple(KERNELS))
    if out["launches"]["K4"] < len(images):
        raise RuntimeError(f"[{name}] K4 launched {out['launches']['K4']} times for "
                           f"{len(images)} frames")
    outs[name] = out
    return outs


class _RelocLog:
    """Wraps a system's `relocalize`: per call the frame, the outcome, the
    host ms (the call reads its results back, so the clock holds the
    device work), the candidates tried and the K1 and K3 launches made
    inside it."""

    def __init__(self, system):
        self.calls = []
        rel = system.relocalizer
        inner = rel.relocalize

        def relocalize(frame):
            k = wrappers()
            l1, l3 = k["K1"].launches, k["K3"].launches
            t0 = time.perf_counter()
            ok = inner(frame)
            self.calls.append(dict(
                frame=int(frame.idx), ok=bool(ok), ms=(time.perf_counter() - t0) * 1e3,
                tried=sum(1 for st in rel.last_stats if isinstance(st[0], int)),
                K1=k["K1"].launches - l1, K3=k["K3"].launches - l3))
            return ok

        rel.relocalize = relocalize


def run_reloc_phase(device, card) -> dict:
    """[reloc]: the blackout and the kidnap at depth 4. Returns {run: out}."""
    import numpy as np

    from gmmloc_tpu_torch.eval import reloc_run, slice_run
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
    from gmmloc_tpu_torch.vocab.bow import Vocabulary

    t0 = time.perf_counter()
    cfg = slice_run.production_config(False)
    n = WARMUP + MEASURED
    gmap, fe, ts, q_wc, t_wc = slice_run.make_world(
        cfg, os.path.join(slice_run.default_fixture_dir(), "reloc"), n,
        n_components=N_COMPONENTS, n_landmarks=N_LANDMARKS, device=device)
    voc = Vocabulary.train(fe.world.desc[::4], k=10, depth=3, seed=0, device=device)
    runs = {
        "reloc_blackout": reloc_run.blackout_frames(fe, ts, q_wc, t_wc, 0, n, RELOC_DARK),
        "reloc_kidnap": reloc_run.kidnap_frames(fe, ts, q_wc, t_wc, **KIDNAP),
    }
    probe = np.concatenate([fe.world.desc] + [f.desc for _, f in runs["reloc_blackout"]])
    words = voc.transform_words(probe)
    if not np.array_equal(words, voc.to("cpu").transform_words(probe)):
        raise RuntimeError("[reloc] the vocabulary's descent on the card differs from "
                           "the CPU's")
    log(f"[reloc] set-up {time.perf_counter() - t0:.1f}s: vocabulary of {voc.n_words} "
        f"words (k=10, depth 3) from {len(fe.world.desc[::4])} landmark descriptors; "
        f"descent on the card equals the CPU's on {len(probe)} descriptors, on {card}")
    outs = {}
    for name, frames in runs.items():
        system = GMMLocSystem(cfg, gmap, device, vocabulary=voc)
        rlog = _RelocLog(system)
        slice_run.timing_table(reset=True)
        reset_launches()
        ran = reloc_run.drive(system, frames, q_wc, t_wc)
        launches = read_launches()
        log(f"[{name}] host timers on {card}:\n{slice_run.timing_table()}")
        r = reloc_run.summary(system, frames, t_wc)
        calls = rlog.calls
        tried = sum(c["tried"] for c in calls)
        out = dict(frames=len(frames), depth=system._depth, lost_frames=r["untracked"],
                   n_lost=r["n_lost"], recovery_frames=r["recovery_frames"],
                   relocalize_calls=len(calls), candidates_tried=tried,
                   ms_per_call=float(np.mean([c["ms"] for c in calls])) if calls else None,
                   ms_per_attempt=sum(c["ms"] for c in calls) / tried if tried else None,
                   reloc_launches=dict(K1=sum(c["K1"] for c in calls),
                                       K3=sum(c["K3"] for c in calls)),
                   max_err_after_m=float(r["errors"].max()) if len(r["errors"]) else None,
                   tracked_after=len(r["errors"]), keyframes=system.world.n_keyframes(),
                   n_rewinds=system.n_rewinds, fps=len(frames) / float(ran["step_s"].sum()),
                   launches=launches)
        log(f"[{name}] {json.dumps(out)} on {card}")
        if system._depth != 4:
            raise RuntimeError(f"[{name}] ran at depth {system._depth}")
        if r["n_lost"] <= 0 or r["lost"] or not r["recovery_frames"]:
            raise RuntimeError(f"[{name}] lost {r['n_lost']} frames, recovered at "
                               f"{r['recovery_frames']}, lost at the end: {r['lost']}")
        if len(r["errors"]) < 10 or r["errors"].max() >= RELOC_MAX_ERR_M:
            raise RuntimeError(f"[{name}] {len(r['errors'])} frames tracked after the "
                               f"recovery, max error {out['max_err_after_m']} m")
        if min(out["reloc_launches"].values()) <= 0:
            raise RuntimeError(f"[{name}] relocalize launched {out['reloc_launches']}")
        log(f"[result] {name}: lost frames {r['untracked']}, recovered at "
            f"{r['recovery_frames']}, {tried} candidates tried in {len(calls)} calls, "
            f"{out['ms_per_attempt']:.2f} ms per attempt, max error after the recovery "
            f"{out['max_err_after_m'] * 100:.2f} cm on {card}")
        outs[name] = out
    return outs


def loop_gate() -> float:
    if JAX_LOOP_MAX_ERR_M is None:
        return PROD_MAX_ERR_M
    return max(PROD_MAX_ERR_M, JAX_LOOP_MAX_ERR_M + 0.01)


def run_revisit(device, card) -> dict:
    """The JAX package's loop-closing test world (eval/reloc_run.py
    revisit_scenario) on the card: `close` must close the loop (K3 in
    `verify`, the pose graph on the card), match the same closure on the
    CPU within 1e-4 m, leave the mirror equal to the host after the next
    sync, and give the same graph result when solved twice more."""
    import dataclasses

    import numpy as np

    from gmmloc_tpu_torch.config import euroc_v1_config
    from gmmloc_tpu_torch.eval import reloc_run
    from gmmloc_tpu_torch.mapping.device_world import DeviceWorld
    from gmmloc_tpu_torch.solver import pose_graph

    cfg = euroc_v1_config()
    cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, max_keyframes=16, max_points=256,
                                               max_obs_per_point=8),
                      frame=dataclasses.replace(cfg.frame, feat_cap=64))
    ref_w, _, ref_lc, kf_re, kf0 = reloc_run.revisit_scenario(cfg, "cpu")
    w, _, lc, _, _ = reloc_run.revisit_scenario(cfg, device)
    mirror = DeviceWorld(w, device)
    mirror.sync()
    t_before = w.kf_t[kf_re].copy()
    l3 = wrappers()["K3"].launches
    t0 = time.perf_counter()
    ok = lc.close(kf_re)
    close_ms = (time.perf_counter() - t0) * 1e3
    k3 = wrappers()["K3"].launches - l3
    if not (ok and ref_lc.close(kf_re) and lc.closures == ref_lc.closures == [(kf_re, kf0)]):
        raise RuntimeError(f"[loop] the revisit was not closed: {lc.closures}")
    mirror.sync()
    valid, pts = np.where(w.kf_valid)[0], np.where(w.pt_valid)[0]
    mirror_ok = (np.array_equal(mirror.kf_q.cpu().numpy()[valid], w.kf_q[valid].astype(np.float32))
                 and np.array_equal(mirror.kf_t.cpu().numpy()[valid],
                                    w.kf_t[valid].astype(np.float32))
                 and np.array_equal(mirror.pt_pos.cpu().numpy()[pts],
                                    w.pt_pos[pts].astype(np.float32)))
    g, q, t, cost = lc.graphs[0]
    same = all(all(np.array_equal(a.cpu().numpy(), b) for a, b in zip(
        pose_graph.optimize_pose_graph(g, iters=15, device=device), (q, t, cost)))
        for _ in range(2))
    out = dict(closed=lc.closures, close_ms=close_ms, K3_in_close=k3,
               moved_m=float(np.linalg.norm(w.kf_t[kf_re] - t_before)),
               kf_t_vs_cpu_m=float(np.abs(w.kf_t[valid] - ref_w.kf_t[valid]).max()),
               pt_pos_vs_cpu_m=float(np.abs(w.pt_pos[pts] - ref_w.pt_pos[pts]).max()),
               mirror_equal=mirror_ok, pose_graph_repeatable=same)
    log(f"[loop] revisit world {json.dumps(out)} on {card}")
    if (k3 <= 0 or out["moved_m"] <= 0.1 or out["kf_t_vs_cpu_m"] >= 1e-4
            or out["pt_pos_vs_cpu_m"] >= 1e-4 or not mirror_ok or not same):
        raise RuntimeError(f"[loop] revisit world: {out}")
    return out


def run_loop_phase(device, card) -> dict:
    """[loop]: one lap with loop closing at depth 4."""
    import numpy as np
    import torch

    from gmmloc_tpu_torch.eval import reloc_run, slice_run
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
    from gmmloc_tpu_torch.solver import pose_graph
    from gmmloc_tpu_torch.vocab.bow import Vocabulary

    t0 = time.perf_counter()
    cfg = slice_run.production_config(False).replace(enable_loop_closing=True)
    gmap, fe, ts, q_wc, t_wc = slice_run.make_world(
        cfg, os.path.join(slice_run.default_fixture_dir(), "loop"), LOOP_FRAMES,
        n_components=N_COMPONENTS, n_landmarks=N_LANDMARKS, device=device)
    voc = Vocabulary.train(fe.world.desc[::4], k=10, depth=3, seed=0, device=device)
    frames = reloc_run.blackout_frames(fe, ts, q_wc, t_wc, 0, LOOP_FRAMES, ())
    log(f"[loop] set-up {time.perf_counter() - t0:.1f}s on {card}")
    system = GMMLocSystem(cfg, gmap, device, vocabulary=voc)
    w, lc, mirror = system.world, system.loop_closer, system.localizer.dev_world
    closes, syncs = [], []
    state = dict(after_closure=False)
    inner_close, inner_sync = lc.close, mirror.sync

    def close(kf):
        t1 = time.perf_counter()
        ok = inner_close(kf)
        closes.append(((time.perf_counter() - t1) * 1e3, ok))
        state["after_closure"] = state["after_closure"] or ok
        return ok

    def sync():
        inner_sync()
        if state["after_closure"]:
            # the first sync after a closure: the mirror holds the host's
            # moved poses and points
            state["after_closure"] = False
            valid = np.where(w.kf_valid)[0]
            pts = np.where(w.pt_valid)[0]
            syncs.append(bool(
                np.array_equal(mirror.kf_q.cpu().numpy()[valid], w.kf_q[valid].astype(np.float32))
                and np.array_equal(mirror.kf_t.cpu().numpy()[valid],
                                   w.kf_t[valid].astype(np.float32))
                and np.array_equal(mirror.pt_pos.cpu().numpy()[pts],
                                   w.pt_pos[pts].astype(np.float32))))

    lc.close, mirror.sync = close, sync
    slice_run.timing_table(reset=True)
    reset_launches()
    ran = reloc_run.drive(system, frames, q_wc, t_wc)
    if state["after_closure"]:
        sync()                  # no keyframe came after the last closure
    launches = read_launches()
    log(f"[loop] host timers on {card}:\n{slice_run.timing_table()}")
    r = reloc_run.summary(system, frames, t_wc)
    # each closure's graph again, twice, on the card: identical poses
    same, pgo_ms = True, []
    for g, q, t, cost in lc.graphs:
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = [x.cpu().numpy() for x in pose_graph.optimize_pose_graph(
                g, iters=15, device=device)]
            pgo_ms.append((time.perf_counter() - t1) * 1e3)
            same = same and all(np.array_equal(a, b) for a, b in zip(out, (q, t, cost)))
    errs = r["errors_tracked"]
    closing = [ms for ms, ok in closes if ok]
    out = dict(frames=len(frames), depth=system._depth,
               closures=[(int(k), int(c)) for k, c in lc.closures],
               closure_frames=[(int(w.kf_frame_idx[k]), int(w.kf_frame_idx[c]))
                               for k, c in lc.closures],
               close_calls=len(closes),
               close_ms_mean=float(np.mean([ms for ms, _ in closes])) if closes else None,
               closing_close_ms=closing,
               pose_graph_nodes=[int(g.q.shape[0]) for g, *_ in lc.graphs],
               pose_graph_edges=[int(g.edge_i.shape[0]) for g, *_ in lc.graphs],
               pose_graph_ms=pgo_ms, pose_graph_repeatable=same,
               mirror_equal_after_closure=syncs,
               max_err_m=float(errs.max()), mean_err_m=float(errs.mean()),
               err_gate_m=loop_gate(), untracked=len(r["untracked"]),
               n_lost=r["n_lost"], keyframes=w.n_keyframes(),
               jax_closures=JAX_LOOP_CLOSURES,
               fps=len(frames) / float(ran["step_s"].sum()), launches=launches)
    log(f"[loop] {json.dumps(out)} on {card}")
    if JAX_LOOP_CLOSURES and not lc.closures:
        raise RuntimeError(f"[loop] the JAX package closes {JAX_LOOP_CLOSURES} loop(s) "
                           "on the lap, the port none")
    if errs.max() >= loop_gate():
        raise RuntimeError(f"[loop] max error {errs.max():.4f} m >= {loop_gate()} m")
    if len(syncs) != len(lc.closures) or not all(syncs):
        raise RuntimeError(f"[loop] mirror after the closures' syncs: {syncs} for "
                           f"{len(lc.closures)} closures")
    if not same:
        raise RuntimeError("[loop] the pose graph gave another result when solved again")
    out["revisit"] = run_revisit(device, card)
    log(f"[result] loop: {len(lc.closures)} closures {out['closure_frames']} (frame pairs), "
        f"close {out['close_ms_mean']:.2f} ms per call, closing calls {closing} ms, pose "
        f"graph {pgo_ms} ms, max error {errs.max() * 100:.2f} cm on {card}")
    return out


def _mirror_tables(world, device) -> dict:
    """A fresh device-world mirror of `world`, synced, as host arrays."""
    import torch

    from gmmloc_tpu_torch.mapping.device_world import DeviceWorld

    mirror = DeviceWorld(world, device)
    mirror.sync()
    return {k: v.cpu().numpy() for k, v in vars(mirror).items()
            if isinstance(v, torch.Tensor)}


def _mirror_differs(tables, world, other=None) -> list:
    """The mirror tables whose live rows (the world's valid keyframes and
    points) differ from the host's, or from `other`'s where given (a
    removed row may hold stale values: the validity masks it)."""
    import numpy as np

    kfs, pts = np.where(world.kf_valid)[0], np.where(world.pt_valid)[0]
    if other is None:
        comp = np.where(world.pt_assoc_vetted, world.pt_assoc_comp, -1)
        other = dict(pt_comp=comp, pt_acomp=world.pt_assoc_comp,
                     **{k: getattr(world, k) for k in tables if hasattr(world, k)})
    bad = []
    for k, v in tables.items():
        rows = kfs if k.startswith("kf_") else pts
        if not np.array_equal(v[rows], np.asarray(other[k])[rows].astype(v.dtype)):
            bad.append(k)
    return bad


def run_disk_phase(device, card, cfg, img_inputs, img_traj) -> dict:
    """[disk]: phase 3's rendered pairs written as an EuRoC ASL tree of
    PNGs, read back by the native decode ring and run through
    `GMMLocSystem.run` (`eval/disk_run.py`): the decode alone, the run
    held to phase 6's checks and trajectory, a stop from `on_frame`, a
    checkpoint loaded into a fresh system and its mirror, the octree
    keypoint distribution and the Rectifier on the card. Returns {run:
    out}."""
    import dataclasses

    import numpy as np
    import torch

    from gmmloc_tpu_torch.eval import disk_run, slice_run
    from gmmloc_tpu_torch.pipeline import checkpoint, html_viewer, rectify
    from gmmloc_tpu_torch.pipeline.dataloader import EuRoCDataloader
    from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
    from gmmloc_tpu_torch.utils import native, timing
    from gmmloc_tpu_torch.utils.control import control

    gmap, images, ts, q_wc, t_wc = img_inputs
    n = len(images)
    fixture = os.path.join(slice_run.default_fixture_dir(), "image")
    root = os.path.join(fixture, "asl")
    outs = {}

    # 1. the tree
    t0 = time.perf_counter()
    n_bytes = disk_run.write_asl_tree(root, images, ts)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load("png_ring")
    build_s = time.perf_counter() - t0
    decoder = (f"{native.decoder_name()} in "
               f"{os.path.relpath(native.library_path('png_ring'), ROOT)} (g++, "
               f"{build_s:.1f}s to build and load)")
    log(f"[disk] wrote {n} pairs, {n_bytes} bytes in {write_s:.2f}s under {root}; "
        f"decoder {decoder}")

    # 2. the decode ring alone
    loader = EuRoCDataloader(root, gt_path=os.path.join(fixture, "room_gt.txt"))
    timing.reset()
    t0 = time.perf_counter()
    decoded = [(l, r) for _, l, r in loader.pairs()]
    ring_s = time.perf_counter() - t0
    same = len(decoded) == n and all(np.array_equal(a, c) and np.array_equal(b, d)
                                     for (a, b), (c, d) in zip(decoded, images))
    ring = dict(pairs=len(decoded), seconds=ring_s, pairs_per_s=len(decoded) / ring_s,
                bit_equal=same, decoder=decoder)
    log(f"[disk] decode ring alone {json.dumps(ring)} on {card}")
    if not same:
        raise RuntimeError("[disk] the decoded pairs differ from the written pixels")
    del decoded
    outs["ring"] = ring

    # 3. the disk run
    frontend = ImageFrontend(cfg, device=device)
    system = GMMLocSystem(cfg, gmap, device)
    control.reset()
    slice_run.timing_table(reset=True)
    reset_launches()
    ran = disk_run.run(system, frontend, loader)
    launches = read_launches()
    take = timing.REGISTRY.get("data/take")
    log(f"[disk] host timers on {card}:\n{slice_run.timing_table()}")
    frames = ran["frames"]
    n_anchors = ran["n_anchors"][-IMG_MEASURED:]
    errs = slice_run.pose_errors(frames, t_wc)
    traj = system.export_trajectory()
    pose_equal = all(np.array_equal(a, b) for a, b in zip(traj[1:], img_traj[1:]))
    out = dict(frames=len(frames), measured=IMG_MEASURED, tracked=system.n_tracked,
               max_err_m=float(errs.max()), mean_err_m=float(errs.mean()),
               err_gate_m=image_gate(), keyframes=system.world.n_keyframes(),
               points=system.world.n_points(), take_ms_mean=take.mean() * 1e3,
               take_ms_max=take.max * 1e3, takes=take.count,
               seconds=ran["seconds"], launches=launches,
               trajectory_equal_to_image_path=pose_equal,
               timestamps_vs_image_path_s=float(np.abs(traj[0] - img_traj[0]).max()),
               **_summary(ran["step_s"], n_anchors, IMG_WARMUP, IMG_MEASURED))
    if not pose_equal:
        # two in-memory runs on the card: how far apart the card's own
        # runs land on the same pixels
        again = GMMLocSystem(cfg, gmap, device)
        slice_run.run_image(again, ImageFrontend(cfg, device=device), images, ts, q_wc, t_wc)
        t2 = again.export_trajectory()
        out["memory_vs_memory_m"] = float(np.abs(t2[2] - img_traj[2]).max())
        out["disk_vs_memory_m"] = float(np.abs(traj[2] - img_traj[2]).max())
    log(f"[disk] {json.dumps(out)} on {card}")
    if len(frames) != n or system.n_tracked != n - 1:
        raise RuntimeError(f"[disk] {len(frames)} frames completed, {system.n_tracked} "
                           f"tracked, of {n}")
    if launches["K4"] < n:
        raise RuntimeError(f"[disk] K4 launched {launches['K4']} times for {n} frames")
    _check_path("disk", out, errs, image_gate(), n_anchors, tuple(KERNELS))
    if not pose_equal and not (0 < out["disk_vs_memory_m"] <= out["memory_vs_memory_m"]):
        raise RuntimeError(f"[disk] the trajectory differs from the image path's by "
                           f"{out['disk_vs_memory_m']} m, two in-memory runs by "
                           f"{out['memory_vs_memory_m']} m")
    log(f"[result] disk: {out['fps']:.2f} tracked frames/s, p50 {out['p50_ms']:.1f} ms, "
        f"p95 {out['p95_ms']:.1f} ms per frame, data/take {out['take_ms_mean']:.3f} ms "
        f"per frame, trajectory equal to the image path's: {pose_equal}, max error "
        f"{out['max_err_m'] * 100:.2f} cm on {card}")
    outs["disk"] = out

    # 4. a stop from on_frame
    stopper = GMMLocSystem(cfg, gmap, device)
    inner, after_stop, stepped = stopper.step, [], []

    def step(frame, *a):
        stepped.append(frame.idx)
        if control.stop:
            after_stop.append(frame.idx)
        return inner(frame, *a)

    def on_frame(i, frame, stat):
        if frame.idx == DISK_STOP_FRAME:
            control.request_stop()

    stopper.step = step
    try:
        world = disk_run.run(stopper, ImageFrontend(cfg, device=device), loader,
                             on_frame=on_frame)["world"]
    finally:
        stop_seen = control.stop
        control.reset()
    stop = dict(stepped=len(stepped), last_stepped=stepped[-1], after_stop=after_stop,
                recorded=len(stopper.world.frame_infos))
    log(f"[disk] stop from on_frame at frame {DISK_STOP_FRAME} {json.dumps(stop)} on {card}")
    if (not stop_seen or after_stop or world is not stopper.world
            or stop["recorded"] != len(stepped)
            or not DISK_STOP_FRAME < stepped[-1] < n - 1):
        raise RuntimeError(f"[disk] the stop at frame {DISK_STOP_FRAME}: {stop}")
    outs["stop"] = stop

    # 5. checkpoint: the disk run's world into a fresh system on the card
    path = os.path.join(fixture, "disk_world.npz")
    checkpoint.save_checkpoint(path, system.world, frame_cursor=n)
    fresh = GMMLocSystem(cfg, gmap, device)
    cursor, _ = checkpoint.load_checkpoint(path, fresh.world)
    mine, theirs = _mirror_tables(fresh.world, device), _mirror_tables(system.world, device)
    bad = (_mirror_differs(mine, fresh.world)
           + [f"{k} (original)" for k in _mirror_differs(mine, fresh.world, theirs)])
    traj_equal = all(np.array_equal(a, b) for a, b in zip(fresh.export_trajectory(), traj))
    html = os.path.join(fixture, "disk_world.html")
    html_viewer.export_html(fresh.world, html, gmm=gmap)
    text = open(html).read()
    frusta = json.loads(text.split("const D = ", 1)[1].split(";\n", 1)[0])["frusta"]
    ck = dict(cursor=cursor, npz_bytes=os.path.getsize(path), mirror_tables=len(mine),
              mirror_differs=bad, trajectory_equal=traj_equal, html_bytes=len(text),
              html_keyframes=len(frusta) // 8, keyframes=fresh.world.n_keyframes())
    log(f"[disk] checkpoint {json.dumps(ck)} on {card}")
    if (bad or not traj_equal or cursor != n or not text
            or ck["html_keyframes"] != ck["keyframes"] or len(frusta) % 8):
        raise RuntimeError(f"[disk] checkpoint: {ck}")
    outs["checkpoint"] = ck

    # 6. the octree keypoint distribution over the first pairs
    n_oct = DISK_OCTREE_FRAMES
    ocfg = cfg.replace(frame=dataclasses.replace(cfg.frame, detect_distribution="octree"))
    osys = GMMLocSystem(ocfg, gmap, device)
    reset_launches()
    oran = disk_run.run(osys, ImageFrontend(ocfg, device=device), loader, n=n_oct)
    olaunch = read_launches()
    oerrs = slice_run.pose_errors(oran["frames"], t_wc)
    octo = dict(frames=len(oran["frames"]), tracked=osys.n_tracked,
                max_err_m=float(oerrs.max()), err_gate_m=image_gate(),
                fps=n_oct / oran["seconds"], launches=olaunch,
                features_mean=float(np.mean([f.num_features() for f in oran["frames"]])))
    log(f"[disk] octree {json.dumps(octo)} on {card}")
    if (octo["frames"] != n_oct or osys.n_tracked != n_oct - 1 or olaunch["K4"] < n_oct
            or oerrs.max() >= image_gate()):
        raise RuntimeError(f"[disk] octree: {octo}")
    outs["disk_octree"] = dict(octo, launches=olaunch)

    # 7. the Rectifier on the card
    ypath = os.path.join(fixture, "rect.yaml")
    disk_run.write_rect_filestorage(ypath, cfg.camera.width, cfg.camera.height)
    rc, rh = rectify.Rectifier(ypath, device=device), rectify.Rectifier(ypath, device="cpu")
    maps_equal = all(np.array_equal(a.cpu().numpy(), b.numpy())
                     for side in ("LEFT", "RIGHT") for a, b in zip(rc.maps[side], rh.maps[side]))
    left, right = (torch.from_numpy(im.astype(np.float32)) for im in images[0])
    out_c = [rc.rectify_left(left.to(device)), rc.rectify_right(right.to(device))]
    out_h = [rh.rectify_left(left), rh.rectify_right(right)]
    remap_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(out_c, out_h))
    eq_exact = all(torch.equal(rectify.equalize_hist(b.to(device)).cpu(),
                               rectify.equalize_hist(b)) for b in out_h)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    reps = 20
    gl, gr = left.to(device), right.to(device)
    for _ in range(3):
        rectify.equalize_hist(rc.rectify_left(gl)), rectify.equalize_hist(rc.rectify_right(gr))
    ev[0].record()
    for _ in range(reps):
        rectify.equalize_hist(rc.rectify_left(gl)), rectify.equalize_hist(rc.rectify_right(gr))
    ev[1].record()
    torch.cuda.synchronize()
    rect = dict(size=[rc.width, rc.height], maps_equal=maps_equal, remap_max_abs_err=remap_err,
                equalize_exact=eq_exact, ms_per_pair=ev[0].elapsed_time(ev[1]) / reps,
                warp_px=float((rh.maps["LEFT"][0] - torch.arange(rc.width)).abs().max()))
    log(f"[disk] rectify {json.dumps(rect)} on {card}")
    if not maps_equal or remap_err >= 1e-3 or not eq_exact or rect["warp_px"] <= 0.5:
        raise RuntimeError(f"[disk] rectify: {rect}")
    outs["rectify"] = rect
    return outs


def _check_multi(name, card, sharded: dict, whole: dict, noisy: dict,
                 noisy_whole: dict) -> dict:
    """[multi] (a)/(b): association exact; the BA of the dry-run window
    and of the noisy window as the unsharded solve's (`entry.ba_gap_fault`:
    within 1e-4 m, the same cost and LM iterations, bit for bit at one
    rank); prints the times beside the card."""
    import numpy as np

    from gmmloc_tpu_torch import entry

    if not (np.array_equal(sharded["visible"], whole["visible"])
            and np.array_equal(sharded["cand"], whole["cand"])):
        raise RuntimeError(f"[multi] {name}: the sharded association differs from the "
                           "unsharded one")
    gaps = dict(dryrun=entry.ba_gap(sharded, whole), noisy=entry.ba_gap(noisy, noisy_whole))
    for window, res in (("dryrun", sharded), ("noisy", noisy)):
        fault = entry.ba_gap_fault(gaps[window], sharded["size"])
        if not np.isfinite(res["cost"]) or fault is not None:
            raise RuntimeError(f"[multi] {name}: the sharded BA of the {window} window "
                               f"(cost {res['cost']}) is {fault}")
    coll = sharded["ba_collectives"]
    it = max(sharded["n_iters"], 1)
    out = dict(
        ranks=sharded["size"], assoc_ms=sharded["assoc_ms"],
        assoc_ms_unsharded=whole["assoc_ms"], visible=int(whole["visible"].sum()),
        candidates=int((whole["cand"] >= 0).sum()),
        ba_ms_per_iter_sharded_eager=sharded["ba_ms_per_iter"],
        ba_ms_per_iter_unsharded_replayed=whole["ba_ms_per_iter"],
        n_iters=sharded["n_iters"], points_per_rank=sharded["points_per_rank"],
        collective_ms_per_iter=coll["ms"] / it, collective_bytes_per_iter=coll["bytes"] / it,
        collective_calls_per_iter=coll["calls"] / it, cost=sharded["cost"],
        noisy_cost=noisy["cost"], noisy_cost_unsharded=noisy_whole["cost"], ba=gaps)
    log(f"[multi] {name} {json.dumps(out)} on {card}")
    return out


def run_multi_phase(device, card) -> dict:
    """[multi]: (a) `dryrun_multichip(1)` and the noisy BA window on a real
    NCCL group of one rank, the sharded association and BAs at production
    shapes held against the unsharded port (exact; the BAs bit for bit);
    (b) both over two gloo ranks on the one card (NCCL takes one rank per
    card), association exact and the BAs within 1e-4 m with the same
    cost and LM iterations; (c) the
    sweep of two feature-path jobs over two ranks, merged on rank 0; (d)
    `entry()` with K1/K2/K3 launched. Each rank is a process with its own
    time limit; a failed rank fails the phase."""
    import tempfile

    import numpy as np
    import torch

    from gmmloc_tpu_torch import entry
    from gmmloc_tpu_torch.eval import sweep

    t_phase = time.perf_counter()
    cam, gmm, pose, feat_uv, prob, L = entry.dryrun_inputs()
    noisy = entry.noisy_window(prob)
    torch.cuda.empty_cache()
    whole = entry.unsharded(device, cam, gmm, pose, feat_uv, prob, L, entry.DRYRUN_ITERS)
    noisy_whole = entry.unsharded(device, cam, None, None, None, noisy, L, entry.DRYRUN_ITERS)
    log(f"[multi] unsharded: association {whole['assoc_ms']:.2f} ms, BA "
        f"{whole['n_iters']} LM iterations at {whole['ba_ms_per_iter']:.3f} ms each "
        f"(replayed from graphs), cost {whole['cost']:.6g}; noisy window "
        f"{noisy_whole['n_iters']} LM iterations, cost {noisy_whole['cost']:.6g} on {card}")
    out = {}
    for key, name, n, backend in (("nccl1", "(a) NCCL, 1 rank", 1, "nccl"),
                                  ("gloo2", "(b) gloo, 2 ranks on one card", 2, "gloo")):
        t0 = time.perf_counter()
        out[key] = _check_multi(
            name, card, entry.dryrun_multichip(n, "cuda", backend=backend, timeout_s=300),
            whole, entry.sharded_ba(n, "cuda", cam, noisy, L, backend=backend, timeout_s=300),
            noisy_whole)
        log(f"[time] [multi] {name[:3]} {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    sweep_dir = tempfile.mkdtemp(prefix="sweep_", dir=os.path.join(ROOT, "build"))
    summ = sweep.main(["--spawn", "2", "--seeds", "0", "--runs", "2", "--frames",
                       str(SWEEP_FRAMES), "--device", "cuda", "--out", sweep_dir,
                       "--timeout", "400"])
    if (summ["n_ranks"] != 2 or sorted(map(tuple, summ["jobs"])) != [(0, 0), (0, 1)]
            or summ["max_err_m"] >= MAX_ERR_M):
        raise RuntimeError(f"[multi] (c) sweep: {summ}")
    out["sweep"] = summ
    log(f"[multi] (c) sweep over 2 ranks, merged on rank 0: {json.dumps(summ)} on {card}")
    log(f"[time] [multi] (c) {time.perf_counter() - t0:.1f}s")

    fn, args = entry.entry(device)
    fn(*args)
    torch.cuda.synchronize()
    reset_launches()
    res = fn(*args).cpu().numpy()
    launches = read_launches()
    if not np.isfinite(res[:7]).all() or res[7] <= 0 or min(launches[k] for k in
                                                          ("K1", "K2", "K3")) <= 0:
        raise RuntimeError(f"[multi] (d) entry: pose {res[:7]}, inliers {res[7]}, "
                           f"launches {launches}")
    out["entry"] = dict(q=res[:4].tolist(), t=res[4:7].tolist(), inliers=int(res[7]),
                        anchors=int(res[9]), launches=launches)
    log(f"[multi] (d) entry: {json.dumps(out['entry'])} on {card}")
    out["launches"] = {k: launches.get(k, 0) + summ["launches"].get(k, 0) for k in KERNELS}
    log(f"[multi] {time.perf_counter() - t_phase:.1f}s on {card}")
    return out


class _Made:
    """Every `GMMLocSystem` a module constructs while the `with` lasts (the
    module's name for the class is wrapped and restored), each with
    `step_s`: the host time of each of its `step` calls."""

    def __init__(self, mod):
        self.mod, self.systems = mod, []

    def __enter__(self):
        cls = self.mod.GMMLocSystem

        def make(*a, **kw):
            system = cls(*a, **kw)
            inner, system.step_s = system.step, []

            def step(*sa, **skw):
                t0 = time.perf_counter()
                st = inner(*sa, **skw)
                system.step_s.append(time.perf_counter() - t0)
                return st

            system.step = step
            self.systems.append(system)
            return system

        self.cls, self.mod.GMMLocSystem = cls, make
        return self.systems

    def __exit__(self, *exc):
        self.mod.GMMLocSystem = self.cls


def _tum_check(name, path, ts, t_wc, start, n, gate):
    """A run's TUM file: one row per frame with the ground truth's
    timestamps; returns the max camera-centre error (m), held under
    `gate`."""
    import numpy as np

    from gmmloc_tpu_torch.eval import ate

    t_est, p_est, _ = ate.load_tum(path)
    if len(t_est) != n or not np.allclose(t_est, ts[start:start + n], rtol=0, atol=1e-6):
        raise RuntimeError(f"[eval] {name}: {len(t_est)} TUM rows for {n} frames, or "
                           "timestamps other than the ground truth's")
    err = float(np.linalg.norm(p_est - t_wc[start:start + n], axis=1).max())
    if not err < gate:
        raise RuntimeError(f"[eval] {name}: max camera-centre error {err:.4f} m >= {gate} m")
    return err


def _eval_runs(name, tool, out_dir, n, traj, start, gate, systems, needed, launches):
    """The checks of one `evaluate`/`evaluate_image` (`tool`) call:
    summary.json with the JAX tool's keys, every run complete with no lost
    frame, its TUM file and error, no BA window cap bound (`evaluate`
    records the BA windows), the kernels launched, the
    mapper drained and joined. Returns per run frames/s (the tool's), p50
    and p95 of the host time per `step` call, rmse and max error."""
    import numpy as np

    from gmmloc_tpu_torch.eval import evaluate

    with_ba = tool is evaluate
    with open(os.path.join(out_dir, "summary.json")) as f:
        written = json.load(f)
    ts, _, t_wc = traj
    runs = written["V1_01_easy"]["runs"]
    out = []
    for r, (m, system) in enumerate(zip(runs, systems)):
        missing = [k for k in tool.RUN_KEYS if k not in m]
        ba = m.get("ba_stats", {})
        if missing or (with_ba and sorted(ba) != sorted(evaluate.BA_STATS_KEYS)):
            raise RuntimeError(f"[eval] {name} run {r}: keys missing {missing}, "
                               f"ba_stats {sorted(ba)}")
        if not (m["completed"] and m["frames"] == n and m["lost"] == 0):
            raise RuntimeError(f"[eval] {name} run {r}: {m}")
        if with_ba and ba["caps_bound"] != 0:
            raise RuntimeError(f"[eval] {name} run {r}: a BA window cap bound "
                               f"{ba['caps_bound']} times")
        if system.online is not None and (system.online.count_queue()
                                          or system.online._thread is not None):
            raise RuntimeError(f"[eval] {name} run {r}: the mapper was not drained")
        err = _tum_check(f"{name} run {r}", os.path.join(out_dir, f"V1_01_easy{r}.txt"),
                         ts, t_wc, start, n, gate)
        step_ms = np.array(system.step_s) * 1e3
        out.append(dict(fps=m["fps"], p50_ms=float(np.percentile(step_ms, 50)),
                        p95_ms=float(np.percentile(step_ms, 95)), rmse_m=m["rmse"],
                        max_err_m=err, kfs=m["kfs"], ba_solves=ba.get("n_solves"),
                        tiers=ba.get("tiers")))
    if len(runs) != len(systems):
        raise RuntimeError(f"[eval] {name}: {len(runs)} runs, {len(systems)} systems")
    for k in needed:
        if launches[k] <= 0:
            raise RuntimeError(f"[eval] {name}: {k} was not launched")
    return out


class _RelocAttempts:
    """Every `Relocalizer.relocalize` call while the `with` lasts: the
    frame, the outcome and the relocalizer's `last_stats` (per candidate
    keyframe: matches and inliers of the pose solve, then the share of
    stereo points consistent with the prior map where the solve kept
    `min_inliers`), with the relocalizer's two thresholds."""

    def __enter__(self):
        from gmmloc_tpu_torch.tracking import relocalize

        self.calls, self.cls = [], relocalize.Relocalizer
        inner = self.inner = self.cls.relocalize

        def relocalize_(rel, frame):
            ok = inner(rel, frame)
            self.calls.append(dict(frame=int(frame.idx), ok=bool(ok),
                                   stats=list(rel.last_stats),
                                   min_inliers=rel.min_inliers,
                                   min_share=rel.gmm_consistency_min))
            return ok

        self.cls.relocalize = relocalize_
        return self.calls

    def __exit__(self, *exc):
        self.cls.relocalize = self.inner


def _reloc_gate(rel: dict, attempts: list) -> dict:
    """`reloc_under_stress`'s gate. It must go lost and try to relocalize.
    Recovered: the median error after the recovery under RELOC_MAX_ERR_M.
    Not recovered: only if place recognition and the pose solve found the
    map (a candidate with `min_inliers` inliers) and the prior-map
    consistency check (`Relocalizer._gmm_consistent`: a share of the
    frame's stereo points within chi2 16 of their nearest component) turned
    down every such candidate. The room fixture's flat tiles (1 mm normal
    sigma against centimetres of stereo depth noise) leave that share at
    its 0.25 threshold, and the 10x map moves it under (ROADMAP queue 3 y).
    Returns the counts it read."""
    solved, rejected = 0, []
    for call in attempts:
        st = call["stats"]
        for i, e in enumerate(st):
            if isinstance(e[0], int) and e[2] >= call["min_inliers"]:
                solved += 1
                if not call["ok"]:
                    nxt = st[i + 1] if i + 1 < len(st) else (None, None)
                    rejected.append(nxt[1] if nxt[0] == "gmm_frac" else None)
    share = attempts[0]["min_share"] if attempts else None
    out = dict(relocalize_calls=len(attempts), solved_candidates=solved,
               rejected_by_consistency=len(rejected),
               consistency_max=max((x for x in rejected if x is not None), default=None),
               consistency_min_share=share)
    if not rel["went_lost"] or not attempts:
        raise RuntimeError(f"[eval] (e) reloc_under_stress: {rel}, {len(attempts)} "
                           "relocalize calls")
    if rel["relocalized"]:
        if not rel["post_recovery_median_err_m"] < RELOC_MAX_ERR_M:
            raise RuntimeError(f"[eval] (e) reloc_under_stress: {rel}")
    elif solved == 0 or any(x is None or x >= share for x in rejected):
        raise RuntimeError(f"[eval] (e) reloc_under_stress did not recover and not for the "
                           f"consistency check alone: {rel}, {out}")
    return out


def run_eval_phase(device, card) -> dict:
    """[eval]: the entry layer (`gmmloc_tpu_torch/eval/`) through its
    `main`s, as a user calls them, on a room fixture standing in for the
    EuRoC assets (`synthetic.GT_DIR`/`V1_GMM` pointed at it): (a) the
    evaluation protocol offline (EVAL_RUNS x EVAL_FRAMES, `--reloc 1`,
    the vocabulary trained once) and online (`--online --pace 20`); (b)
    the image-level protocol at full width; (c) the per-frame diagnosis;
    (d) the map viewer from a checkpoint of (a)'s last world; (e) the
    dense-map stress run at 10x, sharded over two gloo ranks, then its
    relocalization at 10x (`_reloc_gate`) and at 1x. Each step logs
    `[eval] <step> start` before it runs.
    Returns {path: out} with the launches of each path."""
    import shutil

    from gmmloc_tpu_torch.eval import (diagnose, evaluate, evaluate_image, room_fixture,
                                       slice_run, stress, synthetic, view_map)
    from gmmloc_tpu_torch.pipeline import checkpoint

    t_phase = time.perf_counter()
    root = os.path.join(slice_run.default_fixture_dir(), "eval")
    n_traj = EVAL_START + EVAL_FRAMES + 50
    gmm_path, gt_path = room_fixture.write_room_fixture(root, n_components=N_COMPONENTS,
                                                        n_frames=n_traj)
    gt_dir = os.path.join(root, "gt")
    os.makedirs(gt_dir, exist_ok=True)
    shutil.copy(gt_path, os.path.join(gt_dir, "V1_01_easy.txt"))
    saved = (synthetic.GT_DIR, synthetic.V1_GMM, synthetic.V2_GMM)
    synthetic.GT_DIR, synthetic.V1_GMM, synthetic.V2_GMM = gt_dir, gmm_path, gmm_path
    outs = {}
    try:
        traj = synthetic.load_gt_trajectory(gt_path)

        def step(name):
            log(f"[eval] {name} start")
            return time.perf_counter()

        # (a) the protocol, offline then online
        t0 = step("(a) evaluate offline")
        evaluate._VOCAB_CACHE.clear()
        out_dir = os.path.join(root, "feature")
        reset_launches()
        with _Made(evaluate) as systems:
            evaluate.main(["--runs", str(EVAL_RUNS), "--frames", str(EVAL_FRAMES),
                           "--start", str(EVAL_START), "--damping", "0.9", "--reloc", "1",
                           "--out", out_dir])
        launches = read_launches()
        runs = _eval_runs("(a) offline", evaluate, out_dir, EVAL_FRAMES,
                          traj, EVAL_START, PROD_MAX_ERR_M, systems,
                          ("K1", "K2", "K3"), launches)
        if len(evaluate._VOCAB_CACHE) != 1:
            raise RuntimeError("[eval] (a) the vocabulary was not trained once and reused: "
                               f"{len(evaluate._VOCAB_CACHE)} cached")
        outs["eval_feature"] = dict(runs=runs, launches=launches,
                                    seconds=time.perf_counter() - t0)
        log(f"[eval] (a) offline {json.dumps(outs['eval_feature'])} on {card}")

        t0 = step("(a) evaluate online")
        out_dir = os.path.join(root, "online")
        reset_launches()
        with _Made(evaluate) as systems:
            evaluate.main(["--runs", "1", "--frames", str(EVAL_ONLINE_FRAMES), "--start",
                           str(EVAL_START), "--damping", "0.9", "--reloc", "1", "--online",
                           "--pace", "20", "--out", out_dir])
        launches = read_launches()
        runs = _eval_runs("(a) online", evaluate, out_dir, EVAL_ONLINE_FRAMES,
                          traj, EVAL_START, PROD_MAX_ERR_M, systems,
                          ("K1", "K2", "K3"), launches)
        if systems[0].online is None:
            raise RuntimeError("[eval] (a) online: the mapper thread did not run")
        outs["eval_online"] = dict(runs=runs, launches=launches,
                                   seconds=time.perf_counter() - t0)
        log(f"[eval] (a) online {json.dumps(outs['eval_online'])} on {card}")
        last_world = systems[-1].world

        # (b) the image-level protocol at full width
        t0 = step("(b) evaluate_image")
        out_dir = os.path.join(root, "image")
        reset_launches()
        with _Made(evaluate_image) as systems:
            evaluate_image.main(["--runs", "1", "--frames", str(EVAL_IMG_FRAMES),
                                 "--out", out_dir])
        launches = read_launches()
        runs = _eval_runs("(b) image", evaluate_image, out_dir, EVAL_IMG_FRAMES,
                          traj, 0, image_gate(), systems, tuple(KERNELS),
                          launches)
        if launches["K4"] < EVAL_IMG_FRAMES:
            raise RuntimeError(f"[eval] (b) K4 launched {launches['K4']} times for "
                               f"{EVAL_IMG_FRAMES} frames")
        cfg = systems[0].cfg
        outs["eval_image"] = dict(runs=runs, launches=launches, width=cfg.camera.width,
                                  height=cfg.camera.height,
                                  num_features=cfg.frame.num_features,
                                  levels=cfg.frame.num_levels,
                                  seconds=time.perf_counter() - t0)
        log(f"[eval] (b) image {json.dumps(outs['eval_image'])} on {card}")

        # (c) the per-frame diagnosis
        t0 = step("(c) diagnose")
        csv = os.path.join(root, "diag.csv")
        reset_launches()
        diag = diagnose.main(["--seq", "V1_01_easy", "--frames", str(DIAG_FRAMES),
                              "--start", str(EVAL_START), "--out", csv])
        launches = read_launches()
        with open(csv) as f:
            header = f.readline().strip()
            rows = [line.strip().split(",") for line in f if line.strip()]
        cols = header.split(",")
        res, nmot, ngmm = (cols.index(c) for c in ("res", "n_motion", "n_gmm_inl"))
        # the bootstrap keyframe (row 0) has no tracker diagnostics
        missing = [int(r[0]) for r in rows[1:] if r[res] == "1"
                   and (r[nmot] == "-1" or r[ngmm] == "-1")]
        if header != diagnose.HEADER or len(rows) != DIAG_FRAMES or missing:
            raise RuntimeError(f"[eval] (c) diagnose: header {header == diagnose.HEADER}, "
                               f"{len(rows)} rows, frames without diagnostics {missing[:10]}")
        for k in ("K1", "K2", "K3"):
            if launches[k] <= 0:
                raise RuntimeError(f"[eval] (c) diagnose: {k} was not launched")
        outs["diagnose"] = dict(rows=len(rows), tracked=diag["tracked"],
                                rmse_m=diag["ate"]["rmse"], n_lost=diag["n_lost"],
                                launches=launches, seconds=time.perf_counter() - t0)
        log(f"[eval] (c) diagnose {json.dumps(outs['diagnose'])} on {card}")

        # (d) the map viewer from a checkpoint of (a)'s last world
        t0 = step("(d) view_map")
        ckpt = os.path.join(root, "eval_world.npz")
        checkpoint.save_checkpoint(ckpt, last_world, frame_cursor=EVAL_ONLINE_FRAMES)
        html = view_map.main([ckpt, "--gmm", "v1", "--out", os.path.join(root, "map.html")])
        text = open(html).read()
        frusta = json.loads(text.split("const D = ", 1)[1].split(";\n", 1)[0])["frusta"]
        check_host_libs()
        vm = dict(html_bytes=len(text), html_keyframes=len(frusta) // 8,
                  keyframes=last_world.n_keyframes(), seconds=time.perf_counter() - t0)
        if vm["html_keyframes"] != vm["keyframes"] or len(frusta) % 8:
            raise RuntimeError(f"[eval] (d) view_map: {vm}")
        outs["view_map"] = vm
        log(f"[eval] (d) view_map {json.dumps(vm)} on {card}")

        # (e) the dense-map stress run
        t0 = step("(e) stress")
        reset_launches()
        st = stress.main([str(STRESS_FACTOR), "--ranks", "2"])
        sh = st["sharded"]
        if (st["K"] != STRESS_FACTOR * N_COMPONENTS or st["pad"] % 256
                or sh["differs"] or sh["size"] != 2):
            raise RuntimeError(f"[eval] (e) stress: K {st['K']}, pad {st['pad']}, the "
                               f"sharded run differs in {sh['differs']}")
        keep = ("render_ms", "assoc_ms")
        sout = dict(K=st["K"], pad=st["pad"], map_bytes=st["map_bytes"],
                    build_s=st["build_s"], visible=int(st["single"]["visible"].sum()),
                    single={k: st["single"][k] for k in keep},
                    sharded_gloo2={k: sh[k] for k in keep},
                    sharded_collectives=dict(render=sh["render_collectives"],
                                             assoc=sh["assoc_collectives"]))
        log(f"[eval] (e) stress {json.dumps(sout)} on {card}")
        t1 = step("(e) reloc_under_stress")
        with _RelocAttempts() as attempts:
            rel = stress.reloc_under_stress(STRESS_FACTOR, device=device)
        gate = _reloc_gate(rel, attempts)
        t_1x = step("(e) reloc_under_stress 1x")
        rel1 = stress.reloc_under_stress(1, device=device)
        launches = read_launches()
        if not (rel1["went_lost"] and rel1["relocalized"]
                and rel1["post_recovery_median_err_m"] < RELOC_MAX_ERR_M):
            raise RuntimeError(f"[eval] (e) reloc_under_stress(1): {rel1}")
        for k in ("K1", "K2", "K3"):
            if launches[k] <= 0:
                raise RuntimeError(f"[eval] (e) reloc_under_stress: {k} was not launched")
        outs["stress"] = dict(sout, reloc=dict(rel, **gate, seconds=t_1x - t1),
                              reloc_1x=dict(rel1, seconds=time.perf_counter() - t_1x),
                              launches=launches, seconds=time.perf_counter() - t0)
        log(f"[eval] (e) reloc_under_stress({STRESS_FACTOR}) {json.dumps(outs['stress']['reloc'])}; "
            f"neighbour graph and map built on the host in {rel['map_build_s']} s; "
            f"1x: {json.dumps(rel1)} on {card}")
    finally:
        synthetic.GT_DIR, synthetic.V1_GMM, synthetic.V2_GMM = saved
    f = outs["eval_feature"]["runs"]
    on, im = outs["eval_online"]["runs"][0], outs["eval_image"]["runs"][0]
    log(f"[result] eval: offline {[round(r['fps'], 2) for r in f]} frames/s, p50/p95 "
        f"{[(round(r['p50_ms'], 1), round(r['p95_ms'], 1)) for r in f]} ms, rmse "
        f"{[round(r['rmse_m'] * 100, 2) for r in f]} cm; online {on['fps']:.2f} frames/s, "
        f"p50/p95 {on['p50_ms']:.1f}/{on['p95_ms']:.1f} ms, rmse {on['rmse_m'] * 100:.2f} cm; "
        f"image {im['fps']:.2f} frames/s, p50/p95 {im['p50_ms']:.1f}/{im['p95_ms']:.1f} ms, "
        f"rmse {im['rmse_m'] * 100:.2f} cm, max error "
        f"{im['max_err_m'] * 100:.2f} cm; stress K="
        f"{outs['stress']['K']} render {outs['stress']['single']['render_ms']:.3f} ms, "
        f"association {outs['stress']['single']['assoc_ms']:.3f} ms (two gloo ranks "
        f"{outs['stress']['sharded_gloo2']['render_ms']:.3f} / "
        f"{outs['stress']['sharded_gloo2']['assoc_ms']:.3f} ms) on {card}")
    log(f"[time] [eval] {time.perf_counter() - t_phase:.1f}s")
    return outs


def run_bench_phase(card) -> dict:
    """[bench]: `eval/bench.py`'s `main` at BENCH_LINES' frame counts (the
    end-to-end lines in child processes, the components here). Returns
    {path: {"launches": ...}} for the bench's lines and its components."""
    from gmmloc_tpu_torch.eval import bench, slice_run

    t_phase = time.perf_counter()
    argv = ["--fixture", os.path.join(slice_run.default_fixture_dir(), "bench")]
    for line, (n, warm) in BENCH_LINES.items():
        argv += [f"--{line}-frames", str(n), f"--{line}-warm", str(warm)]
    log(f"[bench] start: eval.bench.main({' '.join(argv)})")
    reset_launches()
    res = bench.main(argv)
    read_launches()
    if res is None:
        raise RuntimeError("[bench] a child of the bench failed (its output above)")
    head, detail = res["headline"], res["detail"]
    missing = [k for k in bench.DETAIL_KEYS + bench.PERCENTILE_KEYS if k not in detail]
    if sorted(head) != sorted(bench.HEADLINE_KEYS) or head["metric"] != bench.METRIC or missing:
        raise RuntimeError(f"[bench] headline {head}; detail keys missing {missing}")
    if detail["e2e_status"] != "ok":
        raise RuntimeError(f"[bench] e2e_status {detail['e2e_status']!r}")
    outs = {}
    for line, st in res["lines"].items():
        caps = st["prewarm_ba_graph_captures"]
        if not st["drained"] or not caps or min(caps.values()) < 1:
            raise RuntimeError(f"[bench] {line}: mapper drained {st['drained']}, prewarm "
                               f"graph captures per BA tier {caps}")
        need = ("K1", "K2", "K3", "K4") if line == "image" else ("K1", "K2", "K3")
        if [k for k in need if st["launches"][k] <= 0] or (
                line == "image" and st["launches"]["K4"] < st["frames"]):
            raise RuntimeError(f"[bench] {line}: launches {st['launches']} over "
                               f"{st['frames']} frames")
        # the child's K3 shapes join the paths' exactness check
        shapes = {tuple(s) for s in st["k3_shapes"]}
        if not shapes:
            raise RuntimeError(f"[bench] {line}: the child reported no K3 shapes")
        PATH_K3_SHAPES.update(shapes)
        outs[f"bench_{line}"] = dict(launches=st["launches"], k3_shapes=len(shapes))
    comp = res["component_launches"]
    if [k for k in ("K1", "K2", "K3") if comp[k] <= 0]:
        raise RuntimeError(f"[bench] components: launches {comp}")
    outs["bench_components"] = dict(launches=comp)
    log(f"[result] bench: {json.dumps(head)}; offline {detail['e2e_offline_fps']} frames/s, "
        f"image {detail['image_path_fps']} frames/s; components (ms) "
        + json.dumps({k: detail[k] for k in ("match_ms", "pose_opt_ms", "fused_track_step_ms",
                                             "render_view_ms", "search_corr_ms",
                                             "local_ba_ms")}) + f" on {card}")
    log(f"[time] [bench] {time.perf_counter() - t_phase:.1f}s")
    return outs


def check_host_libs():
    """No PIL, PyYAML or matplotlib: the machines with the card have none."""
    mods = sorted(m for m in ("PIL", "yaml", "matplotlib") if m in sys.modules)
    if mods:
        raise RuntimeError(f"the port imported {mods}")


def check_path_shapes(device, card) -> dict:
    """K3 exact against its plain version at every (N, M) the paths
    launched it at (the triangulation searches' N1 x T*N2 for each
    neighbour count T, each fusion job's B x F, the matchers' shapes)."""
    from gmmloc_tpu_torch.eval import kernel_check

    bad = []
    for n, m in sorted(PATH_K3_SHAPES):
        r = kernel_check.check_hamming_kernel(n, m, device, timing=False)
        if not r["ok"]:
            bad.append(r)
    out = dict(shapes=len(PATH_K3_SHAPES), exact=not bad,
               largest=max(PATH_K3_SHAPES, key=lambda s: s[0] * s[1]))
    log(f"[kernel] K3 at the paths' shapes {json.dumps(out)} on {card}")
    if bad:
        raise RuntimeError(f"K3 is not exact at the paths' shapes: {bad[:3]}")
    return out


def check_imports(jax_before: bool):
    """No JAX (unless the interpreter had it loaded before the port was
    imported), and no module of the JAX package."""
    if "jax" in sys.modules and not jax_before:
        raise RuntimeError("the port imported jax")
    mods = sorted(m for m in sys.modules if m.split(".")[0] == "gmmloc_tpu")
    if mods:
        raise RuntimeError(f"the port imported JAX-package modules: {mods}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "gmmloc_tpu_torch")):
        print("chip_smoke: run from the repository (gmmloc_tpu_torch/ is missing)",
              file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    jax_before = "jax" in sys.modules
    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend
    from gmmloc_tpu_torch.pipeline.system import set_numerics
    from gmmloc_tpu_torch.utils import cuda_build

    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}")
    device = torch.device("cuda", 0)
    set_numerics()

    t0 = time.perf_counter()
    cuda_build.load()
    log(f"[build] {time.perf_counter() - t0:.1f}s "
        f"(nvcc {cuda_build.build_seconds}s, one process per source) -> "
        f"{cuda_build.library_path()} on {card}")

    t0 = time.perf_counter()
    img_cfg = slice_run.image_config()
    img_inputs = slice_run.make_image_inputs(
        img_cfg, os.path.join(slice_run.default_fixture_dir(), "image"),
        IMG_WARMUP + IMG_MEASURED, n_components=N_COMPONENTS,
        n_landmarks=IMG_LANDMARKS, device=device)
    log(f"[image] set-up {time.perf_counter() - t0:.1f}s: {len(img_inputs[1])} "
        f"rendered {img_cfg.camera.width}x{img_cfg.camera.height} uint8 stereo pairs, "
        f"{IMG_LANDMARKS} sprite landmarks, on {card}")
    atlas = first_pair_atlas(ImageFrontend(img_cfg, device=device), img_inputs[1], device)

    kern = check_kernels(device, card, atlas)
    log(f"[time] {time.perf_counter() - t_start:.1f}s to the end of the kernel checks")
    main_out, feature_inputs = run_feature_path(device, card)
    log(f"[result] feature path: {main_out['fps']:.2f} tracked frames/s, p50 "
        f"{main_out['p50_ms']:.1f} ms, p95 {main_out['p95_ms']:.1f} ms per frame "
        f"on {card}")
    img_out, img_traj = run_image_path(device, card, img_cfg, *img_inputs)
    log(f"[result] image path: {img_out['fps']:.2f} tracked frames/s, p50 "
        f"{img_out['p50_ms']:.1f} ms, p95 {img_out['p95_ms']:.1f} ms per frame, "
        f"front end {img_out['frontend_ms_mean']:.2f} ms/frame (CUDA events), max error "
        f"{img_out['max_err_m'] * 100:.2f} cm, {img_out['keyframes']} keyframes, "
        f"launches K3 {img_out['launches']['K3']} K4 {img_out['launches']['K4']} "
        f"on {card}")
    log(f"[time] {time.perf_counter() - t_start:.1f}s to the end of the slice paths")
    prod = run_production_phase(device, card, feature_inputs, img_inputs)
    log(f"[time] {time.perf_counter() - t_start:.1f}s to the end of [production]")
    prod.update(run_reloc_phase(device, card))
    log(f"[time] {time.perf_counter() - t_start:.1f}s to the end of [reloc]")
    prod["loop"] = run_loop_phase(device, card)
    log(f"[time] {time.perf_counter() - t_start:.1f}s to the end of [loop]")
    disk = run_disk_phase(device, card, img_cfg, img_inputs, img_traj)
    check_host_libs()
    log(f"[time] {time.perf_counter() - t_start:.1f}s to the end of [disk]")
    multi = run_multi_phase(device, card)
    log(f"[time] {time.perf_counter() - t_start:.1f}s to the end of [multi]")
    evals = run_eval_phase(device, card)
    log(f"[time] {time.perf_counter() - t_start:.1f}s to the end of [eval]")
    benches = run_bench_phase(card)
    log(f"[time] {time.perf_counter() - t_start:.1f}s to the end of [bench]")
    k3_paths = check_path_shapes(device, card)
    log(f"[time] {time.perf_counter() - t_start:.1f}s in all")
    check_imports(jax_before)

    table = []
    for key, (fn, src, rep) in KERNELS.items():
        k = kern[key]
        table.append(dict(
            name=f"{key} {fn}", route="cuda", source=src, replaces=rep,
            launches=img_out["launches"][key],
            launches_by_path=dict(feature=main_out["launches"][key],
                                  image=img_out["launches"][key],
                                  **{n: o["launches"][key] for n, o in prod.items()},
                                  **{n: disk[n]["launches"][key]
                                     for n in ("disk", "disk_octree")},
                                  entry=multi["entry"]["launches"][key],
                                  multi=multi["launches"][key],
                                  **{n: evals[n]["launches"][key]
                                     for n in ("eval_feature", "eval_online", "eval_image",
                                               "diagnose", "stress")},
                                  **{n: o["launches"][key] for n, o in benches.items()}),
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k["library_ms"], shape=k["shape"],
            **{x: v for x, v in k.items()
               if x.startswith("ms_") or x in ("step_us", "feature_ns_per_step",
                                               "survivor_share",
                                               "dense_image_survivor_share")},
            **({"path_shapes_exact": k3_paths["shapes"]} if key == "K3" else {})))
    log(card)
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
