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
     1280x1280, 4096x1280 and the stereo 1200x1200) exact; K4 (FAST +
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
     keyframes and the launches.

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
MIN_ANCHORED_SHARE = 0.9   # of the measured frames, K2 keeps > 0 GMM anchors

IMG_WARMUP = 20
IMG_MEASURED = 150
IMG_LANDMARKS = 9000
# the JAX package's own max camera-centre error on the same 170 image
# frames, from a CPU run of tools/torch_image_reference.py; the image
# path's gate is the larger of MAX_ERR_M and this + 1 cm
JAX_IMG_MAX_ERR_M = 0.029363626255594893

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


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
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
    for n, m in ((1280, 1280), (4096, 1280), (1200, 1200)):
        r = kernel_check.check_hamming_kernel(n, m, device)
        log(f"[kernel] K3 {n}x{m} {json.dumps(r)} on {card}")
        if not r["ok"]:
            raise RuntimeError(f"K3 is not exact: {r}")
        hs[(n, m)] = r
    main = hs[(4096, 1280)]
    res["K3"] = dict(max_abs_err=max(r["max_abs_err"] for r in hs.values()),
                     library_ms=main["library_ms"], shape="4096x1280",
                     ms_l2=main["ms_l2"],
                     ms_1280x1280=hs[(1280, 1280)]["ms"],
                     ms_1200x1200=hs[(1200, 1200)]["ms"],
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
    return out


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
    main_out = run_feature_path(device, card)
    log(f"[result] feature path: {main_out['fps']:.2f} tracked frames/s, p50 "
        f"{main_out['p50_ms']:.1f} ms, p95 {main_out['p95_ms']:.1f} ms per frame "
        f"on {card}")
    img_out = run_image_path(device, card, img_cfg, *img_inputs)
    log(f"[result] image path: {img_out['fps']:.2f} tracked frames/s, p50 "
        f"{img_out['p50_ms']:.1f} ms, p95 {img_out['p95_ms']:.1f} ms per frame, "
        f"front end {img_out['frontend_ms_mean']:.2f} ms/frame (CUDA events), max error "
        f"{img_out['max_err_m'] * 100:.2f} cm, {img_out['keyframes']} keyframes, "
        f"launches K3 {img_out['launches']['K3']} K4 {img_out['launches']['K4']} "
        f"on {card}")
    check_imports(jax_before)

    table = []
    for key, (fn, src, rep) in KERNELS.items():
        k = kern[key]
        table.append(dict(
            name=f"{key} {fn}", route="cuda", source=src, replaces=rep,
            launches=img_out["launches"][key],
            launches_by_path=dict(feature=main_out["launches"][key],
                                  image=img_out["launches"][key]),
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k["library_ms"], shape=k["shape"],
            **{x: k[x] for x in ("step_us", "feature_ns_per_step", "ms_l2",
                                 "ms_1280x1280", "ms_1200x1200", "survivor_share",
                                 "ms_480x752", "ms_dense_image",
                                 "dense_image_survivor_share") if x in k}))
    log(card)
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
