#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`gmmloc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

  1. the card: name and power limit (nvidia-smi);
  2. build: nvcc compiles `gmmloc_tpu_torch/csrc/*.cu` into
     `build/gmmloc_tpu_torch/`; prints the build seconds;
  3. kernels against their plain PyTorch versions on the card, at the
     main path's shapes: K1/K2 (staged pose solves, F=1280) within the
     pose gates, K3 (Hamming matrix, 1280x1280 and 4096x1280) exact;
     CUDA-event times of each kernel and its plain version;
  4. the main path: `GMMLocSystem.step` over the seeded V1-scale room
     fixture (1280 features/frame, 752x480, 3300 GMM components padded
     to 5120, 30000 landmarks), 25 warm-up + 200 measured frames; checks
     no tracking failure, max per-frame translation error < 5 cm against
     ground truth, > 1 keyframe, >= 1 local BA, and that K1, K2 and K3
     each launched during the run, and that K2 kept GMM anchors on at
     least 90% of the measured frames; prints tracked frames/s and
     p50/p95 frame times.

The line before the last is the kernel table as JSON; the last line is
`{"ok": true, "device": {...}}`. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
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

KERNELS = {
    "K1": ("optimize_pose", "gmmloc_tpu_torch/csrc/pose_solver.cu",
           "gmmloc_tpu/solver/pallas_pose.py:406"),
    "K2": ("optimize_pose_anchored", "gmmloc_tpu_torch/csrc/pose_solver.cu",
           "gmmloc_tpu/solver/pallas_pose.py:460"),
    "K3": ("hamming_matrix", "gmmloc_tpu_torch/csrc/hamming.cu",
           "gmmloc_tpu/features/pallas_kernels.py:44"),
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def check_kernels(device):
    from gmmloc_tpu_torch.config import euroc_v1_config
    from gmmloc_tpu_torch.eval import kernel_check
    from gmmloc_tpu_torch.geometry import camera as cam_mod

    cam = cam_mod.CameraParams.from_config(euroc_v1_config().camera)
    res = {}
    for key, anchored in (("K1", False), ("K2", True)):
        ms = []
        for seed in (0, 3):
            m = kernel_check.check_pose_kernel(cam, 1280, anchored, device, seed=seed,
                                               timing=seed == 0)
            log(f"[kernel] {key} seed={seed} F=1280 {json.dumps(m)}")
            if not m["ok"]:
                raise RuntimeError(f"{key} disagrees with its plain version: {m}")
            ms.append(m)
        res[key] = dict(max_abs_err=max(m["max_abs_err"] for m in ms),
                        ms=ms[0]["ms"], plain_ms=ms[0]["plain_ms"],
                        shape="F=1280")
    hs = []
    for n, m in ((1280, 1280), (4096, 1280)):
        r = kernel_check.check_hamming_kernel(n, m, device)
        log(f"[kernel] K3 {n}x{m} {json.dumps(r)}")
        if not r["ok"]:
            raise RuntimeError(f"K3 is not exact: {r}")
        hs.append(r)
    res["K3"] = dict(max_abs_err=max(r["max_abs_err"] for r in hs),
                     ms=hs[1]["ms"], plain_ms=hs[1]["plain_ms"],
                     shape="4096x1280", ms_1280x1280=hs[0]["ms"],
                     plain_ms_1280x1280=hs[0]["plain_ms"])
    return res


def run_main_path(device):
    import numpy as np

    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.features import cuda_kernels
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
    from gmmloc_tpu_torch.solver import cuda_pose

    n_frames = WARMUP + MEASURED
    t0 = time.perf_counter()
    cfg = slice_run.slice_config()
    gmap, frames, q_wc, t_wc = slice_run.make_inputs(
        cfg, device, slice_run.default_fixture_dir(), n_frames,
        n_components=N_COMPONENTS, n_landmarks=N_LANDMARKS)
    n_valid = int(np.mean([f.num_features() for f in frames]))
    log(f"[main] set-up {time.perf_counter() - t0:.1f}s: {N_COMPONENTS} components "
        f"(pad {cfg.caps.gmm_components_pad}), {N_LANDMARKS} landmarks, "
        f"{n_frames} frames, feat_cap {cfg.frame.feat_cap} "
        f"({n_valid} valid/frame), {cfg.camera.width}x{cfg.camera.height}")

    system = GMMLocSystem(cfg, gmap, device)
    slice_run.timing_table(reset=True)
    for fn in (cuda_pose.optimize_pose, cuda_pose.optimize_pose_anchored,
               cuda_kernels.hamming_matrix):
        fn.launches = 0
    ran = slice_run.run(system, frames, q_wc, t_wc, device)
    step_s, n_anchors = ran["step_s"], ran["n_anchors"][-MEASURED:]
    launches = {
        "K1": cuda_pose.optimize_pose.launches,
        "K2": cuda_pose.optimize_pose_anchored.launches,
        "K3": cuda_kernels.hamming_matrix.launches,
    }
    log(slice_run.timing_table())

    errs = slice_run.pose_errors(frames, t_wc)
    _, q_est, t_est = system.export_trajectory()
    n_kf = system.world.n_keyframes()
    n_ba = len(system.localizer.ba_stats)
    meas = step_s[WARMUP:]
    out = dict(
        frames=n_frames, measured=MEASURED, tracked=system.n_tracked,
        fps=MEASURED / float(meas.sum()),
        p50_ms=float(np.percentile(meas, 50) * 1e3),
        p95_ms=float(np.percentile(meas, 95) * 1e3),
        max_ms=float(meas.max() * 1e3), warmup_s=float(step_s[:WARMUP].sum()),
        max_err_m=float(errs.max()), mean_err_m=float(errs.mean()),
        keyframes=n_kf, points=system.world.n_points(), ba_solves=n_ba,
        ba_iters_last=system.localizer.last_ba_iters, launches=launches,
        anchored_frames=int((n_anchors > 0).sum()),
        anchors_mean=float(n_anchors.mean()), anchors_min=int(n_anchors.min()),
    )
    log(f"[main] {json.dumps(out)}")
    if not (np.isfinite(q_est).all() and np.isfinite(t_est).all()
            and len(t_est) == n_frames):
        raise RuntimeError("exported trajectory is not finite or incomplete")
    if errs.max() >= MAX_ERR_M:
        raise RuntimeError(f"max translation error {errs.max():.4f} m >= {MAX_ERR_M} m")
    if n_kf <= 1 or n_ba < 1:
        raise RuntimeError(f"mapping did not run: {n_kf} keyframes, {n_ba} BA solves")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{k} was not launched on the main path")
    # K2 launches on every frame, with or without anchors: the anchor
    # term ran only where the solve kept some
    if out["anchored_frames"] < MIN_ANCHORED_SHARE * len(n_anchors):
        raise RuntimeError(
            f"the GMM anchor term ran on {out['anchored_frames']} of the "
            f"{len(n_anchors)} last completed frames (need {MIN_ANCHORED_SHARE:.0%})")
    return out


# the jax-free host modules the port shares with the JAX package
SHARED = {
    "gmmloc_tpu", "gmmloc_tpu.config", "gmmloc_tpu.utils", "gmmloc_tpu.utils.proto",
    "gmmloc_tpu.utils.timing", "gmmloc_tpu.mapping", "gmmloc_tpu.mapping.map_state",
    "gmmloc_tpu.tracking", "gmmloc_tpu.tracking.frame",
}


def check_imports(jax_before: bool):
    """No JAX (unless the interpreter had it loaded before the port was
    imported), and nothing of the JAX package beyond the shared host
    modules."""
    if "jax" in sys.modules and not jax_before:
        raise RuntimeError("the port imported jax")
    extra = sorted(m for m in sys.modules
                   if m.split(".")[0] == "gmmloc_tpu" and m not in SHARED)
    if extra:
        raise RuntimeError(f"the port imported JAX-package modules: {extra}")


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
    from gmmloc_tpu_torch.pipeline.system import set_numerics
    from gmmloc_tpu_torch.utils import cuda_build

    card = card_line()
    log(f"[card] {card}")
    device = torch.device("cuda", 0)
    set_numerics()

    t0 = time.perf_counter()
    cuda_build.load()
    log(f"[build] {time.perf_counter() - t0:.1f}s "
        f"(nvcc {cuda_build.build_seconds}s) -> {cuda_build.library_path()}")

    kern = check_kernels(device)
    main_out = run_main_path(device)
    log(f"[result] {main_out['fps']:.2f} tracked frames/s, p50 "
        f"{main_out['p50_ms']:.1f} ms, p95 {main_out['p95_ms']:.1f} ms per frame "
        f"on {card}")
    check_imports(jax_before)

    table = []
    for key, (fn, src, rep) in KERNELS.items():
        k = kern[key]
        table.append(dict(
            name=f"{key} {fn}", route="cuda", source=src, replaces=rep,
            launches=main_out["launches"][key], max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], shape=k["shape"]))
    log(card)
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
