#!/usr/bin/env python3
"""Sweep of the feature kernels K3 (Hamming) and K4 (FAST + NMS) on one NVIDIA GPU.

    python3 tools/feature_kernel_sweep.py [--variants 0,2,3]
        [--old-hamming path/to/an/earlier/hamming.cu]
        [--old-fast path/to/an/earlier/fast_nms.cu]
        [--out chiprun_out/feature_sweep.json]

Builds, each into its own library under `build/feature_sweep/` with
`nvcc -Xptxas -v` (registers, shared memory and spills are printed), all
nvcc processes started together:

  - `gmmloc_tpu_torch/csrc/hamming.cu` and `gmmloc_tpu_torch/csrc/fast_nms.cu`
    as the package ships them;
  - `tools/hamming_variants.cu`, the other ways to compute a tile of K3
    that were tried, once per `GMMLOC_HAMMING_VARIANT` of `--variants`
    (0: 8 popc per pair, 1: 1-bit tensor cores as shipped, 2: int8 tensor
    cores, 3: carry-save, 4 popc per pair);
  - with `--old-hamming` / `--old-fast`, an earlier version of either
    kernel with the same C interface (saved from git).

For every build: exactness against the plain PyTorch version (K3 on
4096x1280, its transpose, 1280x1280, 1200x1200, 37x100, 1x65, 70x67; K4
on a random-integer 480x752 image, 96x130, 33x70, the stacked stereo atlas
of a rendered pair and the densest-surviving image at the atlas's size),
and device ms at the main path's shapes, the launches queued behind a
spin kernel: over a ring of outputs larger than the L2 (`ms`) and into one
buffer (`ms_l2`). The old kernels run first and last, so a drift of the
card shows. One more build of K4 with `GMMLOC_FAST_PROFILE` prints, per
image, the SM cycles of each phase of a block and how many blocks were
alive at once. Prints one JSON line per build and shape, and the card's name
and power limit; a build that nvcc refuses is reported and left out; exits
non-zero if any build failed or disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

K3_TIMED = ((4096, 1280), (1280, 1280), (1200, 1200))
K3_EXACT_ONLY = ((1280, 4096), (37, 100), (1, 65), (70, 67))
VARIANT_NAMES = {0: "popc8", 1: "mma_b1", 2: "mma_s8", 3: "carry_save"}


def build_all(jobs, build_dir):
    """jobs: name -> (source, [extra nvcc flags]). One library each."""
    from gmmloc_tpu_torch.utils import cuda_build

    os.makedirs(build_dir, exist_ok=True)
    nvcc = cuda_build._nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, (src, flags) in jobs.items():
        lib = os.path.join(build_dir, f"lib_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        print(f"[build] {name} rc={p.returncode}\n{log.strip()}", flush=True)
        if p.returncode != 0:
            failed.append(name)
        else:
            libs[name] = lib
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f}s", flush=True)
    return libs, failed


def hamming_from(lib):
    """The C function `gmmloc_hamming` of another library, with the
    package wrapper's calling convention and launch count."""
    import torch

    from gmmloc_tpu_torch.utils import cuda_build

    dll = cuda_build.bind(lib, ("gmmloc_hamming",))

    def fn(a, b, out=None):
        n, m = a.shape[0], b.shape[0]
        if out is None:
            out = torch.empty(n, m, dtype=torch.int32, device=a.device)
        err = dll.gmmloc_hamming(a.data_ptr(), b.data_ptr(), n, m, out.data_ptr(),
                                 torch.cuda.current_stream(a.device).cuda_stream)
        cuda_build.check(err, "gmmloc_hamming")
        fn.launches += 1
        return out

    fn.launches = 0
    return fn


def fast_from(lib):
    import torch

    from gmmloc_tpu_torch.utils import cuda_build

    dll = cuda_build.bind(lib, ("gmmloc_fast_nms",))

    def fn(img, out=None):
        if out is None:
            out = torch.empty_like(img)
        err = dll.gmmloc_fast_nms(img.data_ptr(), img.shape[0], img.shape[1], out.data_ptr(),
                                  torch.cuda.current_stream(img.device).cuda_stream)
        cuda_build.check(err, "gmmloc_fast_nms")
        fn.launches += 1
        return out

    fn.launches = 0
    return fn


PHASES = ("fill", "reject", "bright", "dark", "nms")


def fast_phase_profile(lib, img):
    """One launch of a GMMLOC_FAST_PROFILE build on `img`: per phase the
    mean SM cycles over the stamped blocks (thread 0's view, barriers
    included), and from the global timer the mean life of a block, the
    span from the first block's start to the last one's end and how many
    blocks were alive at once on average."""
    import ctypes

    import numpy as np
    import torch

    fn = fast_from(lib)
    dll = ctypes.CDLL(lib)
    dll.gmmloc_fast_nms_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dll.gmmloc_fast_nms_stamps.restype = ctypes.c_int
    for _ in range(3):
        fn(img)
    torch.cuda.synchronize()
    n = 4096
    st = np.zeros((n, 8), np.int64)
    if dll.gmmloc_fast_nms_stamps(st.ctypes.data, n) != 0:
        raise RuntimeError("gmmloc_fast_nms_stamps failed")
    st = st[st[:, 6] > 0]
    cyc = np.diff(st[:, :6], axis=1)
    life = (st[:, 7] - st[:, 6]).astype(np.float64)
    span = float(st[:, 7].max() - st[:, 6].min())
    return dict(blocks_stamped=int(len(st)),
                phase_cycles={k: float(cyc[:, i].mean()) for i, k in enumerate(PHASES)},
                block_cycles=float(cyc.sum(1).mean()), block_life_ns=float(life.mean()),
                span_ns=span, blocks_alive=float(life.sum() / span))


def rendered_atlas(device):
    """The stacked raw atlas (both images' pyramids) of one rendered
    752x480 stereo pair: K4's input on the image path."""
    import torch

    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend

    cfg = slice_run.image_config()
    images = slice_run.make_image_inputs(
        cfg, os.path.join(slice_run.default_fixture_dir(), "sweep"), 1,
        n_components=3300, device=device)[1]
    det = ImageFrontend(cfg, device=device).detector
    left, right = (torch.as_tensor(im).to(device).to(torch.float32) for im in images[0])
    return det.stacked_atlases(det.build_pyramid(left), det.build_pyramid(right))[0]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="0,2,3",
                    help="GMMLOC_HAMMING_VARIANT values of tools/hamming_variants.cu to build")
    ap.add_argument("--old-hamming", default=None, help="an earlier hamming.cu")
    ap.add_argument("--old-fast", default=None, help="an earlier fast_nms.cu")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "feature_sweep.json"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("feature_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    from gmmloc_tpu_torch.eval import kernel_check as kc
    from gmmloc_tpu_torch.pipeline.system import set_numerics
    from gmmloc_tpu_torch.utils import cuda_build

    set_numerics()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)

    ham_src = os.path.join(cuda_build.CSRC_DIR, "hamming.cu")
    fast_src = os.path.join(cuda_build.CSRC_DIR, "fast_nms.cu")
    variants_src = os.path.join(ROOT, "tools", "hamming_variants.cu")
    k3_jobs = {"k3_shipped": (ham_src, [])}
    for v in (int(x) for x in a.variants.split(",") if x):
        k3_jobs[f"k3_v{v}_{VARIANT_NAMES[v]}"] = (variants_src,
                                                  [f"-DGMMLOC_HAMMING_VARIANT={v}"])
    k4_jobs = {"k4_shipped": (fast_src, [])}
    k4_profile = {"k4_profile": (fast_src, ["-DGMMLOC_FAST_PROFILE"])}
    if a.old_hamming:
        k3_jobs["k3_old"] = (a.old_hamming, [])
    if a.old_fast:
        k4_jobs["k4_old"] = (a.old_fast, [])
    libs, failed = build_all({**k3_jobs, **k4_jobs, **k4_profile},
                             os.path.join(ROOT, "build", "feature_sweep"))

    def ordered(jobs, old):
        """The builds that compiled, the old kernel first and last."""
        names = [n for n in jobs if n != old and n in libs]
        return ([old] + names + [old]) if old in libs else names

    device = torch.device("cuda", 0)
    results, bad = [], []
    os.makedirs(os.path.dirname(a.out), exist_ok=True)

    def emit(r):
        r["card"] = card
        print(json.dumps(r), flush=True)
        results.append(r)
        with open(a.out, "w") as f:     # rewritten per line: a later fault keeps these
            json.dump(results, f, indent=1)
        if not r["ok"]:
            bad.append(f"{r['build']} {r['shape']}")

    for name in ordered(k3_jobs, "k3_old"):
        fn = hamming_from(libs[name])
        for shape in K3_TIMED + K3_EXACT_ONLY:
            r = kc.check_hamming_kernel(*shape, device, kernel=fn, yardsticks=False,
                                        timing=shape in K3_TIMED)
            emit(dict(build=name, kernel="K3", **r))

    images = {"480x752": kc.random_image(480, 752, device),
              "96x130": kc.random_image(96, 130, device, seed=1),
              "33x70": kc.random_image(33, 70, device, seed=2),
              "atlas": rendered_atlas(device)}
    images["dense"] = kc.dense_image(*images["atlas"].shape, device)
    for name in ordered(k4_jobs, "k4_old"):
        fn = fast_from(libs[name])
        for key, img in images.items():
            r = kc.check_fast_kernel(img, kernel=fn, yardsticks=False,
                                     timing=key in ("480x752", "atlas", "dense"))
            emit(dict(build=name, kernel="K4", image=key, **r))

    for name in k4_profile:
        for key in ("480x752", "atlas", "dense"):
            print(json.dumps(dict(build=name, image=key, card=card,
                                  **fast_phase_profile(libs[name], images[key]))), flush=True)
    print(card)
    if bad or failed:
        print(f"feature_kernel_sweep: not exact: {bad}; did not build: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
