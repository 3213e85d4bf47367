#!/usr/bin/env python3
"""Sweep of the staged pose-solve kernels (K1/K2) on one NVIDIA GPU.

    python3 tools/pose_kernel_sweep.py [--clusters 1,2,4,8,16]
        [--old path/to/an/earlier/pose_solver.cu] [--out chiprun_out/pose_sweep.json]

Builds `gmmloc_tpu_torch/csrc/pose_solver.cu` once for each cluster size
(the source's `kCluster` constant replaced in a copy), and with `--old` an
earlier version of the kernel with the one-block C interface
(`gmmloc_pose_solve(pose0, ...)` writing a 16-float pose), each into its
own library under `build/pose_sweep/` with `nvcc -Xptxas -v` (registers
and spills are printed). For each variant, K1 and K2 at F=1280:

  - agreement with the plain PyTorch versions on seeds 0 and 3 (the gates
    of `eval/kernel_check.py`), and three launches bit-identical;
  - device ms of the full 4x10 solve, queued behind a spin kernel, and the
    same launches as the host paces them (the timing of earlier runs);
  - the step sweep of `kernel_check.step_sweep`: the per-step latency and
    the per-feature cost.

With `--ablate`, three more builds of the shipped cluster size each drop
one part of the GN step, to split the per-step latency: `no_solve` (the
6x6 solve and boxplus), `no_pass` (the per-feature residuals and sums),
`no_cluster` (the distributed-shared-memory exchange and the cluster
barrier, replaced by a block barrier). Their results are wrong by
construction; only their step sweeps are printed.

Prints one JSON line per variant, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OLD_SIG = "old"

# ablations: (variant, [(text in pose_solver.cu, replacement), ...])
ABLATIONS = {
    "no_solve": [("const bool done = gn_update(s, q, t, in.step_tol);",
                  "const bool done = s[0] != s[0];")],
    "no_pass": [("if (f[j].valid && !f[j].outlier) {", "if (false) {"),
                ("if (a.type != 0 && (use_huber || !a.outlier)) {", "if (false) {")],
    "no_cluster": [("*cluster.map_shared_rank(&slots[p][rank][lane], dst) = bs;",
                    "slots[p][dst][lane] = bs;"),
                   ("      cluster.sync();\n      float s[kSums];",
                    "      __syncthreads();\n      float s[kSums];")],
}


def build_variants(clusters, old_src, build_dir, ablate=False):
    """One library per variant, all nvcc processes started together."""
    from gmmloc_tpu_torch.utils import cuda_build

    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(cuda_build.CSRC_DIR, "pose_solver.cu")) as f:
        src = f.read()
    pat = re.compile(r"constexpr int kCluster = \d+;")
    if not pat.search(src):
        raise RuntimeError("pose_solver.cu has no `constexpr int kCluster = N;`")
    jobs = {}
    for c in clusters:
        path = os.path.join(build_dir, f"pose_c{c}.cu")
        with open(path, "w") as f:
            f.write(pat.sub(f"constexpr int kCluster = {c};", src))
        jobs[f"C={c}"] = path
    if ablate:
        for name, subs in ABLATIONS.items():
            text = src
            for a, b in subs:
                if a not in text:
                    raise RuntimeError(f"ablation {name}: {a!r} not in pose_solver.cu")
                text = text.replace(a, b)
            path = os.path.join(build_dir, f"pose_{name}.cu")
            with open(path, "w") as f:
                f.write(text)
            jobs[name] = path
    if old_src:
        jobs[OLD_SIG] = old_src
    nvcc = cuda_build._nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, path in jobs.items():
        lib = os.path.join(build_dir, f"lib_{name.replace('=', '')}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        print(f"[build] {name} rc={p.returncode}\n{log.strip()}", flush=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}")
        libs[name] = lib
    print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f}s", flush=True)
    return libs


def new_solver(lib, anchored):
    """K1/K2 through the package's wrapper code on another library."""
    from gmmloc_tpu_torch.solver import cuda_pose, pose_solver
    from gmmloc_tpu_torch.utils import cuda_build

    dll = cuda_build.bind(lib, ("gmmloc_pose_solve", "gmmloc_pose_max_features"))

    def solve(cam, q0, t0, x_w, obs, st, s2i, valid, *anc, rounds=4, iters=10,
              step_tol=1e-8):
        pose, counts, chi2, outl, anc_out = cuda_pose._launch(
            cam, q0, t0, x_w, obs, st, s2i, valid, tuple(anc) if anchored else None,
            rounds, iters, step_tol, lib=dll)
        if anchored:
            return pose_solver.PoseAnchorResult(pose[:4], pose[4:7], outl, counts[0],
                                                chi2, anc_out, counts[1], counts[2])
        return pose_solver.PoseOptResult(pose[:4], pose[4:7], outl, counts[0], chi2,
                                         counts[2])

    return solve


def old_solver(lib, anchored):
    """The one-block kernel's C interface: q0/t0 concatenated, a 16-float
    pose with the counts as floats."""
    import ctypes

    import torch

    from gmmloc_tpu_torch.solver import pose_solver
    from gmmloc_tpu_torch.utils import cuda_build

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll = ctypes.CDLL(lib)
    fn = dll.gmmloc_pose_solve
    fn.argtypes = [P] * 12 + [F, I, I, I, I, F] + [F] * 5 + [P] * 5
    fn.restype = ctypes.c_int

    def solve(cam, q0, t0, x_w, obs, st, s2i, valid, *anc, rounds=4, iters=10,
              step_tol=1e-8):
        dev = x_w.device
        n = x_w.shape[0]
        pose0 = torch.cat([q0, t0]).to(torch.float32).contiguous()
        pose = torch.empty(16, dtype=torch.float32, device=dev)
        chi2 = torch.empty(n, dtype=torch.float32, device=dev)
        outl = torch.empty(n, dtype=torch.bool, device=dev)
        anc_out = torch.empty(n, dtype=torch.bool, device=dev)
        if anchored:
            aptrs = [a.data_ptr() for a in anc[:6]]
            gate = float(anc[6])
        else:
            aptrs, gate = [x_w.data_ptr()] * 6, 0.0
        err = fn(pose0.data_ptr(), x_w.data_ptr(), obs.data_ptr(), st.data_ptr(),
                 s2i.data_ptr(), valid.data_ptr(), *aptrs, gate, n, int(anchored),
                 rounds, iters, step_tol, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                 pose.data_ptr(), chi2.data_ptr(), outl.data_ptr(), anc_out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(err, "gmmloc_pose_solve (old)")
        n_inl, n_anc, steps = (pose[k].to(torch.int32) for k in (7, 8, 9))
        if anchored:
            return pose_solver.PoseAnchorResult(pose[:4], pose[4:7], outl, n_inl, chi2,
                                                anc_out, n_anc, steps)
        return pose_solver.PoseOptResult(pose[:4], pose[4:7], outl, n_inl, chi2, steps)

    return solve


def measure(name, solve, anchored, cam, device, sweep: bool):
    import torch

    from gmmloc_tpu_torch.eval import kernel_check as kc
    from gmmloc_tpu_torch.solver import pose_solver

    plain = pose_solver.optimize_pose_anchored if anchored else pose_solver.optimize_pose
    gates = kc.K2_GATES if anchored else kc.K1_GATES
    res = dict(variant=name, kernel="K2" if anchored else "K1")
    for seed in (0, 3):
        args = kc.pose_args(kc.pose_problem(cam, 1280, seed=seed, anchored=anchored),
                            device, anchored)
        outs = [solve(cam, *args) for _ in range(3)]
        torch.cuda.synchronize()
        m = kc.compare_pose(plain(cam, *args), outs[0], anchored)
        res[f"seed{seed}"] = dict(ok=kc.within(m, gates), **m)
        res[f"seed{seed}"]["repeatable"] = all(
            torch.equal(a, b) for o in outs[1:] for a, b in zip(outs[0], o))
        if seed == 0:
            res["gn_iters"] = int(outs[0].gn_iters)
            res["ms"] = kc.time_cuda(lambda: solve(cam, *args), reps=50, queued=True)
            res["ms_host_paced"] = kc.time_cuda(lambda: solve(cam, *args), reps=20)
    if sweep:
        res["sweep"] = kc.step_sweep(cam, anchored, device, solve=solve)
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--clusters", default="1,2,4,8,16")
    ap.add_argument("--old", default=None, help="an earlier pose_solver.cu (one-block C interface)")
    ap.add_argument("--no-sweep", action="store_true", help="skip the step sweeps")
    ap.add_argument("--ablate", action="store_true",
                    help="also time the shipped kernel without each part of a GN step")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "pose_sweep.json"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("pose_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    from gmmloc_tpu_torch.config import euroc_v1_config
    from gmmloc_tpu_torch.geometry import camera as cam_mod
    from gmmloc_tpu_torch.pipeline.system import set_numerics

    set_numerics()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    clusters = [int(c) for c in a.clusters.split(",") if c]
    libs = build_variants(clusters, a.old, os.path.join(ROOT, "build", "pose_sweep"),
                          ablate=a.ablate)
    cam = cam_mod.CameraParams.from_config(euroc_v1_config().camera)
    device = torch.device("cuda", 0)
    results = []
    # the old kernel first and last, so a drift of the card shows
    order = ([OLD_SIG] if OLD_SIG in libs else []) + [f"C={c}" for c in clusters]
    if OLD_SIG in libs:
        order.append(OLD_SIG)
    for name in order:
        for anchored in (False, True):
            make = old_solver if name == OLD_SIG else new_solver
            r = measure(name, make(libs[name], anchored), anchored, cam, device,
                        sweep=not a.no_sweep)
            r["card"] = card
            print(json.dumps(r), flush=True)
            results.append(r)
    if a.ablate:
        from gmmloc_tpu_torch.eval import kernel_check as kc

        for name in ABLATIONS:
            for anchored in (False, True):
                r = dict(variant=name, kernel="K2" if anchored else "K1", card=card,
                         sweep=kc.step_sweep(cam, anchored, device,
                                             solve=new_solver(libs[name], anchored)))
                print(json.dumps(r), flush=True)
                results.append(r)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(results, f, indent=1)
    print(card)
    bad = [r["variant"] + " " + r["kernel"] for r in results if "seed0" in r
           and not all(r[s]["ok"] and r[s]["repeatable"] for s in ("seed0", "seed3"))]
    if bad:
        print(f"pose_kernel_sweep: disagreement or non-repeatable: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
