"""The readings the limits of `correct` are set from, on the card at a
cell's own size: the checks' numbers of sound runs, of every control and
of faults planted in the program, several seeds in one process.

    python3 -m portbench.probe --workload <cell> --seeds <n,n,...> --seconds <s> \
        [--faults ba_unchanged,assoc_altered,pose_half_batch] [--out <file.jsonl>]

Each seed: one run of the cell (`run.run_cell`, a short window at the
cell's load), its checks' numbers, then each check's every control
(`CONTROLS`) on the same captured sample. Each fault: one more run with
the fault planted in the program from the window's start, its numbers
and `correct`. One JSON line per reading on stdout (and in `--out`).
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import run


def _set(module, name: str, new) -> None:
    """module.<name> = new, keeping the entry's attributes (a kernel
    wrapper's launch counter)."""
    new.__dict__.update(getattr(getattr(module, name), "__dict__", {}))
    setattr(module, name, new)


def _plant(fault: str):
    """The fault, planted in the program's module attribute that the
    timed path looks up (and the checks wrap)."""
    import torch

    from gmmloc_tpu_torch.mapping import association
    from gmmloc_tpu_torch.solver import cuda_pose, local_ba

    if fault == "ba_unchanged":
        orig = local_ba.solve_local_ba

        def ba(cam, prob, n_free, **kw):
            out = orig(cam, prob, n_free, **kw)
            return out._replace(cam_q=prob.cam_q.clone(), cam_t=prob.cam_t.clone(),
                                pts=prob.pts.clone())
        _set(local_ba, "solve_local_ba", ba)
    elif fault == "assoc_altered":
        orig_a = association.associate_and_check_kernel

        def kernel(*a, **kw):
            cand, assoc, pt = orig_a(*a, **kw)
            # every accepted association moved to the next component
            return cand, torch.where(assoc >= 0, assoc + 1, assoc), pt
        _set(association, "associate_and_check_kernel", kernel)
    elif fault == "pose_half_batch":
        orig_p = cuda_pose.optimize_pose_anchored

        def solve(cam, q0, t0, x_w, obs, st, s2i, valid, *a, **kw):
            half = valid.clone()
            half[1::2] = False
            return orig_p(cam, q0, t0, x_w, obs, st, s2i, half, *a, **kw)
        _set(cuda_pose, "optimize_pose_anchored", solve)
    else:
        raise SystemExit(f"unknown fault {fault!r}")


def _record_association(calls: list) -> None:
    """Keep every keyframe association of the window (its inputs and
    outputs, on the host), beside the check's sample."""
    from gmmloc_tpu_torch.mapping import association

    orig = association.associate_and_check_kernel

    def kernel(gmap, cam, *args, **kw):
        out = orig(gmap, cam, *args, **kw)
        calls.append(dict(zip(("q_cw", "t_cw", "uv", "ur", "octave", "valid", "depth"),
                              (x.cpu() for x in args)),
                          cand=out[0].cpu(), assoc=out[1].cpu(), pt_out=out[2].cpu()))
        return out
    _set(association, "associate_and_check_kernel", kernel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--save", default=None,
                    help="a directory: keep each seed's captured BA problems and pose solves, "
                         "and every keyframe association of its window, there (torch.save), "
                         "for reading their numbers again on a CPU")
    a = ap.parse_args(argv)
    run.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("portbench.probe: no CUDA card", file=sys.stderr)
        return 2
    out = open(a.out, "a") if a.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    seeds = [int(s) for s in a.seeds.split(",") if s]
    for seed in seeds:
        from gmmloc_tpu_torch.mapping import association

        kept, assoc_calls = {}, []
        orig = association.associate_and_check_kernel
        try:
            res, compared, r = run.run_cell(
                a.workload, seed, a.seconds, False, kept_out=kept,
                before_window=(lambda: _record_association(assoc_calls)) if a.save else None)
        finally:
            association.associate_and_check_kernel = orig
        emit(dict(workload=a.workload, seed=seed, kind="sound", correct=res["correct"],
                  frames=r.frames, numbers={k: v for k, (v, _) in compared.items()}))
        cell = run.find_cell(run.load_json(os.path.join(run.ROOT, "BENCHMARK.json")),
                             a.workload)
        traffic = run.load_json(os.path.join(run.HERE, "traffic", cell["traffic"] + ".json"))
        for name in traffic["checks"]:
            mod = run.load_reader("checks", name)
            read = getattr(mod, "readings", mod.numbers)
            if read is not mod.numbers:
                emit(dict(workload=a.workload, seed=seed, kind="sound", check=name,
                          numbers=read(kept[name], kept["ref"])))
            for ctl in mod.CONTROLS:
                emit(dict(workload=a.workload, seed=seed, kind="control", check=name,
                          control=ctl, numbers=read(kept[name], kept["ref"], control=ctl)))
        if a.save:
            import torch

            os.makedirs(a.save, exist_ok=True)
            cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x  # noqa: E731
            def host(it):
                return {k: ({kk: cpu(vv) for kk, vv in v.items()} if isinstance(v, dict)
                            else [cpu(x) for x in v] if isinstance(v, list) else cpu(v))
                        for k, v in it.items()}
            items = {f"{check}.{name}": [host(it) for it in res.kept()]
                     for check in ("ba", "pose") if check in kept
                     for name, res in kept[check].items()}
            items["association.all"] = assoc_calls
            torch.save(items, os.path.join(a.save, f"{a.workload}_{seed}.pt"))
        del kept
    for fault in [f for f in a.faults.split(",") if f]:
        seed = seeds[0] + 1000 + len(fault)
        saved = {}
        from gmmloc_tpu_torch.mapping import association
        from gmmloc_tpu_torch.solver import cuda_pose, local_ba

        for mod, name in ((local_ba, "solve_local_ba"),
                          (association, "associate_and_check_kernel"),
                          (cuda_pose, "optimize_pose_anchored")):
            saved[(mod, name)] = getattr(mod, name)
        try:
            res, compared, r = run.run_cell(a.workload, seed, a.seconds, False,
                                            before_window=lambda: _plant(fault))
        finally:
            for (mod, name), f in saved.items():
                setattr(mod, name, f)
        emit(dict(workload=a.workload, seed=seed, kind="fault", fault=fault,
                  correct=res["correct"], numbers={k: v for k, (v, _) in compared.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
