"""The local bundle adjustment: keyframe poses and map points.

Captures a sample of the calls of `solver.local_ba.solve_local_ba` (the
keyframe mapping looks it up at each call, inline offline and on the
mapper thread online): the whole problem as the association,
triangulation and fusion assembled it (cameras, points, observations,
GMM structure terms, prior), its options, and what it returned (cameras,
points, and the observations and structure terms it gated out). The
reference (`reference/local_ba.py`) solves the problem again on the CPU
in float64, its Hessian products staged in bfloat16 as the configuration
states.

The number, the worst solve of the sample: `ba_cost_gap`, the float64
objective (observation chi2, GMM structure terms, prior) of the
program's cameras and points under the program's own final gating,
against that of the reference's solution under its gating, relative to
the latter. A solve that returns its start reads 5-7 on the card.

Not compared, kept for the record (`readings`): the gap of the
solutions themselves, over the points and over the free camera centres
(the norm over the leaf, relative to the norm of the reference's
change) and each point's and camera's own gap in mm. The staged LM often
stops at its iteration cap or on its gain test in a flat valley, where
float32 against float64 rounding alone moves weakly held points by
metres and, in a window the mapper re-solves, cameras by as much as the
solve moves them: on sound runs the points' leaf reads up to 10.8 (its
median point 0.38) and the cameras' up to 0.61, against 0.69 and 0.54
for the bfloat16-state control (PERF.md).

The controls: the solve state (cameras and points) held in bfloat16
(`bf16_state`), and the products staged one precision lower, in float8
e5m2 (`fp8_products`).
"""

from __future__ import annotations

import inspect
import math

import torch

from ..capture import Reservoir, clone
from ..reference import local_ba, se3

SOLVES = 2
LIMITS = {"ba_cost_gap": 0.04}
CONTROLS = ("bf16_state", "fp8_products")
# the program's options of its own layout and its device path, which the
# reference's one path does without
_DROP = ("cuda_graph", "reduce_sum", "schur_impl", "linear_solver", "cg_iters")


def install(patch, seed: int, program) -> dict:
    from gmmloc_tpu_torch.solver import local_ba as prog_ba

    res = Reservoir(SOLVES, seed * 2 + 11)

    def make(orig):
        def solve(cam, prob, n_free, **kw):
            slot = res.offer()
            if slot is None:
                return orig(cam, prob, n_free, **kw)
            item = dict(prob={k: clone(v) for k, v in prob._asdict().items()}, n_free=n_free,
                        kw={k: v for k, v in kw.items() if k not in _DROP})
            out = orig(cam, prob, n_free, **kw)
            item.update(cam_q=clone(out.cam_q), cam_t=clone(out.cam_t), pts=clone(out.pts),
                        obs_bad=clone(out.obs_bad), str_drop=clone(out.str_drop))
            res.put(slot, item)
            return out
        return solve

    patch.set(prog_ba, "solve_local_ba", make)
    return {"solve_local_ba": res}


def _fp8_round(x):
    return x.to(torch.float8_e5m2).to(x.dtype)


def _bf16_round(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _problem(item: dict):
    return local_ba.BAProblem(**{
        k: (v.cpu().double() if v.is_floating_point() else v.cpu())
        for k, v in item["prob"].items()})


def solve(item: dict, cam, control: str | None):
    """The reference's solve of the captured problem (a control's with
    `control`): (cam_q, cam_t, pts, obs_bad, str_drop)."""
    hooks = {"fp8_products": ("_bf16_round", _fp8_round),
             "bf16_state": ("_state_round", _bf16_round)}
    name, fn = hooks.get(control, (None, None))
    saved = getattr(local_ba, name) if name else None
    if name:
        setattr(local_ba, name, fn)
    try:
        out = local_ba.solve_local_ba(cam, _problem(item), item["n_free"], **item["kw"])
    finally:
        if name:
            setattr(local_ba, name, saved)
    return out.cam_q, out.cam_t, out.pts, out.obs_bad, out.str_drop


def cost(cam, prob, kw: dict, cam_q, cam_t, pts, obs_bad, str_drop) -> float:
    """The float64 objective of a solution under its own gating: the chi2
    of the observations it kept, its points' GMM structure terms and the
    first keyframe's prior."""
    _, _, _, chi2, _ = local_ba._obs_terms(cam, prob, cam_q, cam_t, pts)
    exists = (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    kept = prob.obs_valid & exists & ~obs_bad.cpu()
    active_str = prob.pt_valid & (prob.str_type != local_ba.STR_NONE) & ~str_drop.cpu()
    _, _, c_str = local_ba._gmm_terms(prob, pts, kw.get("ba_lambda2", 400.0), active_str)
    d = inspect.signature(local_ba.solve_local_ba).parameters
    info = torch.tensor([kw.get("prior_rot_info", d["prior_rot_info"].default)] * 3
                        + [kw.get("prior_trans_info", d["prior_trans_info"].default)] * 3,
                        dtype=torch.float64)
    c_pri = local_ba._prior_cost(prob, cam_q, cam_t, info)[2]
    return float(torch.where(kept, chi2, 0.0).sum() + torch.where(prob.pt_valid, c_str, 0.0).sum()
                 + c_pri)


def readings(kept: dict, ref: dict, control: str | None = None) -> dict:
    """Every number of the sample's worst solves: the compared one, and
    for the record the solutions' gaps."""
    cam = ref["cam"]
    items = kept["solve_local_ba"].kept()
    if not items:
        return {}
    worst = {}
    for it in items:
        prob = _problem(it)
        ref_sol = solve(it, cam, None)
        c_ref = cost(cam, prob, it["kw"], *ref_sol)
        if control:
            sol = solve(it, cam, control)
        else:
            sol = tuple(it[k].cpu().double() if it[k].is_floating_point() else it[k].cpu()
                        for k in ("cam_q", "cam_t", "pts", "obs_bad", "str_drop"))
        c = cost(cam, prob, it["kw"], *sol)
        free = prob.cam_valid & (torch.arange(prob.cam_q.shape[0]) < it["n_free"])
        got = dict(ba_cost_gap=abs(c - c_ref) / c_ref if math.isfinite(c) else math.inf)
        for leaf, x, x_ref, x0 in (
                ("pts", sol[2][prob.pt_valid], ref_sol[2][prob.pt_valid],
                 prob.pts[prob.pt_valid]),
                ("cam", _centre(*sol[:2])[free], _centre(*ref_sol[:2])[free],
                 _centre(prob.cam_q, prob.cam_t)[free])):
            gap = torch.linalg.norm(x - x_ref, dim=-1)
            moved = float(torch.linalg.norm(x_ref - x0))
            got[f"ba_{leaf}_gap"] = _finite(float(torch.linalg.norm(gap)) / max(moved, 1e-12))
            got[f"ba_{leaf}_gap_median_mm"] = _finite(float(gap.median()) * 1e3) \
                if gap.numel() else 0.0
            got[f"ba_{leaf}_gap_max_mm"] = _finite(float(gap.max()) * 1e3) \
                if gap.numel() else 0.0
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in got.items()}
    return worst


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _centre(q, t):
    return -se3.quat_rotate(se3.quat_conj(q), t)


def numbers(kept: dict, ref: dict, control: str | None = None) -> dict:
    r = readings(kept, ref, control)
    return {k: r[k] for k in LIMITS} if r else {}
