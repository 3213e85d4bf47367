"""Entry points of the port: the per-frame track step, and the
sharded association and local BA at production shapes over a group of
ranks.

Twin of the JAX package's `__graft_entry__.py`:

  - `entry(device)` returns (fn, args): the fused, packed track step
    (guided matches on the Hamming kernel K3, the staged pose solves K1
    and K2 with GMM anchors) on the inputs `__graft_entry__.entry()` makes
    from the same seed (F=1280 features, P=4096 local-map points, K=64
    components);
  - `dryrun_multichip(n_devices, device)` runs one sharded association
    (K=3328 components, F=1280 features) and one sharded local BA at the
    production window tier (L=16 free of C=48 cameras, P=8192 points,
    MO=8 observation slots, the 5/5/40 schedule, "flat" at bfloat16)
    inside a group of n_devices ranks: NCCL with one card per rank on
    CUDA, gloo on the CPU (`backend` overrides). Each rank is a process of
    its own (`parallel.distributed.spawn`), unless the caller already is a
    rank of such a group.

`sharded_rank` is what each rank runs; `dryrun_inputs` makes the
production inputs, so a caller can hold the sharded results against the
unsharded port on the same values (`unsharded`, `ba_gap`). The dry run's
window starts at the truth and barely moves; `noisy_window` perturbs it
as tests/test_distributed.py perturbs its own, so that a sum the sharded
solve failed to reduce moves the result far past the gates
(`sharded_ba` solves such a window alone).

    python -m gmmloc_tpu_torch.entry [--device cpu] [--devices N] [--backend gloo]

runs `entry()` once, then `dryrun_multichip` and the noisy window over N
ranks, prints how far the sharded results lie from the unsharded port's
and their times, and exits non-zero unless the association is equal and
each BA passes `ba_gap_fault`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .config import CameraConfig, euroc_v1_config
from .geometry import camera as cam_mod
from .gmm import mixture, render
from .parallel import distributed, sharding
from .solver import local_ba
from .tracking import fused

DRYRUN_ITERS = dict(iters1=5, iters2=5, iters3=40)


def entry(device="cuda"):
    """(fn, args): the packed, anchored track step and its inputs on
    `device`; `fn(*args)` returns the packed float32 vector
    [q(4) t(3) n_inliers n_motion n_anchors | ...]."""
    from .pipeline.system import set_numerics

    set_numerics()
    cfg = euroc_v1_config()
    cam = cam_mod.CameraParams.from_config(CameraConfig())
    rng = np.random.default_rng(0)
    F, P = 1280, 4096

    uv = rng.uniform([40, 40], [cam.width - 40, cam.height - 40], (P, 2))
    z = rng.uniform(2.0, 10.0, P)
    pts = np.stack(
        [(uv[:, 0] - cam.cx) / cam.fx * z, (uv[:, 1] - cam.cy) / cam.fy * z, z],
        -1,
    ).astype(np.float32)
    desc = rng.integers(0, 256, (P, 32), dtype=np.uint8)
    # current-frame detections: identity-pose projections of the first F
    # landmarks with pixel noise, a consistent scene (inliers > 0 is a
    # real check)
    fuv = (uv[:F] + rng.standard_normal((F, 2)) * 0.3).astype(np.float32)
    fur = (uv[:F, 0] - cam.bf / z[:F]).astype(np.float32)
    sf = cfg.frame.scale_factors().astype(np.float32)

    scal = np.zeros(16, np.float32)
    scal[0] = 1.0                      # identity quaternion
    scal[7], scal[8] = 7.0, 3.0        # motion/local search radii

    def pack_feats(uv_, ur_, desc_):
        pk = np.zeros((F, fused.CUR_W), np.float32)
        pk[:, 0:2] = uv_
        pk[:, 2] = ur_
        pk[:, 4] = 1.0                 # sigma2_inv
        pk[:, 5] = 1.0                 # valid
        pk[:, 8:16] = np.ascontiguousarray(desc_).view(np.float32)
        return pk

    cur = pack_feats(fuv, fur, desc[:F])
    last_cur = pack_feats(uv[:F].astype(np.float32), fur, desc[:F])
    dyn = np.zeros((F, fused.DYN_W), np.float32)
    dyn[:, 0:3] = pts[:F]
    dyn[:, 3] = 1.0                    # q_valid
    dyn[:, 4] = np.arange(F) % 64      # GMM component per slot
    dyn[:, 5] = np.arange(F)           # point ids
    map_tab = np.zeros((P, fused.MAP_W), np.float32)
    map_tab[:, 0:3] = pts
    map_tab[:, 3:6] = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    map_tab[:, 6] = z * 0.3
    map_tab[:, 7] = z * 3.0
    map_tab[:, 8] = 1.0
    map_tab[:, 9] = np.arange(P) % 64
    map_tab[:, 10] = np.arange(P)
    map_tab[:, 16:24] = np.ascontiguousarray(desc).view(np.float32)
    K = 64
    gmm_tab = np.zeros((K, fused.GMM_W), np.float32)
    gmm_tab[:, 0:3] = pts[:K]
    gmm_tab[:, 5] = 1.0                # unit normal z
    gmm_tab[:, 6] = gmm_tab[:, 10] = gmm_tab[:, 14] = 1.0  # identity sqrt_info
    gmm_tab[:, 15] = (np.arange(K) % 2).astype(np.float32)

    args = tuple(torch.tensor(a, device=device)
                 for a in (scal, cur, last_cur, dyn, map_tab, gmm_tab, sf))

    def fn(*a):
        return fused.fused_track_step_packed(
            cam, *a, log_scale_factor=float(np.log(1.2)), num_levels=8, use_anchors=True)

    return fn, args


def dryrun_inputs():
    """The production inputs of `__graft_entry__.dryrun_multichip` from the
    same seed, as numpy: (cam, the GMM map's fields, pose (q, t), feature
    uv, the BA problem's fields, n_free)."""
    cam = cam_mod.CameraParams.from_config(CameraConfig())
    cfg = euroc_v1_config()
    rng = np.random.default_rng(0)
    # association: K = the v1 production pad (3299 components -> 3328)
    K = 3328
    means = np.stack(
        [rng.uniform(-4, 4, K), rng.uniform(-3, 3, K), rng.uniform(3, 9, K)], -1)
    covs = np.tile(np.diag([0.04, 0.04, 1e-6]), (K, 1, 1))
    gmap = mixture.from_arrays(means, covs, "cpu", pad_to=K)
    gmm = {k: getattr(gmap, k).numpy() for k in mixture.FIELDS}
    F = cfg.frame.feat_cap
    feat_uv = rng.uniform([0, 0], [cam.width, cam.height], (F, 2)).astype(np.float32)
    pose = (np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32))

    # local BA at the production window tier (localization's largest)
    L, C, Pn, MO = 16, 48, 8192, cfg.caps.ba_obs_per_point
    cam_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (C, 1))
    cam_t = np.zeros((C, 3), np.float32)
    cam_t[:, 0] = np.arange(C) * 0.1
    pts = np.stack(
        [rng.uniform(-2, 2, Pn), rng.uniform(-1.5, 1.5, Pn), rng.uniform(4, 8, Pn)], -1
    ).astype(np.float32)
    obs_cam = rng.integers(0, C, (Pn, MO))
    pc = pts[:, None, :] + cam_t[obs_cam]
    uvr = np.stack([
        cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
        cam.fy * pc[..., 1] / pc[..., 2] + cam.cy,
        cam.fx * pc[..., 0] / pc[..., 2] + cam.cx - cam.bf / pc[..., 2],
    ], -1).astype(np.float32)
    prob = dict(
        cam_q=cam_q, cam_t=cam_t, cam_valid=np.ones(C, bool), pts=pts,
        pt_valid=np.ones(Pn, bool), obs_cam=obs_cam, obs_uvr=uvr,
        obs_stereo=np.ones((Pn, MO), bool), obs_sigma2_inv=np.ones((Pn, MO), np.float32),
        obs_valid=np.ones((Pn, MO), bool),
        str_type=np.full(Pn, local_ba.STR_DEG), str_normal=np.tile(
            np.array([0.0, 0, 1], np.float32), (Pn, 1)),
        str_mean=pts.copy(), str_sqrt_info=np.tile(np.eye(3, dtype=np.float32), (Pn, 1, 1)),
        prior_q=cam_q[0], prior_t=cam_t[0], has_prior=np.array(True),
    )
    return cam, gmm, pose, feat_uv, prob, L


def noisy_window(prob: dict) -> dict:
    """The BA window `prob` (numpy fields) with the noise of
    tests/test_distributed.py's window, from seed 1: 0.3 px on every
    observation and 1 cm on the points' start; the structure means stay
    at the truth."""
    rng = np.random.default_rng(1)
    return dict(prob,
                obs_uvr=prob["obs_uvr"] + rng.normal(0, 0.3, prob["obs_uvr"].shape)
                .astype(np.float32),
                pts=prob["pts"] + rng.normal(0, 0.01, prob["pts"].shape).astype(np.float32))


def ba_problem(prob: dict, device) -> local_ba.BAProblem:
    """A BAProblem on `device` from numpy fields (int64 indices, float32)."""
    def t(v):
        v = np.asarray(v)
        dt = torch.bool if v.dtype == bool else (
            torch.int64 if v.dtype.kind in "iu" else torch.float32)
        return torch.tensor(v, dtype=dt, device=device)

    return local_ba.BAProblem(**{k: t(v) for k, v in prob.items()})


def _timed_runs(dev) -> int:
    """On the card each part runs twice and the second run is timed (the
    first pays for first launches and graph captures); once on the CPU."""
    return 2 if dev.type == "cuda" else 1


def sharded_rank(device, cam, gmm=None, pose=None, feat_uv=None, prob=None, n_free=None,
                 ba_kw=None) -> dict:
    """One rank's part of the sharded association (with `gmm`: the map's
    fields, the pose, the features) and the sharded local BA (with `prob`:
    the problem's fields), on the default group (`_timed_runs`). Returns
    numpy results of the whole map and problem (the same on every rank),
    the host ms of each part's timed run and its collectives' calls,
    bytes and ms."""
    from .pipeline.system import set_numerics

    set_numerics()
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    runs = _timed_runs(dev)
    mesh = sharding.make_mesh()
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    out = dict(rank=mesh.rank, size=mesh.size)
    if gmm is not None:
        gmap = mixture.from_jax_map(gmm, dev)
        q, t = (torch.tensor(x, device=dev) for x in pose)
        uv = torch.tensor(feat_uv, device=dev)
        valid = torch.ones(uv.shape[0], dtype=torch.bool, device=dev)
        sg = sharding.shard_gmm_map(gmap, mesh)
        for _ in range(runs):
            mesh.reset_stats()
            sync()
            t0 = time.perf_counter()
            r2d = sharding.render_view_sharded(sg, cam, q, t, mesh)
            cand = sharding.search_correspondence_sharded(r2d, uv, valid, sg, mesh)
            sync()
        out.update(assoc_ms=(time.perf_counter() - t0) * 1e3,
                   visible=r2d.visible.cpu().numpy(), cand=cand.cpu().numpy(),
                   assoc_collectives=dict(calls=mesh.calls, bytes=mesh.bytes,
                                          ms=mesh.seconds * 1e3))
    if prob is not None:
        sp = sharding.shard_ba_problem(ba_problem(prob, dev), mesh)
        for _ in range(runs):
            mesh.reset_stats()
            sync()
            t0 = time.perf_counter()
            res = sharding.solve_local_ba_sharded(cam, sp, mesh, n_free, **(ba_kw or {}))
            sync()
        ms = (time.perf_counter() - t0) * 1e3
        cost = float(res.cost)
        if not np.isfinite(cost):
            raise RuntimeError(f"rank {mesh.rank}: the sharded BA's cost is {cost}")
        out.update(
            ba_ms=ms, ba_ms_per_iter=ms / max(res.n_iters, 1), n_iters=res.n_iters,
            cost=cost, points_per_rank=int(sp.prob.pts.shape[0]),
            ba_collectives=dict(calls=mesh.calls, bytes=mesh.bytes, ms=mesh.seconds * 1e3),
            **{k: getattr(res, k).cpu().numpy()
               for k in ("cam_q", "cam_t", "pts", "obs_bad", "str_drop")})
    return out


def _backend(device, backend):
    return backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")


def _no_reduction(t: torch.Tensor) -> torch.Tensor:
    return t


def dryrun_rank(device) -> dict:
    """One rank of `dryrun_multichip`: `sharded_rank` on `dryrun_inputs`."""
    cam, gmm, pose, feat_uv, prob, L = dryrun_inputs()
    return sharded_rank(device, cam, gmm, pose, feat_uv, prob, L, DRYRUN_ITERS)


def dryrun_multichip(n_devices: int, device="cuda", backend=None,
                     timeout_s: float = 900.0) -> dict:
    """The sharded association and local BA at production shapes inside a
    group of n_devices ranks (one process each, each with `timeout_s`).
    Raises when asked for more CUDA ranks than cards under NCCL, when a
    rank fails, or when the BA's cost is not finite. Returns rank 0's
    results (`sharded_rank`)."""
    import torch.distributed as dist

    dev = torch.device(device)
    backend = _backend(device, backend)
    if dev.type == "cuda" and backend == "nccl" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} NCCL ranks on {torch.cuda.device_count()} cards: "
                         "NCCL takes one rank per card")
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"called in a group of {dist.get_world_size()} ranks, "
                             f"not {n_devices}")
        return dryrun_rank(device)
    return distributed.spawn("gmmloc_tpu_torch.entry:dryrun_rank", n_devices, device,
                             backend, dict(device=device), timeout_s=timeout_s)[0]


def sharded_ba(n_devices: int, device, cam, prob: dict, n_free: int, backend=None,
               timeout_s: float = 900.0) -> dict:
    """`sharded_rank` on the BA window `prob` alone (the dry run's schedule)
    over n_devices spawned ranks; rank 0's results."""
    return distributed.spawn(
        "gmmloc_tpu_torch.entry:sharded_rank", n_devices, device, _backend(device, backend),
        dict(device=device, cam=cam, prob=prob, n_free=n_free, ba_kw=DRYRUN_ITERS),
        timeout_s=timeout_s)[0]


def unsharded(device, cam, gmm, pose, feat_uv, prob, n_free, ba_kw=None) -> dict:
    """The unsharded port on the same inputs as `sharded_rank`: render_view
    + search_correspondence, and solve_local_ba with an identity
    `reduce_sum`, so its sums accumulate in float64 as the sharded solve's
    (on the card replayed from graphs), with the host ms of each part's
    timed run (`_timed_runs`)."""
    from .pipeline.system import set_numerics

    set_numerics()
    dev = torch.device(device)
    runs = _timed_runs(dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    out = {}
    if gmm is not None:
        gmap = mixture.from_jax_map(gmm, dev)
        q, t = (torch.tensor(x, device=dev) for x in pose)
        uv = torch.tensor(feat_uv, device=dev)
        for _ in range(runs):
            sync()
            t0 = time.perf_counter()
            r2d = render.render_view(gmap, cam, q, t)
            cand = render.search_correspondence(
                r2d, uv, torch.ones(uv.shape[0], dtype=torch.bool, device=dev))
            sync()
        out.update(assoc_ms=(time.perf_counter() - t0) * 1e3,
                   visible=r2d.visible.cpu().numpy(), cand=cand.cpu().numpy())
    if prob is not None:
        p = ba_problem(prob, dev)
        for _ in range(runs):
            sync()
            t0 = time.perf_counter()
            res = local_ba.solve_local_ba(cam, p, n_free, reduce_sum=_no_reduction,
                                          **(ba_kw or {}))
            sync()
        ms = (time.perf_counter() - t0) * 1e3
        out.update(ba_ms=ms, ba_ms_per_iter=ms / max(res.n_iters, 1), n_iters=res.n_iters,
                   cost=float(res.cost),
                   **{k: getattr(res, k).cpu().numpy()
                      for k in ("cam_q", "cam_t", "pts", "obs_bad", "str_drop")})
    return out


def ba_gap(sharded: dict, whole: dict) -> dict:
    """How far a sharded BA result lies from the unsharded one: the max
    abs difference of points and camera positions (m) and of the camera
    quaternions, the relative difference of the final costs, whether every
    array and the cost are bit-equal, the erased edges that differ, and
    both iteration counts."""
    keys = ("cam_q", "cam_t", "pts", "obs_bad", "str_drop")
    return dict(
        pts_m=float(np.abs(sharded["pts"] - whole["pts"]).max()),
        cam_t_m=float(np.abs(sharded["cam_t"] - whole["cam_t"]).max()),
        cam_q=float(np.abs(sharded["cam_q"] - whole["cam_q"]).max()),
        cost_rel=abs(sharded["cost"] - whole["cost"]) / max(abs(whole["cost"]), 1e-30),
        bit_equal=all(np.array_equal(sharded[k], whole[k]) for k in keys)
        and sharded["cost"] == whole["cost"],
        obs_bad_diff=int((sharded["obs_bad"] != whole["obs_bad"]).sum()),
        n_iters_sharded_unsharded=(sharded["n_iters"], whole["n_iters"]))


def ba_gap_fault(gap: dict, ranks: int, gate: float = 1e-4):
    """Why a sharded BA fails its check, or None: points, camera positions
    and quaternions within `gate` of the unsharded solve (the JAX
    package's two-process gate), the final cost within 1e-5 of it
    relatively, the same LM iterations, and bit for bit at one rank, where
    every collective is an identity. A sum left out of the reduction may
    leave a solve that converges within the distance gate (a wrong camera
    system only changes the steps), but not with the whole solve's steps."""
    if max(gap["pts_m"], gap["cam_t_m"], gap["cam_q"]) > gate:
        return f"beyond {gate} of the unsharded solve: {gap}"
    if gap["cost_rel"] > 1e-5:
        return f"a final cost other than the unsharded solve's: {gap}"
    if gap["n_iters_sharded_unsharded"][0] != gap["n_iters_sharded_unsharded"][1]:
        return f"other LM steps than the unsharded solve's: {gap}"
    if ranks == 1 and not gap["bit_equal"]:
        return f"not bit-equal to the unsharded solve at one rank: {gap}"
    return None


def _main():
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="entry() once, then dryrun_multichip and the noisy BA window over "
                    "--devices ranks held against the unsharded port on the same inputs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--backend", default=None, help="nccl (CUDA default) or gloo")
    a = ap.parse_args()
    fn, args = entry(a.device)
    out = fn(*args).cpu().numpy()
    print("entry ok: q =", out[:4], "inliers =", int(out[7]), flush=True)
    res = dryrun_multichip(a.devices, a.device, backend=a.backend)
    cam, gmm, pose, feat_uv, prob, L = dryrun_inputs()
    ref = unsharded(a.device, cam, gmm, pose, feat_uv, prob, L, DRYRUN_ITERS)
    noisy = noisy_window(prob)
    nres = sharded_ba(a.devices, a.device, cam, noisy, L, backend=a.backend)
    nref = unsharded(a.device, cam, None, None, None, noisy, L, DRYRUN_ITERS)
    gaps = dict(dryrun=ba_gap(res, ref), noisy=ba_gap(nres, nref))
    assoc_equal = bool(np.array_equal(res["cand"], ref["cand"])
                       and np.array_equal(res["visible"], ref["visible"]))
    it = max(res["n_iters"], 1)
    print(json.dumps(dict(
        ranks=res["size"], assoc_equal=assoc_equal, ba=gaps,
        assoc_ms=res["assoc_ms"], assoc_ms_unsharded=ref["assoc_ms"],
        ba_ms_per_iter=res["ba_ms_per_iter"], ba_ms_per_iter_unsharded=ref["ba_ms_per_iter"],
        collective_ms_per_iter=res["ba_collectives"]["ms"] / it,
        collective_bytes_per_iter=res["ba_collectives"]["bytes"] / it,
        card=torch.cuda.get_device_name(0) if torch.cuda.is_available() else None)),
        flush=True)
    faults = [f"{k}: {f}" for k, g in gaps.items()
              if (f := ba_gap_fault(g, res["size"])) is not None]
    if not assoc_equal:
        faults.append("the sharded association differs from the unsharded one")
    if faults:
        raise SystemExit("; ".join(faults))


if __name__ == "__main__":
    _main()
