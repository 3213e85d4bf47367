"""Kernel-against-plain-version checks on the card.

Seeded problems at the main path's shapes, the comparison of each CUDA
kernel (K1, K2, K3, K4) with its plain PyTorch version on the same
inputs, CUDA-event timing, and each kernel's bound. Used by
`chip_smoke.py`, the sweep tools and the card tests.

The bound is the least time the card could take for the function's
work, whatever kernel implements it: the larger of the bytes it must
move (each input read once, each output written once) over the memory
rate, and the operations these inputs need, each class at its own issue
rate (`OPS_PER_SM_CLOCK`: a float32 min, an integer xor and a population
count do not issue at the rate of a float32 add):

  - K1/K2: the GN steps the solve ran x features x the flops of one
    feature pass, at the float32 FMA rate;
  - K3: its bytes (the int32 output). With the tensor cores doing the
    AND + popcount the arithmetic is far under that. What the counting
    would cost on the ALU, at 8 and at 4 population counts per pair, is
    returned beside it as `alu_popc_ms`, as information;
  - K4: its bytes, or the operations no known exact kernel avoids on
    this image, counted from the plain version on the image: on every
    pixel the first two antipodal pairs of the reject (`fast.arc_bounds`
    over pairs 0 and 4: 6 min/max, 2 compares, and the centre subtracted
    once from each bound, 2 subtracts); the other six pairs (24 min/max)
    only where those two still allow a score; the arc pass in its
    cheapest known form (57 min/max over prefix and suffix extrema of the
    ring's halves, and the threshold) on every polarity that survives the
    whole test; the NMS (8 max, one add, one compare) on the pixels that
    score. On the images of the main path that is under the bytes.
    `dense_ops_ms` is the figure of the dense form (206 operations on
    every pixel at one per lane and clock), kept for continuity with
    earlier tables.

K3 and K4 are timed over a ring of pre-allocated outputs larger than the
L2 cache (`time_cuda_ring`), so that every launch's output really leaves
for device memory; the time into one re-used buffer is `ms_l2`.

Gates (stated with their reason): the pose kernels sum the 27 normal-
equation terms in another order than the plain version, so they agree to
float tolerance -- rotation < 0.01 deg (K2: 0.02), translation < 1e-3 m
(K2: 2e-3), outlier-flag difference <= 2 (K2: 3, anchor flags <= 3),
inlier-count difference <= 2; flags may differ only at the chi2 gate.
The Hamming kernel is integer arithmetic and must be exact; the FAST+NMS
kernel is float32 subtract/min/max/compare and must be exact too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solver import cuda_pose, pose_solver
from ..features import cuda_kernels, fast_kernels

K1_GATES = dict(rot_deg=0.01, trans=1e-3, outlier_diff=2, inlier_diff=2)
K2_GATES = dict(rot_deg=0.02, trans=2e-3, outlier_diff=3, inlier_diff=3,
                anchor_diff=3)

# H100 SXM (NVIDIA data sheet, at the 700 W limit): HBM bytes/s, 132 SMs
# at a 1.98 GHz boost clock
HBM_BYTES_S = 3.35e12
SMS = 132
BOOST_HZ = 1.98e9
# results per SM and clock by instruction class (NVIDIA's CUDA C++
# programming manual, "Arithmetic Instructions" throughput table, compute
# capability 9.0): float32 add/multiply/FMA; float32 min, max and compare; 32-bit
# integer add and logic; population count
OPS_PER_SM_CLOCK = dict(fadd=128, fminmax=64, int=64, popc=16)
OPS_S = {k: v * SMS * BOOST_HZ for k, v in OPS_PER_SM_CLOCK.items()}
# an FMA counts as two flops: 67 TFLOP/s, the data sheet's float32 peak
OPS_S["fp32_flop"] = 67e12
# float32 operations per feature and Gauss-Newton step of the pose
# solves: reprojection and its 3x6 Jacobian (~60), robust weight (~10),
# the 27 normal-equation sums (~160); the anchor term adds ~200 (K2)
K1_FLOPS_PER_FEATURE_ITER = 230
K2_FLOPS_PER_FEATURE_ITER = 430
# FAST + NMS in its dense form, per pixel: 16 ring subtracts, 16
# negations, 2 x 79 for the bright and dark arc passes (48 + 16 mins, 15
# max), the two threshold selects and the max (5), the border test (4),
# the NMS (8 max, one add, one compare, one select); earlier tables rated
# all of them at one per lane and clock
K4_DENSE_OPS_PER_PIXEL = 16 + 16 + 2 * 79 + 5 + 4 + 11
DENSE_LANE_OPS_S = 33.5e12
# FAST + NMS as the bound counts it, in min/max-class operations: the
# first two pairs of the reject per pixel (6 min/max, 2 compares), the
# other six (24 min/max) per pixel those two let through, the arc pass per
# surviving polarity (57 min/max, the threshold), the NMS per scoring
# pixel (8 max, the compare); the 2 subtracts per pixel and the NMS's add
# are adds
K4_FIRST_PAIRS = (0, 4)
K4_FIRST_PAIRS_OPS = 8
K4_OTHER_PAIRS_OPS = 24
K4_ARC_PASS_OPS = 58
K4_NMS_OPS = 9
# the outputs of one timing ring: three times the 50 MB L2
RING_BYTES = 150e6


def bound(n_bytes: float, ops: dict) -> dict:
    """The least time for the work: max(bytes / HBM rate, sum over the
    instruction classes of ops / rate). `ops` maps a class of `OPS_S` to
    a count."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = sum(n / OPS_S[k] for k, n in ops.items())
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=t_bytes * 1e3, ops_ms=t_ops * 1e3,
                bytes=int(n_bytes), ops={k: int(n) for k, n in ops.items()})


def hamming_bound(n: int, m: int) -> dict:
    """K3's bound: its bytes. The population counts pair by pair on the
    ALU (8, or 4 after a carry-save tree) would cost `alu_popc_ms`."""
    r = bound((n + m) * 32 + n * m * 4, {})
    r["alu_popc_ms"] = dict(popc8=n * m * 8 / OPS_S["popc"] * 1e3,
                            popc4=n * m * 4 / OPS_S["popc"] * 1e3)
    return r


def fast_bound(img) -> dict:
    """K4's bound on this image (see the module docstring), with the
    share of pixels that survive the exact reject."""
    from ..features import fast

    h, w = img.shape
    score, bright, dark = fast.fast_score_rejecting(img)
    u2, l2 = fast.arc_bounds(fast._ring_diffs(img), K4_FIRST_PAIRS)
    n_first = int((fast._inside_border(img)
                   & ((u2 > fast.FAST_TH_LOW) | (l2 < -fast.FAST_TH_LOW))).sum())
    n_px, n_scoring = h * w, int((score > 0).sum())
    n_passes = int(bright.sum()) + int(dark.sum())
    r = bound(n_px * 8, dict(
        fadd=2 * n_px + n_scoring,
        fminmax=(K4_FIRST_PAIRS_OPS * n_px + K4_OTHER_PAIRS_OPS * n_first
                 + K4_ARC_PASS_OPS * n_passes + K4_NMS_OPS * n_scoring)))
    r["survivor_share"] = float((bright | dark).sum()) / n_px
    r["first_pairs_share"] = n_first / n_px
    r["arc_passes_per_pixel"] = n_passes / n_px
    r["dense_ops_ms"] = n_px * K4_DENSE_OPS_PER_PIXEL / DENSE_LANE_OPS_S * 1e3
    return r


def pose_problem(cam, n: int, seed: int = 0, anchored: bool = False,
                 outlier_frac: float = 0.12, noise: float = 0.4):
    """A seeded pose-only problem of n features (numpy): landmarks seen
    from a perturbed identity pose, 12% gross outliers, 80% stereo; with
    `anchored`, GMM anchors on ~70% of the features (half degenerate)."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform([40, 40], [cam.width - 40, cam.height - 40], (n, 2))
    z = rng.uniform(1.0, 12.0, n)
    x_w = np.stack([(uv[:, 0] - cam.cx) / cam.fx * z,
                    (uv[:, 1] - cam.cy) / cam.fy * z, z], -1)
    obs = np.concatenate([uv, (uv[:, 0] - cam.bf / z)[:, None]], -1)
    obs += rng.normal(0, noise, obs.shape)
    n_out = int(outlier_frac * n)
    obs[:n_out] += rng.normal(0, 30.0, obs[:n_out].shape)
    q0 = np.array([1.0, 0.004, -0.006, 0.002])
    p = dict(
        q0=q0 / np.linalg.norm(q0), t0=np.array([0.02, -0.015, 0.01]),
        x_w=x_w, obs_uvr=obs, is_stereo=rng.random(n) < 0.8,
        sigma2_inv=1.0 / 1.2 ** (2 * rng.integers(0, 8, n)),
        valid=rng.random(n) < 0.95,
    )
    if anchored:
        disp = obs[:, 0] - obs[:, 2]
        zs = np.where(np.abs(disp) < 1e-6, 1e9, cam.bf / np.clip(disp, 1e-6, None))
        nrm = rng.normal(size=(n, 3))
        a_type = np.where(
            rng.random(n) < 0.3, pose_solver.ANCHOR_NONE,
            np.where(rng.random(n) < 0.5, pose_solver.ANCHOR_DEG,
                     pose_solver.ANCHOR_NONDEG))
        a_type = np.where((zs > 0) & (zs < 1e3), a_type, pose_solver.ANCHOR_NONE)
        p.update(
            anc_xc=np.stack([(obs[:, 0] - cam.cx) / cam.fx * zs,
                             (obs[:, 1] - cam.cy) / cam.fy * zs, zs], -1),
            anc_mean=x_w + rng.normal(0, 0.01, (n, 3)),
            anc_normal=nrm / np.linalg.norm(nrm, axis=1, keepdims=True),
            anc_sqrt_info=np.tile(np.eye(3) * 3.0, (n, 1, 1)),
            anc_type=a_type.astype(np.int32),
            anc_weight=np.where(a_type == pose_solver.ANCHOR_DEG,
                                400.0 * np.maximum(zs, 1.0) ** 2, 1.0),
            anc_chi2_th=2.56,
        )
    return p


POSE_ORDER = ("q0", "t0", "x_w", "obs_uvr", "is_stereo", "sigma2_inv", "valid")
ANC_ORDER = ("anc_xc", "anc_mean", "anc_normal", "anc_sqrt_info", "anc_type",
             "anc_weight")


def pose_args(p, device, anchored: bool):
    """Problem dict -> positional tensor args (float32/bool/int32)."""
    def t(v):
        a = np.asarray(v)
        if a.dtype == bool:
            return torch.tensor(a, device=device)
        if a.dtype.kind in "iu":
            return torch.tensor(a, dtype=torch.int32, device=device)
        return torch.tensor(a, dtype=torch.float32, device=device)

    args = [t(p[k]) for k in POSE_ORDER]
    if anchored:
        args += [t(p[k]) for k in ANC_ORDER] + [float(p["anc_chi2_th"])]
    return args


def angle_deg(qa, qb) -> float:
    """Rotation angle between two quaternions, each renormalized in
    float64 first (a float32 unit quaternion is off by ~1e-7 in norm,
    which arccos near 1 would read as ~0.02 degrees)."""
    qa = np.asarray(qa, np.float64)
    qb = np.asarray(qb, np.float64)
    d = abs(float(np.dot(qa / np.linalg.norm(qa), qb / np.linalg.norm(qb))))
    return float(np.degrees(2 * np.arccos(min(d, 1.0))))


def compare_pose(ref, out, anchored: bool) -> dict:
    """Gate quantities between two pose results (any device)."""
    g = lambda x: x.detach().cpu().numpy()
    m = dict(
        rot_deg=angle_deg(g(ref.q), g(out.q)),
        trans=float(np.linalg.norm(g(ref.t) - g(out.t))),
        outlier_diff=int((g(ref.is_outlier) != g(out.is_outlier)).sum()),
        inlier_diff=abs(int(ref.num_inliers) - int(out.num_inliers)),
        max_abs_err=float(max(np.abs(g(ref.q) - g(out.q)).max(),
                              np.abs(g(ref.t) - g(out.t)).max())),
    )
    if anchored:
        m["anchor_diff"] = int((g(ref.anc_outlier) != g(out.anc_outlier)).sum())
    return m


def within(m: dict, gates: dict) -> bool:
    return all(m[k] < v if isinstance(v, float) else m[k] <= v
               for k, v in gates.items())


def time_cuda(fn, reps: int = 20, warmup: int = 3, queued: bool = False) -> float:
    """Mean milliseconds per call of fn() on the current stream, by CUDA
    events around `reps` back-to-back calls.

    With `queued` the calls are enqueued behind a spin kernel that keeps
    the card busy until the host has enqueued them all, so the events hold
    device time only and not the host's pace; the spin is lengthened until
    the first event is still pending when the last call has been enqueued.
    A kernel's time is taken so; a plain version's is taken as the host
    paces it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 1 << 20
    while True:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(spin)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        paced = queued and e0.query()   # the card reached e0 before the host was done
        torch.cuda.synchronize()
        if not paced:
            return e0.elapsed_time(e1) / reps
        spin *= 4


def time_cuda_ring(fn, like, reps: int = 20) -> float:
    """Device ms per call of fn(out), `out` walking a ring of tensors like
    `like` whose total passes `RING_BYTES`, so that no launch writes into
    lines the L2 still holds from its last turn (at most 512 tensors: a
    tiny output stays cached, as it would for its caller)."""
    n = min(int(RING_BYTES // max(like.numel() * like.element_size(), 1)) + 2, 512)
    ring = [torch.empty_like(like) for _ in range(n)]
    state = [0]

    def call():
        state[0] = (state[0] + 1) % n
        fn(ring[state[0]])

    return time_cuda(call, reps=max(reps, n), queued=True)


# the step sweep: one round without early stop (step_tol 0), at F=1280
# over the GN steps, and at 10 steps over the feature count
SWEEP_ITERS = (1, 2, 5, 10)
SWEEP_FEATURES = (128, 320, 640, 1280)


def step_sweep(cam, anchored: bool, device, solve=None, seed: int = 0) -> dict:
    """Device ms of one solve (rounds=1, step_tol=0) at F=1280 for each
    iters in SWEEP_ITERS and at iters=10 for each F in SWEEP_FEATURES. The
    slope over steps is the serial latency of one GN step (the feature pass
    at F=1280, the reduction, the barrier and the 6x6 solve); the slope
    over features, per step, is the per-feature cost of the pass. `solve`
    defaults to the package's K1 (K2 with `anchored`)."""
    if solve is None:
        solve = cuda_pose.optimize_pose_anchored if anchored else cuda_pose.optimize_pose

    def ms(n, iters):
        args = pose_args(pose_problem(cam, n, seed=seed, anchored=anchored), device,
                         anchored)
        out = solve(cam, *args, rounds=1, iters=iters, step_tol=0.0)
        torch.cuda.synchronize()
        if out.gn_iters is not None and int(out.gn_iters) != iters:
            raise RuntimeError(f"{iters} GN steps asked, {int(out.gn_iters)} run")
        return time_cuda(lambda: solve(cam, *args, rounds=1, iters=iters, step_tol=0.0),
                         reps=50, queued=True)

    by_iters = {it: ms(1280, it) for it in SWEEP_ITERS}
    by_feat = {n: ms(n, 10) for n in SWEEP_FEATURES}
    i0, i1 = SWEEP_ITERS[0], SWEEP_ITERS[-1]
    f0, f1 = SWEEP_FEATURES[0], SWEEP_FEATURES[-1]
    return dict(
        ms_by_iters={str(k): v for k, v in by_iters.items()},
        ms_by_features={str(k): v for k, v in by_feat.items()},
        step_us=(by_iters[i1] - by_iters[i0]) / (i1 - i0) * 1e3,
        feature_ns_per_step=(by_feat[f1] - by_feat[f0]) / (f1 - f0) / i1 * 1e6,
    )


def check_pose_kernel(cam, n: int, anchored: bool, device, seed: int = 0,
                      timing: bool = True) -> dict:
    """Run K1 (or K2) and its plain version on the card on one seeded
    problem; returns the gate quantities, `ok`, and both times."""
    p = pose_problem(cam, n, seed=seed, anchored=anchored)
    args = pose_args(p, device, anchored)
    if anchored:
        kern, plain, gates = (cuda_pose.optimize_pose_anchored,
                              pose_solver.optimize_pose_anchored, K2_GATES)
    else:
        kern, plain, gates = (cuda_pose.optimize_pose, pose_solver.optimize_pose,
                              K1_GATES)
    n0 = kern.launches
    out = kern(cam, *args)
    torch.cuda.synchronize()
    if kern.launches != n0 + 1:
        raise RuntimeError(f"{kern.__name__} did not launch its kernel")
    ref = plain(cam, *args)
    m = compare_pose(ref, out, anchored)
    m["ok"] = within(m, gates)
    # work these inputs need: the GN steps the kernel ran (it stops a
    # round early on convergence) over every feature, plus the bytes of
    # each input and output once
    m["gn_iters"] = int(out.gn_iters)
    n_in = sum(a.numel() * a.element_size() for a in args if isinstance(a, torch.Tensor))
    n_out = 8 * 4 + 3 * 4 + n * (4 + 1 + (1 if anchored else 0))
    flops = K2_FLOPS_PER_FEATURE_ITER if anchored else K1_FLOPS_PER_FEATURE_ITER
    m.update(bound(n_in + n_out, dict(fp32_flop=m["gn_iters"] * n * flops)))
    if timing:
        m["ms"] = time_cuda(lambda: kern(cam, *args), queued=True)
        m["plain_ms"] = time_cuda(lambda: plain(cam, *args), reps=5, warmup=1)
    return m


def check_pose_repeatable(cam, n: int, anchored: bool, device, seed: int = 0,
                          runs: int = 3) -> bool:
    """`runs` launches on the same inputs give bit-identical outputs."""
    kern = cuda_pose.optimize_pose_anchored if anchored else cuda_pose.optimize_pose
    args = pose_args(pose_problem(cam, n, seed=seed, anchored=anchored), device, anchored)
    outs = [kern(cam, *args) for _ in range(runs)]
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for o in outs[1:] for a, b in zip(outs[0], o)
               if isinstance(a, torch.Tensor))


def hamming_problem(n: int, m: int, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.integers(0, 256, (n, 32), dtype=np.uint8), device=device)
    b = torch.tensor(rng.integers(0, 256, (m, 32), dtype=np.uint8), device=device)
    return a, b


def check_hamming_kernel(n: int, m: int, device, seed: int = 0, timing: bool = True,
                         kernel=None, yardsticks: bool = True) -> dict:
    """K3 against its plain version on the card: must be exact. `kernel`
    defaults to the package's wrapper; `yardsticks` also times the plain
    version and the library call."""
    kernel = kernel or cuda_kernels.hamming_matrix
    a, b = hamming_problem(n, m, device, seed)
    n0 = kernel.launches
    out = kernel(a, b)
    torch.cuda.synchronize()
    if kernel.launches != n0 + 1:
        raise RuntimeError("hamming_matrix did not launch its kernel")
    ref = cuda_kernels.hamming_matrix_plain(a, b)
    r = dict(max_abs_err=int((out - ref).abs().max()) if out.numel() else 0,
             shape=[n, m])
    r["ok"] = r["max_abs_err"] == 0 and out.dtype == torch.int32
    r.update(hamming_bound(n, m))
    if timing:
        r["ms"] = time_cuda_ring(lambda o: kernel(a, b, out=o), out)
        r["ms_l2"] = time_cuda(lambda: kernel(a, b, out=out), queued=True)
    if timing and yardsticks:
        r["plain_ms"] = time_cuda(lambda: cuda_kernels.hamming_matrix_plain(a, b))
        # the library yardstick: one cdist call on the descriptors
        # unpacked to 0/1 floats (the unpacking stays outside the clock)
        bits = lambda d: ((d[:, :, None] >> torch.arange(8, device=d.device)) & 1) \
            .reshape(d.shape[0], 256).to(torch.float32)
        ba, bb = bits(a), bits(b)
        r["library_equal"] = bool(torch.equal(torch.cdist(ba, bb, p=0).to(torch.int32), ref))
        r["library_ms"] = time_cuda(lambda: torch.cdist(ba, bb, p=0), queued=True)
    return r


def random_image(h: int, w: int, device, seed: int = 0):
    """(h, w) float32 image of random integers in [0, 255]."""
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(0, 256, (h, w)).astype(np.float32), device=device)


def dense_image(h: int, w: int, device):
    """(h, w) float32 ramp 4 x + 20 y (not grey levels: the worst case of
    the function). No ring offset lies along its level lines: every
    antipodal pair of every pixel differs from the centre by >= 8 on both
    sides, so every pixel survives K4's reject in both polarities, the
    most arc passes an image can ask for (and no pixel scores: the
    brighter half ring is 8 long, not 9)."""
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    return (4.0 * xs + 20.0 * ys).contiguous()


def check_fast_kernel(img, timing: bool = True, kernel=None,
                      yardsticks: bool = True) -> dict:
    """K4 against its plain version on one (H, W) float32 image on the
    card: must be exact over the whole output. `kernel` defaults to the
    package's wrapper; `yardsticks` also times the plain version."""
    kernel = kernel or fast_kernels.fast_score_nms
    n0 = kernel.launches
    out = kernel(img)
    torch.cuda.synchronize()
    if kernel.launches != n0 + 1:
        raise RuntimeError("fast_score_nms did not launch its kernel")
    ref = fast_kernels.fast_score_nms_plain(img)
    h, w = img.shape
    r = dict(shape=[h, w], max_abs_err=float((out - ref).abs().max()),
             n_diff=int((out != ref).sum()), n_kept=int((ref > 0).sum()))
    r["ok"] = r["n_diff"] == 0 and out.dtype == torch.float32
    r.update(fast_bound(img))
    if timing:
        r["ms"] = time_cuda_ring(lambda o: kernel(img, out=o), out)
        r["ms_l2"] = time_cuda(lambda: kernel(img, out=out), queued=True)
    if timing and yardsticks:
        r["plain_ms"] = time_cuda(lambda: fast_kernels.fast_score_nms_plain(img), reps=5)
    return r
