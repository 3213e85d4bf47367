"""Local bundle adjustment with GMM structure factors: Schur-complement LM.

PyTorch port of `gmmloc_tpu/solver/local_ba.py::solve_local_ba`
(ref Localization::jointOptimization, localization_opt.cpp:456-925): SE3
camera slots, per-point observation tables (P, MO), mono/stereo
reprojection edges, GMM structure edges (1-D point-to-plane for a
degenerate component, 3-D whitened otherwise) and the first-KF SE3 prior,
solved by a staged LM schedule

  stage 1 (5 it)  -> deactivate degenerate structure edges with
                     chi2 > tri_str_thresh * ba_lambda2 (:773-789)
  stage 2 (5 it)  -> deactivate reprojection edges over the chi2 gates or
                     behind the camera, drop Huber (:797-825)
  stage 3 (40 it)

One Schur path: points are eliminated per point (dense 3x3), the camera
blocks are block-diagonal sums over observations (one-hot contractions,
no scatters), the reduced (6L x 6L) system is solved by LU. The JAX
package's "flatpm", "flat" and "blockdiag" are TPU layouts of this same
math; at float32 the three names run this one path. The residual/Jacobian
products at the accepted state are carried, so one LM iteration makes one
pass at the proposed state, whose chi2 is also the accept-test cost.

`linear_solver="cg"` solves the reduced system by a fixed-count
Jacobi-preconditioned CG, as the JAX package does on its "flat" and
"blockdiag" paths. Its "flatpm" path ignores the option and runs LU, so
"cg" with "flatpm" runs LU here too.

With `use_bf16` (the default, as in the JAX package) the Hessian products
are staged in bfloat16: the carried residuals and Jacobians are rounded,
and each layout rounds where XLA's CPU compiler rounds the JAX layout's
chains (`tests/test_torch_ba.py`, bit for bit on the same values):

  - "flatpm" holds bfloat16 values for sqrt(w), the weighted rows, and the
    sums over the three residual rows that feed H_pp, b_p and U, each term
    and partial sum rounded; XLA runs the last bfloat16 operation before a
    float32 consumer in float32, so the port does too: the last add of the
    H_pp and b_p row sums, and the weighted residual that b_c reads;
  - "flat" rounds w; its weighted camera rows Z*W are rounded where H_cc
    and b_c read them and float32 where U reads them (XLA fuses that
    product into U's dot); H_pp and b_p are exact products of the
    bfloat16 factors;
  - "blockdiag" rounds w and each observation's products Jc^T W Jc,
    Jc^T W Jp and Jc^T W r (summed over the three rows in float32); its
    weighted rows and H_pp, b_p are as "flat"'s.

Each rounding goes through `torch.bfloat16` and back. Every reduction over
observations and everything after it is float32 (a product of two or three
bfloat16 values is exact in float32), apart from the sums of the hook
below. chi2 and the LM accept cost are
exact float32.

`reduce_sum` is the hook of the sharded solve (`parallel/sharding.py`):
with points and observations split over ranks, every sum over them (H_cc,
b_c, the Schur term T^T U, T b_p and the observation and structure costs)
goes through it once per LM iteration and comes back summed over the
ranks, so every rank takes the same accept and stop decisions. Point
blocks, the back-substitution and the stage gates stay per point; the
prior is added once, after the sum. With the hook those sums accumulate
in float64 and round to float32 once, after it: in float32 their value
hangs on the order of the terms, and the order alone moves the staged
LM's early stop by iterations and weakly held points by millimetres (the
JAX package's own unsharded solve does so when its points are permuted;
PERF.md), so a sharded solve would not take the whole solve's steps. In
float64 a solve with its points split over ranks takes the steps of the
whole solve with an identity hook, bit for bit unless a sum lands within
float64's error of a float32 rounding boundary. Without the hook they
accumulate in float32, as the JAX package's, and no collective runs.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, NamedTuple, Optional

import torch

from . import factors
from ..geometry import se3
from ..utils.device import gc_paused

CHI2_MONO = 5.991
CHI2_STEREO = 7.815

STR_NONE = 0
STR_DEG = 1      # degenerate component -> 1-D point-to-plane edge
STR_NONDEG = 2   # full component -> 3-D sqrt-info whitened edge

SCHUR_IMPLS = ("flatpm", "flat", "blockdiag")
LINEAR_SOLVERS = ("lu", "cg")


def check_schur_impl(schur_impl: str) -> None:
    """Raise on a Schur layout name the port does not know. (The JAX
    package sends any other name to its one-hot einsum branch.)"""
    if schur_impl not in SCHUR_IMPLS:
        raise ValueError(f"unknown ba_schur_impl {schur_impl!r}; one of {SCHUR_IMPLS}")


class BAProblem(NamedTuple):
    """C camera slots (the first n_free optimizable), P point slots, MO
    observation slots per point."""

    cam_q: torch.Tensor          # (C,4) T_cw rotations
    cam_t: torch.Tensor          # (C,3)
    cam_valid: torch.Tensor      # (C,) bool
    pts: torch.Tensor            # (P,3)
    pt_valid: torch.Tensor       # (P,) bool
    obs_cam: torch.Tensor        # (P,MO) int64, -1 = empty slot
    obs_uvr: torch.Tensor        # (P,MO,3)
    obs_stereo: torch.Tensor     # (P,MO) bool
    obs_sigma2_inv: torch.Tensor  # (P,MO)
    obs_valid: torch.Tensor      # (P,MO) bool
    str_type: torch.Tensor       # (P,) int STR_*
    str_normal: torch.Tensor     # (P,3)
    str_mean: torch.Tensor       # (P,3)
    str_sqrt_info: torch.Tensor  # (P,3,3)
    prior_q: torch.Tensor        # (4,) prior of camera slot 0
    prior_t: torch.Tensor        # (3,)
    has_prior: torch.Tensor      # () bool


class BAResult(NamedTuple):
    cam_q: torch.Tensor
    cam_t: torch.Tensor
    pts: torch.Tensor
    obs_bad: torch.Tensor     # (P,MO) bool: erase these observations
    str_drop: torch.Tensor    # (P,) bool: downgrade the GMM association
    obs_chi2: torch.Tensor    # (P,MO)
    cost: torch.Tensor        # () final total cost
    n_iters: int              # LM iterations used across the stages


def _inv3(m):
    """Closed-form batched 3x3 inverse (adjugate); identity where
    |det| < 1e-20. Returns (inv, det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    det = a * A + d * B + g * C
    adj = torch.stack(
        [
            torch.stack([A, B, C], -1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        dim=-2,
    )
    small = torch.abs(det) < 1e-20
    det_safe = torch.where(small, torch.ones_like(det), det)
    inv = adj / det_safe[..., None, None]
    eye = torch.eye(3, dtype=m.dtype, device=m.device).expand(m.shape)
    return torch.where(small[..., None, None], eye, inv), det


def _obs_terms(cam, prob: BAProblem, cam_q, cam_t, pts):
    """Residual/Jacobian pass over the (P, MO) observation table."""
    ci = torch.clamp(prob.obs_cam, min=0)
    q = cam_q[ci]
    t = cam_t[ci]
    x = pts[:, None, :].expand(prob.obs_uvr.shape)
    r, pc, depth_ok = factors.reproj_residual(cam, q, t, x, prob.obs_uvr, prob.obs_stereo)
    Jc = factors.stereo_proj_jac_pose(cam, pc, prob.obs_stereo)     # (P,MO,3,6)
    Jp = factors.stereo_proj_jac_point(cam, q, pc, prob.obs_stereo)  # (P,MO,3,3)
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_sigma2_inv
    return r, Jc, Jp, chi2, depth_ok


def _gmm_terms(prob: BAProblem, pts, ba_lambda2, active_str):
    """Structure-factor contributions to the point blocks
    (localization_opt.cpp:650-683)."""
    is_deg = (prob.str_type == STR_DEG) & active_str
    is_nd = (prob.str_type == STR_NONDEG) & active_str
    rs = factors.pt2plane_residual(pts, prob.str_mean, prob.str_normal)
    n = prob.str_normal
    H_deg = ba_lambda2 * n[:, :, None] * n[:, None, :]
    b_deg = (ba_lambda2 * rs)[:, None] * n
    L = prob.str_sqrt_info
    d = pts - prob.str_mean
    r_nd = torch.einsum("pji,pj->pi", L, d)
    H_nd = torch.einsum("pij,pkj->pik", L, L)
    b_nd = torch.einsum("pij,pj->pi", L, r_nd)
    H = torch.where(is_deg[:, None, None], H_deg, 0.0) + torch.where(
        is_nd[:, None, None], H_nd, 0.0)
    b = torch.where(is_deg[:, None], b_deg, 0.0) + torch.where(is_nd[:, None], b_nd, 0.0)
    cost = torch.where(is_deg, ba_lambda2 * rs * rs, 0.0) + torch.where(
        is_nd, torch.sum(r_nd * r_nd, dim=-1), 0.0)
    return H, b, cost


def _bf16_round(x):
    """x rounded to bfloat16 and held in float32."""
    return x.to(torch.bfloat16).to(x.dtype)


def _row_sum(x, rnd, round_last: bool = True):
    """Sum over the residual-row axis (dim 2, size 3) in the staging
    type: ((x0 + x1) + x2), each term and partial sum passed through rnd;
    the last add stays float32 without `round_last`."""
    x = rnd(x)
    s = rnd(x[:, :, 0] + x[:, :, 1]) + x[:, :, 2]
    return rnd(s) if round_last else s


def _weighted_flatpm(r, Jc, Jp, w, rnd):
    """The weighted per-observation products at "flatpm"'s rounding points
    (module docstring): (H_pp, b_p, JWJc (P,MO,6,6), JWJp (P,MO,6,3), JWr
    (P,MO,6)). At float32 (`rnd` the identity) every layout runs this."""
    # weighted rows r*sqrt(w), J*sqrt(w) (P,MO,3,...); rw32 is the float32
    # product that b_c reads
    sqw = rnd(torch.sqrt(w))
    rw32 = r * sqw[..., None]
    rw = rnd(rw32)
    Jcw = rnd(Jc * sqw[..., None, None])
    Jpw = rnd(Jp * sqw[..., None, None])
    # point blocks: row sums in the staging type, float32 over MO
    H_pp = _row_sum(Jpw[..., :, None] * Jpw[..., None, :], rnd, False).sum(1)
    b_p = _row_sum(Jpw * rw[..., None], rnd, False).sum(1)
    JWJc = torch.einsum("pmai,pmaj->pmij", Jcw, Jcw)
    JWJp = _row_sum(Jcw[..., :, None] * Jpw[..., None, :], rnd)
    JWr = torch.einsum("pmai,pma->pmi", Jcw, rw32)
    return H_pp, b_p, JWJc, JWJp, JWr


def _unrounded(x):
    return x


def _weighted_bf16(layout, r, Jc, Jp, w):
    """The weighted per-observation products of "flat" or "blockdiag" at
    bfloat16 staging (module docstring), as `_weighted_flatpm` returns
    them. Sums over the three residual rows run ((0 + 1) + 2) in float32."""
    wb = _bf16_round(w)[..., None, None]
    Jpw = Jp * wb                  # exact: two bfloat16 factors
    H_pp = _row_sum(Jpw[..., :, None] * Jp[..., None, :], _unrounded).sum(1)
    b_p = _row_sum(Jpw * r[..., None], _unrounded).sum(1)
    Jcw = Jc * wb
    if layout == "flat":
        Jcw_r = _bf16_round(Jcw)
        JWJc = _row_sum(Jcw_r[..., :, None] * Jc[..., None, :], _unrounded)
        JWr = _row_sum(Jcw_r * r[..., None], _unrounded)
        JWJp = _row_sum(Jcw[..., :, None] * Jp[..., None, :], _unrounded)
    else:
        # each observation's float32 product, rounded once
        JWJc = _bf16_round(_row_sum(Jcw[..., :, None] * Jc[..., None, :], _unrounded))
        JWr = _bf16_round(_row_sum(Jcw * r[..., None], _unrounded))
        JWJp = _bf16_round(_row_sum(Jcw[..., :, None] * Jp[..., None, :], _unrounded))
    return H_pp, b_p, JWJc, JWJp, JWr


def _prior_cost(prob: BAProblem, cam_q, cam_t, info):
    """First-KF SE3 prior (localization_opt.cpp:558-582) with the (6,)
    information vector `info`: its residual, weight (0 without a prior)
    and cost."""
    r = factors.se3_prior_residual(cam_q[0], cam_t[0], prob.prior_q, prob.prior_t)
    w = prob.has_prior.to(r.dtype)
    return r, w, w * torch.sum(info * r * r)


def _prior_terms(prob: BAProblem, cam_q, cam_t, info):
    """The prior's Hessian block and gradient on camera slot 0."""
    r, w, _ = _prior_cost(prob, cam_q, cam_t, info)
    J = factors.se3_prior_jacobian(cam_q[0], cam_t[0], prob.prior_q, prob.prior_t)
    H = w * torch.einsum("ij,i,ik->jk", J, info, J)
    b = w * torch.einsum("ij,i,i->j", J, info, r)
    return H, b


def _sum_over_ranks(reduce_sum, *xs):
    """xs summed over the ranks through one call of `reduce_sum` on their
    concatenation."""
    flat = reduce_sum(torch.cat([x.reshape(-1) for x in xs]))
    return [part.reshape(x.shape) for part, x in
            zip(torch.split(flat, [x.numel() for x in xs]), xs)]


def _pcg_solve(S, b, iters: int):
    """Jacobi-preconditioned CG on the reduced camera system, a fixed
    `iters` steps with the JAX package's 1e-12 and 1e-30 guards. LM
    accepts an inexact step (the accept test uses the exact cost). No
    host read and no host branch: capturable in a CUDA graph."""
    d = torch.diagonal(S)
    Minv = 1.0 / torch.where(torch.abs(d) < 1e-12, 1.0, d)
    x = torch.zeros_like(b)
    r = b
    z = Minv * r
    p = z
    rz = torch.dot(r, z)
    for _ in range(iters):
        Sp = S @ p
        denom = torch.dot(p, Sp)
        alpha = torch.where(torch.abs(denom) < 1e-30, 0.0, rz / denom)
        x = x + alpha * p
        r = r - alpha * Sp
        z = Minv * r
        rz_new = torch.dot(r, z)
        beta = torch.where(torch.abs(rz) < 1e-30, 0.0, rz_new / rz)
        p = z + beta * p
        rz = rz_new
    return x


_CAPTURES = threading.local()


def thread_graph_captures() -> int:
    """The LM-iteration graphs solves on the calling thread have captured
    so far (`pipeline/prewarm.py` counts them per window tier)."""
    return getattr(_CAPTURES, "n", 0)


_REUSE = threading.local()      # .graphs: the cache of `reuse_graphs`, if any


@contextlib.contextmanager
def reuse_graphs(graphs: dict):
    """Solves on this thread inside the block keep their LM-iteration
    graphs in `graphs` (the caller's, one per problem shape and Huber
    setting) and replay them in later solves of the same shape, with the
    new problem copied into the graph's inputs: such a solve launches no
    eager iteration and captures nothing. Outside a block every solve
    captures its own graphs and frees them."""
    before = getattr(_REUSE, "graphs", None)
    _REUSE.graphs = graphs
    try:
        yield graphs
    finally:
        _REUSE.graphs = before


class _StageGraph(NamedTuple):
    """One stage's captured LM iteration: the tensors it reads (`inputs`)
    and updates (`st`), and its stop flag."""

    graph: "torch.cuda.CUDAGraph"
    inputs: list
    st: list
    done: torch.Tensor


def solve_local_ba(
    cam,
    prob: BAProblem,
    n_free: int,
    ba_lambda2: float = 400.0,
    tri_str_thresh: float = 0.0064,
    prior_rot_info: float = 1.0 / (2.0 * math.pi / 180.0) ** 2,
    prior_trans_info: float = 1.0 / 0.01 ** 2,
    iters1: int = 5,
    iters2: int = 5,
    iters3: int = 40,
    term_gain: float = 1e-5,
    use_bf16: bool = True,
    schur_impl: str = "flat",
    linear_solver: str = "lu",
    cg_iters: int = 48,
    cuda_graph: bool = True,
    reduce_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> BAResult:
    """Staged Schur-complement LM over a fixed-capacity window. Each stage
    stops early when an accepted step gains less than `term_gain`
    (relative) or the damping exceeds 1e4; that test reads one flag per
    iteration on the host. `use_bf16` stages the Hessian products in
    bfloat16 (module docstring).

    On a CUDA device (with `cuda_graph`) each stage runs its first
    iteration eagerly, captures the second as a CUDA graph and replays it
    for the rest: one iteration is ~1100 small kernels, and each eager
    launch takes and hands back the GIL, which a tracker thread launching
    beside the mapper makes several times dearer (tools/gil_probe.py).
    The replay runs the captured kernels on the same values, so the
    stages take the same steps. Inside `reuse_graphs` a later solve of
    the same shape replays the graphs an earlier one captured, from its
    first iteration on.

    `reduce_sum(t)` returns t summed over the ranks of a sharded solve;
    with it the sums over points and observations accumulate in float64
    (module docstring). A collective cannot be captured in a graph: the
    sharded solve passes `cuda_graph=False`."""
    check_schur_impl(schur_impl)
    if linear_solver not in LINEAR_SOLVERS:
        raise ValueError(f"unknown ba_linear_solver {linear_solver!r}; one of "
                         f"{LINEAR_SOLVERS}")
    # the JAX "flatpm" path takes linear_solver and solves by LU all the same
    use_cg = linear_solver == "cg" and schur_impl != "flatpm"
    graphs = None
    if prob.pts.device.type == "cuda" and cuda_graph and reduce_sum is None:
        graphs = getattr(_REUSE, "graphs", None)
    if graphs is not None:
        # a graph kept for later solves reads these tensors: they must be
        # its own, not views of the caller's tables
        prob = BAProblem(*(x.clone() for x in prob))
    L = n_free
    P, MO = prob.obs_cam.shape
    C = prob.cam_q.shape[0]
    dev, dtype = prob.pts.device, prob.pts.dtype
    huber_delta = torch.where(prob.obs_stereo, math.sqrt(CHI2_STEREO),
                              math.sqrt(CHI2_MONO)).to(dtype)
    chi2_th = torch.where(prob.obs_stereo, CHI2_STEREO, CHI2_MONO).to(dtype)

    free_mask = (torch.arange(C, device=dev) < L) & prob.cam_valid
    obs_exists = (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    obs_on_free = obs_exists & (prob.obs_cam < L) & free_mask[
        torch.clamp(prob.obs_cam, 0, L - 1)]
    onehot = ((prob.obs_cam[..., None] == torch.arange(L, device=dev))
              & obs_on_free[..., None]).to(dtype)               # (P,MO,L)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    fm = free_mask[:L]
    fix6 = (~fm).repeat_interleave(6)
    fixed_rows = fix6[:, None] | fix6[None, :]
    eye6L = torch.eye(6 * L, dtype=dtype, device=dev)
    pt_valid = prob.pt_valid
    rnd = _bf16_round if use_bf16 else _unrounded
    acc = dtype if reduce_sum is None else torch.float64
    prior_info = torch.tensor([prior_rot_info] * 3 + [prior_trans_info] * 3,
                              dtype=dtype, device=dev)

    def products_at(cam_q, cam_t, pts):
        r, Jc, Jp, chi2, depth_ok = _obs_terms(cam, prob, cam_q, cam_t, pts)
        return rnd(r), rnd(Jc), rnd(Jp), chi2, depth_ok

    def cost_from(products, cam_q, cam_t, pts, active_obs, active_str, use_huber):
        s = products[3]
        d = huber_delta
        rho = s
        if use_huber:
            rho = torch.where(s > d * d,
                              2.0 * d * torch.sqrt(torch.clamp(s, min=1e-24)) - d * d, s)
        c_obs = torch.sum(torch.where(active_obs, rho, 0.0), dtype=acc)
        _, _, c_str = _gmm_terms(prob, pts, ba_lambda2, active_str)
        c_pri = _prior_cost(prob, cam_q, cam_t, prior_info)[2]
        c_pts = c_obs + torch.sum(torch.where(pt_valid, c_str, 0.0), dtype=acc)
        if reduce_sum is not None:
            c_pts = reduce_sum(c_pts)
        return c_pts.to(dtype) + c_pri

    def lm_step(products, cam_q, cam_t, pts, lam, active_obs, active_str, use_huber):
        r, Jc, Jp, chi2, _ = products
        w = prob.obs_sigma2_inv * active_obs.to(dtype)
        if use_huber:
            w = w * factors.huber_weight(chi2, huber_delta)
        if use_bf16 and schur_impl != "flatpm":
            H_pp, b_p, JWJc, JWJp, JWr = _weighted_bf16(schur_impl, r, Jc, Jp, w)
        else:
            H_pp, b_p, JWJc, JWJp, JWr = _weighted_flatpm(r, Jc, Jp, w, rnd)
        H_str, b_str, _ = _gmm_terms(prob, pts, ba_lambda2, active_str)
        H_pp = H_pp + torch.where(pt_valid[:, None, None], H_str, 0.0)
        b_p = b_p + torch.where(pt_valid[:, None], b_str, 0.0)
        tr_p = H_pp.diagonal(dim1=-2, dim2=-1).sum(-1)
        H_pp_d = H_pp + lam * (tr_p[:, None, None] / 3.0 + 1e-9) * eye3
        H_pp_d = torch.where(pt_valid[:, None, None], H_pp_d, eye3)
        Hpp_inv, _ = _inv3(H_pp_d)

        # camera blocks: one-hot sums of the per-observation products
        oh = onehot.reshape(P * MO, L).to(acc)
        H_cc = (oh.T @ JWJc.reshape(P * MO, 36).to(acc)).reshape(L, 6, 6)
        b_c = oh.T @ JWr.reshape(P * MO, 6).to(acc)                  # (L,6)
        U = torch.einsum("pml,pmij->plij", onehot, JWJp).reshape(P, 6 * L, 3)
        T = U @ Hpp_inv                                              # (P,6L,3)
        TU = (T.permute(1, 0, 2).reshape(6 * L, 3 * P).to(acc)
              @ U.permute(1, 0, 2).reshape(6 * L, 3 * P).T.to(acc))
        Tb = torch.einsum("pcj,pj->c", T.to(acc), b_p.to(acc))
        if reduce_sum is not None:
            H_cc, b_c, TU, Tb = _sum_over_ranks(reduce_sum, H_cc, b_c, TU, Tb)
        H_cc, b_c, TU, Tb = (x.to(dtype) for x in (H_cc, b_c, TU, Tb))
        H_pri, b_pri = _prior_terms(prob, cam_q, cam_t, prior_info)
        H_cc[0] += H_pri
        b_c[0] += b_pri
        S = -TU
        tr_c = H_cc.diagonal(dim1=-2, dim2=-1).sum(-1)
        H_cc_d = H_cc + lam * (tr_c[:, None, None] / 6.0 + 1e-9) * eye6
        S = S + torch.block_diag(*H_cc_d)
        b_red = b_c.reshape(-1) - Tb
        S = torch.where(fixed_rows, eye6L, S)
        b_flat = torch.where(fix6, 0.0, b_red)
        if use_cg:
            dc = -_pcg_solve(S, b_flat, cg_iters).reshape(L, 6)
        else:
            # solve_ex: no host check of the pivots (a graph cannot hold one)
            dc = -torch.linalg.solve_ex(S, b_flat)[0].reshape(L, 6)
        dc = torch.where(fm[:, None], dc, 0.0)
        rhs_p = b_p + torch.einsum("pcj,c->pj", U, dc.reshape(-1))
        dp = -torch.einsum("pij,pj->pi", Hpp_inv, rhs_p)
        dp = torch.where(pt_valid[:, None], dp, 0.0)
        nq, nt = se3.boxplus(cam_q[:L], cam_t[:L], dc)
        return (torch.cat([nq, cam_q[L:]], 0), torch.cat([nt, cam_t[L:]], 0),
                pts + dp)

    def iterate(st, active_obs, active_str, use_huber):
        """One LM iteration on st = [cam_q, cam_t, pts, *products, lam,
        cost]: (the next st, the stop flag)."""
        cam_q, cam_t, pts, lam, cost = st[0], st[1], st[2], st[-2], st[-1]
        products = tuple(st[3:-2])
        nq, nt, npts = lm_step(products, cam_q, cam_t, pts, lam, active_obs,
                               active_str, use_huber)
        nprod = products_at(nq, nt, npts)
        new_cost = cost_from(nprod, nq, nt, npts, active_obs, active_str, use_huber)
        accept = new_cost < cost
        gain = (cost - new_cost) / torch.clamp(cost, min=1e-12)
        done = (accept & (gain < term_gain)) | (lam > 1e4)
        nxt = [torch.where(accept, n, o)
               for n, o in zip((nq, nt, npts) + tuple(nprod), st[:-2])]
        nxt.append(torch.where(accept, torch.clamp(lam * 0.5, min=1e-9), lam * 4.0))
        nxt.append(torch.minimum(new_cost, cost))
        return nxt, done

    def graph_inputs(active_obs, active_str):
        """Every tensor an LM iteration reads besides its state."""
        return [*prob, huber_delta, onehot, eye3, eye6, eye6L, fixed_rows, fix6, fm,
                prior_info, active_obs, active_str]

    # what else a captured iteration holds: shapes, dtypes and constants
    key = (tuple((x.shape, x.dtype) for x in graph_inputs(prob.obs_valid, prob.pt_valid)),
           str(dev), L, tuple(cam), ba_lambda2, term_gain, use_bf16, schur_impl, use_cg,
           cg_iters)

    def run_stage(state, active_obs, active_str, use_huber, iters):
        cam_q, cam_t, pts, products, lam, it_tot = state
        cost = cost_from(products, cam_q, cam_t, pts, active_obs, active_str, use_huber)
        st = [cam_q, cam_t, pts, *products, lam, cost]
        step = lambda s: iterate(s, active_obs, active_str, use_huber)  # noqa: E731
        graph = None
        kept = graphs.get(key + (use_huber,)) if graphs is not None else None
        if kept is not None:
            for x, n in zip(kept.inputs + kept.st, graph_inputs(active_obs, active_str) + st):
                x.copy_(n)
            graph, st, done_g = kept.graph, kept.st, kept.done
        for _ in range(iters):
            if graph is None:
                st, done = step(st)
                if side is not None:
                    # captured after an eager iteration on this stream, which
                    # made the library handles and workspaces it needs
                    st = [x.clone() for x in st]
                    # thread_local: the tracker's thread may launch and
                    # allocate meanwhile. The graph's memory pool goes back
                    # to the caching allocator with the graph.
                    graph = torch.cuda.CUDAGraph()
                    with gc_paused():
                        graph.capture_begin(capture_error_mode="thread_local")
                        nxt, done_g = step(st)
                        for x, n in zip(st, nxt):
                            x.copy_(n)
                        graph.capture_end()
                    _CAPTURES.n = thread_graph_captures() + 1
                    if graphs is not None:
                        graphs[key + (use_huber,)] = _StageGraph(
                            graph, graph_inputs(active_obs, active_str), st, done_g)
            else:
                graph.replay()
                done = done_g
            it_tot += 1
            if bool(done):
                break
        return st[0], st[1], st[2], tuple(st[3:-2]), st[-2], it_tot

    active_obs = prob.obs_valid & obs_exists
    active_str = pt_valid & (prob.str_type != STR_NONE)
    state = (prob.cam_q, prob.cam_t, prob.pts,
             products_at(prob.cam_q, prob.cam_t, prob.pts),
             torch.tensor(1e-4, dtype=dtype, device=dev), 0)
    side = None
    if dev.type == "cuda" and cuda_graph:
        # the stages run on a stream of their own: the legacy default
        # stream cannot be captured
        caller = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(caller)
    with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
        state = run_stage(state, active_obs, active_str, True, iters1)

        rs = factors.pt2plane_residual(state[2], prob.str_mean, prob.str_normal)
        bad_deg = (prob.str_type == STR_DEG) & (
            ba_lambda2 * rs * rs > tri_str_thresh * ba_lambda2)
        active_str = active_str & ~bad_deg
        state = run_stage(state, active_obs, active_str, True, iters2)

        chi2_o, depth_ok = state[3][3], state[3][4]
        active_obs = active_obs & ~((chi2_o > chi2_th) | ~depth_ok)
        state = run_stage(state, active_obs, active_str, False, iters3)
    if side is not None:
        caller.wait_stream(side)
        for x in (*state[:3], *state[3], state[4], active_obs, active_str):
            x.record_stream(caller)
    cam_q_f, cam_t_f, pts_f = state[0], state[1], state[2]
    chi2_f, depth_ok_f = state[3][3], state[3][4]
    if graphs is not None:
        # the kept graphs' state: the next solve overwrites it
        cam_q_f, cam_t_f, pts_f, chi2_f = (x.clone() for x in (cam_q_f, cam_t_f, pts_f,
                                                               chi2_f))
    obs_bad = prob.obs_valid & obs_exists & ((chi2_f > chi2_th) | ~depth_ok_f)
    rs_f = factors.pt2plane_residual(pts_f, prob.str_mean, prob.str_normal)
    str_drop = pt_valid & (prob.str_type == STR_DEG) & (
        ba_lambda2 * rs_f * rs_f > tri_str_thresh * ba_lambda2)
    cost_f = cost_from(state[3], cam_q_f, cam_t_f, pts_f, active_obs, active_str, False)
    return BAResult(cam_q_f, cam_t_f, pts_f, obs_bad, str_drop, chi2_f, cost_f,
                    state[5])


def solve_local_ba_batch(
    cam,
    probs: BAProblem,
    n_free: int,
    ba_lambda2: float = 400.0,
    tri_str_thresh: float = 0.0064,
    iters1: int = 5,
    iters2: int = 5,
    iters3: int = 40,
    use_bf16: bool = True,
    schur_impl: str = "flat",
    linear_solver: str = "lu",
) -> BAResult:
    """B independent windows of one signature (a leading batch axis on
    every field of `probs`), each solved on its own. The JAX package vmaps
    a lock-step LM whose per-window accept masks give each window its solo
    result; here the windows run one after the other. The result's fields
    carry the batch axis, `n_iters` as a (B,) int64 tensor."""
    outs = [
        solve_local_ba(cam, BAProblem(*(x[b] for x in probs)), n_free,
                       ba_lambda2=ba_lambda2, tri_str_thresh=tri_str_thresh,
                       iters1=iters1, iters2=iters2, iters3=iters3, use_bf16=use_bf16,
                       schur_impl=schur_impl, linear_solver=linear_solver)
        for b in range(probs.pts.shape[0])
    ]
    return BAResult(*(torch.stack([getattr(o, k) for o in outs])
                      for k in BAResult._fields[:-1]),
                    torch.tensor([o.n_iters for o in outs], dtype=torch.int64))
