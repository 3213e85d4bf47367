"""Local bundle adjustment with GMM structure factors: Schur-complement LM.

A plain copy of the port's `solver/local_ba.py::solve_local_ba` on the
path the configuration runs (ref Localization::jointOptimization,
localization_opt.cpp:456-925): the "flatpm" layout, the reduced camera
system solved by LU, on the CPU. SE3 camera slots, per-point observation
tables (P, MO), mono/stereo reprojection edges, GMM structure edges (1-D
point-to-plane for a degenerate component, 3-D whitened otherwise) and
the first-KF SE3 prior, solved by a staged LM schedule

  stage 1 (5 it)  -> deactivate degenerate structure edges with
                     chi2 > tri_str_thresh * ba_lambda2 (:773-789)
  stage 2 (5 it)  -> deactivate reprojection edges over the chi2 gates or
                     behind the camera, drop Huber (:797-825)
  stage 3 (40 it)

Points are eliminated per point (dense 3x3), the camera blocks are
block-diagonal sums over observations (one-hot contractions), the reduced
(6L x 6L) system is solved by LU. The residual/Jacobian products at the
accepted state are carried, so one LM iteration makes one pass at the
proposed state, whose chi2 is also the accept-test cost.

With `use_bf16` (the default, as the configuration runs it) the Hessian
products are staged in bfloat16 where the port's "flatpm" layout rounds
them: sqrt(w), the weighted rows, and the sums over the three residual
rows that feed H_pp, b_p and U, each term and partial sum rounded, the
last add of the H_pp and b_p row sums and the weighted residual that b_c
reads in full precision. Each rounding goes through `_bf16_round`, and
each proposed state through `_state_round` (the identity): the checks'
controls swap them for lower precisions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import factors
from . import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815

STR_NONE = 0
STR_DEG = 1      # degenerate component -> 1-D point-to-plane edge
STR_NONDEG = 2   # full component -> 3-D sqrt-info whitened edge


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


def _unrounded(x):
    return x


_state_round = _unrounded


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
) -> BAResult:
    """Staged Schur-complement LM over a fixed-capacity window. Each stage
    stops early when an accepted step gains less than `term_gain`
    (relative) or the damping exceeds 1e4. `use_bf16` stages the Hessian
    products in bfloat16 (module docstring)."""
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
        c_obs = torch.sum(torch.where(active_obs, rho, 0.0))
        _, _, c_str = _gmm_terms(prob, pts, ba_lambda2, active_str)
        c_pri = _prior_cost(prob, cam_q, cam_t, prior_info)[2]
        return c_obs + torch.sum(torch.where(pt_valid, c_str, 0.0)) + c_pri

    def lm_step(products, cam_q, cam_t, pts, lam, active_obs, active_str, use_huber):
        r, Jc, Jp, chi2, _ = products
        w = prob.obs_sigma2_inv * active_obs.to(dtype)
        if use_huber:
            w = w * factors.huber_weight(chi2, huber_delta)
        H_pp, b_p, JWJc, JWJp, JWr = _weighted_flatpm(r, Jc, Jp, w, rnd)
        H_str, b_str, _ = _gmm_terms(prob, pts, ba_lambda2, active_str)
        H_pp = H_pp + torch.where(pt_valid[:, None, None], H_str, 0.0)
        b_p = b_p + torch.where(pt_valid[:, None], b_str, 0.0)
        tr_p = H_pp.diagonal(dim1=-2, dim2=-1).sum(-1)
        H_pp_d = H_pp + lam * (tr_p[:, None, None] / 3.0 + 1e-9) * eye3
        H_pp_d = torch.where(pt_valid[:, None, None], H_pp_d, eye3)
        Hpp_inv, _ = _inv3(H_pp_d)

        # camera blocks: one-hot sums of the per-observation products
        oh = onehot.reshape(P * MO, L)
        H_cc = (oh.T @ JWJc.reshape(P * MO, 36)).reshape(L, 6, 6)
        b_c = oh.T @ JWr.reshape(P * MO, 6)                          # (L,6)
        U = torch.einsum("pml,pmij->plij", onehot, JWJp).reshape(P, 6 * L, 3)
        T = U @ Hpp_inv                                              # (P,6L,3)
        TU = (T.permute(1, 0, 2).reshape(6 * L, 3 * P)
              @ U.permute(1, 0, 2).reshape(6 * L, 3 * P).T)
        Tb = torch.einsum("pcj,pj->c", T, b_p)
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
        dc = -torch.linalg.solve_ex(S, b_flat)[0].reshape(L, 6)
        dc = torch.where(fm[:, None], dc, 0.0)
        rhs_p = b_p + torch.einsum("pcj,c->pj", U, dc.reshape(-1))
        dp = -torch.einsum("pij,pj->pi", Hpp_inv, rhs_p)
        dp = torch.where(pt_valid[:, None], dp, 0.0)
        nq, nt = se3.boxplus(cam_q[:L], cam_t[:L], dc)
        return (torch.cat([nq, cam_q[L:]], 0), torch.cat([nt, cam_t[L:]], 0),
                pts + dp)

    def run_stage(state, active_obs, active_str, use_huber, iters):
        cam_q, cam_t, pts, products, lam, it_tot = state
        cost = cost_from(products, cam_q, cam_t, pts, active_obs, active_str, use_huber)
        for _ in range(iters):
            nq, nt, npts = (_state_round(x) for x in lm_step(
                products, cam_q, cam_t, pts, lam, active_obs, active_str, use_huber))
            nprod = products_at(nq, nt, npts)
            new_cost = cost_from(nprod, nq, nt, npts, active_obs, active_str, use_huber)
            accept = bool(new_cost < cost)
            gain = float((cost - new_cost) / torch.clamp(cost, min=1e-12))
            done = (accept and gain < term_gain) or bool(lam > 1e4)
            it_tot += 1
            if accept:
                cam_q, cam_t, pts, products = nq, nt, npts, nprod
                cost = new_cost
                lam = torch.clamp(lam * 0.5, min=1e-9)
            else:
                lam = lam * 4.0
            if done:
                break
        return cam_q, cam_t, pts, products, lam, it_tot

    active_obs = prob.obs_valid & obs_exists
    active_str = pt_valid & (prob.str_type != STR_NONE)
    q0, t0, p0 = (_state_round(x) for x in (prob.cam_q, prob.cam_t, prob.pts))
    state = (q0, t0, p0, products_at(q0, t0, p0), torch.tensor(1e-4, dtype=dtype), 0)
    state = run_stage(state, active_obs, active_str, True, iters1)

    rs = factors.pt2plane_residual(state[2], prob.str_mean, prob.str_normal)
    bad_deg = (prob.str_type == STR_DEG) & (
        ba_lambda2 * rs * rs > tri_str_thresh * ba_lambda2)
    active_str = active_str & ~bad_deg
    state = run_stage(state, active_obs, active_str, True, iters2)

    chi2_o, depth_ok = state[3][3], state[3][4]
    active_obs = active_obs & ~((chi2_o > chi2_th) | ~depth_ok)
    state = run_stage(state, active_obs, active_str, False, iters3)
    cam_q_f, cam_t_f, pts_f = state[0], state[1], state[2]

    chi2_f, depth_ok_f = state[3][3], state[3][4]
    obs_bad = prob.obs_valid & obs_exists & ((chi2_f > chi2_th) | ~depth_ok_f)
    rs_f = factors.pt2plane_residual(pts_f, prob.str_mean, prob.str_normal)
    str_drop = pt_valid & (prob.str_type == STR_DEG) & (
        ba_lambda2 * rs_f * rs_f > tri_str_thresh * ba_lambda2)
    cost_f = cost_from(state[3], cam_q_f, cam_t_f, pts_f, active_obs, active_str, False)
    return BAResult(cam_q_f, cam_t_f, pts_f, obs_bad, str_drop, chi2_f, cost_f, state[5])
