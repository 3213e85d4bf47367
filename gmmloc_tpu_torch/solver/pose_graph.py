"""Pose-graph optimization (the loop-closure backend).

PyTorch port of `gmmloc_tpu/solver/pose_graph.py`. Standard SE3 PGO:
vertices are keyframe poses T_cw, edges relative constraints
T_ij = T_i_w * T_w_j with residual r = log(T_ij_meas^-1 * T_i * T_j^-1).

All edge residuals and their Jacobians with respect to the two endpoint
tangents come from one batched pass (forward-mode autodiff,
`torch.func.vmap(torch.func.jacfwd(...))`), then a dense (6N x 6N) system
is solved per LM iteration. The system is assembled by one-hot
contractions (matrix products over the edges), not by a scatter-add: on
the card an accumulating scatter with repeated indices sums in an
unspecified order, and the products sum in a fixed one, so two runs give
identical poses. The LM loop runs a fixed number of iterations with the
reference's accept rule and damping schedule and reads nothing back to
the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..geometry import se3
from ..utils.device import resolve


class PoseGraph(NamedTuple):
    q: torch.Tensor           # (N,4) T_cw
    t: torch.Tensor           # (N,3)
    valid: torch.Tensor       # (N,) bool
    fixed: torch.Tensor       # (N,) bool: gauge anchors
    edge_i: torch.Tensor      # (E,) int64
    edge_j: torch.Tensor      # (E,) int64
    edge_q: torch.Tensor      # (E,4) measured T_ij = T_i_w * T_w_j
    edge_t: torch.Tensor      # (E,3)
    edge_info: torch.Tensor   # (E,6) diagonal information
    edge_valid: torch.Tensor  # (E,) bool


def edge_residual(qi, ti, qj, tj, q_meas, t_meas):
    """r = log(T_meas^-1 * T_i * T_j^-1) (...,6)."""
    qm_i, tm_i = se3.inverse(q_meas, t_meas)
    qj_i, tj_i = se3.inverse(qj, tj)
    qa, ta = se3.compose(qi, ti, qj_i, tj_i)
    qr, tr = se3.compose(qm_i, tm_i, qa, ta)
    return se3.log(qr, tr)


def _res(xi_i, xi_j, qi, ti, qj, tj, qm, tm):
    """The edge residual at the endpoints moved by their tangents."""
    qii, tii = se3.boxplus(qi, ti, xi_i)
    qjj, tjj = se3.boxplus(qj, tj, xi_j)
    return edge_residual(qii, tii, qjj, tjj, qm, tm)


# d r / d xi_i and d r / d xi_j in one forward-mode pass over 12 tangents
_jacobians = vmap(jacfwd(_res, argnums=(0, 1)))


def _edge_terms(g: PoseGraph):
    """Residuals (E,6) and the Jacobians (E,6,6) with respect to both
    endpoint tangents, at zero tangents."""
    args = (g.q[g.edge_i], g.t[g.edge_i], g.q[g.edge_j], g.t[g.edge_j], g.edge_q,
            g.edge_t)
    z6 = torch.zeros(g.edge_t.shape[:-1] + (6,), dtype=g.edge_t.dtype,
                     device=g.edge_t.device)
    return (_res(z6, z6, *args),) + _jacobians(z6, z6, *args)


def _residuals(g: PoseGraph, q, t):
    z6 = torch.zeros(g.edge_t.shape[:-1] + (6,), dtype=g.edge_t.dtype,
                     device=g.edge_t.device)
    return _res(z6, z6, q[g.edge_i], t[g.edge_i], q[g.edge_j], t[g.edge_j],
                g.edge_q, g.edge_t)


def optimize_pose_graph(g: PoseGraph, iters: int = 20, lam0: float = 1e-6,
                        device="cuda"):
    """Batched LM over the whole graph on `device` (the graph's tensors
    move there). Returns (q, t, final_cost) on that device."""
    dev = resolve(device)
    g = PoseGraph(*(x.to(dev) for x in g))
    N = g.q.shape[0]
    dtype = g.t.dtype
    free = g.valid & ~g.fixed
    w = g.edge_valid.to(dtype)[:, None] * g.edge_info               # (E,6)
    # one-hot incidence of the edge endpoints (E,N)
    nodes = torch.arange(N, device=dev)
    Ei = (g.edge_i[:, None] == nodes).to(dtype)
    Ej = (g.edge_j[:, None] == nodes).to(dtype)
    free6 = free.repeat_interleave(6)

    def cost_fn(q, t):
        r = _residuals(g, q, t)
        return torch.sum(torch.where(g.edge_valid, torch.sum(r * r * g.edge_info, -1), 0.0))

    q, t = g.q, g.t
    lam = torch.tensor(lam0, dtype=dtype, device=dev)
    cost = cost_fn(q, t)
    for _ in range(iters):
        r, Ji, Jj = _edge_terms(g._replace(q=q, t=t))
        Hi = torch.einsum("eai,ea,eaj->eij", Ji, w, Ji)
        Hj = torch.einsum("eai,ea,eaj->eij", Jj, w, Jj)
        Hij = torch.einsum("eai,ea,eaj->eij", Ji, w, Jj)
        bi = torch.einsum("eai,ea,ea->ei", Ji, w, r)
        bj = torch.einsum("eai,ea,ea->ei", Jj, w, r)
        # H[a,i,b,j] = sum_e of the edge blocks at (edge_i, edge_j) pairs
        H = (torch.einsum("ea,eij,eb->aibj", Ei, Hi, Ei)
             + torch.einsum("ea,eij,eb->aibj", Ej, Hj, Ej)
             + torch.einsum("ea,eij,eb->aibj", Ei, Hij, Ej)
             + torch.einsum("ea,eji,eb->aibj", Ej, Hij, Ei))
        b = Ei.T @ bi + Ej.T @ bj                                     # (N,6)
        Hf = H.reshape(6 * N, 6 * N)
        Hf = Hf + torch.diag(torch.where(free6, lam, 1e6) + 1e-9)
        bf = torch.where(free6, b.reshape(-1), 0.0)
        # solve_ex: no host check of the pivots (as jnp.linalg.solve)
        dx = -torch.linalg.solve_ex(Hf, bf)[0].reshape(N, 6)
        dx = torch.where(free[:, None], dx, 0.0)
        q_new, t_new = se3.boxplus(q, t, dx)
        new_cost = cost_fn(q_new, t_new)
        accept = new_cost < cost
        q = torch.where(accept, q_new, q)
        t = torch.where(accept, t_new, t)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9), lam * 4.0)
        cost = torch.minimum(new_cost, cost)
    return q, t, cost
