"""Sharding over ranks: GMM association with the components split, and the
local BA with points and observations split.

PyTorch port of `gmmloc_tpu/parallel/sharding.py`. The JAX package lets
GSPMD place collectives into single-program code over a mesh; here a rank
is one process (`distributed.py`) that holds its own contiguous slice of
the sharded axis, and the collectives are explicit. Every one of them is
an all-reduce of a sum over a `Mesh`:

  - a sum across ranks (the BA's camera system, costs) sums the ranks'
    partial sums;
  - a gather is an all-reduce of a zero buffer into which each rank wrote
    its own rows. The rows travel as their bit patterns, as integers
    (x + 0 is exact for any pattern, -0.0 and inf included), so a
    gathered array equals the one its owners computed, bit for bit.

NCCL takes these on CUDA tensors; gloo takes CUDA tensors in all_reduce
(it stages them through host memory itself; int32 and float64 checked on
an H100), so both backends get the tensors as they are and the port
stages nothing.

  - association: each rank projects and gates its components, the 2-D
    arrays are gathered, each rank runs occlusion on its own rows against
    all of them and the `visible` flags are gathered; the search takes a
    top-k per rank over its own columns, gathers (d2, global index) and
    merges by (d2, index), ties to the lower index as XLA's top_k breaks
    them. The results equal the unsharded `render_view` and
    `search_correspondence`.
  - local BA: points and their observation rows are split, cameras and
    the prior replicated; `solve_local_ba`'s `reduce_sum` hook sums H_cc,
    b_c, the Schur term, T b_p and the costs across ranks each LM
    iteration (the JAX package's psum of Schur blocks), so every rank
    takes the same steps (the hook's sums accumulate in float64, so the
    steps do not hang on how the points are split); the points are
    gathered back at the end.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..gmm import gaussian, mixture, render
from ..solver import local_ba

_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


class Mesh:
    """The ranks of the default group as a 1-D mesh (the "shard" axis):
    this rank, the group's size, and the all-reduce every collective here
    goes through. Counts calls and bytes, and times each call on the host
    clock between device synchronizations (the sharded paths run eagerly
    and wait for the device once per LM iteration anyway)."""

    def __init__(self):
        import torch.distributed as dist

        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    def reset_stats(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks (a new tensor)."""
        import torch.distributed as dist

        out = t.reshape(-1).clone()
        _sync(out)
        t0 = time.perf_counter()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        _sync(out)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.bytes += out.numel() * out.element_size()
        return out.reshape(t.shape)

    def gather_rows(self, local: torch.Tensor, offset: int, total: int) -> torch.Tensor:
        """(total, ...) holding each rank's `local` rows at its offset,
        bit for bit (rows no rank wrote are zero)."""
        dt = local.dtype
        x = local.to(torch.int32) if dt == torch.bool else local.contiguous()
        if dt in _BITS:
            x = x.view(_BITS[dt])
        buf = torch.zeros((total,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        buf[offset:offset + x.shape[0]] = x
        buf = self.all_reduce(buf)
        if dt == torch.bool:
            return buf != 0
        return buf.view(dt) if dt in _BITS else buf


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def make_mesh() -> Mesh:
    """The mesh of all ranks of the default group (one device each: the
    JAX package's `make_mesh(n_devices)` spans devices, a rank here drives
    one)."""
    return Mesh()


def _split(n: int, mesh: Mesh):
    """(offset, rows per rank, padded total) of a contiguous split of n
    rows, padded to a multiple of the mesh size."""
    per = -(-n // mesh.size)
    return mesh.rank * per, per, per * mesh.size


# ---------------------------------------------------------------------------
# sharded GMM association
# ---------------------------------------------------------------------------


class ShardedGMM(NamedTuple):
    gmap: mixture.GMMMap   # this rank's components (padding: valid=False)
    offset: int            # global index of its first component
    n_total: int           # components of the whole map


def shard_gmm_map(gmap: mixture.GMMMap, mesh: Mesh) -> ShardedGMM:
    """This rank's contiguous slice of the components. K is padded to a
    multiple of the mesh size with invalid components (copies of the last
    one with valid=False). The slice carries no host copies."""
    K = gmap.means.shape[0]
    off, per, _ = _split(K, mesh)
    rows = torch.arange(off, off + per, device=gmap.means.device)
    src = torch.clamp(rows, max=K - 1)
    fields = {k: getattr(gmap, k)[src] for k in mixture.FIELDS}
    fields["valid"] = fields["valid"] & (rows < K)
    return ShardedGMM(mixture.GMMMap(**fields, host={}), off, K)


def render_view_sharded(sg: ShardedGMM, cam, q_cw, t_cw, mesh: Mesh,
                        view_cos_deg: float = 78.0, cov2d_scale_thresh: float = 4.0,
                        occlusion_bh_thresh: float = 0.8,
                        block: int = 512) -> render.Render2D:
    """`render_view` with the components sharded: the per-component gates
    on this rank's slice, the projected 2-D arrays gathered, occlusion on
    this rank's rows, `visible` gathered. Returns the whole map's Render2D
    on every rank."""
    pr = render.project_components(sg.gmap, cam, q_cw, t_cw, view_cos_deg,
                                   cov2d_scale_thresh)
    per = pr.uv.shape[0]
    total = per * mesh.size
    cols = torch.cat([pr.uv, pr.cov2d.reshape(per, 4), pr.depth[:, None],
                      pr.alive[:, None].to(pr.uv.dtype)], 1)          # (per, 8)
    g = mesh.gather_rows(cols, sg.offset, total)
    uv, cov2d, depth, alive = g[:, 0:2], g[:, 2:6].reshape(total, 2, 2), g[:, 6], g[:, 7] > 0
    occ = render.occluded_rows(uv, cov2d[:, 0, 0], cov2d[:, 0, 1], cov2d[:, 1, 1], depth,
                               alive, (sg.offset, sg.offset + per), occlusion_bh_thresh,
                               block)
    visible = mesh.gather_rows(pr.alive & ~occ, sg.offset, total)
    K = sg.n_total
    cov2d_inv, _ = gaussian.inv2x2(cov2d[:K])
    return render.Render2D(uv[:K], cov2d[:K], cov2d_inv, depth[:K], visible[:K])


def search_correspondence_sharded(r2d: render.Render2D, feat_uv, feat_valid, sg: ShardedGMM,
                                  mesh: Mesh, knn: int = 5, mdist2_thresh: float = 9.0):
    """`search_correspondence` with the (N, K) distance matrix sharded over
    K: a top-k over this rank's own columns of the (whole-map) `r2d`,
    (d2, global index) gathered from every rank and merged by (d2, index),
    then the Mahalanobis gate. (N, knn) int64, -1 where gated out, by
    increasing distance."""
    N = feat_uv.shape[0]
    per = sg.gmap.means.shape[0]
    lo, hi = sg.offset, min(sg.offset + per, sg.n_total)
    d2 = torch.sum((feat_uv[:, None, :] - r2d.mean2d[None, lo:hi, :]) ** 2, dim=-1)
    d2 = torch.where(r2d.visible[None, lo:hi], d2, float("inf"))
    k = min(knn, hi - lo)
    top = torch.full((N, knn), float("inf"), dtype=d2.dtype, device=d2.device)
    cand = torch.zeros((N, knn), dtype=torch.int64, device=d2.device)
    if k > 0:
        t, c = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        top[:, :k], cand[:, :k] = t, c + lo
    # (knn * size, N) rows: this rank's candidates at rows rank*knn...
    top_all = mesh.gather_rows(top.T.contiguous(), mesh.rank * knn, mesh.size * knn).T
    cand_all = mesh.gather_rows(cand.T.contiguous(), mesh.rank * knn, mesh.size * knn).T
    # by (d2, index): sort by index, then stably by distance
    by_idx = torch.argsort(cand_all, dim=1, stable=True)
    top_all, cand_all = top_all.gather(1, by_idx), cand_all.gather(1, by_idx)
    by_d2 = torch.argsort(top_all, dim=1, stable=True)[:, :knn]
    top, cand = top_all.gather(1, by_d2), cand_all.gather(1, by_d2)
    found = torch.isfinite(top)
    md2 = gaussian.mdist2_2d(r2d.mean2d[cand], r2d.cov2d_inv[cand], feat_uv[:, None, :])
    keep = found & (md2 < mdist2_thresh) & feat_valid[:, None]
    return torch.where(keep, cand, -1)


# ---------------------------------------------------------------------------
# sharded local BA
# ---------------------------------------------------------------------------


class ShardedBA(NamedTuple):
    prob: local_ba.BAProblem   # this rank's points (padding: pt_valid=False)
    offset: int                # global index of its first point
    n_total: int               # points of the whole problem


def shard_ba_problem(prob: local_ba.BAProblem, mesh: Mesh) -> ShardedBA:
    """Points and their observation rows in contiguous slices, padded to a
    multiple of the mesh size with invalid points (no observation:
    obs_cam -1, obs_valid False, pt_valid False), which add exact zeros to
    every sum; cameras and the prior replicated."""
    P = prob.pts.shape[0]
    off, per, _ = _split(P, mesh)
    rows = torch.arange(off, off + per, device=prob.pts.device)
    real = rows < P
    src = torch.clamp(rows, max=P - 1)
    per_point = {k: getattr(prob, k)[src] for k in (
        "pts", "pt_valid", "obs_cam", "obs_uvr", "obs_stereo", "obs_sigma2_inv",
        "obs_valid", "str_type", "str_normal", "str_mean", "str_sqrt_info")}
    per_point["pt_valid"] = per_point["pt_valid"] & real
    per_point["obs_cam"] = torch.where(real[:, None], per_point["obs_cam"], -1)
    per_point["obs_valid"] = per_point["obs_valid"] & real[:, None]
    local = prob._replace(**per_point)
    return ShardedBA(local, off, P)


def solve_local_ba_sharded(cam, sp: ShardedBA, mesh: Mesh, n_free: int,
                           **kw) -> local_ba.BAResult:
    """`solve_local_ba` on this rank's points with the camera system summed
    across the mesh (default "flat" at bfloat16, as the JAX package runs
    it), run eagerly. The hook's sums accumulate in float64, so the result
    is the whole problem's `solve_local_ba(..., reduce_sum=lambda t: t)`
    at any mesh size. The per-point results (pts, obs_bad, str_drop,
    obs_chi2) are gathered back, so every rank returns the whole
    problem's result."""
    res = local_ba.solve_local_ba(cam, sp.prob, n_free, reduce_sum=mesh.all_reduce,
                                  cuda_graph=False, **kw)
    per = sp.prob.pts.shape[0]
    total = per * mesh.size

    def whole(x):
        return mesh.gather_rows(x, sp.offset, total)[:sp.n_total]

    return res._replace(pts=whole(res.pts), obs_bad=whole(res.obs_bad),
                        str_drop=whole(res.str_drop), obs_chi2=whole(res.obs_chi2))
