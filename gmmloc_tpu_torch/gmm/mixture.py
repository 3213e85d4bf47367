"""The prior GMM map as component tensors on one device.

PyTorch port of `gmmloc_tpu/gmm/mixture.py` (ref gaussian_mixture.cpp):
components padded to a static capacity, a (K, NB) Bhattacharyya
neighbour table built once at load time on the host, and float64 host
copies for the host-side bookkeeping (`host_view`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import native
from ..utils.device import resolve

FIELDS = ("means", "covs", "cov_inv", "det", "scale", "axis", "normal",
          "sqrt_info", "is_degenerated", "is_salient", "valid", "neighbors")


@dataclass
class GMMMap:
    """Padded component tensors; `valid` masks real components. `host`
    holds float64 numpy copies of means/cov_inv/normal/sqrt_info and the
    flags and neighbour table."""

    means: torch.Tensor       # (K,3)
    covs: torch.Tensor        # (K,3,3)
    cov_inv: torch.Tensor     # (K,3,3)
    det: torch.Tensor         # (K,)
    scale: torch.Tensor       # (K,3) ascending eigenvalues
    axis: torch.Tensor        # (K,3,3) eigenvectors as columns
    normal: torch.Tensor      # (K,3) smallest-eigenvalue direction
    sqrt_info: torch.Tensor   # (K,3,3) lower Cholesky of cov_inv
    is_degenerated: torch.Tensor  # (K,) bool
    is_salient: torch.Tensor  # (K,) bool
    valid: torch.Tensor       # (K,) bool
    neighbors: torch.Tensor   # (K,NB) int64, -1 padded
    host: dict


def build_neighbor_graph(means, covs, dets, valid, thresh: float, cap: int,
                         block: int = 256):
    """(K, cap) neighbour table: Bhattacharyya distance < thresh, self
    excluded, the `cap` nearest kept, -1 padded (ref gaussian_mixture.cpp:
    61-78). A spatial prefilter (BH >= |d|^2 / (4 (tr_a + tr_b))) limits
    the closed-form BH to candidate pairs. Load-time only, float64 numpy."""
    K = means.shape[0]
    neighbors = np.full((K, cap), -1, dtype=np.int32)
    means = np.asarray(means, np.float64)
    covs = np.asarray(covs, np.float64)
    dets = np.asarray(dets, np.float64)
    valid = np.asarray(valid)
    tr = covs[:, 0, 0] + covs[:, 1, 1] + covs[:, 2, 2]
    C = {k: covs[:, i, j] for k, (i, j) in
         dict(a=(0, 0), b=(0, 1), c=(0, 2), e=(1, 1), f=(1, 2), i=(2, 2)).items()}
    for start in range(0, K, block):
        stop = min(start + block, K)
        d = means[None, :] - means[start:stop, None]
        dist2 = np.einsum("bki,bki->bk", d, d)
        gate = dist2 < 4.0 * thresh * (tr[start:stop, None] + tr[None, :])
        gate &= valid[None, :] & valid[start:stop, None]
        gate[np.arange(stop - start), np.arange(start, stop)] = False
        rr, cc = np.nonzero(gate)
        if len(rr) == 0:
            continue
        gi = rr + start
        a, b, c3, e, f, i3 = (0.5 * (C[k][gi] + C[k][cc]) for k in "abcefi")
        det_c = a * (e * i3 - f * f) - b * (b * i3 - f * c3) + c3 * (b * f - e * c3)
        dx, dy, dz = (means[cc] - means[gi]).T
        quad = (
            dx * dx * (e * i3 - f * f) + dy * dy * (a * i3 - c3 * c3)
            + dz * dz * (a * e - b * b)
            + 2.0 * (dx * dy * (c3 * f - b * i3) + dx * dz * (b * f - c3 * e)
                     + dy * dz * (b * c3 - a * f))
        ) / np.clip(det_c, 1e-300, None)
        bh = quad / 8.0 + 0.5 * np.log(
            np.clip(det_c, 1e-300, None)
            / np.sqrt(np.clip(dets[gi] * dets[cc], 1e-300, None))
        )
        ok = bh < thresh
        rr, cc, bh = rr[ok], cc[ok], bh[ok]
        for r in np.unique(rr):
            sel = rr == r
            idx = cc[sel]
            if len(idx) > cap:
                idx = idx[np.argsort(bh[sel])[:cap]]
            neighbors[start + r, : len(idx)] = idx
    return neighbors


def _host_view(arrs: dict) -> dict:
    return {
        "means": np.asarray(arrs["means"], np.float64),
        "cov_inv": np.asarray(arrs["cov_inv"], np.float64),
        "normal": np.asarray(arrs["normal"], np.float64),
        "sqrt_info": np.asarray(arrs["sqrt_info"], np.float64),
        "is_degenerated": np.asarray(arrs["is_degenerated"], bool),
        "neighbors": np.asarray(arrs["neighbors"]),
        "valid": np.asarray(arrs["valid"], bool),
    }


def _to_device(arrs: dict, host: dict, device) -> GMMMap:
    t = {}
    for k in FIELDS:
        a = np.asarray(arrs[k])
        if a.dtype == bool:
            t[k] = torch.tensor(a, device=device)
        elif k == "neighbors":
            t[k] = torch.tensor(a, dtype=torch.int64, device=device)
        else:
            t[k] = torch.tensor(a, dtype=torch.float32, device=device)
    return GMMMap(**t, host=host)


def from_arrays(means, covs, device="cuda", pad_to: int | None = None,
                neighbor_dist_thresh: float = 2.5, neighbor_cap: int = 16,
                degenerate_eig_thresh: float = 1e-4,
                salient_eig_thresh: float = 0.2,
                build_neighbors: bool = True) -> GMMMap:
    """GMMMap from raw (K,3)/(K,3,3) arrays: float64 eigendecomposition,
    inverse, determinant and Cholesky on the host, padded to `pad_to`
    (identity covariances in the padding), then float32 on `device`.
    `build_neighbors=False` skips the O(K^2) neighbour pass and leaves the
    neighbour table at -1 (a map whose users never read it)."""
    device = resolve(device)
    means = np.asarray(means, dtype=np.float64)
    covs = np.asarray(covs, dtype=np.float64)
    K = means.shape[0]
    cap = pad_to or K
    evals, evecs = np.linalg.eigh(covs)
    cov_inv = np.linalg.inv(covs)
    det = np.linalg.det(covs)
    is_deg = evals[:, 0] < degenerate_eig_thresh
    is_sal = (evals[:, 1] > salient_eig_thresh) & (evals[:, 2] > salient_eig_thresh)
    sqrt_info = np.linalg.cholesky(cov_inv)

    def pad(a, fill=0.0):
        out = np.full((cap,) + a.shape[1:], fill, dtype=a.dtype)
        out[:K] = a
        return out

    neighbors = np.full((cap, neighbor_cap), -1, dtype=np.int32)
    if build_neighbors:
        neighbors[:K] = build_neighbor_graph(
            means, covs, det, np.ones(K, dtype=bool), neighbor_dist_thresh,
            neighbor_cap)
    eye = lambda a: np.concatenate([a[:K], np.tile(np.eye(3), (cap - K, 1, 1))])
    axis_p = eye(pad(evecs))
    valid = np.zeros(cap, dtype=bool)
    valid[:K] = True
    arrs = dict(
        means=pad(means), covs=eye(pad(covs)), cov_inv=eye(pad(cov_inv)),
        det=pad(det, 1.0), scale=pad(evals), axis=axis_p,
        normal=axis_p[:, :, 0], sqrt_info=eye(pad(sqrt_info)),
        is_degenerated=pad(is_deg, False), is_salient=pad(is_sal, False),
        valid=valid, neighbors=neighbors,
    )
    return _to_device(arrs, _host_view(arrs), device)


def from_jax_map(gmap_np, device) -> GMMMap:
    """The port's map from the JAX `GMMMap` fields as numpy arrays (a
    NamedTuple or a dict with the same field names): the same values,
    float32 tensors on `device`, host copies in float64."""
    arrs = gmap_np._asdict() if hasattr(gmap_np, "_asdict") else dict(gmap_np)
    arrs = {k: np.asarray(arrs[k]) for k in FIELDS}
    return _to_device(arrs, _host_view(arrs), device)


def host_view(gmap: GMMMap) -> dict:
    return gmap.host


def load(path: str, device="cuda", pad_to: int | None = None, **kw) -> GMMMap:
    """Load a `.gmm` protobuf stream (ref loadGMMModel, gmm_utils.cpp:9-67)
    through the native parser (`utils/native.py`, built from
    `native/gmmloc_native.cpp`), as the JAX package's `load` does."""
    means, covs, _, _ = native.load_gmm_file(path)
    return from_arrays(means, covs, device, pad_to=pad_to, **kw)
