"""The keyframe association against the prior map: the GMM render, the
candidate search and the point-to-component solves (the association the
pose solves' anchors and the BA's structure terms come from).

Captures a sample of the calls of
`mapping.association.associate_and_check_kernel` (the keyframe mapping
looks it up at each keyframe, inline offline and on the mapper thread
online): the keyframe's pose and its features as the program handed
them in, and what the call returned (candidates, association, points).
The reference (`reference/association.py`) derives the map's tables from
the raw means and covariances the benchmark made, the octave table from
the configuration, and associates the same keyframe again on the CPU in
float64, with the configuration's thresholds (`PARAMS`, the upstream's).

The numbers, the worst keyframe of the sample: the share of the
keyframe's features with stereo depth whose association (component or
none) differs, the share of candidate entries that differ, and the
largest gap of an output point (mm) among the features whose association
agrees. The control associates in bfloat16.
"""

from __future__ import annotations

import torch

from ..capture import Reservoir, clone
from ..reference import association as ref_assoc
from ..reference.camera import CameraParams

CALLS = 2
LIMITS = {"assoc_differing": 0.05, "assoc_cand_differing": 0.05, "assoc_pt_gap_mm": 0.05}
CONTROLS = ("bf16",)
# the configuration's map and association settings (cfg/v1.yaml, the
# upstream's inline constants; the port's GMMConfig and LocConfig)
MAP = dict(neighbor_dist_thresh=2.5, neighbor_cap=16, degenerate_eig_thresh=1e-4)
PARAMS = dict(knn=5, mdist2_thresh=9.0, view_cos_deg=78.0, cov2d_scale_thresh=4.0,
              occlusion_bh_thresh=0.8, tri_lambda2=400.0, chi2_stereo=7.815,
              str_chi2_thresh=0.0064 * 400.0, chi2_assoc_3d=9.0, iters=5,
              tri_check_str_chi2=True)
_FIELDS = ("q_cw", "t_cw", "uv", "ur", "octave", "valid", "depth")


def install(patch, seed: int, program) -> dict:
    from gmmloc_tpu_torch.mapping import association

    res = Reservoir(CALLS, seed * 2 + 17)

    def make(orig):
        def kernel(gmap, cam, *args, **kw):
            slot = res.offer()
            if slot is None:
                return orig(gmap, cam, *args, **kw)
            item = {k: clone(a) for k, a in zip(_FIELDS, args)}
            out = orig(gmap, cam, *args, **kw)
            item.update(zip(("cand", "assoc", "pt_out"), (clone(x) for x in out)))
            res.put(slot, item)
            return out
        return kernel

    patch.set(association, "associate_and_check_kernel", make)
    return {"calls": res, "means": program.gmm_means, "covs": program.gmm_covs,
            "pad_to": program.config["map"]["pad_to"], "frame": program.config["frame"]}


def associate(kept: dict, gmap: dict, item: dict, cam: CameraParams, dtype):
    f = kept["frame"]
    sf = torch.tensor([f["scale_factor"] ** l for l in range(f["num_levels"])],
                      dtype=torch.float64)
    x = {k: v.cpu() for k, v in item.items()}
    fl = lambda t: t.to(dtype)  # noqa: E731
    return ref_assoc.associate(
        ref_assoc.as_dtype(gmap, dtype), cam, fl(x["q_cw"]), fl(x["t_cw"]), fl(x["uv"]),
        fl(x["ur"]), x["octave"].long(), x["valid"].bool(), fl(x["depth"]),
        fl(1.0 / (sf * sf)), **PARAMS)


def compare(item: dict, cand, assoc, pt_out, ref) -> tuple:
    """(association differing / features with depth, candidate entries
    differing / entries, largest point gap (mm) where the association
    agrees)."""
    r_cand, r_assoc, r_pt = ref
    feat = item["valid"].cpu().bool() & (item["depth"].cpu() > 0)
    n = max(1, int(feat.sum()))
    diff = (assoc.cpu().long() != r_assoc) & feat
    cand_diff = (cand.cpu().long() != r_cand) & item["valid"].cpu().bool()[:, None]
    same = feat & ~diff
    gap = torch.linalg.norm(pt_out.cpu().double() - r_pt.double(), dim=-1)
    gap = torch.where(torch.isfinite(gap), gap, torch.inf)
    g = float(gap[same].max()) * 1e3 if bool(same.any()) else 0.0
    return (float(diff.sum()) / n, float(cand_diff.sum()) / max(1, cand_diff.numel()), g)


def numbers(kept: dict, ref: dict, control: str | None = None) -> dict:
    items = kept["calls"].kept()
    if not items:
        return {}
    gmap = ref_assoc.gmm_map(kept["means"], kept["covs"], kept["pad_to"], **MAP)
    worst = [0.0, 0.0, 0.0]
    for it in items:
        r = associate(kept, gmap, it, ref["cam"], torch.float64)
        got = (associate(kept, gmap, it, ref["cam"], torch.bfloat16) if control
               else (it["cand"], it["assoc"], it["pt_out"]))
        worst = [max(a, b) for a, b in zip(worst, compare(it, *got, r))]
    return dict(zip(("assoc_differing", "assoc_cand_differing", "assoc_pt_gap_mm"), worst))
