"""Run checkpoint / resume for long evaluation sweeps.

The port's own copy of `gmmloc_tpu/pipeline/checkpoint.py` (numpy only),
in the same format, so that either package loads the other's file: one
`.npz` of the world's struct-of-arrays tables, the free lists, the
keyframe order and the per-frame trajectory records, plus a small JSON
side record (`<path>.json`) with the frame cursor. The reference
persists nothing mid-run (only the GMM map at start-up and the
trajectory at shutdown).

One array more than the JAX package writes: `pt_assoc_vetted` (whether a
landmark's GMM association has survived a joint BA, which gates the pose
anchors and the mirror's `pt_comp`). The JAX loader reads only the
arrays it lists, so it still loads the port's files; the port reads the
array where the file has it and otherwise leaves the target's flags.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from ..mapping.map_state import FrameInfo, MapState

_ARRAY_FIELDS = [
    "kf_valid", "kf_q", "kf_t", "kf_frame_idx", "kf_timestamp",
    "kf_feat_uv", "kf_feat_ur", "kf_feat_depth", "kf_feat_octave",
    "kf_feat_angle", "kf_feat_desc", "kf_feat_valid", "kf_obs_point",
    "kf_comp_cand", "covis", "covis_link",
    "pt_valid", "pt_pos", "pt_normal", "pt_min_dist", "pt_max_dist",
    "pt_desc", "pt_ref_kf", "pt_created_kf_idx", "pt_num_found",
    "pt_num_visible", "pt_n_obs", "pt_obs_kf", "pt_obs_feat",
    "pt_assoc_comp", "pt_type", "pt_replaced_by", "pt_last_visible_idx",
    "pt_fuse_tgt_kf",
]
_OPTIONAL_FIELDS = ["pt_assoc_vetted"]

FORMAT_VERSION = 1


def save_checkpoint(path: str, world: MapState, frame_cursor: int,
                    extra: Optional[dict] = None) -> None:
    arrays = {f: getattr(world, f) for f in _ARRAY_FIELDS + _OPTIONAL_FIELDS}
    arrays["_free_kf"] = np.array(world._free_kf, np.int64)
    arrays["_free_pt"] = np.array(world._free_pt, np.int64)
    arrays["_kf_order"] = np.array(world._kf_order, np.int64)
    fis = world.frame_infos
    arrays["fi_ts"] = np.array([fi.timestamp for fi in fis])
    arrays["fi_ref"] = np.array([fi.ref_kf for fi in fis], np.int64)
    arrays["fi_q"] = np.stack([fi.q_cr for fi in fis]) if fis else np.zeros((0, 4))
    arrays["fi_t"] = np.stack([fi.t_cr for fi in fis]) if fis else np.zeros((0, 3))
    # np.savez appends ".npz" to a name without it: write the temporary
    # file under that name and rename it into place
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    meta = {
        "version": FORMAT_VERSION,
        "frame_cursor": int(frame_cursor),
        "max_kf_frame_idx": int(world.max_kf_frame_idx),
        "extra": extra or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, world: MapState) -> Tuple[int, dict]:
    """Restore into an already-constructed MapState of the same
    capacities. Returns (frame_cursor, extra). Every live row is marked
    dirty and `map_version` moves on, so a `DeviceWorld` mirror re-uploads
    the whole world at its next `sync()`."""
    with open(path + ".json") as f:
        meta = json.load(f)
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {meta['version']}, expected {FORMAT_VERSION}")
    with np.load(path) as z:
        for f in _ARRAY_FIELDS + [f for f in _OPTIONAL_FIELDS if f in z.files]:
            tgt, src = getattr(world, f), z[f]
            if tgt.shape != src.shape:
                raise ValueError(f"checkpoint {f}: shape {src.shape}, world {tgt.shape}")
            tgt[...] = src
        world._free_kf = list(z["_free_kf"])
        world._free_pt = list(z["_free_pt"])
        world._kf_order = [int(x) for x in z["_kf_order"]]
        world.frame_infos = [
            FrameInfo(float(t), int(r), q, tt)
            for t, r, q, tt in zip(z["fi_ts"], z["fi_ref"], z["fi_q"], z["fi_t"])
        ]
    world.max_kf_frame_idx = meta["max_kf_frame_idx"]
    world.dirty_kf.update(np.where(world.kf_valid)[0].tolist())
    world.dirty_pt.update(np.where(world.pt_valid)[0].tolist())
    world.map_version += 1
    return meta["frame_cursor"], meta.get("extra", {})
