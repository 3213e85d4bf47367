"""The ORB front end (K4 and the ORB pass): keypoints, descriptors and
stereo depth of the left image.

Captures, for a sample of the window's frames, what `complete` returned
for the pair the harness dispatched: the keypoint table (u, v, u_right,
depth, octave, angle, valid, response) and the descriptors. The
reference (`reference/frontend.py`) runs the whole front end again on the
same uint8 pair on the CPU in float32. The numbers: the share of
keypoints (by level and position) in one set and not the other, the share
of descriptor bits that differ over the keypoints in both, and the share
of those whose stereo match differs (one side matched and the other not,
or u_right apart by more than STEREO_TOL_PX). The control keeps the
pyramid and the blurred levels in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from ..capture import Reservoir
from ..reference import frontend as ref_frontend

FRAMES = 2
STEREO_TOL_PX = 0.01
LIMITS = {"fe_keypoints_differing": 0.01, "fe_desc_bits_differing": 0.008,
          "fe_stereo_differing": 0.03}
CONTROLS = ("bf16",)


def install(patch, seed: int, program) -> dict:
    fe = getattr(program, "frontend", None)
    if fe is None:
        return {}
    res = Reservoir(FRAMES, seed * 2 + 13)

    def make(orig):
        def complete(pend):
            frame = orig(pend)
            slot = res.offer()
            if slot is not None:
                res.put(slot, dict(idx=pend.idx, table=pend.table.numpy().copy(),
                                   desc=pend.desc.numpy().copy()))
            return frame
        return complete

    patch.set(fe, "complete", make)
    return {"frames": res, "images": program.images}


def _keys(table):
    ok = table[:, 6] > 0.5
    return {(int(o), round(float(u), 3), round(float(v), 3)): i
            for i, (u, v, o) in enumerate(zip(table[:, 0], table[:, 1], table[:, 4])) if ok[i]}


def compare(table, desc, ref_table, ref_desc) -> tuple:
    """(keypoints differing / reference keypoints, descriptor bits
    differing / bits compared, stereo differing / keypoints compared)."""
    ka, kb = _keys(table), _keys(ref_table)
    both = [k for k in kb if k in ka]
    kp = (len(ka) + len(kb) - 2 * len(both)) / max(1, len(kb))
    if not both:
        return kp, 1.0, 1.0
    ia = np.array([ka[k] for k in both])
    ib = np.array([kb[k] for k in both])
    bits = np.unpackbits(desc[ia] ^ ref_desc[ib], axis=1).sum() / (256.0 * len(both))
    ur_a, ur_b = table[ia, 2], ref_table[ib, 2]
    st_a, st_b = ur_a >= 0, ur_b >= 0
    st = ((st_a != st_b) | (st_a & st_b & (np.abs(ur_a - ur_b) > STEREO_TOL_PX))).mean()
    return kp, float(bits), float(st)


def numbers(kept: dict, ref: dict, control: str | None = None) -> dict:
    cam = ref["frontend"]
    if not kept:
        return {}
    items = kept["frames"].kept()
    if not items:
        return {}
    worst = [0.0, 0.0, 0.0]
    for it in items:
        left, right = kept["images"][it["idx"]]
        ref_t, ref_d = ref_frontend.features(left, right, cam)
        if control:
            t, d = ref_frontend.features(left, right, cam, store=torch.bfloat16)
        else:
            t, d = it["table"], it["desc"]
        worst = [max(a, b) for a, b in zip(worst, compare(t, d, ref_t, ref_d))]
    return dict(zip(("fe_keypoints_differing", "fe_desc_bits_differing",
                     "fe_stereo_differing"), worst))
