"""The Hamming matrices K3 computes for the guided matching, the stereo
matching, the triangulation search and the fusion.

Captures a sample of the calls of `features.matching.hamming_matrix`
(every caller looks it up there): up to ROWS rows of the query
descriptors, drawn from the seed, all the candidates, and those rows of
the matrix the call returned. The reference (`reference/hamming.py`)
recomputes them; the number is how many entries differ. Integers: the
limit is 0, and no lower precision applies.
"""

from __future__ import annotations

import torch

from ..capture import Reservoir, clone
from ..reference.hamming import hamming_matrix

CALLS = 6
ROWS = 256
LIMITS = {"k3_entries_differing": 0}
CONTROLS = ()


def install(patch, seed: int, program) -> dict:
    from gmmloc_tpu_torch.features import matching

    res = Reservoir(CALLS, seed * 2 + 7)
    gen = torch.Generator().manual_seed(seed)

    def make(orig):
        def hamming(desc_a, desc_b, out=None, **kw):
            slot = res.offer()
            if slot is None:
                return orig(desc_a, desc_b, out=out, **kw) if out is not None \
                    else orig(desc_a, desc_b, **kw)
            rows = torch.randperm(desc_a.shape[0], generator=gen)[:ROWS].to(desc_a.device)
            a, b = clone(desc_a[rows]), clone(desc_b)
            res_ = orig(desc_a, desc_b, out=out, **kw) if out is not None \
                else orig(desc_a, desc_b, **kw)
            res.put(slot, dict(a=a, b=b, d=clone(res_[rows])))
            return res_
        return hamming

    patch.set(matching, "hamming_matrix", make)
    return {"hamming_matrix": res}


def numbers(kept: dict, ref: dict, control: str | None = None) -> dict:
    items = kept["hamming_matrix"].kept()
    if not items:
        return {}
    bad = 0
    for it in items:
        ref = hamming_matrix(it["a"].cpu(), it["b"].cpu())
        got = ref.clone() if control else it["d"].cpu().to(torch.int32)
        bad += int((got != ref).sum())
    return {"k3_entries_differing": bad}
