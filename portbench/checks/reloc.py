"""Relocalization after a tracking loss: the place recognition (the
vocabulary's tree descent, the keyframe database's TF-IDF L1 scores) and
the pose recovered from the accepted keyframe.

Captures, from before the system is built (`prepare`), every keyframe
added to the database (a reused slot too), with its descriptors and the
BoW vector the program stored; the program's inverted file as it stands
at the window's start; and for the window every call of
`Relocalizer.relocalize`: the frame's descriptors and valid mask, the
words the program's descent gave them, the candidates the database query
returned with their scores, the keyframe accepted and the inputs and
output of its pose solve (K1).

The reference (`reference/bow.py`) trains its own vocabulary from the
descriptors the harness made for the program's and builds its own
database from every keyframe added, in order: each gets the reference's
BoW vector, held against the program's. At the window's start its
inverted file is held against the program's, posting by posting. At a
sample of the relocalize calls drawn from the seed (every accepted one,
up to `ACCEPTED`, and `REJECTED` others) the reference descends the
frame's descriptors, scores its own database and ranks the candidates;
the accepted pose is solved again in float64 (`reference/pose_solver.py`).

Numbers: words that differ (the query's, row by row; the keyframes',
word by word), postings in one inverted file and not the other,
candidates ranked differently up to the accepted one, the largest gaps
of the scores and of the BoW values (the keyframes' and the postings'),
and the accepted pose's gaps. Controls: the descent taking ties last; the BoW
arithmetic in float16 (and the pose solve in bfloat16).
"""

from __future__ import annotations

import random
import threading

import numpy as np
import torch

from ..capture import clone
from ..reference import bow
from .pose import _gap, solve

ACCEPTED = 16
REJECTED = 6
TOP = 5               # the candidates the program's query returns
LIMITS = {"reloc_words_differing": 0, "reloc_postings_differing": 0, "reloc_rank_differing": 0,
          "reloc_score_gap": 1e-6, "reloc_bow_gap": 1e-6, "reloc_t_gap_mm": 0.5,
          "reloc_r_gap_mrad": 0.15}
CONTROLS = ("ties_last", "f16")


def prepare(patch, seed: int) -> dict:
    """From before the system is built: every keyframe added to the
    database (a reused slot too), with its descriptors and the BoW vector
    the program stored."""
    from gmmloc_tpu_torch.vocab import bow as prog_bow

    journal = []

    def make_add(orig):
        def add(self, kf, descs, valid=None):
            desc, val = np.array(descs, np.uint8), np.array(valid, bool)
            orig(self, kf, descs, valid)
            words, vals = self.bow[kf]
            journal.append(("add", dict(kf=int(kf), desc=desc, valid=val, words=words,
                                        vals=vals)))
        return add

    patch.set(prog_bow.KeyFrameDatabase, "add", make_add)
    return {"journal": journal}


def install(patch, seed: int, program) -> dict:
    from gmmloc_tpu_torch.solver import cuda_pose
    from gmmloc_tpu_torch.tracking import relocalize
    from gmmloc_tpu_torch.vocab import bow as prog_bow

    kept = program.prepared["reloc"]
    journal = kept["journal"]
    rel = program.system.relocalizer
    if rel is None:
        return kept
    # the program's inverted file at the window's start, to hold against
    # the one the reference builds from every keyframe added before it
    kept.update(seed=seed, spec=program.config["vocabulary"], descs=program.vocabulary_descs,
                start=len(journal), inv={w: dict(d) for w, d in enumerate(rel.db.inv) if d})
    active = threading.local()

    def current():
        return getattr(active, "item", None)

    def make_relocalize(orig):
        def relocalize_(self, frame):
            item = dict(desc=frame.desc.copy(), valid=frame.valid.copy(), words=None,
                        cands=None, solve=None)
            active.item = item
            try:
                ok = orig(self, frame)
            finally:
                active.item = None
            item.update(ok=bool(ok), kf=int(frame.ref_kf) if ok else None)
            journal.append(("reloc", item))
            return ok
        return relocalize_

    def make_words(orig):
        def transform_words(self, descs):
            words = orig(self, descs)
            item = current()
            if item is not None:
                item["words"] = np.array(words)
            return words
        return transform_words

    def make_query(orig):
        def query(self, descs, valid=None, top=TOP):
            cands = orig(self, descs, valid, top)
            item = current()
            if item is not None:
                item["cands"] = list(cands)
            return cands
        return query

    def make_solve(orig):
        def optimize_pose(cam, *args, **kw):
            item = current()
            if item is None:
                return orig(cam, *args, **kw)
            inputs = [clone(a) for a in args]
            out = orig(cam, *args, **kw)
            item["solve"] = dict(inputs=inputs, kw=dict(kw), q=clone(out.q), t=clone(out.t))
            return out
        return optimize_pose

    patch.set(relocalize.Relocalizer, "relocalize", make_relocalize)
    patch.set(prog_bow.KeyFrameDatabase, "query", make_query)
    patch.set(prog_bow.Vocabulary, "transform_words", make_words)
    patch.set(cuda_pose, "optimize_pose", make_solve)
    return kept


def _sample(calls: list, seed: int) -> set:
    """The relocalize calls compared: every accepted one (a sample of
    `ACCEPTED` if more) and `REJECTED` of the others, drawn from the
    seed."""
    rng = random.Random(seed * 2 + 11)
    acc = [i for i, c in enumerate(calls) if c["ok"]]
    rej = [i for i, c in enumerate(calls) if not c["ok"]]
    return set(rng.sample(acc, min(ACCEPTED, len(acc))) + rng.sample(rej, min(REJECTED,
                                                                                 len(rej))))


def _vec_gap(ref: dict, got: dict) -> tuple:
    """(words in one vector and not the other, the largest gap of a
    value of a word in both)."""
    common = ref.keys() & got.keys()
    gap = max((abs(float(ref[w]) - float(got[w])) for w in common), default=0.0)
    return len(ref.keys() ^ got.keys()), gap


def _postings_gap(ref_inv: dict, got_inv: dict) -> tuple:
    """(postings, a word's keyframe, in one inverted file and not the
    other, the largest gap of a value in both)."""
    n, gap = 0, 0.0
    for w in ref_inv.keys() | got_inv.keys():
        m, g = _vec_gap(ref_inv.get(w, {}), got_inv.get(w, {}))
        n, gap = n + m, max(gap, g)
    return n, gap


def numbers(kept: dict, ref: dict, control: str | None = None) -> dict:
    journal = kept["journal"]
    calls = [it for kind, it in journal if kind == "reloc"]
    if not calls:
        return {}
    if "_voc" not in kept:
        spec = kept["spec"]
        kept["_voc"] = bow.train(kept["descs"], spec["k"], spec["depth"], spec["seed"])
    voc = kept["_voc"]
    ties = "last" if control == "ties_last" else "first"
    dtype = np.float16 if control == "f16" else np.float64

    def vector(desc, valid, dt=np.float64, how="first"):
        return voc.bow_vector(voc.descend(desc, how), valid, dt)

    words_diff = rank_diff = postings_diff = 0
    score_gap = bow_gap = t_gap = r_gap = 0.0
    # the reference's database, built from every keyframe added since the
    # system was built, and the program's (or the control's) beside it
    ref_db = bow.Database()
    ctl_db = bow.Database() if control else None
    sample = _sample(calls, kept["seed"])
    n_call = -1
    for n, (kind, it) in enumerate(journal):
        if n == kept["start"]:
            postings_diff, g = _postings_gap(ref_db.inv, ctl_db.inv if control else kept["inv"])
            bow_gap = max(bow_gap, g)
        if kind == "add":
            want = vector(it["desc"], it["valid"])
            if control:
                got = vector(it["desc"], it["valid"], dtype, ties)
                ctl_db.add(it["kf"], got)
            else:
                got = dict(zip(it["words"].tolist(), it["vals"]))
            n_w, g = _vec_gap(want, got)
            words_diff, bow_gap = words_diff + n_w, max(bow_gap, g)
            ref_db.add(it["kf"], want)
            continue
        n_call += 1
        if n_call not in sample:
            continue
        words = voc.descend(it["desc"])
        want = ref_db.query(voc.bow_vector(words, it["valid"]), TOP)
        if control:
            got_words = voc.descend(it["desc"], ties)
            got = ctl_db.query(voc.bow_vector(got_words, it["valid"], dtype), TOP, dtype)
        else:
            got_words, got = it["words"], it["cands"] or []
        if got_words is not None:
            words_diff += int((np.asarray(got_words) != words).sum())
        # the ranks up to the accepted candidate (all of them when none was)
        wk, gk = [k for k, _ in want], [k for k, _ in got]
        upto = (gk.index(it["kf"]) + 1 if it["ok"] and it["kf"] in gk
                else max(len(wk), len(gk)))
        rank_diff += sum(1 for j in range(upto)
                         if (wk[j] if j < len(wk) else None) != (gk[j] if j < len(gk) else None))
        ws = dict(want)
        score_gap = max([score_gap] + [abs(ws[k] - s) for k, s in got if k in ws])
        if it["ok"] and it["solve"] is not None:
            q_ref, t_ref = solve(it["solve"], ref["cam"], torch.float64, False)
            if control == "f16":
                q, t = solve(it["solve"], ref["cam"], torch.bfloat16, False)
            else:
                q, t = it["solve"]["q"].cpu(), it["solve"]["t"].cpu()
            a, b = _gap(q, t, q_ref, t_ref)
            t_gap, r_gap = max(t_gap, a), max(r_gap, b)
    return {"reloc_words_differing": words_diff, "reloc_postings_differing": postings_diff,
            "reloc_rank_differing": rank_diff, "reloc_score_gap": score_gap,
            "reloc_bow_gap": bow_gap, "reloc_t_gap_mm": t_gap, "reloc_r_gap_mrad": r_gap}
