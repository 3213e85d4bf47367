"""`correct` against the control and against faults in the timed path,
at a size a CPU run holds (feat_cap 256, two warm-up frames, a short
window; the program's plain versions stand in for the kernels).

The control puts the checks' reference, at the precision below the one
the configuration states, in the program's place: it has to fail. Each
fault breaks the program underneath the harness for the window (a solve
that returns its state unchanged, a solve over half its features, an
answer or an association altered where it is produced) and has to turn
`correct` false.
"""

import numpy as np
import pytest
import torch

from gmmloc_tpu_torch.features import cuda_kernels
from gmmloc_tpu_torch.mapping import association
from gmmloc_tpu_torch.pipeline import frontend as fe_mod
from gmmloc_tpu_torch.solver import local_ba, pose_solver
from gmmloc_tpu_torch.tracking import relocalize
from gmmloc_tpu_torch.vocab import bow
from portbench import run
from portbench.tests.test_portbench_blackouts import run_blackouts

CUT = dict(frame=dict(feat_cap=256, num_features=240),
           port={"frame.feat_cap": 256, "frame.num_features": 240,
                 "tracking.fused_local_map_cap": 1024})


def _run(cell, seconds, before_window=None, control=False, seed=2**31 + 21):
    res, compared, _ = run.run_cell(cell, seed, seconds, False, "cpu", overrides=CUT,
                                    prewarm=False, warmup=3, before_window=before_window,
                                    control=control)
    return res, compared


@pytest.mark.parametrize("cell,seconds", [("v1_offline_features", 12.0),
                                          ("v1_online_features", 12.0),
                                          ("v1_online_images", 40.0)])
def test_sound_run_is_correct_and_control_fails(cell, seconds):
    """A sound run is correct; a `--control` run (the control's answers in
    the program's place, through the harness's own comparison) is not."""
    res, compared = _run(cell, seconds)
    assert res["correct"], compared
    res, compared = _run(cell, seconds, control=True)
    assert not res["correct"] and res["control"], compared


def _fault(monkeypatch, name):
    """A fault of the program, planted from the window's start."""
    def plant():
        if name == "pose_unchanged":
            def solve(cam, q0, t0, *a, **kw):
                out = orig_anc(cam, q0, t0, *a, **kw)
                return out._replace(q=q0.clone(), t=t0.clone())
            monkeypatch.setattr(pose_solver, "optimize_pose_anchored", solve)
        elif name == "pose_half_batch":
            def solve(cam, q0, t0, x_w, obs, st, s2i, valid, *a, **kw):
                half = valid.clone()
                half[1::2] = False
                return orig_anc(cam, q0, t0, x_w, obs, st, s2i, half, *a, **kw)
            monkeypatch.setattr(pose_solver, "optimize_pose_anchored", solve)
        elif name == "k3_altered":
            def ham(a, b):
                d = orig_ham(a, b)
                if d.numel():
                    d[:, 0] += 1          # each row's first distance
                return d
            monkeypatch.setattr(cuda_kernels, "hamming_matrix_plain", ham)
        elif name == "ba_unchanged":
            def ba(cam, prob, n_free, **kw):
                out = orig_ba(cam, prob, n_free, **kw)
                return out._replace(cam_q=prob.cam_q.clone(), cam_t=prob.cam_t.clone(),
                                    pts=prob.pts.clone())
            monkeypatch.setattr(local_ba, "solve_local_ba", ba)
        elif name == "assoc_altered":
            def kernel(*a, **kw):
                cand, assoc, pt = orig_assoc(*a, **kw)
                # every accepted association moved to the next component
                return cand, torch.where(assoc >= 0, assoc + 1, assoc), pt
            monkeypatch.setattr(association, "associate_and_check_kernel", kernel)
        elif name == "reloc_words_altered":
            def descend(self, desc):
                words = orig_descend(self, desc)
                # every word moved to the next one
                return torch.where(words >= 0, (words + 1) % self.n_words, words)
            monkeypatch.setattr(bow.Vocabulary, "descend", descend)
        elif name in ("reloc_pose_unchanged", "reloc_pose_half_batch"):
            inside = []

            def reloc(self, frame):
                inside.append(True)
                try:
                    return orig_reloc(self, frame)
                finally:
                    inside.pop()

            def solve(cam, q0, t0, x_w, obs, st, s2i, valid, *a, **kw):
                if not inside:
                    return orig_k1(cam, q0, t0, x_w, obs, st, s2i, valid, *a, **kw)
                if name == "reloc_pose_half_batch":
                    valid = valid.clone()
                    valid[1::2] = False
                out = orig_k1(cam, q0, t0, x_w, obs, st, s2i, valid, *a, **kw)
                if name == "reloc_pose_unchanged":
                    out = out._replace(q=q0.clone(), t=t0.clone())
                return out
            monkeypatch.setattr(relocalize.Relocalizer, "relocalize", reloc)
            monkeypatch.setattr(pose_solver, "optimize_pose", solve)
        elif name == "frontend_altered":
            def packed(self, left, right):
                table, desc = orig_packed(self, left, right)
                table = table.clone()
                table[:, 0] += 1.0        # every keypoint a pixel to the right
                return table, desc
            monkeypatch.setattr(fe_mod.ImageFrontend, "_packed", packed)

    orig_anc = pose_solver.optimize_pose_anchored
    orig_ham = cuda_kernels.hamming_matrix_plain
    orig_ba = local_ba.solve_local_ba
    orig_packed = fe_mod.ImageFrontend._packed
    orig_assoc = association.associate_and_check_kernel
    orig_descend = bow.Vocabulary.descend
    orig_reloc = relocalize.Relocalizer.relocalize
    orig_k1 = pose_solver.optimize_pose
    return plant


@pytest.mark.parametrize("cell,fault", [
    ("v1_offline_features", "pose_unchanged"),
    ("v1_offline_features", "pose_half_batch"),
    ("v1_offline_features", "k3_altered"),
    ("v1_offline_features", "ba_unchanged"),
    ("v1_offline_features", "assoc_altered"),
    ("v1_online_features", "pose_half_batch"),
    ("v1_online_features", "ba_unchanged"),
    ("v1_online_images", "frontend_altered"),
])
def test_fault_turns_correct_false(monkeypatch, cell, fault):
    res, compared = _run(cell, 12.0, before_window=_fault(monkeypatch, fault))
    assert not res["correct"], compared


@pytest.mark.parametrize("fault", ["reloc_words_altered", "reloc_pose_unchanged",
                                   "reloc_pose_half_batch"])
def test_relocalization_fault_turns_correct_false(monkeypatch, fault):
    """A fault in the relocalization (a word altered where the descent
    produces it; the recovered pose solve returning its start, or
    solving over half its features) turns a blackout run's `correct`
    false."""
    res, compared, _ = run_blackouts(before_window=_fault(monkeypatch, fault))
    assert not res["correct"], compared


def test_postings_altered_before_the_window_turn_correct_false(monkeypatch):
    """The program's inverted file losing a posting of each keyframe
    added before the window (its stored BoW vectors intact): the
    reference builds its own from every keyframe added since the system
    was built, so the postings differ at the window's start."""
    orig_add, warm = bow.KeyFrameDatabase.add, [True]

    def add(self, kf, descs, valid=None):
        orig_add(self, kf, descs, valid)
        if warm[0]:
            self.inv[int(self.bow[kf][0][0])].pop(kf)

    monkeypatch.setattr(bow.KeyFrameDatabase, "add", add)
    res, compared, _ = run_blackouts(before_window=lambda: warm.__setitem__(0, False))
    assert not res["correct"] and compared["reloc_postings_differing"][0] > 0, compared
