"""`reloc_under_stress` of the port (`gmmloc_tpu_torch/eval/stress.py`)
against the JAX package's `tools/stress.py`, on the CPU.

Both run the scenario on the seeded room fixture's map at twice its
component count (800, the neighbour graph built) at the small width of
`test_torch_eval_protocol` with float32 BA products: 90 frames mapped
from frame 150, 5 dark frames while the camera is carried back to frame
160, then 40 frames from there. The JAX tool reads the reference's map
and trajectory from fixed paths; its `proto.load_gmm_file` and
`synthetic.make_sequence` are wrapped to read the fixture instead.

Gates: both go lost and recover, at the same frames, with the same lost
count and keyframes; the median error after the recovery under 10 cm in
both and within 5 mm of the JAX tool's.
"""

import numpy as np
import pytest
import torch

from gmmloc_tpu.eval import synthetic as jax_synthetic

from gmmloc_tpu_torch.eval import stress

from test_torch_eval_protocol import (cut_configs, load_tool, point_assets,
                                      write_eval_fixture)
from test_torch_system import _ba_in_f32

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def eval_fixture(tmp_path_factory):
    return write_eval_fixture(str(tmp_path_factory.mktemp("reloc_room")), n_frames=300)


def test_reloc_under_stress_matches_jax(eval_fixture, monkeypatch):
    jax_stress = load_tool("stress")
    _ba_in_f32(monkeypatch)
    point_assets(monkeypatch, eval_fixture)
    cut_configs(monkeypatch, [stress], [jax_stress])
    load = jax_stress.proto.load_gmm_file
    monkeypatch.setattr(jax_stress.proto, "load_gmm_file",
                        lambda path: load(eval_fixture["gmm"]))
    make = jax_synthetic.make_sequence

    def make_sequence(cfg, **kw):
        kw.update(gt_path=f"{eval_fixture['gt_dir']}/V1_01_easy.txt",
                  gmm_path=eval_fixture["gmm"])
        return make(cfg, **kw)

    monkeypatch.setattr(jax_synthetic, "make_sequence", make_sequence)
    import gmmloc_tpu.pipeline.system as jax_system

    made = []
    cls = jax_system.GMMLocSystem

    def make_system(*a, **kw):
        made.append(cls(*a, **kw))
        return made[-1]

    monkeypatch.setattr(jax_system, "GMMLocSystem", make_system)

    ref = jax_stress.reloc_under_stress(2)
    out = stress.reloc_under_stress(2, device="cpu")
    s = made[0]
    assert out["K"] == ref["K"] == 800
    assert out["went_lost"] and ref["went_lost"]
    assert out["relocalized"] and ref["relocalized"]
    assert out["recovery_frames"] == list(s.recovery_frames) and out["recovery_frames"]
    assert out["n_lost"] == s.n_lost
    assert out["kfs"] == ref["kfs"] and out["frames"] == ref["frames"] == 135
    assert ref["post_recovery_median_err_m"] < 0.10
    assert out["post_recovery_median_err_m"] < 0.10
    assert abs(out["post_recovery_median_err_m"] - ref["post_recovery_median_err_m"]) < 5e-3
    assert np.isfinite(out["map_build_s"])
