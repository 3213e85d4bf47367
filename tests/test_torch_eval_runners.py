"""The port's small runners and map viewer (`gmmloc_tpu_torch/eval/
run_synthetic.py`, `run_image_pipeline.py`, `view_map.py`) against the
JAX package's tools of the same names, on the CPU.

Both packages' tools read the seeded room fixture through their
`synthetic` asset names, at the small widths of `test_torch_eval_protocol`
(feature path) and `test_torch_eval_image` (image path), float32 BA
products. Gates: the feature runner's trajectory within 5 mm of the JAX
tool's and its ATE within 1 mm; the image runner's camera centres within
1 cm of the JAX tool's (the front ends differ in the pyramid's last
ulps) and under 5 cm of the ground truth; the viewer's HTML byte-equal to
the JAX tool's from one checkpoint.
"""

import numpy as np
import pytest
import torch

from gmmloc_tpu_torch.eval import run_image_pipeline, run_synthetic, view_map
from gmmloc_tpu_torch.pipeline import checkpoint

from test_torch_eval_image import half_res_v1_config
from test_torch_eval_protocol import (capture_systems, cut_configs, load_tool, point_assets,
                                      write_eval_fixture)
from test_torch_system import _ba_in_f32

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def eval_fixture(tmp_path_factory):
    return write_eval_fixture(str(tmp_path_factory.mktemp("runner_room")), n_frames=60)


def _positions(system):
    return system.export_trajectory()[2]


def test_run_synthetic_and_view_map_match_jax(eval_fixture, monkeypatch, tmp_path):
    jax_run, jax_view = load_tool("run_synthetic"), load_tool("view_map")
    _ba_in_f32(monkeypatch)
    point_assets(monkeypatch, eval_fixture)
    cut_configs(monkeypatch, [run_synthetic, view_map], [jax_run, jax_view])
    # the JAX tool leaves the map to make_sequence's default, bound to the
    # reference's path when the module was defined
    make = jax_run.synthetic.make_sequence
    monkeypatch.setattr(jax_run.synthetic, "make_sequence",
                        lambda cfg, **kw: make(cfg, gmm_path=eval_fixture["gmm"], **kw))
    made = capture_systems(monkeypatch, run_synthetic)
    jax_made = capture_systems(monkeypatch, jax_run)
    out = run_synthetic.main(["20", "1", "V1_01_easy", "0", "--cpu"])
    monkeypatch.setattr("sys.argv", ["run_synthetic.py", "20", "1", "V1_01_easy", "0"])
    jax_run.main()
    assert out["frames"] == 20
    mine, ref = _positions(made[0]), _positions(jax_made[0])
    assert mine.shape == ref.shape == (20, 3)
    assert np.linalg.norm(mine - ref, axis=1).max() < 5e-3
    assert made[0].world.n_keyframes() == jax_made[0].world.n_keyframes() > 1

    # the viewer from a checkpoint of the run's world
    ckpt = str(tmp_path / "world.npz")
    checkpoint.save_checkpoint(ckpt, made[0].world, frame_cursor=20)
    path = view_map.main([ckpt, "--gmm", "v1", "--out", str(tmp_path / "port.html")])
    monkeypatch.setattr("sys.argv", ["view_map.py", ckpt, "--gmm", "v1", "--out",
                                     str(tmp_path / "jax.html")])
    jax_view.main()
    with open(path, "rb") as a, open(tmp_path / "jax.html", "rb") as b:
        html, ref_html = a.read(), b.read()
    assert html == ref_html and len(html) > 1000
    # the default output name sits beside the checkpoint
    assert view_map.main([ckpt]) == str(tmp_path / "world.html")


def test_run_image_pipeline_matches_jax(eval_fixture, monkeypatch):
    jax_run = load_tool("run_image_pipeline")
    _ba_in_f32(monkeypatch)
    point_assets(monkeypatch, eval_fixture)
    cut_configs(monkeypatch, [run_image_pipeline], [jax_run], half_res_v1_config)
    made = capture_systems(monkeypatch, run_image_pipeline)
    jax_made = capture_systems(monkeypatch, jax_run)
    out = run_image_pipeline.main(["6", "0", "--cpu"])
    monkeypatch.setattr("sys.argv", ["run_image_pipeline.py", "6", "0"])
    jax_run.main()
    assert out["frames"] == 6 and not out["failed"]
    assert out["errors_m"].max() < 0.05
    mine, ref = _positions(made[0]), _positions(jax_made[0])
    assert mine.shape == ref.shape == (6, 3)
    assert np.linalg.norm(mine - ref, axis=1).max() < 0.01
