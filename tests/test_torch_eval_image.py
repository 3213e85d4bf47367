"""The port's image-level evaluation (`gmmloc_tpu_torch/eval/evaluate_image.py`)
against the JAX package's `tools/evaluate_image.py`, on the CPU.

Both tools render the same sprite stereo pairs of the seeded room fixture
and run them through their front end (one pass per frame,
double-buffered) into the system with the tool's configuration, cut for
the CPU as `test_torch_image_system` cuts it: half resolution (376x240,
intrinsics halved), 600 features, feat_cap 640, a 400-component map, 10
frames, float32 BA products. The front ends differ in the pyramid's last
ulps (`test_torch_frontend`), so the gate is that test's: per-frame camera
centres within 1 cm and rotations within 0.3 deg, the same frames and
completion, keyframes within one, errors against the ground truth under
5 cm.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from gmmloc_tpu_torch import config as config_mod
from gmmloc_tpu_torch.eval import ate, evaluate_image, synthetic

from test_torch_eval_protocol import (assert_tum_close, cut_configs, load_tool,
                                      point_assets, write_eval_fixture)
from test_torch_system import _ba_in_f32

torch.set_num_threads(1)

N_FRAMES = 10


def half_res_v1_config():
    cfg = config_mod.euroc_v1_config()
    c = cfg.camera
    cam = dataclasses.replace(c, fx=c.fx / 2, fy=c.fy / 2, cx=c.cx / 2, cy=c.cy / 2,
                              bf=c.bf / 2, width=c.width // 2, height=c.height // 2)
    return cfg.replace(
        camera=cam,
        frame=dataclasses.replace(cfg.frame, feat_cap=640, num_features=600),
        tracking=dataclasses.replace(cfg.tracking, fused_local_map_cap=1024),
        caps=dataclasses.replace(cfg.caps, gmm_components_pad=512))


@pytest.fixture(scope="module")
def eval_fixture(tmp_path_factory):
    return write_eval_fixture(str(tmp_path_factory.mktemp("img_room")), n_frames=60)


def test_evaluate_image_main_matches_jax_run_once(eval_fixture, monkeypatch, tmp_path):
    jax_tool = load_tool("evaluate_image")
    _ba_in_f32(monkeypatch)
    point_assets(monkeypatch, eval_fixture)
    cut_configs(monkeypatch, [evaluate_image], [jax_tool], half_res_v1_config)
    argv = ["--runs", "1", "--frames", str(N_FRAMES), "--out", str(tmp_path / "port"),
            "--cpu"]
    summary = evaluate_image.main(argv)
    with open(tmp_path / "port" / "summary.json") as f:
        assert set(json.load(f)["V1_01_easy"]) == {"rmse_mean", "completion", "runs"}
    m = summary["V1_01_easy"]["runs"][0]

    args = evaluate_image.build_parser().parse_args(argv)
    cfg = evaluate_image.make_config(args)
    assert cfg.camera.width == 376 and not cfg.camera.do_rectify
    jcfg = jax_tool.euroc_v1_config()          # the cut config, through the tool
    jcfg = jcfg.replace(
        camera=dataclasses.replace(jcfg.camera, do_rectify=False, do_equalization=False),
        tracking=dataclasses.replace(jcfg.tracking, velocity_damping=0.9,
                                     use_fused_track=True, pipelined_track=True))
    gmap = jax_tool.mixture.load(eval_fixture["gmm"], pad_to=jcfg.caps.gmm_components_pad,
                                 neighbor_dist_thresh=jcfg.gmm.neighbor_dist_thresh,
                                 neighbor_cap=jcfg.gmm.neighbor_cap)
    ref_path = str(tmp_path / "jax.txt")
    ref = jax_tool.run_once(jcfg, "V1_01_easy", 0, N_FRAMES, 0, gmap, ref_path)

    assert set(m) == set(ref)
    for k in ("frames", "target", "completed", "lost", "recoveries"):
        assert m[k] == ref[k], k
    assert m["frames"] == N_FRAMES and m["completed"]
    assert abs(m["kfs"] - ref["kfs"]) <= 1 and m["kfs"] > 1
    port_path = str(tmp_path / "port" / "V1_01_easy0.txt")
    assert_tum_close(port_path, ref_path, 0.01, 0.3)
    ts, q_wc, t_wc = synthetic.load_gt_trajectory(f"{eval_fixture['gt_dir']}/V1_01_easy.txt")
    for path in (port_path, ref_path):
        t_est, p_est, _ = ate.load_tum(path)
        np.testing.assert_allclose(t_est, ts[:N_FRAMES], atol=1e-6)
        assert np.linalg.norm(p_est - t_wc[:N_FRAMES], axis=1).max() < 0.05
