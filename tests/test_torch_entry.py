"""The port's entry points (`gmmloc_tpu_torch/entry.py`) against
`__graft_entry__.py`, and the `pose_impl` knob.

  - `entry("cpu")`: the pose and the inlier count of the JAX package's
    `entry()` on the same seeded inputs, within the K2 gates of
    tests/test_torch_fused.py (rotation < 0.02 deg, translation < 2e-3 m),
    with inliers > 0;
  - `pose_impl`: "xla" and "auto" equal on the CPU (both run the plain
    solver there), "pallas" raises on the CPU (a CUDA kernel has no
    interpret mode), an unknown name raises, and the tracker takes all
    three;
  - `dryrun_multichip(2, device="cpu")`: the production shapes (K=3328,
    F=1280; the BA at L=16, C=48, P=8192, MO=8, 5/5/40, "flat" bf16) over
    two gloo ranks (20-50 s on 8 CPU cores); association equal to the
    unsharded port, the BA's points and cameras within 1e-4 m of it.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from gmmloc_tpu_torch import entry
from gmmloc_tpu_torch.eval import kernel_check
from gmmloc_tpu_torch.tracking import fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def test_entry_matches_reference():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as g

    jfn, jargs = g.entry()
    ref = np.asarray(jfn(*jargs))
    fn, args = entry.entry("cpu")
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out = fn(*args).numpy()
    assert out.shape == ref.shape
    assert kernel_check.angle_deg(ref[:4], out[:4]) < 0.02
    assert np.abs(out[4:7] - ref[4:7]).max() < 2e-3
    assert int(out[7]) > 0 and abs(int(out[7]) - int(ref[7])) <= 2, (out[7:10], ref[7:10])


def test_pose_impl_selects_the_solver():
    from gmmloc_tpu_torch.config import CameraConfig
    from gmmloc_tpu_torch.geometry import camera as cam_mod

    fn, args = entry.entry("cpu")
    cam = cam_mod.CameraParams.from_config(CameraConfig())
    kw = dict(log_scale_factor=float(np.log(1.2)), num_levels=8, use_anchors=True)
    auto = fn(*args)
    xla = fused.fused_track_step_packed(cam, *args, pose_impl="xla", **kw)
    assert torch.equal(auto, xla)
    with pytest.raises(ValueError, match="pallas"):
        fused.fused_track_step_packed(cam, *args, pose_impl="pallas", **kw)
    with pytest.raises(ValueError, match="unknown pose_impl"):
        fused.fused_track_step_packed(cam, *args, pose_impl="plain", **kw)


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla", "plain"])
def test_tracker_takes_pose_impl(impl):
    from gmmloc_tpu_torch.eval.slice_run import slice_config
    from gmmloc_tpu_torch.gmm import mixture
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

    cfg = slice_config()
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, pose_impl=impl))
    gmap = mixture.from_arrays(np.zeros((1, 3)), np.eye(3)[None] * 0.01, "cpu")
    if impl == "plain":
        with pytest.raises(ValueError, match="unknown pose_impl"):
            GMMLocSystem(cfg, gmap, "cpu")
    else:
        assert GMMLocSystem(cfg, gmap, "cpu").tracker.cfg.tracking.pose_impl == impl


def test_dryrun_multichip_on_two_cpu_ranks():
    res = entry.dryrun_multichip(2, device="cpu", timeout_s=600.0)
    assert res["size"] == 2 and np.isfinite(res["cost"])
    cam, gmm, pose, feat_uv, prob, L = entry.dryrun_inputs()
    ref = entry.unsharded("cpu", cam, gmm, pose, feat_uv, prob, L, entry.DRYRUN_ITERS)
    np.testing.assert_array_equal(res["visible"], ref["visible"])
    np.testing.assert_array_equal(res["cand"], ref["cand"])
    assert np.abs(res["pts"] - ref["pts"]).max() < 1e-4
    assert np.abs(res["cam_t"] - ref["cam_t"]).max() < 1e-4
    assert res["points_per_rank"] == 4096 and res["n_iters"] == ref["n_iters"]


def test_dryrun_multichip_refuses_more_nccl_ranks_than_cards():
    with pytest.raises(ValueError, match="one rank per card"):
        entry.dryrun_multichip(torch.cuda.device_count() + 1, device="cuda")
