"""The fused track step against the JAX package on captured inputs.

Inputs are captured from the port's own system running the slice on the
seeded room fixture (feat_cap=256); the same arrays then go through
`gmmloc_tpu.tracking.fused.fused_track_step` and the port's
`track_core`. Gates: `feat_point`, `feat_from_local` and `map_in_view`
equal, the pose within the K2 gates (rotation < 0.02 deg, translation
< 2e-3 m).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmmloc_tpu.geometry import camera as jcam
from gmmloc_tpu.tracking import fused as jfused

from gmmloc_tpu_torch.eval import kernel_check, room_fixture
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
from gmmloc_tpu_torch.tracking import fused as tfused

torch.set_num_threads(1)

CAPTURE_AT = (3, 12, 22)   # before the first BA, and with vetted anchors


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    from test_torch_system import _frames, slice_config
    from gmmloc_tpu_torch.eval import synthetic

    d = tmp_path_factory.mktemp("room")
    paths = room_fixture.write_room_fixture(str(d), 400, 40, seed=0)
    cfg = slice_config()
    frames, q_wc, t_wc = _frames(synthetic, cfg, paths, max(CAPTURE_AT) + 1)
    gmap = mixture.load(paths[0], "cpu", pad_to=512,
                        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
                        neighbor_cap=cfg.gmm.neighbor_cap)
    system = GMMLocSystem(cfg, gmap, "cpu")
    calls = []
    orig = tfused.track_core

    def record(cam, *args, **kw):
        calls.append((system.tracker.last_frame, cam, args, kw))
        return orig(cam, *args, **kw)

    tfused.track_core = record
    try:
        caps = {}
        for i, f in enumerate(frames):
            system.step(f, q_wc[i], t_wc[i])
            if calls and calls[-1][0] is not None and f.idx in CAPTURE_AT:
                caps[f.idx] = calls[-1][1:]
        system.flush()
    finally:
        tfused.track_core = orig
    assert sorted(caps) == list(CAPTURE_AT)
    return caps


def _to_jax(v):
    if isinstance(v, torch.Tensor):
        a = v.numpy()
        return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
    return v


@pytest.mark.parametrize("frame", CAPTURE_AT)
def test_track_core_matches_reference(captured, frame):
    cam, args, kw = captured[frame]
    jc = jcam.CameraParams(*cam)
    ref = jfused.fused_track_step(jc, *[_to_jax(a) for a in args],
                                  **{k: _to_jax(v) for k, v in kw.items()})
    out = tfused.track_core(cam, *args, **kw)
    np.testing.assert_array_equal(np.asarray(ref.feat_point), out.feat_point.numpy())
    np.testing.assert_array_equal(np.asarray(ref.feat_from_local), out.feat_from_local.numpy())
    np.testing.assert_array_equal(np.asarray(ref.map_in_view), out.map_in_view.numpy())
    assert int(ref.n_motion_matches) == int(out.n_motion_matches)
    assert int(ref.num_anchors) == int(out.num_anchors)
    assert kernel_check.angle_deg(np.asarray(ref.q), out.q.numpy()) < 0.02
    assert np.linalg.norm(np.asarray(ref.t) - out.t.numpy()) < 2e-3
    assert abs(int(ref.num_inliers) - int(out.num_inliers)) <= 3
    assert int(out.num_inliers) > 50 and (out.feat_point >= 0).sum() > 50
    if frame == CAPTURE_AT[-1]:
        assert int(out.num_anchors) > 0     # the anchored K2 solve ran
