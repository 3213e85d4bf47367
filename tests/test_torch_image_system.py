"""The port's image slice end to end against the JAX package, on the CPU.

Both packages render the same seeded sprite stereo pairs of the room
fixture (uint8), run them through their `ImageFrontend` (the one-pass
dispatch/complete path, double-buffered as the image bench line runs it)
into their `GMMLocSystem` with the image configuration, and the tracked
poses are compared frame by frame. The size is cut for the CPU: half
resolution (376x240, intrinsics halved), 600 features, a 400-component
map and 10 frames.

The two front ends are not bit-identical: the pyramid levels differ in
their last ulps (the resize products sum in another order than XLA's,
tests/test_torch_frontend.py), which moves IC angles by up to ~0.01 deg
and flips descriptor bits, so matches and poses differ slightly. Gates:
per-frame camera-centre difference < 1 cm and rotation < 0.3 deg, both
runs' errors against ground truth < 5 cm, and the same keyframe count
within one. The reference's BA runs with float32 products, as in
tests/test_torch_system.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gmmloc_tpu.gmm import mixture as jax_mixture
from gmmloc_tpu.mapping.map_state import _inverse
from gmmloc_tpu.pipeline.frontend import ImageFrontend as JaxFrontend
from gmmloc_tpu.pipeline.system import GMMLocSystem as JaxSystem

from gmmloc_tpu_torch.eval import slice_run
from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

from test_torch_system import _reference_ba_in_f32, jax_config

torch.set_num_threads(1)

N_FRAMES = 10


def half_res_image_config():
    cfg = slice_run.image_config(feat_cap=640, num_features=600, local_map_cap=1024)
    c = cfg.camera
    cam = dataclasses.replace(c, fx=c.fx / 2, fy=c.fy / 2, cx=c.cx / 2, cy=c.cy / 2,
                              bf=c.bf / 2, width=c.width // 2, height=c.height // 2)
    return cfg.replace(camera=cam, caps=dataclasses.replace(cfg.caps, gmm_components_pad=512))


@pytest.fixture(scope="module")
def image_run(tmp_path_factory):
    cfg = half_res_image_config()
    d = str(tmp_path_factory.mktemp("room_img"))
    gmap, images, ts, q_wc, t_wc = slice_run.make_image_inputs(
        cfg, d, N_FRAMES, n_components=400, n_landmarks=9000, device="cpu")
    return dict(cfg=cfg, dir=d, gmap=gmap, images=images, ts=ts, q_wc=q_wc, t_wc=t_wc)


def _run_jax(run):
    jcfg = jax_config(run["cfg"])
    gmap = jax_mixture.load(f"{run['dir']}/room.gmm", pad_to=jcfg.caps.gmm_components_pad,
                            neighbor_dist_thresh=jcfg.gmm.neighbor_dist_thresh,
                            neighbor_cap=jcfg.gmm.neighbor_cap)
    fe, system = JaxFrontend(jcfg), JaxSystem(jcfg, gmap)
    frames, pend, i_prev = [], None, -1
    images = run["images"]
    for i in range(len(images) + 1):
        new = fe.dispatch(i, run["ts"][i], *images[i]) if i < len(images) else None
        if pend is not None:
            frames.append(fe.complete(pend))
            system.step(frames[-1], run["q_wc"][i_prev], run["t_wc"][i_prev])
            assert not system.track_failed, f"reference lost tracking at {i_prev}"
        pend, i_prev = new, i
    system.flush()
    return frames, system


def test_image_slice_matches_reference(image_run, monkeypatch):
    _reference_ba_in_f32(monkeypatch)
    ref_frames, ref_sys = _run_jax(image_run)

    fe = ImageFrontend(image_run["cfg"], device="cpu")
    system = GMMLocSystem(image_run["cfg"], image_run["gmap"], "cpu")
    ran = slice_run.run_image(system, fe, image_run["images"], image_run["ts"],
                              image_run["q_wc"], image_run["t_wc"])
    frames = ran["frames"]
    assert len(frames) == len(ref_frames) == N_FRAMES
    assert system.n_tracked == N_FRAMES - 1

    # the front ends: the same keypoints on (nearly) all of frame 0
    f0, r0 = frames[0], ref_frames[0]
    n = image_run["cfg"].frame.num_features
    same_kp = (np.abs(f0.uv[:n] - r0.uv[:n]).max(1) < 1e-3) & f0.valid[:n] & r0.valid[:n]
    assert same_kp.sum() >= 0.95 * r0.valid[:n].sum(), (same_kp.sum(), r0.valid[:n].sum())
    assert (r0.ur[r0.valid] >= 0).sum() > 100     # the pair gives stereo matches

    t_wc = image_run["t_wc"]
    for i, (fa, fb) in enumerate(zip(ref_frames, frames)):
        ca, cb = _inverse(fa.q_cw, fa.t_cw)[1], _inverse(fb.q_cw, fb.t_cw)[1]
        drot = np.degrees(2 * np.arccos(min(1.0, abs(float(np.dot(fa.q_cw, fb.q_cw))))))
        assert np.linalg.norm(ca - cb) < 0.01 and drot < 0.3, (
            f"frame {i}: |dt| {np.linalg.norm(ca - cb) * 1e3:.2f} mm, "
            f"rotation {drot:.4f} deg")
        assert np.linalg.norm(ca - t_wc[i]) < 0.05 and np.linalg.norm(cb - t_wc[i]) < 0.05
    assert abs(system.world.n_keyframes() - ref_sys.world.n_keyframes()) <= 1
    assert system.world.n_keyframes() > 1
