"""The disk-driven image path of the port end to end, on the CPU.

The scenario of `tests/test_disk_pipeline.py` (asset-gated in the JAX
package) on the seeded room fixture at the small widths of
`tests/test_torch_image_system.py` (half resolution, 600 features, a
400-component map, 10 frames): the rendered uint8 pairs are written as
an EuRoC ASL tree of PNGs (`eval/disk_run.write_asl_tree`, all five row
filters), read back by the port's loader (native libpng decode and
prefetch ring), pushed through `ImageFrontend` into `GMMLocSystem.run`
(`eval/disk_run.run`), and:

  - the decoded pixels equal the written ones;
  - the trajectory equals the in-memory run's (`slice_run.run_image` on
    the same pixels and the loader's timestamps) bit for bit;
  - the same tree read by the JAX package's loader and run through its
    `ImageFrontend` and `GMMLocSystem` stays within the image slice's
    gates: < 1 cm and < 0.3 deg per frame, keyframes within one (both
    BAs with float32 products, as there).
"""

import os

import numpy as np
import pytest
import torch

from gmmloc_tpu.mapping.map_state import _inverse
from gmmloc_tpu.pipeline.dataloader import EuRoCDataloader as JaxLoader

from gmmloc_tpu_torch.eval import disk_run, slice_run
from gmmloc_tpu_torch.pipeline.dataloader import EuRoCDataloader
from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
from gmmloc_tpu_torch.utils import control

from test_torch_image_system import _run_jax, half_res_image_config
from test_torch_system import _ba_in_f32

torch.set_num_threads(1)

N_FRAMES = 10


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    cfg = half_res_image_config()
    d = str(tmp_path_factory.mktemp("room_disk"))
    gmap, images, ts, q_wc, t_wc = slice_run.make_image_inputs(
        cfg, d, N_FRAMES, n_components=400, n_landmarks=9000, device="cpu")
    root = os.path.join(d, "asl")
    n_bytes = disk_run.write_asl_tree(root, images, ts)
    return dict(cfg=cfg, dir=d, root=root, gt=os.path.join(d, "room_gt.txt"),
                gmap=gmap, images=images, ts=ts, q_wc=q_wc, t_wc=t_wc, n_bytes=n_bytes)


def _disk_run(disk):
    loader = EuRoCDataloader(disk["root"], gt_path=disk["gt"])
    fe = ImageFrontend(disk["cfg"], device="cpu")
    system = GMMLocSystem(disk["cfg"], disk["gmap"], "cpu")
    seen = []
    control.control.reset()
    ran = disk_run.run(system, fe, loader,
                       on_frame=lambda i, f, st: seen.append((i, f.idx)))
    return loader, system, ran, seen


def test_disk_run_equals_in_memory_run(disk):
    loader, system, ran, seen = _disk_run(disk)
    assert len(loader) == N_FRAMES and disk["n_bytes"] > 0
    for (i, left, right), (l0, r0) in zip(loader.pairs(), disk["images"]):
        np.testing.assert_array_equal(left, l0)
        np.testing.assert_array_equal(right, r0)
    np.testing.assert_allclose(loader.timestamps, disk["ts"], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(loader.gt_t[:N_FRAMES], disk["t_wc"])
    np.testing.assert_array_equal(loader.gt_q[:N_FRAMES], disk["q_wc"])

    # on_frame saw every frame once, each with the frame its stat belongs to
    assert sorted(f for _, f in seen) == list(range(N_FRAMES)) == [f for _, f in seen]
    assert all(i >= f for i, f in seen)
    assert len(ran["step_s"]) == N_FRAMES == len(ran["frames"])
    assert system.n_tracked == N_FRAMES - 1 and not system.track_failed

    mem = GMMLocSystem(disk["cfg"], disk["gmap"], "cpu")
    slice_run.run_image(mem, ImageFrontend(disk["cfg"], device="cpu"), disk["images"],
                        loader.timestamps, disk["q_wc"], disk["t_wc"])
    for a, b in zip(system.export_trajectory(), mem.export_trajectory()):
        assert len(a) == N_FRAMES
        np.testing.assert_array_equal(a, b)
    assert system.world.n_keyframes() == mem.world.n_keyframes() > 1


def test_disk_run_matches_reference(disk, monkeypatch):
    _ba_in_f32(monkeypatch)
    jl = JaxLoader(disk["root"], gt_path=disk["gt"])
    images = [(f.left.astype(np.uint8), f.right.astype(np.uint8)) for f in jl]
    for (l0, r0), (l1, r1) in zip(images, disk["images"]):
        np.testing.assert_array_equal(l0, l1)
        np.testing.assert_array_equal(r0, r1)
    ref_frames, ref_sys = _run_jax(dict(disk, images=images, ts=jl.timestamps))

    _, system, ran, _ = _disk_run(disk)
    frames = ran["frames"]
    assert len(frames) == len(ref_frames) == N_FRAMES
    t_wc = disk["t_wc"]
    for i, (fa, fb) in enumerate(zip(ref_frames, frames)):
        ca, cb = _inverse(fa.q_cw, fa.t_cw)[1], _inverse(fb.q_cw, fb.t_cw)[1]
        drot = np.degrees(2 * np.arccos(min(1.0, abs(float(np.dot(fa.q_cw, fb.q_cw))))))
        assert np.linalg.norm(ca - cb) < 0.01 and drot < 0.3, (
            f"frame {i}: |dt| {np.linalg.norm(ca - cb) * 1e3:.2f} mm, "
            f"rotation {drot:.4f} deg")
        assert np.linalg.norm(cb - t_wc[i]) < 0.05
    assert abs(system.world.n_keyframes() - ref_sys.world.n_keyframes()) <= 1
