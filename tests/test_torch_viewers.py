"""The port's map viewers against the JAX package's, on the CPU.

  - `tests/test_checkpoint.py::test_html_viewer_export`'s checks on a
    world the port built on the seeded room fixture (the JAX test needs
    reference assets this repository does not ship);
  - the JAX and port `export_html` write byte-equal files for one loaded
    checkpoint;
  - `tests/test_live_viewer.py`'s two throttle cases on the port's
    `LiveViewer`;
  - the port's `dump_run_report` writes the same files, byte for byte,
    as the JAX package's for one loaded checkpoint and map.
"""

import json
import os
import re
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gmmloc_tpu.gmm import mixture as jax_mixture
from gmmloc_tpu.mapping import map_state as jms
from gmmloc_tpu.pipeline import checkpoint as jax_checkpoint
from gmmloc_tpu.pipeline import html_viewer as jax_html
from gmmloc_tpu.pipeline import visualizer as jax_vis

from gmmloc_tpu_torch.eval import room_fixture, synthetic
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.mapping import map_state as ms
from gmmloc_tpu_torch.pipeline import checkpoint, html_viewer, visualizer
from gmmloc_tpu_torch.pipeline.live_viewer import LiveViewer
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
from gmmloc_tpu_torch.tracking.frame import make_frame
from gmmloc_tpu_torch.utils import proto

from test_torch_system import jax_config, slice_config

torch.set_num_threads(1)

N_FRAMES = 25


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """25 feature frames of the room fixture through the port's system,
    saved as a checkpoint."""
    d = tmp_path_factory.mktemp("room_view")
    cfg = slice_config()
    gmm_path, gt_path = room_fixture.write_room_fixture(str(d), n_components=400,
                                                        n_frames=N_FRAMES + 10, seed=0)
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, gt_path=gt_path, gmm_path=gmm_path, n_landmarks=4000, seed=0,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1)
    kw = dict(pad_to=512, neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
              neighbor_cap=cfg.gmm.neighbor_cap)
    system = GMMLocSystem(cfg, mixture.load(gmm_path, "cpu", **kw), "cpu")
    frames = [fe.make_frame(i, ts[i], q_wc[i], t_wc[i]) for i in range(N_FRAMES)]
    system.run(frames, q_wc, t_wc)
    ckpt = str(d / "world.npz")
    checkpoint.save_checkpoint(ckpt, system.world, frame_cursor=N_FRAMES)
    return dict(cfg=cfg, dir=d, gmm_path=gmm_path, kw=kw, system=system, ckpt=ckpt,
                t_wc=t_wc[:N_FRAMES])


def _payload(path):
    text = open(path).read()
    assert "frusta" in text and "<canvas" in text
    return json.loads(re.search(r"const D = (\{.*?\});\n", text, re.S).group(1))


def test_html_viewer_export(run, tmp_path):
    """The offline viewer renders a populated world and the GMM layer
    into one self-contained HTML file (viewer parity,
    visualizer.cpp:150-221)."""
    means, covs, _, _ = proto.load_gmm_file(run["gmm_path"])
    out = str(tmp_path / "map.html")
    html_viewer.export_html(run["system"].world, out, gmm={"means": means, "covs": covs})
    data = _payload(out)
    assert len(data["frusta"]) >= 8           # >= one keyframe (8 segments)
    assert len(data["frusta"]) == 8 * run["system"].world.n_keyframes()
    assert len(data["points"]) > 100
    assert len(data["ellipsoids"]) > 100
    assert len(data["traj"]) >= 20
    # the port's GMMMap (float32 tensors) takes the place of the arrays:
    # three rings around each component's mean (an eigenvector's sign
    # may differ from float64's, so the rings are held by their centres)
    out2 = str(tmp_path / "map2.html")
    html_viewer.export_html(run["system"].world, out2, gmm=run["system"].gmap,
                            max_ellipsoids=len(means))
    ell = np.array(_payload(out2)["ellipsoids"])
    assert ell.shape == (3 * len(means), 12, 3)
    np.testing.assert_allclose(ell.mean(1), np.repeat(means, 3, axis=0), atol=1e-5)


def _loaded(run):
    """The checkpoint loaded into a fresh MapState of each package."""
    jw = jms.MapState(jax_config(run["cfg"]))
    jax_checkpoint.load_checkpoint(run["ckpt"], jw)
    pw = ms.MapState(run["cfg"])
    checkpoint.load_checkpoint(run["ckpt"], pw)
    return jw, pw


def test_export_html_byte_equal_to_reference(run, tmp_path):
    jw, pw = _loaded(run)
    means, covs, _, _ = proto.load_gmm_file(run["gmm_path"])
    gmm = {"means": means, "covs": covs}
    a, b = str(tmp_path / "jax.html"), str(tmp_path / "port.html")
    jax_html.export_html(jw, a, gmm=gmm)
    html_viewer.export_html(pw, b, gmm=gmm)
    ref = open(a, "rb").read()
    assert len(ref) > 10000 and ref == open(b, "rb").read()
    # the live world writes the same file as its checkpoint
    c = str(tmp_path / "live.html")
    html_viewer.export_html(run["system"].world, c, gmm=gmm)
    assert open(c, "rb").read() == ref


def _world_with_kf():
    cfg = slice_config()
    w = ms.MapState(cfg)
    n = 50
    rng = np.random.default_rng(0)
    f = make_frame(0, 0.0, rng.uniform(50, 400, (n, 2)), np.full(n, -1.0),
                   np.full(n, -1.0), np.zeros(n, np.int32), np.zeros(n),
                   rng.integers(0, 256, (n, 32), dtype=np.uint8), cfg.frame.feat_cap)
    f.valid[:n] = True
    f.set_pose(np.array([1.0, 0, 0, 0]), np.zeros(3))
    kf = w.alloc_keyframe(f)
    for i in range(20):
        p = w.alloc_point(rng.uniform(-2, 2, 3), ref_kf=kf, created_kf_idx=0)
        w.add_observation(p, kf, i)
    f.ref_kf = kf
    w.update_frame_info(f)
    return w


def test_live_viewer_writes_and_throttles(tmp_path):
    w = _world_with_kf()
    path = str(tmp_path / "live.html")
    v = LiveViewer(path, interval=10.0)
    assert v.maybe_update(w)            # the first write goes through
    html = open(path).read()
    assert "http-equiv=\"refresh\"" in html
    assert len(html) > 1000
    assert not v.maybe_update(w)        # throttled inside the interval
    assert v.maybe_update(w, force=True)
    assert v.n_writes == 2
    assert not (tmp_path / "live.html.tmp").exists()  # atomic rename


def test_live_viewer_interval_elapses(tmp_path):
    w = _world_with_kf()
    v = LiveViewer(str(tmp_path / "x.html"), interval=0.05)
    assert v.maybe_update(w)
    time.sleep(0.06)
    assert v.maybe_update(w)


def test_dump_run_report_equals_reference(run, tmp_path):
    pytest.importorskip("matplotlib")
    jw, pw = _loaded(run)
    kw = run["kw"]
    jsys = SimpleNamespace(world=jw, gmap=jax_mixture.load(run["gmm_path"], **kw))
    psys = SimpleNamespace(world=pw, gmap=mixture.load(run["gmm_path"], "cpu", **kw))
    a, b = tmp_path / "jax", tmp_path / "port"
    jax_vis.dump_run_report(str(a), jsys, t_gt=run["t_wc"])
    visualizer.dump_run_report(str(b), psys, t_gt=run["t_wc"])
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) == ["covisibility.png", "map.png",
                                              "trajectory.png"]
    for n in names:
        ref = (a / n).read_bytes()
        assert len(ref) > 1000 and ref == (b / n).read_bytes(), n
