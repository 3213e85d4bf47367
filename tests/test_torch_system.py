"""The port's slice end to end against the JAX package, on the CPU.

Both `GMMLocSystem`s run the slice configuration (offline, pipeline depth
1, unpacked fused track step, host-assembled mapping), reduced to
feat_cap=256 / 240 features, a ~400-component seeded room map, 4000
landmarks and 30 frames, on the same frames. Gates: per-frame camera
centre |dt| < 5 mm and rotation < 0.05 deg, the same keyframe frames,
and a final point count within 2%.

The reference runs its local BA with the float32 products (`use_bf16=False`):
its default stages the BA Hessian products in bfloat16 for TPU bandwidth,
which the port does not (all solver math is float32). With the bf16
staging the two runs part by up to 2.6 mm / 0.067 deg after the first BA
(ROADMAP, queue 3).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gmmloc_tpu import config as jax_config_mod
from gmmloc_tpu.eval import synthetic as jax_synthetic
from gmmloc_tpu.gmm import mixture as jax_mixture
from gmmloc_tpu.mapping.map_state import _inverse
from gmmloc_tpu.pipeline.system import GMMLocSystem as JaxSystem

from gmmloc_tpu_torch.eval import room_fixture, slice_run, synthetic
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 30


def slice_config():
    return slice_run.slice_config(feat_cap=256, num_features=240, local_map_cap=1024)


def jax_config(cfg):
    """The JAX package's `SystemConfig` with the field values of the
    port's `cfg`: the two packages keep their own (equal) config classes,
    so a parity test builds both from the same overrides."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(jax_config_mod, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return jax_config_mod.SystemConfig(**kw)


@pytest.fixture(scope="module")
def fixture_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("room")
    return room_fixture.write_room_fixture(str(d), n_components=400, n_frames=60,
                                           seed=0)


def _frames(mod, cfg, paths, n):
    gmm_path, gt_path = paths
    fe, ts, q_wc, t_wc = mod.make_sequence(
        cfg, gt_path=gt_path, gmm_path=gmm_path, n_landmarks=4000, seed=0,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1)
    return [fe.make_frame(i, ts[i], q_wc[i], t_wc[i]) for i in range(n)], q_wc, t_wc


def test_port_synthetic_frames_equal_reference(fixture_paths):
    cfg = slice_config()
    a, _, _ = _frames(synthetic, cfg, fixture_paths, 5)
    b, _, _ = _frames(jax_synthetic, jax_config(cfg), fixture_paths, 5)
    assert type(a[0]) is not type(b[0])       # each package its own Frame
    for fa, fb in zip(a, b):
        for k in ("uv", "ur", "depth", "octave", "angle", "desc", "valid"):
            np.testing.assert_array_equal(getattr(fa, k), getattr(fb, k), err_msg=k)


def test_room_fixture_shape(fixture_paths):
    from gmmloc_tpu.utils import proto as jax_proto
    from gmmloc_tpu_torch.utils import proto

    means, covs, deg, _ = proto.load_gmm_file(fixture_paths[0])
    for a, b in zip(jax_proto.load_gmm_file(fixture_paths[0]), (means, covs, deg)):
        np.testing.assert_array_equal(a, b)    # both parsers read the fixture
    assert means.shape == (400, 3) and covs.shape == (400, 3, 3)
    assert 0.8 < deg.mean() < 0.95            # mostly planar tiles
    ts, q, t = synthetic.load_gt_trajectory(fixture_paths[1])
    speed = np.linalg.norm(np.diff(t, axis=0), axis=1) / np.diff(ts)
    assert abs(np.median(speed) - 0.4) < 0.1 and np.allclose(np.diff(ts), 0.05)
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-6)


def _run(system, frames, q_wc, t_wc):
    kf_frames, per_frame_pts = [], []
    n_kf = 0
    for i, f in enumerate(frames):
        system.step(f, q_wc[i], t_wc[i])
        assert not system.track_failed, f"tracking failed at {i}"
        if system.world.n_keyframes() != n_kf:
            n_kf = system.world.n_keyframes()
            kf_frames.append(i)
        per_frame_pts.append(system.world.n_points())
    system.flush()
    poses = [(f.q_cw.copy(), f.t_cw.copy()) for f in frames]
    kf_idx = sorted(int(x) for x in system.world.kf_frame_idx[system.world.kf_valid])
    return poses, kf_idx, system.world.n_points(), per_frame_pts


def _reference_ba_in_f32(monkeypatch):
    import gmmloc_tpu.mapping.localization as jax_localization

    solve = jax_localization.local_ba.solve_local_ba

    def solve_f32(*args, **kw):
        return solve(*args, use_bf16=False, **kw)

    monkeypatch.setattr(jax_localization.local_ba, "solve_local_ba", solve_f32)


def test_slice_end_to_end_matches_reference(fixture_paths, monkeypatch):
    _reference_ba_in_f32(monkeypatch)
    cfg = slice_config()
    gmm_path = fixture_paths[0]
    kw = dict(pad_to=512, neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
              neighbor_cap=cfg.gmm.neighbor_cap)

    jcfg = jax_config(cfg)
    frames, q_wc, t_wc = _frames(jax_synthetic, jcfg, fixture_paths, N_FRAMES)
    ref = _run(JaxSystem(jcfg, jax_mixture.load(gmm_path, **kw)), frames, q_wc, t_wc)
    frames, q_wc, t_wc = _frames(synthetic, cfg, fixture_paths, N_FRAMES)
    out = _run(GMMLocSystem(cfg, mixture.load(gmm_path, "cpu", **kw), "cpu"),
               frames, q_wc, t_wc)

    for i, ((qa, ta), (qb, tb)) in enumerate(zip(ref[0], out[0])):
        dt = np.linalg.norm(_inverse(qa, ta)[1] - _inverse(qb, tb)[1])
        drot = np.degrees(2 * np.arccos(min(1.0, abs(float(np.dot(qa, qb))))))
        assert dt < 5e-3 and drot < 0.05, (
            f"frame {i}: |dt| {dt * 1e3:.2f} mm, rotation {drot:.4f} deg; "
            f"keyframes ref {ref[1]} port {out[1]}; points per frame "
            f"ref {ref[3][:i + 1]} port {out[3][:i + 1]}")
    assert ref[1] == out[1], f"keyframe frames differ: ref {ref[1]} port {out[1]}"
    assert len(ref[1]) > 1
    assert abs(out[2] - ref[2]) <= 0.02 * ref[2], (ref[2], out[2])
    errs = [np.linalg.norm(_inverse(q, t)[1] - t_wc[i]) for i, (q, t) in enumerate(out[0])]
    assert max(errs) < 0.05


def test_port_imports_without_jax():
    """Every module of the port imports with JAX and the JAX package made
    unimportable, and none of them loads either."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['gmmloc_tpu'] = None\n"
        "import importlib, pkgutil, gmmloc_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(gmmloc_tpu_torch.__path__,\n"
        "                                              'gmmloc_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "for m in ('gmmloc_tpu_torch.pipeline.frontend', 'gmmloc_tpu_torch.features.detect',\n"
        "          'gmmloc_tpu_torch.features.fast_kernels', 'gmmloc_tpu_torch.pipeline.rectify',\n"
        "          'gmmloc_tpu_torch.eval.image_synthetic', 'gmmloc_tpu_torch.eval.slice_run'):\n"
        "    assert m in mods, m\n"
        "assert 'jax.numpy' not in sys.modules\n"
        "assert not [m for m in sys.modules if m.startswith('gmmloc_tpu.')]\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_no_jax_import_in_port_sources():
    """No source of the port, nor chip_smoke.py, imports JAX or the JAX
    package (`gmmloc_tpu`, not `gmmloc_tpu_torch`)."""
    import re

    bad = re.compile(r"^\s*(import|from)\s+(jax|gmmloc_tpu)(\s|\.|$)", re.M)
    pkg = os.path.join(ROOT, "gmmloc_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, fn) for fn in names if fn.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            src = f.read()
        if "import jax" in src or "from jax" in src or bad.search(src):
            offenders.append(os.path.relpath(path, ROOT))
    assert not offenders, offenders
    assert bad.search("from gmmloc_tpu.config import x") and bad.search("import gmmloc_tpu\n")
    assert not bad.search("from gmmloc_tpu_torch.config import x")


def test_entry_points_default_to_cuda():
    """Without device="cpu" the entry points ask for the card, and with no
    card they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend

    cfg = slice_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mixture.from_arrays(np.zeros((1, 3)), np.eye(3)[None] * 0.01)
    gmap = mixture.from_arrays(np.zeros((1, 3)), np.eye(3)[None] * 0.01, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GMMLocSystem(cfg, gmap)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImageFrontend(slice_run.image_config())


def test_system_rejects_unported_options():
    cfg = slice_config()
    gmap = mixture.from_arrays(np.zeros((1, 3)), np.eye(3)[None] * 0.01, "cpu")
    bad = [
        cfg.replace(online=True),
        cfg.replace(loc=dataclasses.replace(cfg.loc, use_device_world=True)),
        cfg.replace(tracking=dataclasses.replace(cfg.tracking, fused_packed_io=True)),
        cfg.replace(tracking=dataclasses.replace(cfg.tracking, pose_impl="pallas")),
    ]
    for c in bad:
        with pytest.raises(ValueError):
            GMMLocSystem(c, gmap, "cpu")
