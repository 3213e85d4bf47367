"""The benchmark's generator copies against the port's originals, at
small sizes on the CPU."""

import os

import numpy as np
import pytest
import torch

from gmmloc_tpu_torch.eval import image_synthetic, room_fixture, slice_run, synthetic
from portbench import generate, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_room_map_equals_port():
    means, covs = generate.room_gmm(330, seed=7)
    m0, c0, _ = room_fixture.make_room_gmm(330, seed=7)
    assert np.array_equal(means, m0)
    np.testing.assert_allclose(covs, c0, rtol=1e-12, atol=1e-18)


def test_trajectory_equals_port_text_round_trip(tmp_path):
    _, gt = room_fixture.write_room_fixture(str(tmp_path), n_components=50, n_frames=300,
                                            seed=5)
    ts0, q0, t0 = synthetic.load_gt_trajectory(gt)
    ts, q, t = generate.room_trajectory(300, seed=5)
    assert np.array_equal(ts, ts0) and np.array_equal(q, q0) and np.array_equal(t, t0)


def _world_pair(n_comp=200, n_lm=3000, seed=3):
    means, covs = generate.room_gmm(n_comp, seed)
    return (means, covs, generate.sample_world(means, covs, n_lm, seed),
            synthetic.sample_world_from_gmm(means, covs, n_landmarks=n_lm, seed=seed))


def test_world_equals_port():
    _, _, w, w0 = _world_pair()
    np.testing.assert_allclose(w.landmarks, w0.landmarks, rtol=0, atol=1e-12)
    for k in ("desc", "base_angle", "ref_dist", "response"):
        assert np.array_equal(getattr(w, k), getattr(w0, k)), k


class _Recorder:
    """The port's generator's numpy Generator, recording every draw."""

    def __init__(self, rng):
        self.rng, self.draws = rng, []

    def __getattr__(self, name):
        fn = getattr(self.rng, name)

        def call(*a, **kw):
            out = fn(*a, **kw)
            self.draws.append(np.array(out, copy=True))
            return out
        return call


def _noise_from_draws(draws, n_frames, p):
    """The port's draws, frame by frame, in `draw_feature_noise`'s shapes
    (slots past a frame's landmarks padded)."""
    B, S = generate.feature_budget(p)
    per = len(draws) // n_frames
    assert per == 10
    out = {k: [] for k in ("fresh_uv", "fresh_d", "fresh_det", "stereo_u", "flips", "su",
                           "sv", "sdesc", "soct", "sang")}
    for k in range(n_frames):
        d = draws[k * per:(k + 1) * per]
        out["fresh_uv"].append(d[0])
        out["fresh_d"].append(d[1])
        out["fresh_det"].append(d[2])
        st = np.ones(B)
        st[:len(d[3])] = d[3]
        fl = np.zeros((B, p["desc_flip_bits"]), np.int64)
        fl[:len(d[4])] = d[4]
        out["stereo_u"].append(st)
        out["flips"].append(fl)
        for key, x in zip(("su", "sv", "sdesc", "soct", "sang"), d[5:]):
            out[key].append(x)
    return {k: torch.as_tensor(np.stack(v)) for k, v in out.items()}


@pytest.mark.parametrize("num_features", [1200, 240])
def test_feature_frames_equal_port(num_features):
    """The batched maker fed the port's draws gives the port's per-frame
    frames (num_features 240: over budget, ranked by response; 1200: every
    kept landmark, in id order)."""
    cfg = slice_run.production_config(False, feat_cap=num_features + 16,
                                      num_features=num_features)
    _, _, w, w0 = _world_pair()
    ts, q, t = generate.room_trajectory(40, seed=3)
    traffic = run.load_json(os.path.join(ROOT, "portbench", "traffic", "feature_frames.json"))
    config = run.load_json(os.path.join(ROOT, "portbench", "configs", "euroc_v1_offline.json"))
    config["frame"].update(num_features=num_features, feat_cap=num_features + 16)
    p = run.generator_params(config, traffic)
    fe = synthetic.SyntheticFrontend(w0, cfg, seed=4, pixel_noise=p["pixel_noise"],
                                     disp_noise=p["disp_noise"], drop_frac=p["drop_frac"])
    fe.rng = _Recorder(fe.rng)
    n = 6
    port = [fe.make_frame(i, ts[i], q[i], t[i]) for i in range(n)]
    noise = _noise_from_draws(fe.rng.draws, n, p)
    rho = generate.noise_rho(q[:n], t[:n])
    # batched: all six at once, and three plus three with the state carried
    ours, _ = generate.make_feature_frames(w, q[:n], t[:n], rho, noise, None, p, "cpu")
    first = {k: v[:3] for k, v in noise.items()}
    rest = {k: v[3:] for k, v in noise.items()}
    a, st = generate.make_feature_frames(w, q[:3], t[:3], rho[:3], first, None, p, "cpu")
    b, _ = generate.make_feature_frames(w, q[3:n], t[3:n], rho[3:], rest, st, p, "cpu")
    for frames in (ours, a + b):
        for f0, f in zip(port, frames):
            m = len(f["uv"])
            assert m == f0.num_features()
            np.testing.assert_allclose(f["uv"], f0.uv[:m], rtol=0, atol=1e-4)
            np.testing.assert_allclose(f["ur"], f0.ur[:m], rtol=0, atol=1e-4)
            np.testing.assert_allclose(f["depth"], f0.depth[:m], rtol=1e-6, atol=0)
            np.testing.assert_allclose(f["angle"], f0.angle[:m], rtol=0, atol=1e-4)
            assert np.array_equal(f["octave"], f0.octave[:m])
            assert np.array_equal(f["desc"], f0.desc[:m])


def test_feature_frames_repeat_for_a_seed():
    _, _, w, _ = _world_pair(n_lm=2000)
    ts, q, t = generate.room_trajectory(12, seed=1)
    config = run.load_json(os.path.join(ROOT, "portbench", "configs", "euroc_v1_offline.json"))
    traffic = run.load_json(os.path.join(ROOT, "portbench", "traffic", "feature_frames.json"))
    p = run.generator_params(config, traffic)
    a = generate.feature_frames(w, q, t, 2**31 + 11, p, "cpu", chunk=5)
    b = generate.feature_frames(w, q, t, 2**31 + 11, p, "cpu", chunk=5)
    c = generate.feature_frames(w, q, t, 2**31 + 12, p, "cpu", chunk=5)
    assert all(np.array_equal(x["desc"], y["desc"]) and np.array_equal(x["uv"], y["uv"])
               for x, y in zip(a, b))
    assert not np.array_equal(a[0]["uv"], c[0]["uv"])


def test_render_equals_port():
    cfg = slice_run.image_config(slice_run.production_config(True))
    _, _, w, w0 = _world_pair(n_comp=300, n_lm=2500, seed=9)
    ts, q, t = generate.room_trajectory(200, seed=9)
    ren = image_synthetic.SpriteRenderer(w0, cfg, seed=9)
    contrast, size_m = generate.sprite_looks(len(w.landmarks), seed=9)
    np.testing.assert_array_equal(contrast, ren.contrast)
    np.testing.assert_array_equal(size_m, ren.size_m)
    config = run.load_json(os.path.join(ROOT, "portbench", "configs", "euroc_v1_online.json"))
    p = run.generator_params(config, {})
    to8 = lambda im: np.clip(np.round(im), 0, 255).astype(np.uint8)  # noqa: E731
    for k in (150, 190):
        for right in (False, True):
            ref = to8(ren.render(q[k], t[k], right))
            ours = generate.render(w, contrast, size_m, q[k], t[k], p, right, "cpu").numpy()
            diff = np.abs(ours.astype(int) - ref.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-4


def _inputs_digest(cell: str, seed: int, seconds: float, warm: int, **traffic_keys):
    """sha256 over the ground truth, the map and every frame or pair that
    `run.make_inputs` makes for a cell (warm-up `warm`), and the count."""
    import hashlib

    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    c = run.find_cell(bench, cell)
    config = run.load_json(os.path.join(ROOT, "portbench", "configs", c["config"] + ".json"))
    traffic = run.load_json(os.path.join(ROOT, "portbench", "traffic", c["traffic"] + ".json"))
    traffic.update(traffic_keys, warmup_frames={"online": warm, "offline": warm})
    (ts, q, t), (m, cv), data, _, _ = run.make_inputs(config, traffic, seed, seconds, "cpu")
    h = hashlib.sha256()
    for a in (ts, q, t, m, cv):
        h.update(np.ascontiguousarray(a).tobytes())
    for f in data:
        parts = [f[k] for k in ("uv", "ur", "depth", "octave", "angle", "desc")] \
            if isinstance(f, dict) else f
        for a in parts:
            h.update(np.ascontiguousarray(a).tobytes())
    return len(data), h.hexdigest()


@pytest.mark.parametrize("cell,seed,seconds,digest", [
    ("v1_offline_features", 2**31 + 17, 0.5,
     "e4fc0eda180066d04b3aec6a7806b5d74dd90e3a2d35d92509e9bec90ce455a5"),
    ("v1_online_images", 2**31 + 18, 0.1,
     "e877fd8c135d25ebbacc5693e8eb5a3fbceca31c2d40868ef2497f834cbeba72"),
])
def test_existing_traffics_make_the_same_inputs(cell, seed, seconds, digest):
    """The traffics without dropouts make byte for byte the inputs the
    generator made before it had dark stretches (the digests were taken
    from that generator on the CPU at these seeds and sizes)."""
    n, got = _inputs_digest(cell, seed, seconds, 2)
    assert got == digest and n == 2 + int(np.ceil(seconds * (60 if "features" in cell else 20))) + 1


def test_dark_mask():
    traffic = dict(dark_every=10, dark_frames=3, dark_from=4)
    dark = generate.dark_mask(40, 5, traffic)
    assert np.nonzero(dark)[0].tolist() == [9, 10, 11, 19, 20, 21, 29, 30, 31, 39]
    assert generate.dark_mask(40, 5, {}) is None


def test_dark_frames_leave_the_lit_frames_as_they_were():
    """A traffic with dark stretches draws what the one without draws: its
    lit frames are byte for byte the same, its dark ones keep only the
    spurious detections."""
    _, _, w, _ = _world_pair(n_lm=2000)
    ts, q, t = generate.room_trajectory(40, seed=1)
    config = run.load_json(os.path.join(ROOT, "portbench", "configs", "euroc_v1_online.json"))
    traffic = run.load_json(os.path.join(ROOT, "portbench", "traffic",
                                         "feature_blackouts.json"))
    p = run.generator_params(config, traffic)
    dark = generate.dark_mask(40, 5, dict(traffic, dark_every=12, dark_from=3))
    lit = generate.feature_frames(w, q, t, 2**31 + 11, p, "cpu", chunk=16)
    mixed = generate.feature_frames(w, q, t, 2**31 + 11, p, "cpu", chunk=16, dark=dark)
    _, n_spurious = generate.feature_budget(p)
    assert dark.sum() == 18
    for k, (a, b) in enumerate(zip(lit, mixed)):
        if dark[k]:
            assert len(b["uv"]) == n_spurious
            for key in a:
                assert np.array_equal(b[key], a[key][-n_spurious:]), key
        else:
            for key in a:
                assert np.array_equal(a[key], b[key]), key


def test_vocabulary_descs_are_the_rooms_landmarks():
    means, covs = generate.room_gmm(200, 3)
    d = generate.vocabulary_descs("landmark_desc_every_4", means, covs, 3000, 3)
    assert np.array_equal(d, generate.sample_world(means, covs, 3000, 3).desc[::4])
    with pytest.raises(ValueError):
        generate.vocabulary_descs("orbvoc", means, covs, 3000, 3)
