"""The packed and device-chained track steps, and the production
configuration end to end offline, against the JAX package on the CPU.

  - the packed step: a whole 8-frame run through it equals the unpacked
    step's run bit for bit (poses, matches, map); its output vector on
    captured inputs equals `gmmloc_tpu.tracking.fused.
    fused_track_step_packed` within the track-step gates of
    `test_torch_fused.py`; the descriptor lanes carry any byte pattern
    exactly, NaN and denormal ones included;
  - the chained prep (`_chain_prep`) on captured and on seeded inputs
    equals the JAX package's: the dyn pid, validity and component columns
    exactly, positions and poses within 1e-6 m; its temporal slots are
    the host rule's (`Tracker._create_temporal_points`) with tied
    depths;
  - `production_config(online=False)` (depth 4, the mirror, packed IO,
    fused triangulation, device BA assembly), 30 frames, both packages
    with float32 BA products: the same keyframe frames, per-frame camera
    centres within 5 mm and rotations within 0.05 deg, the same primes
    and rewinds, the final point count within 2%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmmloc_tpu.geometry import camera as jcam
from gmmloc_tpu.eval import synthetic as jax_synthetic
from gmmloc_tpu.gmm import mixture as jax_mixture
from gmmloc_tpu.mapping import map_state as jms
from gmmloc_tpu.mapping.map_state import _inverse
from gmmloc_tpu.pipeline.system import GMMLocSystem as JaxSystem
from gmmloc_tpu.tracking import fused as jfused
from gmmloc_tpu.tracking.tracker import Tracker as JaxTracker

from gmmloc_tpu_torch.eval import kernel_check, room_fixture, slice_run, synthetic
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem
from gmmloc_tpu_torch.tracking import fused, tracker as ttracker

from test_torch_system import _ba_in_f32, _frames, _run, jax_config

torch.set_num_threads(1)

N_FRAMES = 30


def production_config():
    return slice_run.production_config(False, feat_cap=256, num_features=240,
                                       local_map_cap=1024)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("room")
    return room_fixture.write_room_fixture(str(d), n_components=400, n_frames=60, seed=0)


def _gmap_kw(cfg):
    return dict(pad_to=512, neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
                neighbor_cap=cfg.gmm.neighbor_cap)


def _to_jax(v):
    if isinstance(v, torch.Tensor):
        a = v.numpy()
        return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
    return v


# ---------------------------------------------------------------------------
# the production configuration end to end (and the captured step inputs)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(paths):
    """Both packages on production_config(online=False) with float32 BA
    products; the port's packed-step and chain-prep calls recorded."""
    cfg = production_config()
    jcfg = jax_config(cfg)
    calls = {"packed": [], "prep": []}
    with pytest.MonkeyPatch.context() as mp:
        _ba_in_f32(mp)
        frames, q_wc, t_wc = _frames(jax_synthetic, jcfg, paths, N_FRAMES)
        js = JaxSystem(jcfg, jax_mixture.load(paths[0], **_gmap_kw(cfg)))
        ref = _run(js, frames, q_wc, t_wc)

        for name, key in (("fused_track_step_packed", "packed"), ("_chain_prep", "prep")):
            orig = getattr(fused, name)

            def record(*args, _orig=orig, _key=key, **kw):
                calls[_key].append(([a.clone() if isinstance(a, torch.Tensor) else a
                                     for a in args], dict(kw)))
                return _orig(*args, **kw)

            mp.setattr(fused, name, record)
        frames, q_wc, t_wc = _frames(synthetic, cfg, paths, N_FRAMES)
        ps = GMMLocSystem(cfg, mixture.load(paths[0], "cpu", **_gmap_kw(cfg)), "cpu")
        out = _run(ps, frames, q_wc, t_wc)
    return dict(ref=ref, out=out, js=js, ps=ps, t_wc=t_wc, calls=calls)


def test_production_offline_matches_reference(runs):
    ref, out, js, ps = runs["ref"], runs["out"], runs["js"], runs["ps"]
    assert ps._depth == 4 and js._depth == 4
    assert ps.cfg.tracking.fused_map_refresh == "kf"
    assert ps.localizer.dev_world.n_syncs > 0
    assert ps.tracker.n_chained > N_FRAMES // 2
    for i, ((qa, ta), (qb, tb)) in enumerate(zip(ref[0], out[0])):
        dt = np.linalg.norm(_inverse(qa, ta)[1] - _inverse(qb, tb)[1])
        drot = np.degrees(2 * np.arccos(min(1.0, abs(float(np.dot(qa, qb))))))
        assert dt < 5e-3 and drot < 0.05, (
            f"frame {i}: |dt| {dt * 1e3:.2f} mm, rotation {drot:.4f} deg; "
            f"keyframes ref {ref[1]} port {out[1]}")
    assert ref[1] == out[1] and len(ref[1]) > 1
    assert (ps.n_primes, ps.n_rewinds, ps.n_rewound_frames) == (
        js.n_primes, js.n_rewinds, js.n_rewound_frames)
    assert abs(out[2] - ref[2]) <= 0.02 * ref[2], (ref[2], out[2])
    errs = [np.linalg.norm(_inverse(q, t)[1] - runs["t_wc"][i])
            for i, (q, t) in enumerate(out[0])]
    assert max(errs) < 0.05
    assert len(ps.localizer.tri_stats) > 0 and len(ps.localizer.ba_stats) > 0


@pytest.mark.parametrize("which", ["prime", "chained"])
def test_packed_step_matches_reference(runs, which):
    calls = runs["calls"]["packed"]
    # the prime's step takes the host-built tables; a chained one the prep's
    args, kw = calls[0] if which == "prime" else calls[len(calls) // 2]
    cam = args[0]
    out = fused.unpack_result(fused.fused_track_step_packed(*args, **kw).numpy(),
                              args[2].shape[0], args[5].shape[0])
    ref = fused.unpack_result(np.asarray(jfused.fused_track_step_packed(
        jcam.CameraParams(*cam), *[_to_jax(a) for a in args[1:]], **kw)),
        args[2].shape[0], args[5].shape[0])
    q, t, fp, fl, outl, n_inl, n_mot, in_view, n_anc = out
    np.testing.assert_array_equal(fp, ref[2])
    np.testing.assert_array_equal(fl, ref[3])
    np.testing.assert_array_equal(in_view, ref[7])
    assert n_mot == ref[6] and n_anc == ref[8]
    assert kernel_check.angle_deg(ref[0], q) < 0.02
    assert np.linalg.norm(ref[1] - t) < 2e-3
    assert abs(n_inl - ref[5]) <= 3 and n_inl > 50


def test_packed_run_equals_unpacked_run(paths):
    """The slice configuration with the packed step (per-frame map
    refresh) and with the unpacked step: the same 8-frame run (four
    keyframes, two BA solves), bit for bit."""
    base = slice_run.slice_config(feat_cap=256, num_features=240, local_map_cap=1024)
    res = []
    for packed in (False, True):
        cfg = base.replace(tracking=dataclasses.replace(base.tracking,
                                                        fused_packed_io=packed))
        frames, q_wc, t_wc = _frames(synthetic, cfg, paths, 8)
        s = GMMLocSystem(cfg, mixture.load(paths[0], "cpu", **_gmap_kw(cfg)), "cpu")
        out = _run(s, frames, q_wc, t_wc)
        res.append((out, [f.mappoint.copy() for f in frames], s.world))
    (a, ma, wa), (b, mb, wb) = res
    for (qa, ta), (qb, tb) in zip(a[0], b[0]):
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(ta, tb)
    assert a[1:] == b[1:] and len(a[1]) >= 3
    for x, y in zip(ma, mb):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(wa.pt_num_found, wb.pt_num_found)
    np.testing.assert_array_equal(wa.pt_pos, wb.pt_pos)


def test_descriptor_lanes_carry_raw_bytes():
    """Byte patterns that read as float32 NaN (quiet and signalling),
    infinities, -0 and denormals go through the host packing and the
    step's byte view unchanged, as through the JAX package's."""
    pats = [0x7FC00000, 0x7F800001, 0xFF800001, 0x7FBFFFFF, 0x7F800000, 0xFF800000,
            0x80000000, 0x00000001, 0x807FFFFF, 0x3F800000]
    rng = np.random.default_rng(0)
    F = 64
    desc = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    words = desc.view(np.uint32)                            # (F, 8)
    words[:len(pats), :] = np.array(pats, np.uint32)[:, None]
    words[len(pats):2 * len(pats), 3] = pats
    frame = type("F", (), {})()
    frame.feat_cap, frame.desc = F, desc
    frame.uv = rng.uniform(0, 700, (F, 2)).astype(np.float32)
    frame.ur = frame.angle = np.zeros(F, np.float32)
    frame.octave = np.zeros(F, np.int32)
    frame.valid = np.ones(F, bool)
    trk = ttracker.Tracker.__new__(ttracker.Tracker)
    trk.sigma2_inv = np.ones(8)
    pk = trk._pack_frame(frame)
    for x in (torch.from_numpy(pk), torch.from_numpy(pk).clone(), torch.from_numpy(pk)[:, :]):
        np.testing.assert_array_equal(fused.desc_bits(x, fused.CUR_DESC).numpy(), desc)
    np.testing.assert_array_equal(np.asarray(jfused._desc_bits(jnp.asarray(pk)[:, 8:16])),
                                  desc)


# ---------------------------------------------------------------------------
# the chained prep
# ---------------------------------------------------------------------------


_PREP_STATIC = ("velocity_ema", "velocity_damping", "th_depth", "temp_cap")
_jax_chain_prep = jax.jit(jfused._chain_prep, static_argnums=0,
                          static_argnames=_PREP_STATIC)


def _check_prep(args, kw):
    kw = dict(kw, **dict(zip(_PREP_STATIC, args[10:])))
    args = args[:10]
    cam = args[0]
    q0, t0, dyn, vel = (x.numpy() for x in fused._chain_prep(*args, **kw))
    jq0, jt0, jdyn, jvel = (np.asarray(x) for x in _jax_chain_prep(
        jcam.CameraParams(*cam), *[_to_jax(a) for a in args[1:]], **kw))
    np.testing.assert_array_equal(dyn[:, 3:6], jdyn[:, 3:6])
    np.testing.assert_allclose(dyn[:, 0:3], jdyn[:, 0:3], rtol=0, atol=1e-6 * (
        1 + np.abs(jdyn[:, 0:3]).max()))
    np.testing.assert_allclose(q0, jq0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t0, jt0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(vel, jvel, rtol=0, atol=1e-6)
    return dyn


def test_chain_prep_matches_reference_on_captured_inputs(runs):
    calls = runs["calls"]["prep"]
    assert len(calls) > 10
    n_temp = 0
    for args, kw in (calls[2], calls[len(calls) // 2], calls[-1]):
        dyn = _check_prep(args, kw)
        n_temp += int((dyn[:, 5] == fused.TEMP_PID).sum())
    assert n_temp > 0


def _seeded_prep(seed, ties: str):
    """Chain-prep inputs with F=64 feature slots, P=96 map slots (feature
    slots that index the map table reach past F: each gather clamps to its
    own table) and tied depths: `ties` = "none", "inside" (ties well
    inside the processed prefix) or "cutoff" (a tie group straddling the
    cap)."""
    rng = np.random.default_rng(seed)
    cam = slice_run.euroc_v1_config().camera
    from gmmloc_tpu_torch.geometry import camera as cam_mod
    cam = cam_mod.CameraParams.from_config(cam)
    F, P, MP = 64, 96, 300
    u = rng.uniform(10, 740, F).astype(np.float32)
    disp = rng.uniform(0.5, 40, F).astype(np.float32)
    if ties == "inside":
        disp[5:12] = disp[5]
    elif ties == "cutoff":
        disp[:] = rng.uniform(30, 40, F)
        disp[10:40] = 1.5                     # z ~ 29 m: one depth for 30 slots
    ur = (u - disp).astype(np.float32)
    ur[rng.random(F) < 0.1] = -1.0
    cur = np.zeros((F, fused.CUR_W), np.float32)
    cur[:, 0], cur[:, 1], cur[:, 2] = u, rng.uniform(10, 470, F), ur
    cur[:, 5] = rng.random(F) > 0.05
    q = np.array([1.0, *rng.normal(0, 0.05, 3)])
    q /= np.linalg.norm(q)
    out = np.zeros(10 + 3 * F + P, np.float32)
    out[0:4], out[4:7] = q, rng.normal(0, 1, 3)
    fp = np.where(rng.random(F) < 0.5, rng.integers(0, P, F), -1)
    fl = rng.random(F) < 0.5
    out[10:10 + F] = fp
    out[10 + F:10 + 2 * F] = fl
    out[10 + 2 * F:10 + 3 * F] = rng.random(F) < 0.1
    dyn = np.zeros((F, fused.DYN_W), np.float32)
    dyn[:, 5] = np.where(rng.random(F) < 0.7, rng.integers(0, MP, F), fused.TEMP_PID)
    map_tab = np.zeros((P, fused.MAP_W), np.float32)
    map_tab[:, 10] = np.where(rng.random(P) < 0.8, rng.integers(0, MP, P), -1)
    prev2 = np.concatenate([q, out[4:7] + rng.normal(0, 0.02, 3)]).astype(np.float32)
    vel = np.concatenate([[0.999, 0.01, 0.0, 0.02], rng.normal(0, 0.02, 3), [1.0]])
    t = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt)
    args = [cam, t(out), t(cur), t(dyn), t(map_tab), t(prev2), t(vel),
            t(rng.normal(0, 3, (MP, 3))), t(rng.random(MP) < 0.9, torch.bool),
            t(np.where(rng.random(MP) < 0.5, rng.integers(0, 50, MP), -1))]
    kw = dict(velocity_ema=0.5, velocity_damping=0.9, th_depth=20.0, temp_cap=20)
    return args, kw


def _host_temporal_slots(args, kw, host_pid):
    """The slots the JAX package's host rule (_create_temporal_points)
    gives temporal points, on the frame the prep saw: its stereo depths
    are bf / (u - ur) in float32, as the device computes them."""
    cam, out, cur = args[0], args[1].numpy(), args[2].numpy()
    F = cur.shape[0]
    cfg = jax_config(production_config())
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking,
                                                   temporal_points_cap=kw["temp_cap"]))
    world = jms.MapState(cfg)
    trk = JaxTracker(cfg, jcam.CameraParams(*cam), world)
    trk.th_depth = kw["th_depth"]
    u, ur = cur[:, 0], cur[:, 2]
    disp = u - ur
    valid = cur[:, 5] > 0.5
    depth = np.where((ur >= 0) & (disp > 1e-6) & valid,
                     np.float32(cam.bf) / np.maximum(disp, np.float32(1e-6)), -1.0)
    frame = type("F", (), {})()
    frame.depth, frame.valid = depth.astype(np.float32), valid
    frame.uv = cur[:, 0:2]
    frame.q_cw, frame.t_cw = out[0:4].astype(np.float64), out[4:7].astype(np.float64)
    frame.mappoint = np.full(F, -1, np.int32)
    real = host_pid >= 0
    frame.mappoint[real] = host_pid[real]
    world.pt_n_obs[host_pid[real]] = 2
    world.pt_valid[host_pid[real]] = True
    trk.last_frame = frame
    n_before = world.n_points()
    trk._create_temporal_points()
    assert world.n_points() >= n_before
    return np.where(frame.mappoint != np.where(real, host_pid, -1))[0]


@pytest.mark.parametrize("ties", ["none", "inside", "cutoff"])
def test_chain_prep_temporal_slots_match_host_rule(ties):
    args, kw = _seeded_prep(1, ties)
    dyn = _check_prep(args, kw)
    dev_slots = np.where(dyn[:, 5] == fused.TEMP_PID)[0]
    # the slots with a persistent landmark, as the host's last frame holds them
    pid = dyn[:, 5].astype(np.int64)
    host_pid = np.where(dyn[:, 5] >= 0, pid, -1)
    host_slots = _host_temporal_slots(args, kw, host_pid)
    assert len(dev_slots) > 5
    if ties != "cutoff":
        np.testing.assert_array_equal(np.sort(host_slots), dev_slots)
    else:
        # a tie group straddling the cutoff: the host rule (np.argsort,
        # not stable) may take other members of the group than the
        # device's stable order, in the JAX package as here (ROADMAP queue
        # 3, m); outside the group the two rules agree
        group = np.arange(10, 40)
        differ = np.setxor1d(host_slots, dev_slots)
        assert np.isin(differ, group).all(), differ
