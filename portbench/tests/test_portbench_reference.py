"""The reference's frozen copies against the port's originals on the CPU:
the keyframe association and the local BA."""

import math

import numpy as np
import torch

from gmmloc_tpu_torch.config import euroc_v1_config
from gmmloc_tpu_torch.geometry import camera as port_cam
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.mapping import association as port_assoc
from gmmloc_tpu_torch.solver import local_ba as port_ba
from portbench import generate
from portbench.checks import association as assoc_check
from portbench.reference import association as ref_assoc
from portbench.reference import camera as ref_cam
from portbench.reference import local_ba as ref_ba

CAM = (435.2046959714599, 435.2046959714599, 367.4517211914062, 252.2008514404297, 752, 480,
       47.90639384423901)


def _keyframe(means, covs, F=300, seed=4):
    """A keyframe of the room loop: its pose and features on landmarks
    sampled from the map, with stereo depth and pixel noise."""
    ts, q_wc, t_wc = generate.room_trajectory(200, seed=0)
    q_wc, t_wc = torch.tensor(q_wc[160]), torch.tensor(t_wc[160])
    q_cw = q_wc * torch.tensor([1.0, -1, -1, -1])
    t_cw = -ref_assoc.se3.quat_rotate(q_cw, t_wc)
    world = generate.sample_world(means, covs, 20000, seed)
    pc = ref_assoc.se3.apply(q_cw, t_cw, torch.tensor(world.landmarks))
    cam = ref_cam.CameraParams(*CAM)
    uvr, vis = ref_cam.project_stereo(cam, pc)
    idx = torch.nonzero(vis & (pc[:, 2] > 0.5)).flatten()
    idx = idx[torch.randperm(len(idx), generator=torch.Generator().manual_seed(seed))[:F]]
    gen = torch.Generator().manual_seed(seed + 1)
    uv = uvr[idx, :2] + 0.3 * torch.randn(len(idx), 2, generator=gen, dtype=torch.float64)
    depth = pc[idx, 2] * (1 + 0.01 * torch.randn(len(idx), generator=gen, dtype=torch.float64))
    ur = uv[:, 0] - CAM[6] / depth
    octave = torch.randint(0, 8, (len(idx),), generator=gen)
    valid = torch.rand(len(idx), generator=gen) > 0.05
    f32 = lambda t: t.float()  # noqa: E731
    return f32(q_cw), f32(t_cw), f32(uv), f32(ur), octave, valid, f32(depth)


def test_association_equals_the_port():
    """The reference's association (map tables derived from the raw
    arrays, render, search, point solves) is the port's kernel's, at the
    same float32 inputs and on the same map."""
    means, covs = generate.room_gmm(400, 0)
    cfg = euroc_v1_config()
    gmap = mixture.from_arrays(means, covs, "cpu", pad_to=512)
    q, t, uv, ur, octave, valid, depth = _keyframe(means, covs)
    sf = torch.tensor([1.2 ** l for l in range(8)], dtype=torch.float64)
    s2i = (1.0 / (sf * sf)).float()
    p = assoc_check.PARAMS
    got = port_assoc.associate_and_check_kernel(
        gmap, port_cam.CameraParams.from_config(cfg.camera), q, t, uv, ur, octave, valid,
        depth, s2i, **p)
    ref_map = ref_assoc.as_dtype(ref_assoc.gmm_map(means, covs, 512, **assoc_check.MAP),
                                 torch.float32)
    want = ref_assoc.associate(ref_map, ref_cam.CameraParams(*CAM), q, t, uv, ur, octave,
                               valid, depth, s2i, **p)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((want[1] >= 0).sum()) > 50                      # the test associates
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-5)
    assert torch.equal(gmap.neighbors[:400], ref_map["neighbors"][:400])


def test_association_check_reads_zero_on_the_port_and_fails_the_control():
    means, covs = generate.room_gmm(400, 0)
    q, t, uv, ur, octave, valid, depth = _keyframe(means, covs)
    gmap = mixture.from_arrays(means, covs, "cpu", pad_to=512)
    cfg = euroc_v1_config()
    sf = torch.tensor([1.2 ** l for l in range(8)], dtype=torch.float64)
    out = port_assoc.associate_and_check_kernel(
        gmap, port_cam.CameraParams.from_config(cfg.camera), q, t, uv, ur, octave, valid,
        depth, (1.0 / (sf * sf)).float(), **assoc_check.PARAMS)
    item = dict(q_cw=q, t_cw=t, uv=uv, ur=ur, octave=octave, valid=valid, depth=depth,
                cand=out[0], assoc=out[1], pt_out=out[2])

    class Calls:
        def kept(self):
            return [item]

    kept = {"calls": Calls(), "means": means, "covs": covs, "pad_to": 512,
            "frame": {"scale_factor": 1.2, "num_levels": 8}}
    ref = {"cam": ref_cam.CameraParams(*CAM)}
    sound = assoc_check.numbers(kept, ref)
    assert all(v <= assoc_check.LIMITS[k] for k, v in sound.items()), sound
    control = assoc_check.numbers(kept, ref, control="bf16")
    assert any(v > assoc_check.LIMITS[k] for k, v in control.items()), control


def _ba_problem(dtype=torch.float64, C=5, P=120, MO=4, seed=2):
    """A small window: C cameras along the room loop (the first held by a
    prior), P points seen from up to MO of them with pixel noise, some
    with plane or full GMM structure terms, the start perturbed."""
    g = torch.Generator().manual_seed(seed)
    ts, q_wc, t_wc = generate.room_trajectory(200, seed=0)
    q_wc, t_wc = torch.tensor(q_wc[100:100 + 4 * C:4]), torch.tensor(t_wc[100:100 + 4 * C:4])
    q_cw = q_wc * torch.tensor([1.0, -1, -1, -1])
    t_cw = -ref_ba.se3.quat_rotate(q_cw, t_wc)
    cam = ref_cam.CameraParams(*CAM)
    # points in front of the middle camera
    xc = torch.stack([torch.rand(P, generator=g) * 4 - 2, torch.rand(P, generator=g) * 3 - 1.5,
                      torch.rand(P, generator=g) * 4 + 2], -1).double()
    qm, tm = ref_ba.se3.inverse(q_cw[C // 2], t_cw[C // 2])
    pts = ref_ba.se3.apply(qm, tm, xc)
    obs_cam = torch.full((P, MO), -1, dtype=torch.int64)
    obs_uvr = torch.zeros(P, MO, 3, dtype=torch.float64)
    for p in range(P):
        cams = torch.randperm(C, generator=g)[:MO]
        for m, c in enumerate(cams.tolist()):
            uvr, vis = ref_cam.project_stereo(cam, ref_ba.se3.apply(q_cw[c], t_cw[c], pts[p]))
            obs_cam[p, m] = c
            obs_uvr[p, m] = uvr + 0.5 * torch.randn(3, generator=g, dtype=torch.float64)
    str_type = torch.randint(0, 3, (P,), generator=g)
    normal = torch.nn.functional.normalize(torch.randn(P, 3, generator=g, dtype=torch.float64),
                                           dim=-1)
    L = torch.linalg.cholesky(torch.eye(3, dtype=torch.float64) * 400.0).expand(P, 3, 3)
    dq = torch.cat([torch.ones(C, 1), 0.002 * torch.randn(C, 3, generator=g)], -1).double()
    q0 = ref_ba.se3.quat_mul(dq, q_cw)
    q0 = q0 / q0.norm(dim=-1, keepdim=True)
    fields = dict(
        cam_q=q0, cam_t=t_cw + 0.01 * torch.randn(C, 3, generator=g, dtype=torch.float64),
        cam_valid=torch.ones(C, dtype=torch.bool),
        pts=pts + 0.02 * torch.randn(P, 3, generator=g, dtype=torch.float64),
        pt_valid=torch.rand(P, generator=g) > 0.05, obs_cam=obs_cam, obs_uvr=obs_uvr,
        obs_stereo=torch.rand(P, MO, generator=g) > 0.3,
        obs_sigma2_inv=torch.ones(P, MO, dtype=torch.float64),
        obs_valid=torch.rand(P, MO, generator=g) > 0.1, str_type=str_type,
        str_normal=normal, str_mean=pts.clone(), str_sqrt_info=L.clone(),
        prior_q=q_cw[0].clone(), prior_t=t_cw[0].clone(), has_prior=torch.tensor(True))
    return cam, {k: v.to(dtype) if v.is_floating_point() else v for k, v in fields.items()}


def test_local_ba_equals_the_port():
    """The trimmed reference solve is the port's solve on the path the
    configuration runs ("flatpm", LU, bfloat16-staged products), bit for
    bit at float64 on the CPU."""
    cam, f = _ba_problem()
    kw = dict(ba_lambda2=400.0, tri_str_thresh=0.0064,
              prior_rot_info=1.0 / math.radians(2.0) ** 2, prior_trans_info=1.0 / 0.01 ** 2,
              iters1=5, iters2=5, iters3=40, term_gain=1e-5)
    want = port_ba.solve_local_ba(cam, port_ba.BAProblem(**f), 4, schur_impl="flatpm",
                                  linear_solver="lu", cuda_graph=False, **kw)
    got = ref_ba.solve_local_ba(cam, ref_ba.BAProblem(**f), 4, **kw)
    assert got.n_iters == want.n_iters > 3
    for k in ("cam_q", "cam_t", "pts", "obs_bad", "str_drop", "cost"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    moved = (got.pts - f["pts"])[f["pt_valid"]].norm()
    assert float(moved) > 0.05


def test_local_ba_state_hook_is_the_identity():
    """`_state_round` (the bf16-state control's hook) changes nothing when
    left alone and moves the solution when set."""
    cam, f = _ba_problem(seed=3)
    a = ref_ba.solve_local_ba(cam, ref_ba.BAProblem(**f), 4)
    saved = ref_ba._state_round
    ref_ba._state_round = lambda x: x.to(torch.bfloat16).to(x.dtype)
    try:
        b = ref_ba.solve_local_ba(cam, ref_ba.BAProblem(**f), 4)
    finally:
        ref_ba._state_round = saved
    assert ref_ba._state_round is ref_ba._unrounded
    assert float((a.pts - b.pts).norm()) > 1e-3
    assert np.isfinite(float(b.cost))
