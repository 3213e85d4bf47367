"""Card tests of the port's CUDA kernels against their plain versions.

Marked `cuda`: they skip without an NVIDIA GPU (decided inside the
fixture). They import no JAX, so on a machine without it run them with

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gmmloc_tpu_torch.config import euroc_v1_config
from gmmloc_tpu_torch.eval import kernel_check
from gmmloc_tpu_torch.geometry import camera as cam_mod

pytestmark = pytest.mark.cuda

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS_DIR)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def cam():
    return cam_mod.CameraParams.from_config(euroc_v1_config().camera)


@pytest.mark.parametrize("n", [1280, 300])
@pytest.mark.parametrize("anchored", [False, True])
def test_pose_kernel_matches_plain(device, cam, n, anchored):
    for seed in (0, 3):
        m = kernel_check.check_pose_kernel(cam, n, anchored, device, seed=seed,
                                           timing=False)
        assert m["ok"], m


@pytest.mark.parametrize("shape", [(1280, 1280), (4096, 1280), (37, 100), (1, 65),
                                   (1200, 1200), (70, 67), (5, 3), (129, 66), (300, 1282)])
def test_hamming_kernel_exact(device, shape):
    """Every path shape, M not a multiple of 4 (scalar stores), and N, M
    under one tile."""
    r = kernel_check.check_hamming_kernel(*shape, device, timing=False)
    assert r["ok"], r


def test_hamming_kernel_transposed_call(device):
    """(4096,1280) against the transposed call: a swapped or transposed
    mma fragment cannot satisfy both."""
    from gmmloc_tpu_torch.features import cuda_kernels

    a, b = kernel_check.hamming_problem(4096, 1280, device, seed=5)
    ab = cuda_kernels.hamming_matrix(a, b)
    ba = cuda_kernels.hamming_matrix(b, a)
    assert torch.equal(ab, ba.t())
    assert torch.equal(ab, cuda_kernels.hamming_matrix_plain(a, b))
    # descriptors that differ row by row in their popcounts: the rank-1
    # correction of the tensor-core form must take the right row and column
    a[::3] = 0
    b[1::2] = 255
    assert torch.equal(cuda_kernels.hamming_matrix(a, b),
                       cuda_kernels.hamming_matrix_plain(a, b))


def test_hamming_kernel_writes_into_out(device):
    from gmmloc_tpu_torch.features import cuda_kernels

    a, b = kernel_check.hamming_problem(100, 36, device, seed=2)
    out = torch.full((100, 36), -1, dtype=torch.int32, device=device)
    n0 = cuda_kernels.hamming_matrix.launches
    assert cuda_kernels.hamming_matrix(a, b, out=out) is out
    assert cuda_kernels.hamming_matrix.launches == n0 + 1
    assert torch.equal(out, cuda_kernels.hamming_matrix_plain(a, b))
    # an output off 16 bytes takes the scalar stores
    buf = torch.full((100 * 36 + 1,), -1, dtype=torch.int32, device=device)
    off = buf[1:].view(100, 36)
    cuda_kernels.hamming_matrix(a, b, out=off)
    assert torch.equal(off, out) and int(buf[0]) == -1


@pytest.mark.parametrize("shape", [(480, 752), (96, 130), (4420, 752), (7, 9), (33, 70),
                                   (20, 40), (100, 64), (65, 129)])
def test_fast_nms_kernel_bit_exact(device, shape):
    """The path shapes, widths that are not a multiple of 4 (the scalar
    fill), and images smaller than one tile."""
    img = kernel_check.random_image(*shape, device, seed=sum(shape))
    r = kernel_check.check_fast_kernel(img, timing=False)
    assert r["ok"], r


@pytest.mark.parametrize("shape", [(4420, 752), (200, 130)])
def test_fast_nms_kernel_dense_survivors(device, shape):
    """Every pixel survives the reject in both polarities: the survivor
    lists are full, and the result is still exact."""
    img = kernel_check.dense_image(*shape, device)
    r = kernel_check.check_fast_kernel(img, timing=False)
    # every pixel inside the 3 px border, in both polarities
    inside = (shape[0] - 6) * (shape[1] - 6) / (shape[0] * shape[1])
    assert r["ok"] and abs(r["survivor_share"] - inside) < 1e-9, r
    assert abs(r["arc_passes_per_pixel"] - 2 * inside) < 1e-9, r
    # the same slope wrapped to grey levels scores along its seams
    r = kernel_check.check_fast_kernel(torch.remainder(img, 256.0).contiguous(), timing=False)
    assert r["ok"] and r["n_kept"] > 0, r


def test_fast_nms_kernel_flat_and_offset_views(device):
    from gmmloc_tpu_torch.features import fast_kernels

    flat = torch.full((480, 752), 77.0, device=device)
    assert int(fast_kernels.fast_score_nms(flat).count_nonzero()) == 0
    # a view off 16 bytes takes the scalar fill and stores
    img = kernel_check.random_image(121, 752, device, seed=4)
    view = img.reshape(-1)[752:].view(120, 752)[:, :]
    shifted = img.reshape(-1)[1:1 + 120 * 752].view(120, 752)
    assert shifted.data_ptr() % 16 != 0
    for v in (view, shifted):
        assert torch.equal(fast_kernels.fast_score_nms(v),
                           fast_kernels.fast_score_nms_plain(v))
    out = torch.empty_like(view)
    assert fast_kernels.fast_score_nms(view, out=out) is out
    assert torch.equal(out, fast_kernels.fast_score_nms_plain(view))


def test_image_frontend_on_card_matches_cpu(device):
    """The one-pass front end on the card (K3, K4) against the same code
    on the CPU (the plain versions) on one rendered pair: the pyramid
    products and atan2 round differently on the card, so the tolerance is
    a share of equal keypoints and stereo decisions."""
    import os

    import numpy as np

    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.features import fast_kernels
    from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend

    cfg = slice_run.image_config()
    _, images, _, _, _ = slice_run.make_image_inputs(
        cfg, os.path.join(slice_run.default_fixture_dir(), "card_test"), 1,
        n_components=400, device="cpu")

    n0 = fast_kernels.fast_score_nms.launches
    gpu = ImageFrontend(cfg, device=device).process_packed(0, 0.0, *images[0])
    assert fast_kernels.fast_score_nms.launches == n0 + 1
    cpu = ImageFrontend(cfg, device="cpu").process_packed(0, 0.0, *images[0])
    n = cfg.frame.num_features
    same = (np.abs(gpu.uv[:n] - cpu.uv[:n]).max(1) < 1e-3) & cpu.valid[:n]
    assert same.sum() >= 0.95 * cpu.valid[:n].sum() and cpu.valid[:n].sum() > 800
    assert ((gpu.ur[:n] >= 0) == (cpu.ur[:n] >= 0)).mean() >= 0.95


@pytest.mark.parametrize("distribution", ["quota", "octree"])
def test_image_frontend_graph_replay_equals_eager(device, distribution):
    """The front end driven as the benchmark drives it (dispatch(i + 1)
    before complete(i)) over 8 seeded 752x480 pairs: the first pass runs
    eagerly, the second is captured into a CUDA graph, every later one
    replays it. Each frame's table and descriptors equal the eager pass
    (`_packed`) on the same prepared pair bit for bit, and each frame
    counts the same K3 and K4 launches, one of each."""
    import dataclasses

    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.features import cuda_kernels, fast_kernels
    from gmmloc_tpu_torch.pipeline.frontend import ImageFrontend
    from gmmloc_tpu_torch.utils import timing

    cfg = slice_run.image_config()
    cfg = cfg.replace(frame=dataclasses.replace(cfg.frame, detect_distribution=distribution))
    h, w = cfg.camera.height, cfg.camera.width
    pairs = []
    for seed in range(8):
        rng = np.random.default_rng(seed)
        img = np.kron(rng.uniform(0, 255, (h // 8, w // 8)), np.ones((8, 8)))
        img = np.clip(img + rng.normal(0, 4, (h, w)), 0, 255).astype(np.uint8)
        pairs.append((img, np.roll(img, -(3 + seed), axis=1)))
    timing.reset()
    fe, eager = ImageFrontend(cfg, device=device), ImageFrontend(cfg, device=device)
    kernels = (fast_kernels.fast_score_nms, cuda_kernels.hamming_matrix)
    launched, got, pend = [], [], None
    for i, pair in enumerate(pairs + [None]):
        new = None
        if pair is not None:
            n0 = [k.launches for k in kernels]
            new = fe.dispatch(i, 0.0, *pair)
            launched.append([k.launches - n for k, n in zip(kernels, n0)])
        if pend is not None:
            fe.complete(pend)
            got.append((pend.table.clone(), pend.desc.clone()))
        pend = new
    assert launched == [[1, 1]] * len(pairs)
    assert timing.REGISTRY.accs["frontend/replay"].count == len(pairs) - 1
    for (table, desc), pair in zip(got, pairs):
        ref_table, ref_desc = eager._packed(*eager._prepare(*pair))
        assert torch.equal(table.view(torch.int32), ref_table.cpu().view(torch.int32))
        assert torch.equal(desc, ref_desc.cpu())
        assert (table[:, 6] > 0.5).sum() > 500 and (table[:, 2] >= 0).sum() > 100


def test_kernel_wrappers_raise_on_bad_input(device, cam):
    from gmmloc_tpu_torch.features import cuda_kernels, fast_kernels
    from gmmloc_tpu_torch.solver import cuda_pose

    img = torch.zeros(16, 16, device=device)
    with pytest.raises(ValueError):
        fast_kernels.fast_score_nms(img.double())
    with pytest.raises(ValueError):
        fast_kernels.fast_score_nms(img[None])
    with pytest.raises(ValueError):
        fast_kernels.fast_score_nms(img.t()[:, :8])
    for bad in (torch.empty(16, 16, device=device, dtype=torch.float64),
                torch.empty(16, 8, device=device), torch.empty(16, 32, device=device)[:, ::2],
                torch.empty(16, 16), img, img[:]):
        with pytest.raises(ValueError):
            fast_kernels.fast_score_nms(img, out=bad)

    a = torch.zeros(8, 32, dtype=torch.uint8, device=device)
    with pytest.raises(ValueError):
        cuda_kernels.hamming_matrix(a, a[:, :16])
    with pytest.raises(ValueError):
        cuda_kernels.hamming_matrix(a, a.cpu())
    with pytest.raises(ValueError):
        cuda_kernels.hamming_matrix(a.view(-1)[8:8 * 32 - 24].view(7, 32), a)   # off 16 bytes
    for bad in (torch.empty(8, 8, device=device, dtype=torch.int64),
                torch.empty(8, 4, device=device, dtype=torch.int32),
                torch.empty(8, 16, device=device, dtype=torch.int32)[:, ::2],
                torch.empty(8, 8, dtype=torch.int32)):
        with pytest.raises(ValueError):
            cuda_kernels.hamming_matrix(a, a, out=bad)
    p = kernel_check.pose_problem(cam, 64)
    args = kernel_check.pose_args(p, device, anchored=False)
    args[2] = args[2].double()
    with pytest.raises(TypeError):
        cuda_pose.optimize_pose(cam, *args)


# The pose kernels run as a thread block cluster whose blocks meet at a
# barrier every GN step: a barrier that one block skips never completes.
# So each case below launches in a child process under its own time
# limit, and a hang fails the test instead of stopping the suite.


def _in_child(case: str, timeout: float = 300.0, **kw) -> dict:
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_cuda as t; "
            "print('RESULT ' + json.dumps(getattr(t, sys.argv[2])(**json.loads(sys.argv[3]))))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    try:
        r = subprocess.run([sys.executable, "-c", code, TESTS_DIR, case, json.dumps(kw)],
                           cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{case}({kw}) did not finish in {timeout} s: a cluster barrier hung?")
    assert r.returncode == 0, r.stderr[-4000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _child_setup(anchored, n, seed=0, **problem):
    from gmmloc_tpu_torch.solver import cuda_pose, pose_solver

    torch.backends.cuda.matmul.allow_tf32 = False
    cam = cam_mod.CameraParams.from_config(euroc_v1_config().camera)
    dev = torch.device("cuda", 0)
    p = kernel_check.pose_problem(cam, n, seed=seed, anchored=anchored, **problem)
    kern = cuda_pose.optimize_pose_anchored if anchored else cuda_pose.optimize_pose
    plain = pose_solver.optimize_pose_anchored if anchored else pose_solver.optimize_pose
    return cam, dev, p, kern, plain


def _compare(cam, dev, p, kern, plain, anchored, **kw):
    args = kernel_check.pose_args(p, dev, anchored)
    out = kern(cam, *args, **kw)
    torch.cuda.synchronize()
    m = kernel_check.compare_pose(plain(cam, *args, **kw), out, anchored)
    m["ok"] = kernel_check.within(m, kernel_check.K2_GATES if anchored
                                  else kernel_check.K1_GATES)
    m["gn_iters"] = int(out.gn_iters)
    m["q"] = out.q.cpu().tolist()
    m["t"] = out.t.cpu().tolist()
    m["num_inliers"] = int(out.num_inliers)
    m["num_outliers"] = int(out.is_outlier.sum())
    return m


def case_early_stop(anchored: bool) -> dict:
    """A noise-free problem with a loose step tolerance: every round stops
    after a few steps, in every block at the same step."""
    cam, dev, p, kern, plain = _child_setup(anchored, 1280, outlier_frac=0.0, noise=0.0)
    return _compare(cam, dev, p, kern, plain, anchored, step_tol=1e-4)


def case_degenerate(anchored: bool, nan_feature: bool) -> dict:
    """Every feature invalid and no anchors (a zero Hessian: the first step
    of each round is 0), or one valid feature with a NaN measurement (a
    non-finite step stops each round at once)."""
    cam, dev, p, kern, plain = _child_setup(anchored, 300)
    p["valid"] = np.zeros(300, bool)
    if anchored:
        p["anc_type"] = np.zeros(300, np.int32)
    if nan_feature:
        p["valid"][7] = True
        p["obs_uvr"][7, 0] = np.nan
    return _compare(cam, dev, p, kern, plain, anchored)


def case_ragged(anchored: bool, n: int) -> dict:
    """F not a multiple of the cluster's threads. At F >= 64 the kernel
    holds the pose gates against the plain version on seeds 0 and 3; a
    single feature leaves the 6x6 system rank-deficient (the pose is set
    by the 1e-6 damping and rounding), so there the kernel's chi2, flags
    and counts are held against its own pose instead."""
    from gmmloc_tpu_torch.solver import pose_solver

    res = {}
    for seed in (0, 3):
        cam, dev, p, kern, plain = _child_setup(anchored, n, seed=seed)
        if n >= 64:
            res[f"seed{seed}"] = _compare(cam, dev, p, kern, plain, anchored)
            continue
        args = kernel_check.pose_args(p, dev, anchored)
        out = kern(cam, *args)
        chi2 = pose_solver._chi2(cam, out.q, out.t, *args[2:6])
        th = torch.where(args[4], pose_solver.CHI2_STEREO, pose_solver.CHI2_MONO)
        flags = args[6] & ~(chi2 <= th)
        res[f"seed{seed}"] = dict(
            ok=bool(torch.isfinite(out.q).all() and torch.isfinite(out.t).all()
                    and torch.allclose(out.chi2, chi2, rtol=1e-4, atol=1e-4)
                    and torch.equal(out.is_outlier, flags)
                    and int(out.num_inliers) == int((args[6] & ~flags).sum())))
    return res


def case_repeatable(anchored: bool, n: int) -> dict:
    cam, dev, _, _, _ = _child_setup(anchored, n)
    return dict(ok=kernel_check.check_pose_repeatable(cam, n, anchored, dev, runs=3))


@pytest.mark.parametrize("anchored", [False, True])
def test_pose_kernel_early_stop_is_uniform(device, anchored):
    m = _in_child("case_early_stop", anchored=anchored)
    assert m["ok"], m
    assert 4 <= m["gn_iters"] < 20, m      # each round stopped early


@pytest.mark.parametrize("nan_feature", [False, True])
@pytest.mark.parametrize("anchored", [False, True])
def test_pose_kernel_degenerate_problems(device, anchored, nan_feature):
    m = _in_child("case_degenerate", anchored=anchored, nan_feature=nan_feature)
    assert m["ok"], m
    assert m["gn_iters"] == 4, m          # one step per round, then the stop
    p = kernel_check.pose_problem(cam_mod.CameraParams.from_config(
        euroc_v1_config().camera), 300)
    np.testing.assert_allclose(m["q"], p["q0"], atol=1e-7)
    np.testing.assert_allclose(m["t"], p["t0"], atol=1e-7)
    assert m["num_inliers"] == 0 and m["num_outliers"] == int(nan_feature), m


@pytest.mark.parametrize("n", [1, 64, 300, 1281])
@pytest.mark.parametrize("anchored", [False, True])
def test_pose_kernel_ragged_feature_counts(device, anchored, n):
    res = _in_child("case_ragged", anchored=anchored, n=n)
    assert all(r["ok"] for r in res.values()), res


@pytest.mark.parametrize("n", [1280, 1281])
@pytest.mark.parametrize("anchored", [False, True])
def test_pose_kernel_bit_identical_across_launches(device, anchored, n):
    assert _in_child("case_repeatable", anchored=anchored, n=n)["ok"]


# ---------------------------------------------------------------------------
# the production configuration on the card
# ---------------------------------------------------------------------------


def _production_system(device, n_frames, online, **widths):
    import os

    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

    cfg = slice_run.production_config(online, **widths)
    gmap, frames, q_wc, t_wc = slice_run.make_inputs(
        cfg, os.path.join(slice_run.default_fixture_dir(), "card_test_production"),
        n_frames, n_components=400 if widths else 3300,
        n_landmarks=4000 if widths else 30000, device=device)
    return GMMLocSystem(cfg, gmap, device), frames, q_wc, t_wc


def test_chained_step_reads_mirror_while_a_sync_runs(device):
    """The chained step reads the mirror on the tracker's stream while a
    sync of new point rows runs on a second stream in another thread, as
    the mapper's does: over 50 repetitions both steps give what the same
    two steps give one after the other."""
    import threading

    from gmmloc_tpu_torch.tracking import fused

    system, frames, q_wc, t_wc = _production_system(
        device, 12, False, feat_cap=256, num_features=240, local_map_cap=1024)
    for i in range(11):
        system.step(frames[i], q_wc[i], t_wc[i])
    trk, dw, w = system.tracker, system.localizer.dev_world, system.world
    ch = trk._chain
    assert ch is not None and system._depth == 4
    cur = trk._upload(trk._pack_frame(frames[11]))
    gmm_tab, scales = trk._dev_static()
    tk = system.cfg.tracking
    dw.sync()
    ids = np.where(w.pt_valid)[0]
    base = w.pt_pos[ids].copy()

    def step(view):
        out, dyn, _, _ = fused.fused_track_step_chained(
            system.cam, ch["out"], ch["cur"], ch["dyn"], ch["map_tab"], ch["pose_prev"],
            ch["vel"], *view, cur, ch["map_tab"], gmm_tab, scales, float(trk.log_sf),
            trk.num_levels, use_anchors=True, velocity_ema=float(tk.velocity_ema),
            velocity_damping=float(tk.velocity_damping), th_depth=float(trk.th_depth),
            temp_cap=int(tk.temporal_points_cap))
        return torch.cat([out, dyn.reshape(-1)])

    def set_rows(shift):
        w.pt_pos[ids] = base + shift
        w.dirty_pt.update(ids.tolist())
        w.map_version += 1

    # one after the other
    set_rows(0.0)
    dw.sync()
    ref0 = step(dw.read_for_tracking())
    set_rows(0.02)
    dw.sync()
    ref1 = step(dw.read_for_tracking())
    torch.cuda.synchronize()
    assert not torch.equal(ref0, ref1)

    mapper = torch.cuda.Stream(device)
    for _ in range(50):
        set_rows(0.0)
        dw.sync()
        torch.cuda.synchronize()
        out0 = step(dw.read_for_tracking())           # enqueued, still running
        set_rows(0.02)

        def sync_on_mapper():
            with torch.cuda.stream(mapper):
                dw.sync()

        th = threading.Thread(target=sync_on_mapper)
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
        out1 = step(dw.read_for_tracking())
        torch.cuda.synchronize()
        assert torch.equal(out0, ref0) and torch.equal(out1, ref1)


def test_production_online_run_on_card(device):
    """production_config(online=True) at full width, 40 frames, on the
    card: no tracking failure, camera-centre error under 5 cm, the mapper
    drained and joined, the chain and the mirror used."""
    from gmmloc_tpu_torch.eval import slice_run

    system, frames, q_wc, t_wc = _production_system(device, 40, True)
    system.online.join_timeout_s = 300.0
    slice_run.run(system, frames, q_wc, t_wc, device)
    system.stop()
    errs = slice_run.pose_errors(frames, t_wc)
    assert errs.max() < 0.05, errs.max()
    assert system._depth == 4 and system.tracker.n_chained > 20
    assert system.online.count_queue() == 0 and system.online._thread is None
    assert system.world.n_keyframes() >= 2 and system.localizer.dev_world.n_syncs > 0


def test_local_ba_graph_replay_equals_eager(device, monkeypatch):
    """The local BA's LM iterations replayed from a CUDA graph give what
    the eager iterations give, on the BA windows of a 30-frame production
    run at full width: the same LM iterations, poses, points and
    outlier decisions, bit for bit. The solves run in a second thread
    beside launches of the main thread, as the mapper's do."""
    import threading

    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.solver import local_ba

    solve = local_ba.solve_local_ba
    windows = []

    def record(cam, prob, n_free, **kw):
        windows.append((cam, prob, n_free, kw))
        return solve(cam, prob, n_free, **kw)

    monkeypatch.setattr(local_ba, "solve_local_ba", record)
    system, frames, q_wc, t_wc = _production_system(device, 30, False)
    slice_run.run(system, frames, q_wc, t_wc, device)
    assert len(windows) >= 2
    results = {}

    def mapper():
        with torch.cuda.stream(torch.cuda.Stream(device)):
            for i, (cam, prob, n_free, kw) in enumerate(windows[:4]):
                results[i] = (solve(cam, prob, n_free, **kw),
                              solve(cam, prob, n_free, cuda_graph=False, **kw))
        torch.cuda.synchronize()

    th = threading.Thread(target=mapper)
    th.start()
    x = torch.zeros(1024, device=device)
    while th.is_alive():                       # launches beside the captures
        x = x + 1.0
    th.join()
    assert len(results) == min(4, len(windows))
    for g, e in results.values():
        assert g.n_iters == e.n_iters and g.n_iters > 2
        for k in ("cam_q", "cam_t", "pts", "obs_bad", "str_drop", "obs_chi2", "cost"):
            assert torch.equal(getattr(g, k), getattr(e, k)), k


def test_local_ba_reused_graphs_equal_eager(device, monkeypatch):
    """Inside `reuse_graphs` a solve replays the LM-iteration graphs an
    earlier solve of the same shape captured, with its own problem copied
    in: on the BA windows of a 30-frame production run, solved in turn on
    a second thread, each gives what the eager iterations give, bit for
    bit, and only the first solve of a window tier captures."""
    import threading

    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.solver import local_ba

    solve = local_ba.solve_local_ba
    windows = []

    def record(cam, prob, n_free, **kw):
        windows.append((cam, prob, n_free, kw))
        return solve(cam, prob, n_free, **kw)

    monkeypatch.setattr(local_ba, "solve_local_ba", record)
    system, frames, q_wc, t_wc = _production_system(device, 30, False)
    slice_run.run(system, frames, q_wc, t_wc, device)
    assert len(windows) >= 3
    results, captures = {}, []

    def mapper():
        graphs = {}
        with torch.cuda.stream(torch.cuda.Stream(device)), local_ba.reuse_graphs(graphs):
            for i, (cam, prob, n_free, kw) in enumerate(windows[:5]):
                n0 = local_ba.thread_graph_captures()
                results[i] = solve(cam, prob, n_free, **kw)
                captures.append(local_ba.thread_graph_captures() - n0)
        for i, (cam, prob, n_free, kw) in enumerate(windows[:5]):
            results[i] = (results[i], solve(cam, prob, n_free, cuda_graph=False, **kw))
        torch.cuda.synchronize()

    th = threading.Thread(target=mapper)
    th.start()
    x = torch.zeros(1024, device=device)
    while th.is_alive():                       # launches beside the replays
        x = x + 1.0
    th.join()
    assert len(results) == min(5, len(windows))
    tiers = [(w[1].obs_cam.shape, w[1].cam_q.shape, w[2]) for w in windows[:5]]
    assert captures == [2 if t not in tiers[:i] else 0 for i, t in enumerate(tiers)], captures
    for g, e in results.values():
        assert g.n_iters == e.n_iters and g.n_iters > 2
        for k in ("cam_q", "cam_t", "pts", "obs_bad", "str_drop", "obs_chi2", "cost"):
            assert torch.equal(getattr(g, k), getattr(e, k)), k


def test_local_ba_cg_graph_replay_equals_eager(device, monkeypatch):
    """The Jacobi-preconditioned CG ("flat" at float32, "cg") replayed in
    the LM iteration's CUDA graph gives what the eager iterations give,
    bit for bit, on the BA windows of a 30-frame production run."""
    from gmmloc_tpu_torch.eval import slice_run
    from gmmloc_tpu_torch.solver import local_ba

    solve = local_ba.solve_local_ba
    windows = []

    def record(cam, prob, n_free, **kw):
        windows.append((cam, prob, n_free, kw))
        return solve(cam, prob, n_free, **kw)

    monkeypatch.setattr(local_ba, "solve_local_ba", record)
    system, frames, q_wc, t_wc = _production_system(device, 30, False)
    slice_run.run(system, frames, q_wc, t_wc, device)
    assert len(windows) >= 2
    for cam, prob, n_free, kw in windows[:3]:
        kw = dict(kw, schur_impl="flat", use_bf16=False, linear_solver="cg")
        g = solve(cam, prob, n_free, **kw)
        e = solve(cam, prob, n_free, cuda_graph=False, **kw)
        lu = solve(cam, prob, n_free, cuda_graph=False, **dict(kw, linear_solver="lu"))
        assert g.n_iters == e.n_iters and g.n_iters > 2
        for k in ("cam_q", "cam_t", "pts", "obs_bad", "str_drop", "obs_chi2", "cost"):
            assert torch.equal(getattr(g, k), getattr(e, k)), k
        assert abs(float(g.cost) - float(lu.cost)) <= 1e-3 * abs(float(lu.cost))


def test_pose_graph_on_card_is_repeatable(device):
    """The pose-graph solve on the card: two solves of one graph give the
    same poses bit for bit (no accumulating scatter), within 1e-4 of the
    CPU solve."""
    from gmmloc_tpu_torch.geometry import se3
    from gmmloc_tpu_torch.solver import pose_graph as pg

    n = 40
    rng = np.random.default_rng(0)
    ang = 2 * np.pi * np.arange(n) / n
    q = se3.so3_exp(torch.tensor(np.stack([0 * ang, 0 * ang, ang], -1), dtype=torch.float32))
    t = torch.tensor(np.stack([np.cos(ang), np.sin(ang), 0 * ang], -1), dtype=torch.float32)
    ei = torch.tensor([i for i in range(n) for d in (1, 2)], dtype=torch.int64)
    ej = torch.tensor([(i + d) % n for i in range(n) for d in (1, 2)], dtype=torch.int64)
    eq, et = se3.compose(q[ei], t[ei], *se3.inverse(q[ej], t[ej]))
    noise = torch.tensor(rng.normal(0, 0.03, (n, 6)), dtype=torch.float32)
    noise[0] = 0.0
    q0, t0 = se3.boxplus(q, t, noise)
    E = len(ei)
    g = pg.PoseGraph(q=q0, t=t0, valid=torch.ones(n, dtype=torch.bool),
                     fixed=torch.arange(n) == 0, edge_i=ei, edge_j=ej, edge_q=eq,
                     edge_t=et, edge_info=torch.full((E, 6), 100.0),
                     edge_valid=torch.ones(E, dtype=torch.bool))
    a = pg.optimize_pose_graph(g, iters=15, device=device)
    b = pg.optimize_pose_graph(g, iters=15, device=device)
    c = pg.optimize_pose_graph(g, iters=15, device="cpu")
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        torch.testing.assert_close(x.cpu(), z, atol=1e-4, rtol=1e-4)
    assert float(a[2]) < 1e-3 < float(pg.optimize_pose_graph(g, iters=0, device=device)[2])


def test_vocabulary_descent_on_card_equals_cpu(device):
    """The tree descent (a 256-entry popcount table, the first child among
    ties) gives the CPU's words on the card, ties included."""
    from gmmloc_tpu_torch.vocab.bow import Vocabulary

    rng = np.random.default_rng(0)
    descs = rng.integers(0, 256, (6000, 32), dtype=np.uint8)
    voc = Vocabulary.train(descs, k=10, depth=3, seed=0, device=device)
    cpu = voc.to("cpu")
    q = np.concatenate([descs, rng.integers(0, 256, (4000, 32), dtype=np.uint8),
                        np.zeros((10, 32), np.uint8)])
    np.testing.assert_array_equal(voc.transform_words(q), cpu.transform_words(q))
    np.testing.assert_array_equal(
        voc.word_weight, Vocabulary.train(descs, k=10, depth=3, seed=0,
                                          device="cpu").word_weight)


def test_pose_impl_on_card(device):
    """`entry()`'s track step with pose_impl "pallas" launches K1 and K2
    and equals "auto" bit for bit; "xla" launches neither and lands within
    the K2 gates (rotation < 0.02 deg, translation < 2e-3 m)."""
    from gmmloc_tpu_torch import entry
    from gmmloc_tpu_torch.solver import cuda_pose
    from gmmloc_tpu_torch.tracking import fused

    fn, args = entry.entry(device)
    cam = cam_mod.CameraParams.from_config(euroc_v1_config().camera)
    kw = dict(log_scale_factor=float(np.log(1.2)), num_levels=8, use_anchors=True)
    outs, launches = {}, {}
    for impl in ("auto", "pallas", "xla"):
        n0 = cuda_pose.optimize_pose.launches + cuda_pose.optimize_pose_anchored.launches
        outs[impl] = fused.fused_track_step_packed(cam, *args, pose_impl=impl, **kw).cpu()
        launches[impl] = (cuda_pose.optimize_pose.launches
                          + cuda_pose.optimize_pose_anchored.launches - n0)
    assert torch.equal(outs["auto"], outs["pallas"])
    assert launches == {"auto": 2, "pallas": 2, "xla": 0}, launches
    a, x = outs["auto"].numpy(), outs["xla"].numpy()
    assert kernel_check.angle_deg(a[:4], x[:4]) < 0.02 and np.abs(a[4:7] - x[4:7]).max() < 2e-3
    assert a[7] > 0


@pytest.mark.parametrize("ranks,backend", [(1, "nccl"), (2, "gloo")])
def test_sharded_paths_on_card(device, ranks, backend):
    """`dryrun_multichip` on the card (production shapes) over a real NCCL
    group of one rank and over two gloo ranks: association equal to the
    unsharded port, the BA's points and cameras equal to the unsharded
    solve at the same float64 sums. The noisy window (`entry.noisy_window`:
    a solve that moves, so a sum left out of the reduction shows) within
    the JAX package's two-process gate of the unsharded solve. Both BAs
    bit for bit at one rank."""
    from gmmloc_tpu_torch import entry

    res = entry.dryrun_multichip(ranks, "cuda", backend=backend, timeout_s=300)
    cam, gmm, pose, feat_uv, prob, L = entry.dryrun_inputs()
    ref = entry.unsharded(device, cam, gmm, pose, feat_uv, prob, L, entry.DRYRUN_ITERS)
    np.testing.assert_array_equal(res["visible"], ref["visible"])
    np.testing.assert_array_equal(res["cand"], ref["cand"])
    assert np.abs(res["pts"] - ref["pts"]).max() < 1e-5
    assert np.abs(res["cam_t"] - ref["cam_t"]).max() < 1e-5
    assert res["size"] == ranks and np.isfinite(res["cost"])
    noisy = entry.noisy_window(prob)
    nres = entry.sharded_ba(ranks, "cuda", cam, noisy, L, backend=backend, timeout_s=300)
    nref = entry.unsharded(device, cam, None, None, None, noisy, L, entry.DRYRUN_ITERS)
    for sharded, whole in ((res, ref), (nres, nref)):
        gap = entry.ba_gap(sharded, whole)
        assert entry.ba_gap_fault(gap, ranks) is None, gap


# The entry layer (`eval/`) on the card, each run in a child process with
# its own time limit: the online protocol must not synchronize the whole
# device while the mapper thread captures a CUDA graph (that fails with
# cudaErrorStreamCaptureUnsupported), and the stress run's sharded ranks
# are processes that a failed rank would leave waiting.


def _eval_fixture(root: str, n_components: int, n_frames: int) -> None:
    """The room fixture as the entry layer reads it, the port's
    `synthetic` asset names pointed at it."""
    import shutil

    from gmmloc_tpu_torch.eval import room_fixture, synthetic

    gmm_path, gt_path = room_fixture.write_room_fixture(root, n_components=n_components,
                                                        n_frames=n_frames)
    os.makedirs(os.path.join(root, "gt"), exist_ok=True)
    shutil.copy(gt_path, os.path.join(root, "gt", "V1_01_easy.txt"))
    synthetic.GT_DIR, synthetic.V1_GMM, synthetic.V2_GMM = (os.path.join(root, "gt"),
                                                            gmm_path, gmm_path)


def case_evaluate_online(root: str) -> dict:
    from gmmloc_tpu_torch.eval import evaluate

    _eval_fixture(root, 3300, 150 + 80 + 50)
    summary = evaluate.main(["--runs", "1", "--frames", "80", "--start", "150",
                             "--reloc", "0", "--online", "--pace", "20", "--out", root])
    return summary["V1_01_easy"]["runs"][0]


def test_evaluate_online_on_card(device, tmp_path):
    """`evaluate.main --online --pace 20` at full width: 80 frames
    complete, none lost, keyframes mapped on the mapper thread and the
    run's rmse under 5 cm."""
    m = _in_child("case_evaluate_online", timeout=600.0, root=str(tmp_path))
    assert m["completed"] and m["frames"] == 80 and m["lost"] == 0, m
    assert m["kfs"] >= 2 and m["ba_stats"]["n_solves"] >= 1, m
    assert m["rmse"] < 0.05, m


def case_stress_sharded(root: str) -> dict:
    from gmmloc_tpu_torch.eval import stress

    _eval_fixture(root, 3300, 60)
    out = stress.main(["10", "--ranks", "2"])
    sh = out["sharded"]
    return dict(K=out["K"], pad=out["pad"], differs=sh["differs"], size=sh["size"],
                visible=int(out["single"]["visible"].sum()),
                candidates=int((out["single"]["cand"] >= 0).sum()))


def test_stress_sharded_association_on_card(device, tmp_path):
    """The stress run's render and association on the 10x map (33000
    components) over two gloo ranks on the card: equal to one device."""
    r = _in_child("case_stress_sharded", timeout=600.0, root=str(tmp_path))
    assert r["K"] == 33000 and r["pad"] == 33024 and r["size"] == 2, r
    assert r["differs"] == [] and r["visible"] > 0 and r["candidates"] > 0, r


def case_bench_components(root: str) -> dict:
    import types

    from gmmloc_tpu_torch.eval import bench

    bench.write_fixture(root, 60)
    bench.reset_launches()
    detail = bench.components(types.SimpleNamespace(feat_cap=None, fixture=root),
                              torch.device("cuda", 0), log=lambda *a: None)
    return dict(detail=detail, launches=bench.read_launches())


def test_bench_components_on_card(device, tmp_path):
    """The bench's components at full width on the card (CUDA-event
    times): every time positive, the composite finite, and K1 (the pose
    solve), K2 and K3 (the fused track step, the match) launched."""
    r = _in_child("case_bench_components", timeout=600.0, root=str(tmp_path))
    d = r["detail"]
    for k in ("match_ms", "pose_opt_ms", "fused_track_step_ms", "render_view_ms",
              "search_corr_ms", "local_ba_ms", "frame_core_ms"):
        assert d[k] > 0, (k, d)
    assert np.isfinite(d["kernel_composite_fps"]) and d["ba_solves_per_sec"] > 0, d
    assert all(r["launches"][k] > 0 for k in ("K1", "K2", "K3")), r["launches"]


def case_prewarm_run(root: str, line: str, prewarm: bool, n: int) -> dict:
    """The bench's `line` (offline or online, full width) for n frames
    from frame 150 in a fresh process, after the port's prewarm or
    without it; online, the mapper paced (`slice_run.pace_mapper`) so the
    run repeats bit for bit. Returns the poses, keyframes and BA solves."""
    from gmmloc_tpu_torch.eval import bench, slice_run
    from gmmloc_tpu_torch.pipeline import prewarm as prewarm_mod
    from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

    dev = torch.device("cuda", 0)
    bench.point_assets(root)
    cfg = bench.line_config(line)
    frames, q_wc, t_wc = bench.feature_frames(cfg, n)
    system = GMMLocSystem(cfg, bench.load_map(cfg, dev), dev)
    captures = {}
    if prewarm:
        prewarm_mod.prewarm(cfg, system.cam, dev, stats=captures)
    for i, f in enumerate(frames):
        system.step(f, q_wc[bench.START + i], t_wc[bench.START + i])
        assert not system.track_failed, i
        slice_run.pace_mapper(system)
    system.flush()
    system.stop()
    w = system.world
    return dict(q=[np.asarray(f.q_cw).tolist() for f in frames],
                t=[np.asarray(f.t_cw).tolist() for f in frames],
                keyframes=sorted(int(x) for x in w.kf_frame_idx[w.kf_valid]),
                ba_solves=len(system.localizer.ba_stats),
                captures=captures.get("ba_graph_captures", {}))


@pytest.mark.parametrize("line", ["offline", "online"])
def test_prewarm_leaves_card_runs_unchanged(device, tmp_path, line):
    """The production configurations on the card, each in a fresh process
    (module loads, library handles, allocator and graph pools all new):
    the run after `prewarm` gives the poses of the run without it, bit for
    bit, with the same keyframes and BA solves; prewarm captured graphs."""
    from gmmloc_tpu_torch.eval import bench

    n = 60
    bench.write_fixture(str(tmp_path), bench.START + n + 50)
    runs = [_in_child("case_prewarm_run", timeout=600.0, root=str(tmp_path), line=line,
                      prewarm=p, n=n) for p in (False, True)]
    without, with_ = runs
    assert with_["captures"] and min(with_["captures"].values()) >= 1, with_["captures"]
    assert without["ba_solves"] > 0 and len(without["keyframes"]) > 1, without
    assert (with_["keyframes"], with_["ba_solves"]) == (without["keyframes"],
                                                         without["ba_solves"])
    bad = [i for i in range(n)
           if with_["q"][i] != without["q"][i] or with_["t"][i] != without["t"][i]]
    assert not bad, f"poses differ from frame {bad[0]} on ({len(bad)} frames)"
