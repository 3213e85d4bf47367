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
