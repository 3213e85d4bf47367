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


@pytest.mark.parametrize("shape", [(1280, 1280), (4096, 1280), (37, 100), (1, 65)])
def test_hamming_kernel_exact(device, shape):
    r = kernel_check.check_hamming_kernel(*shape, device, timing=False)
    assert r["ok"], r


@pytest.mark.parametrize("shape", [(480, 752), (96, 130), (4420, 752), (7, 9), (33, 70)])
def test_fast_nms_kernel_bit_exact(device, shape):
    img = kernel_check.random_image(*shape, device, seed=sum(shape))
    r = kernel_check.check_fast_kernel(img, timing=False)
    assert r["ok"], r


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

    a = torch.zeros(8, 32, dtype=torch.uint8, device=device)
    with pytest.raises(ValueError):
        cuda_kernels.hamming_matrix(a, a[:, :16])
    with pytest.raises(ValueError):
        cuda_kernels.hamming_matrix(a, a.cpu())
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
