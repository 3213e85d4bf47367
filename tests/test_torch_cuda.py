"""Card tests of the port's CUDA kernels against their plain versions.

Marked `cuda`: they skip without an NVIDIA GPU (decided inside the
fixture). They import no JAX, so on a machine without it run them with

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from gmmloc_tpu_torch.config import euroc_v1_config
from gmmloc_tpu_torch.eval import kernel_check
from gmmloc_tpu_torch.geometry import camera as cam_mod

pytestmark = pytest.mark.cuda


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
