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


def test_kernel_wrappers_raise_on_bad_input(device, cam):
    from gmmloc_tpu_torch.features import cuda_kernels
    from gmmloc_tpu_torch.solver import cuda_pose

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
