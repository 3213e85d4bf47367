"""The port's dense-map stress run (`gmmloc_tpu_torch/eval/stress.py`)
against the JAX package's `tools/stress.py`, on the CPU.

On the seeded room fixture (400 components): `densify` bit-equal to the
JAX tool's; `mixture.from_arrays(build_neighbors=False)` giving the JAX
package's tables (the neighbour table left at -1); render and association
on the densified map equal to the JAX functions at the tool's probe (the
identity pose, 1280 features drawn with seed 0); and the tool's `main`
with its sharded run over two gloo ranks on the CPU equal to one device.
"""

import numpy as np
import pytest
import torch

from gmmloc_tpu.gmm import mixture as jax_mixture
from gmmloc_tpu.gmm import render as jax_render

from gmmloc_tpu_torch.eval import stress
from gmmloc_tpu_torch.gmm import mixture, render
from gmmloc_tpu_torch.utils import proto

from test_torch_eval_protocol import load_tool, point_assets, write_eval_fixture

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def eval_fixture(tmp_path_factory):
    return write_eval_fixture(str(tmp_path_factory.mktemp("stress_room")), n_frames=60)


@pytest.fixture(scope="module")
def jax_stress():
    return load_tool("stress")


@pytest.fixture(scope="module")
def dense(eval_fixture, jax_stress):
    means, covs, _, _ = proto.load_gmm_file(eval_fixture["gmm"])
    return means, covs


def test_densify_bit_equal(dense, jax_stress):
    means, covs = dense
    for factor, seed in ((1, 0), (3, 0), (10, 5)):
        a = stress.densify(means, covs, factor, seed=seed)
        b = jax_stress.densify(means, covs, factor, seed=seed)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert a[0].shape == (factor * len(means), 3)


@pytest.mark.parametrize("build", [False, True], ids=["no_neighbors", "neighbors"])
def test_from_arrays_tables_as_jax(dense, build):
    means, covs = stress.densify(*dense, 2)
    pad = stress.padded(len(means))
    assert pad == 1024
    kw = dict(pad_to=pad, neighbor_cap=16, neighbor_dist_thresh=2.5, build_neighbors=build)
    mine = mixture.from_arrays(means, covs, "cpu", **kw)
    ref = jax_mixture.from_arrays(means, covs, **kw)
    for k in mixture.FIELDS:
        np.testing.assert_array_equal(getattr(mine, k).numpy(), np.asarray(getattr(ref, k)),
                                      err_msg=k)
    nb = mine.neighbors.numpy()
    if build:
        assert (nb[:len(means)] >= 0).any()
    else:
        assert (nb == -1).all()
    np.testing.assert_array_equal(mine.host["neighbors"], nb)


def test_render_and_association_equal_jax(dense):
    means, covs = stress.densify(*dense, 2)
    gmap = stress.stress_map(means, covs, "cpu")
    one = stress.single_device(gmap, "cpu")
    cam, q, t, uv, fv = stress.probe_inputs("cpu")
    jmap = jax_mixture.from_arrays(means, covs, pad_to=stress.padded(len(means)),
                                   neighbor_cap=16, neighbor_dist_thresh=2.5,
                                   build_neighbors=False)
    from gmmloc_tpu.config import CameraConfig
    from gmmloc_tpu.geometry import camera as jax_cam

    jcam = jax_cam.CameraParams.from_config(CameraConfig())
    r2d = jax_render.render_view(jmap, jcam, np.asarray(q), np.asarray(t))
    cand = jax_render.search_correspondence(r2d, uv.numpy(), fv.numpy())
    assert one["visible"].sum() > 10
    np.testing.assert_array_equal(one["visible"], np.asarray(r2d.visible))
    vis = one["visible"]
    np.testing.assert_allclose(one["mean2d"][vis], np.asarray(r2d.mean2d)[vis], rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(one["cand"], np.asarray(cand))
    assert (one["cand"] >= 0).sum() > 0
    # the port's own render and search again: the timed calls change nothing
    again = render.search_correspondence(render.render_view(gmap, cam, q, t), uv, fv)
    np.testing.assert_array_equal(again.numpy(), one["cand"])


def test_stress_main_sharded_equals_one_device(eval_fixture, monkeypatch):
    point_assets(monkeypatch, eval_fixture)
    out = stress.main(["2", "--cpu", "--ranks", "2"])
    assert out["K"] == 800 and out["pad"] == 1024
    assert out["map_bytes"] > 0
    sh = out["sharded"]
    assert sh["size"] == 2 and sh["differs"] == []
    assert sh["render_collectives"]["calls"] == 2 and sh["assoc_collectives"]["calls"] == 2
    for k in ("render_ms", "assoc_ms"):
        assert out["single"][k] > 0 and sh[k] > 0
