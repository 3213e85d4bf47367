"""The multi-device paths (`gmmloc_tpu_torch/parallel/`) on the CPU, with
gloo ranks spawned as processes (`distributed.spawn`: each rank a fresh
interpreter that imports no JAX, each with its own time limit).

  - sharded association at 2 and 3 ranks (3 pads K=128 to 129) on the
    inputs of tests/test_pipeline.py's sharded test: `visible` and the
    candidates equal to the port's unsharded `render_view` +
    `search_correspondence` and to the JAX package's;
  - sharded local BA at 2 and 3 ranks on the problem of
    tests/test_distributed.py (L=4, C=8, P=64, MO=4, "flat" at bfloat16):
    within the JAX package's two-process gate (1e-4 m) of the port's
    unsharded solve at the same float64 sums, and the same on every rank;
  - `shard_jobs`, `barrier_and_gather_json`, `init_distributed` at one
    process, and a failed or hung rank failing the spawn;
  - `eval/sweep.py --spawn 2`: one short job per rank, merged on rank 0.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from gmmloc_tpu.config import CameraConfig as JCameraConfig
from gmmloc_tpu.geometry import camera as jcam, se3 as jse3
from gmmloc_tpu.gmm import mixture as jmixture, render as jrender
from gmmloc_tpu.parallel import distributed as jdist

from gmmloc_tpu_torch import entry
from gmmloc_tpu_torch.config import CameraConfig
from gmmloc_tpu_torch.geometry import camera as cam_mod
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.eval import sweep
from gmmloc_tpu_torch.parallel import distributed

RANK_TIMEOUT_S = 240.0


@pytest.fixture
def one_thread(monkeypatch):
    """Spawned ranks run one CPU thread each (the tests run beside others)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _spawn(n, **kwargs):
    return distributed.spawn("gmmloc_tpu_torch.entry:sharded_rank", n, "cpu",
                             kwargs=dict(device="cpu", **kwargs), timeout_s=RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def assoc_inputs():
    """tests/test_pipeline.py::test_sharded_association_matches_single_device's
    inputs (its rng fixture: default_rng(42)); the JAX package's result."""
    rng = np.random.default_rng(42)
    K = 128
    means = np.stack([rng.uniform(-3, 3, K), rng.uniform(-2, 2, K), rng.uniform(5, 7, K)], -1)
    covs = np.tile(np.diag([0.04, 0.04, 1e-6]), (K, 1, 1))
    uv = rng.uniform([0, 0], [752, 480], (32, 2)).astype(np.float32)
    jc = jcam.CameraParams.from_config(JCameraConfig())
    jmap = jmixture.from_arrays(means, covs, pad_to=K)
    r = jrender.render_view(jmap, jc, jse3.quat_identity(), jnp.zeros(3))
    cand = jrender.search_correspondence(r, jnp.asarray(uv), jnp.ones(32, bool))
    gmap = mixture.from_arrays(means, covs, "cpu", pad_to=K)
    return dict(
        cam=cam_mod.CameraParams.from_config(CameraConfig()),
        gmm={k: getattr(gmap, k).numpy() for k in mixture.FIELDS},
        pose=(np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32)),
        feat_uv=uv, jax_visible=np.asarray(r.visible), jax_cand=np.asarray(cand))


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_association_matches_unsharded_and_reference(assoc_inputs, n, one_thread):
    a = assoc_inputs
    ref = entry.unsharded("cpu", a["cam"], a["gmm"], a["pose"], a["feat_uv"], None, None)
    np.testing.assert_array_equal(ref["visible"], a["jax_visible"])
    np.testing.assert_array_equal(ref["cand"], a["jax_cand"])
    assert ref["visible"].sum() > 10 and (ref["cand"] >= 0).sum() > 5
    outs = _spawn(n, cam=a["cam"], gmm=a["gmm"], pose=a["pose"], feat_uv=a["feat_uv"])
    for o in outs:
        assert o["size"] == n
        np.testing.assert_array_equal(o["visible"], ref["visible"])
        np.testing.assert_array_equal(o["cand"], ref["cand"])
        assert o["assoc_collectives"]["calls"] == 4


def _distributed_test_problem():
    """The window of tests/test_distributed.py's two-process BA."""
    cam = cam_mod.CameraParams.from_config(CameraConfig())
    rng = np.random.default_rng(0)
    L, C, Pn, MO = 4, 8, 64, 4
    cam_t = np.zeros((C, 3), np.float32)
    cam_t[:, 0] = np.arange(C) * 0.05
    cam_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (C, 1))
    pts = np.stack([rng.uniform(-2, 2, Pn), rng.uniform(-1, 1, Pn),
                    rng.uniform(3, 8, Pn)], -1).astype(np.float32)
    obs_cam = rng.integers(0, C, (Pn, MO)).astype(np.int32)
    pc = pts[:, None, :] + cam_t[obs_cam]
    uvr = np.stack([
        cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
        cam.fy * pc[..., 1] / pc[..., 2] + cam.cy,
        cam.fx * pc[..., 0] / pc[..., 2] + cam.cx - cam.bf / pc[..., 2],
    ], -1).astype(np.float32)
    uvr += rng.normal(0, 0.3, uvr.shape).astype(np.float32)
    prob = dict(
        cam_q=cam_q, cam_t=cam_t, cam_valid=np.ones(C, bool),
        pts=pts + rng.normal(0, 0.01, pts.shape).astype(np.float32),
        pt_valid=np.ones(Pn, bool), obs_cam=obs_cam, obs_uvr=uvr,
        obs_stereo=np.ones((Pn, MO), bool), obs_sigma2_inv=np.ones((Pn, MO), np.float32),
        obs_valid=np.ones((Pn, MO), bool), str_type=np.zeros(Pn, np.int32),
        str_normal=np.tile(np.array([0.0, 0, 1], np.float32), (Pn, 1)), str_mean=pts,
        str_sqrt_info=np.tile(np.eye(3, dtype=np.float32), (Pn, 1, 1)),
        prior_q=cam_q[0], prior_t=cam_t[0], has_prior=np.array(True))
    return cam, prob, L


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_ba_matches_unsharded(n, one_thread):
    """Default "flat" at bfloat16; 3 ranks pad P=64 to 66. Every rank ends
    with the same cameras (the ranks took the same steps)."""
    cam, prob, L = _distributed_test_problem()
    ref = entry.unsharded("cpu", cam, None, None, None, prob, L)
    outs = _spawn(n, cam=cam, prob=prob, n_free=L)
    for o in outs:
        err_pts = float(np.abs(o["pts"] - ref["pts"]).max())
        err_cam = float(np.abs(o["cam_t"] - ref["cam_t"]).max())
        assert err_pts < 1e-4 and err_cam < 1e-4, (err_pts, err_cam)
        np.testing.assert_array_equal(o["cam_t"], outs[0]["cam_t"])
        np.testing.assert_array_equal(o["cam_q"], outs[0]["cam_q"])
        np.testing.assert_array_equal(o["obs_bad"], ref["obs_bad"])
        assert o["n_iters"] == ref["n_iters"] and np.isfinite(o["cost"])
        assert o["points_per_rank"] == -(-64 // n)
        # two all-reduces per LM iteration (the camera system, the cost)
        # plus the stage costs and the gathers at the end
        assert o["ba_collectives"]["calls"] >= 2 * o["n_iters"]
    assert ref["cost"] < 1e3 and ref["n_iters"] > 3


def test_shard_jobs_matches_reference():
    jobs = [(s, r) for s in ["a", "b", "c"] for r in range(5)]
    for nproc in (1, 2, 3, 4):
        parts = [distributed.shard_jobs(jobs, pid, nproc) for pid in range(nproc)]
        assert parts == [jdist.shard_jobs(jobs, pid, nproc) for pid in range(nproc)]
        flat = [j for p in parts for j in p]
        assert sorted(flat) == sorted(jobs) and len(flat) == len(set(flat))


def test_barrier_and_gather_json_merges_in_rank_order(tmp_path):
    out = str(tmp_path)
    for pid in (2, 1):
        assert distributed.barrier_and_gather_json(out, "t", {"pid": pid}, pid, 3) is None
    merged = distributed.barrier_and_gather_json(out, "t", {"pid": 0}, 0, 3)
    assert merged == [{"pid": 0}, {"pid": 1}, {"pid": 2}]
    # the JAX package's file names: the two merge each other's files
    assert jdist.barrier_and_gather_json(out, "t", {"pid": 0}, 0, 3) == merged
    # a rank that never writes is None after the wait
    assert distributed.barrier_and_gather_json(str(tmp_path / "b"), "t", {"pid": 0}, 0, 2,
                                               timeout_s=0.2) == [{"pid": 0}, None]


def test_init_distributed_single_process_is_noop(monkeypatch):
    import torch.distributed as dist

    for var in ("GMMLOC_COORDINATOR", "GMMLOC_NUM_PROCESSES", "GMMLOC_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.env_spec() == jdist.env_spec() == ("127.0.0.1:9911", 1, 0)
    assert distributed.init_distributed("cpu") == (0, 1)
    assert not dist.is_initialized()


def test_spawn_fails_on_a_failed_or_hung_rank():
    """A rank that raises fails the spawn at once with its output; a rank
    that outlives its time limit is killed and fails it."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)rank \d of 2 failed.*no_such_argument"):
        distributed.spawn("gmmloc_tpu_torch.parallel.distributed:env_spec", 2, "cpu",
                          kwargs=dict(no_such_argument=1), timeout_s=RANK_TIMEOUT_S)
    with pytest.raises(RuntimeError, match="killed after 2.0 s"):
        distributed.spawn("subprocess:call", 1, "cpu", kwargs=dict(args=["sleep", "60"]),
                          timeout_s=2.0)
    assert time.monotonic() - t0 < 40


def test_sweep_merges_on_rank_zero(tmp_path, one_thread):
    """Two (seed, run) jobs of the room fixture's feature path, four frames
    each, round-robin over two gloo ranks; rank 0 merges them in rank
    order into the summary it returns and writes."""
    summ = sweep.main(["--spawn", "2", "--seeds", "0", "--runs", "2", "--frames", "4",
                       "--device", "cpu", "--out", str(tmp_path),
                       "--timeout", str(RANK_TIMEOUT_S)])
    assert summ["n_ranks"] == 2 and summ["jobs"] == [[0, 0], [0, 1]]
    assert summ["total_frames"] == 8 and len(summ["rank_wall_s"]) == 2
    assert 0.0 < summ["scaling_efficiency"] <= 1.0 and summ["agg_fps"] > 0
    assert summ["max_err_m"] < 0.05
    # the CPU runs the kernels' plain versions
    assert summ["launches"] == {"K1": 0, "K2": 0, "K3": 0}
    with open(tmp_path / "summary.json") as f:
        written = json.load(f)
    assert written["summary"] == summ
    assert [(r["seed"], r["run"]) for r in written["runs"]] == [(0, 0), (0, 1)]
    # the two jobs drew different noise
    assert written["runs"][0]["max_err_m"] != written["runs"][1]["max_err_m"]
