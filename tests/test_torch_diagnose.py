"""The port's per-frame diagnosis (`gmmloc_tpu_torch/eval/diagnose.py`)
against the JAX package's `tools/diagnose_seq.py`, on the CPU.

Both tools run the feature-level sequence of the seeded room fixture at
the small width of `test_torch_eval_protocol` with float32 BA products,
on the fused track path (the default) and the classic one
(`use_fused_track=False`). The JAX tool reads its pipelined default's
`None` stat at frame 1, so its config is made synchronous
(`pipelined_track=False`), as the port's tool runs it.

Gates: the same CSV header and row count; the integer columns (events,
counts, the tracker's diagnostics `tracker.dbg`) equal on every frame;
the map ratio within 1e-4, the columns in cm within 1e-2 cm and those in
deg within 5e-3 deg of the JAX tool's (`_tol`: 500 and 10 times tighter
than the slice's 5 mm / 0.05 deg).

The float columns first part at frame 1, the first pose solve, by
1e-5 cm (its prediction and every integer column are equal), and the gap
grows with the frames. The last test shows the cause: the two packages'
solves round in another order (XLA's fused multiply-add in the cross
product, the order of the normal equations' sums), not another formula.
"""

import dataclasses

import numpy as np
import pytest

from gmmloc_tpu_torch.eval import diagnose

from test_torch_eval_protocol import (cut_configs, load_tool, point_assets, small_v1_config,
                                      write_eval_fixture)
from test_torch_system import _ba_in_f32

N_FRAMES = 30
INT_COLS = ("frame", "res", "lost", "inliers", "kfs", "is_kf", "ref_kf", "n_motion",
            "wide_retry", "kf_fallback", "n_gmm_inl", "n_tmp", "n_per", "coasted")


@pytest.fixture(scope="module")
def eval_fixture(tmp_path_factory):
    return write_eval_fixture(str(tmp_path_factory.mktemp("diag_room")))


@pytest.fixture(scope="module")
def jax_diagnose():
    return load_tool("diagnose_seq")


def _tol(col: str) -> float:
    """The float columns' gate: float32 parity noise between the two
    packages' pose solves moves camera centres by up to 5.2e-3 cm and
    rotations by up to 1.3e-3 deg over these 30 frames (both paths, on
    the CPU); the map ratio is a ratio of equal counts. The noise is the
    rounding order of the pose solve, from frame 1 on
    (`test_float_columns_part_by_float32_rounding_order`)."""
    if col.endswith("_cm"):
        return 1e-2
    if col.endswith("_deg"):
        return 5e-3
    return 1e-4


def _read(path):
    with open(path) as f:
        header = f.readline().strip()
        rows = [line.strip().split(",") for line in f if line.strip()]
    return header, np.array(rows, dtype=np.float64)


def _run_both(eval_fixture, jax_diagnose, monkeypatch, tmp_path, fused: bool):
    _ba_in_f32(monkeypatch)
    point_assets(monkeypatch, eval_fixture)

    def cut():
        cfg = small_v1_config()
        return cfg.replace(tracking=dataclasses.replace(
            cfg.tracking, use_fused_track=fused, pipelined_track=False))

    cut_configs(monkeypatch, [diagnose], [jax_diagnose], cut)
    args = ["--seq", "V1_01_easy", "--frames", str(N_FRAMES), "--start", "0",
            "--reloc", "0"]
    out = diagnose.main(args + ["--out", str(tmp_path / "port.csv"), "--cpu"])
    monkeypatch.setattr("sys.argv", ["diagnose_seq.py"] + args
                        + ["--out", str(tmp_path / "jax.csv")])
    jax_diagnose.main()
    return out, _read(tmp_path / "port.csv"), _read(tmp_path / "jax.csv")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "classic"])
def test_diagnose_csv_matches_jax(eval_fixture, jax_diagnose, monkeypatch, tmp_path, fused):
    out, (header, rows), (ref_header, ref) = _run_both(
        eval_fixture, jax_diagnose, monkeypatch, tmp_path, fused)
    assert header == ref_header == diagnose.HEADER
    assert rows.shape == ref.shape == (N_FRAMES, len(header.split(",")))
    assert out["rows"] == out["tracked"] == N_FRAMES
    cols = header.split(",")
    ints = [cols.index(c) for c in INT_COLS]
    floats = [i for i in range(len(cols)) if i not in ints]
    for i in ints:
        np.testing.assert_array_equal(rows[:, i], ref[:, i], err_msg=cols[i])
    for i in floats:
        np.testing.assert_allclose(rows[:, i], ref[:, i], rtol=0, atol=_tol(cols[i]),
                                   err_msg=cols[i])
    # the tracker's diagnostics are there on every tracked frame after the
    # first (the bootstrap keyframe has none)
    for c in ("n_motion", "n_gmm_inl"):
        assert (rows[1:, cols.index(c)] >= 0).all(), c
    if not fused:
        for c in ("n_tmp", "n_per"):
            assert (rows[1:, cols.index(c)] >= 0).all(), c


@pytest.mark.parametrize("seed", [0, 3])
def test_float_columns_part_by_float32_rounding_order(seed):
    """Where the float columns part (the pose of frame 1, the first solve;
    its prediction and every integer column are equal): the same pose
    solve rounds in another order. (1) XLA contracts the cross products
    of `se3.quat_rotate` (`jnp.cross`, the first op of the residual) into
    one fused multiply-add, fma(a_i, b_j, -round(a_j b_i)); the port rounds
    both products, as numpy does. (2) The normal equations' sums over the
    edges (`einsum("nij,n,nik->jk")` and `("nij,n,ni->j")`,
    `pose_solver._reproj_normal`) take XLA's per-edge terms and land on
    the exact sum within float32 rounding, as XLA's do, in another order.
    (3) On XLA's H and b the port's 6x6 solve takes XLA's step bit for bit."""
    import jax
    import jax.numpy as jnp
    import torch

    from gmmloc_tpu.config import euroc_v1_config as jax_v1
    from gmmloc_tpu.geometry import camera as jcam
    from gmmloc_tpu.solver import factors as jf, pose_solver as jps

    from gmmloc_tpu_torch.eval import kernel_check
    from gmmloc_tpu_torch.geometry import camera as tcam, se3
    from gmmloc_tpu_torch.solver import pose_solver as tps
    from gmmloc_tpu_torch.utils.numerics import fma32

    rng = np.random.default_rng(seed)
    a, b = (rng.normal(size=(4096, 3)).astype(np.float32) for _ in range(2))
    xla = np.asarray(jnp.cross(jnp.asarray(a), jnp.asarray(b)))
    A, B = torch.tensor(a), torch.tensor(b)
    idx = ((1, 2), (2, 0), (0, 1))
    once = torch.stack([fma32(A[:, i], B[:, j], -(A[:, j] * B[:, i])) for i, j in idx], -1)
    np.testing.assert_array_equal(once.numpy(), xla)
    twice = np.stack([a[:, i] * b[:, j] - a[:, j] * b[:, i] for i, j in idx], -1)
    np.testing.assert_array_equal(se3.cross(A, B).numpy(), twice)
    assert (twice != xla).any()

    c = jax_v1().camera
    jc, tc = jcam.CameraParams.from_config(c), tcam.CameraParams.from_config(c)
    p = kernel_check.pose_problem(tc, 256, seed=seed)
    q0, t0, x_w, obs, st, s2i, valid = (jnp.asarray(np.asarray(p[k]))
                                        for k in kernel_check.POSE_ORDER)

    @jax.jit
    def normal_eq(q, t, x, o, s, si, v):
        r, pc, _ = jf.reproj_residual(jc, q, t, x, o, s)
        J = jf.stereo_proj_jac_pose(jc, pc, s)
        w = si * v.astype(jnp.float32) * jf.huber_weight(
            jnp.sum(r * r, -1) * si, jnp.sqrt(jnp.where(s, 7.815, 5.991)))
        return (r, J, w, jnp.einsum("nij,n,nik->jk", J, w, J),
                jnp.einsum("nij,n,ni->j", J, w, r))

    r, J, w, H, g = (np.asarray(x) for x in normal_eq(q0, t0, x_w, obs, st, s2i, valid))
    Jt, wt, rt = torch.tensor(J), torch.tensor(w), torch.tensor(r)
    mine = (torch.einsum("nij,n,nik->jk", Jt, wt, Jt).numpy(),
            torch.einsum("nij,n,ni->j", Jt, wt, rt).numpy())
    J64, w64, r64 = (x.astype(np.float64) for x in (J, w, r))
    terms = (np.einsum("nij,n,nik->nijk", J64, w64, J64), np.einsum("nij,n,ni->nij", J64, w64, r64))
    for ours, theirs, t in zip(mine, (H, g), terms):
        exact = t.sum(axis=(0, 1))
        bound = 2 * t.shape[0] * t.shape[1] * np.finfo(np.float32).eps * np.abs(t).sum(axis=(0, 1))
        assert (np.abs(ours - exact) <= bound).all() and (np.abs(theirs - exact) <= bound).all()
    step = -tps._chol_solve6(torch.tensor(H) + torch.eye(6) * 1e-6, torch.tensor(g))
    ref = -np.asarray(jps._chol_solve6(jnp.asarray(H) + jnp.eye(6) * 1e-6, jnp.asarray(g)))
    np.testing.assert_array_equal(step.numpy(), ref)
