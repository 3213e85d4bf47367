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
    the CPU); the map ratio is a ratio of equal counts."""
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
