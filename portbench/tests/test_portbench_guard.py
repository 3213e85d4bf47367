"""What the harness and its reference load, and its refusal without a
card."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# a cell's loop for a few frames on the CPU at a cut width, through the
# harness's own functions, then every top-level module name it loaded
_LOOP = """
import json, sys
from portbench import run
run.run_cell("v1_offline_features", 2**31 + 5, 1.0, False, "cpu", prewarm=False, warmup=3,
             overrides=dict(frame=dict(feat_cap=256, num_features=240),
                            port={"frame.feat_cap": 256, "frame.num_features": 240,
                                  "tracking.fused_local_map_cap": 1024}))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE = """
import json, sys
import portbench.reference, portbench.generate, portbench.arith, portbench.peaks
import portbench.trace, portbench.capture
from portbench.reference import (association, bow, camera, detect, factors, fast, frontend,
                                 hamming, local_ba, numerics, orb, pose_solver, pyramid, se3,
                                 stereo)
from portbench.checks import (association as assoc_check, ba, frontend as fe_check,
                              matching as k3_check, pose, reloc)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code: str) -> list:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_cell_loads_nothing_of_jax():
    mods = _modules(_LOOP)
    assert "gmmloc_tpu_torch" in mods and "portbench" in mods
    # whole top-level names: gmmloc_tpu_torch is not gmmloc_tpu
    assert not {"jax", "jaxlib", "flax", "gmmloc_tpu"} & set(mods)


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(_REFERENCE)
    assert not {"gmmloc_tpu_torch", "gmmloc_tpu", "jax", "jaxlib"} & set(mods)


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "gmmloc_tpu_torch.fake", object())
    assert "gmmloc_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in run.forbidden_modules()


@pytest.mark.parametrize("cell", ["v1_online_images", "v1_offline_features",
                                  "v1_online_features"])
def test_refuses_without_a_card(cell):
    """No fallback to the CPU: no card, a non-zero exit and no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
                          str(2**31 + 3), "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
