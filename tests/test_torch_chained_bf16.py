"""`production_config(online=False)` end to end with both packages' local
BA at their default bfloat16 staging of the Hessian products.

With 8-bit Hessian entries the LM's relative-gain stop lands where the
sums' order puts it (ROADMAP queue 3, f). On this run the JAX package's
own two bfloat16 layouts part already on the keyframes: its default
"flatpm" keyframes frames [0, 1, 3, 10, 17, 20, 23, 29], its "flat"
layout [0, 1, 3, 5, 15, 20, 25], as the port does at either staging (my
CPU runs). The port is held against the reference's "flat" layout: the
same keyframe frames, points within 2%, per-frame camera centres within
7.5 mm and rotations within 0.15 deg (measured: 6.5 mm / 0.112 deg; the
float32 case in test_torch_chained.py holds 5 mm / 0.05 deg).
"""

import dataclasses

import numpy as np
import torch

from gmmloc_tpu.eval import synthetic as jax_synthetic
from gmmloc_tpu.gmm import mixture as jax_mixture
from gmmloc_tpu.mapping.map_state import _inverse
from gmmloc_tpu.pipeline.system import GMMLocSystem as JaxSystem

from gmmloc_tpu_torch.eval import room_fixture, synthetic
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

from test_torch_chained import N_FRAMES, _gmap_kw, production_config
from test_torch_system import _frames, _run, jax_config

torch.set_num_threads(1)


def test_production_offline_bf16_matches_reference(tmp_path):
    paths = room_fixture.write_room_fixture(str(tmp_path), n_components=400, n_frames=60,
                                            seed=0)
    cfg = production_config()
    jcfg = jax_config(cfg)
    jcfg = jcfg.replace(loc=dataclasses.replace(jcfg.loc, ba_schur_impl="flat"))
    frames, q_wc, t_wc = _frames(jax_synthetic, jcfg, paths, N_FRAMES)
    ref = _run(JaxSystem(jcfg, jax_mixture.load(paths[0], **_gmap_kw(cfg))), frames,
               q_wc, t_wc)
    frames, q_wc, t_wc = _frames(synthetic, cfg, paths, N_FRAMES)
    ps = GMMLocSystem(cfg, mixture.load(paths[0], "cpu", **_gmap_kw(cfg)), "cpu")
    out = _run(ps, frames, q_wc, t_wc)
    assert ps._depth == 4
    for i, ((qa, ta), (qb, tb)) in enumerate(zip(ref[0], out[0])):
        dt = np.linalg.norm(_inverse(qa, ta)[1] - _inverse(qb, tb)[1])
        drot = np.degrees(2 * np.arccos(min(1.0, abs(float(np.dot(qa, qb))))))
        assert dt < 7.5e-3 and drot < 0.15, (
            f"frame {i}: |dt| {dt * 1e3:.2f} mm, rotation {drot:.4f} deg; "
            f"keyframes ref {ref[1]} port {out[1]}")
    assert ref[1] == out[1] and len(ref[1]) > 1
    assert abs(out[2] - ref[2]) <= 0.02 * ref[2], (ref[2], out[2])
    errs = [np.linalg.norm(_inverse(q, t)[1] - t_wc[i]) for i, (q, t) in enumerate(out[0])]
    assert max(errs) < 0.05
