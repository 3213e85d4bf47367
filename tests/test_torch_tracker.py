"""The classic (multi-call) tracking path against the JAX package.

The fused track step falls back to this path when it under-matches; here
both systems run it for every frame (`use_fused_track=False`) on the
seeded room fixture, with the gates of the end-to-end slice test: camera
centre |dt| < 5 mm and rotation < 0.05 deg per frame, the same keyframe
frames, a final point count within 2%. The reference BA runs with
float32 products, as in tests/test_torch_system.py.
"""

import dataclasses

import numpy as np
import torch

from gmmloc_tpu.eval import synthetic as jax_synthetic
from gmmloc_tpu.gmm import mixture as jax_mixture
from gmmloc_tpu.mapping.map_state import _inverse
from gmmloc_tpu.pipeline.system import GMMLocSystem as JaxSystem

from gmmloc_tpu_torch.eval import synthetic
from gmmloc_tpu_torch.gmm import mixture
from gmmloc_tpu_torch.pipeline.system import GMMLocSystem

from test_torch_system import (_frames, _reference_ba_in_f32, _run, fixture_paths,  # noqa: F401
                               jax_config, slice_config)

torch.set_num_threads(1)


def test_classic_tracking_matches_reference(fixture_paths, monkeypatch):  # noqa: F811
    _reference_ba_in_f32(monkeypatch)
    cfg = slice_config()
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, use_fused_track=False))
    kw = dict(pad_to=512, neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
              neighbor_cap=cfg.gmm.neighbor_cap)
    n = 26
    jcfg = jax_config(cfg)
    frames, q_wc, t_wc = _frames(jax_synthetic, jcfg, fixture_paths, n)
    jsys = JaxSystem(jcfg, jax_mixture.load(fixture_paths[0], **kw))
    ref = _run(jsys, frames, q_wc, t_wc)
    frames, q_wc, t_wc = _frames(synthetic, cfg, fixture_paths, n)
    tsys = GMMLocSystem(cfg, mixture.load(fixture_paths[0], "cpu", **kw), "cpu")
    out = _run(tsys, frames, q_wc, t_wc)
    assert tsys.tracker.dbg.get("path") == "classic"
    for i, ((qa, ta), (qb, tb)) in enumerate(zip(ref[0], out[0])):
        dt = np.linalg.norm(_inverse(qa, ta)[1] - _inverse(qb, tb)[1])
        drot = np.degrees(2 * np.arccos(min(1.0, abs(float(np.dot(qa, qb))))))
        assert dt < 5e-3 and drot < 0.05, (
            f"frame {i}: |dt| {dt * 1e3:.2f} mm, rotation {drot:.4f} deg; "
            f"keyframes ref {ref[1]} port {out[1]}")
    assert ref[1] == out[1] and len(out[1]) > 2
    assert abs(out[2] - ref[2]) <= 0.02 * ref[2], (ref[2], out[2])
