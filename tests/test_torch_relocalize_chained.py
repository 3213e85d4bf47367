"""LOST-state relocalization at pipeline depth 4, the port against the
JAX package on the CPU.

The blackout scenario of `tests/test_torch_relocalize.py` through
`slice_run.production_config` (the device-world mirror, packed IO, the
device-chained pipeline at depth 4), so the loss is found at drain time
four frames late, the frames still in flight re-run synchronously
(`_rewind_rest`) and the chain re-primes after the recovery. Widths:
feat_cap 256 / 240 features; at 64 the JAX package's depth-4 run never
recovers (`tools/torch_reloc_reference.py --depth 4`). Gates as in
`test_torch_relocalize.py`.
"""

import torch

from tests.test_torch_relocalize import _ba_in_f32, check_recovery, fixture_paths, run_both  # noqa: F401

from gmmloc_tpu_torch.eval import reloc_run, slice_run

torch.set_num_threads(1)


def test_blackout_at_depth_4_recovers_as_reference(fixture_paths, monkeypatch):
    _ba_in_f32(monkeypatch)
    cfg = slice_run.production_config(False, feat_cap=256, num_features=240,
                                      local_map_cap=1024)
    out = run_both(fixture_paths, cfg, lambda fe, ts, q, t: (
        reloc_run.blackout_frames(fe, ts, q, t, 0, 40, range(20, 24))))
    check_recovery(out)
    assert out["port"]["untracked"][:4] == [20, 21, 22, 23]
