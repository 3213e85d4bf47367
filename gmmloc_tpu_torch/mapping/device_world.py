"""Device-resident world mirror: keyframe feature tables + landmark attributes.

PyTorch port of `gmmloc_tpu/mapping/device_world.py`. The mapping kernels
(fused triangulation, the fusion gathers, the BA assembly) and the
device-chained track step gather from tensors on the card instead of
re-uploading the rows they need on every keyframe:

  - keyframe feature tables (uv/ur/desc/octave/angle/valid/depth/cand)
    change once per keyframe (alloc, culling) -> dirty-row writes;
  - landmark attributes (pos/normal/dist bounds/descriptor/observation
    tables/validity/association) change in known batches -> dirty-row
    writes;
  - keyframe poses are small -> re-uploaded wholesale.

`MapState` marks dirty rows at its mutation sites; `sync()` gathers them
on the host, uploads each table group's rows in one host-to-device copy
and writes them with one `index_copy_` per table.

Streams. In online mode `sync()` runs on the mapper thread's stream while
the tracker's chained step reads `pt_pos`, `pt_valid` and `pt_comp` on
its own. The rule: a sync never writes a tensor the tracker may read. It
publishes fresh copies of those three (copy-on-write, ~1 MB at full
width) together with a CUDA event recorded after the writes, as one
attribute (`track_view`); the reader makes its stream wait on that event
and calls `record_stream` on the three tensors, so the caching allocator
does not hand their blocks to the mapper's stream while the tracker's
queued work still reads them. A dispatch therefore sees the mirror as it
stood when it was enqueued, as the JAX package's functional updates give.
Every other table is read and written on the mapper's stream only.
"""

from __future__ import annotations

import numpy as np
import torch

from .map_state import MapState


def _upload(arrays, device):
    """Host arrays -> device tensors of the same dtypes and shapes through
    ONE host-to-device copy of their bytes."""
    blobs = [np.ascontiguousarray(a) for a in arrays]
    offs, n = [], 0
    for b in blobs:
        offs.append(n)
        n += -(-b.nbytes // 8) * 8          # keep every segment 8-byte aligned
    buf = np.zeros(n, np.uint8)
    for b, o in zip(blobs, offs):
        buf[o:o + b.nbytes] = b.reshape(-1).view(np.uint8)
    dev = torch.from_numpy(buf).to(device)
    return [dev[o:o + b.nbytes].view(torch.from_numpy(b[:0]).dtype).reshape(b.shape)
            for b, o in zip(blobs, offs)]


class DeviceWorld:
    """Card mirror of the MapState tables the mapping kernels gather from."""

    def __init__(self, world: MapState, device):
        self.w = world
        self.device = dev = torch.device(device)
        MK, MP, F, MO = world.MK, world.MP, world.F, world.MO
        knn = world.kf_comp_cand.shape[2]

        def full(shape, fill, dtype):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        f32, i32 = torch.float32, torch.int32
        self.kf_feat_uv = full((MK, F, 2), 0.0, f32)
        self.kf_feat_ur = full((MK, F), -1.0, f32)
        self.kf_feat_desc = full((MK, F, 32), 0, torch.uint8)
        self.kf_feat_octave = full((MK, F), 0, i32)
        self.kf_feat_angle = full((MK, F), 0.0, f32)
        self.kf_feat_valid = full((MK, F), False, torch.bool)
        self.kf_feat_depth = full((MK, F), -1.0, f32)
        self.kf_comp_cand = full((MK, F, knn), -1, i32)
        self.pt_pos = full((MP, 3), 0.0, f32)
        self.pt_normal = full((MP, 3), 0.0, f32)
        self.pt_min_dist = full((MP,), 0.0, f32)
        self.pt_max_dist = full((MP,), 0.0, f32)
        self.pt_desc = full((MP, 32), 0, torch.uint8)
        # per-point observation tables (the BA assembly gathers the
        # window's observations on the card, mapping/ba_assemble.py)
        self.pt_obs_kf = full((MP, MO), -1, i32)
        self.pt_obs_feat = full((MP, MO), -1, i32)
        self.pt_valid = full((MP,), False, torch.bool)
        # vetted GMM component as f32 (-1 none): the chained step's input
        self.pt_comp = full((MP,), -1.0, f32)
        # raw GMM association (un-vetted; the BA structure factors use it)
        self.pt_acomp = full((MP,), -1, i32)
        self.kf_q = full((MK, 4), 0.0, f32)
        self.kf_t = full((MK, 3), 0.0, f32)
        self.track_view = (self.pt_pos, self.pt_valid, self.pt_comp, None)
        self.n_syncs = 0
        self._synced_version = -1

    def prewarm_scatters(self, kf_buckets=(1, 2, 4, 8),
                         pt_buckets=(256, 512, 1024, 2048, 4096)) -> None:
        """Run `sync`'s upload and row writes once per dirty-set bucket,
        into copies of the tables (the mirror itself is left as it is), so
        that the first sync of each size pays no first-launch or allocator
        cost inside a measured window."""
        dev = self.device

        def rows(b, table):
            return np.zeros((b,) + tuple(table.shape[1:]),
                            torch.empty(0, dtype=table.dtype).numpy().dtype)

        kf_names = ("kf_feat_uv", "kf_feat_ur", "kf_feat_desc", "kf_feat_octave",
                    "kf_feat_angle", "kf_feat_depth", "kf_comp_cand", "kf_feat_valid")
        pt_names = ("pt_pos", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_obs_kf",
                    "pt_obs_feat", "pt_comp", "pt_acomp", "pt_desc", "pt_valid")
        for names, buckets in ((kf_names, kf_buckets), (pt_names, pt_buckets)):
            for b in buckets:
                tables = [getattr(self, n) for n in names]
                up = _upload([np.zeros(b, np.int64)] + [rows(b, t) for t in tables], dev)
                for t, r in zip(tables, up[1:]):
                    t.index_copy(0, up[0], r)
        _upload([np.zeros_like(self.w.kf_q, np.float32),
                 np.zeros_like(self.w.kf_t, np.float32)], dev)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    def sync(self) -> None:
        """Bring the mirror up to date with MapState's dirty rows."""
        w = self.w
        if not w.dirty_kf and not w.dirty_pt and self._synced_version == w.map_version:
            # nothing changed since the last sync: skip the pose re-upload
            return
        self._synced_version = w.map_version
        dev = self.device
        # take the dirty sets before reading the rows they name
        dirty_kf, w.dirty_kf = w.dirty_kf, set()
        dirty_pt, w.dirty_pt = w.dirty_pt, set()
        if dirty_kf:
            ids = np.array(sorted(dirty_kf), np.int64)
            rows = _upload([ids, w.kf_feat_uv[ids], w.kf_feat_ur[ids],
                            w.kf_feat_desc[ids], w.kf_feat_octave[ids],
                            w.kf_feat_angle[ids], w.kf_feat_depth[ids],
                            w.kf_comp_cand[ids], w.kf_feat_valid[ids]], dev)
            idx = rows[0]
            for name, r in zip(("kf_feat_uv", "kf_feat_ur", "kf_feat_desc",
                                "kf_feat_octave", "kf_feat_angle", "kf_feat_depth",
                                "kf_comp_cand", "kf_feat_valid"), rows[1:]):
                getattr(self, name).index_copy_(0, idx, r)
        if dirty_pt:
            ids = np.array(sorted(dirty_pt), np.int64)
            comp = np.where(w.pt_assoc_vetted[ids], w.pt_assoc_comp[ids], -1)
            rows = _upload([ids, w.pt_pos[ids].astype(np.float32),
                            w.pt_normal[ids].astype(np.float32),
                            w.pt_min_dist[ids].astype(np.float32),
                            w.pt_max_dist[ids].astype(np.float32),
                            w.pt_obs_kf[ids], w.pt_obs_feat[ids],
                            comp.astype(np.float32), w.pt_assoc_comp[ids],
                            w.pt_desc[ids], w.pt_valid[ids]], dev)
            idx = rows[0]
            for name, r in zip(("pt_normal", "pt_min_dist", "pt_max_dist",
                                "pt_obs_kf", "pt_obs_feat", "pt_acomp", "pt_desc"),
                               (rows[2], rows[3], rows[4], rows[5], rows[6],
                                rows[8], rows[9])):
                getattr(self, name).index_copy_(0, idx, r)
            # the tables the tracker reads: fresh copies (module docstring)
            self.pt_pos = self.pt_pos.clone().index_copy_(0, idx, rows[1])
            self.pt_comp = self.pt_comp.clone().index_copy_(0, idx, rows[7])
            self.pt_valid = self.pt_valid.clone().index_copy_(0, idx, rows[10])
        self.kf_q, self.kf_t = _upload([w.kf_q.astype(np.float32),
                                        w.kf_t.astype(np.float32)], dev)
        ready = None
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        self.track_view = (self.pt_pos, self.pt_valid, self.pt_comp, ready)
        self.n_syncs += 1

    def read_for_tracking(self):
        """(pt_pos, pt_valid, pt_comp) for work enqueued next on the
        caller's current stream: that stream waits for the sync that
        published them, and the allocator keeps them for it."""
        pos, valid, comp, ready = self.track_view
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in (pos, valid, comp):
                t.record_stream(stream)
        return pos, valid, comp
