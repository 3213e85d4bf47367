"""Export the interactive HTML map viewer from a checkpoint.

Twin of the JAX package's `tools/view_map.py`: loads a checkpoint
(`pipeline/checkpoint.py`) into a `MapState` of `euroc_v1_config()`'s
capacities and writes the self-contained HTML viewer
(`pipeline/html_viewer.py`), optionally with the prior map's ellipsoids.
A host tool: numpy only, no device.

    python -m gmmloc_tpu_torch.eval.view_map CKPT.npz [--gmm v1|v2|PATH.gmm]
        [--out map.html]
"""

from __future__ import annotations

import argparse
import os

from ..config import euroc_v1_config
from ..mapping.map_state import MapState
from ..pipeline import checkpoint, html_viewer
from ..utils import proto
from . import synthetic


def main(argv=None) -> str:
    """Writes the viewer; returns its path."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt")
    ap.add_argument("--gmm", default=None, help="v1 | v2 | path to a .gmm proto stream")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    world = MapState(euroc_v1_config())
    checkpoint.load_checkpoint(args.ckpt, world)
    gmm = None
    if args.gmm:
        path = {"v1": synthetic.V1_GMM, "v2": synthetic.V2_GMM}.get(args.gmm, args.gmm)
        means, covs, _, _ = proto.load_gmm_file(path)
        gmm = {"means": means, "covs": covs}
    out = args.out or os.path.splitext(args.ckpt)[0] + ".html"
    html_viewer.export_html(world, out, gmm=gmm)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
