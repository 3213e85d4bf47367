"""Image-path smoke: sprite-rendered stereo -> the ORB front end -> the
system.

Twin of the JAX package's `tools/run_image_pipeline.py`: renders a
9000-landmark sprite world sampled from `synthetic.V1_GMM` along
`synthetic.GT_DIR/V1_01_easy.txt`, runs each pair through the front end's
one-pass `process_packed` and steps the system, printing per frame the
features, stereo matches, inliers, keyframes and points, then the max
camera-centre error.

    python -m gmmloc_tpu_torch.eval.run_image_pipeline [n_frames] [start] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from ..config import euroc_v1_config
from ..gmm import mixture
from ..mapping.map_state import _inverse
from ..pipeline.frontend import ImageFrontend
from ..pipeline.system import GMMLocSystem
from ..utils import proto
from . import synthetic
from .image_synthetic import SpriteRenderer


def main(argv=None) -> dict:
    """Returns the frames run, their camera-centre errors (m) and whether
    tracking failed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=30)
    ap.add_argument("start", nargs="?", type=int, default=150)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    cfg = euroc_v1_config()
    cfg = cfg.replace(
        camera=dataclasses.replace(cfg.camera, do_rectify=False, do_equalization=False),
        tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9))
    ts, q_wc, t_wc = synthetic.load_gt_trajectory(f"{synthetic.GT_DIR}/V1_01_easy.txt")
    means, covs, _, _ = proto.load_gmm_file(synthetic.V1_GMM)
    world = synthetic.sample_world_from_gmm(means, covs, n_landmarks=9000)
    renderer = SpriteRenderer(world, cfg)
    frontend = ImageFrontend(cfg, device=device)
    gmap = mixture.load(synthetic.V1_GMM, device, pad_to=cfg.caps.gmm_components_pad,
                        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
                        neighbor_cap=cfg.gmm.neighbor_cap)
    sys_ = GMMLocSystem(cfg, gmap, device)

    t0 = time.time()
    frames = []
    failed = False
    for i in range(args.n_frames):
        fi = args.start + i
        left, right = renderer.render_stereo(q_wc[fi], t_wc[fi])
        left = np.clip(np.round(left), 0, 255).astype(np.uint8)
        right = np.clip(np.round(right), 0, 255).astype(np.uint8)
        frame = frontend.process_packed(i, ts[fi], left, right)
        n_depth = int((frame.depth > 0).sum())
        # pipelined: the stat of the previous frame (None while the first
        # is in flight); final poses land at drain time
        st = sys_.step(frame, q_wc[fi], t_wc[fi])
        frames.append((fi, frame))
        print(f"f{i}: feats={frame.num_features()} stereo={n_depth} "
              f"inl={st.num_match_inliers if st is not None else '-'} "
              f"kfs={sys_.world.n_keyframes()} pts={sys_.world.n_points()}", flush=True)
        if sys_.track_failed or (st is not None and not st.res):
            print("TRACKING FAILED")
            failed = True
            break
    sys_.flush()
    sys_.stop()
    errs = np.array([np.linalg.norm(_inverse(f.q_cw, f.t_cw)[1] - t_wc[fi])
                     for fi, f in frames])
    wall = time.time() - t0
    print(f"\n{len(errs)} frames in {wall:.0f}s; max err {errs.max() * 1000:.1f}mm")
    return dict(frames=len(errs), errors_m=errs, failed=failed, seconds=wall)


if __name__ == "__main__":
    main()
