"""End-to-end synthetic run: the full system on a ground-truth trajectory
segment.

Twin of the JAX package's `tools/run_synthetic.py`: feature-level frames
(`synthetic`) along `synthetic.GT_DIR/<seq>.txt` against landmarks of
`synthetic.V1_GMM`, stepped through `GMMLocSystem` under the run-control
gate; prints progress every 20 frames, the frame rate and the ATE.

    python -m gmmloc_tpu_torch.eval.run_synthetic [n_frames] [stride] [seq] [start] [--cpu]

(start 150 skips the stationary, depth-degenerate opening of the EuRoC
V1/V2 sequences.)
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from ..config import euroc_v1_config
from ..gmm import mixture
from ..pipeline.system import GMMLocSystem
from ..utils.control import control as ctl
from . import ate, synthetic


def main(argv=None) -> dict:
    """Returns the frames completed, the seconds and the ATE record. From
    the command line (`argv` None) it installs the run-control signal
    handlers (SIGUSR1 pause, SIGUSR2 step, SIGTERM stop)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=100)
    ap.add_argument("stride", nargs="?", type=int, default=1)
    ap.add_argument("seq", nargs="?", default="V1_01_easy")
    ap.add_argument("start", nargs="?", type=int, default=150)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    if argv is None:
        from ..utils.control import install_signal_handlers

        install_signal_handlers()
    device = "cpu" if args.cpu else "cuda"
    cfg = euroc_v1_config()
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9))
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, gt_path=f"{synthetic.GT_DIR}/{args.seq}.txt", gmm_path=synthetic.V1_GMM,
        n_frames=args.start + args.n_frames, stride=args.stride, n_landmarks=30000,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1)
    start = args.start
    ts, q_wc, t_wc = ts[start:], q_wc[start:], t_wc[start:]
    gmap = mixture.load(synthetic.V1_GMM, device, pad_to=cfg.caps.gmm_components_pad,
                        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
                        neighbor_cap=cfg.gmm.neighbor_cap)
    sys_ = GMMLocSystem(cfg, gmap, device)

    t0 = time.time()
    stats = []
    for i in range(len(ts)):
        while not ctl.should_run() and not ctl.stop:
            time.sleep(0.001)
        ctl.consume_step()
        if ctl.stop:
            print(f"stop requested at frame {i}")
            break
        frame = fe.make_frame(i, ts[i], q_wc[i], t_wc[i])
        stat = sys_.step(frame, q_wc[i], t_wc[i])
        if stat is not None:  # pipelined: the stat of an earlier frame
            stats.append(stat)
        if sys_.track_failed:
            print(f"TRACKING FAILED at frame {i}")
            break
        if i % 20 == 0 and stat is not None:
            print(f"frame {i:4d} inliers={stat.num_match_inliers:4d} "
                  f"ratio={stat.ratio_map:.2f} kfs={sys_.world.n_keyframes()} "
                  f"pts={sys_.world.n_points()} t={time.time() - t0:.1f}s")
    st = sys_.flush()
    if st is not None:
        stats.append(st)
    sys_.stop()
    wall = time.time() - t0
    n_done = len(stats)
    print(f"\n{n_done} frames in {wall:.1f}s = {n_done / wall:.2f} fps")
    ts_est, _, t_est = sys_.export_trajectory()
    m = ate.ate_rmse(ts_est, t_est, ts[:n_done], t_wc[:n_done])
    print(f"ATE: rmse={m['rmse'] * 100:.2f}cm mean={m['mean'] * 100:.2f}cm n={m['n']}")
    return dict(frames=n_done, seconds=wall, ate=m)


if __name__ == "__main__":
    main()
