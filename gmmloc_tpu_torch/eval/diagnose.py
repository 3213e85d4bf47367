"""Per-frame diagnostic run: pose error against the ground truth, frame by
frame.

Twin of the JAX package's `tools/diagnose_seq.py`. Logs for every frame
the translation error (cm), the rotation error (deg), inliers, the map
ratio, keyframe and LOST events and the tracker's diagnostics
(`tracker.dbg`: motion matches, the wide retry, the keyframe fallback,
GMM-associated inliers, the motion model's prediction error, temporal and
persistent edges, coasting), written as CSV to `--out` with the JAX
tool's header and columns, for offline analysis of where a sequence
diverges. The sequence is the feature-level one of `evaluate.py`, read
through `synthetic.GT_DIR` and `synthetic.V1_GMM`/`V2_GMM`.

    python -m gmmloc_tpu_torch.eval.diagnose --seq V1_03_difficult \\
        --frames 400 --start 150 --out diag.csv [--reloc 1] [--cpu]

A row reads the system right after the frame's own step, so the tracker
runs synchronously here (`pipelined_track=False`; the config documents the
pipelined fused step as bit-identical to it). The JAX tool steps its
pipelined default and reads the `None` stat of the first dispatched
frame, so it stops at frame 1 unless its config is made synchronous.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np

from ..config import euroc_v1_config
from ..gmm import mixture
from ..mapping import map_state as ms
from ..pipeline.system import GMMLocSystem
from . import ate, synthetic

HEADER = ("frame,res,lost,terr_cm,rerr_deg,inliers,ratio_map,kfs,is_kf,ref_kf,n_motion,"
          "wide_retry,kf_fallback,n_gmm_inl,tpred_cm,rpred_deg,n_tmp,n_per,ex_cm,ey_cm,"
          "ez_cm,coasted")


def quat_angle_deg(q1, q2):
    d = abs(float(np.dot(q1, q2)))
    return float(np.degrees(2 * np.arccos(min(1.0, d))))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", default="V1_03_difficult")
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--start", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reloc", type=int, default=1)
    ap.add_argument("--out", default="diag.csv")
    ap.add_argument("--damping", type=float, default=0.9)
    ap.add_argument("--ema", type=float, default=None)
    ap.add_argument("--anchor", type=int, default=None)
    ap.add_argument("--gate", type=int, default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def make_config(args):
    cfg = euroc_v1_config()
    tk = dict(velocity_damping=args.damping, pipelined_track=False)
    if args.ema is not None:
        tk["velocity_ema"] = args.ema
    if args.anchor is not None:
        tk["use_gmm_pose_anchor"] = bool(args.anchor)
    if args.gate is not None and not args.gate:
        tk["max_jump_trans"] = 1e9
        tk["max_jump_rot_deg"] = 1e9
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, **tk),
                       enable_relocalization=bool(args.reloc))


def row(i, stat, sys_, frame, q_wc, t_wc) -> tuple:
    """The CSV row of frame i, read right after its step."""
    # GT camera pose -> T_cw
    q_gt_cw = q_wc * np.array([1.0, -1, -1, -1])
    if stat.res:
        _, t_wc_est = ms._inverse(frame.q_cw, frame.t_cw)
        terr = float(np.linalg.norm(t_wc_est - t_wc)) * 100
        rerr = quat_angle_deg(frame.q_cw, q_gt_cw)
        # error vector in the GT camera frame (x right, y down, z forward)
        ecam = ms._quat_to_mat(q_gt_cw) @ (t_wc_est - t_wc) * 100
    else:
        terr, rerr = -1.0, -1.0
        ecam = np.full(3, -1.0)
    dbg = sys_.tracker.dbg
    if "t_pred" in dbg and stat.res:
        tp_err = float(np.linalg.norm(
            ms._inverse(dbg["q_pred"], dbg["t_pred"])[1] - t_wc)) * 100
        rp_err = quat_angle_deg(dbg["q_pred"], q_gt_cw)
    else:
        tp_err, rp_err = -1.0, -1.0
    return (i, int(stat.res), int(sys_.lost), terr, rerr, stat.num_match_inliers,
            stat.ratio_map, sys_.world.n_keyframes(), int(frame.is_keyframe),
            frame.ref_kf, dbg.get("n_motion_match", -1),
            int(dbg.get("used_wide_retry", False)), int(dbg.get("used_kf_fallback", False)),
            dbg.get("n_gmm_inliers", -1), tp_err, rp_err, dbg.get("n_tmp_edges", -1),
            dbg.get("n_per_edges", -1), ecam[0], ecam[1], ecam[2],
            int(dbg.get("coasted", False)))


def main(argv=None) -> dict:
    """Runs the diagnosis and writes the CSV; returns the run's summary
    (rows, tracked rows, ATE, lost count, BA statistics)."""
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    cfg = make_config(args)
    gmm_path = synthetic.V2_GMM if args.seq.startswith("V2") else synthetic.V1_GMM
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, gt_path=f"{synthetic.GT_DIR}/{args.seq}.txt", gmm_path=gmm_path,
        n_frames=args.start + args.frames, n_landmarks=30000, seed=args.seed,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1)
    ts, q_wc, t_wc = ts[args.start:], q_wc[args.start:], t_wc[args.start:]
    gmap = mixture.load(
        gmm_path, device, pad_to=cfg.caps.gmm_components_pad,
        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
        neighbor_cap=cfg.gmm.neighbor_cap,
        degenerate_eig_thresh=cfg.gmm.degenerate_eig_thresh,
        salient_eig_thresh=cfg.gmm.salient_eig_thresh)
    vocab = None
    if args.reloc:
        # on-domain vocabulary, as in evaluate.py
        from ..vocab.bow import Vocabulary

        sub = fe.world.desc[:: max(1, len(fe.world.desc) // 20000)]
        vocab = Vocabulary.train(sub, k=10, depth=4, seed=0, device=device)
    sys_ = GMMLocSystem(cfg, gmap, device, vocabulary=vocab)

    rows = []
    t0 = time.time()
    for i in range(len(ts)):
        frame = fe.make_frame(i, ts[i], q_wc[i], t_wc[i])
        stat = sys_.step(frame, q_wc[i], t_wc[i])
        rows.append(row(i, stat, sys_, frame, q_wc[i], t_wc[i]))
        if sys_.track_failed:
            print(f"FATAL tracking failure at frame {i}")
            break
        if i % 50 == 0:
            print(f"frame {i:4d} terr={rows[-1][3]:7.2f}cm rerr={rows[-1][4]:6.2f}deg "
                  f"inl={stat.num_match_inliers:4d} lost={sys_.lost} "
                  f"kfs={sys_.world.n_keyframes()}", flush=True)
    wall = time.time() - t0
    with open(args.out, "w") as f:
        f.write(HEADER + "\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")

    sys_.stop()
    ts_est, _, t_est = sys_.export_trajectory()
    m = ate.ate_rmse(ts_est, t_est, ts, t_wc)
    done = [r for r in rows if r[1]]
    print(f"\n{len(rows)} frames ({len(done)} tracked) in {wall:.1f}s")
    print(f"ATE rmse={m['rmse'] * 100:.2f}cm mean={m['mean'] * 100:.2f}cm n={m['n']}")
    print(f"n_lost={sys_.n_lost}  csv={args.out}")
    out = dict(rows=len(rows), tracked=len(done), seconds=wall, ate=m,
               n_lost=sys_.n_lost, ba_solves=len(sys_.localizer.ba_stats))
    bs = sys_.localizer.ba_stats
    if bs:
        tiers = collections.Counter((b["L"], b["P"]) for b in bs)
        om = np.array([b["obs_mean"] for b in bs])
        op = np.array([b["obs_p95"] for b in bs])
        print(f"BA solves={len(bs)} tiers={dict(tiers)} "
              f"obs/pt mean={om.mean():.2f} p95={op.mean():.2f} "
              f"MO-hit={sum(b['obs_max_hit'] for b in bs)}")
    return out


if __name__ == "__main__":
    main()
