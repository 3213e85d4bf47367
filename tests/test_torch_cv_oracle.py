"""OpenCV-oracle gates on the port's ORB front end, on the CPU.

`tests/test_cv_oracle.py`'s three behavioural gates with the same
rendered pairs (its `stereo_world` fixture) and the same thresholds, on
the port's detector and matcher (their plain PyTorch versions here):
detector repeatability against cv2 FAST, match precision and count
against a cv2 ORB + cross-checked BFMatcher oracle with geometric ground
truth, and the separation of matched from random descriptor distances.
Skipped where cv2 is absent, as the JAX file is.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from tests.test_cv_oracle import _match_precision, stereo_world  # noqa: E402,F401

from gmmloc_tpu_torch.features import detect, matching  # noqa: E402

torch.set_num_threads(1)


def _detect(img, num_levels):
    det = detect.ORBDetector(img.shape[0], img.shape[1], num_features=800,
                             num_levels=num_levels, device="cpu")
    return det(torch.from_numpy(np.asarray(img, np.float32)))


def test_fast_detector_repeatability_vs_opencv(stereo_world):
    """Most of the port's FAST+NMS keypoints sit within 2 px of a cv2
    FAST keypoint on the same image (level 0)."""
    cfg, _, img0, *_ = stereo_world
    d = _detect(img0, 1)
    ours = d.uv.numpy()[d.valid.numpy()]
    assert len(ours) > 100

    fastd = cv2.FastFeatureDetector_create(threshold=18)
    theirs = np.array([k.pt for k in fastd.detect(img0.astype(np.uint8), None)],
                      np.float32)
    assert len(theirs) > 100, "oracle found too few corners (bad fixture)"
    dist = np.linalg.norm(ours[:, None, :] - theirs[None, :, :], axis=-1)
    near = (dist.min(axis=1) <= 2.0).mean()
    assert near > 0.7, f"only {near:.0%} of the port's keypoints near a cv2 corner"


def test_match_rate_vs_opencv_orb(stereo_world):
    """Detector + descriptor + matcher: precision within 5 points of the
    cv2 ORB oracle's, and at least half its verified match count."""
    cfg, _, img0, img1, pose0, pose1, world = stereo_world
    d0, d1 = _detect(img0, 4), _detect(img1, 4)
    m, _ = matching.mutual_best_match(d0.desc, d0.valid, d1.desc, d1.valid,
                                      max_dist=matching.TH_LOW)
    m = m.numpy()
    ours = [(i, m[i]) for i in np.where(m >= 0)[0]]
    prec_ours, n_ours = _match_precision(d0.uv.numpy(), d1.uv.numpy(), ours, None, None,
                                         world.landmarks, cfg, pose0, pose1)

    orb = cv2.ORB_create(nfeatures=800)
    k0, dd0 = orb.detectAndCompute(img0.astype(np.uint8), None)
    k1, dd1 = orb.detectAndCompute(img1.astype(np.uint8), None)
    raw = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True).match(dd0, dd1)
    raw = [r for r in raw if r.distance <= matching.TH_LOW]
    cu0 = np.array([k.pt for k in k0], np.float32)
    cu1 = np.array([k.pt for k in k1], np.float32)
    prec_cv, n_cv = _match_precision(cu0, cu1, [(r.queryIdx, r.trainIdx) for r in raw],
                                     None, None, world.landmarks, cfg, pose0, pose1)

    assert n_cv > 50, "oracle produced too few matches (bad fixture)"
    assert n_ours >= 0.5 * n_cv, f"match count {n_ours} vs oracle {n_cv}"
    assert prec_ours >= prec_cv - 0.05, f"precision {prec_ours:.2f} vs oracle {prec_cv:.2f}"


def test_descriptor_distance_separation(stereo_world):
    """Matched-pair Hamming distances separate cleanly from the
    random-pair background."""
    cfg, _, img0, img1, *_ = stereo_world
    d0, d1 = _detect(img0, 4), _detect(img1, 4)
    m, md = matching.mutual_best_match(d0.desc, d0.valid, d1.desc, d1.valid,
                                       max_dist=matching.TH_LOW)
    m = m.numpy()
    qi = np.where(m >= 0)[0]
    assert len(qi) > 80
    matched = md.numpy()[qi]

    a = d0.desc.numpy()[d0.valid.numpy()]
    b = d1.desc.numpy()[d1.valid.numpy()]
    rng = np.random.default_rng(0)
    ia = rng.integers(0, len(a), 4000)
    ib = rng.integers(0, len(b), 4000)
    pop = np.unpackbits(a[ia] ^ b[ib], axis=1).sum(1)

    assert np.median(pop) > 100, f"background median {np.median(pop)}"
    assert np.median(matched) < matching.TH_LOW, np.median(matched)
    assert np.percentile(pop, 5) > matching.TH_LOW, np.percentile(pop, 5)
