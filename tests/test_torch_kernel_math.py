"""The arithmetic identities under the CUDA kernels K3 and K4, on the CPU.

The kernels themselves run only on the card; what they rely on is held
here in plain tensor form, exactly (integer arithmetic, and float32
subtract / min / max / compare only):

  - K4's reject (`fast.arc_bounds`): no pixel whose `fast.fast_score` is
    non-zero is rejected, per polarity, on random-integer, flat,
    checkerboard, ramp, near-threshold and rendered sprite images; the
    dark term from the bright differences equals the negated form bit for
    bit, as does the arc pass over prefix and suffix extrema of the ring's
    halves; the bounds taken on the ring pixels with the centre subtracted
    once equal those of the 16 differences;
    `fast.fast_score_rejecting` (the kernel's arithmetic) equals
    `fast.fast_score` and the JAX package's `fast.nms3x3(fast.fast_score)`;
  - K3's form `popc(a) + popc(b) - 2 popc(a & b)`, and the carry-save sum
    of the sweep's ALU variant, equal `hamming_matrix_plain` and the JAX
    package's `matching._hamming_matrix_xla`;
  - the wrappers' `out=` argument on the CPU;
  - the launch counts of kernels captured into a CUDA graph.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmmloc_tpu.features import fast as jfast, matching as jm

from gmmloc_tpu_torch.eval import kernel_check, slice_run, synthetic
from gmmloc_tpu_torch.eval.image_synthetic import SpriteRenderer
from gmmloc_tpu_torch.features import cuda_kernels, fast, fast_kernels
from gmmloc_tpu_torch.utils import cuda_build

torch.set_num_threads(1)


def _sprite(h=240, w=376):
    import dataclasses

    cfg = slice_run.image_config()
    cam = dataclasses.replace(cfg.camera, width=w, height=h, fx=cfg.camera.fx / 2,
                              fy=cfg.camera.fy / 2, cx=cfg.camera.cx / 2,
                              cy=cfg.camera.cy / 2)
    cfg = dataclasses.replace(cfg, camera=cam)
    rng = np.random.default_rng(7)
    n = 1500
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(2.0, 10.0, n)], -1)
    world = synthetic.SyntheticWorld(
        landmarks=pts, desc=rng.integers(0, 256, (n, 32), dtype=np.uint8),
        base_angle=rng.uniform(0, 360, n).astype(np.float32),
        ref_dist=np.linalg.norm(pts, axis=1).astype(np.float32),
        comp_id=np.full(n, -1, np.int32),
        response=rng.uniform(20, 80, n).astype(np.float32))
    left, _ = SpriteRenderer(world, cfg, seed=1).render_stereo(
        np.array([1.0, 0, 0, 0]), np.zeros(3))
    return np.clip(np.round(left), 0, 255).astype(np.float32)


def _image(kind):
    rng = np.random.default_rng(11)
    h, w = 96, 130
    ys, xs = np.mgrid[0:h, 0:w]
    if kind == "random":
        return rng.integers(0, 256, (h, w)).astype(np.float32)
    if kind == "flat":
        return np.full((h, w), 93.0, np.float32)
    if kind == "checkerboard":
        return (255.0 * ((ys + xs) % 2)).astype(np.float32)
    if kind == "blocks":
        return (200.0 * (((ys // 5) + (xs // 7)) % 2) + 20).astype(np.float32)
    if kind == "ramp":
        return kernel_check.dense_image(h, w, "cpu").numpy()
    if kind == "near_threshold":
        # differences of exactly 7 and 8 around the threshold, with noise
        # of one grey level
        base = 100.0 + 7.0 * ((ys // 3 + xs // 3) % 2) + (rng.random((h, w)) < 0.3)
        return base.astype(np.float32)
    if kind == "fractional":
        return rng.uniform(0, 255, (h, w)).astype(np.float32)
    if kind == "sprite":
        return _sprite()
    raise ValueError(kind)


IMAGES = ["random", "flat", "checkerboard", "blocks", "ramp", "near_threshold",
          "fractional", "sprite"]


@pytest.mark.parametrize("kind", IMAGES)
def test_fast_reject_keeps_every_scoring_pixel(kind):
    img = torch.from_numpy(_image(kind))
    d = fast._ring_diffs(img)
    u, l = fast.arc_bounds(d)
    mb = fast._window_max_min9(d)
    md = fast._window_max_min9([-x for x in d])
    # the bounds themselves, everywhere (wrapped pixels included)
    assert bool((mb <= u).all()) and bool((md <= -l).all())
    score, bright, dark = fast.fast_score_rejecting(img)
    ref = fast.fast_score(img)
    inside = fast._inside_border(img)
    assert not bool((inside & (mb > fast.FAST_TH_LOW) & ~bright).any())
    assert not bool((inside & (md > fast.FAST_TH_LOW) & ~dark).any())
    assert not bool(((ref != 0) & ~(bright | dark)).any())
    assert torch.equal(score, ref)
    # the kernel tests the ring pixels and subtracts the centre once:
    # rounding is monotone, so the bounds are the same bit for bit
    ring = [fast._shift2d(img, dy, dx) for dy, dx in fast.RING]
    u_raw, l_raw = fast.arc_bounds(ring)
    assert torch.equal(u_raw - img, u) and torch.equal(l_raw - img, l)
    if kind == "flat":
        assert int((bright | dark).sum()) == 0
    if kind == "ramp":   # the densest case: both polarities everywhere, no score
        assert torch.equal(bright & dark, inside) and int((ref != 0).sum()) == 0
    if kind in ("random", "sprite", "blocks"):
        assert int((ref > 0).sum()) > 20


@pytest.mark.parametrize("kind", ["random", "near_threshold", "fractional", "sprite"])
def test_fast_dark_from_bright_differences_bit_equal(kind):
    img = torch.from_numpy(_image(kind))
    d = fast._ring_diffs(img)
    a = fast._window_max_min9([-x for x in d])
    b = -fast._window_best9_halves(d, bright=False)
    assert torch.equal(a, b)
    assert torch.equal(fast._window_max_min9(d), fast._window_best9_halves(d, bright=True))
    assert np.array_equal(a.numpy().view(np.uint32)[a.numpy() != 0],
                          b.numpy().view(np.uint32)[b.numpy() != 0])


@pytest.mark.parametrize("kind", ["random", "ramp", "sprite"])
def test_fast_rejecting_form_matches_reference(kind):
    img = _image(kind)
    ref = np.asarray(jfast.nms3x3(jfast.fast_score(jnp.asarray(img))))
    score, _, _ = fast.fast_score_rejecting(torch.from_numpy(img))
    np.testing.assert_array_equal(fast.nms3x3(score).numpy(), ref)
    np.testing.assert_array_equal(
        fast_kernels.fast_score_nms(torch.from_numpy(img)).numpy(), ref)


def _descriptors(seed, n, m):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    # a few extreme rows: all zeros, all ones, copies
    a[0] = 0
    b[0] = 255
    if n > 2 and m > 2:
        a[1] = 255
        a[2] = b[2]
    return a, b


def _hamming_carry_save(desc_a, desc_b):
    """The carry-save form of `tools/hamming_variants.cu` (variant 3): the
    8 XOR words through 7 bitwise adders into ones, twos, fours and
    eights, then 4 popcounts."""
    a, b = cuda_kernels._words(desc_a), cuda_kernels._words(desc_b)
    x = [a[:, None, w] ^ b[None, :, w] for w in range(8)]

    def csa(p, q, r):
        u = p ^ q
        return (p & q) | (u & r), u ^ r

    c0, s0 = csa(x[0], x[1], x[2])
    c1, s1 = csa(x[3], x[4], x[5])
    c2, s2 = csa(s0, s1, x[6])
    ones, c3 = s2 ^ x[7], s2 & x[7]
    f0, t0 = csa(c0, c1, c2)
    twos, f1 = t0 ^ c3, t0 & c3
    fours, eights = f0 ^ f1, f0 & f1
    popc = cuda_kernels._popc32
    return popc(ones) + 2 * popc(twos) + 4 * popc(fours) + 8 * popc(eights)


@pytest.mark.parametrize("form", ["and_popc", "carry_save"])
@pytest.mark.parametrize("shape", [(1, 65), (37, 100), (200, 131)])
def test_hamming_forms_equal_plain_and_reference(form, shape):
    a, b = _descriptors(sum(shape), *shape)
    fn = dict(and_popc=cuda_kernels.hamming_matrix_and_popc,
              carry_save=_hamming_carry_save)[form]
    out = fn(torch.tensor(a), torch.tensor(b))
    plain = cuda_kernels.hamming_matrix_plain(torch.tensor(a), torch.tensor(b))
    ref = np.asarray(jm._hamming_matrix_xla(jnp.asarray(a), jnp.asarray(b)))
    assert out.dtype == torch.int32 and tuple(out.shape) == shape
    assert torch.equal(out, plain)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert int(out[0, 0]) == 256


def test_kernel_tile_column_order_is_a_permutation():
    """The shared-memory row order of K3's B tile (`permuted` in
    `csrc/hamming.cu`): within 16 columns, column 4q + 2t + i sits at row
    8t + 2q + i, so the thread that holds tile columns 2q, 2q+1 of the two
    mma tiles owns output columns 4q .. 4q+3."""
    perm = [(l & ~15) | ((l & 2) << 2) | ((l >> 1) & 6) | (l & 1) for l in range(64)]
    assert sorted(perm) == list(range(64))
    for l in range(64):
        q, t, i = (l >> 2) & 3, (l >> 1) & 1, l & 1
        assert perm[l] == (l & ~15) + 8 * t + 2 * q + i


def test_wrappers_out_argument_on_cpu():
    a, b = _descriptors(3, 9, 12)
    ta, tb = torch.tensor(a), torch.tensor(b)
    out = torch.empty(9, 12, dtype=torch.int32)
    assert cuda_kernels.hamming_matrix(ta, tb, out=out) is out
    assert torch.equal(out, cuda_kernels.hamming_matrix_plain(ta, tb))
    with pytest.raises(ValueError):
        cuda_kernels.hamming_matrix(ta.to(torch.int32), tb)
    for bad in (torch.empty(9, 12, dtype=torch.int64), torch.empty(12, 9, dtype=torch.int32),
                torch.empty(9, 24, dtype=torch.int32)[:, ::2]):
        with pytest.raises(ValueError):
            cuda_kernels.hamming_matrix(ta, tb, out=bad)

    img = torch.from_numpy(_image("random"))
    res = torch.empty_like(img)
    assert fast_kernels.fast_score_nms(img, out=res) is res
    assert torch.equal(res, fast_kernels.fast_score_nms_plain(img))
    for bad in (torch.empty(96, 130, dtype=torch.float64), torch.empty(130, 96),
                torch.empty(96, 260)[:, ::2], img):
        with pytest.raises(ValueError):
            fast_kernels.fast_score_nms(img, out=bad)


def test_captured_launches_count_at_each_replay():
    """A launch this thread makes inside `cuda_build.captured_launches`
    (a CUDA graph's capture) goes to the capture's tally, with its shape
    kept, not to the wrapper's count; another thread's launch meanwhile
    counts as usual; each replay counts the tally once."""
    def wrapper():
        pass

    wrapper.launches, wrapper.shapes = 0, set()
    with cuda_build.captured_launches() as tally:
        cuda_build.count_launch(wrapper, (3, 4))
        other = threading.Thread(target=cuda_build.count_launch, args=(wrapper,))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    assert wrapper.launches == 1 and tally == {wrapper: 1} and wrapper.shapes == {(3, 4)}
    for _ in range(3):
        for w, n in tally.items():
            cuda_build.count_launch(w, times=n)
    cuda_build.count_launch(wrapper)
    assert wrapper.launches == 5


def test_gc_paused_nests_across_threads():
    """`device.gc_paused` (around a CUDA graph's capture) holds the cyclic
    collector off until the last of overlapping blocks ends, in whatever
    thread, and leaves it off where it was off before."""
    import gc

    from gmmloc_tpu_torch.utils.device import gc_paused

    assert gc.isenabled()
    inner_started, outer_done = threading.Event(), threading.Event()
    seen = []

    def other():
        with gc_paused():
            inner_started.set()
            outer_done.wait(timeout=10)
            seen.append(gc.isenabled())

    with gc_paused():
        th = threading.Thread(target=other)
        th.start()
        inner_started.wait(timeout=10)
    seen.append(gc.isenabled())          # the other thread's block is open
    outer_done.set()
    th.join(timeout=10)
    assert seen == [False, False] and gc.isenabled()
    gc.disable()
    try:
        with gc_paused():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_kernel_bounds_count_the_functions_work():
    """The bounds of `eval/kernel_check.py` at the main path's shapes:
    K3 is bound by its bytes; K4's operation count grows with the
    survivors of the exact reject, counts the other six pairs only where
    the first two let a pixel through, and is never the old dense figure."""
    b3 = kernel_check.hamming_bound(4096, 1280)
    assert b3["bound_by"] == "bytes"
    assert abs(b3["bound_ms"] - (4096 * 1280 * 4 + (4096 + 1280) * 32) / 3.35e12 * 1e3) < 1e-9
    assert b3["alu_popc_ms"]["popc8"] == 2 * b3["alu_popc_ms"]["popc4"] > b3["bound_ms"]
    flat = kernel_check.fast_bound(torch.from_numpy(_image("flat")))
    ramp = kernel_check.fast_bound(torch.from_numpy(_image("ramp")))
    assert flat["survivor_share"] == 0.0 and ramp["survivor_share"] > 0.85
    assert ramp["arc_passes_per_pixel"] == 2 * ramp["survivor_share"]
    assert flat["first_pairs_share"] == 0.0
    assert ramp["first_pairs_share"] == ramp["survivor_share"]
    n_px = 96 * 130
    assert flat["ops"] == dict(fadd=2 * n_px, fminmax=8 * n_px)
    assert ramp["ops"]["fminmax"] == round(
        (8 + (24 + 2 * 58) * ramp["survivor_share"]) * n_px)
    assert flat["bound_by"] == "bytes" and flat["bound_ms"] < ramp["bound_ms"]
    assert ramp["bound_by"] == "operations"
    assert flat["dense_ops_ms"] == ramp["dense_ops_ms"]
