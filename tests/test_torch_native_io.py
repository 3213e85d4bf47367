"""The port's native IO (`gmmloc_tpu_torch/utils/native.py`) on the CPU.

The six cases of `tests/test_native_io.py` on the port's PNG decoder and
prefetch ring, which the port builds from
`gmmloc_tpu_torch/native/png_ring.cpp` into `build/` (the JAX package
loads the committed libpng-based `native/libgmmloc_io.so`): the decode
equals PIL and the JAX package's native decode, RGB converts to gray
bit-equal to the JAX decode (8 and 16 bits, with and without alpha), the
ring serves pairs in order and complete under slot contention, a missing
file raises, and the loader reads a 3-frame ASL tree. Then every row
filter the harness's PNG writer (`eval/disk_run.py`) emits decodes equal
to PIL, the formats the decoder refuses raise, and the native `.gmm`
parser equals the port's Python one on the room fixture.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from gmmloc_tpu.utils import native as jax_native

from gmmloc_tpu_torch.eval import disk_run, room_fixture
from gmmloc_tpu_torch.pipeline.dataloader import EuRoCDataloader
from gmmloc_tpu_torch.utils import native, proto


def _write_pngs(tmp_path, n=6, w=64, h=48, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        p = str(tmp_path / f"im{i}.png")
        Image.fromarray(img, mode="L").save(p)
        paths.append((p, img))
    return paths


def test_decode_matches_pil(tmp_path):
    for p, img in _write_pngs(tmp_path, n=3):
        dec = native.decode_png_gray(p)
        np.testing.assert_array_equal(dec, img)
        np.testing.assert_array_equal(dec, jax_native.decode_png_gray(p))
    assert native.library_path("png_ring").startswith(native.BUILD_DIR)


def _png(img, color, depth, chunks=(), interlace=0):
    """A PNG of (H, W, C) samples (uint8 or, at 16 bits, uint16) with the
    harness's cycled row filters and extra (type, data) chunks."""
    h, w = img.shape[:2]
    raw = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    bpp = raw.shape[1] // w
    chunk = lambda t, d: (struct.pack(">I", len(d)) + t + d
                          + struct.pack(">I", zlib.crc32(t + d)))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                                color, 0, 0, interlace))
    for t, d in chunks:
        out += chunk(t, d)
    idat = zlib.compress(disk_run.filter_rows(raw, bpp).tobytes())
    return out + chunk(b"IDAT", idat) + chunk(b"IEND", b"")


@pytest.mark.parametrize("color,depth", [(0, 8), (0, 16), (4, 8), (4, 16), (2, 8),
                                         (6, 8), (2, 16), (6, 16)])
def test_decode_formats_equal_jax_decode(tmp_path, color, depth):
    """Every format the decoder takes gives the JAX package's libpng
    decode bit for bit, with all five row filters at 1-8 bytes per
    pixel."""
    rng = np.random.default_rng(color * 100 + depth)
    ch = {0: 1, 4: 2, 2: 3, 6: 4}[color]
    img = rng.integers(0, 1 << depth, (23, 19, ch), dtype=np.int64)
    img[3, :, :] = img[3, :, :1]               # gray pixels inside a colour image
    p = tmp_path / "f.png"
    p.write_bytes(_png(img, color, depth))
    ref = jax_native.decode_png_gray(str(p))
    assert ref is not None and ref.shape == (23, 19)
    np.testing.assert_array_equal(native.decode_png_gray(str(p)), ref)


@pytest.mark.parametrize("case", ["palette", "gray4", "interlaced", "rgb_gamma",
                                  "crc", "truncated", "not_png"])
def test_decode_refuses(tmp_path, case):
    """Formats whose libpng conversion the decoder does not reproduce, and
    corrupt files, raise instead of decoding to other pixels."""
    img = np.zeros((4, 5, 3), np.int64)
    data = {"palette": lambda: _png(img[..., :1], 3, 8),
            "gray4": lambda: _png(img[..., :1], 0, 4),
            "interlaced": lambda: _png(img[..., :1], 0, 8, interlace=1),
            "rgb_gamma": lambda: _png(img, 2, 8, chunks=[(b"gAMA", struct.pack(">I", 45455))]),
            "crc": lambda: _png(img, 2, 8)[:-16] + bytes(4) + _png(img, 2, 8)[-12:],
            "truncated": lambda: _png(img, 2, 8)[:40],
            "not_png": lambda: b"GIF89a" + bytes(40)}[case]()
    p = tmp_path / "bad.png"
    p.write_bytes(data)
    with pytest.raises(IOError):
        native.decode_png_gray(str(p))
    # gray images with colour-space chunks decode (no conversion applies)
    p.write_bytes(_png(img[..., :1], 0, 8, chunks=[(b"gAMA", struct.pack(">I", 45455))]))
    np.testing.assert_array_equal(native.decode_png_gray(str(p)), 0)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "LA"])
def test_decode_rgb_converts_to_gray(tmp_path, mode):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (16, 24, len(mode)), dtype=np.uint8)
    p = str(tmp_path / f"{mode}.png")
    Image.fromarray(img, mode=mode).save(p)
    dec = native.decode_png_gray(p)
    assert dec.shape == (16, 24)
    np.testing.assert_array_equal(dec, jax_native.decode_png_gray(p))
    if mode != "LA":
        # BT.709 luma within rounding of libpng's fixed-point conversion
        luma = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
        assert np.abs(dec.astype(np.float64) - luma).max() <= 2.0


def test_prefetcher_in_order_and_complete(tmp_path):
    pairs = _write_pngs(tmp_path, n=10)
    paths = [p for p, _ in pairs]
    imgs = [im for _, im in pairs]
    with native.NativePrefetcher(paths, list(reversed(paths)), capacity=3,
                                 n_threads=2) as pf:
        for i in range(10):
            got = pf.take()
            np.testing.assert_array_equal(got[0], imgs[i])
            np.testing.assert_array_equal(got[1], imgs[9 - i])
        assert pf.take() is None


def test_prefetcher_slot_contention_stress(tmp_path):
    # capacity 2 with 4 workers maximises same-slot contention; the ring
    # must serve frames in strict order with uncorrupted buffers
    pairs = _write_pngs(tmp_path, n=64, w=32, h=24, seed=3)
    paths = [p for p, _ in pairs]
    imgs = [im for _, im in pairs]
    with native.NativePrefetcher(paths, paths, capacity=2, n_threads=4,
                                 max_pixels=32 * 24) as pf:
        for i in range(64):
            got = pf.take()
            np.testing.assert_array_equal(got[0], imgs[i])
            np.testing.assert_array_equal(got[1], imgs[i])
        assert pf.take() is None


def test_missing_file_raises(tmp_path):
    pairs = _write_pngs(tmp_path, n=2)
    paths = [p for p, _ in pairs]
    bad = [paths[0], str(tmp_path / "nope.png")]
    with native.NativePrefetcher(bad, bad, capacity=2, n_threads=1) as pf:
        pf.take()                              # the first pair decodes fine
        with pytest.raises(IOError):
            pf.take()
    with pytest.raises(IOError):
        native.decode_png_gray(bad[1])


def test_dataloader_uses_native_decode(tmp_path):
    # EuRoC ASL layout: cam0/cam1 with a 3-frame index
    for cam in ("cam0", "cam1"):
        os.makedirs(tmp_path / "mav0" / cam / "data", exist_ok=True)
    rng = np.random.default_rng(2)
    rows, frames = [], []
    for i in range(3):
        img = rng.integers(0, 256, (20, 24), dtype=np.uint8)
        name = f"{1000 + i}.png"
        for cam in ("cam0", "cam1"):
            Image.fromarray(img, mode="L").save(str(tmp_path / "mav0" / cam / "data" / name))
        rows.append(f"{(1000 + i) * 1000000},{name}")
        frames.append(img)
    with open(tmp_path / "mav0" / "cam0" / "data.csv", "w") as f:
        f.write("#ts,fname\n" + "\n".join(rows) + "\n")

    dl = EuRoCDataloader(str(tmp_path))
    out = list(dl)
    assert len(out) == 3
    for i, fr in enumerate(out):
        assert fr.left.dtype == np.float32 and fr.timestamp == (1000 + i) * 1e-3
        np.testing.assert_array_equal(fr.left.astype(np.uint8), frames[i])
        np.testing.assert_array_equal(fr.right.astype(np.uint8), frames[i])
    np.testing.assert_array_equal(dl.get_frame(1).left, out[1].left)
    assert [i for i, *_ in dl.pairs(2)] == [0, 1]


def test_writer_filters_decode_equal_to_pil(tmp_path):
    """Each PNG row filter the harness writes (None, Sub, Up, Average,
    Paeth, cycled by row) decodes to the written pixels, through PIL and
    through the port's decoder."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (23, 37), dtype=np.uint8)
    img[5:9] = 255                              # saturated rows (wrap-around)
    rows = disk_run.filter_rows(img)
    assert sorted(set(rows[:, 0].tolist())) == [0, 1, 2, 3, 4]
    png = disk_run.encode_png_gray(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), img)
    p = tmp_path / "f.png"
    p.write_bytes(png)
    np.testing.assert_array_equal(native.decode_png_gray(str(p)), img)


def test_gmm_parse_equals_python_parser(tmp_path):
    gmm_path, _ = room_fixture.write_room_fixture(str(tmp_path), n_components=400,
                                                  n_frames=10, seed=0)
    for a, b in zip(native.load_gmm_file(gmm_path), proto.load_gmm_file(gmm_path)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    out = str(tmp_path / "again.gmm")
    native.save_gmm_file(out, *proto.load_gmm_file(gmm_path))
    assert open(out, "rb").read() == open(gmm_path, "rb").read()
