"""ctypes bindings for the port's native host libraries.

Two libraries, each compiled with g++ at first use from a source in the
repository, never loaded from a prebuilt object (the committed
`native/*.so` are not used):

  - `gmmloc_native`, from the repository's `native/gmmloc_native.cpp`
    (shared with the JAX package's bindings): the `.gmm` protobuf stream
    parser and writer (`gmm_parse`, `gmm_serialize`; ref
    protobuf_utils.cpp, gmm_utils.cpp loadGMMModel);
  - `png_ring`, from the port's `gmmloc_tpu_torch/native/png_ring.cpp`:
    the PNG grayscale decoder (zlib inflate, un-filtering, libpng's gray
    conversion) and the threaded stereo prefetch ring of
    `native/euroc_loader.cpp` (ref dataloader.cpp:53-116,
    gmmloc.cpp:241-249). The JAX package decodes through libpng, whose
    headers the machines with the card do not have; this decoder needs
    only zlib and is the one the port uses on every machine.

    g++ -O3 -fPIC -shared -std=c++17 <src>.cpp -o
        build/gmmloc_tpu_torch/native/lib<name>_<hash>.so [-lz -lpthread]

The library name carries a hash of the source and the flags, so an edited
source rebuilds. A build writes a name of its own and renames it into
place, so processes that build at once (test workers) never load a
half-written file. A failed build raises with g++'s output: there is no
fallback to another parser or decoder. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(ROOT, "build", "gmmloc_tpu_torch", "native")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
# name -> (source, link flags)
LIBS = {
    "gmmloc_native": (os.path.join(ROOT, "native", "gmmloc_native.cpp"), []),
    "png_ring": (os.path.join(PKG_DIR, "native", "png_ring.cpp"), ["-lz", "-lpthread"]),
}

# the largest image a decode takes (pixels), as the JAX package's bindings
MAX_PIXELS = 4096 * 3072

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIZE = ctypes.c_size_t
_I = ctypes.c_int
SIGNATURES = {
    "gmmloc_native": {
        "gmm_parse": ([_P, _SIZE, _P, _P, _P, _P, _I64], _I64),
        "gmm_serialize": ([_P, _P, _P, _P, _I64, _P, _SIZE], _I64),
    },
    "png_ring": {
        "gmmloc_png_decode_gray": ([ctypes.c_char_p, _P, _I64, _P, _P], _I),
        "gmmloc_png_ring_create": ([ctypes.c_char_p, ctypes.c_char_p, _I64, _I, _I], _P),
        "gmmloc_png_ring_take": ([_P, _P, _P, _P], _I),
        "gmmloc_png_ring_destroy": ([_P], None),
        "gmmloc_png_zlib_version": ([], ctypes.c_char_p),
    },
}

_lock = threading.Lock()
_libs: dict = {}


def library_path(name: str) -> str:
    src, libs = LIBS[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS + libs).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile library `name`'s source if no library for the current
    source exists. Returns the library path; raises with g++'s output on
    failure."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    src, libs = LIBS[name]
    res = subprocess.run(["g++", *CXX_FLAGS, src, "-o", tmp, *libs],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed to build {src} ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The library `name` ("gmmloc_native" or "png_ring"), built on first
    use, with its C functions declared."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build(name))
            for fn, (args, res) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _libs[name] = lib
        return _libs[name]


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# ---------------------------------------------------------------------------
# .gmm stream


def load_gmm_file(path: str):
    """Parse a `.gmm` stream -> (means (K,3), covs (K,3,3), deg (K,),
    sal (K,)), as `proto.load_gmm_file` returns them."""
    from .proto import read_varint

    lib = load("gmmloc_native")
    with open(path, "rb") as f:
        buf = np.frombuffer(f.read(), np.uint8)
    k = read_varint(buf.tobytes()[:10], 0)[0] if len(buf) else 0
    means = np.zeros((k, 3), np.float64)
    covs = np.zeros((k, 9), np.float64)
    deg = np.zeros(k, np.uint8)
    sal = np.zeros(k, np.uint8)
    n = lib.gmm_parse(_ptr(buf), len(buf), _ptr(means), _ptr(covs), _ptr(deg),
                      _ptr(sal), k)
    if n != k:
        raise ValueError(f"malformed .gmm stream: {path}")
    return means, covs.reshape(k, 3, 3), deg.astype(bool), sal.astype(bool)


def save_gmm_file(path: str, means, covs, deg=None, sal=None) -> None:
    """Write a `.gmm` stream (the format `load_gmm_file` reads)."""
    lib = load("gmmloc_native")
    means = np.ascontiguousarray(means, np.float64).reshape(-1, 3)
    k = len(means)
    covs = np.ascontiguousarray(covs, np.float64).reshape(k, 9)
    deg = np.zeros(k, np.uint8) if deg is None else np.ascontiguousarray(deg, np.uint8)
    sal = np.zeros(k, np.uint8) if sal is None else np.ascontiguousarray(sal, np.uint8)
    cap = 16 + k * 128
    out = np.zeros(cap, np.uint8)
    n = lib.gmm_serialize(_ptr(means), _ptr(covs), _ptr(deg), _ptr(sal), k,
                          _ptr(out), cap)
    if n < 0:
        raise RuntimeError("gmm_serialize: output buffer too small")
    with open(path, "wb") as f:
        f.write(out[:n].tobytes())


# ---------------------------------------------------------------------------
# PNG decode and the prefetch ring


def decoder_name() -> str:
    """What decodes the PNGs: the port's decoder and the zlib it runs."""
    return f"the port's PNG decoder (zlib {load('png_ring').gmmloc_png_zlib_version().decode()})"


def decode_png_gray(path: str, max_pixels: int = MAX_PIXELS) -> np.ndarray:
    """Decode a PNG to (H, W) uint8 (8- or 16-bit gray, gray+alpha, RGB
    or RGBA; RGB converts to gray as the JAX package's libpng decode
    does). Raises IOError if the file is missing, corrupt or of a format
    the decoder refuses (palette, gray below 8 bits, interlaced, colour
    with colour-space chunks)."""
    lib = load("png_ring")
    buf = np.empty(max_pixels, np.uint8)
    w, h = np.zeros(1, np.int32), np.zeros(1, np.int32)
    rc = lib.gmmloc_png_decode_gray(os.fsencode(path), _ptr(buf), max_pixels,
                                    _ptr(w), _ptr(h))
    if rc != 0:
        raise IOError(f"PNG decode failed (rc={rc}): {path}")
    return buf[: int(w[0]) * int(h[0])].reshape(int(h[0]), int(w[0])).copy()


class NativePrefetcher:
    """In-order stereo-pair prefetcher over the C++ decode ring: worker
    threads decode ahead into `capacity` slots; `take` blocks (with the
    interpreter lock released) until the next pair is ready."""

    def __init__(self, files_left, files_right, capacity: int = 8,
                 n_threads: int = 2, max_pixels: int = MAX_PIXELS):
        if len(files_left) != len(files_right) or not files_left:
            raise ValueError("the prefetcher takes two equal, non-empty file lists")
        self._lib = load("png_ring")
        self._max_pixels = max_pixels
        self._handle = self._lib.gmmloc_png_ring_create(
            "\n".join(files_left).encode(), "\n".join(files_right).encode(),
            max_pixels, capacity, n_threads)
        if not self._handle:
            raise RuntimeError("native prefetcher creation failed")
        self._l = np.empty(max_pixels, np.uint8)
        self._r = np.empty(max_pixels, np.uint8)
        self._whwh = np.zeros(4, np.int32)

    def take(self):
        """The next (left, right) uint8 pair in order; None when exhausted.
        Raises IOError if either image of the pair failed to decode."""
        if not self._handle:
            raise RuntimeError("the prefetcher is closed")
        rc = self._lib.gmmloc_png_ring_take(self._handle, _ptr(self._l), _ptr(self._r),
                                             _ptr(self._whwh))
        if rc == -1:
            return None
        if rc != 0:
            raise IOError(f"native decode failed (rc={rc})")
        wl, hl, wr, hr = (int(x) for x in self._whwh)
        return (self._l[: wl * hl].reshape(hl, wl).copy(),
                self._r[: wr * hr].reshape(hr, wr).copy())

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.gmmloc_png_ring_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
