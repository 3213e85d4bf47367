"""Build and load the port's CUDA kernels (`gmmloc_tpu_torch/csrc/*.cu`).

Each source compiles with its own nvcc process, all started together,
and the objects link into one shared library with a plain C interface,
loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c gmmloc_tpu_torch/csrc/<name>.cu -o <name>.o
    nvcc -shared -o build/gmmloc_tpu_torch/libgmmloc_kernels_<hash>.so *.o

The build runs at first use, takes seconds, and is cached by a hash of the
sources and flags, so an edited source rebuilds. Nothing here runs at
import time.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "gmmloc_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "gmmloc_hamming": [_P, _P, _I, _I, _P, _P],
    "gmmloc_fast_nms": [_P, _I, _I, _P, _P],
    "gmmloc_pose_solve": (
        [_P] * 13 + [_F, _I, _I, _I, _I, _F] + [_F] * 5 + [_P] * 6
    ),
    "gmmloc_pose_max_features": [],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libgmmloc_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if no library for the current sources exists.
    Returns the library path; raises with nvcc's output on failure."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fails = []
    for src, p in zip(sources(), procs):
        log = p.communicate()[0]
        if p.returncode != 0:
            fails.append(f"{os.path.basename(src)} ({p.returncode}):\n{log}")
    if not fails:
        res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            fails.append(f"link ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    build_seconds = time.perf_counter() - t0
    if fails:
        raise RuntimeError("nvcc failed: " + "\n".join(fails))
    os.replace(tmp, out)
    return out


def bind(path: str, names=tuple(SIGNATURES)) -> ctypes.CDLL:
    """Load a kernel library and declare its C functions `names`."""
    lib = ctypes.CDLL(path)
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t from a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


_count_lock = threading.Lock()
_tallies = {}      # thread id -> its capture's launches, while it captures


def count_launch(wrapper, shape=None, times: int = 1) -> None:
    """Add `times` to `wrapper.launches` and, where given, the launch's
    shape to the set `wrapper.shapes` (the tracker and the mapper thread
    launch the same kernels, so the update takes a lock). A launch this
    thread makes inside `captured_launches` goes into a CUDA graph and
    runs only when the graph replays, so it goes to that block's tally
    instead, which the replays count."""
    with _count_lock:
        if shape is not None:
            wrapper.shapes.add(shape)
        tally = _tallies.get(threading.get_ident()) if _tallies else None
        if tally is None:
            wrapper.launches += times
        else:
            tally[wrapper] += times


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph's capture on this thread: yields a Counter of
    the kernel launches captured (wrapper -> launches), to be counted with
    `count_launch(wrapper, times=n)` at each replay. Other threads' launches
    meanwhile count as usual."""
    tally = collections.Counter()
    me = threading.get_ident()
    with _count_lock:
        _tallies[me] = tally
    try:
        yield tally
    finally:
        with _count_lock:
            del _tallies[me]
