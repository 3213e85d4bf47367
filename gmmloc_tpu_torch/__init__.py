"""gmmloc-tpu ported to PyTorch with hand-written CUDA kernels (sm_90a).

The JAX package `gmmloc_tpu` is the reference; this package mirrors its
layout (geometry/, gmm/, features/, solver/, tracking/, mapping/,
pipeline/, eval/) and imports nothing of it: the numpy-only host modules
(config, map state, frame, proto, timing) are the port's own copies. Kernels live in
csrc/ and build at first use (utils/cuda_build.py). Importing the package
loads no JAX and builds nothing.
"""
