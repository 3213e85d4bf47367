"""The configuration tree, shared with the JAX package.

`gmmloc_tpu/config.py` is plain dataclasses with no JAX import; the port
uses it as it is.
"""

from gmmloc_tpu.config import *  # noqa: F401,F403
from gmmloc_tpu.config import derived_pyramid, euroc_v1_config  # noqa: F401
