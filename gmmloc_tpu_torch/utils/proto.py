"""Hand-rolled varint-framed protobuf stream IO for the .gmm map format.

The reference stores GMM maps as a varint message-count header followed by
varint-length-prefixed ComponentProto messages (voxblox pattern; ref:
gmmloc/src/utils/protobuf_utils.cpp:12-101, schema
proto/gmmloc/GMM.proto:5-21). We parse the proto2 wire format directly —
no protoc dependency — into numpy arrays.

ComponentProto fields:
  1: optional bool   is_degenerated
  2: optional bool   is_salient
  3: repeated double mean       [packed]
  4: repeated double covariance [packed]

The port's own copy of `gmmloc_tpu/utils/proto.py` (numpy only, copied unchanged
so that the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _parse_component(buf: bytes):
    """Parse one ComponentProto message body."""
    pos = 0
    is_deg = False
    is_sal = False
    mean = np.zeros(3, dtype=np.float64)
    cov = np.zeros(9, dtype=np.float64)
    n = len(buf)
    while pos < n:
        key, pos = read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if field == 1 and wire == 0:
            v, pos = read_varint(buf, pos)
            is_deg = bool(v)
        elif field == 2 and wire == 0:
            v, pos = read_varint(buf, pos)
            is_sal = bool(v)
        elif field in (3, 4) and wire == 2:  # packed doubles
            ln, pos = read_varint(buf, pos)
            arr = np.frombuffer(buf, dtype="<f8", count=ln // 8, offset=pos)
            pos += ln
            if field == 3:
                mean = arr
            else:
                cov = arr
        elif field in (3, 4) and wire == 1:  # unpacked double (rare)
            v = np.frombuffer(buf, dtype="<f8", count=1, offset=pos)[0]
            pos += 8
            if field == 3:
                mean = np.append(mean[mean != 0], v)
            else:
                cov = np.append(cov[cov != 0], v)
        else:  # skip unknown field
            if wire == 0:
                _, pos = read_varint(buf, pos)
            elif wire == 1:
                pos += 8
            elif wire == 2:
                ln, pos = read_varint(buf, pos)
                pos += ln
            elif wire == 5:
                pos += 4
            else:
                raise ValueError(f"unsupported wire type {wire}")
    return is_deg, is_sal, mean, cov


def load_gmm_file(path: str):
    """Parse a .gmm stream -> (means (K,3), covs (K,3,3), flags).

    Mirrors GMMUtility::loadGMMModel (gmm_utils.cpp:9-67). The stored
    degeneracy/salience flags are re-derived downstream from the
    eigendecomposition exactly as the reference constructor does, but we
    keep the stored ones too.
    """
    with open(path, "rb") as f:
        buf = f.read()
    count, pos = read_varint(buf, 0)
    means = np.zeros((count, 3), dtype=np.float64)
    covs = np.zeros((count, 3, 3), dtype=np.float64)
    deg = np.zeros(count, dtype=bool)
    sal = np.zeros(count, dtype=bool)
    for i in range(count):
        size, pos = read_varint(buf, pos)
        body = buf[pos : pos + size]
        pos += size
        d, s, m, c = _parse_component(body)
        deg[i], sal[i] = d, s
        means[i] = m
        covs[i] = c.reshape(3, 3)
    return means, covs, deg, sal


def _encode_component(is_deg: bool, is_sal: bool, mean, cov) -> bytes:
    body = bytearray()
    body += write_varint((1 << 3) | 0) + write_varint(int(is_deg))
    body += write_varint((2 << 3) | 0) + write_varint(int(is_sal))
    mean_bytes = np.asarray(mean, dtype="<f8").tobytes()
    body += write_varint((3 << 3) | 2) + write_varint(len(mean_bytes)) + mean_bytes
    cov_bytes = np.asarray(cov, dtype="<f8").reshape(-1).tobytes()
    body += write_varint((4 << 3) | 2) + write_varint(len(cov_bytes)) + cov_bytes
    return bytes(body)


def save_gmm_file(path: str, means, covs, deg=None, sal=None) -> None:
    """Write the same varint-framed stream (ref: saveGMMModel gmm_utils.cpp:69)."""
    means = np.asarray(means)
    K = means.shape[0]
    deg = np.zeros(K, dtype=bool) if deg is None else np.asarray(deg)
    sal = np.zeros(K, dtype=bool) if sal is None else np.asarray(sal)
    with open(path, "wb") as f:
        f.write(write_varint(K))
        for i in range(K):
            body = _encode_component(bool(deg[i]), bool(sal[i]), means[i], covs[i])
            f.write(write_varint(len(body)))
            f.write(body)
