"""Bit-exact scalar hash / math helpers shared with the reference semantics.

The mapping pipeline's tie-breaking depends on these exact integer hashes
(reference: khashl.h:321-345, sketch.c:28-38) and on the fast float32 log2
approximation (mgpriv.h:63-71).  Everything here operates on Python ints /
numpy arrays with explicit wrap-around so results match C uint32/uint64
arithmetic bit for bit.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import math

import numpy as np

U32 = 0xFFFFFFFF
U64 = 0xFFFFFFFFFFFFFFFF


def kh_hash_uint32(key: int) -> int:
    """32-bit integer hash (khashl.h:321)."""
    key &= U32
    key = (key + (~(key << 15) & U32)) & U32
    key ^= key >> 10
    key = (key + (key << 3)) & U32
    key ^= key >> 6
    key = (key + (~(key << 11) & U32)) & U32
    key ^= key >> 16
    return key


def kh_hash_str(s: str | bytes) -> int:
    """String hash (khashl.h:342): h = h*31 + c over uint32."""
    if isinstance(s, str):
        s = s.encode("latin-1")
    h = 0
    if len(s):
        h = s[0]
        for c in s[1:]:
            h = ((h << 5) - h + c) & U32
    return h


def hash64(key: int, mask: int) -> int:
    """Invertible 64-bit integer hash used for minimizers (sketch.c:28)."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def hash64_np(key: np.ndarray, mask: int) -> np.ndarray:
    """Vectorized hash64 over a uint64 numpy array."""
    key = key.astype(np.uint64, copy=True)
    m = np.uint64(mask)
    with np.errstate(over="ignore"):
        key = (~key + (key << np.uint64(21))) & m
        key ^= key >> np.uint64(24)
        key = (key + (key << np.uint64(3)) + (key << np.uint64(8))) & m
        key ^= key >> np.uint64(14)
        key = (key + (key << np.uint64(2)) + (key << np.uint64(4))) & m
        key ^= key >> np.uint64(28)
        key = (key + (key << np.uint64(31))) & m
    return key


def mg_log2(x: float) -> float:
    """Fast float32 log2 approximation (mgpriv.h:63); only valid for x >= 2.

    Bit-exact with the C version: all arithmetic in float32.
    """
    z = np.float32(x)
    i = z.view(np.uint32)
    log_2 = np.float32(np.int32(((int(i) >> 23) & 255) - 128))
    i = np.uint32((int(i) & ~(255 << 23)) + (127 << 23))
    zf = i.view(np.float32)
    log_2 = np.float32(
        log_2
        + (np.float32(np.float32(np.float32(-0.34484843) * zf) + np.float32(2.02466578)) * zf
           - np.float32(0.67487759))
    )
    return float(log_2)


def mg_log2_np(x: np.ndarray) -> np.ndarray:
    """Vectorized bit-exact mg_log2 over float32 arrays (x >= 2)."""
    z = x.astype(np.float32)
    i = z.view(np.uint32)
    log_2 = (((i >> np.uint32(23)) & np.uint32(255)).astype(np.int32) - 128).astype(np.float32)
    i2 = (i & np.uint32(~(np.uint32(255 << 23)))) + np.uint32(127 << 23)
    zf = i2.view(np.float32)
    c1 = np.float32(-0.34484843)
    c2 = np.float32(2.02466578)
    c3 = np.float32(0.67487759)
    return log_2 + ((c1 * zf + c2) * zf - c3)


# libm expf/logf for exact float32 transcendental parity with the C build
_libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_libm.expf.restype = ctypes.c_float
_libm.expf.argtypes = [ctypes.c_float]
_libm.logf.restype = ctypes.c_float
_libm.logf.argtypes = [ctypes.c_float]


def expf(x: float) -> float:
    """glibc expf (float32), as called by the reference (map-algo.c:388)."""
    return _libm.expf(ctypes.c_float(x))


def logf(x: float) -> float:
    """glibc logf (float32), as used in mapq estimation (gcmisc.c:216)."""
    return _libm.logf(ctypes.c_float(x))


def log_double(x: float) -> float:
    """double-precision log (divergence calc, gchain1.c:295)."""
    return math.log(x)
