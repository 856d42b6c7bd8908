"""Bit-exact scalar hash and math helpers of the reference.

The mapping tail's tie-breaking depends on these exact integer hashes
(khashl.h:321-345) and on the fast float32 log2 (mgpriv.h:63-71); the
penalties and mapq call libm's expf and logf (map-algo.c:388,
gcmisc.c:216), and calling the same libm keeps them bit-exact with the
C build."""
from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

U32 = 0xFFFFFFFF

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


def mg_log2(x: float) -> float:
    """Fast float32 log2 (mgpriv.h:63); only valid for x >= 2.  Every
    operation in float32, as the C version."""
    z = np.float32(x)
    i = z.view(np.uint32)
    log_2 = np.float32(np.int32(((int(i) >> 23) & 255) - 128))
    i = np.uint32((int(i) & ~(255 << 23)) + (127 << 23))
    zf = i.view(np.float32)
    log_2 = np.float32(
        log_2
        + (np.float32(np.float32(np.float32(-0.34484843) * zf)
                      + np.float32(2.02466578)) * zf
           - np.float32(0.67487759)))
    return float(log_2)
