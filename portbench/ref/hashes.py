"""libm's expf, as the chain penalties call it (map-algo.c:388):
calling the same libm keeps them bit-exact with the C build."""
from __future__ import annotations

import ctypes
import ctypes.util

_libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_libm.expf.restype = ctypes.c_float
_libm.expf.argtypes = [ctypes.c_float]


def expf(x: float) -> float:
    """glibc expf (float32), as called by the reference (map-algo.c:388)."""
    return _libm.expf(ctypes.c_float(x))
