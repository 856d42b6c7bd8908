"""The per-chain filter block of the per-read path (map-algo.c:418-440)
in the native library (native/mgt_filters.c).  The JAX package's
pure-Python filters run only without that library, which the port
requires, so they are not copied."""
from __future__ import annotations

import ctypes as ct
from typing import Tuple

from ..utils.native import get_lib

_cfg = False


def apply_chain_filters(ax, ay, off: int, cnt: int, score: int,
                        opt) -> Tuple[int, int]:
    """Occurrence end trim, score end shrink, unbalanced-indel and
    compensating-gap seed masking of one chain, in place.  Returns the
    chain's new (off, cnt)."""
    global _cfg
    lib = get_lib()
    if not _cfg:
        u64p = ct.POINTER(ct.c_uint64)
        i64p = ct.POINTER(ct.c_int64)
        lib.mgt_chain_filters.restype = None
        lib.mgt_chain_filters.argtypes = [
            u64p, u64p, ct.c_int32, ct.c_int32, ct.c_int32,
            ct.c_int32, ct.c_int32, ct.c_int32, i64p, i64p]
        _cfg = True
    assert ax.flags["C_CONTIGUOUS"] and ay.flags["C_CONTIGUOUS"]
    off_c = ct.c_int64(off)
    cnt_c = ct.c_int64(cnt)
    lib.mgt_chain_filters(
        ax.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        ay.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        opt.lc_max_occ, opt.lc_max_trim, score, opt.bw, 100,
        opt.max_gap >> 1, ct.byref(off_c), ct.byref(cnt_c))
    return off_c.value, cnt_c.value
