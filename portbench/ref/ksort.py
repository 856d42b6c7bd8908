"""Reference-exact sorting utilities.

`radix_argsort` reproduces the permutation of the reference's in-place
MSD radix sort (ksort.h KRADIX_SORT_INIT): deterministic but *unstable*
for tied keys.  Output parity requires this exact permutation wherever
the reference radix-sorts data whose downstream processing is
order-sensitive (seed anchors, chain scores, arcs, ...).

Runs the native C implementation (native/mgt_core.c).
"""
from __future__ import annotations

import ctypes

import numpy as np

from .native import get_lib


def radix_argsort(keys: np.ndarray) -> np.ndarray:
    """Argsort of uint64 keys with reference-exact tie permutation.

    Works for narrower unsigned keys too (leading zero digits are no-op
    passes in the MSD algorithm, so the permutation matches the 4-byte
    instantiations like radix_sort_gc as well).
    """
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = len(keys)
    if n <= 1:
        return np.arange(n, dtype=np.int64)
    lib = get_lib()
    idx = np.empty(n, dtype=np.uint64)
    lib.mgt_radix_argsort_u64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n,
    )
    return idx.astype(np.int64)

