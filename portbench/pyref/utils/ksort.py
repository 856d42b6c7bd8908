"""Reference-exact sorting utilities.

`radix_argsort` reproduces the permutation of the reference's in-place
MSD radix sort (ksort.h KRADIX_SORT_INIT): deterministic but *unstable*
for tied keys.  Output parity requires this exact permutation wherever
the reference radix-sorts data whose downstream processing is
order-sensitive (seed anchors, chain scores, arcs, ...).

Native C implementation by default; bit-equivalent pure-Python fallback.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .native import get_lib

_RS_SMALL = 64


def _py_insertion(pairs: list, lo: int, hi: int) -> None:
    for i in range(lo + 1, hi):
        if pairs[i][0] < pairs[i - 1][0]:
            t = pairs[i]
            j = i
            while j > lo and t[0] < pairs[j - 1][0]:
                pairs[j] = pairs[j - 1]
                j -= 1
            pairs[j] = t


def _py_flag_sort(pairs: list, lo: int, hi: int, shift: int) -> None:
    nxt = [0] * 256
    end = [0] * 256
    for i in range(lo, hi):
        end[(pairs[i][0] >> shift) & 255] += 1
    start = lo
    for d in range(256):
        cnt = end[d]
        nxt[d] = start
        end[d] = start + cnt
        start += cnt
    d = 0
    while d < 256:
        if nxt[d] == end[d]:
            d += 1
            continue
        t = (pairs[nxt[d]][0] >> shift) & 255
        if t == d:
            nxt[d] += 1
            continue
        hold = pairs[nxt[d]]
        while True:
            swap = hold
            hold = pairs[nxt[t]]
            pairs[nxt[t]] = swap
            nxt[t] += 1
            t = (hold[0] >> shift) & 255
            if t == d:
                break
        pairs[nxt[d]] = hold
        nxt[d] += 1
    if shift:
        sub = shift - 8 if shift > 8 else 0
        start = lo
        for d in range(256):
            e = end[d]
            if e - start > _RS_SMALL:
                _py_flag_sort(pairs, start, e, sub)
            elif e - start > 1:
                _py_insertion(pairs, start, e)
            start = e


def _py_radix_argsort(keys: np.ndarray) -> np.ndarray:
    n = len(keys)
    pairs = [(int(keys[i]), i) for i in range(n)]
    if n <= _RS_SMALL:
        _py_insertion(pairs, 0, n)
    else:
        _py_flag_sort(pairs, 0, n, 56)
    return np.asarray([p[1] for p in pairs], dtype=np.int64)


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
    if lib is None:
        return _py_radix_argsort(keys)
    idx = np.empty(n, dtype=np.uint64)
    lib.mgt_radix_argsort_u64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n,
    )
    return idx.astype(np.int64)


def sort_128x(x: np.ndarray, y: np.ndarray):
    """Sort parallel (x, y) uint64 arrays by x (radix_sort_128x semantics)."""
    perm = radix_argsort(x)
    return x[perm], y[perm]
