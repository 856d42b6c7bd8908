"""Minimizer sketching host API.

Returns (x, y) uint64 arrays: x = hash<<8 | kmer_span,
y = rid<<32 | last_pos<<1 | strand (reference sketch.c:40-55), from
the native C sketcher (native/mgt_sketch.c).
"""
from __future__ import annotations

import ctypes

import numpy as np

from .native import get_lib

_sketch_configured = False


def _native_sketch(seq_bytes: bytes, w: int, k: int, rid: int):
    global _sketch_configured
    lib = get_lib()
    if not _sketch_configured:
        lib.mgt_sketch.restype = ctypes.c_int64
        lib.mgt_sketch.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ]
        _sketch_configured = True
    n = len(seq_bytes)
    cap = max(n + 16, 64)
    while True:
        out = np.empty(2 * cap, dtype=np.uint64)
        got = lib.mgt_sketch(seq_bytes, n, w, k, rid,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), cap)
        if got >= 0:
            rec = out[: 2 * got].reshape(-1, 2)
            return rec[:, 0].copy(), rec[:, 1].copy()
        cap *= 2


def sketch(seq: str | bytes, w: int, k: int, rid: int = 0):
    """Compute (w,k)-minimizers of one sequence; returns (x, y) uint64 arrays."""
    if isinstance(seq, str):
        seq = seq.encode("latin-1")
    if len(seq) == 0:
        return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64))
    return _native_sketch(seq, w, k, rid)


_many_configured = False


def sketch_many(seqs, w: int, k: int, rids, n_threads: int = 0):
    """Sketch many segments with the pthread-pooled native engine
    (mgt_sketch_many; the kt_for bucket-build analog, index.c:207).

    Returns [(x, y), ...] per segment.  Per-segment record caps are
    sized at len/4 + 64 (~2.3x the expected 2L/w density); the rare
    overflow segment is
    re-sketched through the doubling single-segment path."""
    global _many_configured
    lib = get_lib()
    if not _many_configured:
        lib.mgt_sketch_many.restype = None
        lib.mgt_sketch_many.argtypes = [
            ctypes.c_char_p] + [ctypes.c_void_p] * 5 + [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
        _many_configured = True
    if n_threads <= 0:
        import os
        n_threads = os.cpu_count() or 1
    n = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    off = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    caps = lens // 4 + 64
    out_off = np.zeros(n, dtype=np.int64)
    np.cumsum(caps[:-1], out=out_off[1:])
    buf = b"".join(seqs)
    rid_a = np.asarray(rids, dtype=np.int64)
    out = np.empty(2 * int(caps.sum()), dtype=np.uint64)
    out_n = np.empty(n, dtype=np.int64)
    lib.mgt_sketch_many(
        buf, off.ctypes.data, lens.ctypes.data, rid_a.ctypes.data,
        out_off.ctypes.data, caps.ctypes.data, n, w, k, n_threads,
        out.ctypes.data, out_n.ctypes.data)
    res = []
    for i in range(n):
        m = int(out_n[i])
        if m < 0 or m > int(caps[i]):
            # cap overflow: redo via the adaptive single-segment path
            res.append(sketch(seqs[i], w, k, int(rid_a[i])))
            continue
        rec = out[2 * int(out_off[i]): 2 * (int(out_off[i]) + m)]
        rec = rec.reshape(-1, 2)
        res.append((rec[:, 0].copy(), rec[:, 1].copy()))
    return res
