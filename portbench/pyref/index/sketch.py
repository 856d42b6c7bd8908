"""Minimizer sketching host API.

Returns (x, y) uint64 arrays: x = hash<<8 | kmer_span,
y = rid<<32 | last_pos<<1 | strand (reference sketch.c:40-55).
Native C path by default; exact pure-Python fallback.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..utils.hashes import hash64
from ..utils.native import get_lib

U64MAX = 0xFFFFFFFFFFFFFFFF

NT4 = np.full(256, 4, dtype=np.uint8)
NT4[:4] = [0, 1, 2, 3]
for _c, _v in zip("ACGTU", [0, 1, 2, 3, 3]):
    NT4[ord(_c)] = _v
    NT4[ord(_c.lower())] = _v

_sketch_configured = False


def _native_sketch(seq_bytes: bytes, w: int, k: int, rid: int):
    global _sketch_configured
    lib = get_lib()
    if lib is None or not hasattr(lib, "mgt_sketch"):
        return None
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


def _py_sketch(seq_bytes: bytes, w: int, k: int, rid: int):
    """Exact reference-semantics loop (sketch.c:56-109)."""
    shift1 = 2 * (k - 1)
    mask = (1 << (2 * k)) - 1
    kf = kr = 0
    buf = [(U64MAX, U64MAX)] * w
    mn = (U64MAX, U64MAX)
    min_pos = 0
    l = buf_pos = 0
    kmer_span = 0
    xs, ys = [], []
    assert 0 < w < 256 and 0 < k <= 28

    codes = NT4[np.frombuffer(seq_bytes, dtype=np.uint8)]
    for i in range(len(seq_bytes)):
        c = int(codes[i])
        info = (U64MAX, U64MAX)
        if c < 4:
            kmer_span = l + 1 if l + 1 < k else k
            kf = ((kf << 2) | c) & mask
            kr = (kr >> 2) | ((3 ^ c) << shift1)
            if kf == kr:
                continue
            z = 0 if kf < kr else 1
            l += 1
            if l >= k and kmer_span < 256:
                info = (hash64(kr if z else kf, mask) << 8 | kmer_span,
                        rid << 32 | ((i << 1 | z) & 0xFFFFFFFF))
        else:
            l = 0
            kmer_span = 0
        buf[buf_pos] = info
        if l == w + k - 1 and mn[0] != U64MAX:
            for j in list(range(buf_pos + 1, w)) + list(range(buf_pos)):
                if mn[0] == buf[j][0] and buf[j][1] != mn[1]:
                    xs.append(buf[j][0]); ys.append(buf[j][1])
        if info[0] <= mn[0]:
            if l >= w + k and mn[0] != U64MAX:
                xs.append(mn[0]); ys.append(mn[1])
            mn, min_pos = info, buf_pos
        elif buf_pos == min_pos:
            if l >= w + k - 1 and mn[0] != U64MAX:
                xs.append(mn[0]); ys.append(mn[1])
            mn = (U64MAX, mn[1])
            for j in list(range(buf_pos + 1, w)) + list(range(buf_pos + 1)):
                if mn[0] >= buf[j][0]:
                    mn, min_pos = buf[j], j
            if l >= w + k - 1 and mn[0] != U64MAX:
                for j in list(range(buf_pos + 1, w)) + list(range(buf_pos + 1)):
                    if mn[0] == buf[j][0] and mn[1] != buf[j][1]:
                        xs.append(buf[j][0]); ys.append(buf[j][1])
        buf_pos += 1
        if buf_pos == w:
            buf_pos = 0
    if mn[0] != U64MAX:
        xs.append(mn[0]); ys.append(mn[1])
    return (np.asarray(xs, dtype=np.uint64), np.asarray(ys, dtype=np.uint64))


def sketch(seq: str | bytes, w: int, k: int, rid: int = 0):
    """Compute (w,k)-minimizers of one sequence; returns (x, y) uint64 arrays."""
    if isinstance(seq, str):
        seq = seq.encode("latin-1")
    if len(seq) == 0:
        return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64))
    res = _native_sketch(seq, w, k, rid)
    if res is None:
        res = _py_sketch(seq, w, k, rid)
    return res


_many_configured = False


def sketch_many(seqs, w: int, k: int, rids, n_threads: int = 0):
    """Sketch many segments with the pthread-pooled native engine
    (mgt_sketch_many; the kt_for bucket-build analog, index.c:207).

    Returns [(x, y), ...] per segment, or None when the native library
    is unavailable.  Per-segment record caps are sized at len/4 + 64
    (~2.3x the expected 2L/w density); the rare overflow segment is
    re-sketched through the doubling single-segment path."""
    global _many_configured
    lib = get_lib()
    if lib is None or not hasattr(lib, "mgt_sketch_many"):
        return None
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
