"""2-piece affine-gap wavefront alignment (miniwfa) for the reference's
host finish at -c: the exact engine through the reference's native
library (csrc/mgt_wfa.c mgt_wfa_exact2) and the k-mer chain heuristic
for huge divergent gaps (miniwfa.c:620-834).  Penalties: x=4, o1=4,
e1=2, o2=15, e2=1 (miniwfa.c:11-18).

A frozen copy of the port's align/wfa.py.
"""
from __future__ import annotations

import copy
import ctypes
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .native import get_lib


@dataclass
class WfOpt:
    x: int = 4
    o1: int = 4
    e1: int = 2
    o2: int = 15
    e2: int = 1
    kmer: int = 13
    max_occ: int = 2
    min_len: int = 30
    step: int = 0
    max_iter: int = 0
    max_s: int = 0
    cigar: bool = False


@dataclass
class WfRst:
    s: int = 0
    n_cigar: int = 0
    # len << 4 | op, ops: 7 '=', 8 'X', 1 I, 2 D
    cigar: Optional[List[int]] = None
    n_iter: int = 0


_native_cfg = False


def wfa_exact(opt: WfOpt, ts: bytes, qs: bytes) -> WfRst:
    """mwf_wfa_exact / mwf_wfa_core (miniwfa.c:380-435, 603-615) in the
    native wavefront engine (native/mgt_wfa.c); s = -1 when the score or
    iteration budget ran out."""
    global _native_cfg
    lib = get_lib()
    if not _native_cfg:
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.mgt_wfa_exact2.restype = ctypes.c_int32
        lib.mgt_wfa_exact2.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(u32p), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mgt_wfa_free.restype = None
        lib.mgt_wfa_free.argtypes = [u32p]
        _native_cfg = True
    cig = ctypes.POINTER(ctypes.c_uint32)()
    n_cig = ctypes.c_int32(0)
    n_iter = ctypes.c_int64(0)
    s = lib.mgt_wfa_exact2(ts, len(ts), qs, len(qs), opt.x, opt.o1, opt.e1,
                           opt.o2, opt.e2, 1 if opt.cigar else 0,
                           opt.max_s, opt.max_iter, opt.step,
                           ctypes.byref(cig), ctypes.byref(n_cig),
                           ctypes.byref(n_iter))
    r = WfRst(s=s, n_iter=n_iter.value)
    if opt.cigar and s >= 0:
        r.n_cigar = n_cig.value
        r.cigar = [int(cig[i]) for i in range(n_cig.value)]
        if n_cig.value:
            lib.mgt_wfa_free(cig)
    return r


# ----------------------------------------------------------------------
# k-mer chain heuristic for huge divergent gaps (miniwfa.c:620-822)
# ----------------------------------------------------------------------

_NT4 = np.full(256, 4, dtype=np.uint8)
_NT4[:4] = [0, 1, 2, 3]
for _c, _v in zip("ACGTU", [0, 1, 2, 3, 3]):
    _NT4[ord(_c)] = _v
    _NT4[ord(_c.lower())] = _v


def _fc_kmer(seq: bytes, rid: int, k: int) -> List[int]:
    out = []
    mask = (1 << (2 * k)) - 1
    x = l = 0
    for i, ch in enumerate(seq):
        c = int(_NT4[ch])
        if c < 4:
            x = ((x << 2) | c) & mask
            l += 1
            if l >= k:
                out.append(((x << 1 | rid) << 32) | i)
        else:
            l = 0
            x = 0
    return out


def _lis_64(a: List[int]) -> List[int]:
    """Longest increasing subsequence (mg_lis_64, miniwfa.c:620-639)."""
    n = len(a)
    M = [0] * (n + 1)
    P = [0] * n
    L = 0
    for i in range(n):
        lo, hi = 1, L
        while lo <= hi:
            mid = (lo + hi + 1) >> 1
            if a[M[mid]] < a[i]:
                lo = mid + 1
            else:
                hi = mid - 1
        newL = lo
        P[i] = M[newL - 1]
        M[newL] = i
        if newL > L:
            L = newL
    out = [0] * L
    k = M[L]
    for i in range(L - 1, -1, -1):
        out[i] = k
        k = P[k]
    return out


def _chain(s1: bytes, s2: bytes, k: int, max_occ: int) -> List[int]:
    """mg_chain (miniwfa.c:658-710): k-mer matches + LIS."""
    l1, l2 = len(s1), len(s2)
    if l1 < k or l2 < k:
        return []
    a = _fc_kmer(s1, 0, k) + _fc_kmer(s2, 1, k)
    a.sort()
    b = []
    n_a = len(a)
    i0 = 0
    for i in range(1, n_a + 1):
        if i == n_a or (a[i0] >> 33) != (a[i] >> 33):
            if i - i0 >= 2:
                j = i0
                while j < i and ((a[j] >> 32) & 1) == 0:
                    j += 1
                if i0 < j < i and j - i0 <= max_occ and i - j <= max_occ:
                    for s in range(i0, j):
                        for t in range(j, i):
                            b.append((a[s] << 32 | (a[t] & 0xFFFFFFFF))
                                     & 0xFFFFFFFFFFFFFFFF)
            i0 = i
    b.sort()
    b = [((x >> 32) | (x << 32)) & 0xFFFFFFFFFFFFFFFF for x in b]
    lis = _lis_64(b)
    out = [b[i] for i in lis]
    return [((x >> 32) | (x << 32)) & 0xFFFFFFFFFFFFFFFF for x in out]


def _ksim(s1: bytes, s2: bytes, k: int) -> float:
    """k-mer similarity (mwf_ksim, miniwfa.c:712-738)."""
    l1, l2 = len(s1), len(s2)
    if l1 < k or l2 < k:
        return 0.0
    a = _fc_kmer(s1, 0, k) + _fc_kmer(s2, 1, k)
    a.sort()
    n1 = n2 = t1 = t2 = 0
    n_a = len(a)
    i0 = 0
    for i in range(1, n_a + 1):
        if i == n_a or (a[i0] >> 33) != (a[i] >> 33):
            j = i0
            while j < i and ((a[j] >> 32) & 1) == 0:
                j += 1
            m1, m2 = j - i0, i - j
            mn = m1 if m1 < m2 else m2
            n1 += m1
            n2 += m2
            if m1 > 0 and m2 > 0:
                t1 += mn
                t2 += mn
            i0 = i
    p1 = t1 / n1 if n1 else 0.0
    p2 = t2 / n2 if n2 else 0.0
    return p1 if p1 > p2 else p2


def _anchor_filter(a: List[int], tl: int, ql: int, k: int,
                   min_l: int) -> List[int]:
    """wf_anchor_filter (miniwfa.c:755-774)."""
    n = len(a)
    a = list(a)
    x0 = y0 = x1 = y1 = 0
    st = -1
    l = 0
    for i in range(n + 1):
        if i == n:
            x, y = tl, ql
        else:
            x = ((a[i] >> 32) & 0xFFFFFFFF) + 1
            y = (a[i] & 0xFFFFFFFF) + 1
        if x - x0 != y - y0:
            if l < min_l:
                for j in range(max(st, 0), i):
                    a[j] = 0
            x0, y0, st, l = x, y, i, k
        else:
            l += x - x1
        x1, y1 = x, y
    return [v for v in a if v != 0]


def _cig_push(cigar: List[int], op: int, ln: int) -> None:
    if cigar and (cigar[-1] & 0xF) == op:
        cigar[-1] += ln << 4
    else:
        cigar.append(ln << 4 | op)


def _cig_extend(cigar: List[int], other: List[int]) -> None:
    if not other:
        return
    _cig_push(cigar, other[0] & 0xF, other[0] >> 4)
    cigar.extend(other[1:])


def wfa_chain(opt: WfOpt, ts: bytes, qs: bytes) -> WfRst:
    """mwf_wfa_chain (miniwfa.c:776-822)."""
    tl, ql = len(ts), len(qs)
    a = _chain(ts, qs, opt.kmer, opt.max_occ)
    a = _anchor_filter(a, tl, ql, opt.kmer, opt.min_len)
    r = WfRst()
    c: List[int] = []
    x0 = y0 = 0
    n_a = len(a)
    for i in range(n_a + 1):
        if i == n_a:
            x1, y1 = tl, ql
        else:
            x1 = ((a[i] >> 32) & 0xFFFFFFFF) + 1
            y1 = (a[i] & 0xFFFFFFFF) + 1
        if i < n_a and x1 - x0 == y1 - y0 and x1 - x0 <= opt.kmer:
            if opt.cigar:
                _cig_push(c, 7, x1 - x0)
        elif x0 < x1 and y0 < y1:
            if x1 - x0 >= 10000 and y1 - y0 >= 10000 \
                    and _ksim(ts[x0:x1], qs[y0:y1], opt.kmer) < 0.02:
                if opt.cigar:
                    _cig_push(c, 2, x1 - x0)
                    _cig_push(c, 1, y1 - y0)
                r.s += opt.o2 * 2 + opt.e2 * ((x1 - x0) + (y1 - y0))
            else:
                opt2 = copy.copy(opt)
                q = wfa_exact(opt2, ts[x0:x1], qs[y0:y1])
                if opt.cigar:
                    _cig_extend(c, q.cigar or [])
                r.s += q.s
        elif x0 < x1:
            _cig_push(c, 2, x1 - x0)
            r.s += min(opt.o2 + (x1 - x0) * opt.e2,
                       opt.o1 + (x1 - x0) * opt.e1)
        elif y0 < y1:
            _cig_push(c, 1, y1 - y0)
            r.s += min(opt.o2 + (y1 - y0) * opt.e2,
                       opt.o1 + (y1 - y0) * opt.e1)
        x0, y0 = x1, y1
    r.cigar = c
    r.n_cigar = len(c)
    return r


def wfa_auto(ts: bytes, qs: bytes, cigar: bool = True) -> WfRst:
    """mwf_wfa_auto (miniwfa.c:824-834): exact with an iteration budget,
    fall back to the chain heuristic."""
    opt = WfOpt(cigar=cigar, step=0, max_iter=100_000_000)
    r = wfa_exact(opt, ts, qs)
    if r.s < 0:
        opt.max_iter = 0
        if cigar:
            opt.step = 5000
        r = wfa_chain(opt, ts, qs)
    return r
