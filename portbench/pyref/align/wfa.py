"""2-piece affine-gap wavefront aligner (miniwfa equivalent).

Semantics-equal reimplementation of the reference WFA library
(miniwfa.c): a stripe of max_pen+1 wavefront slices of (H,E1,F1,E2,F2)
per diagonal, numpy-vectorized next-wave kernels (score-only and
traceback flavors), band shrinking, and the k-mer chain heuristic for
huge divergent gaps.  Penalties: x=4, o1=4,e1=2, o2=15,e2=1
(miniwfa.c:11-18).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

NEG_INF = -0x40000000
I32 = np.int32


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
    cigar: Optional[List[int]] = None   # len<<4|op, ops: 7 '=', 8 'X', 1 I, 2 D
    n_iter: int = 0


class _Slice:
    """One wavefront slice over diagonals [lo, hi] with m1 NEG_INF pads."""
    __slots__ = ("lo", "hi", "m1", "H", "E1", "F1", "E2", "F2")

    def __init__(self, lo: int, hi: int, m1: int):
        self.lo, self.hi, self.m1 = lo, hi, m1
        n = hi - lo + 1 + 2 * m1
        self.H = np.full(n, NEG_INF, dtype=I32)
        self.E1 = np.full(n, NEG_INF, dtype=I32)
        self.F1 = np.full(n, NEG_INF, dtype=I32)
        self.E2 = np.full(n, NEG_INF, dtype=I32)
        self.F2 = np.full(n, NEG_INF, dtype=I32)

    def rng(self, arr: np.ndarray, a: int, b: int) -> np.ndarray:
        """Values for diagonals [a, b]; NEG_INF outside the padded range."""
        base = self.lo - self.m1
        n = len(arr)
        ia, ib = a - base, b - base + 1
        if ia >= 0 and ib <= n:
            return arr[ia:ib]
        out = np.full(b - a + 1, NEG_INF, dtype=I32)
        oa = max(ia, 0)
        ob = min(ib, n)
        if oa < ob:
            out[oa - ia: ob - ia] = arr[oa:ob]
        return out

    def getd(self, arr: np.ndarray, d: int) -> int:
        base = self.lo - self.m1
        i = d - base
        if 0 <= i < len(arr):
            return int(arr[i])
        return NEG_INF

    def setd(self, arr: np.ndarray, d: int, v: int) -> None:
        arr[d - (self.lo - self.m1)] = v

    def set_range(self, arr: np.ndarray, a: int, vals: np.ndarray) -> None:
        i = a - (self.lo - self.m1)
        arr[i: i + len(vals)] = vals


class _Stripe:
    def __init__(self, max_pen: int):
        self.max_pen = max_pen
        self.n = max_pen + 1
        self.s = -1
        self.top = -1
        self.lo = self.hi = 0
        self.a: List[Optional[_Slice]] = [None] * self.n
        for _ in range(self.n):
            self.add(0, 0)
        self.s = 0
        self.a[self.top].setd(self.a[self.top].H, 0, -1)

    def add(self, lo: int, hi: int) -> _Slice:
        self.s += 1
        self.top += 1
        if self.top == self.n:
            self.top = 0
        sl = _Slice(lo, hi, self.max_pen + 1)
        self.a[self.top] = sl
        return sl

    def get(self, x: int) -> _Slice:
        y = self.top - x
        if y < 0:
            y += self.n
        return self.a[y]


def _pad_str(ts: bytes, qs: bytes) -> Tuple[bytes, bytes]:
    """Pad with two distinct unused characters (wf_pad_str)."""
    used = set(ts) | set(qs)
    c1 = c2 = -1
    for i in range(256):
        if i not in used:
            if c1 < 0:
                c1 = i
            elif c2 < 0:
                c2 = i
                break
    assert c1 >= 0 and c2 >= 0
    return ts + bytes([c1] * 8), qs + bytes([c2] * 8)


def _extend1(pts: bytes, pqs: bytes, k: int, d: int) -> int:
    """Exact-match extension on padded strings (wf_extend1_padded)."""
    a = pts[k + 1:]
    b = pqs[d + k + 1:]
    n = min(len(a), len(b))
    av = np.frombuffer(a[:n], dtype=np.uint8)
    bv = np.frombuffer(b[:n], dtype=np.uint8)
    neq = av != bv
    return k + int(np.argmax(neq))  # pads guarantee a mismatch exists


def _good_diag_np(d: np.ndarray, k: np.ndarray, tl: int, ql: int) -> np.ndarray:
    return (k >= -1) & (k < tl) & (d + k >= -1) & (d + k < ql)


def _stripe_shrink(wf: _Stripe, tl: int, ql: int) -> None:
    """wf_stripe_shrink (miniwfa.c:144-171)."""
    ds = np.arange(wf.lo, wf.hi + 1, dtype=np.int64)
    good = np.zeros(len(ds), dtype=bool)
    for j in range(wf.n):
        p = wf.a[(wf.top + 1 + j) % wf.n]
        a = max(wf.lo, p.lo)
        b = min(wf.hi, p.hi)
        if a > b:
            continue
        dd = np.arange(a, b + 1, dtype=np.int64)
        sl = slice(a - wf.lo, b - wf.lo + 1)
        for arr in (p.H, p.E1, p.F1, p.E2, p.F2):
            good[sl] |= _good_diag_np(dd, p.rng(arr, a, b).astype(np.int64),
                                      tl, ql)
    idx = np.nonzero(good)[0]
    assert len(idx) > 0
    wf.lo = int(ds[idx[0]])
    wf.hi = int(ds[idx[-1]])


def _next(wf: _Stripe, opt: WfOpt, lo: int, hi: int, tb: Optional[list]):
    """wf_next_basic: add one wavefront slice (miniwfa.c:243-327)."""
    ft = wf.add(lo, hi)
    fx = wf.get(opt.x)
    fo1 = wf.get(opt.o1 + opt.e1)
    fo2 = wf.get(opt.o2 + opt.e2)
    fe1 = wf.get(opt.e1)
    fe2 = wf.get(opt.e2)

    pHx = fx.rng(fx.H, lo, hi)
    pHo1m = fo1.rng(fo1.H, lo - 1, hi - 1)
    pHo1p = fo1.rng(fo1.H, lo + 1, hi + 1)
    pHo2m = fo2.rng(fo2.H, lo - 1, hi - 1)
    pHo2p = fo2.rng(fo2.H, lo + 1, hi + 1)
    pE1 = fe1.rng(fe1.E1, lo - 1, hi - 1)
    pF1 = fe1.rng(fe1.F1, lo + 1, hi + 1)
    pE2 = fe2.rng(fe2.E2, lo - 1, hi - 1)
    pF2 = fe2.rng(fe2.F2, lo + 1, hi + 1)

    E1 = np.maximum(pHo1m, pE1)
    E2 = np.maximum(pHo2m, pE2)
    e = np.maximum(E1, E2)
    F1 = np.maximum(pHo1p, pF1) + 1
    F2 = np.maximum(pHo2p, pF2) + 1
    f = np.maximum(F1, F2)
    h = np.maximum(e, f)
    H = np.maximum(pHx + 1, h)

    if tb is not None:
        x = np.zeros(hi - lo + 1, dtype=np.uint8)
        x |= np.where(pHo1m >= pE1, 0, 0x08).astype(np.uint8)
        x |= np.where(pHo2m >= pE2, 0, 0x20).astype(np.uint8)
        ze = np.where(E1 >= E2, 1, 3).astype(np.uint8)
        x |= np.where(pHo1p >= pF1, 0, 0x10).astype(np.uint8)
        x |= np.where(pHo2p >= pF2, 0, 0x40).astype(np.uint8)
        zf = np.where(F1 >= F2, 2, 4).astype(np.uint8)
        z = np.where(e >= f, ze, zf)
        z = np.where(pHx + 1 >= h, 0, z).astype(np.uint8)
        tb.append((lo, hi, x | z))

    ft.set_range(ft.H, lo, H)
    ft.set_range(ft.E1, lo, E1)
    ft.set_range(ft.F1, lo, F1)
    ft.set_range(ft.E2, lo, E2)
    ft.set_range(ft.F2, lo, F2)

    if H[0] >= -1 or E1[0] >= -1 or F1[0] >= -1 or E2[0] >= -1 or F2[0] >= -1:
        wf.lo = lo
    if H[-1] >= -1 or E1[-1] >= -1 or F1[-1] >= -1 or E2[-1] >= -1 \
            or F2[-1] >= -1:
        wf.hi = hi


def _traceback(opt: WfOpt, tb: list, t_end: int, pts: bytes, q_end: int,
               pqs: bytes, last: int) -> List[int]:
    """wf_traceback (miniwfa.c:329-377)."""
    cigar: List[int] = []

    def push(op, ln):
        if cigar and (cigar[-1] & 0xF) == op:
            cigar[-1] += ln << 4
        else:
            cigar.append(ln << 4 | op)

    i, k, s = q_end, t_end, len(tb) - 1
    while i >= 0 and k >= 0:
        k0 = k
        if last == 0:
            while i >= 0 and k >= 0 and pqs[i] == pts[k]:
                i -= 1
                k -= 1
            if k0 - k > 0:
                push(7, k0 - k)
            if i < 0 or k < 0:
                break
        assert s >= 0
        lo, hi, xarr = tb[s]
        j = i - k - lo
        assert j <= hi - lo
        x = int(xarr[j])
        state = (x & 7) if last == 0 else last
        ext = (x >> (state + 2)) & 1 if state > 0 else 0
        if state == 0:
            push(8, 1)
            i -= 1
            k -= 1
            s -= opt.x
        elif state == 1:
            push(1, 1)
            i -= 1
            s -= opt.e1 if ext else opt.o1 + opt.e1
        elif state == 3:
            push(1, 1)
            i -= 1
            s -= opt.e2 if ext else opt.o2 + opt.e2
        elif state == 2:
            push(2, 1)
            k -= 1
            s -= opt.e1 if ext else opt.o1 + opt.e1
        elif state == 4:
            push(2, 1)
            k -= 1
            s -= opt.e2 if ext else opt.o2 + opt.e2
        else:
            raise AssertionError
        last = state if (state > 0 and ext) else 0
    if i >= 0:
        push(1, i + 1)
    elif k >= 0:
        push(2, k + 1)
    cigar.reverse()
    return cigar


_native_cfg = False


def _wfa_exact_native(opt: WfOpt, ts: bytes, qs: bytes) -> Optional[WfRst]:
    """Native C wavefront engine (native/mgt_wfa.c); ~100x the numpy path."""
    global _native_cfg
    import ctypes

    from ..utils.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "mgt_wfa_exact"):
        return None
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


def wfa_exact(opt: WfOpt, ts: bytes, qs: bytes) -> WfRst:
    """mwf_wfa_exact / mwf_wfa_core (miniwfa.c:380-435, 603-615)."""
    r = _wfa_exact_native(opt, ts, qs)
    if r is not None:
        return r
    return _wfa_exact_py(opt, ts, qs)


def _wfa_exact_py(opt: WfOpt, ts: bytes, qs: bytes) -> WfRst:
    """numpy-vectorized reference implementation (validation oracle)."""
    tl, ql = len(ts), len(qs)
    r = WfRst()
    pts, pqs = _pad_str(ts, qs)
    is_tb = opt.cigar
    max_pen = max(opt.x, opt.o1 + opt.e1, opt.o2 + opt.e2)
    wf = _Stripe(max_pen)
    tb: Optional[list] = [] if is_tb else None
    last_state = 0
    stopped = False

    while True:
        p = wf.a[wf.top]
        found = False
        base = p.lo - p.m1
        H = p.H
        for d in range(p.lo, p.hi + 1):
            hd = int(H[d - base])
            if hd < -1 or d + hd < -1 or hd >= tl or d + hd >= ql:
                continue
            k = _extend1(pts, pqs, hd, d)
            if k == tl - 1 and d + k == ql - 1:
                if k == hd and is_tb:
                    lo_t, hi_t, xarr = tb[-1]
                    last_state = int(xarr[d - lo_t]) & 7
                found = True
                break
            H[d - base] = k
        if found:
            break
        lo = wf.lo - 1 if wf.lo > -tl else -tl
        hi = wf.hi + 1 if wf.hi < ql else ql
        _next(wf, opt, lo, hi, tb)
        if (wf.s & 0xFF) == 0:
            _stripe_shrink(wf, tl, ql)
        r.n_iter += hi - lo + 1
        if (opt.max_iter > 0 and r.n_iter > opt.max_iter) \
                or (opt.max_s > 0 and wf.s > opt.max_s):
            stopped = True
            break
    r.s = -1 if stopped else wf.s
    if is_tb and not stopped:
        r.cigar = _traceback(opt, tb, tl - 1, pts, ql - 1, pqs, last_state)
        r.n_cigar = len(r.cigar)
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
                import copy
                opt2 = copy.copy(opt)
                q = wfa_exact(opt2, ts[x0:x1], qs[y0:y1])
                if opt.cigar:
                    _cig_extend(c, q.cigar or [])
                r.s += q.s
        elif x0 < x1:
            _cig_push(c, 2, x1 - x0)
            r.s += min(opt.o2 + (x1 - x0) * opt.e2, opt.o1 + (x1 - x0) * opt.e1)
        elif y0 < y1:
            _cig_push(c, 1, y1 - y0)
            r.s += min(opt.o2 + (y1 - y0) * opt.e2, opt.o1 + (y1 - y0) * opt.e1)
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


def wfa_cmp(ts: bytes, qs: bytes):
    """mg_wfa_cmp (algo.c:177-194): score-only alignment and identity."""
    opt = WfOpt(cigar=False, max_s=0, max_iter=0)
    r = wfa_exact(opt, ts, qs)
    return r
