"""Graph wavefront alignment (GWFA) — exact host engine.

Semantics-equal port of the reference graph edit-distance machinery
(gfa-ed.c:56-617): wavefront state is a set of (vertex, diagonal)
records carrying the furthest offset k, the anti-diagonal (for pruning)
and a traceback id; exact matches extend within and across vertices at
zero cost, and each score step expands every diagonal by the three
edit operations.  Finished vertex-diagonals become "forbidden bands"
used during wavefront dedup.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..utils.ksort import radix_argsort

GWF_DIAG_SHIFT = 0x40000000
U32M = 0xFFFFFFFF


def _gen_vd(v: int, d: int) -> int:
    return (v << 32) | ((GWF_DIAG_SHIFT + d) & U32M)


class _Diag:
    __slots__ = ("vd", "k", "xo", "t")

    def __init__(self, vd, k, xo, t):
        self.vd = vd
        self.k = k
        self.xo = xo & U32M
        self.t = t


def _extend1(d: int, k: int, vl: int, ts: bytes, ql: int, qs: bytes) -> int:
    """Exact-match extension along one diagonal (gwf_extend1)."""
    max_k = (ql - d if ql - d < vl else vl) - 1
    n = max_k - k
    if n <= 0:
        return k
    a = ts[k + 1: max_k + 1]
    b = qs[d + k + 1: d + max_k + 1]
    if a == b:
        return max_k
    av = np.frombuffer(a, dtype=np.uint8)
    bv = np.frombuffer(b, dtype=np.uint8)
    return k + int(np.argmax(av != bv))


class GwfBuf:
    def __init__(self, traceback: bool):
        self.ha = set()          # (w, i) visited pairs
        self.ht = {}             # (v, pre) -> trace index
        self.intv: List[Tuple[int, int]] = []
        self.tmp: List[Tuple[int, int]] = []
        self.trace: List[Tuple[int, int]] = []
        self.traceback = traceback

    def trace_push(self, v: int, pre: int) -> int:
        key = (v, pre)
        idx = self.ht.get(key)
        if idx is None:
            idx = len(self.trace)
            self.trace.append(key)
            self.ht[key] = idx
        return idx


def _intv_merge_adj(a: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    if not a:
        return []
    out = []
    st, en = a[0]
    for vd0, vd1 in a[1:]:
        if vd0 > en:
            out.append((st, en))
            st, en = vd0, vd1
        else:
            en = en if en > vd1 else vd1
    out.append((st, en))
    return out


def _dedup(buf: GwfBuf, b: List[_Diag]) -> List[_Diag]:
    """gwf_dedup (gfa-ed.c:265-278)."""
    if buf.intv or buf.tmp:
        tmp = buf.tmp
        if any(tmp[i - 1][0] > tmp[i][0] for i in range(1, len(tmp))):
            keys = np.asarray([t[0] for t in tmp], dtype=np.uint64)
            perm = radix_argsort(keys)
            tmp = [tmp[i] for i in perm]
        merged = []
        i = j = 0
        sw, tm = buf.intv, tmp
        while i < len(sw) and j < len(tm):
            if sw[i][0] <= tm[j][0]:
                merged.append(sw[i])
                i += 1
            else:
                merged.append(tm[j])
                j += 1
        merged.extend(sw[i:])
        merged.extend(tm[j:])
        buf.intv = _intv_merge_adj(merged)
        buf.tmp = []
    # diag dedup (gwf_diag_dedup)
    is_sorted = all(b[i - 1].vd <= b[i].vd for i in range(1, len(b)))
    if not is_sorted:
        inb = [p for p in b if not (p.xo & 1)]
        ooo = [p for p in b if p.xo & 1]
        keys = np.asarray([p.vd for p in ooo], dtype=np.uint64)
        perm = radix_argsort(keys)
        ooo = [ooo[i] for i in perm]
        for p in ooo:
            p.xo &= 0xFFFFFFFE
        merged = []
        i = j = 0
        while i < len(inb) and j < len(ooo):
            if inb[i].vd <= ooo[j].vd:
                merged.append(inb[i])
                i += 1
            else:
                merged.append(ooo[j])
                j += 1
        merged.extend(inb[i:])
        merged.extend(ooo[j:])
        b = merged
    out = []
    n = len(b)
    st = 0
    for i in range(1, n + 1):
        if i == n or b[i].vd != b[st].vd:
            max_j = st
            for j in range(st + 1, i):
                if b[max_j].k < b[j].k:
                    max_j = j
            out.append(b[max_j])
            st = i
    # mixed dedup with forbidden bands
    if buf.intv:
        res = []
        i = j = 0
        a = out
        iv = buf.intv
        while i < len(a) and j < len(iv):
            if iv[j][0] <= a[i].vd < iv[j][1]:
                i += 1
            elif a[i].vd >= iv[j][1]:
                j += 1
            else:
                res.append(a[i])
                i += 1
        res.extend(a[i:])
        out = res
    return out


def _prune(a: List[_Diag], max_lag: int, bw_dyn: int) -> List[_Diag]:
    """gwf_prune (gfa-ed.c:281-302)."""
    max_x = 0
    max_i = -1
    for i, p in enumerate(a):
        if (p.xo >> 1) > max_x:
            max_x = p.xo >> 1
            max_i = i
    q = a[max_i]
    iq = ((q.vd & U32M) - GWF_DIAG_SHIFT) + q.k
    dq = (q.xo >> 1) - iq - iq
    out = []
    for p in a:
        ip = ((p.vd & U32M) - GWF_DIAG_SHIFT) + p.k
        dp = (p.xo >> 1) - ip - ip
        w = dp - dq if dp > dq else dq - dp
        if bw_dyn >= 0 and w > bw_dyn:
            continue
        if (p.xo >> 1) + max_lag < max_x:
            continue
        out.append(p)
    return out


def _push(B: List[_Diag], v, d, k, x, ooo, t):
    B.append(_Diag(_gen_vd(v, d), k, ((x << 1) | ooo) & U32M, t))


def _update(p: _Diag, v, d, k, x, ooo, t) -> int:
    vd = _gen_vd(v, d)
    if p.vd == vd:
        if not (p.k > k):
            p.xo = ((x << 1) | ooo) & U32M
            p.t = t
            p.k = k
        return 0
    return 1


def _extend_batch(g, es, ql, q, a: List[_Diag], B: List[_Diag],
                  A: List[_Diag], buf: GwfBuf):
    """gwf_ed_extend_batch (gfa-ed.c:332-402): Landau-Vishkin over a run
    of consecutive diagonals within one vertex."""
    n = len(a)
    v = a[0].vd >> 32
    vl = es[v >> 1].len
    ts = es[v >> 1].fwd if (v & 1) == 0 else es[v >> 1].rc
    lens = []
    for p in a:
        k = _extend1((p.vd & U32M) - GWF_DIAG_SHIFT, p.k, vl, ts, ql, q)
        ln = k - p.k
        p.xo = (p.xo + (ln << 2)) & U32M
        p.k = k
    b: List[_Diag] = []
    b.append(_Diag(a[0].vd - 1, a[0].k + 1, (a[0].xo + 2) & U32M, a[0].t))
    if n == 1 or a[0].k > a[1].k:
        b.append(_Diag(a[0].vd, a[0].k + 1, (a[0].xo + 4) & U32M, a[0].t))
    else:
        b.append(_Diag(a[0].vd, a[1].k + 1, (a[1].xo + 2) & U32M, a[1].t))
    for j in range(1, n - 1):
        x = (a[j - 1].xo + 2) & U32M
        k = a[j - 1].k
        t = a[j - 1].t
        if not (k > a[j].k + 1):
            x = (a[j].xo + 4) & U32M
            t = a[j].t
            k = a[j].k + 1
        if not (k > a[j + 1].k + 1):
            x = (a[j + 1].xo + 2) & U32M
            t = a[j + 1].t
            k = a[j + 1].k + 1
        b.append(_Diag(a[j].vd, k, x, t))
    if n >= 2:
        if a[n - 2].k > a[n - 1].k + 1:
            b.append(_Diag(a[n - 1].vd, a[n - 2].k, (a[n - 2].xo + 2) & U32M,
                           a[n - 2].t))
        else:
            b.append(_Diag(a[n - 1].vd, a[n - 1].k + 1,
                           (a[n - 1].xo + 4) & U32M, a[n - 1].t))
    b.append(_Diag(a[n - 1].vd + 1, a[n - 1].k, (a[n - 1].xo + 2) & U32M,
                   a[n - 1].t))
    # out-of-bound handling
    for p in a:
        d = (p.vd & U32M) - GWF_DIAG_SHIFT
        if p.k == vl - 1 or d + p.k == ql - 1:
            p.xo |= 1
            A.append(_Diag(p.vd, p.k, p.xo, p.t))
    for p in b:
        d = (p.vd & U32M) - GWF_DIAG_SHIFT
        if d + p.k < ql and p.k < vl:
            B.append(p)
        elif p.k == vl:
            vd0 = _gen_vd(v, d)
            buf.tmp.append((vd0, vd0 + 1))


class GwfState:
    """Re-entrant GWFA state (gfa_ed_init/step, gfa-ed.c:552-593)."""

    def __init__(self, g, es, ql: int, q, v0: int, off0: int,
                 traceback: bool = True, max_chk: int = 1000,
                 bw_dyn: int = -1, max_lag: int = -1, i_term: int = -1):
        self.g = g
        self.es = es
        self.ql = ql
        self.q = q.encode("latin-1") if isinstance(q, str) else q
        self.buf = GwfBuf(traceback)
        self.traceback = traceback
        self.max_chk = max_chk
        self.bw_dyn = bw_dyn
        self.max_lag = max_lag
        self.i_term = i_term
        self.s = 0
        d0 = _Diag(_gen_vd(v0, -off0), off0 - 1, 0, 0)
        if traceback:
            d0.t = self.buf.trace_push(-1, -1)
        self.a: List[_Diag] = [d0]
        self.end_tb = -1

    # ------------------------------------------------------------------
    def _extend(self, v1: int, off1: int):
        """One score step (gwf_ed_extend).  Returns (found, end_v, end_off)."""
        g, es, ql, q = self.g, self.es, self.ql, self.q
        buf = self.buf
        a = self.a
        buf.tmp = []
        buf.ha = set()
        A: List[_Diag] = []
        B: List[_Diag] = []
        x = 0
        n = len(a)
        for i in range(1, n + 1):
            if i == n or a[i].vd != a[i - 1].vd + 1:
                _extend_batch(g, es, ql, q, a[x:i], B, A, buf)
                x = i
        do_dedup = len(A) > 0

        head = 0
        while head < len(A):
            t = A[head]
            head += 1
            ooo = t.xo & 1
            v = t.vd >> 32
            d = (t.vd & U32M) - GWF_DIAG_SHIFT
            k = t.k
            vl = es[v >> 1].len
            ts = es[v >> 1].fwd if (v & 1) == 0 else es[v >> 1].rc
            k = _extend1(d, k, vl, ts, ql, q)
            i = k + d
            x0 = ((t.xo >> 1) + ((k - t.k) << 1)) & U32M

            if k + 1 < vl and i + 1 < ql:
                push1 = push2 = 1
                if len(B) >= 2:
                    push1 = _update(B[-2], v, d - 1, k + 1, x0 + 1, ooo, t.t)
                if len(B) >= 1:
                    push2 = _update(B[-1], v, d, k + 1, x0 + 2, ooo, t.t)
                if push1:
                    _push(B, v, d - 1, k + 1, x0 + 1, 1, t.t)
                if push2 or push1:
                    _push(B, v, d, k + 1, x0 + 2, 1, t.t)
                _push(B, v, d + 1, k, x0 + 1, ooo, t.t)
            elif i + 1 < ql:  # end of vertex, not end of query
                st, cnt = g.arc_range(v)
                vd0 = _gen_vd(v, d)
                buf.tmp.append((vd0, vd0 + 1))
                tw = buf.trace_push(v, t.t) if self.traceback else -1
                n_ext = 0
                for ai in range(st, st + cnt):
                    w = int(g.arc_w[ai])
                    ol = self.g.arc[ai].ow
                    key = (w, i + 1)
                    absent = key not in buf.ha
                    buf.ha.add(key)
                    ws = es[w >> 1].fwd if (w & 1) == 0 else es[w >> 1].rc
                    if i + 1 < ql and ol < len(ws) and q[i + 1] == ws[ol]:
                        n_ext += 1
                        if absent:
                            A.append(_Diag(_gen_vd(w, i + 1 - ol), ol,
                                           (((x0 + 2) << 1) | 1) & U32M, tw))
                    elif absent:
                        _push(B, w, i - ol, ol, x0 + 1, 1, tw)
                        _push(B, w, i + 1 - ol, ol, x0 + 2, 1, tw)
                if cnt == 0 or n_ext != cnt:
                    _push(B, v, d + 1, k, x0 + 1, 1, t.t)
            elif v1 == 0xFFFFFFFF or (v == v1 and k == off1):
                self.end_tb = t.t
                self.a = []
                return True, v, k, x0 - i - 1
            elif k + 1 < vl:  # end of query, not end of vertex
                _push(B, v, d - 1, k + 1, x0 + 1, ooo, t.t)
            elif v != v1:
                st, cnt = g.arc_range(v)
                tw = buf.trace_push(v, t.t) if self.traceback else -1
                for ai in range(st, st + cnt):
                    w = int(g.arc_w[ai])
                    ow = self.g.arc[ai].ow
                    _push(B, w, i - ow, ow, x0 + 1, 1, tw)
            # else: banding corner case; do nothing

        if do_dedup:
            B = _dedup(buf, B)
        if self.max_lag > 0 and len(B) > self.max_chk \
                and ((self.s + 1) & 0xF) == 0:
            B = _prune(B, self.max_lag, self.bw_dyn)
        self.a = B
        return False, -1, -1, -1

    def step(self, v1: int, off1: int, s_term: int):
        """Run until the end condition (gfa_ed_step).  Returns
        (s, walk, end_v, end_off, wlen)."""
        n_iter = 0
        found = False
        end_v = end_off = wlen = -1
        while len(self.a) > 0:
            found, end_v, end_off, wlen = self._extend(v1, off1)
            n_iter += len(self.a)
            if found or len(self.a) == 0:
                break
            if s_term >= 0 and self.s >= s_term:
                break
            if self.i_term > 0 and n_iter > self.i_term:
                break
            self.s += 1
        walk = []
        if self.traceback and found:
            i = self.end_tb
            walk.append(end_v)
            while i >= 0 and self.buf.trace[i][0] >= 0:
                walk.append(self.buf.trace[i][0])
                i = self.buf.trace[i][1]
            walk.reverse()
        s = self.s if found else -1
        return s, walk, end_v, end_off, wlen


def gwfa_ed(g, es, qseq, v0: int, end0: int, v1: int, end1: int,
            max_ed: int):
    """Bridge-mode GWFA (bridge_gwfa parameters, gchain1.c:360-366)."""
    st = GwfState(g, es, len(qseq), qseq, v0, end0, traceback=True,
                  max_chk=1000, bw_dyn=1000, max_lag=max_ed // 2,
                  i_term=500000000)
    s, walk, _, _, _ = st.step(v1, end1, max_ed)
    return s, walk
