"""SCC linearization and bubble detection (gfa-bbl.c)."""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .gfa import Graph, revcomp

U32MAX = 0xFFFFFFFF
INT32_MAX = 0x7FFFFFFF


def sort_ref_arc(g: Graph) -> None:
    """Put the rank-0 reference-successor arc first per vertex
    (gfa_sort_ref_arc, gfa-bbl.c:11-33); required before --call."""
    for v in range(g.n_vtx):
        s = g.seg[v >> 1]
        if s.rank != 0:
            continue
        st, nv = g.arc_range(v)
        hit = -1
        for i in range(nv):
            w = g.arc[st + i].w
            t = g.seg[w >> 1]
            if t.rank == 0 and t.snid == s.snid and (v & 1) == (w & 1):
                if ((v & 1) == 0 and s.soff + s.len == t.soff) or \
                        ((v & 1) == 1 and t.soff + t.len == s.soff):
                    hit = i
                    break
        assert nv == 0 or hit >= 0
        if hit > 0:
            g.arc[st + hit], g.arc[st] = g.arc[st], g.arc[st + hit]
    g._build_views()


@dataclass
class SubV:
    v: int
    d: int = 0
    off: int = 0
    n: int = 0


@dataclass
class SubGraph:
    """gfa_sub_t: linearized subgraph from one SCC run."""
    v: List[SubV] = field(default_factory=list)
    a: List[int] = field(default_factory=list)   # dst_rank<<32 | arc_index
    is_dag: bool = True


class SccBuf:
    def __init__(self, g: Graph):
        n_vtx = g.n_vtx
        self.index = 0
        self.v_index = np.full(n_vtx, U32MAX, dtype=np.uint64)
        self.low = np.zeros(n_vtx, dtype=np.uint64)
        self.stack_flag = np.zeros(n_vtx, dtype=np.uint8)
        self.i = np.zeros(n_vtx, dtype=np.int64)
        self.start = np.full(n_vtx, U32MAX, dtype=np.uint64)


def scc1(g: Graph, b: SccBuf, v0: int) -> SubGraph:
    """Iterative Tarjan SCC producing a linearized subgraph
    (gfa_scc1, gfa-bbl.c:85-169)."""
    sub = SubGraph()
    ts: List[int] = []
    ds: List[int] = [v0 << 32]
    while ds:
        x = ds.pop()
        i = x & U32MAX
        v = x >> 32
        if i == 0:
            b.low[v] = b.v_index[v] = b.index
            b.index += 1
            b.stack_flag[v] = 1
            ts.append(v)
        st, nv = g.arc_range(v)
        if i == nv:
            if b.low[v] == b.v_index[v]:
                j = len(ts) - 1
                while ts[j] != v:
                    j -= 1
                for k in range(len(ts) - 1, j - 1, -1):
                    w = ts[k]
                    sub.v.append(SubV(v=w))
                    b.stack_flag[w] = 0
                del ts[j:]
            if ds:
                w = v
                v2 = ds[-1] >> 32
                if b.low[w] < b.low[v2]:
                    b.low[v2] = b.low[w]
        else:
            w = g.arc[st + i].w
            ds.append((v << 32) | (i + 1))
            if b.v_index[w] == U32MAX and b.stack_flag[w ^ 1] == 0:
                ds.append(w << 32)
            elif b.stack_flag[w]:
                if b.v_index[w] < b.low[v]:
                    b.low[v] = b.v_index[w]
    sub.v.reverse()
    for k, sv in enumerate(sub.v):
        b.start[sv.v] = v0
        b.i[sv.v] = k
    # fill adjacency restricted to this subgraph
    for k, sv in enumerate(sub.v):
        st, nv = g.arc_range(sv.v)
        o0 = len(sub.a)
        loc = []
        for i in range(nv):
            w = g.arc[st + i].w
            if b.start[w] == v0:
                loc.append((int(b.i[w]) << 32) | (st + i))
        loc.sort()  # uint64 sort; ties impossible (arc index unique)
        sub.a.extend(loc)
        sv.d = 0
        sv.off = o0
        sv.n = len(loc)
        if loc and (loc[0] >> 32) <= k:
            sub.is_dag = False
    return sub


@dataclass
class Bubble:
    """gfa_bubble_t (gfa-priv.h:32-38)."""
    snid: int
    vs: int
    ve: int
    ss: int
    se: int
    n_paths: int
    len_min: int
    len_max: int
    v: List[int]
    is_bidir: int = 0
    seq_min: str = ""
    seq_max: str = ""

    @property
    def n_seg(self):
        return len(self.v)


def _n_paths(g: Graph, sub: SubGraph, js: int, je: int) -> int:
    cnt = [0] * (je - js + 1)
    cnt[0] = 1
    for j in range(js, je):
        t = sub.v[j]
        for k in range(t.n):
            a = sub.a[t.off + k]
            jv = a >> 32
            if jv <= j or jv > je:
                continue
            if cnt[jv - js] + cnt[j - js] > INT32_MAX:
                cnt[jv - js] = INT32_MAX
            else:
                cnt[jv - js] += cnt[j - js]
    return min(cnt[je - js], INT32_MAX)


def _write_seq(g: Graph, vlist: List[int]) -> str:
    parts = []
    for v in reversed(vlist):
        s = g.seg[v >> 1]
        parts.append(revcomp(s.seq) if v & 1 else s.seq)
    return "".join(parts)


def find_bubbles(g: Graph) -> List[Bubble]:
    """Walk each stable sequence from its min-offset rank-0 segment and
    detect single-source/single-sink intervals (gfa_bubble,
    gfa-bbl.c:244-372)."""
    n_sseq = len(g.sseq)
    vs = [U32MAX] * n_sseq
    vmin = [U32MAX] * n_sseq
    for i, s in enumerate(g.seg):
        if s.rank != 0 or s.snid < 0:
            continue
        if s.soff < vmin[s.snid]:
            vmin[s.snid] = s.soff
            vs[s.snid] = i << 1
    out: List[Bubble] = []
    scbuf = SccBuf(g)
    for i in range(n_sseq):
        if vs[i] == U32MAX:
            continue
        sub = scc1(g, scbuf, vs[i])
        n_v = len(sub.v)
        sd = [INT32_MAX] * n_v
        ld = [0] * n_v
        sp = [-1] * n_v
        lp = [-1] * n_v
        sd[0] = 0
        for j in range(n_v):
            t = sub.v[j]
            for k in range(t.n):
                a = sub.a[t.off + k]
                jv = a >> 32
                l = g.arc[a & U32MAX].v_lv & U32MAX
                if jv <= j:
                    continue
                if sd[jv] >= sd[j] + l:
                    sd[jv] = sd[j] + l
                    sp[jv] = j
                if ld[jv] < ld[j] + l:
                    ld[jv] = ld[j] + l
                    lp[jv] = j
        jst = 0
        max_a = max_soff = -1
        for j in range(n_v):
            t = sub.v[j]
            if j == max_a and g.seg[t.v >> 1].soff > max_soff:
                sst = g.seg[sub.v[jst].v >> 1]
                sen = g.seg[t.v >> 1]
                if sst.snid == i and sen.snid == i:
                    b = Bubble(
                        snid=i,
                        vs=sub.v[jst].v,
                        ve=t.v,
                        ss=sst.soff + sst.len,
                        se=sen.soff,
                        len_min=sd[j] - sd[jst] - sst.len,
                        len_max=ld[j] - ld[jst] - sst.len,
                        n_paths=_n_paths(g, sub, jst, j),
                        v=[sub.v[k].v for k in range(jst, j + 1)],
                    )
                    assert b.len_min >= 0
                    assert b.len_max >= 0 and b.len_max >= b.len_min
                    segs = sorted(v >> 1 for v in b.v)
                    b.is_bidir = int(any(segs[k] == segs[k - 1]
                                         for k in range(1, len(segs))))
                    walk = []
                    k = j
                    while k > jst:
                        if k < j:
                            walk.append(sub.v[k].v)
                        k = sp[k]
                    b.seq_min = _write_seq(g, walk)
                    walk = []
                    k = j
                    while k > jst:
                        if k < j:
                            walk.append(sub.v[k].v)
                        k = lp[k]
                    b.seq_max = _write_seq(g, walk)
                    assert len(b.seq_min) == b.len_min
                    assert len(b.seq_max) == b.len_max
                    out.append(b)
                max_a = max_soff = -1
                jst = j
            for k in range(t.n):
                if (sub.a[t.off + k] >> 32) > max_a:
                    max_a = sub.a[t.off + k] >> 32
            if g.seg[t.v >> 1].snid == i and g.seg[t.v >> 1].soff > max_soff:
                max_soff = g.seg[t.v >> 1].soff
    return out
