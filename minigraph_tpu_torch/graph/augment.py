"""Graph augmentation: insert diverged query regions into the graph
(gfa-aug.c).  This is the pangenome graph-construction engine: given
insertion events {graph end vertices, offsets, query contig span}, it
computes all split points, splits old segments (renaming everything
s1..sN), remaps old arcs, and adds new segments for the inserted query
subsequences with rank = max_rank+1."""
from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np

from ..utils.ksort import radix_argsort
from .gfa import Arc, Graph, Segment, COMP_TABLE


class InsEvent:
    """gfa_ins_t (gfa.h:110-114)."""
    __slots__ = ("v", "voff", "coff", "ctg")

    def __init__(self, v0=0, v1=0, voff0=0, voff1=0, coff0=0, coff1=0, ctg=0):
        self.v = [v0, v1]
        self.voff = [voff0, voff1]
        self.coff = [coff0, coff1]
        self.ctg = ctg


def _seg_base(g: Graph, v: int, j: int) -> str:
    s = g.seg[v >> 1]
    if (v & 1) == 0:
        return s.seq[j]
    return chr(COMP_TABLE[ord(s.seq[s.len - 1 - j])])


def ins_shrink_semi(g: Graph, pen: int, v: int, voff: int, coff: int,
                    vv: int, vend: int, cend: int, seq: str) -> int:
    """X-drop shrink of one event end over matching bases
    (gfa_ins_shrink_semi, gfa-aug.c:195-211)."""
    if cend == coff:
        return 0
    dir_ = 1 if cend > coff else -1
    i, j = coff, voff
    l = max_l = 0
    score = mx = 0
    vlen = g.seg[v >> 1].len
    while i != cend:
        if j == vlen or j == -1:
            break
        if vv == v and j == vend:
            break
        l += 1
        cg = _seg_base(g, v, j)
        score += 1 if cg.lower() == seq[i].lower() else -pen
        if score > mx:
            mx, max_l = score, l
        if score < mx - pen * pen:
            break
        i += dir_
        j += dir_
    return max_l


def ins_adj(g: Graph, pen: int, ins: InsEvent, seq: str) -> int:
    """gfa_ins_adj (gfa-aug.c:213-221)."""
    tot = 0
    l = ins_shrink_semi(g, pen, ins.v[0], ins.voff[0], ins.coff[0],
                        ins.v[1], ins.voff[1], ins.coff[1], seq)
    ins.voff[0] += l
    ins.coff[0] += l
    tot += l
    l = ins_shrink_semi(g, pen, ins.v[1], ins.voff[1] - 1, ins.coff[1] - 1,
                        ins.v[0], ins.voff[0] - 1, ins.coff[0] - 1, seq)
    ins.voff[1] -= l
    ins.coff[1] -= l
    tot += l
    return tot


def find_arc(g: Graph, v: int, w: int) -> int:
    """gfa_find_arc (gfa-priv.h:141-148): index if unique, -1 absent,
    -2 multiple."""
    st, cnt = g.arc_range(v)
    nw = 0
    k = -1
    for i in range(st, st + cnt):
        if g.arc[i].w == w:
            nw += 1
            k = i
    return k if nw == 1 else (-1 if nw == 0 else -2)


def _check_multi(g: Graph, ins: InsEvent) -> bool:
    """check_multi (gfa-aug.c:223-237)."""
    if ins.v[0] != ins.v[1] and ins.coff[1] - ins.coff[0] == 0:
        s0 = g.seg[ins.v[0] >> 1]
        s1 = g.seg[ins.v[1] >> 1]
        if ins.voff[0] != 0 and ins.voff[0] != s0.len:
            return False
        if ins.voff[1] != 0 and ins.voff[1] != s1.len:
            return False
        v0 = ins.v[0] ^ 1 if ins.voff[0] == 0 else ins.v[0]
        v1 = ins.v[1] if ins.voff[1] == 0 else ins.v[1] ^ 1
        return find_arc(g, v0, v1) >= 0
    return False


def ins_filter(g: Graph, ins: List[InsEvent]) -> List[InsEvent]:
    """Drop impossible/multi-link events (gfa_ins_filter, gfa-aug.c:239)."""
    out = []
    for p in ins:
        ok = True
        for k in range(2):
            vlen = g.seg[p.v[k] >> 1].len
            side = ((vlen - p.voff[k] if p.v[k] & 1 else p.voff[k]) << 1) \
                | ((p.v[k] & 1) ^ k)
            if side == 0 or side == (vlen << 1 | 1):
                ok = False
                break
        if not ok or _check_multi(g, p):
            sys.stderr.write(
                f"[W::ins_filter] {'impossible insert' if not ok else 'multi-link'}"
                f" between {'><'[p.v[0] & 1]}{g.seg[p.v[0] >> 1].name} and "
                f"{'><'[p.v[1] & 1]}{g.seg[p.v[1] >> 1].name} derived from the "
                f"{p.ctg}-th query at {p.coff[0]}-{p.coff[1]}\n")
            continue
        out.append(p)
    return out


def _create_first_arc(g: Graph, seg: List[Segment], v: int, w: int,
                      rank: int) -> None:
    """Arc pair with lv preset to the full segment length
    (create_first_arc, gfa-aug.c:28-33)."""
    link_id = len(g.arc)
    a = Arc(v_lv=(v << 32) | seg[v >> 1].len, w=w, rank=rank, ov=0, ow=0,
            link_id=link_id, comp=False)
    g.arc.append(a)
    b = Arc(v_lv=((w ^ 1) << 32) | seg[(w ^ 1) >> 1].len, w=v ^ 1, rank=rank,
            ov=0, ow=0, link_id=link_id, comp=True)
    g.arc.append(b)


def augment(g: Graph, ins: List[InsEvent], names: List[str],
            seqs: List[str]) -> None:
    """gfa_augment (gfa-aug.c:35-193)."""
    n_ins = len(ins)
    if n_ins <= 0 or len(names) <= 0:
        return
    n_old_arc = len(g.arc)
    # collect split sides per segment: (side, ins_index, end)
    per_seg: List[List[Tuple[int, int, int]]] = [[] for _ in range(g.n_seg)]
    n_ctg_seg = 0
    for i, p in enumerate(ins):
        for k in range(2):
            vlen = g.seg[p.v[k] >> 1].len
            side = ((vlen - p.voff[k] if p.v[k] & 1 else p.voff[k]) << 1) \
                | ((p.v[k] & 1) ^ k)
            assert side != 0 and side != (vlen << 1 | 1)
            per_seg[p.v[k] >> 1].append((side, i, k))
        if p.coff[1] > p.coff[0]:
            n_ctg_seg += 1
    for j in range(g.n_seg):
        if len(per_seg[j]) > 1:
            keys = np.asarray([x[0] for x in per_seg[j]], dtype=np.uint64)
            perm = radix_argsort(keys)
            per_seg[j] = [per_seg[j][i] for i in perm]

    # split old segments
    seg: List[Segment] = []
    ins_side = [0] * n_ins
    oldcnt = []
    for j in range(g.n_seg):
        s = g.seg[j]
        k0 = len(seg)
        t = Segment(name=f"s{len(seg) + 1}", snid=s.snid, soff=s.soff,
                    rank=s.rank)
        seg.append(t)
        off = 0
        sp = per_seg[j]
        i0 = 0
        for i in range(1, len(sp) + 1):
            if i == len(sp) or (sp[i][0] >> 1) != (sp[i0][0] >> 1):
                for l in range(i0, i):
                    side, ins_i, end = sp[l]
                    shift = 32 if end == 0 else 0
                    sd = side & 1
                    k_cur = len(seg) - 1
                    which = 0 if (side >> 1) == 0 else sd
                    ins_side[ins_i] |= ((((k_cur + which) << 1) | (sd ^ end))
                                        & 0xFFFFFFFF) << shift
                if (sp[i0][0] >> 1) != 0 and (sp[i0][0] >> 1) != s.len:
                    t.len = (sp[i0][0] >> 1) - off
                    t.seq = s.seq[off: off + t.len]
                    off += t.len
                    t = Segment(name=f"s{len(seg) + 2}", snid=s.snid,
                                soff=s.soff + off, rank=s.rank)
                    seg.append(t)
                    t.name = f"s{len(seg)}"
                i0 = i
        t.len = s.len - off
        t.seq = s.seq[off:] if s.seq is not None else ""
        oldcnt.append((k0, len(seg) - k0))
        for i in range(len(seg) - k0 - 1):
            _create_first_arc(g, seg, (k0 + i) << 1, (k0 + i + 1) << 1, s.rank)
    n_old_seg = len(seg)

    # update existing arcs to attach to the outermost split pieces
    for t_i in range(n_old_arc):
        a = g.arc[t_i]
        v = a.v_lv >> 32
        off, cnt = oldcnt[v >> 1]
        v = ((off + cnt - 1) << 1) if (v & 1) == 0 else ((off << 1) | 1)
        a.v_lv = (v << 32) | seg[v >> 1].len
        off, cnt = oldcnt[a.w >> 1]
        a.w = (off << 1) if (a.w & 1) == 0 else (((off + cnt - 1) << 1) | 1)

    # create newly inserted segments
    for i, p in enumerate(ins):
        if p.coff[0] < p.coff[1]:
            k = len(seg)
            t = Segment(name=f"s{k + 1}")
            t.seq = seqs[p.ctg][p.coff[0]: p.coff[1]]
            t.len = len(t.seq)
            t.snid = g.sseq_add(names[p.ctg])
            t.soff = p.coff[0]
            t.rank = g.max_rank + 1
            seg.append(t)
            g.sseq_update(t)
            _create_first_arc(g, seg, ins_side[i] >> 32, k << 1, t.rank)
            _create_first_arc(g, seg, k << 1, ins_side[i] & 0xFFFFFFFF, t.rank)
        else:
            _create_first_arc(g, seg, ins_side[i] >> 32,
                              ins_side[i] & 0xFFFFFFFF, g.max_rank + 1)

    # swap in the new segment array
    g.seg = seg
    g.name2id = {s.name: i for i, s in enumerate(seg)}
    g.max_rank += 1
    # drop aux of removed links (link_aux entries for old arcs survive by id)
    g.arc_sort()
    g.arc_index()
    g.fix_multi()
    g._build_views()
