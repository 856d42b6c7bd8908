"""Sequence-graph substrate: the host-authoritative graph model and
GFA/rGFA/FASTA I/O.

Mirrors the semantics of the reference's gfa sub-library (gfa.h:87-101,
gfa-base.c, gfa-io.c) with an array-of-records host model plus derived
numpy (and later device) arrays.  A segment is a sequence; a vertex is
one side of a segment (vertex = seg_id<<1 | orientation); an arc is a
directed edge between vertices, stored together with its complement.
Arcs are sorted by (vertex<<32 | lv) and indexed per vertex.

Output is byte-compatible with `gfa_print` (gfa-io.c:339-395).
"""
from __future__ import annotations

import gzip
import re
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..utils.ksort import radix_argsort

INT32_MAX = 0x7FFFFFFF

# DNA complement table (IUPAC), same mapping as gfa_comp_table (gfa-base.c:509)
_COMP_SRC = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_COMP_DST = "TVGHEFCDIJMLKNOPQYSAABWXRZ"
COMP_TABLE = {}
for i in range(256):
    COMP_TABLE[i] = i
for a, b in zip(_COMP_SRC, _COMP_DST):
    COMP_TABLE[ord(a)] = ord(b)
    COMP_TABLE[ord(a.lower())] = ord(b.lower())
COMP_BYTES = bytes(COMP_TABLE[i] for i in range(256))


def comp_char(c: str) -> str:
    return chr(COMP_TABLE[ord(c)])


def revcomp(seq: str) -> str:
    return seq.encode("latin-1").translate(COMP_BYTES)[::-1].decode("latin-1")


@dataclass
class AuxTag:
    tag: str          # two characters
    type: str         # one of A i f Z B
    value: object     # str (A/Z), int (i), float32-as-float (f), (subtype, list) (B)


@dataclass
class Segment:
    name: str
    len: int = 0
    seq: Optional[str] = None
    snid: int = -1    # stable name id
    soff: int = -1    # stable offset
    rank: int = -1    # stable rank
    deleted: bool = False
    aux: List[AuxTag] = field(default_factory=list)


@dataclass
class StableSeq:
    name: str
    min: int = -1
    max: int = -1
    rank: int = -1


@dataclass
class Arc:
    v_lv: int         # vertex<<32 | lv
    w: int
    rank: int = -1
    ov: int = 0
    ow: int = 0
    link_id: int = 0
    strong: bool = False
    deleted: bool = False
    comp: bool = False

    @property
    def v(self) -> int:
        return self.v_lv >> 32

    @property
    def lv(self) -> int:
        return self.v_lv & 0xFFFFFFFF


class Graph:
    """Host-authoritative mutable sequence graph (gfa_t equivalent)."""

    def __init__(self):
        self.seg: List[Segment] = []
        self.name2id = {}
        self.sseq: List[StableSeq] = []
        self.sname2id = {}
        self.arc: List[Arc] = []
        self.link_aux = {}        # link_id -> List[AuxTag]
        self.idx: Optional[np.ndarray] = None   # (n_vtx, 2) [start, count]
        self.max_rank = 0
        # derived flat arrays (built by _build_views after finalize)
        self.arc_v: Optional[np.ndarray] = None
        self.arc_w: Optional[np.ndarray] = None
        self.arc_lv: Optional[np.ndarray] = None
        self.arc_rank: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    # basic accessors
    # ------------------------------------------------------------------
    @property
    def n_seg(self) -> int:
        return len(self.seg)

    @property
    def n_vtx(self) -> int:
        return len(self.seg) * 2

    @property
    def n_arc(self) -> int:
        return len(self.arc)

    def name_to_id(self, name: str) -> int:
        return self.name2id.get(name, -1)

    def arc_range(self, v: int) -> Tuple[int, int]:
        """(start, count) of arcs leaving vertex v in the sorted arc array."""
        row = self.idx[v]
        return int(row[0]), int(row[1])

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------
    def add_seg(self, name: str) -> int:
        sid = self.name2id.get(name)
        if sid is None:
            sid = len(self.seg)
            self.seg.append(Segment(name=name))
            self.name2id[name] = sid
        return sid

    def sseq_add(self, sname: str) -> int:
        sid = self.sname2id.get(sname)
        if sid is None:
            sid = len(self.sseq)
            self.sseq.append(StableSeq(name=sname))
            self.sname2id[sname] = sid
        return sid

    def sseq_update(self, s: Segment) -> None:
        if s.snid < 0 or s.snid >= len(self.sseq):
            return
        ps = self.sseq[s.snid]
        if ps.min < 0 or s.soff < ps.min:
            ps.min = s.soff
        if ps.max < 0 or s.soff + s.len > ps.max:
            ps.max = s.soff + s.len
        if ps.rank < 0:
            ps.rank = s.rank

    def add_arc1(self, v: int, w: int, ov: int, ow: int, link_id: int = -1,
                 comp: bool = False) -> Arc:
        a = Arc(v_lv=v << 32, w=w, ov=ov, ow=ow, rank=-1, comp=comp)
        if link_id >= 0:
            a.link_id = link_id
            a.rank = self.arc[link_id].rank if link_id < len(self.arc) else -1
        else:
            a.link_id = len(self.arc)
        self.arc.append(a)
        return a

    # ------------------------------------------------------------------
    # finalize / repair (gfa_finalize, gfa-base.c:421-430)
    # ------------------------------------------------------------------
    def arc_sort(self) -> None:
        keys = np.asarray([a.v_lv for a in self.arc], dtype=np.uint64)
        perm = radix_argsort(keys)
        # NB: arcs keep their link_id; self.link_aux is keyed by link_id
        self.arc = [self.arc[i] for i in perm]

    def arc_is_sorted(self) -> bool:
        return all(self.arc[i - 1].v_lv <= self.arc[i].v_lv
                   for i in range(1, len(self.arc)))

    def arc_index(self) -> None:
        idx = np.zeros((self.n_vtx, 2), dtype=np.int64)
        n = len(self.arc)
        last = 0
        for i in range(1, n + 1):
            if i == n or (self.arc[i - 1].v_lv >> 32) != (self.arc[i].v_lv >> 32):
                idx[self.arc[i - 1].v_lv >> 32] = (last, i - last)
                last = i
        self.idx = idx

    def _fix_no_seg(self) -> None:
        for s in self.seg:
            if s.len == 0:
                s.deleted = True
                sys.stderr.write(
                    f"[W] segment '{s.name}' is used on an L-line but not "
                    f"defined on an S-line\n")

    def _fix_semi_arc(self) -> None:
        """Infer missing overlap lengths from complement arcs (gfa-base.c:235)."""
        for v in range(self.n_vtx):
            st, cnt = self.arc_range(v)
            for i in range(st, st + cnt):
                av = self.arc[i]
                if av.deleted or (av.ow != INT32_MAX and av.ov != INT32_MAX):
                    continue
                w = av.w ^ 1
                wst, wcnt = self.arc_range(w)
                c = 0
                jv = -1
                for j in range(wst, wst + wcnt):
                    aw = self.arc[j]
                    if not aw.deleted and aw.w == (v ^ 1):
                        c += 1
                        jv = j
                is_multi = False
                if c == 1:
                    aw = self.arc[jv]
                    if av.ov != INT32_MAX and aw.ow != INT32_MAX and av.ov != aw.ow:
                        is_multi = True
                    if av.ow != INT32_MAX and aw.ov != INT32_MAX and av.ow != aw.ov:
                        is_multi = True
                if c == 1 and not is_multi:
                    aw = self.arc[jv]
                    if aw.ov != INT32_MAX:
                        av.ow = aw.ov
                    if aw.ow != INT32_MAX:
                        av.ov = aw.ow
                else:
                    sys.stderr.write("[W] can't infer overlap length\n")
                    av.deleted = True

    def _fix_symm_add(self) -> None:
        """Add or mark complement arcs (gfa-base.c:269)."""
        n_vtx = self.n_vtx
        for v in range(n_vtx):
            st, cnt = self.arc_range(v)
            for i in range(st, st + cnt):
                avi = self.arc[i]
                if avi.deleted or avi.comp:
                    continue
                wst, wcnt = self.arc_range(avi.w ^ 1)
                found = False
                for j in range(wst, wst + wcnt):
                    awj = self.arc[j]
                    if awj.deleted or awj.comp:
                        continue
                    if awj.w == (v ^ 1) and awj.ov == avi.ow and awj.ow == avi.ov:
                        awj.comp = True
                        awj.link_id = avi.link_id
                        found = True
                        break
                if not found:
                    a_new = self.add_arc1(avi.w ^ 1, v ^ 1, avi.ow, avi.ov,
                                          avi.link_id, comp=True)
                    a_new.rank = avi.rank

    def _fix_arc_len(self) -> None:
        for a in self.arc:
            v, w = a.v_lv >> 32, a.w
            sv = self.seg[v >> 1]
            if not sv.deleted and sv.len < a.ov:
                sys.stderr.write(
                    f"[W] overlap length longer than segment length for "
                    f"'{sv.name}': {a.ov} > {sv.len}\n")
                a.ov = sv.len
            if sv.deleted or self.seg[w >> 1].deleted:
                a.deleted = True
            else:
                a.v_lv |= (sv.len - a.ov) & 0xFFFFFFFF

    def _arc_rm(self) -> None:
        kept = []
        for a in self.arc:
            u, v = a.v_lv >> 32, a.w
            if not a.deleted and not self.seg[u >> 1].deleted \
                    and not self.seg[v >> 1].deleted:
                kept.append(a)
            else:
                self.link_aux.pop(a.link_id, None)
        if len(kept) < len(self.arc):
            self.idx = None
        self.arc = kept

    def cleanup(self) -> None:
        self._arc_rm()
        if not self.arc_is_sorted():
            self.arc_sort()
            self.idx = None
        if self.idx is None:
            self.arc_index()

    def fix_multi(self) -> int:
        """Remove duplicated links, preferring min rank (gfa-base.c:363)."""
        n_rm = 0
        for v in range(self.n_vtx):
            st, cnt = self.arc_range(v)
            buf = []
            for i in range(st, st + cnt):
                if not self.arc[i].deleted:
                    buf.append((self.arc[i].w << 32) | (i - st))
            if not buf:
                continue
            keys = np.asarray(buf, dtype=np.uint64)
            perm = radix_argsort(keys)
            buf = [buf[p] for p in perm]
            nb = len(buf)
            s = 0
            for i in range(1, nb + 1):
                if i == nb or (buf[i] >> 32) != (buf[s] >> 32):
                    if i - s > 1:
                        k = st + (buf[s] & 0xFFFFFFFF)
                        min_rank = self.arc[k].rank
                        for j in range(s + 1, i):
                            t = st + (buf[j] & 0xFFFFFFFF)
                            if self.arc[t].rank >= 0 and self.arc[t].rank < min_rank:
                                min_rank = self.arc[t].rank
                                k = t
                        if self.arc[k].w == (v ^ 1):
                            sys.stderr.write(
                                "[W] can't fix multiple edges due to '>v -- <v' "
                                f"involving segment {self.seg[v >> 1].name}\n")
                        else:
                            wst, wcnt = self.arc_range(self.arc[k].w ^ 1)
                            link_id = self.arc[k].link_id
                            n_rm += i - s - 1
                            for j in range(s + 1, i):
                                self.arc[st + (buf[j] & 0xFFFFFFFF)].deleted = True
                            for j in range(wst, wst + wcnt):
                                aw = self.arc[j]
                                if aw.w == (v ^ 1) and aw.link_id != link_id:
                                    aw.deleted = True
                    s = i
        if n_rm > 0:
            sys.stderr.write(f"[W::fix_multi] removed {n_rm} multiple link(s)\n")
            self._arc_rm()
            self.arc_index()
        return n_rm

    def finalize(self) -> None:
        self._fix_no_seg()
        self.arc_sort()
        self.arc_index()
        self._fix_semi_arc()
        self._fix_symm_add()
        self._fix_arc_len()
        self.cleanup()
        self._build_views()

    def _build_views(self) -> None:
        n = len(self.arc)
        self.arc_v = np.fromiter((a.v_lv >> 32 for a in self.arc), np.int64, n)
        self.arc_w = np.fromiter((a.w for a in self.arc), np.int64, n)
        self.arc_lv = np.fromiter((a.v_lv & 0xFFFFFFFF for a in self.arc), np.int64, n)
        self.arc_rank = np.fromiter((a.rank for a in self.arc), np.int64, n)
