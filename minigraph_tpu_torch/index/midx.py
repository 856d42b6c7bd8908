"""Minimizer index over a sequence graph.

Flat sorted-array layout instead of the reference's bucketed hash
(index.c:12-17): all (minimizer, position) records are sorted by
(minimizer, position), as the reference returns each minimizer's
positions (index.c:156).  ops/anchors.py turns these tables into the
device join tables.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..graph.gfa import Graph, revcomp
from ..utils import trace
from .sketch import sketch_many


@dataclass
class EdSeq:
    """Per-segment forward and reverse-complement sequence bytes
    (gfa_edseq_init equivalent; used by GWFA/CIGAR stages)."""
    fwd: bytes
    rc: bytes
    len: int


class MinimizerIndex:
    def __init__(self, g: Graph, k: int, w: int):
        self.g = g
        self.k = k
        self.w = w
        self.n_seg = g.n_seg
        # sorted flat tables
        self.keys: np.ndarray = np.empty(0, dtype=np.uint64)      # unique minimizers
        self.key_start: np.ndarray = np.empty(0, dtype=np.int64)
        self.key_cnt: np.ndarray = np.empty(0, dtype=np.int64)
        self.pos: np.ndarray = np.empty(0, dtype=np.uint64)       # y records
        self.es: List[EdSeq] = []

    def get_many(self, miniers: np.ndarray):
        """(start, count) of each query minimizer (count 0 when absent)."""
        if len(self.keys) == 0:
            z = np.zeros(len(miniers), dtype=np.int64)
            return z, z.copy()
        idx = np.minimum(np.searchsorted(self.keys, miniers),
                         len(self.keys) - 1)
        found = self.keys[idx] == miniers
        start = np.where(found, self.key_start[idx], 0)
        cnt = np.where(found, self.key_cnt[idx], 0)
        return start.astype(np.int64), cnt.astype(np.int64)

    def cal_quantile(self, fracs) -> List[int]:
        """Occurrence quantiles over distinct minimizers (index.c:74-93)."""
        counts = self.key_cnt.astype(np.uint32)
        n = len(counts)
        out = []
        for f in fracs:
            kk = int((1.0 - float(np.float32(f))) * n)
            if n == 0:
                out.append(0)
            else:
                kk = min(kk, n - 1)
                out.append(int(np.partition(counts, kk)[kk]))
        return out


def gfa_overlap(g: Graph) -> bool:
    return any(a.ov != 0 or a.ow != 0 for a in g.arc)


class IndexCache:
    """Per-segment sketch and edseq cache for delta re-indexing.

    Graph generation re-indexes the whole graph after every sample
    (ggen.c:92), but augmentation only splits segments and adds new ones;
    it never edits sequence (gfa-aug.c:93-175).  Keyed by the segment
    sequence, unchanged segments reuse their sketch records (the y
    records rebased to the new segment id) and their forward and
    reverse-complement strings; only new or split segments are sketched.
    The tables equal a build from scratch: a segment's sketch is a pure
    function of (seq, w, k)."""

    def __init__(self):
        self.sk = {}   # (len, hash) -> (x, y_low32)
        self.es = {}   # (len, hash) -> EdSeq
        self.hits = self.misses = 0

    @staticmethod
    def key(seq: str):
        return (len(seq), hash(seq))


def build_index(g: Graph, k: int, w: int, mo=None,
                cache: Optional[IndexCache] = None
                ) -> Optional[MinimizerIndex]:
    """Index the graph (mg_index, index.c:186-230): uppercases segment
    sequences in place, sketches every segment, builds the flat table,
    and updates dynamic occurrence options.  With `cache`, unchanged
    segments reuse their cached sketches (delta re-index).  Timed as
    the span setup.index."""
    with trace.span("setup.index"):
        return _build_index(g, k, w, mo, cache)


def _build_index(g, k, w, mo, cache):
    if gfa_overlap(g):
        raise ValueError("graphs with overlapping segments are not supported")
    for s in g.seg:
        if s.seq is not None:
            s.seq = s.seq.upper()

    # parallel bucket-build analog (kt_for, index.c:207): one
    # pthread-pooled native call sketches every segment (with a cache,
    # every segment not in it)
    live = [(i, s.seq) for i, s in enumerate(g.seg)
            if s.seq is not None and s.len > 0]
    sk = [None] * len(live)
    if cache is not None:
        for n, (i, seq) in enumerate(live):
            hit = cache.sk.get(IndexCache.key(seq))
            if hit is not None:
                sk[n] = (hit[0], hit[1] | (np.uint64(i) << np.uint64(32)))
        cache.hits = sum(x is not None for x in sk)
        cache.misses = len(live) - cache.hits
    todo = [n for n in range(len(live)) if sk[n] is None]
    many = sketch_many([live[n][1].encode("latin-1") for n in todo], w, k,
                       [live[n][0] for n in todo]) if todo else []
    for n, xy in zip(todo, many):
        sk[n] = xy
    if cache is not None:
        # drop the entries of segments that disappeared
        cache.sk = {IndexCache.key(seq): (x, y & np.uint64(0xFFFFFFFF))
                    for (_, seq), (x, y) in zip(live, sk)}
    xs_all = [x for x, _ in sk]
    ys_all = [y for _, y in sk]
    gi = MinimizerIndex(g, k, w)
    if xs_all:
        x = np.concatenate(xs_all)
        y = np.concatenate(ys_all)
        minier = x >> np.uint64(8)
        # y is globally ascending over the segment scan (rid<<32|pos),
        # so a stable sort on minier alone equals lexsort((y, minier)).
        # When key and ordinal fit one u64, sort the composite instead:
        # unique keys let np.sort's unstable radix/intro path run ~5x
        # faster than a stable 64-bit argsort.
        kbits = 2 * k
        nbits = max(int(len(minier) - 1).bit_length(), 1)
        if kbits + nbits <= 64:
            comp = (minier << np.uint64(nbits)) \
                | np.arange(len(minier), dtype=np.uint64)
            comp.sort()
            order = comp & np.uint64((1 << nbits) - 1)
        else:
            order = np.argsort(minier, kind="stable")
        minier = minier[order]
        gi.pos = y[order]
        # group boundaries on the now-sorted keys
        if len(minier):
            brk = np.empty(len(minier), dtype=bool)
            brk[0] = True
            np.not_equal(minier[1:], minier[:-1], out=brk[1:])
            start = np.nonzero(brk)[0]
            gi.keys = minier[start]
            gi.key_start = start.astype(np.int64)
            cnt = np.empty(len(start), dtype=np.int64)
            cnt[:-1] = start[1:] - start[:-1]
            cnt[-1] = len(minier) - start[-1]
            gi.key_cnt = cnt

    gi.es = []
    new_es = {}
    for s in g.seg:
        ck = IndexCache.key(s.seq or "") if cache is not None else None
        es = cache.es.get(ck) if cache is not None else None
        if es is None:
            es = EdSeq(fwd=(s.seq or "").encode("latin-1"),
                       rc=revcomp(s.seq or "").encode("latin-1"), len=s.len)
        new_es[ck] = es
        gi.es.append(es)
    if cache is not None:
        cache.es = new_es
    from ..utils.syslog import mlog
    mlog("mg_index", "indexed the graph")
    if mo is not None:
        from ..options import opt_update
        opt_update(gi, mo)
    return gi
