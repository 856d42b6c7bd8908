"""Minimizer index over a sequence graph.

Flat sorted-array layout instead of the reference's bucketed hash
(index.c:12-17): all (minimizer, position) records are sorted by
(minimizer, position); lookups binary-search the key array.  Lookup
results are identical — the reference also returns each minimizer's
positions sorted by position (index.c:156).  This layout is directly
usable as device gather tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..graph.gfa import Graph, revcomp
from .sketch import sketch


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

    # ------------------------------------------------------------------
    def get(self, minier: int) -> np.ndarray:
        """Positions (y records) of a minimizer, sorted by position."""
        i = np.searchsorted(self.keys, np.uint64(minier))
        if i >= len(self.keys) or self.keys[i] != np.uint64(minier):
            return _EMPTY
        s = self.key_start[i]
        return self.pos[s: s + self.key_cnt[i]]

    def get_many(self, miniers: np.ndarray):
        """Vectorized lookup: returns (start, count) per query minimizer
        (count 0 when absent)."""
        idx = np.searchsorted(self.keys, miniers)
        idx_c = np.minimum(idx, len(self.keys) - 1) if len(self.keys) else idx
        found = np.zeros(len(miniers), dtype=bool)
        if len(self.keys):
            found = self.keys[idx_c] == miniers
        start = np.where(found, self.key_start[idx_c] if len(self.keys) else 0, 0)
        cnt = np.where(found, self.key_cnt[idx_c] if len(self.keys) else 0, 0)
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


_EMPTY = np.empty(0, dtype=np.uint64)


def gfa_overlap(g: Graph) -> bool:
    return any(a.ov != 0 or a.ow != 0 for a in g.arc)


class IndexCache:
    """Per-segment sketch + edseq cache for DELTA re-indexing.

    The -cxggs loop re-indexes the whole graph after every sample
    (ggen.c:92), but augmentation only SPLITS segments and adds new
    ones — it never edits sequence (gfa-aug.c:93-175).  Keyed by the
    segment sequence itself, unchanged segments reuse their sketch
    records (the y records are rebased to the new segment id) and
    their forward/rc byte strings; only new or split segments are
    re-sketched.  The rebuilt flat tables are byte-identical to a
    from-scratch build because the per-segment sketch is a pure
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
    segments reuse cached sketches (delta re-index)."""
    if gfa_overlap(g):
        raise ValueError("graphs with overlapping segments are not supported")
    for s in g.seg:
        if s.seq is not None:
            s.seq = s.seq.upper()

    new_sk = {} if cache is not None else None
    xs_all, ys_all = [], []
    if cache is None:
        # parallel bucket-build analog (kt_for, index.c:207): one
        # pthread-pooled native call sketches every segment
        from .sketch import sketch_many
        live = [(i, s.seq) for i, s in enumerate(g.seg)
                if s.seq is not None and s.len > 0]
        many = sketch_many([s.encode("latin-1") for _, s in live],
                           w, k, [i for i, _ in live]) if live else []
        if many is not None:
            for (i, _), (x, y) in zip(live, many):
                xs_all.append(x)
                ys_all.append(y)
            live = None   # handled
        if many is None and live:
            for i, seq in live:
                x, y = sketch(seq, w, k, i)
                xs_all.append(x)
                ys_all.append(y)
    else:
        for i, s in enumerate(g.seg):
            if s.seq is None or s.len == 0:
                continue
            ck = IndexCache.key(s.seq)
            hit = cache.sk.get(ck)
            if hit is not None:
                x, y_low = hit
                y = y_low.astype(np.uint64) \
                    | (np.uint64(i) << np.uint64(32))
                cache.hits += 1
            else:
                x, y = sketch(s.seq, w, k, i)
                cache.misses += 1
            new_sk[ck] = (x, (y & np.uint64(0xFFFFFFFF)).astype(np.uint64))
            xs_all.append(x)
            ys_all.append(y)
    if cache is not None:
        cache.sk = new_sk  # drop entries for segments that disappeared
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
        # group boundaries on the now-sorted keys (np.unique would
        # sort AGAIN: ~12 s wasted at human scale)
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
    new_es = {} if cache is not None else None
    for s in g.seg:
        ck = IndexCache.key(s.seq or "") if cache is not None else None
        es = cache.es.get(ck) if cache is not None else None
        if es is None:
            fwd = (s.seq or "").encode("latin-1")
            es = EdSeq(fwd=fwd,
                       rc=revcomp(s.seq or "").encode("latin-1"),
                       len=s.len)
        if cache is not None:
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
