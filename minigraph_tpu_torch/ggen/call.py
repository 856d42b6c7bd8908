"""Per-sample path calls through graph bubbles → BED
(mg_call_asm, asm-call.c:21-147)."""
from __future__ import annotations

import sys
from typing import List, Optional

from ..graph.bubbles import find_bubbles
from ..graph.gfa import Graph
from .ggsimple import gc_index


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


def call_asm(g: Graph, n_seq: int, seqs, gcs, min_mapq: int, min_blen: int,
             out=sys.stdout) -> None:
    max_acnt, a_dens, sintv, qintv = gc_index(
        g, n_seq, gcs, min_mapq, min_blen >> 1, min_blen)
    if max_acnt == 0:
        return

    bb = find_bubbles(g)
    n_bb = len(bb)
    # stem marking
    bid = [0] * g.n_seg
    is_stem = [0] * g.n_seg
    is_src = [0] * g.n_seg
    ba = [None] * n_bb  # (t, i, st, en, strand, qs, qe, glen)
    for i, b in enumerate(bb):
        assert b.n_seg >= 2
        for v in b.v:
            bid[v >> 1] = i
        is_stem[b.v[0] >> 1] = is_stem[b.v[-1] >> 1] = 1
        is_src[b.v[0] >> 1] = 1

    for t in range(n_seq):
        gt = gcs[t]
        if gt is None:
            continue
        for i, gc in enumerate(gt.gc):
            st = -1
            for j in range(1, gc.cnt):
                lc = gt.lc[gc.off + j]
                prev = gt.lc[gc.off + j - 1]
                if not is_stem[lc.v >> 1] and is_stem[prev.v >> 1]:
                    st = gc.off + j
                elif (is_stem[lc.v >> 1] and not is_stem[prev.v >> 1]
                        and st > 0) or \
                        (is_stem[lc.v >> 1] and is_stem[prev.v >> 1]):
                    en = gc.off + j
                    if is_stem[lc.v >> 1] and is_stem[prev.v >> 1]:
                        st = gc.off + j  # two adjacent stems: a deletion
                    else:
                        assert en > st
                    span = (int(gt.ay[gt.lc[st].off]) >> 32) & 0xFF
                    qs = _i32(int(gt.ay[gt.lc[st - 1].off
                                        + gt.lc[st - 1].cnt - 1])) + 1
                    qe = _i32(int(gt.ay[gt.lc[en].off])) + 1 - span
                    n_ovlp = qintv[t].count_overlap(qs, qe)
                    if n_ovlp > 1:
                        continue
                    glen = 0
                    bad = False
                    for k in range(st, en):
                        seg = gt.lc[k].v >> 1
                        n_ovlp = sintv[seg].count_overlap(0, g.seg[seg].len)
                        glen += g.seg[seg].len
                        if n_ovlp > 1:
                            bad = True
                            break
                    if bad:
                        continue
                    assert is_stem[gt.lc[st - 1].v >> 1] \
                        and is_stem[gt.lc[en].v >> 1]
                    b0 = bid[gt.lc[st - 1].v >> 1]
                    b1 = bid[gt.lc[en].v >> 1]
                    if b0 < b1:
                        strand = 1
                    elif b0 > b1:
                        strand = -1
                    else:
                        if is_src[gt.lc[st - 1].v >> 1] \
                                + is_src[gt.lc[en].v >> 1] != 1:
                            sys.stderr.write(
                                f"[W::call] type-1 folded inversion alignment"
                                f" around {'><'[gt.lc[st].v & 1]}"
                                f"{g.seg[gt.lc[st].v >> 1].name} <=> "
                                f"{seqs[t].name}:{qs}-{qe}\n")
                            continue
                        strand = 1 if is_src[gt.lc[st - 1].v >> 1] else -1
                    the_bid = bid[gt.lc[st - 1].v >> 1] if strand > 0 \
                        else bid[gt.lc[en].v >> 1]
                    ok = True
                    for k in range(st, en):
                        if bid[gt.lc[k].v >> 1] != the_bid:
                            ok = False
                            break
                    if not ok:
                        sys.stderr.write(
                            f"[W::call] type-2 folded inversion alignment "
                            f"around {'><'[gt.lc[st].v & 1]}"
                            f"{g.seg[gt.lc[st].v >> 1].name} <=> "
                            f"{seqs[t].name}:{qs}-{qe}\n")
                        continue
                    ba[the_bid] = (t, i, st, en, strand, qs, qe, glen)

    lines = []
    for i, b in enumerate(bb):
        a = ba[i]
        s = [f"{g.sseq[b.snid].name}\t{b.ss}\t{b.se}\t"
             f"{'><'[b.v[0] & 1]}{g.seg[b.v[0] >> 1].name}\t"
             f"{'><'[b.v[-1] & 1]}{g.seg[b.v[-1] >> 1].name}\t"]
        if a is not None:
            t, gi_, st, en, strand, qs, qe, glen = a
            gt = gcs[t]
            assert strand != 0
            if st == en:
                s.append("*")
            elif strand > 0:
                for j in range(st, en):
                    v = gt.lc[j].v
                    s.append(f"{'><'[v & 1]}{g.seg[v >> 1].name}")
            else:
                for j in range(en - 1, st - 1, -1):
                    v = gt.lc[j].v
                    s.append(f"{'<>'[v & 1]}{g.seg[v >> 1].name}")
            s.append(f":{glen}:{'+' if strand > 0 else '-'}:"
                     f"{seqs[t].name}:{qs}:{qe}")
        else:
            s.append(".")
        lines.append("".join(s) + "\n")
    out.write("".join(lines))
