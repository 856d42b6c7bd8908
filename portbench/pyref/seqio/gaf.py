"""GAF/PAF record serialization (mg_write_gaf, format.c:121-291)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..graph.gfa import COMP_TABLE, Graph
from ..mapping.gchain import GChains
from ..options import (MG_M_FRAG_MERGE, MG_M_NO_COMP_PATH, MG_M_PRINT_2ND,
                       MG_M_SHOW_UNMAP, MG_M_VERTEX_COOR, MG_M_WRITE_LCHAIN,
                       MG_M_WRITE_MZ)


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


def _fmt_div(div: float) -> str:
    if div == 0.0:
        return "0"
    return f"{float(div):.4f}"[:15]


def write_gaf(g: Graph, gs: Optional[GChains], n_seg: int, qlens: List[int],
              qname: str, flag: int) -> str:
    """Serialize all chains of one query to GAF/PAF text."""
    if gs is not None:
        txt = getattr(gs, "gaf_text", None)
        if txt is not None:
            # serialized natively off the chain tables (mgt_gaf.c)
            return txt
    out: List[str] = []
    qlen = sum(qlens)
    if (gs is None or gs.n_gc == 0) and (flag & MG_M_SHOW_UNMAP):
        name = qname
        if (flag & MG_M_FRAG_MERGE) and n_seg == 2 and len(name) > 2 \
                and name[-1] == "1" and name[-2] == "/":
            name = name[:-2]
        return f"{name}\t{qlen}\t0\t0\t*\t*\t0\t0\t0\t0\t0\t0\n"
    if gs is None:
        return ""
    for p in gs.gc:
        if p.id != p.parent and not (flag & MG_M_PRINT_2ND):
            continue
        if p.cnt == 0:
            continue
        s: List[str] = []
        rev_sign = 0
        name = qname
        if (flag & MG_M_FRAG_MERGE) and n_seg == 2 and len(name) > 2 \
                and name[-1] == "1" and name[-2] == "/":
            name = name[:-2]
        s.append(f"{name}\t{qlen}\t{p.qs}\t{p.qe}\t+\t")
        assert p.cnt > 0
        sign_idx = 0  # position of '+' within s (patched for compact rev)
        if flag & MG_M_VERTEX_COOR:
            compact = 0
            for j in range(p.cnt):
                q = gs.lc[p.off + j]
                s.append(f"{'><'[q.v & 1]}{g.seg[q.v >> 1].name}")
        else:
            last_pnid, st, en, rev = -1, -1, -1, -1
            compact = 0 if (flag & MG_M_NO_COMP_PATH) else 1
            for j in range(p.cnt):
                q = gs.lc[p.off + j]
                t = g.seg[q.v >> 1]
                if t.snid < 0:
                    compact = 0
                    if last_pnid >= 0:
                        s.append(f"{'><'[rev]}{g.sseq[last_pnid].name}:{st}-{en}")
                    last_pnid, st, en, rev = -1, -1, -1, -1
                    s.append(f"{'><'[q.v & 1]}{t.name}")
                else:
                    cont = 0
                    if last_pnid >= 0 and t.snid == last_pnid and (q.v & 1) == rev:
                        if not (q.v & 1):
                            if t.soff == en:
                                en = t.soff + t.len
                                cont = 1
                        else:
                            if t.soff + t.len == st:
                                st = t.soff
                                cont = 1
                    if cont == 0:
                        if last_pnid >= 0:
                            compact = 0
                            s.append(f"{'><'[rev]}{g.sseq[last_pnid].name}:{st}-{en}")
                        last_pnid, rev = t.snid, q.v & 1
                        st = t.soff
                        en = st + t.len
            if last_pnid >= 0:
                if g.sseq[last_pnid].rank != 0 or g.sseq[last_pnid].min != 0:
                    compact = 0
                if not compact:
                    s.append(f"{'><'[rev]}{g.sseq[last_pnid].name}:{st}-{en}")
            else:
                compact = 0
        if compact:
            rev = gs.lc[p.off].v & 1
            t = g.seg[gs.lc[p.off + p.cnt - 1 if rev else p.off].v >> 1]
            ps = g.sseq[t.snid]
            s.append(f"{ps.name}\t{ps.max}\t")
            if rev:
                rev_sign = 1
                s[0] = s[0][:-2] + "-\t"  # flip the strand sign
                s.append(f"{t.soff + (p.plen - p.pe)}\t{t.soff + (p.plen - p.ps)}")
            else:
                s.append(f"{t.soff + p.ps}\t{t.soff + p.pe}")
        else:
            s.append(f"\t{p.plen}\t{p.ps}\t{p.pe}")
        if p.p is not None:
            s.append(f"\t{p.p.mlen}\t{p.p.blen}\t{p.mapq}")
        else:
            s.append(f"\t{p.mlen}\t{p.blen}\t{p.mapq}")
        s.append(f"\ttp:A:{'P' if p.id == p.parent else 'S'}")
        if p.p is not None:
            s.append(f"\tNM:i:{p.p.blen - p.p.mlen}")
        s.append(f"\tcm:i:{p.n_anchor}\ts1:i:{p.score}\ts2:i:{p.subsc}")
        if 0.0 <= p.div <= 1.0:
            s.append(f"\tdv:f:{_fmt_div(p.div)}")
        if n_seg > 1:
            s.append("\tql:B:i" + "".join(f",{x}" for x in qlens))
        if p.p is not None:
            ops = "MIDNSHP=XB"
            s.append("\tcg:Z:")
            rng = range(p.p.n_cigar - 1, -1, -1) if rev_sign else range(p.p.n_cigar)
            for j in rng:
                c = p.p.cigar[j]
                s.append(f"{c >> 4}{ops[c & 0xF]}")
        if p.ds is not None and p.ds.ds:
            s.append("\tds:Z:")
            if rev_sign:
                ds = p.ds.ds
                for i in range(p.ds.n_off - 1, -1, -1):
                    off = p.ds.off[i]
                    s.append(ds[off])
                    en2 = p.ds.off[i + 1] if i < p.ds.n_off - 1 else p.ds.len
                    if ds[off] == ":":
                        s.append(ds[off + 1: en2])
                    elif ds[off] == "*":
                        s.append("".join(chr(COMP_TABLE[ord(c)])
                                         for c in ds[off + 1: en2]))
                    else:
                        for j in range(en2 - 1, off, -1):
                            if ds[j] == "[":
                                s.append("]")
                            elif ds[j] == "]":
                                s.append("[")
                            else:
                                s.append(chr(COMP_TABLE[ord(ds[j])]))
            else:
                s.append(p.ds.ds)
        s.append("\n")
        if flag & MG_M_WRITE_LCHAIN:
            _write_lchain_lines(s, g, gs, p, flag)
        out.append("".join(s))
    return "".join(out)


def _write_lchain_lines(s: List[str], g: Graph, gs: GChains, p, flag: int) -> None:
    """-S / --write-mz linear-chain dump lines (format.c:252-289)."""
    import math
    for j in range(p.cnt):
        lc = gs.lc[p.off + j]
        s.append(f"*\t{'><'[lc.v & 1]}{g.seg[lc.v >> 1].name}"
                 f"\t{g.seg[lc.v >> 1].len}\t{lc.cnt}")
        if lc.cnt > 0:
            q_span = (int(gs.ay[lc.off]) >> 32) & 0xFF
            n = (int(gs.ax[lc.off + lc.cnt - 1]) >> 32) \
                - (int(gs.ax[lc.off]) >> 32) + 1
            if n == lc.cnt:
                div = 0.0
            elif n > lc.cnt:
                div = math.log(n / lc.cnt) / q_span
            else:
                div = math.log(lc.cnt / n) / q_span
            s.append(f"\t{_fmt_div(div)}")
            s.append(f"\t{_i32(int(gs.ax[lc.off])) + 1 - q_span}"
                     f"\t{_i32(int(gs.ax[lc.off + lc.cnt - 1])) + 1}")
            s.append(f"\t{_i32(int(gs.ay[lc.off])) + 1 - q_span}"
                     f"\t{_i32(int(gs.ay[lc.off + lc.cnt - 1])) + 1}")
            if flag & MG_M_WRITE_MZ:
                last = _i32(int(gs.ax[lc.off])) + 1 - q_span
                s.append(f"\t{q_span}\t")
                for i in range(1, lc.cnt):
                    x = _i32(int(gs.ax[lc.off + i])) + 1 - q_span
                    if i > 1:
                        s.append(",")
                    s.append(str(x - last))
                    last = x
                last = _i32(int(gs.ay[lc.off])) + 1 - q_span
                s.append("\t")
                for i in range(1, lc.cnt):
                    x = _i32(int(gs.ay[lc.off + i])) + 1 - q_span
                    if i > 1:
                        s.append(",")
                    s.append(str(x - last))
                    last = x
        s.append("\n")
