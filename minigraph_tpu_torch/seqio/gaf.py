"""GAF record serialization of the per-read path (mg_write_gaf,
format.c:121-291), for the output flags the port admits
(mapper.py SUPPORTED_FLAGS) and single-segment reads without base-level
alignment (no -c)."""
from __future__ import annotations

from typing import List, Optional

from ..graph.gfa import Graph
from ..mapping.gchain import GChains
from ..options import MG_M_NO_COMP_PATH, MG_M_PRINT_2ND, MG_M_SHOW_UNMAP


def _fmt_div(div: float) -> str:
    if div == 0.0:
        return "0"
    return f"{float(div):.4f}"[:15]


def write_gaf(g: Graph, gs: Optional[GChains], n_seg: int, qlens: List[int],
              qname: str, flag: int) -> str:
    """Serialize all chains of one query to GAF text."""
    assert n_seg == 1, "the port maps single-segment reads only"
    if gs is not None:
        txt = getattr(gs, "gaf_text", None)
        if txt is not None:
            # serialized natively off the chain tables (mgt_gaf.c)
            return txt
    qlen = sum(qlens)
    if (gs is None or gs.n_gc == 0) and (flag & MG_M_SHOW_UNMAP):
        return f"{qname}\t{qlen}\t0\t0\t*\t*\t0\t0\t0\t0\t0\t0\n"
    if gs is None:
        return ""
    out: List[str] = []
    for p in gs.gc:
        if p.id != p.parent and not (flag & MG_M_PRINT_2ND):
            continue
        if p.cnt == 0:
            continue
        s: List[str] = [f"{qname}\t{qlen}\t{p.qs}\t{p.qe}\t+\t"]
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
                if last_pnid >= 0 and t.snid == last_pnid \
                        and (q.v & 1) == rev:
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
                        s.append(f"{'><'[rev]}{g.sseq[last_pnid].name}"
                                 f":{st}-{en}")
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
                s[0] = s[0][:-2] + "-\t"  # flip the strand sign
                s.append(f"{t.soff + (p.plen - p.pe)}"
                         f"\t{t.soff + (p.plen - p.ps)}")
            else:
                s.append(f"{t.soff + p.ps}\t{t.soff + p.pe}")
        else:
            s.append(f"\t{p.plen}\t{p.ps}\t{p.pe}")
        s.append(f"\t{p.mlen}\t{p.blen}\t{p.mapq}")
        s.append(f"\ttp:A:{'P' if p.id == p.parent else 'S'}")
        s.append(f"\tcm:i:{p.n_anchor}\ts1:i:{p.score}\ts2:i:{p.subsc}")
        if 0.0 <= p.div <= 1.0:
            s.append(f"\tdv:f:{_fmt_div(p.div)}")
        s.append("\n")
        out.append("".join(s))
    return "".join(out)
