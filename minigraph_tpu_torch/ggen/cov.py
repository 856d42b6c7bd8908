"""Coverage annotation (cal_cov.c): per-read streaming coverage and
assembly merged-interval breadth, written back as dc:f / cf:f tags."""
from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from ..graph.augment import find_arc
from ..graph.gfa import AuxTag, Graph


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


def cov_map(g: Graph, gt, min_mapq: int, min_blen: int,
            c_seg: np.ndarray, c_link: np.ndarray, qname: str) -> None:
    """Streaming per-read segment/link coverage (mg_cov_map, cal_cov.c:8)."""
    if c_seg is None and c_link is None:
        return
    if gt is None or gt.n_gc == 0:
        return
    for gc in gt.gc:
        assert gc.cnt > 0 and gc.n_anchor > 0
        if gc.mapq < min_mapq or gc.blen < min_blen:
            continue
        for j in range(gc.cnt):
            lc = gt.lc[gc.off + j]
            s, e = 0, g.seg[lc.v >> 1].len
            if j == 0:
                s = _i32(int(gt.ax[lc.off])) + 1 \
                    - ((int(gt.ay[lc.off]) >> 32) & 0xFF)
            if j == gc.cnt - 1:
                e = _i32(int(gt.ax[lc.off + lc.cnt - 1])) + 1
            if c_seg is not None:
                c_seg[lc.v >> 1] += (e - s) / g.seg[lc.v >> 1].len
        assert gt.lc[gc.off].cnt > 0
        last_an = gt.lc[gc.off].off + gt.lc[gc.off].cnt - 1
        for j in range(1, gc.cnt):
            lc0 = gt.lc[gc.off + j - 1]
            lc1 = gt.lc[gc.off + j]
            if lc1.cnt > 0:
                curr = lc1.off
                seg_cur = (int(gt.ay[curr]) >> 48) & 0xFF
                seg_last = (int(gt.ay[last_an]) >> 48) & 0xFF
                is_skip = seg_cur != seg_last
                last_an = lc1.off + lc1.cnt - 1
                if is_skip:
                    continue
            a01 = find_arc(g, lc0.v, lc1.v)
            a10 = find_arc(g, lc1.v ^ 1, lc0.v ^ 1)
            if a01 < 0 or a10 < 0:
                sys.stderr.write(
                    f"[W] Multi/disconnected link: "
                    f"{'><'[lc0.v & 1]}{g.seg[lc0.v >> 1].name}[{lc0.v}] -> "
                    f"{'><'[lc1.v & 1]}{g.seg[lc1.v >> 1].name}[{lc1.v}] "
                    f"({qname}, {a01}, {a10}). Continue anyway!\n")
                continue
            assert (g.arc[a01].comp ^ g.arc[a10].comp) == 1
            if c_link is not None:
                c_link[a01] += 1.0
                c_link[a10] += 1.0


def cov_asm(g: Graph, n_seq: int, gcs, min_mapq: int, min_blen: int,
            cov_seg: np.ndarray, cov_link: np.ndarray) -> None:
    """Assembly mode: merged-interval breadth per segment, binary per
    link (mg_cov_asm, cal_cov.c:55-139).

    NB: the reference's chain loop never increments its index
    (cal_cov.c:88), an infinite-loop bug; we iterate every chain.
    """
    s_iv: List[List] = [[] for _ in range(g.n_seg)]
    cnt_link = np.zeros(g.n_arc, dtype=np.int64)
    for t in range(n_seq):
        gt = gcs[t]
        if gt is None or gt.n_gc == 0:
            continue
        for gc in gt.gc:
            assert gc.cnt > 0 and gc.n_anchor > 0
            if gc.mapq < min_mapq or gc.blen < min_blen:
                continue
            for j in range(gc.cnt):
                lc = gt.lc[gc.off + j]
                length = g.seg[lc.v >> 1].len
                s, e = 0, length
                if j == 0:
                    s = _i32(int(gt.ax[lc.off])) + 1 \
                        - ((int(gt.ay[lc.off]) >> 32) & 0xFF)
                if j == gc.cnt - 1:
                    e = _i32(int(gt.ax[lc.off + lc.cnt - 1])) + 1
                if lc.v & 1:
                    s, e = length - e, length - s
                s_iv[lc.v >> 1].append((s, e))
            for j in range(1, gc.cnt):
                lc0 = gt.lc[gc.off + j - 1]
                lc1 = gt.lc[gc.off + j]
                a01 = find_arc(g, lc0.v, lc1.v)
                a10 = find_arc(g, lc1.v ^ 1, lc0.v ^ 1)
                assert a01 >= 0 and a10 >= 0
                cnt_link[a01] += 1
                cnt_link[a10] += 1
    cov_link += (cnt_link > 0).astype(np.float64)
    for i in range(g.n_seg):
        iv = sorted(s_iv[i], key=lambda x: x[0])
        st = en = cov = 0
        for s, e in iv:
            if s > en:
                cov += en - st
                st, en = s, e
            else:
                en = max(en, e)
        cov += en - st
        cov_seg[i] += cov / g.seg[i].len


def aux_update_f(aux: List[AuxTag], tag: str, x: float) -> None:
    """gfa_aux_update_f (gfa-base.c:475): NB the lookup uses the literal
    'cv' tag, so an existing dc/cf value is appended, matching the C."""
    for t in aux:
        if t.tag == "cv":
            t.value = float(np.float32(x))
            return
    aux.append(AuxTag(tag, "f", float(np.float32(x))))


def aux_update_cv(g: Graph, tag: str, cov_seg, cov_link) -> None:
    """gfa_aux_update_cv (gfa-base.c:493-503)."""
    if cov_seg is not None:
        for i, s in enumerate(g.seg):
            aux_update_f(s.aux, tag, float(cov_seg[i]))
    if cov_link is not None:
        for i, a in enumerate(g.arc):
            if not a.comp:
                aux = g.link_aux.setdefault(a.link_id, [])
                aux_update_f(aux, tag, float(cov_link[i]))
