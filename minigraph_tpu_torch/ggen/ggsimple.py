"""Incremental graph augmentation from assembly mappings
(mg_ggsimple / mg_ggsimple_cigar, ggsimple.c)."""
from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np

from ..align.wfa import WfOpt, wfa_exact
from ..graph.augment import InsEvent, augment, ins_adj, ins_filter
from ..graph.gfa import Graph, revcomp
from ..mapping.gchain import GChains
from ..options import (DBG, MG_DBG_INSERT, MG_G_NO_INV, MG_G_NO_QOVLP,
                       GGOptions)
from ..utils.algo import IntervalSet, mss_all


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


def wfa_cmp(s1: bytes, s2: bytes, max_pen: int) -> Tuple[int, int, int]:
    """mg_wfa_cmp (algo.c:177-194): returns (score, mlen, blen)."""
    opt = WfOpt(cigar=True, max_s=max_pen)
    r = wfa_exact(opt, s1, s2)
    mlen = blen = 0
    for c in (r.cigar or []):
        op, ln = c & 0xF, c >> 4
        blen += ln
        if op == 7:
            mlen += ln
    l1, l2 = len(s1), len(s2)
    score = -(l1 + l2) if r.s < 0 else (l1 + l2) // 2 - r.s
    return score, mlen, blen


def gc_index(g: Graph, n_seq: int, gcs: List[Optional[GChains]],
             min_mapq: int, min_map_len: int, min_depth_len: int):
    """Interval-index primary chains on query and graph segments; compute
    anchor density (mg_gc_index, ggsimple.c:11-101).

    Returns (max_acnt, a_dens, sintv[per seg], qintv[per seq])."""
    s_iv: List[List[Tuple[int, int]]] = [[] for _ in range(g.n_seg)]
    q_iv: List[List[Tuple[int, int]]] = [[] for _ in range(n_seq)]
    max_acnt = 0
    sum_acnt = sum_alen = 0
    for t in range(n_seq):
        gt = gcs[t]
        if gt is None:
            continue
        for gc in gt.gc:
            if gc.id != gc.parent:
                continue
            if gc.blen < min_depth_len or gc.mapq < min_mapq:
                continue
            if gc.n_anchor > max_acnt:
                max_acnt = gc.n_anchor
            q_iv[t].append((gc.qs, gc.qe))
            for j in range(gc.cnt):
                lc = gt.lc[gc.off + j]
                slen = g.seg[lc.v >> 1].len
                if lc.cnt > 0:
                    qs_x = int(gt.ax[lc.off])
                    qs_y = int(gt.ay[lc.off])
                    qe_x = int(gt.ax[lc.off + lc.cnt - 1])
                    rs0 = _i32(qs_x) + 1 - ((qs_y >> 32) & 0xFF)
                    re0 = _i32(qe_x)
                    assert rs0 >= 0 and re0 > rs0 and re0 < slen
                    sum_alen += re0 - rs0
                    sum_acnt += (qe_x >> 32) - (qs_x >> 32) + 1
                    rs, re = 0, slen
                    if j == 0:
                        rs = gc.p.ss if gc.p is not None else rs0
                    if j == gc.cnt - 1:
                        re = gc.p.ee if gc.p is not None else re0
                    if lc.v & 1:
                        rs, re = slen - re, slen - rs
                else:
                    rs, re = 0, slen
                s_iv[lc.v >> 1].append((rs, re))
    if max_acnt == 0:
        return 0, 0.0, None, None
    a_dens = sum_acnt / sum_alen
    sintv = [IntervalSet(iv) for iv in s_iv]
    qintv = [IntervalSet(iv) for iv in q_iv]
    return max_acnt, a_dens, sintv, qintv


def path2seq(g: Graph, gcs: GChains, ls: int, le: int,
             voff: List[int]) -> str:
    """Extract the path sequence over llchains [ls, le] (mg_path2seq,
    ggen.c:148-182)."""
    parts = []
    for k in range(ls, le + 1):
        v = gcs.lc[k].v
        length = g.seg[v >> 1].len
        st, en = 0, length
        if k == ls:
            st = voff[0]
        if k == le:
            en = voff[1]
        assert 0 <= st <= en <= length
        if v & 1:
            st2, en2 = length - en, length - st
            parts.append(revcomp(g.seg[v >> 1].seq[st2:en2]))
        else:
            parts.append(g.seg[v >> 1].seq[st:en])
    return "".join(parts)


def _common_event_filter(g: Graph, opt: GGOptions, gt: GChains, t: int,
                         seq, I: InsEvent, pd: int, loop_ls: int,
                         loop_le: int, path_ls: int, path_le: int,
                         seg_bounds, qintv, sintv,
                         fix_empty: bool) -> Optional[bool]:
    """Shared filtering + inversion test (ggsimple.c:209-246 / 465-506).

    Returns None to skip the event, else is_inv.  The graph-coverage
    loop runs over [loop_ls, loop_le] (pre-adjustment lchains in the
    CIGAR flavor, ggsimple.c:479) while path extraction uses the
    boundary-adjusted [path_ls, path_le]."""
    min_len = max(pd, I.coff[1] - I.coff[0])
    if I.coff[0] <= min_len or I.coff[1] >= len(seq.seq) - min_len:
        return None
    if I.coff[1] - I.coff[0] < opt.min_var_len and pd < opt.min_var_len:
        return None
    frag = seq.seq[I.coff[0]: I.coff[1]]
    if "n" in frag or "N" in frag:
        return None
    n_ovlp = qintv[t].count_overlap(I.coff[0], I.coff[1])
    if n_ovlp == 0:
        sys.stderr.write(f"[W::ggs] query interval {seq.name}:"
                         f"{I.coff[0]}-{I.coff[1]} is not covered\n")
    if n_ovlp != 1:
        return None
    for k in range(loop_ls, loop_le + 1):
        v = gt.lc[k].v
        length = g.seg[v >> 1].len
        s, e = seg_bounds(k, length)
        if v & 1:
            s, e = length - e, length - s
        if fix_empty and s == e:  # CIGAR flavor only (ggsimple.c:485-488)
            if s == 0:
                e += 1
            else:
                s -= 1
        n_ovlp = sintv[v >> 1].count_overlap(s, e)
        if n_ovlp == 0:
            sys.stderr.write(f"[W::ggs] graph interval "
                             f"{g.seg[v >> 1].name}:{s}-{e} is not covered\n")
        if n_ovlp != 1:
            return None
    is_inv = False
    if pd - (I.coff[1] - I.coff[0]) < opt.min_var_len \
            and (I.coff[1] - I.coff[0]) - pd < opt.min_var_len:
        qd = I.coff[1] - I.coff[0]
        pseq = path2seq(g, gt, path_ls, path_le, I.voff)
        qfrag = seq.seq[I.coff[0]: I.coff[0] + qd]
        score, mlen, blen = wfa_cmp(pseq.encode("latin-1"),
                                    qfrag.encode("latin-1"), 5000)
        if score > 0:
            if mlen > blen * opt.ggs_max_iden:
                return None
            if blen - mlen < opt.min_var_len * opt.ggs_max_iden:
                return None
        elif not (opt.flag & MG_G_NO_INV):
            rseq = revcomp(pseq)
            score, mlen, blen = wfa_cmp(rseq.encode("latin-1"),
                                        qfrag.encode("latin-1"), 5000)
            if score > 0 and mlen > blen * opt.ggs_min_inv_iden:
                is_inv = True
    if DBG["flag"] & MG_DBG_INSERT:  # ggsimple.c:247-257 stage dump
        qd = I.coff[1] - I.coff[0]
        pseq = path2seq(g, gt, path_ls, path_le, I.voff)
        sys.stderr.write(
            "IN\t[%c%s:%d,%c%s:%d|%d] <=> %s:[%d,%d|%d] inv:%d\n"
            % ("><"[I.v[0] & 1], g.seg[I.v[0] >> 1].name, I.voff[0],
               "><"[I.v[1] & 1], g.seg[I.v[1] >> 1].name, I.voff[1], pd,
               seq.name, I.coff[0], I.coff[1], qd, int(is_inv)))
        sys.stderr.write(f"IP\t{pseq}\nIQ\t"
                         + seq.seq[I.coff[0]: I.coff[1]])
        if pd - qd < opt.min_var_len and qd - pd < opt.min_var_len:
            score, mlen, blen = wfa_cmp(
                pseq.encode("latin-1"),
                seq.seq[I.coff[0]: I.coff[1]].encode("latin-1"), 5000)
        else:
            score, mlen, blen = -1, 0, max(pd, qd)
        sys.stderr.write(f"\nIS\t{pd}=={len(pseq)}\tnwcmp:{score}"
                         f"\tmlen:{mlen}\tblen:{blen}\n")
    return is_inv


def _emit(g: Graph, ins: List[InsEvent], I: InsEvent, is_inv: bool) -> int:
    if is_inv:
        a = InsEvent(ctg=I.ctg)
        a.coff = [I.coff[0], I.coff[0]]
        a.v = [I.v[0], I.v[1] ^ 1]
        a.voff = [I.voff[0], g.seg[I.v[1] >> 1].len - I.voff[1]]
        b = InsEvent(ctg=I.ctg)
        b.coff = [I.coff[1], I.coff[1]]
        b.v = [I.v[0] ^ 1, I.v[1]]
        b.voff = [g.seg[I.v[0] >> 1].len - I.voff[0], I.voff[1]]
        ins.append(a)
        ins.append(b)
        return 1
    ins.append(I)
    return 0


def ggsimple(g: Graph, opt: GGOptions, n_seq: int, seqs,
             gcs: List[Optional[GChains]], use_cigar: bool) -> None:
    """Dispatch to the CIGAR-based or anchor-gap-based augmentation."""
    if use_cigar:
        _ggsimple_cigar(g, opt, n_seq, seqs, gcs)
    else:
        _ggsimple_nocigar(g, opt, n_seq, seqs, gcs)


def _finish(g: Graph, opt: GGOptions, n_seq, seqs, ins: List[InsEvent],
            n_inv: int) -> None:
    if ins:
        names = [s.name for s in seqs]
        sqs = [s.seq for s in seqs]
        ins = ins_filter(g, ins)
        augment(g, ins, names, sqs)
    from ..utils.syslog import mlog
    mlog("ggs", f"inserted {len(ins)} events, including {n_inv} inversions")


def _ggsimple_nocigar(g: Graph, opt: GGOptions, n_seq, seqs, gcs) -> None:
    """mg_ggsimple (ggsimple.c:107-309): anchor-gap scoring without CIGAR."""
    max_acnt, a_dens, sintv, qintv = gc_index(
        g, n_seq, gcs, opt.min_mapq, opt.min_map_len, opt.min_depth_len)
    if max_acnt == 0:
        return
    ins: List[InsEvent] = []
    n_inv = 0
    for t in range(n_seq):
        gt = gcs[t]
        if gt is None:
            continue
        for gc in gt.gc:
            if gc.id != gc.parent:
                continue
            if gc.blen < opt.min_map_len or gc.mapq < opt.min_mapq:
                continue
            assert gc.cnt > 0
            # score inter-anchor gaps
            n_anchor = gc.n_anchor
            sc = [0] * max(n_anchor - 1, 0)
            meta = [0] * max(n_anchor - 1, 0)
            off_l = gc.off
            off_a = gt.lc[off_l].off + 1
            far_q = 0
            for j in range(1, n_anchor):
                qx = int(gt.ax[off_a - 1])
                qy = int(gt.ay[off_a - 1])
                px = int(gt.ax[off_a])
                py = int(gt.ay[off_a])
                lc = gt.lc[off_l]
                ed = -1
                off_l0 = off_l
                qd = _i32(py) - _i32(qy)
                c = (px >> 32) - (qx >> 32) - 1
                if _i32(qy) > far_q:
                    far_q = _i32(qy)
                if off_a == lc.off + lc.cnt:
                    pd = g.seg[lc.v >> 1].len - _i32(qx) - 1
                    off_l += 1
                    while off_l < gc.off + gc.cnt and gt.lc[off_l].cnt == 0:
                        pd += g.seg[gt.lc[off_l].v >> 1].len
                        off_l += 1
                    assert off_l < gc.off + gc.cnt
                    if gt.lc[off_l].ed >= 0:
                        ed = gt.lc[off_l].ed
                    pd += _i32(px) + 1
                else:
                    pd = _i32(px) - _i32(qx)
                if (opt.flag & MG_G_NO_QOVLP) and _i32(py) < far_q:
                    s = 1
                elif pd == qd and c == 0:
                    s = -opt.match_pen
                elif ed >= 0:
                    min_d = pd if pd < qd else qd
                    tt = 1.0 / (1.01 - opt.ggs_max_iden)
                    if tt > 10.0:
                        tt = 10.0
                    s = int(ed * tt - min_d)
                elif pd > qd:
                    x = qd * a_dens
                    x = x if x > c else c
                    s = int(x + (pd - qd) * a_dens + 0.499)
                else:
                    s = int(qd * a_dens + 0.499)
                    s = s if s > c else c
                sc[j - 1] = s
                meta[j - 1] = (pd << 32) | off_l0
                off_a += 1

            ss = mss_all(sc, 10, 0)
            off_a = gt.lc[gc.off].off
            for seg_ms in ss:
                min_len = opt.ggs_min_end_cnt if opt.ggs_min_end_cnt > 0 else 0
                if min_len < seg_ms.sc * opt.ggs_min_end_frac:
                    min_len = seg_ms.sc * opt.ggs_min_end_frac
                if seg_ms.st <= min_len or seg_ms.en >= n_anchor - 1 - min_len:
                    continue
                st, en = seg_ms.st, seg_ms.en
                qx = int(gt.ax[off_a + st])
                qy = int(gt.ay[off_a + st])
                px = int(gt.ax[off_a + en])
                py = int(gt.ay[off_a + en])
                span = (py >> 32) & 0xFF
                ls = meta[st] & 0xFFFFFFFF
                le = meta[en] & 0xFFFFFFFF
                assert ls <= le
                I = InsEvent(ctg=t)
                I.v = [gt.lc[ls].v, gt.lc[le].v]
                I.voff = [_i32(qx) + 1 - span, _i32(px) + 1]
                I.coff = [_i32(qy) + 1 - span, _i32(py) + 1]
                assert I.voff[0] <= g.seg[I.v[0] >> 1].len
                assert I.voff[1] <= g.seg[I.v[1] >> 1].len
                pd = span
                for k in range(st, en):
                    pd += meta[k] >> 32
                if I.coff[0] > I.coff[1]:
                    if pd + (I.coff[0] - I.coff[1]) >= opt.min_var_len:
                        sys.stderr.write(
                            f"[W::ggs] query overlap on gchain\n")
                    continue
                pd -= ins_adj(g, opt.ggs_shrink_pen, I, seqs[t].seq)

                def seg_bounds(k, length, _st=st, _en=en, _ls=ls, _le=le,
                               _off_a=off_a):
                    s_, e_ = 0, length
                    if k == _ls:
                        s_ = _i32(int(gt.ax[_off_a + _st])) + 1 \
                            - ((int(gt.ay[_off_a + _st]) >> 32) & 0xFF)
                    if k == _le:
                        e_ = _i32(int(gt.ax[_off_a + _en])) + 1
                    return s_, e_

                is_inv = _common_event_filter(g, opt, gt, t, seqs[t], I, pd,
                                              ls, le, ls, le, seg_bounds,
                                              qintv, sintv, False)
                if is_inv is None:
                    continue
                n_inv += _emit(g, ins, I, is_inv)
    _finish(g, opt, n_seq, seqs, ins, n_inv)


def _ggsimple_cigar(g: Graph, opt: GGOptions, n_seq, seqs, gcs) -> None:
    """mg_ggsimple_cigar (ggsimple.c:392-570): CIGAR-interval scoring."""
    max_acnt, a_dens, sintv, qintv = gc_index(
        g, n_seq, gcs, opt.min_mapq, opt.min_map_len, opt.min_depth_len)
    if max_acnt == 0:
        return
    ins: List[InsEvent] = []
    n_inv = 0
    for t in range(n_seq):
        gt = gcs[t]
        if gt is None:
            continue
        for gc in gt.gc:
            if gc.id != gc.parent:
                continue
            if gc.p is None or gc.blen < opt.min_map_len \
                    or gc.mapq < opt.min_mapq:
                continue
            assert gc.cnt > 0
            # split the CIGAR into per-segment intervals
            # (gg_count_intv/gg_write_intv, ggsimple.c:319-362)
            intv = []  # (lc, vo, qo, po, len, op)
            l = gc.off
            pl = 0
            x = gc.ps
            y = gc.qs
            for cg in gc.p.cigar:
                op, ln = cg & 0xF, cg >> 4
                rl = ln
                if op in (2, 7, 8):
                    while x + rl > g.seg[gt.lc[l].v >> 1].len:
                        plen = g.seg[gt.lc[l].v >> 1].len - x
                        intv.append([l, x, y, pl, plen, op])
                        if op in (7, 8):
                            y += plen
                        rl -= plen
                        pl += plen
                        l += 1
                        x = 0
                intv.append([l, x, y, pl, rl, op])
                if op in (7, 8):
                    x += rl
                    y += rl
                    pl += rl
                elif op == 1:
                    y += rl
                elif op == 2:
                    x += rl
                    pl += rl
            assert y == gc.qe and pl == gc.pe - gc.ps
            sc = [(-iv[4] if iv[4] >= 10 else 0) if iv[5] == 7 else iv[4]
                  for iv in intv]
            ss = mss_all(sc, opt.min_var_len, 2 * opt.min_var_len)
            # merge nearby segments (gg_merge_seg, ggsimple.c:376-390)
            j0 = 0
            for j in range(1, len(ss)):
                s0, s1 = ss[j0], ss[j]
                mid = sum(sc[i] for i in range(s0.en + 1, s1.st))
                if -mid < s0.sc * 0.2 and -mid < s1.sc * 0.2:
                    s0.en = s1.en
                    s0.sc += s1.sc + mid
                    s1.st = s1.en
                    s1.sc = 0
                else:
                    j0 = j

            for seg_ms in ss:
                st, en = seg_ms.st, seg_ms.en
                if st == en:
                    continue
                is_, ie = intv[st], intv[en - 1]
                assert is_[5] != 7 and ie[5] != 7
                ls, le = is_[0], ie[0]
                I = InsEvent(ctg=t)
                I.v = [gt.lc[ls].v, gt.lc[le].v]
                I.voff = [is_[1], ie[1] + (ie[4] if ie[5] != 1 else 0)]
                I.coff = [is_[2], ie[2] + (ie[4] if ie[5] != 2 else 0)]
                assert I.voff[0] <= g.seg[I.v[0] >> 1].len
                assert I.voff[1] <= g.seg[I.v[1] >> 1].len
                if I.voff[0] == 0:
                    assert ls - 1 >= gc.off
                    ls -= 1
                    I.v[0] = gt.lc[ls].v
                    I.voff[0] = g.seg[I.v[0] >> 1].len
                if I.voff[1] == g.seg[I.v[1] >> 1].len:
                    assert le + 1 < gc.off + gc.cnt
                    le += 1
                    I.v[1] = gt.lc[le].v
                    I.voff[1] = 0
                pd = ie[3] + (ie[4] if ie[5] != 1 else 0) - is_[3]
                pd -= ins_adj(g, opt.ggs_shrink_pen, I, seqs[t].seq)

                def seg_bounds(k, length, _is=is_, _ie=ie):
                    s_, e_ = 0, length
                    if k == _is[0]:
                        s_ = _is[1]
                    if k == _ie[0]:
                        e_ = _ie[1] + (_ie[4] if _ie[5] != 1 else 0)
                    return s_, e_

                is_inv = _common_event_filter(g, opt, gt, t, seqs[t], I, pd,
                                              is_[0], ie[0], ls, le,
                                              seg_bounds, qintv, sintv, True)
                if is_inv is None:
                    continue
                n_inv += _emit(g, ins, I, is_inv)
    _finish(g, opt, n_seq, seqs, ins, n_inv)
