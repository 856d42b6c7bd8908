"""One read's graph chains for the reference's host finish at -c.

A frozen copy of the port's mapping/gchain.py pieces that its per-read
path runs before the base-level stage: the chain records (mg_llchain_t,
mg_cigar_t, mg_gchain_t, mg_gchains_t), the whole per-read tail in one
native call (csrc/mgt_tail.c mgt_map_tail: linear chain, long-join
rescue, lchain tail, graph chain) with the selection
(csrc/mgt_select.c), and the chain records built from their output.
"""
from __future__ import annotations

import ctypes as ct
import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .native import get_lib
from .options import MG_MAX_SHORT_K

F32 = np.float32


@dataclass
class LLChain:
    """mg_llchain_t (minigraph.h:108-113)."""
    off: int = 0
    cnt: int = 0
    v: int = 0
    score: int = 0
    ed: int = -1


@dataclass
class Cigar:
    """mg_cigar_t (minigraph.h:115-118)."""
    n_cigar: int = 0
    mlen: int = 0
    blen: int = 0
    aplen: int = 0
    ss: int = 0
    ee: int = 0
    cigar: List[int] = field(default_factory=list)


@dataclass
class GChain:
    """mg_gchain_t (minigraph.h:125-138)."""
    id: int = 0
    parent: int = 0
    off: int = 0
    cnt: int = 0
    n_anchor: int = 0
    score: int = 0
    qs: int = -1
    qe: int = -1
    plen: int = 0
    ps: int = -1
    pe: int = -1
    blen: int = 0
    mlen: int = 0
    div: float = -1.0
    hash: int = 0
    subsc: int = 0
    n_sub: int = 0
    mapq: int = 0
    flt: int = 0
    p: Optional[Cigar] = None     # base-level alignment (-c)
    ds: Optional[object] = None   # its ds:Z string (cigar.DsString)


@dataclass
class GChains:
    """mg_gchains_t (minigraph.h:140-146)."""
    gc: List[GChain] = field(default_factory=list)
    lc: List[LLChain] = field(default_factory=list)
    ax: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.uint64))
    ay: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.uint64))
    rep_len: int = 0


def scratch(llc_cap: int, n_a_total: int, gc_cap: int):
    """Output buffers of the native tail and selection, with their
    pointers: (o_llc, o_ax, o_ay, g_tab, g_hash, g_extra, ptrs, sel)."""
    bufs = (np.empty((5, max(llc_cap, 4096)), dtype=np.int64),
            np.empty(max(n_a_total, 1 << 14), dtype=np.uint64),
            np.empty(max(n_a_total, 1 << 14), dtype=np.uint64),
            np.empty((4, max(gc_cap, 64)), dtype=np.int64),
            np.empty(max(gc_cap, 64), dtype=np.uint32),
            np.empty((max(gc_cap, 64), 8), dtype=np.int64))
    o_llc_, g_tab_ = bufs[0], bufs[3]
    ptrs = (o_llc_[0].ctypes.data, o_llc_[1].ctypes.data,
            o_llc_[2].ctypes.data, o_llc_[3].ctypes.data,
            o_llc_[4].ctypes.data, bufs[1].ctypes.data,
            bufs[2].ctypes.data, g_tab_[0].ctypes.data,
            g_tab_[1].ctypes.data, g_tab_[2].ctypes.data,
            g_tab_[3].ctypes.data, bufs[4].ctypes.data,
            bufs[5].ctypes.data)
    sel_tab = np.empty((4, max(gc_cap, 64)), dtype=np.int64)
    return bufs + (ptrs, sel_tab)


_configured = False


def _configure(lib) -> None:
    global _configured
    if _configured:
        return
    lib.mgt_map_tail.restype = ct.c_int64
    lib.mgt_map_tail.argtypes = (
        [ct.c_int64, ct.c_void_p, ct.c_void_p]      # mode, f, p
        + [ct.c_int64] * 7 + [ct.c_double] * 2      # chain params
        + [ct.c_int64] * 4                          # is_cdna..rmq_cap
        + [ct.c_int64] * 5                          # rescue
        + [ct.c_double]                             # rescue ratio
        + [ct.c_int64, ct.c_void_p, ct.c_void_p]    # anchors
        + [ct.c_void_p] + [ct.c_int64] * 4          # lchain tail
        + [ct.c_void_p] * 4 + [ct.c_int64, ct.c_void_p]  # graph
        + [ct.c_void_p] * 6 + [ct.c_char_p]         # gwfa
        + [ct.c_char_p, ct.c_int64]                 # qseq
        + [ct.c_int64] * 3 + [ct.c_double]          # gc params
        + [ct.c_int64, ct.c_uint32] + [ct.c_int64] * 3
        + [ct.c_int64] * 3 + [ct.c_void_p] * 13)    # caps + out
    lib.mgt_select_chains.restype = ct.c_int64
    lib.mgt_select_chains.argtypes = \
        [ct.c_double, ct.c_double] + [ct.c_int64] * 7 \
        + [ct.c_void_p] * 17
    _configured = True


def map_tail(args0, opt, ax, ay, mini_pos, mode: int, qlen: int,
             max_dist_x: int, max_dist_y: int, chn_pen_gap: float,
             chn_pen_skip: float, hash_: int, qseq: str, do_rescue: int,
             sel_args):
    """The whole per-read tail (mgt_map_tail) and the selection
    (mgt_select_chains) of one single-segment read, as the port's
    map_tail_full runs them; args0 are the graph's leading pointer
    arguments (tail._get_gfull_ctx).  Returns (chains kept, scratch),
    or None where an engine bails."""
    lib = get_lib()
    _configure(lib)
    n_a = len(ax)
    sc = scratch(n_a + 1024, n_a, max(n_a, 64))
    if n_a == 0:
        return 0, sc
    qb = qseq.encode("latin-1")
    mini_pos = np.ascontiguousarray(mini_pos, dtype=np.int64)
    ax2 = np.array(ax, dtype=np.uint64)
    ay2 = np.array(ay, dtype=np.uint64)
    o_llc, o_ax, g_tab = sc[0], sc[1], sc[3]
    n_gc = lib.mgt_map_tail(
        mode, None, None,
        max_dist_x, max_dist_y, opt.bw, opt.max_lc_skip,
        opt.max_lc_iter, opt.min_lc_cnt, opt.min_lc_score,
        chn_pen_gap, chn_pen_skip,
        0, 1, opt.max_gap_pre, opt.rmq_size_cap,
        do_rescue, qlen, opt.bw_long, opt.rmq_rescue_size,
        opt.max_gap, opt.rmq_rescue_ratio,
        n_a, ax2.ctypes.data, ay2.ctypes.data,
        mini_pos.ctypes.data, len(mini_pos), opt.lc_max_occ,
        opt.lc_max_trim, opt.max_gap >> 1,
        *args0, qb, len(qb),
        opt.bw_long, opt.max_gc_skip, opt.ref_bonus, opt.mask_level,
        MG_MAX_SHORT_K, hash_, opt.min_gc_cnt, opt.min_gc_score,
        opt.gdp_max_ed,
        o_llc.shape[1], len(o_ax), g_tab.shape[1], *sc[6])
    if n_gc <= 0:
        return (None if n_gc < 0 else 0), sc
    (mask_level, pri_ratio, min_diff, best_n, qlen_, max_mini,
     min_gc_score, rep_len) = sel_args
    pt, sel = sc[6], sc[7]
    n2 = lib.mgt_select_chains(
        mask_level, pri_ratio, min_diff, best_n, qlen_, max_mini,
        min_gc_score, rep_len, n_gc,
        pt[7], pt[8], pt[9], pt[10],          # g_off/g_cnt/g_na/g_sc
        pt[11], pt[12],                       # g_hash/g_extra
        pt[0], pt[1], pt[2], pt[3], pt[4],    # o_lv/loff/lcnt/lsc/led
        pt[5], pt[6],                         # o_ax/o_ay
        sel[0].ctypes.data, sel[1].ctypes.data,
        sel[2].ctypes.data, sel[3].ctypes.data)
    return (None if n2 < 0 else n2), sc


def gcs_from_scratch(n_gc: int, sc) -> GChains:
    """The chain records of the selected chains in the scratch
    (mgt_map_tail + mgt_select_chains layout)."""
    o_llc, o_ax, o_ay, g_tab, g_hash, g_extra = sc[:6]
    gcs = GChains()
    if n_gc == 0:
        return gcs
    sel = sc[7]
    lv, loff, lcnt, lsc, led = (o_llc[i] for i in range(5))
    n_llc = int(g_tab[1][:n_gc].sum())
    n_a = int(lcnt[:n_llc].sum())
    gcs.lc = [LLChain(off=int(loff[i]), cnt=int(lcnt[i]), v=int(lv[i]),
                      score=int(lsc[i]), ed=int(led[i]))
              for i in range(n_llc)]
    gcs.ax = o_ax[:n_a].copy()
    gcs.ay = o_ay[:n_a].copy()
    gcs._lc_tables = (lv[:n_llc].copy(), loff[:n_llc].copy(),
                      lcnt[:n_llc].copy())
    for c in range(n_gc):
        p = GChain(score=int(g_tab[3][c]), off=int(g_tab[0][c]),
                   cnt=int(g_tab[1][c]), n_anchor=int(g_tab[2][c]),
                   hash=int(g_hash[c]))
        p.id = c
        p.parent = int(sel[0][c])
        p.mapq = int(sel[1][c])
        p.n_sub = int(sel[2][c])
        p.subsc = int(sel[3][c])
        row = g_extra[c]
        p.qs, p.qe, p.ps, p.pe, p.plen, p.blen, p.mlen = \
            (int(v) for v in row[:7])
        n_mini = int(row[7])
        q_span = (int(gcs.ay[gcs.lc[p.off].off]) >> 32) & 0xFF
        if n_mini >= p.n_anchor:
            p.div = float(F32(math.log(n_mini / p.n_anchor) / q_span))
        else:
            p.div = float(F32(math.log(p.n_anchor / n_mini) / q_span))
        gcs.gc.append(p)
    return gcs
