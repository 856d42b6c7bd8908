"""The native batch tail of the reference: reads -> GAF text.

A frozen copy of the port's mapping/native_tail.py, cut to the host
path (items mode, every read collected inside its worker): one call
maps a batch of reads in csrc/mgt_batch.c, a work-stealing pthread
loop over the seed collection (mgt_collect), the linear and graph
chaining with the long-join rescue (mgt_map_tail), mgt_select_chains,
with -c the base-level stage (csrc/mgt_cigar.c: the anchor walk, an
exact WFA a gap, the ds string) and mgt_format_gaf.
"""
from __future__ import annotations

import ctypes as ct

import numpy as np

from .options import (DBG, MG_M_CIGAR, MG_M_FRAG_MERGE, MG_M_HEAP_SORT,
                       MG_M_NO_COMP_PATH, MG_M_PRINT_2ND, MG_M_RMQ,
                       MG_M_SHOW_UNMAP, MG_M_SPLICE, MG_M_SR,
                       MG_MAX_SHORT_K)
from .cigar import _es_tables
from .hashes import expf
from .native import get_lib

_configured = False


def chain_penalties(gi, opt):
    """f32 chain penalties (map-algo.c:388)."""
    tmp = expf(-np.float32(opt.div) * np.float32(gi.k))
    gap = float(np.float32(np.float32(opt.chn_pen_gap) * np.float32(tmp)))
    skip = float(np.float32(np.float32(opt.chn_pen_skip) * np.float32(tmp)))
    return gap, skip


def _seg_len(g) -> np.ndarray:
    seg_len = getattr(g, "_seg_len_arr", None)
    if seg_len is None or len(seg_len) != g.n_seg:
        seg_len = np.asarray([s.len for s in g.seg], dtype=np.int64)
        g._seg_len_arr = seg_len
    return seg_len


def _flat_graph(g, es):
    """Vertex-oriented flat graph view for the native GWFA engine,
    cached per (graph, edseq-table) pair."""
    cache = getattr(g, "_gwfa_cache", None)
    if cache is not None and cache[0] is es:
        return cache[1]
    n_vtx = g.n_vtx
    arc_start = np.empty(n_vtx, dtype=np.int64)
    arc_cnt = np.empty(n_vtx, dtype=np.int32)
    for v in range(n_vtx):
        st, cnt = g.arc_range(v)
        arc_start[v] = st
        arc_cnt[v] = cnt
    arc_w = np.asarray(g.arc_w, dtype=np.uint32)
    arc_ow = np.asarray([a.ow for a in g.arc], dtype=np.int32)
    seq_off = np.empty(n_vtx, dtype=np.int64)
    seq_len = np.empty(n_vtx, dtype=np.int32)
    parts = []
    off = 0
    for i, e in enumerate(es):
        seq_off[2 * i] = off
        seq_len[2 * i] = e.len
        parts.append(e.fwd)
        off += e.len
        seq_off[2 * i + 1] = off
        seq_len[2 * i + 1] = e.len
        parts.append(e.rc)
        off += e.len
    seq_buf = b"".join(parts)
    flat = (arc_start, arc_cnt, arc_w, arc_ow, seq_off, seq_len, seq_buf)
    g._gwfa_cache = (es, flat)
    return flat


def _get_gfull_ctx(g, es):
    """Graph-constant leading pointer arguments of the native tail,
    cached on the graph."""
    ctx = getattr(g, "_gfull_ctx", None)
    if ctx is None or ctx[0] is not es:
        gw = _flat_graph(g, es)
        seg_len = _seg_len(g)
        idx = g.idx
        if idx.dtype != np.int64 or not idx.flags["C_CONTIGUOUS"]:
            idx = np.ascontiguousarray(idx, dtype=np.int64)
            g.idx = idx
        args0 = (idx.ctypes.data, g.arc_w.ctypes.data,
                 g.arc_lv.ctypes.data, g.arc_rank.ctypes.data, len(idx),
                 seg_len.ctypes.data, gw[0].ctypes.data,
                 gw[1].ctypes.data, gw[2].ctypes.data, gw[3].ctypes.data,
                 gw[4].ctypes.data, gw[5].ctypes.data, gw[6])
        keep = (idx, g.arc_w, g.arc_lv, g.arc_rank, seg_len, gw)
        ctx = (es, args0, keep)
        g._gfull_ctx = ctx
    return ctx[1]


def _get_gaf_ctx(g):
    """Per-graph name/coordinate arrays for the native GAF formatter
    (native/mgt_gaf.c), cached on the graph."""
    ctx = getattr(g, "_gaf_ctx", None)
    if ctx is not None and ctx[0] == (g.n_seg, len(g.sseq)):
        return ctx[1]
    seg_len = _seg_len(g)
    names = [s.name.encode("latin-1") for s in g.seg]
    nm = b"".join(names)
    nm_off = np.zeros(g.n_seg + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(x) for x in names), np.int64, g.n_seg),
              out=nm_off[1:])
    snid = np.asarray([s.snid for s in g.seg], dtype=np.int64)
    soff = np.asarray([s.soff for s in g.seg], dtype=np.int64)
    n_ss = len(g.sseq)
    ss_names = [s.name.encode("latin-1") for s in g.sseq]
    ss_nm = b"".join(ss_names)
    ss_off = np.zeros(n_ss + 1, dtype=np.int64)
    if n_ss:
        np.cumsum(np.fromiter((len(x) for x in ss_names), np.int64, n_ss),
                  out=ss_off[1:])
    ss_min = np.asarray([s.min for s in g.sseq] or [0], dtype=np.int64)
    ss_max = np.asarray([s.max for s in g.sseq] or [0], dtype=np.int64)
    ss_rank = np.asarray([s.rank for s in g.sseq] or [0], dtype=np.int64)
    args = (nm, nm_off.ctypes.data, seg_len.ctypes.data,
            snid.ctypes.data, soff.ctypes.data,
            ss_nm, ss_off.ctypes.data, ss_min.ctypes.data,
            ss_max.ctypes.data, ss_rank.ctypes.data)
    keep = (nm, nm_off, seg_len, snid, soff, ss_nm, ss_off, ss_min,
            ss_max, ss_rank)
    g._gaf_ctx = ((g.n_seg, n_ss), args, keep)
    return args


def get_collect_ctx(gi):
    """Flat index-table pointers for the native collector, cached on
    the index, plus the O(1) open-addressing probe table."""
    ctx = getattr(gi, "_collect_ctx", None)
    if ctx is None:
        seg_len = _seg_len(gi.g)
        keys = np.ascontiguousarray(gi.keys, dtype=np.uint64)
        kst = np.ascontiguousarray(gi.key_start, dtype=np.int64)
        kcn = np.ascontiguousarray(gi.key_cnt, dtype=np.int64)
        pos = np.ascontiguousarray(gi.pos, dtype=np.uint64)
        lib = get_lib()
        htab, n_slots = None, 0
        # 16 B/slot at >= 2x load headroom; above 2**27 keys (a 4 GB
        # table) the collector binary-searches the sorted keys instead
        if 0 < len(keys) <= 1 << 27:
            n_slots = 1 << max(6, int(2 * len(keys) - 1).bit_length())
            htab = np.empty(2 * n_slots, dtype=np.uint64)
            lib.mgt_collect_hash_build(
                ct.c_void_p(keys.ctypes.data),
                ct.c_void_p(kst.ctypes.data),
                ct.c_void_p(kcn.ctypes.data), ct.c_int64(len(keys)),
                ct.c_void_p(htab.ctypes.data), ct.c_int64(n_slots))
        ctx = ((keys.ctypes.data, kst.ctypes.data, kcn.ctypes.data,
                len(keys), pos.ctypes.data, seg_len.ctypes.data,
                htab.ctypes.data if htab is not None else None,
                n_slots),
               (keys, kst, kcn, pos, seg_len, htab))
        gi._collect_ctx = ctx
    return ctx[0]


def _configure(lib):
    global _configured
    if _configured:
        return
    lib.mgt_map_tail_batch.restype = ct.c_int64
    lib.mgt_map_tail_batch.argtypes = (
        [ct.c_int64, ct.c_int64, ct.c_void_p, ct.c_void_p]
        + [ct.c_void_p] * 13                      # per-read arrays
        + [ct.c_int64] * 4 + [ct.c_void_p] * 3
        + [ct.c_int64, ct.c_void_p]               # host-collect ctx
        + [ct.c_void_p, ct.c_int64]               # probe table
        + [ct.c_int64, ct.c_void_p, ct.c_void_p]  # frag ctx
        + [ct.c_int64, ct.c_void_p]               # -c ctx
        + [ct.c_char_p, ct.c_void_p, ct.c_char_p, ct.c_void_p]
        + [ct.c_void_p]                           # qname_len
        + [ct.c_void_p] * 4 + [ct.c_int64, ct.c_void_p]
        + [ct.c_void_p] * 6 + [ct.c_char_p]       # graph ctx
        + [ct.c_char_p] + [ct.c_void_p] * 3
        + [ct.c_char_p] + [ct.c_void_p] * 4       # gaf name ctx
        + [ct.c_void_p] * 4)                      # out
    lib.mgt_buf_free.restype = None
    lib.mgt_buf_free.argtypes = [ct.c_void_p]
    lib.mgt_collect_hash_build.restype = None
    _configured = True


def map_batch_native(gi, opt, items, n_threads: int,
                     rescue: bool = True) -> dict:
    """Map a batch of reads to GAF text in one native call.

    items: list of (key, qname, seq); the workers run the seed
    collection, the chaining (1: the banded DP with the read's own gaps;
    2: RMQ, --rmq and asm), the selection and the GAF formatter.
    Returns {key: text}, with None for a read whose native engines
    bailed (status != 0).  rescue=False drops the long-join rescue
    re-chain (map-algo.c:407-417): the control's broken guarantee."""
    lib = get_lib()
    _configure(lib)
    n = len(items)
    if n == 0:
        return {}
    if opt.flag & MG_M_FRAG_MERGE or DBG["flag"]:
        raise NotImplementedError("the reference maps without "
                                  "fragments and debug dumps")
    is_sr = bool(opt.flag & MG_M_SR)
    is_splice = bool(opt.flag & MG_M_SPLICE)
    is_rmq = bool(opt.flag & MG_M_RMQ)
    if opt.max_gap_ref > 0:
        mdx_dp = opt.max_gap_ref
    elif opt.max_frag_len > 0:
        mdx_dp = None      # depends on the read's length
    else:
        mdx_dp = opt.max_gap
    chn_pen_gap, chn_pen_skip = chain_penalties(gi, opt)
    do_rescue = int(rescue and opt.bw_long > opt.bw
                    and not (opt.flag & (MG_M_SPLICE | MG_M_SR)))
    gaf_flags = (int(bool(opt.flag & MG_M_PRINT_2ND))
                 | (int(bool(opt.flag & MG_M_NO_COMP_PATH)) << 1)
                 | (int(bool(opt.flag & MG_M_SHOW_UNMAP)) << 2))
    P = np.array([
        opt.bw, opt.max_lc_skip, opt.max_lc_iter, opt.min_lc_cnt,
        opt.min_lc_score, int(is_splice), opt.max_gap_pre,
        opt.rmq_size_cap, do_rescue, opt.bw_long, opt.rmq_rescue_size,
        opt.max_gap, opt.lc_max_occ, opt.lc_max_trim, opt.max_gap >> 1,
        opt.max_gc_skip, opt.ref_bonus, MG_MAX_SHORT_K, opt.min_gc_cnt,
        opt.min_gc_score, opt.gdp_max_ed, opt.seed, gi.k * 2,
        opt.best_n, gaf_flags], dtype=np.int64)
    PD = np.array([chn_pen_gap, chn_pen_skip, opt.rmq_rescue_ratio,
                   opt.mask_level, opt.pri_ratio], dtype=np.float64)

    mode = np.empty(n, dtype=np.int64)
    zeros = [np.zeros(n, dtype=np.int64) for _ in range(4)]
    ptrs = [np.zeros(n, dtype=np.uint64) for _ in range(5)]
    n_a, n_mv, n_mini, rep_len = zeros
    axp, ayp, fpp, ppp, mpp = ptrs
    qlen = np.empty(n, dtype=np.int64)
    mdx = np.empty(n, dtype=np.int64)
    mdy = np.empty(n, dtype=np.int64)
    qseq_off = np.zeros(n + 1, dtype=np.int64)
    qname_off = np.zeros(n + 1, dtype=np.int64)
    seq_parts, name_parts = [], []
    for k, (_, qname, seq) in enumerate(items):
        ql = len(seq)
        qlen[k] = ql
        if is_rmq:
            mode[k] = 2
            mdx[k] = opt.max_gap
            mdy[k] = 0
        else:
            mode[k] = 1
            mdx[k] = mdx_dp if mdx_dp is not None \
                else max(opt.max_frag_len - ql, opt.max_gap)
            mdy[k] = max(ql, opt.max_gap) if is_sr else opt.max_gap
        seq_parts.append(seq)
        name_parts.append(qname or "")
        qseq_off[k + 1] = qseq_off[k] + ql
        qname_off[k + 1] = qname_off[k] + len(name_parts[-1])
    qseq_blob = "".join(seq_parts).encode("latin-1")
    qname_blob = "".join(name_parts).encode("latin-1")

    args0 = _get_gfull_ctx(gi.g, gi.es)
    gctx = _get_gaf_ctx(gi.g)
    o_off = np.empty(n, dtype=np.int64)
    o_len = np.empty(n, dtype=np.int64)
    status = np.empty(n, dtype=np.int64)
    pbuf = ct.c_void_p()
    cptr = get_collect_ctx(gi)
    col_args = (1, gi.w, gi.k, opt.occ_max1,
                cptr[0], cptr[1], cptr[2], cptr[3], cptr[4],
                cptr[6], cptr[7])
    frag_args = (int(bool(opt.flag & MG_M_HEAP_SORT)), None, None)
    cig_args = (0, None)
    if opt.flag & MG_M_CIGAR:
        # -c: the workers align and write cg:Z/ds:Z themselves, reading
        # every segment's fwd/rc bytes through this pointer table (the
        # cast holds it through the call)
        cig_args = (1, ct.cast(_es_tables(gi.es)[0], ct.c_void_p))
    total = lib.mgt_map_tail_batch(
        n, max(1, n_threads), P.ctypes.data, PD.ctypes.data,
        mode.ctypes.data, n_a.ctypes.data, axp.ctypes.data,
        ayp.ctypes.data, fpp.ctypes.data, ppp.ctypes.data,
        n_mv.ctypes.data, n_mini.ctypes.data, mpp.ctypes.data,
        qlen.ctypes.data,
        rep_len.ctypes.data, mdx.ctypes.data, mdy.ctypes.data,
        *col_args,
        *frag_args,
        *cig_args,
        qseq_blob, qseq_off.ctypes.data,
        qname_blob, qname_off.ctypes.data,
        None,
        *args0,
        gctx[0], gctx[1], gctx[3], gctx[4],
        gctx[5], gctx[6], gctx[7], gctx[8], gctx[9],
        ct.byref(pbuf), o_off.ctypes.data, o_len.ctypes.data,
        status.ctypes.data)
    if total < 0:
        raise MemoryError("native batch tail: allocation failed")
    txt = ct.string_at(pbuf, total).decode("latin-1") if total else ""
    lib.mgt_buf_free(pbuf)
    return {it[0]: (txt[int(o_off[k]): int(o_off[k]) + int(o_len[k])]
                    if status[k] == 0 else None)
            for k, it in enumerate(items)}
