"""The reference's host finish at -c: a read whose native batch bailed.

The batch's base-level stage gives a read up whole when one gap of one
of its chains runs over the native WFA budget (csrc/mgt_batch.c
cigar_stage); the port then maps that read again on its per-read path.
The finish does the same on the reference's own library: the seed
collection (mgt_collect), the whole tail and the selection (chains.py),
the CIGAR of each chain the GAF prints (cigar.py: the native walk, else
the Python walk with its chain heuristic) and its ds string, written by
the batch's own formatter (mgt_format_gaf) with those -c tables.
"""
from __future__ import annotations

import ctypes as ct
from typing import Optional

import numpy as np

from . import chains
from .cigar import gchain_cigar, gchain_gen_ds
from .native import get_lib
from .options import (MG_M_HEAP_SORT, MG_M_NO_COMP_PATH, MG_M_PRINT_2ND,
                      MG_M_RMQ, MG_M_SHOW_UNMAP, MG_M_SPLICE, MG_M_SR)
from .tail import (_get_gaf_ctx, _get_gfull_ctx, chain_penalties,
                   get_collect_ctx)

U32 = 0xFFFFFFFF
_configured = False


def _configure(lib) -> None:
    global _configured
    if _configured:
        return
    lib.mgt_collect.restype = ct.c_int64
    lib.mgt_collect.argtypes = (
        [ct.c_char_p] + [ct.c_int64] * 4
        + [ct.c_void_p] * 3 + [ct.c_int64, ct.c_void_p, ct.c_void_p]
        + [ct.c_void_p, ct.c_int64]               # probe table
        + [ct.c_void_p, ct.c_int64]
        + [ct.c_void_p] * 2 + [ct.c_int64]
        + [ct.c_void_p, ct.c_int64] + [ct.c_void_p])
    lib.mgt_format_gaf.restype = ct.c_int64
    lib.mgt_format_gaf.argtypes = (
        [ct.c_char_p] + [ct.c_void_p] * 4
        + [ct.c_char_p] + [ct.c_void_p] * 4
        + [ct.c_char_p, ct.c_int64, ct.c_int64, ct.c_int64]
        + [ct.c_void_p] * 4          # lv, loff, lcnt, o_ay
        + [ct.c_void_p] * 5          # g_off/g_cnt/g_na/g_sc/g_extra
        + [ct.c_void_p] * 3          # sel parent/mapq/subsc
        + [ct.c_int64] * 3
        + [ct.c_int64, ct.c_int64, ct.c_void_p]  # frag shape
        + [ct.c_void_p] * 7          # -c cigar/ds tables
        + [ct.c_void_p, ct.c_int64])
    _configured = True


def _hash32(key: int) -> int:
    """32-bit integer hash (khashl.h:321; bh_hash32 in csrc/mgt_batch.c)."""
    key &= U32
    key = (key + (~(key << 15) & U32)) & U32
    key ^= key >> 10
    key = (key + (key << 3)) & U32
    key ^= key >> 6
    key = (key + (~(key << 11) & U32)) & U32
    key ^= key >> 16
    return key


def _hash_str(s: bytes) -> int:
    """String hash (khashl.h:342; bh_hash_str): h = h*31 + c over u32."""
    h = s[0] if s else 0
    for c in s[1:]:
        h = ((h << 5) - h + c) & U32
    return h


def collect(gi, opt, seq: str):
    """The read's anchors (mgt_collect, as the batch's workers collect):
    (ax, ay, rep_len, mini_pos, n_mv), or None where the engine bails."""
    lib = get_lib()
    _configure(lib)
    cptr = get_collect_ctx(gi)
    qb = seq.encode("latin-1")
    qlen = len(qb)
    mv = np.empty(2 * (max(qlen, 2048) // 2 + 64) + 64, dtype=np.uint64)
    ax = np.empty(1 << 14, dtype=np.uint64)
    ay = np.empty(1 << 14, dtype=np.uint64)
    mp = np.empty(1 << 13, dtype=np.int64)
    meta = np.empty(4, dtype=np.int64)
    while True:
        r = lib.mgt_collect(
            qb, qlen, gi.w, gi.k, opt.occ_max1,
            cptr[0], cptr[1], cptr[2], cptr[3], cptr[4], cptr[5],
            cptr[6], cptr[7],
            mv.ctypes.data, len(mv) // 2,
            ax.ctypes.data, ay.ctypes.data, len(ax),
            mp.ctypes.data, len(mp), meta.ctypes.data)
        if r == 0:
            n_a, n_mv, rep_len, n_mini = (int(x) for x in meta)
            return ax[:n_a].copy(), ay[:n_a].copy(), rep_len, \
                mp[:n_mini].copy(), n_mv
        if r != -1:
            return None
        # grow the buffers the engine reported too small (meta[0]
        # anchors, meta[1] minimizer records)
        need_mv = 2 * (int(meta[1]) + 64)
        need_a = int(meta[0]) + 64
        need_mp = int(meta[1]) + 64
        if len(mv) < need_mv:
            mv = np.empty(need_mv + (need_mv >> 1), dtype=np.uint64)
        if len(ax) < need_a:
            ax = np.empty(need_a + (need_a >> 1), dtype=np.uint64)
            ay = np.empty(need_a + (need_a >> 1), dtype=np.uint64)
        if len(mp) < need_mp:
            mp = np.empty(need_mp + (need_mp >> 1), dtype=np.int64)


def finish_read(gi, opt, qname: str, seq: str, rescue: bool = True
                ) -> Optional[str]:
    """The GAF text of one single-segment read at -c, mapped on the
    host one stage at a time; None where an engine bails, and under the
    heap-sorted seed collection, which the finish does not hold."""
    if opt.flag & MG_M_HEAP_SORT:
        return None
    col = collect(gi, opt, seq)
    if col is None:
        return None
    ax, ay, rep_len, mini_pos, n_mv = col
    qlen = len(seq)
    if opt.flag & MG_M_RMQ:
        mode, mdx, mdy = 2, opt.max_gap, 0
    else:
        mode = 1
        if opt.max_gap_ref > 0:
            mdx = opt.max_gap_ref
        elif opt.max_frag_len > 0:
            mdx = max(opt.max_frag_len - qlen, opt.max_gap)
        else:
            mdx = opt.max_gap
        mdy = max(qlen, opt.max_gap) if opt.flag & MG_M_SR else opt.max_gap
    gap, skip = chain_penalties(gi, opt)
    qb = qname.encode("latin-1")
    h = _hash_str(qb) ^ ((_hash32(qlen) + _hash32(opt.seed)) & U32)
    do_rescue = int(rescue and opt.bw_long > opt.bw
                    and not (opt.flag & (MG_M_SPLICE | MG_M_SR)))
    sel_args = (opt.mask_level, opt.pri_ratio, gi.k * 2, opt.best_n,
                qlen, n_mv, opt.min_gc_score, rep_len)
    n2, sc = chains.map_tail(
        _get_gfull_ctx(gi.g, gi.es), opt, ax, ay, mini_pos, mode, qlen,
        mdx, mdy, gap, skip, _hash32(h), seq, do_rescue, sel_args)
    if n2 is None:
        return None
    gcs = chains.gcs_from_scratch(n2, sc)
    print_2nd = bool(opt.flag & MG_M_PRINT_2ND)
    printed = [gc for c, gc in enumerate(gcs.gc)
               if (c == gc.parent or print_2nd) and gc.cnt > 0]
    # the CIGAR and ds of the chains the GAF prints, as the batch's
    # base-level stage aligns them
    every = gcs.gc
    gcs.gc = printed
    gchain_cigar(gi.g, gi.es, seq, gcs)
    gchain_gen_ds(gi.g, gi.es, seq, gcs)
    gcs.gc = every
    return _format(gi.g, gcs, n2, sc, qb, qlen, opt.flag)


def _format(g, gcs, n_gc: int, sc, qb: bytes, qlen: int, flag: int) -> str:
    """mgt_format_gaf over the selected chains' tables, with the -c
    tables of the chains that carry a CIGAR."""
    lib = get_lib()
    _configure(lib)
    n = max(n_gc, 1)
    cg_p = (ct.c_void_p * n)()
    cg_n = np.zeros(n, dtype=np.int64)
    cg_st = np.zeros(4 * n, dtype=np.int64)
    ds_p = (ct.c_void_p * n)()
    ds_n = np.zeros(n, dtype=np.int64)
    do_p = (ct.c_void_p * n)()
    do_n = np.zeros(n, dtype=np.int64)
    keep = []
    for c, gc in enumerate(gcs.gc):
        if gc.p is None:
            continue
        cg = np.asarray(gc.p.cigar, dtype=np.uint32)
        keep.append(cg)
        cg_p[c] = cg.ctypes.data
        cg_n[c] = len(cg)
        cg_st[4 * c: 4 * c + 4] = (gc.p.mlen, gc.p.blen, gc.p.aplen,
                                   gc.qe - gc.qs)
        ds = gc.ds
        if ds is not None and ds.len > 0:
            db = np.frombuffer(ds.ds.encode("latin-1"), dtype=np.uint8)
            off = np.ascontiguousarray(ds.off, dtype=np.int64)
            keep += [db, off]
            ds_p[c] = db.ctypes.data
            ds_n[c] = ds.len
            do_p[c] = off.ctypes.data
            do_n[c] = ds.n_off
    ctx = _get_gaf_ctx(g)
    pt, sel = sc[6], sc[7]
    buf = np.empty(1 << 16, dtype=np.uint8)
    while True:
        m = lib.mgt_format_gaf(
            *ctx, qb, len(qb), qlen, n_gc,
            pt[0], pt[1], pt[2], pt[6],
            pt[7], pt[8], pt[9], pt[10], pt[12],
            sel[0].ctypes.data, sel[1].ctypes.data, sel[3].ctypes.data,
            int(bool(flag & MG_M_PRINT_2ND)),
            int(bool(flag & MG_M_NO_COMP_PATH)),
            int(bool(flag & MG_M_SHOW_UNMAP)),
            1, 0, None,
            ct.cast(cg_p, ct.c_void_p), cg_n.ctypes.data,
            cg_st.ctypes.data, ct.cast(ds_p, ct.c_void_p),
            ds_n.ctypes.data, ct.cast(do_p, ct.c_void_p),
            do_n.ctypes.data,
            buf.ctypes.data, len(buf))
        if m >= 0:
            return buf[:m].tobytes().decode("latin-1")
        buf = np.empty(len(buf) * 4, dtype=np.uint8)
