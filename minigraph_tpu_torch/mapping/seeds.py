"""Query sketching and seed-hit (anchor) collection of the per-read
path (map-algo.c:34-192).

Anchor packing (map-algo.c:152-192):
  a.x = seg<<33 | rev<<32 | seg_pos
  a.y = occ<<56 | seg_id<<48 | flags | span<<32 | q_pos
sorted by x with the reference-exact radix permutation.
"""
from __future__ import annotations

import ctypes as ct
import threading
from typing import List

import numpy as np

from ..index.midx import MinimizerIndex
from ..index.midx_device import sketch_segments_device
from ..index.sketch import sketch
from ..options import (MG_M_NO_DIAG, MG_SEED_OCC_SHIFT, MG_SEED_SEG_SHIFT,
                       MG_SEED_TANDEM, MapOptions)
from ..utils.ksort import radix_argsort
from ..utils.native import get_lib
from .native_tail import _seg_len, get_collect_ctx

U64 = np.uint64

_collect_cfg = False
_CTLS = threading.local()


def collect_minimizers(gi: MinimizerIndex, qlens: List[int], seqs: List[str]):
    """Sketch query segments; positions offset by cumulative length
    (collect_minimizers, map-algo.c:34-45)."""
    xs, ys = [], []
    total = 0
    for i, (ql, s) in enumerate(zip(qlens, seqs)):
        x, y = sketch(s, gi.w, gi.k, i)
        y = y + U64((total << 1) & 0xFFFFFFFFFFFFFFFF)
        xs.append(x)
        ys.append(y)
        total += ql
    if not xs:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64)
    return np.concatenate(xs), np.concatenate(ys)


def collect_minimizers_device(gi: MinimizerIndex, qlens: List[int],
                              seqs: List[str], device, mesh=None):
    """collect_minimizers with the sketch on `device` (--seed-device):
    the index builder's chunk-halo sweep (index/midx_device.py), exact
    for queries of any length.  With `mesh`, the sweep's chunk batches
    split data-parallel over the mesh's "data" ranks (one long query over
    several devices).  Equal to collect_minimizers bit for bit."""
    sk = sketch_segments_device([s.upper() for s in seqs], gi.w, gi.k,
                                device=device, mesh=mesh)
    xs, ys = [], []
    total = 0
    for i, ((x, y), ql) in enumerate(zip(sk, qlens)):
        y = y | (U64(i) << U64(32))
        y = y + U64((total << 1) & 0xFFFFFFFFFFFFFFFF)
        xs.append(x)
        ys.append(y)
        total += ql
    if not xs:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64)
    return np.concatenate(xs), np.concatenate(ys)


def _heap_lt(a, b) -> bool:
    return a[0] > b[0]


def _heapdown(i: int, n: int, heap: list) -> None:
    """ks_heapdown (ksort.h:43-53): max-heap w.r.t. heap_lt = (x >)."""
    k = i
    tmp = heap[i]
    while True:
        k = (k << 1) + 1
        if k >= n:
            break
        if k != n - 1 and _heap_lt(heap[k], heap[k + 1]):
            k += 1
        if _heap_lt(heap[k], tmp):
            break
        heap[i] = heap[k]
        i = k
    heap[i] = tmp


def _heapmake(n: int, heap: list) -> None:
    for i in range((n >> 1) - 1, -1, -1):
        _heapdown(i, n, heap)


def collect_seed_hits_heap(gi: MinimizerIndex, opt: MapOptions,
                           max_occ: int, mv_x: np.ndarray,
                           mv_y: np.ndarray):
    """Heap-merge seed collection (collect_seed_hits_heap,
    map-algo.c:93-150): anchors come out sorted by construction.  Used
    by the short-read presets (--heap-sort)."""
    n_mv = len(mv_x)
    if n_mv == 0:
        return (np.empty(0, U64), np.empty(0, U64), 0, np.empty(0, np.int64))
    minier = mv_x >> U64(8)
    start, cnt = gi.get_many(minier)
    q_pos = (mv_y & U64(0xFFFFFFFF)).astype(np.int64)
    q_span = (mv_x & U64(0xFF)).astype(np.int64)
    seg_id = (mv_y >> U64(32)).astype(np.int64)
    over = cnt >= max_occ
    kept = ~over

    rep_len = 0
    rep_st = rep_en = 0
    for i in np.nonzero(over)[0]:
        en = (q_pos[i] >> 1) + 1
        st = en - q_span[i]
        if st > rep_en:
            rep_len += rep_en - rep_st
            rep_st, rep_en = st, en
        else:
            rep_en = en
    rep_len += rep_en - rep_st

    tandem = np.zeros(n_mv, dtype=bool)
    if n_mv > 1:
        same_prev = minier[1:] == minier[:-1]
        tandem[1:] |= same_prev
        tandem[:-1] |= same_prev

    k_idx = np.nonzero(kept)[0]
    mini_pos = (q_pos[k_idx] >> 1).astype(np.int64)
    n_m = len(k_idx)
    n_a = int(cnt[k_idx].sum())
    if n_a == 0:
        return (np.empty(0, U64), np.empty(0, U64), int(rep_len), mini_pos)
    seg_len = _seg_len(gi.g)

    # heap entries: [x = r value, y = match_idx<<32 | hit_pos]
    heap = []
    for mi in range(n_m):
        i = k_idx[mi]
        if cnt[i] > 0:
            heap.append([int(gi.pos[start[i]]), mi << 32])
    heap_size = len(heap)
    _heapmake(heap_size, heap)

    ax = np.empty(n_a, dtype=np.uint64)
    ay = np.empty(n_a, dtype=np.uint64)
    n_for = 0
    n_rev = 0
    while heap_size > 0:
        mi = heap[0][1] >> 32
        i = k_idx[mi]
        r = heap[0][0]
        rpos = (r & 0xFFFFFFFF) >> 1
        qp = int(q_pos[i])
        span = int(q_span[i])
        occ = int(cnt[i])
        if (r & 1) == (qp & 1):  # forward strand
            x = ((r >> 32) << 33) | rpos
            pos_out = n_for
            n_for += 1
        else:
            x = ((r >> 32) << 33) | (1 << 32) \
                | (int(seg_len[r >> 32]) - (rpos + 1 - span) - 1)
            n_rev += 1
            pos_out = n_a - n_rev
        y = (span << 32) | (qp >> 1)
        y |= int(seg_id[i]) << MG_SEED_SEG_SHIFT
        if tandem[i]:
            y |= MG_SEED_TANDEM
        y |= min(occ, 255) << MG_SEED_OCC_SHIFT
        ax[pos_out] = x
        ay[pos_out] = y
        hit = heap[0][1] & 0xFFFFFFFF
        if hit < occ - 1:
            heap[0][1] += 1
            heap[0][0] = int(gi.pos[start[i] + hit + 1])
        else:
            heap[0] = heap[heap_size - 1]
            heap_size -= 1
        _heapdown(0, heap_size, heap)
    # reverse-strand anchors were filled from the end in descending order
    if n_a > n_for + n_rev:
        ax[n_for: n_for + n_rev] = ax[n_a - n_rev:]
        ay[n_for: n_for + n_rev] = ay[n_a - n_rev:]
        n_a = n_for + n_rev
        ax, ay = ax[:n_a], ay[:n_a]
    return ax, ay, int(rep_len), mini_pos


def collect_seed_hits(gi: MinimizerIndex, opt: MapOptions, max_occ: int,
                      mv_x: np.ndarray, mv_y: np.ndarray, qname=None):
    """Index lookups + anchor construction + exact-order sort
    (collect_matches + collect_seed_hits, map-algo.c:58-192).

    Returns (ax, ay, rep_len, mini_pos).  With -D (NO_DIAG) and a
    query name, hits on the query's own diagonal are dropped.
    """
    n_mv = len(mv_x)
    if n_mv == 0:
        return (np.empty(0, U64), np.empty(0, U64), 0, np.empty(0, np.int64))

    minier = mv_x >> U64(8)
    start, cnt = gi.get_many(minier)

    q_pos = (mv_y & U64(0xFFFFFFFF)).astype(np.int64)
    q_span = (mv_x & U64(0xFF)).astype(np.int64)
    seg_id = (mv_y >> U64(32)).astype(np.int64)

    over = cnt >= max_occ
    kept = ~over

    # repeat-length accounting over high-occurrence minimizers
    # (map-algo.c:72-77)
    rep_len = 0
    rep_st = rep_en = 0
    for i in np.nonzero(over)[0]:
        en = (q_pos[i] >> 1) + 1
        st = en - q_span[i]
        if st > rep_en:
            rep_len += rep_en - rep_st
            rep_st, rep_en = st, en
        else:
            rep_en = en
    rep_len += rep_en - rep_st

    # tandem flag: same minimizer as an adjacent query minimizer
    tandem = np.zeros(n_mv, dtype=bool)
    if n_mv > 1:
        same_prev = minier[1:] == minier[:-1]
        tandem[1:] |= same_prev
        tandem[:-1] |= same_prev

    k_idx = np.nonzero(kept)[0]
    mini_pos = (q_pos[k_idx] >> 1).astype(np.int64)
    k_cnt = cnt[k_idx]
    n_a = int(k_cnt.sum())
    if n_a == 0:
        return (np.empty(0, U64), np.empty(0, U64), int(rep_len), mini_pos)

    # expand matches to hits
    m_rep = np.repeat(np.arange(len(k_idx)), k_cnt)
    offs = np.concatenate([np.zeros(1, np.int64),
                           np.cumsum(k_cnt)[:-1]])
    hit_off = np.arange(n_a, dtype=np.int64) - offs[m_rep]
    r = gi.pos[start[k_idx][m_rep] + hit_off]

    if qname is not None and (opt.flag & MG_M_NO_DIAG):
        # skip self-diagonal matches (-D; map-algo.c:167-177)
        keep_hit = np.ones(n_a, dtype=bool)
        for h in range(n_a):
            rk = int(r[h])
            s = gi.g.seg[rk >> 32]
            if s.snid >= 0 and gi.g.sseq:
                gname = gi.g.sseq[s.snid].name
                g_pos = s.soff + (rk & 0xFFFFFFFF)
            else:
                gname = s.name
                g_pos = rk & 0xFFFFFFFF
            if g_pos == int(q_pos[k_idx][m_rep[h]]) and qname == gname:
                keep_hit[h] = False
        m_rep = m_rep[keep_hit]
        r = r[keep_hit]
        n_a = len(r)
        if n_a == 0:
            return (np.empty(0, U64), np.empty(0, U64), int(rep_len),
                    mini_pos)

    mq_pos = q_pos[k_idx][m_rep]
    mq_span = q_span[k_idx][m_rep]
    mseg = seg_id[k_idx][m_rep]
    mtan = tandem[k_idx][m_rep]
    mocc = np.minimum(k_cnt, 255)[m_rep]

    rid = (r >> U64(32)).astype(np.int64)
    rpos = ((r & U64(0xFFFFFFFF)) >> U64(1)).astype(np.int64)
    rev = ((r.astype(np.int64) ^ mq_pos) & 1).astype(np.int64)

    seg_len = _seg_len(gi.g)
    tpos = np.where(rev == 0, rpos, seg_len[rid] - (rpos + 1 - mq_span) - 1)
    ax = (rid.astype(np.uint64) << U64(33)) \
        | (rev.astype(np.uint64) << U64(32)) | tpos.astype(np.uint64)
    ay = (mocc.astype(np.uint64) << U64(MG_SEED_OCC_SHIFT)) \
        | (mseg.astype(np.uint64) << U64(MG_SEED_SEG_SHIFT)) \
        | np.where(mtan, U64(MG_SEED_TANDEM), U64(0)) \
        | (mq_span.astype(np.uint64) << U64(32)) \
        | (mq_pos >> 1).astype(np.uint64)

    perm = radix_argsort(ax)
    return ax[perm], ay[perm], int(rep_len), mini_pos


def collect_native(gi: MinimizerIndex, opt: MapOptions, max_occ: int,
                   seq: str):
    """Whole seed-collection stage in one native call
    (native/mgt_collect.c): sketch + flat-table probe + anchor build +
    reference-exact sort.  Returns (ax, ay, rep_len, mini_pos, n_mv),
    or None for the Python path (empty index, or the engine bails)."""
    global _collect_cfg
    if len(gi.keys) == 0:
        return None
    lib = get_lib()
    if not _collect_cfg:
        lib.mgt_collect.restype = ct.c_int64
        lib.mgt_collect.argtypes = (
            [ct.c_char_p] + [ct.c_int64] * 4
            + [ct.c_void_p] * 3 + [ct.c_int64, ct.c_void_p, ct.c_void_p]
            + [ct.c_void_p, ct.c_int64]               # probe table
            + [ct.c_void_p, ct.c_int64]
            + [ct.c_void_p] * 2 + [ct.c_int64]
            + [ct.c_void_p, ct.c_int64] + [ct.c_void_p])
        _collect_cfg = True
    cptr = get_collect_ctx(gi)
    qb = seq.encode("latin-1")
    qlen = len(qb)
    bufs = getattr(_CTLS, "col", None)
    if bufs is None or len(bufs[0]) < qlen + 128:
        bufs = (np.empty(2 * (max(qlen, 2048) // 2 + 64) + 64,
                         dtype=np.uint64),   # mv records (2 u64 each)
                np.empty(1 << 14, dtype=np.uint64),
                np.empty(1 << 14, dtype=np.uint64),
                np.empty(1 << 13, dtype=np.int64),
                np.empty(4, dtype=np.int64))
        _CTLS.col = bufs
    mv, ax, ay, mp, meta = bufs
    while True:
        r = lib.mgt_collect(
            qb, qlen, gi.w, gi.k, max_occ,
            cptr[0], cptr[1], cptr[2], cptr[3], cptr[4], cptr[5],
            cptr[6], cptr[7],
            mv.ctypes.data, len(mv) // 2,
            ax.ctypes.data, ay.ctypes.data, len(ax),
            mp.ctypes.data, len(mp), meta.ctypes.data)
        if r == 0:
            n_a, n_mv, rep_len, n_mini = (int(x) for x in meta)
            return (ax[:n_a].copy(), ay[:n_a].copy(), rep_len,
                    mp[:n_mini].copy(), n_mv)
        if r != -1:
            return None
        # grow only the buffers the engine reported too small
        # (meta[0] = anchors needed, meta[1] = minimizer records needed)
        need_mv = 2 * (int(meta[1]) + 64)
        need_a = int(meta[0]) + 64
        need_mp = int(meta[1]) + 64
        bufs = (mv if len(mv) >= need_mv
                else np.empty(need_mv + (need_mv >> 1), dtype=np.uint64),
                ax if len(ax) >= need_a
                else np.empty(need_a + (need_a >> 1), dtype=np.uint64),
                ay if len(ay) >= need_a
                else np.empty(need_a + (need_a >> 1), dtype=np.uint64),
                mp if len(mp) >= need_mp
                else np.empty(need_mp + (need_mp >> 1), dtype=np.int64),
                meta)
        if bufs[0] is mv and bufs[1] is ax and bufs[3] is mp:
            return None      # the engine asks for nothing bigger: bail
        _CTLS.col = bufs
        mv, ax, ay, mp, meta = bufs
