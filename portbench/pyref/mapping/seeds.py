"""Query sketching and seed-hit (anchor) collection.

Anchor packing (map-algo.c:152-192):
  a.x = seg<<33 | rev<<32 | seg_pos
  a.y = occ<<56 | seg_id<<48 | flags | span<<32 | q_pos
sorted by x with the reference-exact radix permutation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..index.midx import MinimizerIndex
from ..index.sketch import sketch
from ..options import MG_SEED_OCC_SHIFT, MG_SEED_SEG_SHIFT, MG_SEED_TANDEM, MapOptions
from ..utils.ksort import radix_argsort

U64 = np.uint64


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
                              seqs: List[str], mesh=None):
    """collect_minimizers with the sketch on device, chunk-halo exact
    for arbitrarily long queries (contig/chromosome scale): reuses the
    index builder's chunked sweep (index/midx_device.py — an emission
    at payload position p is fully determined by bases
    [p-(w+k+1), p+w], so overlapping chunks reproduce the host stream
    byte-identically).  With `mesh`, chunk batches shard data-parallel
    across the mesh (SURVEY §5/§7: one long query split over devices).
    Output == collect_minimizers bit-for-bit; reference semantics
    map-algo.c:34-45."""
    from ..index.midx_device import sketch_segments_device

    sk = sketch_segments_device([s.upper() for s in seqs], gi.w, gi.k,
                                mesh=mesh)
    xs, ys = [], []
    total = 0
    for i, ((x, y), ql) in enumerate(zip(sk, qlens)):
        y = y | (np.uint64(i) << np.uint64(32))
        y = y + U64((total << 1) & 0xFFFFFFFFFFFFFFFF)
        xs.append(x)
        ys.append(y)
        total += ql
    if not xs:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64)
    return np.concatenate(xs), np.concatenate(ys)


def _heap_lt(a, b) -> bool:
    return a[0] > b[0]


def _heapdown(i: int, n: int, l: list) -> None:
    """ks_heapdown (ksort.h:43-53): max-heap w.r.t. heap_lt = (x >)."""
    k = i
    tmp = l[i]
    while True:
        k = (k << 1) + 1
        if k >= n:
            break
        if k != n - 1 and _heap_lt(l[k], l[k + 1]):
            k += 1
        if _heap_lt(l[k], tmp):
            break
        l[i] = l[k]
        i = k
    l[i] = tmp


def _heapmake(n: int, l: list) -> None:
    for i in range((n >> 1) - 1, -1, -1):
        _heapdown(i, n, l)


def collect_seed_hits_heap(gi: MinimizerIndex, opt: MapOptions, max_occ: int,
                           mv_x: np.ndarray, mv_y: np.ndarray):
    """Heap-merge seed collection (collect_seed_hits_heap,
    map-algo.c:93-150): anchors come out sorted by construction.
    Used by the short-read presets (--heap-sort)."""
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
    seg_len = np.asarray([s.len for s in gi.g.seg], dtype=np.int64)

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
                | (seg_len[r >> 32] - (rpos + 1 - span) - 1)
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
                      mv_x: np.ndarray, mv_y: np.ndarray,
                      qname=None):
    """Index lookups + anchor construction + exact-order sort
    (collect_matches + collect_seed_hits, map-algo.c:58-192).

    Returns (ax, ay, rep_len, mini_pos).
    """
    from ..options import MG_M_NO_DIAG
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

    # repeat-length accounting over high-occurrence minimizers (map-algo.c:72-77)
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

    seg_len = getattr(gi, "_seg_len_arr", None)
    if seg_len is None or len(seg_len) != gi.g.n_seg:
        seg_len = np.asarray([s.len for s in gi.g.seg], dtype=np.int64)
        gi._seg_len_arr = seg_len
    tpos = np.where(rev == 0, rpos, seg_len[rid] - (rpos + 1 - mq_span) - 1)
    ax = (rid.astype(np.uint64) << U64(33)) | (rev.astype(np.uint64) << U64(32)) \
        | tpos.astype(np.uint64)
    ay = (mocc.astype(np.uint64) << U64(MG_SEED_OCC_SHIFT)) \
        | (mseg.astype(np.uint64) << U64(MG_SEED_SEG_SHIFT)) \
        | np.where(mtan, U64(MG_SEED_TANDEM), U64(0)) \
        | (mq_span.astype(np.uint64) << U64(32)) \
        | (mq_pos >> 1).astype(np.uint64)

    perm = radix_argsort(ax)
    return ax[perm], ay[perm], int(rep_len), mini_pos


_native_collect_cfg = False
import threading as _threading
_CTLS = _threading.local()


def get_collect_ctx(gi):
    """Flat index-table pointers for the native collectors, cached on
    the index (keys/key_start/key_cnt/n_keys/pos/seg_len), plus the
    O(1) open-addressing probe table (built once per index)."""
    ctx = getattr(gi, "_collect_ctx", None)
    if ctx is None:
        import ctypes as ct

        from ..utils.native import get_lib
        seg_len = getattr(gi, "_seg_len_arr", None)
        if seg_len is None or len(seg_len) != gi.g.n_seg:
            seg_len = np.asarray([t.len for t in gi.g.seg],
                                 dtype=np.int64)
            gi._seg_len_arr = seg_len
        keys = np.ascontiguousarray(gi.keys, dtype=np.uint64)
        kst = np.ascontiguousarray(gi.key_start, dtype=np.int64)
        kcn = np.ascontiguousarray(gi.key_cnt, dtype=np.int64)
        pos = np.ascontiguousarray(gi.pos, dtype=np.uint64)
        lib = get_lib()
        htab, n_slots = None, 0
        # 16 B/slot at >= 2x load headroom; above ~128 M keys (a 4 GB
        # table) the collectors fall back to binary search over the
        # sorted key array instead of paying the memory.
        # MGT_PROBE_KEYCAP overrides the threshold (tests force the
        # fallback without a 134 M-key build; parity is pinned in
        # tests/test_native_engines.py::test_probe_fallback_parity)
        import os as _os
        keycap = int(_os.environ.get("MGT_PROBE_KEYCAP", 1 << 27))
        if lib is not None and hasattr(lib, "mgt_collect_hash_build") \
                and 0 < len(keys) <= keycap:
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


def collect_native(gi: MinimizerIndex, opt: MapOptions, max_occ: int,
                   seq: str):
    """Whole seed-collection stage in one native call
    (native/mgt_collect.c): sketch + flat-table probe + anchor build +
    reference-exact sort.  Returns (ax, ay, rep_len, mini_pos, n_mv)
    or None for the Python path (no native lib / empty index)."""
    global _native_collect_cfg
    import ctypes as ct

    from ..utils.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "mgt_collect") \
            or len(gi.keys) == 0:
        return None
    if not _native_collect_cfg:
        lib.mgt_collect.restype = ct.c_int64
        lib.mgt_collect.argtypes = (
            [ct.c_char_p] + [ct.c_int64] * 4
            + [ct.c_void_p] * 3 + [ct.c_int64, ct.c_void_p, ct.c_void_p]
            + [ct.c_void_p, ct.c_int64]               # probe table
            + [ct.c_void_p, ct.c_int64]
            + [ct.c_void_p] * 2 + [ct.c_int64]
            + [ct.c_void_p, ct.c_int64] + [ct.c_void_p])
        _native_collect_cfg = True
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
        # (meta[0]=anchors needed, meta[1]=minimizer records needed);
        # blind doubling of the others can explode on low-complexity
        # reads where the mv shortfall repeats
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
            return None      # engine asks for nothing bigger: bail
        _CTLS.col = bufs
        mv, ax, ay, mp, meta = bufs
