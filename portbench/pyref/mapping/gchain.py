"""Graph chaining: DP over linear chains with graph reachability
(mg_gchain1_dp, gchain1.c:62-240), chain materialization with path
bridging (mg_gchain_gen, gchain1.c:443-520), and per-chain extras
(mg_gchain_extra, gchain1.c:242-297).
"""
from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..graph.shortk import PathDst, shortest_k
from ..options import MG_MAX_SHORT_K
from ..utils.hashes import kh_hash_uint32, mg_log2
from ..utils.ksort import radix_argsort
from .lchain import LChain, _i32, chain_backtrack

INT32_MIN = -0x80000000
U64 = np.uint64
F32 = np.float32
U32M = 0xFFFFFFFF


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
    p: Optional[Cigar] = None
    ds: Optional[object] = None  # DsString


@dataclass
class GChains:
    """mg_gchains_t (minigraph.h:140-146)."""
    gc: List[GChain] = field(default_factory=list)
    lc: List[LLChain] = field(default_factory=list)
    ax: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.uint64))
    ay: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.uint64))
    rep_len: int = 0

    @property
    def n_gc(self):
        return len(self.gc)

    @property
    def n_lc(self):
        return len(self.lc)

    @property
    def n_a(self):
        return len(self.ax)


def _target_dist(g, l0: LChain, l1: LChain) -> int:
    """mg_target_dist (gchain1.c:31-36)."""
    return (l1.qs - l0.qe) - (g.seg[l0.v >> 1].len - l0.re) \
        + (g.seg[l1.v >> 1].len - l1.rs)


def _cal_sc(dj: PathDst, li: LChain, lc: List[LChain], ay: np.ndarray,
            a_i, f: np.ndarray, bw: int, ref_bonus: int,
            chn_pen_gap: float) -> int:
    """Transition score for graph chaining (cal_sc, gchain1.c:38-60)."""
    if dj.n_path == 0:
        return INT32_MIN
    segi = (int(ay[li.off]) >> 48) & 0xFF
    gap = dj.dist - dj.target_dist
    lj = lc[a_i[dj.meta]]
    segj = (int(ay[lj.off + lj.cnt - 1]) >> 48) & 0xFF
    if gap < 0:
        gap = -gap
    if segi == segj and gap > bw:
        return INT32_MIN
    if lj.qe <= li.qs:
        sc = li.score
    else:
        sc = int((li.qe - lj.qe) / (li.qe - li.qs) * li.score + 0.499)
    if dj.is_0:
        sc += ref_bonus
    lin_pen = F32(F32(chn_pen_gap) * F32(gap))
    log_pen = F32(mg_log2(gap)) if gap >= 2 else F32(0.0)
    sc -= int(F32(lin_pen + log_pen))
    sc += int(f[dj.meta])
    return sc


_native_gdp_cfg = False


def _gdp_core(g, arrs, n_lc, qlen, max_dist_g, max_dist_q, bw, max_skip,
              ref_bonus, chn_pen_gap, mask_level, ay):
    """Shared native call (native/mgt_gchain.c mgt_gchain1_dp).

    arrs = (v, off, cnt, score, qs, qe, rs, re) int64 arrays.  Returns
    (n_u, u, order, dist_pre, hash_pre, inner_pre) or None on fallback
    (lib missing, debug dumps requested, or engine overflow)."""
    global _native_gdp_cfg
    import ctypes as ct

    from ..options import DBG, MG_DBG_GC1
    from ..utils.native import get_lib
    if DBG["flag"] & MG_DBG_GC1:
        return None
    lib = get_lib()
    if lib is None or not hasattr(lib, "mgt_gchain1_dp"):
        return None
    if not _native_gdp_cfg:
        lib.mgt_gchain1_dp.restype = ct.c_int64
        lib.mgt_gchain1_dp.argtypes = \
            [ct.c_void_p] * 4 + [ct.c_int64, ct.c_void_p, ct.c_int64] \
            + [ct.c_void_p] * 9 \
            + [ct.c_int64] * 6 + [ct.c_double] * 2 + [ct.c_int64] \
            + [ct.c_void_p] * 5
        _native_gdp_cfg = True
    lv, loff, lcnt, lscore, lqs, lqe, lrs, lre = arrs
    seg_len = getattr(g, "_seg_len_arr", None)
    if seg_len is None or len(seg_len) != g.n_seg:
        seg_len = np.asarray([s.len for s in g.seg], dtype=np.int64)
        g._seg_len_arr = seg_len
    idx = g.idx
    if idx.dtype != np.int64 or not idx.flags["C_CONTIGUOUS"]:
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        g.idx = idx
    ay = ay if ay.flags["C_CONTIGUOUS"] else np.ascontiguousarray(ay)
    u = np.empty(n_lc, dtype=np.uint64)
    order = np.empty(n_lc, dtype=np.int64)
    dist_pre = np.empty(n_lc, dtype=np.int64)
    hash_pre = np.empty(n_lc, dtype=np.uint32)
    inner_pre = np.empty(n_lc, dtype=np.int64)
    n_u = lib.mgt_gchain1_dp(
        idx.ctypes.data, g.arc_w.ctypes.data, g.arc_lv.ctypes.data,
        g.arc_rank.ctypes.data, len(idx), seg_len.ctypes.data,
        n_lc, lv.ctypes.data, loff.ctypes.data, lcnt.ctypes.data,
        lscore.ctypes.data, lqs.ctypes.data, lqe.ctypes.data,
        lrs.ctypes.data, lre.ctypes.data, ay.ctypes.data,
        qlen, max_dist_g, max_dist_q, bw, max_skip, ref_bonus,
        chn_pen_gap, mask_level, MG_MAX_SHORT_K,
        u.ctypes.data, order.ctypes.data, dist_pre.ctypes.data,
        hash_pre.ctypes.data, inner_pre.ctypes.data)
    if n_u < 0:
        return None
    return n_u, u, order, dist_pre, hash_pre, inner_pre


def _gchain1_dp_native(g, lc: List[LChain], qlen: int, max_dist_g: int,
                       max_dist_q: int, bw: int, max_skip: int,
                       ref_bonus: int, chn_pen_gap: float, mask_level: float,
                       ay: np.ndarray):
    """Native DP over an LChain object list; returns None on fallback."""
    n_lc = len(lc)
    it = np.int64
    arrs = (np.fromiter((r.v for r in lc), it, n_lc),
            np.fromiter((r.off for r in lc), it, n_lc),
            np.fromiter((r.cnt for r in lc), it, n_lc),
            np.fromiter((r.score for r in lc), it, n_lc),
            np.fromiter((r.qs for r in lc), it, n_lc),
            np.fromiter((r.qe for r in lc), it, n_lc),
            np.fromiter((r.rs for r in lc), it, n_lc),
            np.fromiter((r.re for r in lc), it, n_lc))
    res = _gdp_core(g, arrs, n_lc, qlen, max_dist_g, max_dist_q, bw,
                    max_skip, ref_bonus, chn_pen_gap, mask_level, ay)
    if res is None:
        return None
    n_u, u, order, dist_pre, hash_pre, inner_pre = res
    for i, r in enumerate(lc):
        r.dist_pre = int(dist_pre[i])
        r.hash_pre = int(hash_pre[i])
        r.inner_pre = int(inner_pre[i])
    n_slots = int((u[:n_u] & np.uint64(U32M)).sum())
    swap = [lc[i] for i in order[:n_slots]]
    return n_u, u[:n_u].copy(), swap


def gchain1_dp_tab(g, tab, qlen: int, max_dist_g: int, max_dist_q: int,
                   bw: int, max_skip: int, ref_bonus: int,
                   chn_pen_gap: float, chn_pen_skip: float,
                   mask_level: float, ay: np.ndarray):
    """Graph-chaining DP over a native lchain TABLE (lchain_tail_tab)
    instead of LChain objects — the fused tail path.  Returns
    (n_u, u, swap) like gchain1_dp; LChain objects are only built for
    the slots that survive into graph chains."""
    n_lc = tab["n"]
    if n_lc == 0:
        return 0, np.empty(0, dtype=np.uint64), []
    arrs = (tab["v"], tab["off"], tab["cnt"], tab["score"],
            tab["qs"], tab["qe"], tab["rs"], tab["re"])
    res = _gdp_core(g, arrs, n_lc, qlen, max_dist_g, max_dist_q, bw,
                    max_skip, ref_bonus, chn_pen_gap, mask_level, ay)
    if res is None:
        # fallback: materialize objects and run the Python DP
        lc = [LChain(off=int(tab["off"][i]), cnt=int(tab["cnt"][i]),
                     v=int(tab["v"][i]), rs=int(tab["rs"][i]),
                     re=int(tab["re"][i]), qs=int(tab["qs"][i]),
                     qe=int(tab["qe"][i]), score=int(tab["score"][i]))
              for i in range(n_lc)]
        return gchain1_dp(g, lc, qlen, max_dist_g, max_dist_q, bw,
                          max_skip, ref_bonus, chn_pen_gap, chn_pen_skip,
                          mask_level, ay)
    n_u, u, order, dist_pre, hash_pre, inner_pre = res
    n_slots = int((u[:n_u] & np.uint64(U32M)).sum())
    sel = order[:n_slots]
    slots = {k: tab[k][sel] for k in
             ("v", "off", "cnt", "score", "qs", "qe", "rs", "re")}
    slots["dist_pre"] = dist_pre[sel]
    slots["hash_pre"] = hash_pre[sel]
    slots["inner_pre"] = inner_pre[sel]
    slots["n"] = n_slots
    return n_u, u[:n_u].copy(), slots


def gchain1_dp(g, lc: List[LChain], qlen: int, max_dist_g: int,
               max_dist_q: int, bw: int, max_skip: int, ref_bonus: int,
               chn_pen_gap: float, chn_pen_skip: float, mask_level: float,
               ay: np.ndarray):
    """Graph-chaining DP.  Returns (n_u, u, new_lc) where new_lc is the
    lchain list reordered into gchain layout."""
    n_lc = len(lc)
    if n_lc == 0:
        return 0, np.empty(0, dtype=np.uint64), lc
    nat = _gchain1_dp_native(g, lc, qlen, max_dist_g, max_dist_q, bw,
                             max_skip, ref_bonus, chn_pen_gap, mask_level,
                             ay)
    if nat is not None:
        return nat

    srt = np.empty(n_lc, dtype=np.uint64)
    a_i = np.empty(n_lc, dtype=np.int64)
    n_ext = 0
    for i, r in enumerate(lc):
        r.dist_pre = -1
        min_end_dist_g = g.seg[r.v >> 1].len - r.re
        if r.rs < min_end_dist_g:
            min_end_dist_g = r.rs
        is_isolated = 0
        if min_end_dist_g > max_dist_g:
            is_isolated = 1
        elif (min_end_dist_g >> 3) > r.score:
            is_isolated = 1
        srt[i] = U64(((is_isolated << 31) | r.qe) & U32M)
        a_i[i] = i
        if not is_isolated:
            n_ext += 1
    if n_ext < 2:
        u = np.asarray([(r.score << 32) | 1 for r in lc], dtype=np.uint64)
        return n_lc, u, lc
    perm = radix_argsort(srt)
    srt = srt[perm]
    a_i = a_i[perm]

    f = np.zeros(n_ext, dtype=np.int64)
    p = np.full(n_ext, -1, dtype=np.int64)
    t = np.full(n_ext, -1, dtype=np.int64)
    v = np.zeros(n_lc, dtype=np.int64)

    for i in range(n_ext):
        li = lc[a_i[i]]
        segi = (int(ay[li.off]) >> 48) & 0xFF
        # collect candidate predecessors
        x = li.qs + bw
        if x > qlen:
            x = qlen
        # find_max (gchain1.c:16-29): replicates the reference's code,
        # which in the mixed case returns the FIRST index with
        # srt >= x (its comment claims largest-below; parity follows
        # the code, not the comment)
        lo, hi = 0, i
        if i == 0:
            xj = -1
        elif srt[i - 1] < x:
            xj = i - 1
        elif srt[0] >= x:
            xj = -1
        else:
            s, e = 0, i
            while e > s:
                m = s + (e - s) // 2
                if srt[m] >= x:
                    e = m
                else:
                    s = m + 1
            xj = s
        dst: List[PathDst] = []
        n_skip = 0
        for j in range(xj, -1, -1):
            lj = lc[a_i[j]]
            if lj.qs >= li.qs:
                continue
            if lj.qe > li.qs:
                o = lj.qe - li.qs
                if o > (lj.qe - lj.qs) * mask_level \
                        or o > (li.qe - li.qs) * mask_level:
                    continue
            dq = li.qs - lj.qe
            segj = (int(ay[lj.off + lj.cnt - 1]) >> 48) & 0xFF
            if segi == segj:
                if dq > max_dist_q:
                    break
            else:
                if dq > max_dist_g and dq > max_dist_q:
                    break
            if li.v != lj.v:
                min_dist = li.rs + (g.seg[lj.v >> 1].len - lj.re)
                if min_dist > max_dist_g:
                    continue
                if segi == segj and min_dist - bw > li.qs - lj.qe:
                    continue
                target_dist = _target_dist(g, lj, li)
                if target_dist < 0:
                    continue
            elif lj.rs >= li.rs or lj.re >= li.re:
                continue
            else:
                dr = li.rs - lj.re
                w = dr - dq if dr > dq else dq - dr
                if segi == segj and w > bw:
                    continue
                if dr > max_dist_g or dr < -max_dist_g:
                    continue
                if lj.re > li.rs:
                    o = lj.re - li.rs
                    if o > (lj.re - lj.rs) * mask_level \
                            or o > (li.re - li.rs) * mask_level:
                        continue
                target_dist = _target_dist(g, lj, li)
            q = PathDst()
            q.inner = 1 if li.v == lj.v else 0
            q.v = lj.v ^ 1
            q.meta = j
            q.qlen = li.qs - lj.qe
            q.target_dist = target_dist
            q.target_hash = 0
            q.check_hash = 0
            dst.append(q)
            if t[j] == i:
                n_skip += 1
                if n_skip > max_skip:
                    break
            if p[j] >= 0:
                t[p[j]] = i
        # reachability
        shortest_k(g, li.v ^ 1, dst,
                   max_dist_g + (g.seg[li.v >> 1].len - li.rs),
                   MG_MAX_SHORT_K, False)
        kept = []
        for dj in dst:
            if dj.n_path == 0:
                continue
            sc = _cal_sc(dj, li, lc, ay, a_i, f, bw, ref_bonus, chn_pen_gap)
            if sc == INT32_MIN:
                continue
            if sc + li.score < 0:
                continue
            kept.append(dj)
        # DP
        from ..options import DBG, MG_DBG_GC1
        dbg_gc1 = bool(DBG["flag"] & MG_DBG_GC1)
        max_f, max_j, max_d, max_inner = li.score, -1, -1, 0
        max_hash = 0
        for dj in kept:
            sc = _cal_sc(dj, li, lc, ay, a_i, f, bw, ref_bonus, chn_pen_gap)
            if sc == INT32_MIN:
                continue
            if dbg_gc1:  # gchain1.c:195-198 stage dump
                lj = lc[a_i[dj.meta]]
                seg_len = g.seg[li.v >> 1].len
                sys.stderr.write(
                    "  [dst:%d] dst=%c%s[%d], n_path=%d, target=%d, "
                    "opt_dist=%d, score=%d, q_intv=[%d,%d), g_intv=[%d,%d)\n"
                    % (dj.meta, "><"[dj.v & 1], g.seg[dj.v >> 1].name,
                       dj.v, dj.n_path, dj.target_dist - seg_len,
                       dj.dist - seg_len, sc, lj.qs, lj.qe, lj.rs, lj.re))
            if sc > max_f:
                max_f, max_j = sc, dj.meta
                max_d, max_hash, max_inner = dj.dist, dj.hash, dj.inner
        f[i] = max_f
        p[i] = max_j
        li.dist_pre = max_d
        li.hash_pre = max_hash
        li.inner_pre = max_inner
        v[i] = v[max_j] if (max_j >= 0 and v[max_j] > max_f) else max_f
        if dbg_gc1:  # gchain1.c:206
            sys.stderr.write(" [opt:%d] opt=%d, max_f=%d\n"
                             % (a_i[i], max_j, max_f))

    from ..options import DBG, MG_DBG_GC1
    if DBG["flag"] & MG_DBG_GC1:  # gchain1.c:211-214
        mmax_f, mmax_i = 0, -1
        for i in range(n_ext):
            if f[i] > mmax_f:
                mmax_f, mmax_i = f[i], i
        i = mmax_i
        while i >= 0:
            sys.stderr.write(
                "[best] i=%d, seg=%s, max_f=%d, chn_pen_gap=%f\n"
                % (a_i[i], g.seg[lc[a_i[i]].v >> 1].name, f[i],
                   chn_pen_gap))
            i = p[i]

    u, vv, n_u, n_v = chain_backtrack(n_ext, f, p, 0, 0, 0x7FFFFFFF,
                                      n_lc - n_ext)
    u = list(u[:n_u])
    vv = list(vv)
    for i in range(n_lc - n_ext):
        u.append((lc[a_i[n_ext + i]].score << 32) | 1)
        vv.append(n_ext + i)
        n_u += 1
        n_v += 1
    # reorder lchains into gchain layout
    swap: List[LChain] = []
    k = 0
    for i in range(n_u):
        ni = int(u[i]) & U32M
        k0 = k
        for j in range(ni):
            swap.append(lc[a_i[vv[k0 + (ni - j - 1)]]])
            k += 1
    assert k == n_v
    return n_u, np.asarray(u, dtype=np.uint64), swap


# ----------------------------------------------------------------------
# gchain materialization
# ----------------------------------------------------------------------

class _BridgeAux:
    def __init__(self, g, es, qseq, n_seg):
        self.g = g
        self.es = es
        self.qseq = qseq
        self.n_seg = n_seg
        self.llc: List[LLChain] = []
        self.a_out_x: List[np.ndarray] = []
        self.a_out_y: List[np.ndarray] = []
        self.n_a = 0


def _copy_lchain(aux: _BridgeAux, p: LChain, ax, ay, ed: int) -> None:
    q = LLChain(cnt=p.cnt, v=p.v, score=p.score, ed=ed, off=aux.n_a)
    aux.a_out_x.append(ax[p.off: p.off + p.cnt].copy())
    aux.a_out_y.append(ay[p.off: p.off + p.cnt].copy())
    aux.n_a += p.cnt
    aux.llc.append(q)


def _bridge_shortk(aux: _BridgeAux, l0: LChain, l1: LChain) -> int:
    dst = PathDst()
    dst.v = l0.v ^ 1
    assert l1.dist_pre >= 0
    dst.target_dist = l1.dist_pre
    dst.target_hash = l1.hash_pre
    dst.check_hash = 1
    path = shortest_k(aux.g, l1.v ^ 1, [dst], dst.target_dist,
                      MG_MAX_SHORT_K, True)
    if not path or dst.target_hash != dst.hash:
        sys.stderr.write(
            f"[W::bridge] {'><'[(l1.v ^ 1) & 1]}"
            f"{aux.g.seg[l1.v >> 1].name}[{l1.v ^ 1}] -> "
            f"{'><'[(l0.v ^ 1) & 1]}{aux.g.seg[l0.v >> 1].name}"
            f"[{l0.v ^ 1}], dist={dst.dist}, target_dist={dst.target_dist}; "
            f"chain skiped.\n")
        return -1
    for s in range(len(path) - 2, 0, -1):
        aux.llc.append(LLChain(off=0, cnt=0, score=0, v=path[s].v ^ 1, ed=-1))
    return 0


def _bridge_gwfa(aux: _BridgeAux, kmer_size: int, gdp_max_ed: int,
                 l0: LChain, l1: LChain):
    """GWFA bridging (bridge_gwfa, gchain1.c:349-381).  Returns (found, ed)."""
    from ..align.gwfa import gwfa_bridge
    qs = l0.qe - kmer_size
    qe = l1.qs + kmer_size
    end0 = l0.re - kmer_size
    end1 = l1.rs + kmer_size - 1
    s, walk = gwfa_bridge(aux.g, aux.es, aux.qseq[qs:qe], l0.v, end0,
                          l1.v, end1, gdp_max_ed)
    if s < 0:
        return 0, -1
    for j in range(1, len(walk) - 1):
        aux.llc.append(LLChain(off=0, cnt=0, score=0, v=walk[j], ed=-1))
    return 1, s


def _bridge_lchains(gc_out: GChains, aux: _BridgeAux, kmer_size: int,
                    gdp_max_ed: int, l0: LChain, l1: LChain, ax, ay) -> int:
    if l1.v != l0.v:
        ed = -1
        ret = 0
        if aux.n_seg > 1:
            ret = _bridge_shortk(aux, l0, l1)
        else:
            found, ed = _bridge_gwfa(aux, kmer_size, gdp_max_ed, l0, l1)
            if not found:
                ret = _bridge_shortk(aux, l0, l1)
        if ret < 0:
            return -1
        _copy_lchain(aux, l1, ax, ay, ed)
    else:
        t = aux.llc[-1]
        k = 0
        while k < l1.cnt:
            akx = _i32(int(ax[l1.off + k]))
            aky = _i32(int(ay[l1.off + k]))
            if akx > l0.re and aky > l0.qe:
                break
            k += 1
        if k < l1.cnt:
            t.cnt += l1.cnt - k
            t.score += l1.score
            aux.a_out_x.append(ax[l1.off + k: l1.off + l1.cnt].copy())
            aux.a_out_y.append(ay[l1.off + k: l1.off + l1.cnt].copy())
            aux.n_a += l1.cnt - k
    return 0


def _resolve_overlap(l0: LChain, l1: LChain, ax, ay) -> None:
    """resolve_overlap (gchain1.c:409-441)."""
    x = _i32(int(ax[l1.off]))
    y = _i32(int(ay[l1.off]))
    j = l0.cnt - 1
    while j >= 0:
        if _i32(int(ay[l0.off + j])) <= y and \
                (l0.v != l1.v or _i32(int(ax[l0.off + j])) <= x):
            break
        j -= 1
    shift0 = l0.cnt - 1 - j
    x = _i32(int(ax[l0.off + l0.cnt - 1]))
    y = _i32(int(ay[l0.off + l0.cnt - 1]))
    j = 0
    while j < l1.cnt:
        if _i32(int(ay[l1.off + j])) >= y and \
                (l0.v != l1.v or _i32(int(ax[l1.off + j])) >= x):
            break
        j += 1
    shift1 = j
    assert shift1 < l1.cnt
    if shift0 > 0:
        l0.cnt -= shift0
        if l0.cnt:
            l0.qe = _i32(int(ay[l0.off + l0.cnt - 1])) + 1
            l0.re = _i32(int(ax[l0.off + l0.cnt - 1])) + 1
    if shift1 > 0:
        l1.off += shift1
        l1.cnt -= shift1
        span = (int(ay[l1.off]) >> 32) & 0xFF
        l1.qs = _i32(int(ay[l1.off])) + 1 - span
        l1.rs = _i32(int(ax[l1.off])) + 1 - span
    if l0.cnt == 0:
        l0.qs = l0.qe = l1.qs
        l0.rs = l0.re = l1.rs


def gchain_gen(g, es, n_u: int, u: np.ndarray, lc: List[LChain],
               ax: np.ndarray, ay: np.ndarray, hash_: int, min_gc_cnt: int,
               min_gc_score: int, gdp_max_ed: int, n_seg: int,
               qseq: str) -> GChains:
    """mg_gchain_gen (gchain1.c:443-520)."""
    gcs = GChains()
    if n_u == 0 or len(lc) == 0:
        return gcs
    aux = _BridgeAux(g, es, qseq, n_seg)
    kmer_size = (int(ay[0]) >> 32) & 0xFF
    st = 0
    for i in range(n_u):
        nui = int(u[i]) & 0xFFFFFFFF
        m = sum(lc[st + j].cnt for j in range(nui))
        if m >= min_gc_cnt and (int(u[i]) >> 32) >= min_gc_score:
            n_a0 = aux.n_a
            n_llc0 = len(aux.llc)
            gci = GChain(score=int(u[i]) >> 32, off=n_llc0)
            h = hash_
            for j in range(nui):
                pj = lc[st + j]
                h = (h + kh_hash_uint32(pj.qs & 0xFFFFFFFF)
                     + kh_hash_uint32(pj.re & 0xFFFFFFFF)
                     + kh_hash_uint32(pj.v)) & 0xFFFFFFFF
            gci.hash = kh_hash_uint32(h)
            for j in range(1, nui):
                _resolve_overlap(lc[st + j - 1], lc[st + j], ax, ay)
            _copy_lchain(aux, lc[st], ax, ay, -1)
            j0 = 0
            for j in range(1, nui):
                l0, l1 = lc[st + j0], lc[st + j]
                if l1.cnt > 0:
                    ret = _bridge_lchains(gcs, aux, kmer_size, gdp_max_ed,
                                          l0, l1, ax, ay)
                    if ret < 0:
                        for tt in range(j0, j):
                            ret = _bridge_lchains(gcs, aux, kmer_size,
                                                  gdp_max_ed, lc[st + tt],
                                                  lc[st + tt + 1], ax, ay)
                            assert ret >= 0
                    j0 = j
            gci.cnt = len(aux.llc) - n_llc0
            gci.n_anchor = aux.n_a - n_a0
            gcs.gc.append(gci)
        st += nui
    gcs.lc = aux.llc
    if aux.a_out_x:
        gcs.ax = np.concatenate(aux.a_out_x)
        gcs.ay = np.concatenate(aux.a_out_y)
    gchain_extra(g, gcs)
    gchain_sort_by_score(gcs)
    return gcs


def _slots_to_objects(slots) -> List[LChain]:
    """Materialize LChain objects from a gchain-layout slot table."""
    return [LChain(off=int(slots["off"][i]), cnt=int(slots["cnt"][i]),
                   v=int(slots["v"][i]), rs=int(slots["rs"][i]),
                   re=int(slots["re"][i]), qs=int(slots["qs"][i]),
                   qe=int(slots["qe"][i]), score=int(slots["score"][i]),
                   dist_pre=int(slots["dist_pre"][i]),
                   hash_pre=int(slots["hash_pre"][i]),
                   inner_pre=int(slots["inner_pre"][i]))
            for i in range(slots["n"])]


_native_gen_cfg = False
import threading as _threading

_TLS = _threading.local()


def _get_gen_scratch(llc_cap, n_a_total, gc_cap):
    """Reused output buffers + cached pointer ints for the native
    gchain materialization calls.  Thread-local: the whole-tail call
    releases the GIL, so tails may run on a thread pool."""
    sc = getattr(_TLS, "gen", None)
    if sc is None or len(sc) < 8 or sc[0].shape[1] < llc_cap \
            or len(sc[1]) < n_a_total or sc[3].shape[1] < gc_cap:
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
        # native select outputs (parent/mapq/n_sub/subsc), appended
        # last so the sc[:6] / sc[6] layout stays stable
        sel_tab = np.empty((4, max(gc_cap, 64)), dtype=np.int64)
        sc = bufs + (ptrs, sel_tab)
        _TLS.gen = sc
    return sc



def gchain_gen_tab(g, es, n_u: int, u: np.ndarray, lc, ax: np.ndarray,
                   ay: np.ndarray, hash_: int, min_gc_cnt: int,
                   min_gc_score: int, gdp_max_ed: int, n_seg: int,
                   qseq: str) -> GChains:
    """mg_gchain_gen through the native engine (native/mgt_gchain.c
    mgt_gchain_gen) when `lc` is a slot table from gchain1_dp_tab;
    falls back to the Python path (object list or engine bailout)."""
    global _native_gen_cfg
    import ctypes as ct

    from ..utils.native import get_lib

    if isinstance(lc, list):
        return gchain_gen(g, es, n_u, u, lc, ax, ay, hash_, min_gc_cnt,
                          min_gc_score, gdp_max_ed, n_seg, qseq)
    slots = lc
    lib = get_lib()
    if lib is None or not hasattr(lib, "mgt_gchain_gen") or n_u == 0 \
            or slots["n"] == 0:
        if n_u == 0 or slots["n"] == 0:
            gcs = GChains()
            return gcs
        return gchain_gen(g, es, n_u, u, _slots_to_objects(slots), ax, ay,
                          hash_, min_gc_cnt, min_gc_score, gdp_max_ed,
                          n_seg, qseq)
    if not _native_gen_cfg:
        lib.mgt_gchain_gen.restype = ct.c_int64
        lib.mgt_gchain_gen.argtypes = \
            [ct.c_void_p] * 4 + [ct.c_int64, ct.c_void_p] \
            + [ct.c_void_p] * 6 + [ct.c_char_p] \
            + [ct.c_int64] + [ct.c_void_p] * 11 \
            + [ct.c_void_p] * 2 + [ct.c_int64, ct.c_char_p, ct.c_int64] \
            + [ct.c_uint32] + [ct.c_int64] * 5 \
            + [ct.c_int64] * 3 + [ct.c_void_p] * 13
        _native_gen_cfg = True
    from ..align.gwfa import _flat_graph
    gw = _flat_graph(g, es)
    seg_len = getattr(g, "_seg_len_arr", None)
    if seg_len is None or len(seg_len) != g.n_seg:
        seg_len = np.asarray([s.len for s in g.seg], dtype=np.int64)
        g._seg_len_arr = seg_len
    idx = g.idx
    if idx.dtype != np.int64 or not idx.flags["C_CONTIGUOUS"]:
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        g.idx = idx
    qb = qseq.encode("latin-1")
    n_slots = slots["n"]
    n_a_total = len(ax)
    llc_cap = n_slots + 1024
    gc_cap = max(n_u, 1)
    # per-read scratch reused across calls (sized to the max seen)
    sc = _get_gen_scratch(llc_cap, n_a_total, gc_cap)
    o_llc, o_ax, o_ay, g_tab, g_hash, g_extra = sc[:6]
    llc_cap = o_llc.shape[1]
    n_gc = lib.mgt_gchain_gen(
        idx.ctypes.data, g.arc_w.ctypes.data, g.arc_lv.ctypes.data,
        g.arc_rank.ctypes.data, len(idx), seg_len.ctypes.data,
        gw[0].ctypes.data, gw[1].ctypes.data, gw[2].ctypes.data,
        gw[3].ctypes.data, gw[4].ctypes.data, gw[5].ctypes.data, gw[6],
        n_u, u.ctypes.data,
        slots["v"].ctypes.data, slots["off"].ctypes.data,
        slots["cnt"].ctypes.data, slots["score"].ctypes.data,
        slots["qs"].ctypes.data, slots["qe"].ctypes.data,
        slots["rs"].ctypes.data, slots["re"].ctypes.data,
        slots["dist_pre"].ctypes.data,
        np.ascontiguousarray(slots["hash_pre"],
                             dtype=np.uint32).ctypes.data,
        ax.ctypes.data, ay.ctypes.data, n_a_total, qb, len(qb),
        hash_, min_gc_cnt, min_gc_score, gdp_max_ed, n_seg,
        MG_MAX_SHORT_K,
        llc_cap, len(o_ax), g_tab.shape[1],
        o_llc[0].ctypes.data, o_llc[1].ctypes.data, o_llc[2].ctypes.data,
        o_llc[3].ctypes.data, o_llc[4].ctypes.data,
        o_ax.ctypes.data, o_ay.ctypes.data,
        g_tab[0].ctypes.data, g_tab[1].ctypes.data, g_tab[2].ctypes.data,
        g_tab[3].ctypes.data, g_hash.ctypes.data, g_extra.ctypes.data)
    if n_gc < 0:
        # alloc/cap overflow or bridge-failure warning: Python path
        return gchain_gen(g, es, n_u, u, _slots_to_objects(slots), ax, ay,
                          hash_, min_gc_cnt, min_gc_score, gdp_max_ed,
                          n_seg, qseq)
    return _gcs_from_scratch(n_gc, sc)


def _get_gfull_ctx(g, es):
    """Per-(graph, edseq) constant leading args for the native graph-
    chain calls, pointer ints cached — .ctypes.data constructs an
    interface object per access (~1 us), and these calls have 13
    graph-constant pointers."""
    ctx = getattr(g, "_gfull_ctx", None)
    if ctx is None or ctx[0] is not es:
        from ..align.gwfa import _flat_graph
        gw = _flat_graph(g, es)
        seg_len = getattr(g, "_seg_len_arr", None)
        if seg_len is None or len(seg_len) != g.n_seg:
            seg_len = np.asarray([s.len for s in g.seg], dtype=np.int64)
            g._seg_len_arr = seg_len
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


_native_full_cfg = False


def gchain_full_tab(g, es, tab, qlen: int, max_dist_g: int,
                    max_dist_q: int, bw: int, max_skip: int,
                    ref_bonus: int, chn_pen_gap: float, mask_level: float,
                    ay_full: np.ndarray, ax_full: np.ndarray, hash_: int,
                    min_gc_cnt: int, min_gc_score: int, gdp_max_ed: int,
                    n_seg: int, qseq: str):
    """The whole graph-chain stage (DP + materialization + extras +
    score sort) in ONE native call (mgt_gchain_full).  Returns a
    GChains or None (caller falls back to the two-step path)."""
    global _native_full_cfg
    import ctypes as ct

    from ..options import DBG, MG_DBG_GC1
    from ..utils.native import get_lib
    if DBG["flag"] & MG_DBG_GC1:
        return None
    lib = get_lib()
    if lib is None or not hasattr(lib, "mgt_gchain_full"):
        return None
    if not _native_full_cfg:
        lib.mgt_gchain_full.restype = ct.c_int64
        lib.mgt_gchain_full.argtypes = \
            [ct.c_void_p] * 4 + [ct.c_int64, ct.c_void_p] \
            + [ct.c_void_p] * 6 + [ct.c_char_p] \
            + [ct.c_int64] + [ct.c_void_p] * 8 \
            + [ct.c_void_p] * 2 + [ct.c_int64, ct.c_char_p, ct.c_int64] \
            + [ct.c_int64] * 6 + [ct.c_double] * 2 \
            + [ct.c_int64, ct.c_uint32] + [ct.c_int64] * 4 \
            + [ct.c_int64] * 3 + [ct.c_void_p] * 13
        _native_full_cfg = True
    args0 = _get_gfull_ctx(g, es)
    n_lc = tab["n"]
    if n_lc == 0:
        return GChains()
    qb = qseq.encode("latin-1")
    n_a_total = len(ax_full)
    llc_cap = n_lc + 1024
    gc_cap = max(n_lc, 64)
    sc = _get_gen_scratch(llc_cap, n_a_total, gc_cap)
    o_llc, o_ax, o_ay, g_tab, g_hash, g_extra, out_ptrs = sc[:7]
    n_gc = lib.mgt_gchain_full(
        *args0, n_lc,
        tab["v"].ctypes.data, tab["off"].ctypes.data,
        tab["cnt"].ctypes.data, tab["score"].ctypes.data,
        tab["qs"].ctypes.data, tab["qe"].ctypes.data,
        tab["rs"].ctypes.data, tab["re"].ctypes.data,
        ax_full.ctypes.data, ay_full.ctypes.data, n_a_total, qb, len(qb),
        qlen, max_dist_g, max_dist_q, bw, max_skip, ref_bonus,
        chn_pen_gap, mask_level, MG_MAX_SHORT_K, hash_,
        min_gc_cnt, min_gc_score, gdp_max_ed, n_seg,
        o_llc.shape[1], len(o_ax), g_tab.shape[1], *out_ptrs)
    if n_gc < 0:
        return None
    return _gcs_from_scratch(n_gc, sc)


def _gcs_from_scratch(n_gc: int, sc, selected: bool = False) -> GChains:
    """Build the GChains object from the native output scratch
    (mgt_gchain_full / mgt_map_tail layout).  With selected=True the
    scratch has been through mgt_select_chains: parent/mapq/n_sub/
    subsc come from sc[7] and the finish stage skips selection."""
    o_llc, o_ax, o_ay, g_tab, g_hash, g_extra = sc[:6]
    gcs = GChains()
    gcs.selected = selected
    if n_gc == 0:
        return gcs
    sel = sc[7] if selected else None
    lv, loff, lcnt, lsc, led = (o_llc[i] for i in range(5))
    n_llc = int(g_tab[1][:n_gc].sum())
    n_a = int(lcnt[:n_llc].sum())
    gcs.lc = [LLChain(off=int(loff[i]), cnt=int(lcnt[i]), v=int(lv[i]),
                      score=int(lsc[i]), ed=int(led[i]))
              for i in range(n_llc)]
    gcs.ax = o_ax[:n_a].copy()   # scratch is reused next read
    gcs.ay = o_ay[:n_a].copy()
    gcs._lc_tables = (lv[:n_llc].copy(), loff[:n_llc].copy(),
                      lcnt[:n_llc].copy())
    for c in range(n_gc):
        p = GChain(score=int(g_tab[3][c]), off=int(g_tab[0][c]),
                   cnt=int(g_tab[1][c]), n_anchor=int(g_tab[2][c]),
                   hash=int(g_hash[c]))
        if sel is not None:
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

_native_ext_cfg = False


def _gchain_extra_native(g, gcs: GChains) -> bool:
    """Native scalar accumulation (native/mgt_filters.c); the float
    divergence stays here for f32 formatting parity."""
    global _native_ext_cfg
    import ctypes as ct

    from ..utils.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "mgt_gchain_extra_all"):
        return False
    if not _native_ext_cfg:
        # raw-int pointers (arr.ctypes.data) need explicit c_void_p
        # argtypes: the ctypes default converts ints to 32-bit
        lib.mgt_gchain_extra_all.restype = None
        lib.mgt_gchain_extra_all.argtypes = \
            [ct.c_void_p] * 8 + [ct.c_int64, ct.c_void_p]
        _native_ext_cfg = True
    lct = getattr(gcs, "_lc_tables", None)
    if lct is None:
        lct = (np.asarray([r.v for r in gcs.lc], dtype=np.int64),
               np.asarray([r.off for r in gcs.lc], dtype=np.int64),
               np.asarray([r.cnt for r in gcs.lc], dtype=np.int64))
        gcs._lc_tables = lct
    lc_v, lc_off, lc_cnt = lct
    seg_len = getattr(g, "_seg_len_arr", None)
    if seg_len is None or len(seg_len) != g.n_seg:
        seg_len = np.asarray([s.len for s in g.seg], dtype=np.int64)
        g._seg_len_arr = seg_len

    ax = gcs.ax if gcs.ax.flags["C_CONTIGUOUS"] \
        else np.ascontiguousarray(gcs.ax)
    ay = gcs.ay if gcs.ay.flags["C_CONTIGUOUS"] \
        else np.ascontiguousarray(gcs.ay)
    n_gc = len(gcs.gc)
    gc_off = np.fromiter((p.off for p in gcs.gc), np.int64, n_gc)
    gc_cnt = np.fromiter((p.cnt for p in gcs.gc), np.int64, n_gc)
    out = np.empty((n_gc, 8), dtype=np.int64)
    lib.mgt_gchain_extra_all(
        ax.ctypes.data, ay.ctypes.data, lc_v.ctypes.data,
        lc_off.ctypes.data, lc_cnt.ctypes.data, seg_len.ctypes.data,
        gc_off.ctypes.data, gc_cnt.ctypes.data, ct.c_int64(n_gc),
        out.ctypes.data)
    for i, p in enumerate(gcs.gc):
        p.qs = p.qe = p.ps = p.pe = -1
        p.plen = p.blen = p.mlen = 0
        p.div = -1.0
        if p.cnt == 0:
            continue
        row = out[i]
        p.qs, p.qe, p.ps, p.pe, p.plen, p.blen, p.mlen = \
            (int(v) for v in row[:7])
        n_mini = int(row[7])
        q_span = (int(gcs.ay[gcs.lc[p.off].off]) >> 32) & 0xFF
        if n_mini >= p.n_anchor:
            p.div = float(F32(math.log(n_mini / p.n_anchor) / q_span))
        else:
            p.div = float(F32(math.log(p.n_anchor / n_mini) / q_span))
    return True


def gchain_extra(g, gcs: GChains) -> None:
    """Compute qs/qe/ps/pe/plen/blen/mlen/divergence (gchain1.c:242-297)."""
    if _gchain_extra_native(g, gcs):
        return
    for p in gcs.gc:
        p.qs = p.qe = p.ps = p.pe = -1
        p.plen = p.blen = p.mlen = 0
        p.div = -1.0
        if p.cnt == 0:
            continue
        q = gcs.lc[p.off]
        q_span = (int(gcs.ay[q.off]) >> 32) & 0xFF
        p.qs = _i32(int(gcs.ay[q.off])) + 1 - q_span
        p.ps = _i32(int(gcs.ax[q.off])) + 1 - q_span
        tmp = int(gcs.ax[q.off]) >> 32
        assert p.qs >= 0 and p.ps >= 0
        q = gcs.lc[p.off + p.cnt - 1]
        p.qe = _i32(int(gcs.ay[q.off + q.cnt - 1])) + 1
        p.pe = g.seg[q.v >> 1].len - _i32(int(gcs.ax[q.off + q.cnt - 1])) - 1
        n_mini = (int(gcs.ax[q.off + q.cnt - 1]) >> 32) - tmp + 1
        assert p.n_anchor > 0

        def i32v(a):
            return (((a & np.uint64(0xFFFFFFFF)).astype(np.int64)
                     ^ 0x80000000) - 0x80000000)

        rest_pl = 0
        last_x = int(gcs.ax[gcs.lc[p.off].off])
        last_y = int(gcs.ay[gcs.lc[p.off].off])
        for j in range(p.cnt):
            q = gcs.lc[p.off + j]
            vlen = g.seg[q.v >> 1].len
            p.plen += vlen
            if q.cnt > 0:
                # vectorized inner anchor loop (gchain1.c:265-287)
                rx = gcs.ax[q.off: q.off + q.cnt]
                ry = gcs.ay[q.off: q.off + q.cnt]
                rx32 = i32v(rx)
                ry32 = i32v(ry)
                rxm = (rx >> np.uint64(32)).astype(np.int64)
                span = ((ry >> np.uint64(32))
                        & np.uint64(0xFF)).astype(np.int64)
                prev_y = np.concatenate(([np.int64(_i32(last_y))],
                                         ry32[:-1]))
                prev_x32 = np.concatenate(([np.int64(_i32(last_x))],
                                           rx32[:-1]))
                prev_xm = np.concatenate(([np.int64(last_x >> 32)],
                                          rxm[:-1]))
                ql = ry32 - prev_y
                pl = rx32 - prev_x32
                if j == 0:
                    pl[0] = ql[0] = span[0]
                else:
                    pl[0] = rx32[0] + 1 + rest_pl
                neg = ql < 0
                n_mini += int((prev_xm[neg] - rxm[neg]).sum())
                ql = np.abs(ql)
                p.blen += int(np.maximum(pl, ql).sum())
                p.mlen += int(np.where((pl > span) & (ql > span), span,
                                       np.minimum(pl, ql)).sum())
                last_x = int(rx[-1])
                last_y = int(ry[-1])
            if q.cnt == 0:
                rest_pl += vlen
            else:
                rest_pl = vlen - _i32(int(gcs.ax[q.off + q.cnt - 1])) - 1
        p.pe = p.plen - p.pe
        assert p.pe >= p.ps
        if n_mini >= p.n_anchor:
            p.div = float(F32(math.log(n_mini / p.n_anchor) / q_span))
        else:
            p.div = float(F32(math.log(p.n_anchor / n_mini) / q_span))


def gchain_restore_order(gcs: GChains) -> None:
    """Reorder lc[]/a[] to match gc[] order (gcmisc.c:8-35)."""
    new_lc: List[LLChain] = []
    ax_parts, ay_parts = [], []
    for gc in gcs.gc:
        assert gc.cnt > 0
        first = gcs.lc[gc.off]
        new_lc.extend(gcs.lc[gc.off: gc.off + gc.cnt])
        ax_parts.append(gcs.ax[first.off: first.off + gc.n_anchor])
        ay_parts.append(gcs.ay[first.off: first.off + gc.n_anchor])
    gcs.lc = new_lc
    if ax_parts:
        gcs.ax = np.concatenate(ax_parts)
        gcs.ay = np.concatenate(ay_parts)
    n_lc = 0
    for gc in gcs.gc:
        gc.off = n_lc
        n_lc += gc.cnt
    n_a = 0
    for lc in gcs.lc:
        lc.off = n_a
        n_a += lc.cnt


def gchain_sort_by_score(gcs: GChains) -> None:
    """Sort gchains by (score, hash) descending (gcmisc.c:56-71)."""
    n = gcs.n_gc
    if n == 0:
        return
    keys = np.asarray([(gc.score << 32) | gc.hash for gc in gcs.gc],
                      dtype=np.uint64)
    perm = radix_argsort(keys)
    gcs.gc = [gcs.gc[perm[n - 1 - i]] for i in range(n)]
    gchain_restore_order(gcs)


_native_mt_cfg = False
_native_sel_cfg = False
_native_gaf_cfg = False
_native_gwf_hook_cfg = False


def _map_tail_gwfa_device(lib, attempt, pool, qseq):
    """Harvest the read's GWFA bridge jobs (hook mode 1), solve them on
    the device pool, re-run the tail injecting the results (mode 2).
    Reads with no bridge sites finish in the single harvest pass —
    harvest only alters behavior AT bridge sites."""
    global _native_gwf_hook_cfg
    import ctypes as ct
    if not _native_gwf_hook_cfg:
        lib.mgt_gwf_hook_set.restype = None
        lib.mgt_gwf_hook_set.argtypes = [
            ct.c_int64, ct.c_int64, ct.c_void_p, ct.c_int64,
            ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int64]
        lib.mgt_gwf_hook_jobs.restype = ct.c_int64
        lib.mgt_gwf_hook_jobs.argtypes = []
        _native_gwf_hook_cfg = True
    from ..align.gwfa_device import WCAP
    jobs_cap = 64
    while True:
        jobs = np.zeros((jobs_cap, 8), dtype=np.int64)
        lib.mgt_gwf_hook_set(1, jobs_cap, jobs.ctypes.data, 0,
                             None, None, None, 0)
        n_gc = attempt()
        n_jobs = lib.mgt_gwf_hook_jobs()
        lib.mgt_gwf_hook_set(0, 0, None, 0, None, None, None, 0)
        if n_gc < 0 or n_jobs == 0:
            return n_gc
        if n_jobs > jobs_cap:
            jobs_cap = int(n_jobs) * 2
            continue
        res_s, res_walk, res_wn = pool.run(jobs[:n_jobs], qseq)
        lib.mgt_gwf_hook_set(2, 0, None, n_jobs, res_s.ctypes.data,
                             res_walk.ctypes.data, res_wn.ctypes.data,
                             WCAP)
        n_gc = attempt()
        lib.mgt_gwf_hook_set(0, 0, None, 0, None, None, None, 0)
        return n_gc


def _map_tail_gwfa_sink(lib, attempt, sink, qseq):
    """Cross-read pooling variant of _map_tail_gwfa_device: phase 1
    harvests this read's jobs into the batch sink and defers (the
    driver re-runs after ONE pool dispatch for the whole batch);
    phase 2 injects the read's pre-solved slice (hook mode 2)."""
    global _native_gwf_hook_cfg
    import ctypes as ct
    if not _native_gwf_hook_cfg:
        lib.mgt_gwf_hook_set.restype = None
        lib.mgt_gwf_hook_set.argtypes = [
            ct.c_int64, ct.c_int64, ct.c_void_p, ct.c_int64,
            ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int64]
        lib.mgt_gwf_hook_jobs.restype = ct.c_int64
        lib.mgt_gwf_hook_jobs.argtypes = []
        _native_gwf_hook_cfg = True
    from ..align.gwfa_device import WCAP, GwfaPending
    jobs_cap = 64
    while True:
        jobs = np.zeros((jobs_cap, 8), dtype=np.int64)
        lib.mgt_gwf_hook_set(1, jobs_cap, jobs.ctypes.data, 0,
                             None, None, None, 0)
        n_gc = attempt()
        n_jobs = lib.mgt_gwf_hook_jobs()
        lib.mgt_gwf_hook_set(0, 0, None, 0, None, None, None, 0)
        if n_gc < 0 or n_jobs == 0:
            return n_gc
        if n_jobs > jobs_cap:
            jobs_cap = int(n_jobs) * 2
            continue
        break
    if sink.phase == 1:
        return GwfaPending(sink.add(jobs[:n_jobs], qseq))
    # phase 2: this read's jobs were pre-solved; the re-harvest above
    # is deterministic, so the queued slice matches site-for-site.  A
    # missing/mismatched slice only skips injection — the inline host
    # engine then bridges identically.
    inj = sink.pop_inject()
    if inj is None or len(inj[0]) != n_jobs:
        return attempt()
    res_s, res_walk, res_wn = inj
    lib.mgt_gwf_hook_set(2, 0, None, n_jobs,
                         res_s.ctypes.data, res_walk.ctypes.data,
                         res_wn.ctypes.data, WCAP)
    n_gc = attempt()
    lib.mgt_gwf_hook_set(0, 0, None, 0, None, None, None, 0)
    return n_gc


def _get_gaf_ctx(g):
    """Per-graph name/coordinate arrays for the native GAF formatter
    (native/mgt_gaf.c): seg name blob + offsets, snid/soff, stable-seq
    name blob + min/max/rank.  Cached on the Graph like _get_gfull_ctx."""
    ctx = getattr(g, "_gaf_ctx", None)
    if ctx is not None and ctx[0] == (g.n_seg, len(g.sseq)):
        return ctx[1]
    seg_len = getattr(g, "_seg_len_arr", None)
    if seg_len is None or len(seg_len) != g.n_seg:
        seg_len = np.asarray([s.len for s in g.seg], dtype=np.int64)
        g._seg_len_arr = seg_len
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


def _format_gaf_native(lib, g, n_gc, sc, qname, qlen, flag):
    """Serialize the selected chain tables to GAF text natively
    (native/mgt_gaf.c); returns the text or None for the Python
    serializer fallback."""
    global _native_gaf_cfg
    import ctypes as ct
    if not hasattr(lib, "mgt_format_gaf"):
        return None
    if not _native_gaf_cfg:
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
            + [ct.c_void_p] * 7          # -c cigar/ds tables (NULLs)
            + [ct.c_void_p, ct.c_int64])
        _native_gaf_cfg = True
    from ..options import (MG_M_NO_COMP_PATH, MG_M_PRINT_2ND,
                           MG_M_SHOW_UNMAP)
    ctx = _get_gaf_ctx(g)
    pt, sel = sc[6], sc[7]
    qb = qname.encode("latin-1") if qname else b""
    buf = getattr(_TLS, "gafbuf", None)
    if buf is None:
        buf = np.empty(1 << 16, dtype=np.uint8)
        _TLS.gafbuf = buf
    while True:
        n = lib.mgt_format_gaf(
            *ctx, qb, len(qb), qlen, n_gc,
            pt[0], pt[1], pt[2], pt[6],
            pt[7], pt[8], pt[9], pt[10], pt[12],
            sel[0].ctypes.data, sel[1].ctypes.data, sel[3].ctypes.data,
            int(bool(flag & MG_M_PRINT_2ND)),
            int(bool(flag & MG_M_NO_COMP_PATH)),
            int(bool(flag & MG_M_SHOW_UNMAP)),
            1, 0, None,
            None, None, None, None, None, None, None,
            buf.ctypes.data, len(buf))
        if n >= 0:
            return buf[:n].tobytes().decode("latin-1")
        buf = np.empty(len(buf) * 4, dtype=np.uint8)
        _TLS.gafbuf = buf


def _select_native(lib, n_gc: int, sc, sel_args) -> int:
    """Run the whole selection stage (set_parent + flt_sub + drop_flt
    + set_mapq, gcmisc.c:74-223) natively on the chain-table scratch
    (native/mgt_select.c).  Returns the surviving chain count, or -1
    for the Python fallback."""
    global _native_sel_cfg
    import ctypes as ct
    if not hasattr(lib, "mgt_select_chains"):
        return -1
    if not _native_sel_cfg:
        lib.mgt_select_chains.restype = ct.c_int64
        lib.mgt_select_chains.argtypes = \
            [ct.c_double, ct.c_double] + [ct.c_int64] * 7 \
            + [ct.c_void_p] * 17
        _native_sel_cfg = True
    (mask_level, pri_ratio, min_diff, best_n, qlen, max_mini,
     min_gc_score, rep_len) = sel_args
    pt = sc[6]
    sel_tab = sc[7]
    return lib.mgt_select_chains(
        mask_level, pri_ratio, min_diff, best_n, qlen, max_mini,
        min_gc_score, rep_len, n_gc,
        pt[7], pt[8], pt[9], pt[10],          # g_off/g_cnt/g_na/g_sc
        pt[11], pt[12],                       # g_hash/g_extra
        pt[0], pt[1], pt[2], pt[3], pt[4],    # o_lv/loff/lcnt/lsc/led
        pt[5], pt[6],                         # o_ax/o_ay
        sel_tab[0].ctypes.data, sel_tab[1].ctypes.data,
        sel_tab[2].ctypes.data, sel_tab[3].ctypes.data)


def map_tail_full(g, es, mode: int, f32, p32, ax, ay, mini_pos,
                  opt, qlen: int, n_segs: int, max_dist_x: int,
                  max_dist_y: int, chn_pen_gap: float,
                  chn_pen_skip: float, is_splice: bool, hash_: int,
                  qseq: str, select=None, emit=None, gwfa_pool=None):
    """The WHOLE per-read tail in one native call (native/mgt_tail.c
    mgt_map_tail): linear-chain stage + long-join rescue + lchain tail
    + graph-chain stage.  Returns a GChains, or None for the
    decomposed fallback path.  mode: 0 finish-from-fp, 1 banded DP,
    2 RMQ."""
    global _native_mt_cfg
    import ctypes as ct

    from ..options import DBG, MG_M_SPLICE, MG_M_SR
    from ..utils.native import get_lib
    if DBG["flag"]:
        return None
    lib = get_lib()
    if lib is None or not hasattr(lib, "mgt_map_tail"):
        return None
    if not _native_mt_cfg:
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
        _native_mt_cfg = True
    n_a = len(ax)
    if n_a == 0:
        return GChains()
    args0 = _get_gfull_ctx(g, es)
    qb = qseq.encode("latin-1")
    ax0, ay0 = ax, ay
    mini_pos = np.ascontiguousarray(mini_pos, dtype=np.int64)
    fp_ptr = pp_ptr = None
    if mode == 0:
        f32 = np.ascontiguousarray(f32, dtype=np.int32)
        p32 = np.ascontiguousarray(p32, dtype=np.int32)
        fp_ptr, pp_ptr = f32.ctypes.data, p32.ctypes.data
    elif mode == 3:
        # f32 carries the device-backtracked u array (sc<<32|cnt);
        # max_dist_x (already len(u) from the caller) is n_u
        f32 = np.ascontiguousarray(f32, dtype=np.uint64)
        fp_ptr = f32.ctypes.data
    do_rescue = int(opt.bw_long > opt.bw
                    and not (opt.flag & (MG_M_SPLICE | MG_M_SR))
                    and n_segs == 1)
    llc_cap = n_a + 1024
    sc = _get_gen_scratch(llc_cap, n_a, max(n_a, 64))
    o_llc, o_ax, o_ay, g_tab = sc[0], sc[1], sc[2], sc[3]
    out_ptrs = sc[6]

    def attempt():
        # the engines compact/flag ax/ay IN PLACE; every attempt works
        # on fresh copies so a mid-call fallback (-1/-2/-3) and the
        # harvest->inject re-run both see pristine arrays
        ax = np.array(ax0, dtype=np.uint64)
        ay = np.array(ay0, dtype=np.uint64)
        return lib.mgt_map_tail(
            mode, fp_ptr, pp_ptr,
            max_dist_x, max_dist_y, opt.bw, opt.max_lc_skip,
            opt.max_lc_iter, opt.min_lc_cnt, opt.min_lc_score,
            chn_pen_gap, chn_pen_skip,
            int(is_splice), n_segs, opt.max_gap_pre, opt.rmq_size_cap,
            do_rescue, qlen, opt.bw_long, opt.rmq_rescue_size,
            opt.max_gap, opt.rmq_rescue_ratio,
            n_a, ax.ctypes.data, ay.ctypes.data,
            mini_pos.ctypes.data, len(mini_pos), opt.lc_max_occ,
            opt.lc_max_trim, opt.max_gap >> 1,
            *args0, qb, len(qb),
            opt.bw_long, opt.max_gc_skip, opt.ref_bonus, opt.mask_level,
            MG_MAX_SHORT_K, hash_, opt.min_gc_cnt, opt.min_gc_score,
            opt.gdp_max_ed,
            o_llc.shape[1], len(o_ax), g_tab.shape[1], *out_ptrs)

    if gwfa_pool is not None and hasattr(lib, "mgt_gwf_hook_set"):
        from ..align.gwfa_device import GwfaBatchSink, GwfaPending
        if isinstance(gwfa_pool, GwfaBatchSink):
            r = _map_tail_gwfa_sink(lib, attempt, gwfa_pool, qseq)
            if isinstance(r, GwfaPending):
                return r
            n_gc = r
        else:
            n_gc = _map_tail_gwfa_device(lib, attempt, gwfa_pool, qseq)
    else:
        n_gc = attempt()
    if n_gc < 0:
        return None
    if select is not None:
        if n_gc == 0:
            n2 = 0
        else:
            n2 = _select_native(lib, n_gc, sc, select)
        if n2 >= 0:
            if emit is not None:
                # anchors -> GAF bytes entirely in C: skip the object
                # build and the Python serializer (seqio/gaf.py)
                txt = _format_gaf_native(lib, g, n2, sc, emit[0],
                                         emit[1], emit[2])
                if txt is not None:
                    gcs = GChains()
                    gcs.selected = True
                    gcs.gaf_text = txt
                    return gcs
            return _gcs_from_scratch(n2, sc, selected=True)
    return _gcs_from_scratch(n_gc, sc)
