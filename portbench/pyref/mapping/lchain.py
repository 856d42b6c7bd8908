"""Linear (colinear) anchor chaining.

Host-exact implementation of the two chaining DP engines
(lchain.c:149-219 banded DP, lchain.c:252-372 RMQ long-range), the shared
peak backtrack (lchain.c:27-77), anchor compaction (lchain.c:79-112) and
chain materialization (lchain.c:374-441).  Scores use float32 penalties
with the fast log2 approximation, truncated to int exactly like the C.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..utils.hashes import mg_log2
from ..utils.ksort import radix_argsort

INT32_MIN = -0x80000000
U64 = np.uint64
F32 = np.float32


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


def comput_sc(ax_i, ay_i, ax_j, ay_j, max_dist_x, max_dist_y, bw,
              chn_pen_gap, chn_pen_skip, is_cdna, n_seg) -> int:
    """Transition score between anchors j -> i (lchain.c:114-139)."""
    dq = _i32(ay_i) - _i32(ay_j)
    sidi = (ay_i >> 48) & 0xFF
    sidj = (ay_j >> 48) & 0xFF
    if dq <= 0 or dq > max_dist_x:
        return INT32_MIN
    dr = _i32((ax_i - ax_j) & 0xFFFFFFFFFFFFFFFF)
    if sidi == sidj and (dr == 0 or dq > max_dist_y):
        return INT32_MIN
    dd = dr - dq if dr > dq else dq - dr
    if sidi == sidj and dd > bw:
        return INT32_MIN
    if n_seg > 1 and not is_cdna and sidi == sidj and dr > max_dist_y:
        return INT32_MIN
    dg = dr if dr < dq else dq
    q_span = (ay_j >> 32) & 0xFF
    sc = q_span if q_span < dg else dg
    if dd or dg > q_span:
        lin_pen = F32(F32(chn_pen_gap) * F32(dd) + F32(chn_pen_skip) * F32(dg))
        log_pen = F32(mg_log2(dd + 1)) if dd >= 1 else F32(0.0)
        if is_cdna or sidi != sidj:
            if sidi != sidj and dr == 0:
                sc += 1
            elif dr > dq or sidi != sidj:
                sc -= int(min(lin_pen, log_pen))
            else:
                sc -= int(F32(lin_pen + F32(0.5) * log_pen))
        else:
            sc -= int(F32(lin_pen + F32(0.5) * log_pen))
    return sc


def chain_backtrack(n: int, f: np.ndarray, p: np.ndarray, min_cnt: int,
                    min_sc: int, max_drop: int, extra_u: int):
    """Peak-sorted greedy backtrack (mg_chain_backtrack, lchain.c:27-77).

    Returns (u, v, n_u, n_v): u = score<<32|cnt per chain (+extra_u slack),
    v = anchor indices in backwards order per chain.
    """
    sel = np.nonzero(f >= min_sc)[0]
    if len(sel) == 0:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int64), 0, 0
    keys = f[sel].astype(np.int64).astype(np.uint64)
    perm = radix_argsort(keys)
    zx = keys[perm]
    zy = sel[perm]
    n_z = len(zx)

    t = np.zeros(n, dtype=np.int64)

    def bk_end(k: int) -> int:
        i = int(zy[k])
        if i < 0 or t[i] != 0:
            return i
        end_i = -1
        max_i = i
        max_s = 0
        while True:
            t[i] = 2
            i = int(p[i])
            end_i = i
            s = int(zx[k]) if i < 0 else int(np.int32(np.uint32(zx[k] & U64(0xFFFFFFFF)))) - int(f[i])
            if s > max_s:
                max_s, max_i = s, i
            elif max_s - s > max_drop:
                break
            if not (i >= 0 and t[i] == 0):
                break
        i = int(zy[k])
        while i >= 0 and i != end_i:
            t[i] = 0
            i = int(p[i])
        return max_i

    u_list: List[int] = []
    v = np.empty(n, dtype=np.int64)
    n_v = 0
    for k in range(n_z - 1, -1, -1):
        if t[int(zy[k])] == 0:
            n_v0 = n_v
            end_i = bk_end(k)
            i = int(zy[k])
            while i != end_i:
                v[n_v] = i
                n_v += 1
                t[i] = 1
                i = int(p[i])
            sc = int(zx[k]) if i < 0 else int(np.int32(np.uint32(zx[k] & U64(0xFFFFFFFF)))) - int(f[i])
            if sc >= min_sc and n_v > n_v0 and n_v - n_v0 >= min_cnt:
                u_list.append((sc << 32) | (n_v - n_v0))
            else:
                n_v = n_v0
    u = np.asarray(u_list + [0] * extra_u, dtype=np.uint64)
    return u, v[:n_v], len(u_list), n_v


def compact_a(n_u: int, u: np.ndarray, n_v: int, v: np.ndarray,
              ax: np.ndarray, ay: np.ndarray):
    """Reorder anchors chain-by-chain and sort chains by first-anchor
    target position (compact_a, lchain.c:79-112).  Mutates u in place."""
    bx = np.empty(n_v, dtype=np.uint64)
    by = np.empty(n_v, dtype=np.uint64)
    k = 0
    for i in range(n_u):
        ni = int(u[i]) & 0xFFFFFFFF
        k0 = k
        for j in range(ni):
            src = v[k0 + (ni - j - 1)]
            bx[k] = ax[src]
            by[k] = ay[src]
            k += 1
    # sort chains by first-anchor x
    wx = np.empty(n_u, dtype=np.uint64)
    wy = np.empty(n_u, dtype=np.uint64)
    k = 0
    for i in range(n_u):
        wx[i] = bx[k]
        wy[i] = U64(k << 32 | i)
        k += int(u[i]) & 0xFFFFFFFF
    perm = radix_argsort(wx)
    wy = wy[perm]
    u2 = np.empty(n_u, dtype=np.uint64)
    ox = np.empty(n_v, dtype=np.uint64)
    oy = np.empty(n_v, dtype=np.uint64)
    k = 0
    for i in range(n_u):
        j = int(wy[i]) & 0xFFFFFFFF
        nj = int(u[j]) & 0xFFFFFFFF
        src = int(wy[i]) >> 32
        u2[i] = u[j]
        ox[k: k + nj] = bx[src: src + nj]
        oy[k: k + nj] = by[src: src + nj]
        k += nj
    u[:n_u] = u2
    return ox, oy


_native_cfg = False


def _native_chain(fn_name: str, args_pre, ax: np.ndarray, ay: np.ndarray):
    """Route a chaining DP through the native library; returns
    (ax, ay, n_u, u) or None if unavailable."""
    global _native_cfg
    import ctypes

    from ..utils.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, fn_name):
        return None
    if not _native_cfg:
        vp = ctypes.c_void_p
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.mgt_lchain_dp.restype = ctypes.c_int64
        lib.mgt_lchain_dp.argtypes = [
            ctypes.c_int32] * 7 + [ctypes.c_float, ctypes.c_float,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            vp, vp, vp, i32p]
        lib.mgt_lchain_rmq.restype = ctypes.c_int64
        lib.mgt_lchain_rmq.argtypes = [
            ctypes.c_int32] * 7 + [ctypes.c_float, ctypes.c_float,
            ctypes.c_int64, vp, vp, vp, i32p]
        _native_cfg = True
    import ctypes as ct
    n = len(ax)
    ax = np.ascontiguousarray(ax, dtype=np.uint64)
    ay = np.ascontiguousarray(ay, dtype=np.uint64)
    u = np.zeros(max(n, 1), dtype=np.uint64)
    n_u = ct.c_int32(0)
    fn = getattr(lib, fn_name)
    n_v = fn(*args_pre, n, ax.ctypes.data, ay.ctypes.data,
             u.ctypes.data, ct.byref(n_u))
    from ..options import DBG, MG_DBG_LC_PROF
    if DBG["flag"] & MG_DBG_LC_PROF:
        import sys as _sys
        stats = (ct.c_int64 * 4).in_dll(lib, "mgt_lchain_stats")
        if fn_name == "mgt_lchain_dp":
            _sys.stderr.write(
                f"LP\tn_iter={stats[0]}\tmmax_f={stats[1]}\n")
        else:
            _sys.stderr.write(
                f"LP\tn_iter={stats[0]}\tmmax_f={stats[1]}\t"
                f"rmq_size={stats[2]}\tmp_max={stats[3]}\n")
    if n_u.value == 0:
        return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64),
                0, np.empty(0, dtype=np.uint64))
    return ax[:n_v], ay[:n_v], n_u.value, u[: n_u.value]


def lchain_dp(max_dist_x: int, max_dist_y: int, bw: int, max_skip: int,
              max_iter: int, min_cnt: int, min_sc: int, chn_pen_gap: float,
              chn_pen_skip: float, is_cdna: bool, n_seg: int,
              ax: np.ndarray, ay: np.ndarray):
    """Banded chaining DP (mg_lchain_dp, lchain.c:149-219).

    Returns (ax, ay, n_u, u) with anchors compacted per chain.
    """
    n = len(ax)
    if n > 0:
        res = _native_chain(
            "mgt_lchain_dp",
            (max_dist_x, max_dist_y, bw, max_skip, max_iter, min_cnt,
             min_sc, float(np.float32(chn_pen_gap)),
             float(np.float32(chn_pen_skip)), int(is_cdna), n_seg),
            ax, ay)
        if res is not None:
            return res
    if n == 0:
        return ax, ay, 0, np.empty(0, dtype=np.uint64)
    if max_dist_x < bw:
        max_dist_x = bw
    if max_dist_y < bw and not is_cdna:
        max_dist_y = bw
    max_drop = 0x7FFFFFFF if is_cdna else bw

    f = np.zeros(n, dtype=np.int64)
    p = np.full(n, -1, dtype=np.int64)
    v = np.zeros(n, dtype=np.int64)
    t = np.full(n, -1, dtype=np.int64)  # any value != i works as "unset"

    axl = ax  # local aliases (python ints via item())
    st = 0
    max_ii = -1
    for i in range(n):
        xi = int(axl[i])
        yi = int(ay[i])
        max_f = (yi >> 32) & 0xFF
        max_j = -1
        n_skip = 0
        while st < i and ((xi >> 32) != (int(axl[st]) >> 32)
                          or xi > int(axl[st]) + max_dist_x):
            st += 1
        if i - st > max_iter:
            st = i - max_iter
        j = i - 1
        while j >= st:
            sc = comput_sc(xi, yi, int(axl[j]), int(ay[j]), max_dist_x,
                           max_dist_y, bw, chn_pen_gap, chn_pen_skip,
                           is_cdna, n_seg)
            if sc != INT32_MIN:
                sc += int(f[j])
                if sc > max_f:
                    max_f, max_j = sc, j
                    if n_skip > 0:
                        n_skip -= 1
                elif t[j] == i:
                    n_skip += 1
                    if n_skip > max_skip:
                        break
                if p[j] >= 0:
                    t[p[j]] = i
            j -= 1
        end_j = j
        if max_ii < 0 or xi - int(axl[max_ii]) > max_dist_x:
            mx = INT32_MIN
            max_ii = -1
            for j in range(i - 1, st - 1, -1):
                if mx < f[j]:
                    mx, max_ii = int(f[j]), j
        if max_ii >= 0 and max_ii < end_j:
            tmp = comput_sc(xi, yi, int(axl[max_ii]), int(ay[max_ii]),
                            max_dist_x, max_dist_y, bw, chn_pen_gap,
                            chn_pen_skip, is_cdna, n_seg)
            if tmp != INT32_MIN and max_f < tmp + int(f[max_ii]):
                max_f = tmp + int(f[max_ii])
                max_j = max_ii
        f[i] = max_f
        p[i] = max_j
        v[i] = v[max_j] if (max_j >= 0 and v[max_j] > max_f) else max_f
        if max_ii < 0 or (xi - int(axl[max_ii]) <= max_dist_x and f[max_ii] < f[i]):
            max_ii = i
    u, vv, n_u, n_v = chain_backtrack(n, f, p, min_cnt, min_sc, max_drop, 0)
    if n_u == 0:
        return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64),
                0, np.empty(0, dtype=np.uint64))
    ox, oy = compact_a(n_u, u, n_v, vv, ax, ay)
    return ox, oy, n_u, u


_native_fin_cfg = False


def lchain_dp_from_fp(f: np.ndarray, p: np.ndarray, bw: int, max_skip_unused,
                      min_cnt: int, min_sc: int, is_cdna: bool,
                      ax: np.ndarray, ay: np.ndarray):
    """Finish mg_lchain_dp from precomputed DP arrays (lchain.c:209-219).

    The device chain kernel (ops/chain_exact.py) fills f/p exactly for
    unflagged reads; this runs the shared peak backtrack + chain
    compaction on the host (native C when available).  Returns
    (ax, ay, n_u, u) like lchain_dp."""
    global _native_fin_cfg
    n = len(ax)
    if n == 0:
        return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64),
                0, np.empty(0, dtype=np.uint64))
    import ctypes as ct

    from ..utils.native import get_lib
    lib = get_lib()
    if lib is not None and hasattr(lib, "mgt_lchain_finish"):
        if not _native_fin_cfg:
            vp = ct.c_void_p
            i32p = ct.POINTER(ct.c_int32)
            lib.mgt_lchain_finish.restype = ct.c_int64
            lib.mgt_lchain_finish.argtypes = [
                ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int64,
                vp, vp, vp, vp, vp, i32p]
            _native_fin_cfg = True
        axc = np.ascontiguousarray(ax, dtype=np.uint64)
        ayc = np.ascontiguousarray(ay, dtype=np.uint64)
        f32 = np.ascontiguousarray(f, dtype=np.int32)
        p32 = np.ascontiguousarray(p, dtype=np.int32)
        u = np.zeros(n, dtype=np.uint64)
        n_u = ct.c_int32(0)
        n_v = lib.mgt_lchain_finish(
            bw, int(is_cdna), min_cnt, min_sc, n,
            f32.ctypes.data, p32.ctypes.data, axc.ctypes.data,
            ayc.ctypes.data, u.ctypes.data, ct.byref(n_u))
        if n_u.value == 0:
            return (np.empty(0, dtype=np.uint64),
                    np.empty(0, dtype=np.uint64), 0,
                    np.empty(0, dtype=np.uint64))
        return axc[:n_v], ayc[:n_v], n_u.value, u[: n_u.value]
    max_drop = 0x7FFFFFFF if is_cdna else bw
    u, vv, n_u, n_v = chain_backtrack(
        n, f.astype(np.int64), p.astype(np.int64), min_cnt, min_sc,
        max_drop, 0)
    if n_u == 0:
        return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64),
                0, np.empty(0, dtype=np.uint64))
    ox, oy = compact_a(n_u, u, n_v, vv, ax, ay)
    return ox, oy, n_u, u


def lchain_rmq(max_dist, max_dist_inner, bw, max_chn_skip, cap_rmq_size,
               min_cnt, min_sc, chn_pen_gap, chn_pen_skip, ax, ay):
    """RMQ-based long-range chaining (mg_lchain_rmq, lchain.c:252-372)."""
    from .lchain_rmq import lchain_rmq_impl
    return lchain_rmq_impl(max_dist, max_dist_inner, bw, max_chn_skip,
                           cap_rmq_size, min_cnt, min_sc, chn_pen_gap,
                           chn_pen_skip, ax, ay)


@dataclass
class LChain:
    """mg_lchain_t (minigraph.h:100-106)."""
    off: int = 0
    cnt: int = 0
    v: int = 0
    rs: int = 0
    re: int = 0
    qs: int = 0
    qe: int = 0
    score: int = 0
    dist_pre: int = -1
    hash_pre: int = 0
    inner_pre: int = 0


def lchain_gen(qlen: int, n_u: int, u: np.ndarray,
               ax: np.ndarray, ay: np.ndarray) -> List[LChain]:
    """Materialize chains sorted by query start (mg_lchain_gen,
    lchain.c:374-408)."""
    if n_u == 0:
        return []
    zx = np.empty(n_u, dtype=np.uint64)
    zy = np.empty(n_u, dtype=np.uint64)
    k = 0
    for i in range(n_u):
        span = (int(ay[k]) >> 32) & 0xFF
        qs = _i32(int(ay[k])) + 1 - span
        zx[i] = U64((qs << 32) | (int(u[i]) >> 32))
        zy[i] = U64((k << 32) | (int(u[i]) & 0xFFFFFFFF))
        k += int(u[i]) & 0xFFFFFFFF
    perm = radix_argsort(zx)
    zx, zy = zx[perm], zy[perm]
    out = []
    for i in range(n_u):
        k = int(zy[i]) >> 32
        q_span = (int(ay[k]) >> 32) & 0xFF
        cnt = int(zy[i]) & 0xFFFFFFFF
        r = LChain(
            off=k,
            cnt=cnt,
            score=int(zx[i]) & 0xFFFFFFFF,
            v=int(ax[k]) >> 32,
            rs=max(_i32(int(ax[k])) + 1 - q_span, 0),
            qs=int(zx[i]) >> 32,
            re=_i32(int(ax[k + cnt - 1])) + 1,
            qe=_i32(int(ay[k + cnt - 1])) + 1,
        )
        out.append(r)
    return out


def update_anchors(lc: LChain, ax: np.ndarray, ay: np.ndarray,
                   mini_pos: np.ndarray) -> None:
    """Rewrite anchor x to minimizer_index<<32 | tpos (mg_update_anchors,
    lchain.c:424-441)."""
    n_a = lc.cnt
    if n_a <= 0:
        return
    off = lc.off
    # vectorized: anchor qpos values are a (sorted) subsequence of
    # mini_pos, so searchsorted gives each anchor's minimizer index
    qpos = (((ay[off: off + n_a] & np.uint64(0xFFFFFFFF))
             .astype(np.int64) ^ 0x80000000) - 0x80000000)
    j_idx = np.searchsorted(mini_pos, qpos)
    assert j_idx[0] < len(mini_pos) and mini_pos[j_idx[0]] == qpos[0]
    assert (mini_pos[j_idx] == qpos).all()
    ax[off: off + n_a] = (j_idx.astype(np.uint64) << np.uint64(32)) \
        | (ax[off: off + n_a] & np.uint64(0xFFFFFFFF))


_native_tail_cfg = False
import threading as _threading_t
_TAIL_TLS = _threading_t.local()


def lchain_tail_tab(qlen: int, n_u: int, u: np.ndarray, ax: np.ndarray,
                    ay: np.ndarray, mini_pos: np.ndarray, opt):
    """Fused native linear-chain tail (native/mgt_gchain.c
    mgt_lchain_tail): mg_lchain_gen + the per-chain filter block +
    mg_update_anchors in ONE call per read.  Mutates ax/ay in place.

    Returns a dict of kept-chain table arrays (off/cnt/v/rs/re/qs/qe/
    score, all int64, sorted by query start) or None when the native
    library is unavailable (caller runs the legacy object path)."""
    global _native_tail_cfg
    import ctypes as ct

    from ..utils.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "mgt_lchain_tail"):
        return None
    if not _native_tail_cfg:
        lib.mgt_lchain_tail.restype = ct.c_int64
        lib.mgt_lchain_tail.argtypes = \
            [ct.c_int64, ct.c_int64] + [ct.c_void_p] * 4 \
            + [ct.c_int64] * 6 + [ct.c_void_p] * 8
        _native_tail_cfg = True
    assert ax.flags["C_CONTIGUOUS"] and ay.flags["C_CONTIGUOUS"]
    mini_pos = np.ascontiguousarray(mini_pos, dtype=np.int64)
    sc = getattr(_TAIL_TLS, "tabs", None)
    if sc is None or sc[0].shape[1] < n_u:
        tabs = np.empty((8, max(n_u, 4096)), dtype=np.int64)
        sc = (tabs, tuple(tabs[i].ctypes.data for i in range(8)))
        _TAIL_TLS.tabs = sc
    tabs, tab_ptrs = sc
    n_out = lib.mgt_lchain_tail(
        qlen, n_u, u.ctypes.data, ax.ctypes.data, ay.ctypes.data,
        mini_pos.ctypes.data, len(mini_pos),
        opt.lc_max_occ, opt.lc_max_trim, opt.bw, opt.max_gap >> 1,
        opt.min_lc_cnt, *tab_ptrs)
    if n_out < 0:
        return None
    t = tabs[:, :n_out]
    return {"off": t[0], "cnt": t[1], "v": t[2], "rs": t[3], "re": t[4],
            "qs": t[5], "qe": t[6], "score": t[7], "n": int(n_out)}
