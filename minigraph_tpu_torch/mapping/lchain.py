"""Linear (colinear) anchor chaining of the per-read path.

The banded DP (lchain.c:149-219) and the RMQ long-range chain
(lchain.c:252-372) run in the native library (native/mgt_lchain.c);
the peak backtrack (lchain.c:27-77) stays here for the graph-chain
DP's Python path, with chain materialization (lchain.c:374-441) and
the fused native lchain tail.  The port's native library is required
(utils/native.py raises when it cannot be built), so the JAX package's
pure-Python DP and RMQ bodies, which run only without it, are not
copied.
"""
from __future__ import annotations

import ctypes as ct
import sys
import threading
from dataclasses import dataclass
from typing import List

import numpy as np

from ..options import DBG, MG_DBG_LC_PROF
from ..utils.ksort import radix_argsort
from ..utils.native import get_lib

U64 = np.uint64


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


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


_chain_cfg = False


def _native_chain(fn_name: str, args_pre, ax: np.ndarray, ay: np.ndarray):
    """Run a chaining DP in the native library; returns (ax, ay, n_u, u)
    with the anchors compacted chain by chain."""
    global _chain_cfg
    lib = get_lib()
    if not _chain_cfg:
        vp = ct.c_void_p
        i32p = ct.POINTER(ct.c_int32)
        lib.mgt_lchain_dp.restype = ct.c_int64
        lib.mgt_lchain_dp.argtypes = [
            ct.c_int32] * 7 + [ct.c_float, ct.c_float,
            ct.c_int32, ct.c_int32, ct.c_int64,
            vp, vp, vp, i32p]
        lib.mgt_lchain_rmq.restype = ct.c_int64
        lib.mgt_lchain_rmq.argtypes = [
            ct.c_int32] * 7 + [ct.c_float, ct.c_float,
            ct.c_int64, vp, vp, vp, i32p]
        _chain_cfg = True
    n = len(ax)
    ax = np.ascontiguousarray(ax, dtype=np.uint64)
    ay = np.ascontiguousarray(ay, dtype=np.uint64)
    u = np.zeros(max(n, 1), dtype=np.uint64)
    n_u = ct.c_int32(0)
    n_v = getattr(lib, fn_name)(*args_pre, n, ax.ctypes.data,
                                ay.ctypes.data, u.ctypes.data, ct.byref(n_u))
    if DBG["flag"] & MG_DBG_LC_PROF:
        # the engine's counters of this call (lchain.c stats)
        stats = (ct.c_int64 * 4).in_dll(lib, "mgt_lchain_stats")
        if fn_name == "mgt_lchain_dp":
            sys.stderr.write(f"LP\tn_iter={stats[0]}\tmmax_f={stats[1]}\n")
        else:
            sys.stderr.write(
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
    if len(ax) == 0:
        return ax, ay, 0, np.empty(0, dtype=np.uint64)
    return _native_chain(
        "mgt_lchain_dp",
        (max_dist_x, max_dist_y, bw, max_skip, max_iter, min_cnt,
         min_sc, float(np.float32(chn_pen_gap)),
         float(np.float32(chn_pen_skip)), int(is_cdna), n_seg),
        ax, ay)


def lchain_rmq(max_dist, max_dist_inner, bw, max_chn_skip, cap_rmq_size,
               min_cnt, min_sc, chn_pen_gap, chn_pen_skip, ax, ay):
    """RMQ-based long-range chaining (mg_lchain_rmq, lchain.c:252-372)."""
    if len(ax) == 0:
        return ax, ay, 0, np.empty(0, dtype=np.uint64)
    return _native_chain(
        "mgt_lchain_rmq",
        (max_dist, max_dist_inner, bw, max_chn_skip, cap_rmq_size,
         min_cnt, min_sc, float(np.float32(chn_pen_gap)),
         float(np.float32(chn_pen_skip))),
        ax, ay)


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


_tail_cfg = False
_TLS = threading.local()


def lchain_tail_tab(qlen: int, n_u: int, u: np.ndarray, ax: np.ndarray,
                    ay: np.ndarray, mini_pos: np.ndarray, opt):
    """Fused native linear-chain tail (native/mgt_gchain.c
    mgt_lchain_tail): mg_lchain_gen + the per-chain filter block +
    mg_update_anchors in ONE call per read.  Mutates ax/ay in place.

    Returns a dict of kept-chain table arrays (off/cnt/v/rs/re/qs/qe/
    score, all int64, sorted by query start) or None when the engine
    bails (the caller runs the object path)."""
    global _tail_cfg
    lib = get_lib()
    if not _tail_cfg:
        lib.mgt_lchain_tail.restype = ct.c_int64
        lib.mgt_lchain_tail.argtypes = \
            [ct.c_int64, ct.c_int64] + [ct.c_void_p] * 4 \
            + [ct.c_int64] * 6 + [ct.c_void_p] * 8
        _tail_cfg = True
    assert ax.flags["C_CONTIGUOUS"] and ay.flags["C_CONTIGUOUS"]
    mini_pos = np.ascontiguousarray(mini_pos, dtype=np.int64)
    sc = getattr(_TLS, "tabs", None)
    if sc is None or sc[0].shape[1] < n_u:
        tabs = np.empty((8, max(n_u, 4096)), dtype=np.int64)
        sc = (tabs, tuple(tabs[i].ctypes.data for i in range(8)))
        _TLS.tabs = sc
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
