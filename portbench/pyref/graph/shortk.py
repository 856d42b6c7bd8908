"""K best shortest paths from one vertex to a set of destination vertices
(mg_shortest_k, shortk.c:41-242).

Dijkstra-like search keeping up to max_k best distances per vertex; each
destination may carry a target distance and 32-bit path hash so the exact
path chosen during graph-chaining DP can be re-found during chain
materialization.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..options import MG_MAX_SHORT_K
from ..utils.hashes import kh_hash_uint32

MG_SHORT_K_EXT = 1000
U32 = 0xFFFFFFFF


@dataclass
class PathDst:
    """mg_path_dst_t (mgpriv.h:40-52)."""
    v: int = 0
    target_dist: int = -1
    target_hash: int = 0
    meta: int = 0
    check_hash: int = 0
    inner: int = 0
    qlen: int = 0
    # outputs
    n_path: int = 0
    is_0: int = 0
    path_end: int = -1
    dist: int = -1
    hash: int = 0


@dataclass
class PathV:
    v: int
    d: int
    pre: int


class _Node:
    __slots__ = ("v", "di", "pre", "hash", "is_0", "removed", "visited")

    def __init__(self, v, di, pre, hash_, is_0):
        self.v = v
        self.di = di
        self.pre = pre
        self.hash = hash_
        self.is_0 = is_0
        self.removed = False
        self.visited = False


_native_cfg = False


def _shortest_k_native(g, src: int, dst: List[PathDst], max_dist: int,
                       max_k: int, want_path: bool):
    """Native engine (native/mgt_shortk.c).  Returns (ok, ret)."""
    global _native_cfg
    import ctypes
    from ..utils.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "mgt_shortest_k"):
        return False, None
    if not _native_cfg:
        lib.mgt_shortest_k.restype = ctypes.c_int64
        _native_cfg = True
    n_dst = len(dst)
    dst_v = np.asarray([t.v for t in dst], dtype=np.int64)
    dst_td = np.asarray([t.target_dist for t in dst], dtype=np.int64)
    dst_th = np.asarray([t.target_hash for t in dst], dtype=np.uint32)
    dst_ch = np.asarray([t.check_hash for t in dst], dtype=np.int64)
    dst_in = np.asarray([t.inner for t in dst], dtype=np.int64)
    o_np = np.zeros(n_dst, dtype=np.int64)
    o_di = np.zeros(n_dst, dtype=np.int64)
    o_ha = np.zeros(n_dst, dtype=np.uint32)
    o_i0 = np.zeros(n_dst, dtype=np.int64)
    o_pe = np.zeros(n_dst, dtype=np.int64)
    path_cap = 1 << 16 if want_path else 0
    pv_v = np.zeros(max(path_cap, 1), dtype=np.int64)
    pv_d = np.zeros(max(path_cap, 1), dtype=np.int64)
    pv_p = np.zeros(max(path_cap, 1), dtype=np.int64)

    def P(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    idx = g.idx
    if idx.dtype != np.int64 or not idx.flags["C_CONTIGUOUS"]:
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        g.idx = idx
    r = lib.mgt_shortest_k(
        P(idx), P(g.arc_w), P(g.arc_lv),
        P(g.arc_rank), ctypes.c_int64(len(idx)),
        ctypes.c_int64(src), ctypes.c_int64(max_dist),
        ctypes.c_int64(max_k), ctypes.c_int64(1 if want_path else 0),
        ctypes.c_int64(n_dst),
        P(dst_v), P(dst_td), P(dst_th), P(dst_ch), P(dst_in),
        P(o_np), P(o_di), P(o_ha), P(o_i0), P(o_pe),
        ctypes.c_int64(path_cap), P(pv_v), P(pv_d), P(pv_p))
    if r == -3:
        return False, None  # overflow: python fallback
    for i, t in enumerate(dst):
        t.n_path = int(o_np[i])
        t.dist = int(o_di[i])
        t.hash = int(o_ha[i])
        t.is_0 = int(o_i0[i])
        t.path_end = int(o_pe[i])
    if r == -2:
        return True, None   # reference "logical bug" guard
    if want_path and (o_np > 0).any():
        return True, [PathV(v=int(pv_v[i]), d=int(pv_d[i]),
                            pre=int(pv_p[i])) for i in range(r)]
    return True, None


def shortest_k(g, src: int, dst: List[PathDst], max_dist: int,
               max_k: int, want_path: bool) -> Optional[List[PathV]]:
    """Search from vertex src to all dst[]; fills dst fields in place.

    Returns the compressed predecessor array when want_path, else None.
    """
    n_dst = len(dst)
    if n_dst <= 0:
        return None
    ok, ret = _shortest_k_native(g, src, dst, max_dist, max_k, want_path)
    if ok:
        return ret
    for t in dst:
        if t.inner:
            t.dist, t.n_path, t.path_end = 0, 1, -1
        else:
            t.dist, t.n_path, t.path_end = -1, 0, -1
    if max_k > MG_MAX_SHORT_K:
        max_k = MG_MAX_SHORT_K

    # group destinations by vertex (dst_group sorted by (v, i))
    order = sorted(range(n_dst), key=lambda i: (dst[i].v, i))
    h2: Dict[int, Tuple[int, int]] = {}
    j = 0
    for i in range(1, n_dst + 1):
        if i == n_dst or dst[order[i]].v != dst[order[j]].v:
            h2[dst[order[j]].v] = (j, i - j)
            j = i
    dst_done = [0] * n_dst

    # visited-vertex state: v -> list of alive-or-dead nodes (<= max_k best)
    hstate: Dict[int, List[_Node]] = {}
    heap: List[Tuple[int, _Node]] = []
    out: List[_Node] = []
    node_id = 0

    p = _Node(src, 0 << 32 | node_id, -1, kh_hash_uint32(src), 1)
    node_id += 1
    heapq.heappush(heap, (p.di, p))
    hstate[src] = [p]

    n_done = 0
    arc_v, arc_w, arc_lv, arc_rank = g.arc_v, g.arc_w, g.arc_lv, g.arc_rank

    while heap:
        di, r = heapq.heappop(heap)
        if r.removed:
            continue
        r.visited = True
        r.di = (r.di >> 32) << 32 | len(out)
        out.append(r)

        grp = h2.get(r.v)
        if grp is not None:
            off, cnt = grp
            dist = r.di >> 32
            for jj in range(cnt):
                t = dst[order[off + jj]]
                done = 0
                if t.inner:
                    done = 1
                else:
                    copy = 0
                    if t.n_path == 0:
                        copy = 1
                    elif t.target_dist >= 0:
                        if dist == t.target_dist and t.check_hash \
                                and r.hash == t.target_hash:
                            copy, done = 1, 1
                        else:
                            d0 = abs(t.dist - t.target_dist)
                            d1 = abs(dist - t.target_dist)
                            if d1 < d0:
                                copy = 1
                    if copy:
                        t.path_end = len(out) - 1
                        t.dist = dist
                        t.hash = r.hash
                        t.is_0 = r.is_0
                        if t.target_dist >= 0:
                            if dist == t.target_dist and t.check_hash \
                                    and r.hash == t.target_hash:
                                done = 1
                            elif dist > t.target_dist + MG_SHORT_K_EXT:
                                done = 1
                    t.n_path += 1
                    if t.n_path >= max_k:
                        done = 1
                if dst_done[off + jj] == 0 and done:
                    dst_done[off + jj] = 1
                    n_done += 1
            if n_done == n_dst:
                break

        st, cnt = g.arc_range(r.v)
        for ai in range(st, st + cnt):
            w = int(arc_w[ai])
            d = (r.di >> 32) + int(arc_lv[ai])
            if d > max_dist:
                continue
            q = hstate.get(w)
            if q is None:
                q = []
                hstate[w] = q
            if len(q) < max_k:
                p = _Node(w, d << 32 | node_id, len(out) - 1,
                          (r.hash + kh_hash_uint32(w)) & U32, r.is_0)
                node_id += 1
                if arc_rank[ai] > 0:
                    p.is_0 = 0
                heapq.heappush(heap, (p.di, p))
                q.append(p)
            else:
                worst = max(q, key=lambda nd: nd.di)
                if (worst.di >> 32) > d:
                    if worst.visited:
                        # "logical bug" guard (shortk.c:183): abort the search
                        return None
                    worst.removed = True
                    p = _Node(w, d << 32 | node_id, len(out) - 1,
                              (r.hash + kh_hash_uint32(w)) & U32, r.is_0)
                    node_id += 1
                    if arc_rank[ai] > 0:
                        p.is_0 = 0
                    heapq.heappush(heap, (p.di, p))
                    q[q.index(worst)] = p

    n_found = sum(1 for t in dst if t.n_path > 0)
    ret: Optional[List[PathV]] = None
    if n_found > 0 and want_path:
        n_out = len(out)
        trans = [0] * n_out
        for i, t in enumerate(dst):
            if t.n_path > 0 and t.target_dist >= 0 and t.path_end >= 0:
                trans[out[t.path_end].di & U32] = 1
        for i in range(n_out):
            grp = h2.get(out[i].v)
            if grp is not None:
                off, cnt = grp
                for j in range(off, off + cnt):
                    if dst[order[j]].target_dist < 0:
                        trans[i] = 1
        for i in range(n_out - 1, -1, -1):
            if trans[i] and out[i].pre >= 0:
                trans[out[i].pre] = 1
        n = 0
        for i in range(n_out):
            if trans[i]:
                trans[i] = n
                n += 1
            else:
                trans[i] = -1
        ret = [None] * n  # type: ignore
        for i in range(n_out):
            if trans[i] < 0:
                continue
            nd = out[i]
            ret[trans[i]] = PathV(v=nd.v, d=nd.di >> 32,
                                  pre=nd.pre if nd.pre < 0 else trans[nd.pre])
        for t in dst:
            if t.path_end >= 0:
                t.path_end = trans[t.path_end]
    return ret
