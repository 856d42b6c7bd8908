"""RMQ-based long-range linear chaining (mg_lchain_rmq, lchain.c:252-372).

Used by the asm/ggs presets and as the long-join rescue pass for poorly
covered long queries.  The balanced-tree range-min query finds the best
predecessor under the concave gap cost; a second "inner" tree handles
near-diagonal candidates exactly like the reference.
"""
from __future__ import annotations

import numpy as np

from ..utils.hashes import mg_log2
from ..utils.krmq import RMQNode, RMQTree
from .lchain import _i32, chain_backtrack, compact_a

INT32_MAX = 0x7FFFFFFF
F32 = np.float32


def comput_sc_simple(ax_i, ay_i, ax_j, ay_j, chn_pen_gap, chn_pen_skip):
    """lchain.c:234-250; returns (sc, exact, width)."""
    dq = _i32(ay_i) - _i32(ay_j)
    dr = _i32((ax_i - ax_j) & 0xFFFFFFFFFFFFFFFF)
    dd = dr - dq if dr > dq else dq - dr
    width = dd
    dg = dr if dr < dq else dq
    q_span = (ay_j >> 32) & 0xFF
    sc = q_span if q_span < dg else dg
    exact = (dd == 0 and dg <= q_span)
    if dd or dq > q_span:
        lin_pen = F32(F32(chn_pen_gap) * F32(dd) + F32(chn_pen_skip) * F32(dg))
        log_pen = F32(mg_log2(dd + 1)) if dd >= 1 else F32(0.0)
        sc -= int(F32(lin_pen + F32(0.5) * log_pen))
    return sc, exact, width


def lchain_rmq_impl(max_dist, max_dist_inner, bw, max_chn_skip, cap_rmq_size,
                    min_cnt, min_sc, chn_pen_gap, chn_pen_skip,
                    ax: np.ndarray, ay: np.ndarray):
    n = len(ax)
    if n == 0:
        return ax, ay, 0, np.empty(0, dtype=np.uint64)
    from .lchain import _native_chain
    res = _native_chain(
        "mgt_lchain_rmq",
        (max_dist, max_dist_inner, bw, max_chn_skip, cap_rmq_size,
         min_cnt, min_sc, float(np.float32(chn_pen_gap)),
         float(np.float32(chn_pen_skip))),
        ax, ay)
    if res is not None:
        return res
    if max_dist < bw:
        max_dist = bw
    if max_dist_inner <= 0 or max_dist_inner >= max_dist:
        max_dist_inner = 0
    f = np.zeros(n, dtype=np.int64)
    p = np.full(n, -1, dtype=np.int64)
    t = np.full(n, -1, dtype=np.int64)
    v = np.zeros(n, dtype=np.int64)
    root = RMQTree()
    root_inner = RMQTree()
    use_inner = max_dist_inner > 0

    axi = [int(x) for x in ax]
    ayi = [int(y) for y in ay]
    st = st_inner = 0
    i0 = 0
    chn_pen_gap_d = float(np.float32(chn_pen_gap))

    for i in range(n):
        q_span = (ayi[i] >> 32) & 0xFF
        max_f = q_span
        max_j = -1
        # add in-range anchors
        if i0 < i and axi[i0] != axi[i]:
            for j in range(i0, i):
                pri = -(int(f[j]) + 0.5 * chn_pen_gap_d
                        * (_i32(axi[j]) + _i32(ayi[j])))
                root.insert(RMQNode(_i32(ayi[j]), j, pri))
                if use_inner:
                    root_inner.insert(RMQNode(_i32(ayi[j]), j, pri))
            i0 = i
        # evict out-of-range anchors
        while st < i and ((axi[i] >> 32) != (axi[st] >> 32)
                          or axi[i] > axi[st] + max_dist
                          or root.size() > cap_rmq_size):
            q = root.find((_i32(ayi[st]), st))
            if q is not None:
                root.erase(q)
            st += 1
        if use_inner:
            while st_inner < i and ((axi[i] >> 32) != (axi[st_inner] >> 32)
                                    or axi[i] > axi[st_inner] + max_dist_inner
                                    or root_inner.size() > cap_rmq_size):
                q = root_inner.find((_i32(ayi[st_inner]), st_inner))
                if q is not None:
                    root_inner.erase(q)
                st_inner += 1
        # RMQ over [y - max_dist, y - 1]
        lo = (_i32(ayi[i]) - max_dist, INT32_MAX)
        hi = (_i32(ayi[i]) - 1, 0)
        q = root.rmq(lo, hi)
        if q is not None:
            n_skip = 0
            j = q.i
            assert lo[0] <= q.y <= hi[0]
            sc, exact, width = comput_sc_simple(axi[i], ayi[i], axi[j], ayi[j],
                                                chn_pen_gap, chn_pen_skip)
            sc += int(f[j])
            if width <= bw and sc > max_f:
                max_f, max_j = sc, j
            if not exact and use_inner and root_inner.root is not None \
                    and _i32(ayi[i]) > 0:
                lo_node, _ = root_inner.interval((_i32(ayi[i]) - 1, n))
                if lo_node is not None:
                    qq = lo_node
                    while qq is not None:
                        if qq.y < _i32(ayi[i]) - max_dist_inner:
                            break
                        j = qq.i
                        sc, _, width = comput_sc_simple(
                            axi[i], ayi[i], axi[j], ayi[j],
                            chn_pen_gap, chn_pen_skip)
                        sc += int(f[j])
                        if width <= bw:
                            if sc > max_f:
                                max_f, max_j = sc, j
                                if n_skip > 0:
                                    n_skip -= 1
                            elif t[j] == i:
                                n_skip += 1
                                if n_skip > max_chn_skip:
                                    break
                            if p[j] >= 0:
                                t[p[j]] = i
                        qq = root_inner.prev_of(qq)
        assert max_j < 0 or (axi[max_j] < axi[i]
                             and _i32(ayi[max_j]) < _i32(ayi[i]))
        f[i] = max_f
        p[i] = max_j
        v[i] = v[max_j] if (max_j >= 0 and v[max_j] > max_f) else max_f

    u, vv, n_u, n_v = chain_backtrack(n, f, p, min_cnt, min_sc, bw, 0)
    if n_u == 0:
        return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64),
                0, np.empty(0, dtype=np.uint64))
    ox, oy = compact_a(n_u, u, n_v, vv, ax, ay)
    return ox, oy, n_u, u
