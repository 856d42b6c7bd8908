"""Graph wavefront alignment (GWFA) over the GFA topology
(gfa-ed.c).  Used to bridge linear chains during graph-chain
materialization and to score candidate insertions during graph
generation.

Placeholder: the exact GWFA engine lands with the base-alignment
milestone; returning failure makes callers fall back to
target-distance shortest-path bridging (gchain1.c:386-388).
"""
from __future__ import annotations


import ctypes

import numpy as np

_cfg = False


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


def _native_gwfa(g, es, qseq, v0, end0, v1, end1, max_ed):
    global _cfg
    from ..utils.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "mgt_gwfa_ed"):
        return None
    if not _cfg:
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.mgt_gwfa_ed.restype = ctypes.c_int32
        lib.mgt_gwfa_ed.argtypes = [
            i64p, i32p, u32p, i32p, i64p, i32p, ctypes.c_char_p,
            ctypes.c_int32, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int32,
            ctypes.c_uint32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64,
            i32p, ctypes.c_int32, i32p,
        ]
        _cfg = True
    arc_start, arc_cnt, arc_w, arc_ow, seq_off, seq_len, seq_buf = \
        _flat_graph(g, es)
    qb = qseq.encode("latin-1") if isinstance(qseq, str) else qseq
    # walk length is bounded by query span + edit distance
    walk = np.zeros(len(qb) + max_ed + 64, dtype=np.int32)
    n_walk = ctypes.c_int32(0)

    def P(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    s = lib.mgt_gwfa_ed(
        P(arc_start, ctypes.c_int64), P(arc_cnt, ctypes.c_int32),
        P(arc_w, ctypes.c_uint32), P(arc_ow, ctypes.c_int32),
        P(seq_off, ctypes.c_int64), P(seq_len, ctypes.c_int32), seq_buf,
        len(qb), qb, v0, end0, v1, end1,
        max_ed, 1, 1000, 1000, max_ed // 2, 500_000_000,
        P(walk, ctypes.c_int32), len(walk), ctypes.byref(n_walk))
    if s == -2:
        return None      # overflow: use the exact Python engine
    return s, [int(x) for x in walk[: n_walk.value]]


def gwfa_bridge(g, es, qseq: str, v0: int, end0: int, v1: int, end1: int,
                max_ed: int):
    """Returns (score, vertex_walk).  score < 0 means failure."""
    res = _native_gwfa(g, es, qseq, v0, end0, v1, end1, max_ed)
    if res is not None:
        return res
    from .gwfa_exact import gwfa_ed
    return gwfa_ed(g, es, qseq, v0, end0, v1, end1, max_ed)
