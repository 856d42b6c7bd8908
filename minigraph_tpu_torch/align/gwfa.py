"""Graph wavefront alignment (GWFA, gfa-ed.c) bridging two linear
chains during graph-chain materialization (bridge_gwfa,
gchain1.c:349-381): the native engine (native/mgt_gwfa.c), and the
exact Python engine (align/gwfa_exact.py) when the native one
overflows its caps.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..mapping.native_tail import _flat_graph
from ..utils.native import get_lib
from .gwfa_exact import gwfa_ed

_cfg = False


def _native_gwfa(g, es, qseq, v0, end0, v1, end1, max_ed):
    global _cfg
    lib = get_lib()
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
    return gwfa_ed(g, es, qseq, v0, end0, v1, end1, max_ed)
