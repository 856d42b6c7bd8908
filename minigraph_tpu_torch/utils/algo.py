"""Generic algorithms: all-maximal-scoring segments and interval
overlap queries (algo.c)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

MSS_NEG_INF = -0x80000000


@dataclass
class MsSeg:
    st: int
    en: int
    sc: int


def mss_all(S, min_sc: int, xdrop: int) -> List[MsSeg]:
    """Ruzzo-Tompa all-maximal-scoring-segments with optional x-drop
    reset (mg_mss_all, algo.c:40-93)."""
    n = len(S)
    ret: List[MsSeg] = []
    seg: List[list] = []  # [st, en, L, R, pre]

    def move_segs():
        for p in seg:
            if p[3] - p[2] >= min_sc:
                ret.append(MsSeg(p[0], p[1], p[3] - p[2]))
        seg.clear()

    i = 0
    L = 0
    mx = MSS_NEG_INF
    while i < n:
        if S[i] > 0:
            R = L + S[i]
            k = i + 1
            while k < n and S[k] > 0:
                R += S[k]
                k += 1
            if R > mx:
                mx = R
            t = [i, k, L, R, 0]
            while True:
                j = len(seg) - 1
                while j >= 0:
                    p = seg[j]
                    if p[2] < t[2]:
                        break
                    j = p[4] if p[4] >= 0 else j - 1
                if j >= 0 and seg[j][3] < t[3]:
                    p = seg[j]
                    t[0], t[2], t[4] = p[0], p[2], p[4]
                    del seg[j:]
                else:
                    if j < 0:
                        move_segs()
                        mx = R
                    t[4] = j
                    seg.append(t)
                    break
            L = R
            i = k
        else:
            if xdrop > 0 and L + S[i] + xdrop < mx:
                move_segs()
                L = 0
                mx = MSS_NEG_INF
            L += S[i]
            i += 1
    move_segs()
    return ret


class IntervalSet:
    """Interval list with overlap counting.

    The reference uses an Eytzinger-layout implicit interval tree
    (algo.c:105-171); only overlap membership matters to callers, so a
    sorted-array + vectorized scan is result-equivalent.
    """

    def __init__(self, intervals: List[Tuple[int, int]]):
        # reference sorts by start (radix, ties order-irrelevant for counting)
        ivs = sorted(intervals, key=lambda x: x[0])
        self.st = np.asarray([x[0] for x in ivs], dtype=np.int64)
        self.en = np.asarray([x[1] for x in ivs], dtype=np.int64)

    def count_overlap(self, st: int, en: int) -> int:
        if len(self.st) == 0:
            return 0
        return int(np.count_nonzero((self.st < en) & (self.en > st)))
