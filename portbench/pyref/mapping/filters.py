"""Per-lchain end trimming and bad-seed masking (map-algo.c:194-330)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..options import MG_SEED_FIXED, MG_SEED_IGNORE

U64 = np.uint64


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


def fix_bad_ends(ax, ay, lc_max_occ: int, lc_max_trim: int,
                 as_: int, cnt: int) -> Tuple[int, int]:
    """Trim chain ends made of high-occurrence seeds (map-algo.c:194)."""
    as0, cnt0 = as_, cnt
    k = 0
    i = as0 + cnt0 - 1
    while k < lc_max_trim and k < cnt0:
        if (int(ay[i]) >> 56) <= lc_max_occ:
            break
        k += 1
        i -= 1
    cnt -= k
    k = 0
    i = as0
    while k < cnt and k < lc_max_trim:
        if (int(ay[i]) >> 56) <= lc_max_occ:
            break
        i += 1
        k += 1
    return as_ + k, cnt - k


def _i32v(a):
    return (((a & np.uint64(0xFFFFFFFF)).astype(np.int64)
             ^ 0x80000000) - 0x80000000)


def fix_bad_ends_alt(ax, ay, score: int, bw: int, min_match: int,
                     as_: int, cnt: int) -> Tuple[int, int]:
    """Score-based end shrink (map-algo.c:207-238), vectorized: the
    running l/m sums don't depend on the trim decision, so they are
    prefix sums; the early break is the first index satisfying the
    stop test and the trim point is the last flagged index before it.
    """
    as0, cnt0 = as_, cnt
    if cnt0 < 3:
        return as_, cnt
    xs = _i32v(ax[as0: as0 + cnt0])
    ys = _i32v(ay[as0: as0 + cnt0])
    spans = ((ay[as0: as0 + cnt0] >> np.uint64(32))
             & np.uint64(0xFF)).astype(np.int64)
    lr = xs[1:] - xs[:-1]
    lq = ys[1:] - ys[:-1]
    mn = np.minimum(lr, lq)
    mx = np.maximum(lr, lq)

    def one_pass(mn_, mx_, sp_, l0):
        # entries correspond to loop steps i = 0..len-1
        l_after = l0 + np.cumsum(mn_)
        m_after = l0 + np.cumsum(np.minimum(mn_, sp_))
        l_before = l_after - mn_
        stop = (l_after >= (bw << 1)) \
            | ((m_after >= min_match) & (m_after >= bw)) \
            | (m_after >= (score >> 1))
        k = int(np.argmax(stop)) if stop.any() else len(mn_) - 1
        flag = (mx_ - mn_) > (l_before >> 1)
        fl = np.nonzero(flag[: k + 1])[0]
        return int(fl[-1]) if len(fl) else -1

    l0 = int(spans[0])
    # forward: steps i = as0+1 .. as0+cnt0-2
    t = one_pass(mn[: cnt0 - 2], mx[: cnt0 - 2], spans[1: cnt0 - 1], l0)
    if t >= 0:
        as_ = as0 + 1 + t
    cnt = as0 + cnt0 - as_
    # backward: steps i = as0+cnt0-2 .. as_+1 (gaps reversed)
    l0 = int(spans[cnt0 - 1])
    nb = as0 + cnt0 - 2 - as_
    if nb > 0:
        rmn = mn[::-1][:nb]
        rmx = mx[::-1][:nb]
        rsp = spans[::-1][:nb]  # q_span of anchor i+1 at step t
        t = one_pass(rmn, rmx, rsp, l0)
        if t >= 0:
            cnt = (as0 + cnt0 - 2 - t) + 1 - as_
    return as_, cnt


def _collect_long_gaps(as1: int, cnt1: int, ax, ay, min_gap: int):
    if cnt1 < 2:
        return None
    import numpy as np

    def i32v(a):
        return (((a & np.uint64(0xFFFFFFFF)).astype(np.int64)
                 ^ 0x80000000) - 0x80000000)

    ys = i32v(ay[as1: as1 + cnt1])
    xs = i32v(ax[as1: as1 + cnt1])
    gap = (ys[1:] - ys[:-1]) - (xs[1:] - xs[:-1])
    K = (np.nonzero((gap < -min_gap) | (gap > min_gap))[0] + 1).tolist()
    if len(K) <= 1:
        return None
    return K


def filter_bad_seeds(as1: int, cnt1: int, ax, ay, min_gap: int,
                     diff_thres: int, max_ext_len: int, max_ext_cnt: int) -> None:
    """Mask seeds inside unbalanced indel clusters (map-algo.c:259-294)."""
    K = _collect_long_gaps(as1, cnt1, ax, ay, min_gap)
    if K is None:
        return
    n = len(K)
    mx = 0
    max_st = max_en = -1
    k = 0
    while True:
        if k == n or k >= max_en:
            if max_en > 0:
                for i in range(K[max_st], K[max_en]):
                    ay[as1 + i] = U64(int(ay[as1 + i]) | MG_SEED_IGNORE)
            mx = 0
            max_st = max_en = -1
            if k == n:
                break
        i = K[k]
        gap = (_i32(int(ay[as1 + i])) - _i32(int(ay[as1 + i - 1]))) \
            - (_i32(int(ax[as1 + i])) - _i32(int(ax[as1 + i - 1])))
        n_ins = gap if gap > 0 else 0
        n_del = -gap if gap <= 0 else 0
        qs = _i32(int(ay[as1 + i - 1]))
        rs = _i32(int(ax[as1 + i - 1]))
        max_diff = 0
        max_diff_l = -1
        l = k + 1
        while l < n and l <= k + max_ext_cnt:
            j = K[l]
            if _i32(int(ay[as1 + j])) - qs > max_ext_len \
                    or _i32(int(ax[as1 + j])) - rs > max_ext_len:
                break
            gap = (_i32(int(ay[as1 + j])) - _i32(int(ay[as1 + j - 1]))) \
                - (_i32(int(ax[as1 + j])) - _i32(int(ax[as1 + j - 1])))
            if gap > 0:
                n_ins += gap
            else:
                n_del += -gap
            diff = n_ins + n_del - abs(n_ins - n_del)
            if max_diff < diff:
                max_diff = diff
                max_diff_l = l
            l += 1
        if max_diff > diff_thres and max_diff > mx:
            mx = max_diff
            max_st = k
            max_en = max_diff_l
        k += 1


def filter_bad_seeds_alt(as1: int, cnt1: int, ax, ay, min_gap: int,
                         max_ext: int) -> None:
    """Mask seeds between compensating gaps (map-algo.c:296-330)."""
    K = _collect_long_gaps(as1, cnt1, ax, ay, min_gap)
    if K is None:
        return
    n = len(K)
    k = 0
    while k < n:
        i = K[k]
        gap1 = (_i32(int(ay[as1 + i])) - _i32(int(ay[as1 + i - 1]))) \
            - (_i32(int(ax[as1 + i])) - _i32(int(ax[as1 + i - 1])))
        re1 = _i32(int(ax[as1 + i]))
        qe1 = _i32(int(ay[as1 + i]))
        gap1 = gap1 if gap1 > 0 else -gap1
        l = k + 1
        while l < n:
            j = K[l]
            if _i32(int(ay[as1 + j])) - qe1 > max_ext \
                    or _i32(int(ax[as1 + j])) - re1 > max_ext:
                break
            gap2 = (_i32(int(ay[as1 + j])) - _i32(int(ay[as1 + j - 1]))) \
                - (_i32(int(ax[as1 + j])) - _i32(int(ax[as1 + j - 1])))
            q_span_pre = (int(ay[as1 + j - 1]) >> 32) & 0xFF
            rs2 = _i32(int(ax[as1 + j - 1])) + q_span_pre
            qs2 = _i32(int(ay[as1 + j - 1])) + q_span_pre
            m = min(rs2 - re1, qs2 - qe1)
            gap2 = gap2 if gap2 > 0 else -gap2
            if m > gap1 + gap2:
                break
            re1 = _i32(int(ax[as1 + j]))
            qe1 = _i32(int(ay[as1 + j]))
            gap1 = gap2
            l += 1
        if l > k + 1:
            end = K[l - 1]
            for j in range(K[k], end):
                ay[as1 + j] = U64(int(ay[as1 + j]) | MG_SEED_IGNORE)
            ay[as1 + end] = U64(int(ay[as1 + end]) | MG_SEED_FIXED)
        k = l


_native_flt_cfg = False


def apply_chain_filters(ax, ay, off: int, cnt: int, score: int,
                        opt) -> Tuple[int, int]:
    """The whole per-chain filter block (mapper tail order): occurrence
    end trim, score end shrink, unbalanced-indel and compensating-gap
    seed masking.  Native C (native/mgt_filters.c) when available."""
    global _native_flt_cfg
    import ctypes as ct

    from ..utils.native import get_lib
    lib = get_lib()
    if lib is not None and hasattr(lib, "mgt_chain_filters"):
        if not _native_flt_cfg:
            u64p = ct.POINTER(ct.c_uint64)
            i64p = ct.POINTER(ct.c_int64)
            lib.mgt_chain_filters.restype = None
            lib.mgt_chain_filters.argtypes = [
                u64p, u64p, ct.c_int32, ct.c_int32, ct.c_int32,
                ct.c_int32, ct.c_int32, ct.c_int32, i64p, i64p]
            _native_flt_cfg = True
        assert ax.flags["C_CONTIGUOUS"] and ay.flags["C_CONTIGUOUS"]
        off_c = ct.c_int64(off)
        cnt_c = ct.c_int64(cnt)
        lib.mgt_chain_filters(
            ax.ctypes.data_as(ct.POINTER(ct.c_uint64)),
            ay.ctypes.data_as(ct.POINTER(ct.c_uint64)),
            opt.lc_max_occ, opt.lc_max_trim, score, opt.bw, 100,
            opt.max_gap >> 1, ct.byref(off_c), ct.byref(cnt_c))
        return off_c.value, cnt_c.value
    off, cnt = fix_bad_ends(ax, ay, opt.lc_max_occ, opt.lc_max_trim,
                            off, cnt)
    off, cnt = fix_bad_ends_alt(ax, ay, score, opt.bw, 100, off, cnt)
    filter_bad_seeds(off, cnt, ax, ay, 10, 40, opt.max_gap >> 1, 10)
    filter_bad_seeds_alt(off, cnt, ax, ay, 30, opt.max_gap >> 1)
    return off, cnt
