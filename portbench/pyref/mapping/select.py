"""Primary/secondary chain selection and mapping quality
(gcmisc.c:74-223)."""
from __future__ import annotations

from typing import List

import numpy as np

from ..utils.hashes import logf
from ..utils.ksort import radix_argsort
from .gchain import GChains, gchain_restore_order


def gchain_set_parent(mask_level: float, gcs_gc: List, sub_diff: int,
                      hard_mask_level: int = 0) -> None:
    """Assign primary/secondary by query overlap (gcmisc.c:74-128).
    Assumes chains sorted by score."""
    n = len(gcs_gc)
    if n <= 0:
        return
    for i, r in enumerate(gcs_gc):
        r.id = i
    w = [0]
    gcs_gc[0].parent = 0
    k = 1
    for i in range(1, n):
        ri = gcs_gc[i]
        si, ei = ri.qs, ri.qe
        uncov_len = 0
        if not hard_mask_level:
            cov = []
            for j in range(k):
                rp = gcs_gc[w[j]]
                sj, ej = rp.qs, rp.qe
                if ej <= si or sj >= ei:
                    continue
                cov.append((max(sj, si) << 32) | min(ej, ei))
            if cov:
                keys = np.asarray(cov, dtype=np.uint64)
                perm = radix_argsort(keys)
                x = si
                for pi in perm:
                    cj = int(keys[pi])
                    s_, e_ = cj >> 32, cj & 0xFFFFFFFF
                    if s_ > x:
                        uncov_len += s_ - x
                    x = max(e_, x)
                if ei > x:
                    uncov_len += ei - x
        j = 0
        while j < k:
            rp = gcs_gc[w[j]]
            sj, ej = rp.qs, rp.qe
            if ej <= si or sj >= ei:
                j += 1
                continue
            mn = min(ej - sj, ei - si)
            mx = max(ej - sj, ei - si)
            if si < sj:
                ol = 0 if ei < sj else (ei - sj if ei < ej else ej - sj)
            else:
                ol = 0 if ej < si else (ej - si if ej < ei else ei - si)
            # float32 like the reference (gcmisc.c:114) and the native
            # engine, so fallback and fused paths can never diverge on
            # a ulp-edge comparison
            if np.float32(ol) / np.float32(mn) \
                    - np.float32(uncov_len) / np.float32(mx) \
                    > np.float32(mask_level):
                ri.parent = rp.parent
                rp.subsc = max(rp.subsc, ri.score)
                if ri.cnt >= rp.cnt:
                    rp.n_sub += 1
                break
            j += 1
        if j == k:
            w.append(i)
            k += 1
            ri.parent = i
            ri.n_sub = 0


def gchain_flt_sub(pri_ratio: float, min_diff: int, best_n: int,
                   gcs_gc: List) -> int:
    """Mark weak secondary chains filtered (gcmisc.c:131-148)."""
    n = len(gcs_gc)
    if pri_ratio > 0.0 and n > 0:
        k = 0
        n_2nd = 0
        for i in range(n):
            r = gcs_gc[i]
            p = r.parent
            rp = gcs_gc[p]
            if p == i:
                r.flt = 0
                k += 1
            elif (np.float32(r.score)
                  >= np.float32(rp.score) * np.float32(pri_ratio)
                  or r.score + min_diff >= rp.score) and n_2nd < best_n:
                if not (r.qs == rp.qs and r.qe == rp.qe and r.ps == rp.ps
                        and r.pe == rp.pe):
                    r.flt = 0
                    n_2nd += 1
                    k += 1
                else:
                    r.flt = 1
            else:
                r.flt = 1
        return k
    return n


def gchain_drop_flt(gcs: GChains) -> None:
    """Hard-drop filtered chains (gcmisc.c:151-188)."""
    if gcs.n_gc == 0:
        return
    o2n = {}
    n_gc = 0
    for i, r in enumerate(gcs.gc):
        if r.flt or r.cnt == 0:
            continue
        o2n[i] = n_gc
        n_gc += 1
    new_gc = []
    new_lc = []
    ax_parts, ay_parts = [], []
    for i, r in enumerate(gcs.gc):
        if i in o2n:
            first = gcs.lc[r.off]
            new_lc_off = len(new_lc)
            new_lc.extend(gcs.lc[r.off: r.off + r.cnt])
            ax_parts.append(gcs.ax[first.off: first.off + r.n_anchor])
            ay_parts.append(gcs.ay[first.off: first.off + r.n_anchor])
            r.id = o2n[i]
            r.parent = o2n.get(r.parent, -1)
            new_gc.append(r)
    gcs.gc = new_gc
    gcs.lc = new_lc
    gcs.ax = np.concatenate(ax_parts) if ax_parts else np.empty(0, np.uint64)
    gcs.ay = np.concatenate(ay_parts) if ay_parts else np.empty(0, np.uint64)
    if hasattr(gcs, "_lc_tables"):
        del gcs._lc_tables   # native-engine cache is layout-bound
    n_lc = 0
    for gc in gcs.gc:
        gc.off = n_lc
        gc.n_anchor = sum(lc.cnt for lc in gcs.lc[n_lc: n_lc + gc.cnt])
        n_lc += gc.cnt
    n_a = 0
    for lc in gcs.lc:
        lc.off = n_a
        n_a += lc.cnt


def gchain_set_mapq(gcs: GChains, qlen: int, max_mini: int,
                    min_gc_score: int) -> None:
    """minimap2-style mapq (gcmisc.c:191-223)."""
    q_coef = np.float32(40.0)
    if gcs is None or gcs.n_gc == 0:
        return
    t_sc = qlen if qlen < 100 else 100
    t_cnt = max_mini if max_mini < 10 else 10
    if t_cnt < 5:
        t_cnt = 5
    r_sc = 1.0 / t_sc
    r_cnt = 1.0 / t_cnt
    sum_sc = sum(gc.score for gc in gcs.gc if gc.parent == gc.id)
    uniq_ratio = np.float32(np.float32(sum_sc) / np.float32(sum_sc + gcs.rep_len))
    for r in gcs.gc:
        if r.parent == r.id:
            F = np.float32
            pen_s1 = F((F(1.0) if r.score > t_sc else F(F(r.score) * F(r_sc)))
                       * uniq_ratio)
            pen_cm = F(1.0) if r.n_anchor > t_cnt else F(F(r.n_anchor) * F(r_cnt))
            pen_cm = pen_s1 if pen_s1 < pen_cm else pen_cm
            subsc = r.subsc if r.subsc > min_gc_score else min_gc_score
            x = F(F(subsc) / F(r.score))
            mapq = int(F(F(pen_cm * q_coef) * F(F(1.0) - x)) * F(logf(float(r.score))))
            mapq -= int(F(F(4.343) * F(logf(float(r.n_sub + 1))) + F(0.499)))
            mapq = mapq if mapq > 0 else 0
            if r.score > subsc and mapq == 0:
                mapq = 1
            r.mapq = mapq if mapq < 60 else 60
        else:
            r.mapq = 0
