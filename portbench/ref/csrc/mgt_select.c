/* Primary/secondary selection + mapq on the native chain tables
 * (mg_gchain_set_parent / mg_gchain_flt_sub / mg_gchain_drop_flt /
 * mg_gchain_set_mapq, gcmisc.c:74-223).  Runs directly on the
 * mgt_gchain_full / mgt_map_tail output scratch so the per-read
 * Python finish stage reduces to building the few surviving chain
 * objects.  All float arithmetic is single-precision exactly as the
 * reference (incl. libm logf), so mapq is bit-identical.
 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* Insertion sort on u64 values: the reference radix-sorts the cov[]
 * keys (gcmisc.c:100) but only the sorted VALUES are consumed, so any
 * correct ordering gives identical uncov_len; cov is tiny (<= number
 * of primaries). */
static void sort_u64(uint64_t *a, int64_t n)
{
    int64_t i, j;
    for (i = 1; i < n; ++i) {
        uint64_t v = a[i];
        for (j = i - 1; j >= 0 && a[j] > v; --j) a[j + 1] = a[j];
        a[j + 1] = v;
    }
}

/* In: chain tables sorted by score desc (post mgt_gchain_full).
 * Out: tables compacted to the surviving chains; per-chain
 * parent/mapq/n_sub/subsc planes filled.  Returns the new n_gc,
 * or -1 on alloc failure (caller falls back to the Python stage). */
int64_t mgt_select_chains(
    double mask_level, double pri_ratio, int64_t min_diff,
    int64_t best_n, int64_t qlen, int64_t max_mini,
    int64_t min_gc_score, int64_t rep_len, int64_t n_gc,
    int64_t *g_off, int64_t *g_cnt, int64_t *g_na, int64_t *g_sc,
    uint32_t *g_hash, int64_t *g_extra,
    int64_t *o_lv, int64_t *o_loff, int64_t *o_lcnt, int64_t *o_lsc,
    int64_t *o_led, uint64_t *o_ax, uint64_t *o_ay,
    int64_t *out_parent, int64_t *out_mapq, int64_t *out_nsub,
    int64_t *out_subsc)
{
    int64_t i, j, k, n_kept;
    int64_t *parent = 0, *n_sub = 0, *subsc = 0, *w = 0, *o2n = 0;
    uint64_t *cov = 0;
    unsigned char *flt = 0;
    float maskf = (float)mask_level, prif = (float)pri_ratio;

    if (n_gc <= 0) return 0;
    parent = (int64_t *)malloc(8 * (size_t)n_gc);
    n_sub = (int64_t *)calloc((size_t)n_gc, 8);
    subsc = (int64_t *)calloc((size_t)n_gc, 8);
    w = (int64_t *)malloc(8 * (size_t)n_gc);
    o2n = (int64_t *)malloc(8 * (size_t)n_gc);
    cov = (uint64_t *)malloc(8 * (size_t)n_gc);
    flt = (unsigned char *)calloc((size_t)n_gc, 1);
    if (!parent || !n_sub || !subsc || !w || !o2n || !cov || !flt)
        goto fail;

    /* ---- set_parent (gcmisc.c:74-128); hard_mask_level == 0 on the
     * mapping path (map-algo.c:464) ---- */
    w[0] = 0, parent[0] = 0;
    for (i = 1, k = 1; i < n_gc; ++i) {
        int64_t si = g_extra[i * 8], ei = g_extra[i * 8 + 1];
        int64_t n_cov = 0, uncov_len = 0;
        for (j = 0; j < k; ++j) {
            int64_t sj = g_extra[w[j] * 8], ej = g_extra[w[j] * 8 + 1];
            if (ej <= si || sj >= ei) continue;
            if (sj < si) sj = si;
            if (ej > ei) ej = ei;
            cov[n_cov++] = (uint64_t)sj << 32 | (uint64_t)ej;
        }
        if (n_cov > 0) {
            int64_t x = si;
            sort_u64(cov, n_cov);
            for (j = 0; j < n_cov; ++j) {
                int64_t cs = (int64_t)(cov[j] >> 32);
                int64_t ce = (int64_t)(int32_t)(uint32_t)cov[j];
                if (cs > x) uncov_len += cs - x;
                x = ce > x ? ce : x;
            }
            if (ei > x) uncov_len += ei - x;
        }
        for (j = 0; j < k; ++j) {
            int64_t p = w[j];
            int64_t sj = g_extra[p * 8], ej = g_extra[p * 8 + 1];
            int64_t mn, mx, ol;
            if (ej <= si || sj >= ei) continue;
            mn = ej - sj < ei - si ? ej - sj : ei - si;
            mx = ej - sj > ei - si ? ej - sj : ei - si;
            ol = si < sj ? (ei < sj ? 0 : ei < ej ? ei - sj : ej - sj)
                         : (ej < si ? 0 : ej < ei ? ej - si : ei - si);
            if ((float)ol / mn - (float)uncov_len / mx > maskf) {
                parent[i] = parent[p];
                subsc[p] = subsc[p] > g_sc[i] ? subsc[p] : g_sc[i];
                if (g_cnt[i] >= g_cnt[p]) ++n_sub[p];
                break;
            }
        }
        if (j == k) w[k++] = i, parent[i] = i, n_sub[i] = 0;
    }

    /* ---- flt_sub (gcmisc.c:131-148) ---- */
    if (pri_ratio > 0.0) {
        int64_t n_2nd = 0;
        for (i = 0; i < n_gc; ++i) {
            int64_t p = parent[i];
            if (p == i) {
                flt[i] = 0;
            } else if (((float)g_sc[i] >= (float)g_sc[p] * prif
                        || g_sc[i] + min_diff >= g_sc[p])
                       && n_2nd < best_n) {
                /* not an identical hit: compare qs/qe/ps/pe */
                const int64_t *a = g_extra + i * 8, *b = g_extra + p * 8;
                if (!(a[0] == b[0] && a[1] == b[1] && a[2] == b[2]
                      && a[3] == b[3]))
                    flt[i] = 0, ++n_2nd;
                else
                    flt[i] = 1;
            } else {
                flt[i] = 1;
            }
        }
    }

    /* ---- drop_flt: compact chains, llchains and anchors in place
     * (gcmisc.c:151-188 + mg_gchain_restore_offset) ---- */
    n_kept = 0;
    for (i = 0; i < n_gc; ++i) {
        o2n[i] = -1;
        if (flt[i] || g_cnt[i] == 0) continue;
        o2n[i] = n_kept++;
    }
    {
        int64_t n_lc = 0, n_a = 0, n_lc0 = 0, n_a0 = 0, ng = 0;
        for (i = 0; i < n_gc; ++i) {
            int64_t cnt = g_cnt[i], na = g_na[i];
            if (o2n[i] >= 0) {
                if (n_a != n_a0) {
                    memmove(o_ax + n_a, o_ax + n_a0, 8 * (size_t)na);
                    memmove(o_ay + n_a, o_ay + n_a0, 8 * (size_t)na);
                }
                if (n_lc != n_lc0) {
                    memmove(o_lv + n_lc, o_lv + n_lc0, 8 * (size_t)cnt);
                    memmove(o_lcnt + n_lc, o_lcnt + n_lc0, 8 * (size_t)cnt);
                    memmove(o_lsc + n_lc, o_lsc + n_lc0, 8 * (size_t)cnt);
                    memmove(o_led + n_lc, o_led + n_lc0, 8 * (size_t)cnt);
                }
                g_cnt[ng] = cnt, g_na[ng] = na, g_sc[ng] = g_sc[i];
                g_hash[ng] = g_hash[i];
                if (ng != i)
                    memmove(g_extra + ng * 8, g_extra + i * 8, 64);
                out_parent[ng] = parent[i] >= 0 ? o2n[parent[i]] : -1;
                out_nsub[ng] = n_sub[i];
                out_subsc[ng] = subsc[i];
                ++ng, n_lc += cnt, n_a += na;
            }
            n_lc0 += cnt, n_a0 += na;
        }
        /* restore offsets over the compacted layout */
        n_lc = 0;
        for (i = 0; i < n_kept; ++i) {
            g_off[i] = n_lc;
            n_lc += g_cnt[i];
        }
        n_a = 0;
        for (i = 0; i < n_lc; ++i) {
            o_loff[i] = n_a;
            n_a += o_lcnt[i];
        }
    }

    /* ---- set_mapq (gcmisc.c:191-223) on the kept set ---- */
    {
        const float q_coef = 40.0f;
        int64_t sum_sc = 0;
        float uniq_ratio, r_sc, r_cnt;
        int64_t t_sc = qlen < 100 ? qlen : 100;
        int64_t t_cnt = max_mini < 10 ? max_mini : 10;
        if (t_cnt < 5) t_cnt = 5;
        r_sc = 1.0 / t_sc;
        r_cnt = 1.0 / t_cnt;
        for (i = 0; i < n_kept; ++i)
            if (out_parent[i] == i) sum_sc += g_sc[i];
        uniq_ratio = (float)sum_sc / (sum_sc + rep_len);
        for (i = 0; i < n_kept; ++i) {
            if (out_parent[i] == i) {
                int64_t mapq, ssc;
                float x, pen_s1, pen_cm;
                pen_s1 = (g_sc[i] > t_sc ? 1.0f : g_sc[i] * r_sc)
                         * uniq_ratio;
                pen_cm = g_na[i] > t_cnt ? 1.0f : g_na[i] * r_cnt;
                pen_cm = pen_s1 < pen_cm ? pen_s1 : pen_cm;
                ssc = out_subsc[i] > min_gc_score ? out_subsc[i]
                                                  : min_gc_score;
                x = (float)ssc / g_sc[i];
                mapq = (int64_t)(pen_cm * q_coef * (1.0f - x)
                                 * logf((float)g_sc[i]));
                mapq -= (int64_t)(4.343f * logf((float)(out_nsub[i] + 1))
                                  + .499f);
                mapq = mapq > 0 ? mapq : 0;
                if (g_sc[i] > ssc && mapq == 0) mapq = 1;
                out_mapq[i] = mapq < 60 ? mapq : 60;
            } else {
                out_mapq[i] = 0;
            }
        }
    }

    free(parent); free(n_sub); free(subsc); free(w); free(o2n);
    free(cov); free(flt);
    return n_kept;
fail:
    free(parent); free(n_sub); free(subsc); free(w); free(o2n);
    free(cov); free(flt);
    return -1;
}
