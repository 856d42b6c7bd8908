/* Whole per-read mapping tail in ONE call (map-algo.c:377-495): the
 * linear-chain stage (finish-from-device-DP / banded DP / RMQ), the
 * long-join RMQ rescue re-chain (map-algo.c:407-417), the fused
 * lchain tail (mg_lchain_gen + filter block + mg_update_anchors) and
 * the whole graph-chain stage (DP + materialization + extras + score
 * sort).  Composes the in-process engines; every stage keeps the
 * reference-exact tie permutations, so output stays byte-identical
 * to the decomposed Python-driven path (which remains the fallback
 * for debug dumps and engine bailouts).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

/* Env-gated stage profiling (MGT_PROF=1): per-stage wall ns summed
 * atomically across worker threads; mgt_tail_prof_dump reads+resets.
 * Stages: 0 lchain, 1 rescue, 2 lchain_tail, 3 gchain_full.
 * Counters (mgt_tail_prof_dump8 slots 4-7): 4 rescue calls,
 * 5 rescue anchors, 6 rescue inner-walk iters, 7 first-pass anchors. */
static int64_t mgt_prof_ns[8];
static int mgt_prof_on = -1;

static inline int mgt_tail_prof(void)
{
    if (mgt_prof_on < 0) {
        const char *e = getenv("MGT_PROF");
        mgt_prof_on = e && *e && *e != '0';
    }
    return mgt_prof_on;
}

static inline int64_t mgt_now_ns(void)
{
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

static inline void mgt_prof_add(int k, int64_t ns)
{
    __atomic_fetch_add(&mgt_prof_ns[k], ns, __ATOMIC_RELAXED);
}

void mgt_tail_prof_dump(int64_t *out4)
{
    int k;
    for (k = 0; k < 4; ++k) {
        out4[k] = __atomic_load_n(&mgt_prof_ns[k], __ATOMIC_RELAXED);
        __atomic_store_n(&mgt_prof_ns[k], (int64_t)0, __ATOMIC_RELAXED);
    }
}

/* non-static accessor for sibling translation units (mgt_gchain.c) */
int mgt_tail_prof_on(void) { return mgt_tail_prof(); }

void mgt_tail_prof_dump8(int64_t *out8)
{
    int k;
    for (k = 0; k < 8; ++k) {
        out8[k] = __atomic_load_n(&mgt_prof_ns[k], __ATOMIC_RELAXED);
        __atomic_store_n(&mgt_prof_ns[k], (int64_t)0, __ATOMIC_RELAXED);
    }
}

extern void mgt_radix_sort_128x(uint64_t *a, int64_t n);
extern int64_t mgt_lchain_dp(int32_t max_dist_x, int32_t max_dist_y,
                             int32_t bw, int32_t max_skip, int32_t max_iter,
                             int32_t min_cnt, int32_t min_sc,
                             float chn_pen_gap, float chn_pen_skip,
                             int32_t is_cdna, int32_t n_seg, int64_t n,
                             uint64_t *ax, uint64_t *ay, uint64_t *u_out,
                             int32_t *n_u_out);
extern int64_t mgt_lchain_rmq(int32_t max_dist, int32_t max_dist_inner,
                              int32_t bw, int32_t max_chn_skip,
                              int32_t cap_rmq_size, int32_t min_cnt,
                              int32_t min_sc, float chn_pen_gap,
                              float chn_pen_skip, int64_t n, uint64_t *ax,
                              uint64_t *ay, uint64_t *u_out,
                              int32_t *n_u_out);
extern int64_t mgt_lchain_finish(int32_t bw, int32_t is_cdna,
                                 int32_t min_cnt, int32_t min_sc, int64_t n,
                                 const int32_t *f32v, const int32_t *p32,
                                 uint64_t *ax, uint64_t *ay,
                                 uint64_t *u_out, int32_t *n_u_out);
extern int64_t mgt_lchain_tail(
    int64_t qlen, int64_t n_u, const uint64_t *u, uint64_t *ax,
    uint64_t *ay, const int64_t *mini_pos, int64_t n_mv,
    int64_t lc_max_occ, int64_t lc_max_trim, int64_t bw,
    int64_t max_gap_half, int64_t min_lc_cnt,
    int64_t *t_off, int64_t *t_cnt, int64_t *t_v, int64_t *t_rs,
    int64_t *t_re, int64_t *t_qs, int64_t *t_qe, int64_t *t_score);
extern int64_t mgt_gchain_full(
    const int64_t *gidx, const int64_t *arc_w, const int64_t *arc_lv,
    const int64_t *arc_rank, int64_t n_vtx, const int64_t *seg_len,
    int64_t *gw_arc_start, int32_t *gw_arc_cnt, uint32_t *gw_arc_w,
    int32_t *gw_arc_ow, int64_t *gw_seq_off, int32_t *gw_seq_len,
    const char *gw_seq,
    int64_t n_lc, const int64_t *lv, const int64_t *loff,
    const int64_t *lcnt, const int64_t *lscore, const int64_t *lqs,
    const int64_t *lqe, const int64_t *lrs, const int64_t *lre,
    const uint64_t *ax, const uint64_t *ay, int64_t n_a_total,
    const char *qseq, int64_t qseq_len,
    int64_t qlen, int64_t max_dist_g, int64_t max_dist_q, int64_t bw,
    int64_t max_skip, int64_t ref_bonus, double chn_pen_gap,
    double mask_level, int64_t max_sk, uint32_t hash0,
    int64_t min_gc_cnt, int64_t min_gc_score, int64_t gdp_max_ed,
    int64_t n_seg,
    int64_t llc_cap, int64_t a_cap, int64_t gc_cap,
    int64_t *o_lv, int64_t *o_loff, int64_t *o_lcnt, int64_t *o_lsc,
    int64_t *o_led, uint64_t *o_ax, uint64_t *o_ay,
    int64_t *g_off, int64_t *g_cnt, int64_t *g_na, int64_t *g_sc,
    uint32_t *g_hash, int64_t *g_extra);

/* Returns n_gc (>= 0), or <0 for the Python fallback (-1 alloc,
 * -2 output caps, -3 bridge warning / reference assert). */
int64_t mgt_map_tail(
    /* linear-chain stage: 0 = finish from device f/p, 1 = banded DP,
     * 2 = RMQ */
    int64_t mode, const int32_t *fdp, const int32_t *pdp,
    int64_t max_dist_x, int64_t max_dist_y, int64_t bw,
    int64_t max_lc_skip, int64_t max_lc_iter, int64_t min_lc_cnt,
    int64_t min_lc_score, double chn_pen_gap, double chn_pen_skip,
    int64_t is_cdna, int64_t n_segs, int64_t max_gap_pre,
    int64_t rmq_size_cap,
    /* long-join rescue (map-algo.c:407-417) */
    int64_t do_rescue, int64_t qlen, int64_t bw_long,
    int64_t rmq_rescue_size, int64_t rescue_max_dist,
    double rmq_rescue_ratio,
    /* anchors (mutated in place) */
    int64_t n_a, uint64_t *ax, uint64_t *ay,
    /* lchain tail */
    const int64_t *mini_pos, int64_t n_mv, int64_t lc_max_occ,
    int64_t lc_max_trim, int64_t max_gap_half,
    /* graph-chain stage */
    const int64_t *gidx, const int64_t *arc_w, const int64_t *arc_lv,
    const int64_t *arc_rank, int64_t n_vtx, const int64_t *seg_len,
    int64_t *gw_arc_start, int32_t *gw_arc_cnt, uint32_t *gw_arc_w,
    int32_t *gw_arc_ow, int64_t *gw_seq_off, int32_t *gw_seq_len,
    const char *gw_seq, const char *qseq, int64_t qseq_len,
    int64_t bw_gc, int64_t max_gc_skip, int64_t ref_bonus,
    double mask_level, int64_t max_sk, uint32_t hash0,
    int64_t min_gc_cnt, int64_t min_gc_score, int64_t gdp_max_ed,
    /* out (mgt_gchain_full layout) */
    int64_t llc_cap, int64_t a_cap, int64_t gc_cap,
    int64_t *o_lv, int64_t *o_loff, int64_t *o_lcnt, int64_t *o_lsc,
    int64_t *o_led, uint64_t *o_ax, uint64_t *o_ay,
    int64_t *g_off, int64_t *g_cnt, int64_t *g_na, int64_t *g_sc,
    uint32_t *g_hash, int64_t *g_extra)
{
    uint64_t *u = 0;
    int64_t *t8 = 0;
    int64_t n_v, n_u, n_lc, ret = -1, i;
    int32_t n_u32 = 0;
    int64_t tp0 = 0, tp1;

    if (n_a == 0) return 0;
    if (mgt_tail_prof()) tp0 = mgt_now_ns();
    u = (uint64_t *)malloc(8 * (size_t)n_a);
    if (!u) return -1;
    if (mode == 3) {
        /* chains precomputed on device (ops/backtrack_jax.py):
         * ax/ay arrive compacted, fdp carries u (sc<<32|cnt),
         * max_dist_x its length */
        n_u32 = (int32_t)max_dist_x;
        if (n_u32 > 0)
            memcpy(u, fdp, 8 * (size_t)n_u32);
        n_v = n_a;
    } else if (mode == 0)
        n_v = mgt_lchain_finish((int32_t)bw, (int32_t)is_cdna,
                                (int32_t)min_lc_cnt, (int32_t)min_lc_score,
                                n_a, fdp, pdp, ax, ay, u, &n_u32);
    else if (mode == 1)
        n_v = mgt_lchain_dp((int32_t)max_dist_x, (int32_t)max_dist_y,
                            (int32_t)bw, (int32_t)max_lc_skip,
                            (int32_t)max_lc_iter, (int32_t)min_lc_cnt,
                            (int32_t)min_lc_score, (float)chn_pen_gap,
                            (float)chn_pen_skip, (int32_t)is_cdna,
                            (int32_t)n_segs, n_a, ax, ay, u, &n_u32);
    else
        n_v = mgt_lchain_rmq((int32_t)max_dist_x, (int32_t)max_gap_pre,
                             (int32_t)bw, (int32_t)max_lc_skip,
                             (int32_t)rmq_size_cap, (int32_t)min_lc_cnt,
                             (int32_t)min_lc_score, (float)chn_pen_gap,
                             (float)chn_pen_skip, n_a, ax, ay, u, &n_u32);
    n_u = n_u32;
    if (tp0) {
        tp1 = mgt_now_ns(); mgt_prof_add(0, tp1 - tp0); tp0 = tp1;
        mgt_prof_add(7, n_a);
    }
    if (n_u == 0) { ret = 0; goto done; }

    if (do_rescue && n_segs == 1 && n_u > 1) {
        /* long-join rescue: if the best chain leaves a large part of
         * the query uncovered, re-chain everything with the RMQ
         * engine at bw_long (map-algo.c:407-417) */
        int64_t st = (int32_t)(uint32_t)ay[0];
        int64_t en = (int32_t)(uint32_t)ay[(int64_t)(uint32_t)u[0] - 1];
        if (qlen - (en - st) > rmq_rescue_size
            || (double)(qlen - (en - st))
                > (double)qlen * rmq_rescue_ratio) {
            int64_t na2 = 0;
            uint64_t *z, *by;
            for (i = 0; i < n_u; ++i) na2 += (int64_t)(uint32_t)u[i];
            z = (uint64_t *)malloc(16 * (size_t)na2);
            by = (uint64_t *)malloc(8 * (size_t)na2);
            if (!z || !by) { free(z); free(by); goto done; }
            for (i = 0; i < na2; ++i)
                z[2 * i] = ax[i], z[2 * i + 1] = (uint64_t)i;
            mgt_radix_sort_128x(z, na2);   /* reference-exact ties */
            for (i = 0; i < na2; ++i) by[i] = ay[(int64_t)z[2 * i + 1]];
            for (i = 0; i < na2; ++i) ax[i] = z[2 * i];
            memcpy(ay, by, 8 * (size_t)na2);
            free(z); free(by);
            n_v = mgt_lchain_rmq((int32_t)rescue_max_dist,
                                 (int32_t)max_gap_pre, (int32_t)bw_long,
                                 (int32_t)max_lc_skip,
                                 (int32_t)rmq_size_cap,
                                 (int32_t)min_lc_cnt,
                                 (int32_t)min_lc_score,
                                 (float)chn_pen_gap, (float)chn_pen_skip,
                                 na2, ax, ay, u, &n_u32);
            n_u = n_u32;
            if (tp0) {
                extern int64_t mgt_lchain_stats[4];
                mgt_prof_add(4, 1);
                mgt_prof_add(5, na2);
                mgt_prof_add(6, mgt_lchain_stats[0]);
            }
            if (n_u == 0) { ret = 0; goto done; }
        }
    }
    if (tp0) { tp1 = mgt_now_ns(); mgt_prof_add(1, tp1 - tp0); tp0 = tp1; }

    t8 = (int64_t *)malloc(8 * 8 * (size_t)n_u);
    if (!t8) goto done;
    n_lc = mgt_lchain_tail(qlen, n_u, u, ax, ay, mini_pos, n_mv,
                           lc_max_occ, lc_max_trim, bw, max_gap_half,
                           min_lc_cnt, t8, t8 + n_u, t8 + 2 * n_u,
                           t8 + 3 * n_u, t8 + 4 * n_u, t8 + 5 * n_u,
                           t8 + 6 * n_u, t8 + 7 * n_u);
    if (tp0) { tp1 = mgt_now_ns(); mgt_prof_add(2, tp1 - tp0); tp0 = tp1; }
    if (n_lc < 0) goto done;
    if (n_lc == 0) { ret = 0; goto done; }

    ret = mgt_gchain_full(gidx, arc_w, arc_lv, arc_rank, n_vtx, seg_len,
                          gw_arc_start, gw_arc_cnt, gw_arc_w, gw_arc_ow,
                          gw_seq_off, gw_seq_len, gw_seq,
                          n_lc, t8 + 2 * n_u, t8, t8 + n_u, t8 + 7 * n_u,
                          t8 + 5 * n_u, t8 + 6 * n_u, t8 + 3 * n_u,
                          t8 + 4 * n_u,
                          ax, ay, n_v, qseq, qseq_len,
                          qlen, bw_gc, bw_gc, bw_gc, max_gc_skip,
                          ref_bonus, chn_pen_gap, mask_level, max_sk,
                          hash0, min_gc_cnt, min_gc_score, gdp_max_ed,
                          n_segs, llc_cap, a_cap, gc_cap,
                          o_lv, o_loff, o_lcnt, o_lsc, o_led, o_ax, o_ay,
                          g_off, g_cnt, g_na, g_sc, g_hash, g_extra);
    if (tp0) mgt_prof_add(3, mgt_now_ns() - tp0);
done:
    free(u); free(t8);
    return ret;
}
