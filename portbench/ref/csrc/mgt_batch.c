/* Batched per-read mapping tails: the kt_for worker loop (kthread.c:
 * 30-52) applied to the whole native tail.  One call maps a batch of
 * device-front reads anchors -> GAF bytes: for each read it composes
 * mgt_map_tail (linear+graph chaining), mgt_select_chains (gcmisc.c
 * selection) and mgt_format_gaf (format.c serialization), with a
 * work-stealing pthread pool so multi-core hosts scale without the
 * Python interpreter in the loop.  Reads whose engines bail get
 * status=1 and are re-run by the caller on the exact Python-driven
 * path (anchor planes are copied before mutation, so the retry sees
 * pristine input).
 */
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

extern void mgt_shortk_tls_free(void);
extern void mgt_lchain_tls_free(void);
extern void mgt_cigar_tls_free(void);
extern void mgt_collect_tls_free(void);

extern int64_t mgt_collect_frag(
    const uint8_t *seq_blob, const int64_t *seg_off, int64_t n_segs,
    int64_t w, int64_t k, int64_t max_occ, int64_t use_heap,
    const uint64_t *keys, const int64_t *key_start,
    const int64_t *key_cnt, int64_t n_keys, const uint64_t *pos,
    const int64_t *seg_len,
    const uint64_t *htab, int64_t n_slots,
    uint64_t *mv, int64_t mv_cap,
    uint64_t *ax, uint64_t *ay, int64_t a_cap,
    int64_t *mini_pos, int64_t mp_cap,
    int64_t *out_meta);

extern int64_t mgt_gchain_cigar(
    const uint64_t *ax, const uint64_t *ay, int64_t off_a0,
    int64_t n_anchor, const int64_t *lc_v, const int64_t *lc_off,
    const int64_t *lc_cnt, int64_t gc_off, int64_t gc_cnt,
    const char **seqp, const int64_t *seg_len, const char *q,
    uint32_t *cig_out, int64_t cig_cap, int64_t *stats_out);

extern int64_t mgt_gen_ds(
    const uint32_t *cigar, int64_t n_cigar, const uint8_t *tseq,
    int64_t aplen, const uint8_t *qseq, int64_t qs, int64_t qe,
    char *ds_out, int64_t ds_cap, int64_t *off_out, int64_t off_cap,
    int64_t *n_off_out);

extern int64_t mgt_map_tail(
    int64_t mode, const int32_t *fdp, const int32_t *pdp,
    int64_t max_dist_x, int64_t max_dist_y, int64_t bw,
    int64_t max_lc_skip, int64_t max_lc_iter, int64_t min_lc_cnt,
    int64_t min_lc_score, double chn_pen_gap, double chn_pen_skip,
    int64_t is_cdna, int64_t n_segs, int64_t max_gap_pre,
    int64_t rmq_size_cap,
    int64_t do_rescue, int64_t qlen, int64_t bw_long,
    int64_t rmq_rescue_size, int64_t rescue_max_dist,
    double rmq_rescue_ratio,
    int64_t n_a, uint64_t *ax, uint64_t *ay,
    const int64_t *mini_pos, int64_t n_mv, int64_t lc_max_occ,
    int64_t lc_max_trim, int64_t max_gap_half,
    const int64_t *gidx, const int64_t *arc_w, const int64_t *arc_lv,
    const int64_t *arc_rank, int64_t n_vtx, const int64_t *seg_len,
    int64_t *gw_arc_start, int32_t *gw_arc_cnt, uint32_t *gw_arc_w,
    int32_t *gw_arc_ow, int64_t *gw_seq_off, int32_t *gw_seq_len,
    const char *gw_seq, const char *qseq, int64_t qseq_len,
    int64_t bw_gc, int64_t max_gc_skip, int64_t ref_bonus,
    double mask_level, int64_t max_sk, uint32_t hash0,
    int64_t min_gc_cnt, int64_t min_gc_score, int64_t gdp_max_ed,
    int64_t llc_cap, int64_t a_cap, int64_t gc_cap,
    int64_t *o_lv, int64_t *o_loff, int64_t *o_lcnt, int64_t *o_lsc,
    int64_t *o_led, uint64_t *o_ax, uint64_t *o_ay,
    int64_t *g_off, int64_t *g_cnt, int64_t *g_na, int64_t *g_sc,
    uint32_t *g_hash, int64_t *g_extra);

extern int64_t mgt_select_chains(
    double mask_level, double pri_ratio, int64_t min_diff,
    int64_t best_n, int64_t qlen, int64_t max_mini,
    int64_t min_gc_score, int64_t rep_len, int64_t n_gc,
    int64_t *g_off, int64_t *g_cnt, int64_t *g_na, int64_t *g_sc,
    uint32_t *g_hash, int64_t *g_extra,
    int64_t *o_lv, int64_t *o_loff, int64_t *o_lcnt, int64_t *o_lsc,
    int64_t *o_led, uint64_t *o_ax, uint64_t *o_ay,
    int64_t *out_parent, int64_t *out_mapq, int64_t *out_nsub,
    int64_t *out_subsc);

extern int64_t mgt_format_gaf(
    const char *seg_nm, const int64_t *seg_nm_off,
    const int64_t *seg_len, const int64_t *seg_snid,
    const int64_t *seg_soff,
    const char *ss_nm, const int64_t *ss_nm_off,
    const int64_t *ss_min, const int64_t *ss_max, const int64_t *ss_rank,
    const char *qname, int64_t qname_len, int64_t qlen,
    int64_t n_gc,
    const int64_t *lv, const int64_t *loff, const int64_t *lcnt,
    const uint64_t *o_ay,
    const int64_t *g_off, const int64_t *g_cnt, const int64_t *g_na,
    const int64_t *g_sc, const int64_t *g_extra,
    const int64_t *sel_parent, const int64_t *sel_mapq,
    const int64_t *sel_subsc,
    int64_t print_2nd, int64_t no_comp_path, int64_t show_unmap,
    int64_t n_seg, int64_t frag_merge, const int64_t *qlens,
    const uint32_t *const *cig_p, const int64_t *cig_n,
    const int64_t *cig_stats,
    const char *const *ds_p, const int64_t *ds_n,
    const int64_t *const *ds_off_p, const int64_t *ds_noff,
    char *buf, int64_t cap);

/* khashl.h integer/string hashes (definitional formulas) */
static inline uint32_t bh_hash32(uint32_t key)
{
    key += ~(key << 15);
    key ^= key >> 10;
    key += key << 3;
    key ^= key >> 6;
    key += ~(key << 11);
    key ^= key >> 16;
    return key;
}

static inline uint32_t bh_hash_str(const char *s, int64_t n)
{
    uint32_t h = 0;
    int64_t i;
    if (n > 0) {
        h = (uint8_t)s[0];
        for (i = 1; i < n; ++i)
            h = (h << 5) - h + (uint8_t)s[i];
    }
    return h;
}

/* P layout (int64 scalars, shared by every read in the batch) */
enum {
    P_BW, P_MAX_LC_SKIP, P_MAX_LC_ITER, P_MIN_LC_CNT, P_MIN_LC_SCORE,
    P_IS_CDNA, P_MAX_GAP_PRE, P_RMQ_SIZE_CAP, P_DO_RESCUE, P_BW_LONG,
    P_RMQ_RESCUE_SIZE, P_RESCUE_MAX_DIST, P_LC_MAX_OCC,
    P_LC_MAX_TRIM, P_MAX_GAP_HALF, P_MAX_GC_SKIP, P_REF_BONUS,
    P_MAX_SK, P_MIN_GC_CNT, P_MIN_GC_SCORE, P_GDP_MAX_ED, P_SEED,
    P_SEL_MIN_DIFF, P_SEL_BEST_N, P_GAF_FLAGS, P_N
};
/* PD layout (double scalars) */
enum { D_PEN_GAP, D_PEN_SKIP, D_RESCUE_RATIO, D_MASK_LEVEL,
       D_PRI_RATIO, D_N };

typedef struct {
    /* shared inputs */
    int64_t n_reads;
    const int64_t *P;
    const double *PD;
    const int64_t *mode, *n_a, *n_mv, *n_minis, *qlen, *rep_len,
        *mdx, *mdy;
    const uint64_t *axp, *ayp, *fpp, *ppp, *mpp;  /* per-read addrs */
    /* host-collect mode: anchors built in the worker from the read
     * itself (qseq blob) via mgt_collect; per-read anchor inputs are
     * ignored */
    int64_t do_collect, idx_w, idx_k, max_occ, n_keys;
    const uint64_t *keys;
    const int64_t *key_start, *key_cnt;
    const uint64_t *pos;
    const uint64_t *htab;              /* collect probe table */
    int64_t n_slots;
    int64_t use_heap;                  /* short-read heap collection */
    const int64_t *n_segs;             /* per-read segment count (or 0) */
    const int64_t *seg_mid;            /* 2-seg frag boundary offset */
    /* -c mode: per-chain CIGAR + ds generated in the worker;
     * seg_seqp[2s]/[2s+1] = fwd/rc byte strings of segment s */
    int64_t do_cigar;
    const char **seg_seqp;
    const char *qseq_blob;
    const int64_t *qseq_off;
    const char *qname_blob;
    const int64_t *qname_off;
    const int64_t *qname_len;          /* per-item override (frag blob
                                        * batches: the arena name span
                                        * covers every mate; the item
                                        * name is the first mate's) */
    /* graph ctx */
    const int64_t *gidx, *arc_w, *arc_lv, *arc_rank;
    int64_t n_vtx;
    const int64_t *gseg_len;
    int64_t *gw_arc_start;
    int32_t *gw_arc_cnt;
    uint32_t *gw_arc_w;
    int32_t *gw_arc_ow;
    int64_t *gw_seq_off;
    int32_t *gw_seq_len;
    const char *gw_seq;
    /* gaf name ctx */
    const char *seg_nm;
    const int64_t *seg_nm_off, *seg_snid, *seg_soff;
    const char *ss_nm;
    const int64_t *ss_nm_off, *ss_min, *ss_max, *ss_rank;
    /* outputs */
    int64_t *r_tid, *r_off, *r_len, *status;
    /* per-thread result buffers */
    char **tbuf;
    int64_t *tlen;
    /* work-stealing cursor */
    int64_t next;
} batch_t;

typedef struct {
    batch_t *b;
    int tid;
} warg_t;

typedef struct {
    uint64_t *ax, *ay;          /* anchor copies */
    int64_t a_sz;
    uint64_t *mv;               /* collect-mode sketch records */
    int64_t mv_sz;
    int64_t *mp;                /* collect-mode minimizer positions */
    int64_t mp_sz;
    uint32_t *cgb;              /* -c: all chains' CIGAR words */
    int64_t cgb_sz;
    char *dsb;                  /* -c: all chains' ds streams */
    int64_t dsb_sz;
    int64_t *dob;               /* -c: ds token offsets */
    int64_t dob_sz;
    char *tsq;                  /* -c: one chain's path target seq */
    int64_t tsq_sz;
    void *ctab;                 /* -c: per-chain ptr/stat table */
    int64_t ctab_sz;            /* capacity in chains */
    int64_t *tab;               /* o_lv..o_led | g_off..g_sc | extra.. */
    uint64_t *o_ax, *o_ay;
    uint32_t *g_hash;
    int64_t llc_cap, a_cap, gc_cap;
    char *gb;                   /* gaf grow buffer */
    int64_t gb_cap, gb_len;
} tscratch_t;

static int ts_reserve(tscratch_t *t, int64_t n_a)
{
    int64_t llc_cap = n_a + 1024;
    int64_t a_cap = n_a > 64 ? n_a : 64;
    int64_t gc_cap = a_cap;
    if (n_a > t->a_sz) {
        free(t->ax); free(t->ay);
        t->a_sz = n_a + (n_a >> 1);
        t->ax = (uint64_t *)malloc(8 * (size_t)t->a_sz);
        t->ay = (uint64_t *)malloc(8 * (size_t)t->a_sz);
        if (!t->ax || !t->ay) { t->a_sz = 0; return -1; }
    }
    if (llc_cap > t->llc_cap || gc_cap > t->gc_cap || a_cap > t->a_cap) {
        free(t->tab); free(t->o_ax); free(t->o_ay); free(t->g_hash);
        t->llc_cap = llc_cap + (llc_cap >> 1);
        t->a_cap = a_cap + (a_cap >> 1);
        t->gc_cap = gc_cap + (gc_cap >> 1);
        t->tab = (int64_t *)malloc(
            8 * (size_t)(5 * t->llc_cap + (4 + 8 + 4) * t->gc_cap));
        t->o_ax = (uint64_t *)malloc(8 * (size_t)t->a_cap);
        t->o_ay = (uint64_t *)malloc(8 * (size_t)t->a_cap);
        t->g_hash = (uint32_t *)malloc(4 * (size_t)t->gc_cap);
        if (!t->tab || !t->o_ax || !t->o_ay || !t->g_hash) {
            t->llc_cap = t->a_cap = t->gc_cap = 0;
            return -1;
        }
    }
    return 0;
}

/* Carve the per-chain cigar/ds pointer+stat table out of ts->ctab.
 * Layout per capacity chain: ptr + i64 + 4*i64 + ptr + i64 + ptr +
 * i64 = 80 bytes. */
#define CTAB_CARVE(t)                                                  \
    const uint32_t **cg_p = (const uint32_t **)(t)->ctab;              \
    int64_t *cg_n = (int64_t *)(cg_p + (t)->ctab_sz);                  \
    int64_t *cg_st = cg_n + (t)->ctab_sz;                              \
    const char **dsp = (const char **)(cg_st + 4 * (t)->ctab_sz);      \
    int64_t *dsn = (int64_t *)(dsp + (t)->ctab_sz);                    \
    const int64_t **dop = (const int64_t **)(dsn + (t)->ctab_sz);     \
    int64_t *don = (int64_t *)(dop + (t)->ctab_sz)

static int64_t grow8(void **p, int64_t *sz, int64_t need, int64_t esz)
{
    if (need <= *sz) return 0;
    int64_t want = need + (need >> 1) + 64;
    void *np = realloc(*p, (size_t)(want * esz));
    if (!np) return -1;
    *p = np;
    *sz = want;
    return 0;
}

/* Base-level stage for one read (-c): per selected chain, run the
 * anchor-walk + per-gap WFA CIGAR (mgt_gchain_cigar), extract the
 * path target sequence, and derive the ds difference string
 * (mg_gchain_cigar + mg_gchain_gen_ds, galign.c:39-293).  Fills the
 * ctab pointer table consumed by mgt_format_gaf.  Returns 0, or -1
 * to bail the whole read to the exact per-read path. */
static int cigar_stage(batch_t *b, tscratch_t *ts, int64_t i,
                       int64_t n2, const int64_t *o_lv,
                       const int64_t *o_loff, const int64_t *o_lcnt,
                       const int64_t *g_off, const int64_t *g_cnt,
                       const int64_t *g_na, const int64_t *g_extra,
                       const int64_t *sel_parent, int64_t print_2nd)
{
    const char *q = b->qseq_blob + b->qseq_off[i];
    int64_t c, cg_need = 0, ds_need = 0, do_need = 0, ts_need = 0;

    if (n2 > ts->ctab_sz) {
        int64_t want = n2 + (n2 >> 1) + 8;
        void *np = realloc(ts->ctab, (size_t)(want * 80));
        if (!np) return -1;
        ts->ctab = np;
        ts->ctab_sz = want;
    }
    CTAB_CARVE(ts);
    /* pass 1: per-chain capacity budgets (align/cigar.py:100,264) */
    for (c = 0; c < n2; ++c) {
        const int64_t *ex = g_extra + 8 * c;
        int64_t budget, span;
        cg_p[c] = 0;
        dsp[c] = 0;
        if ((c != sel_parent[c] && !print_2nd) || g_cnt[c] == 0)
            continue;
        budget = (ex[3] - ex[2]) + (ex[1] - ex[0])
            + 4 * g_na[c] + 64;
        span = (ex[3] - ex[2]) + (ex[1] - ex[0]);
        cg_n[c] = budget;              /* budget for now */
        cg_need += budget;
        ds_need += 4 * span + 16 * budget + 64;
        do_need += 2 * span + budget + 8;
        if (ex[3] - ex[2] > ts_need) ts_need = ex[3] - ex[2];
    }
    if (grow8((void **)&ts->cgb, &ts->cgb_sz, cg_need, 4) < 0 ||
        grow8((void **)&ts->dsb, &ts->dsb_sz, ds_need, 1) < 0 ||
        grow8((void **)&ts->dob, &ts->dob_sz, do_need, 8) < 0 ||
        grow8((void **)&ts->tsq, &ts->tsq_sz, ts_need, 1) < 0)
        return -1;
    /* pass 2: cigar + tseq + ds per chain (arenas fixed; pointers
     * into them are stable) */
    int64_t cg_used = 0, ds_used = 0, do_used = 0;
    for (c = 0; c < n2; ++c) {
        const int64_t *ex = g_extra + 8 * c;
        int64_t budget, off_a0, na, n, st4[4], aplen, j, tl;
        int64_t nds, noff, span;
        if ((c != sel_parent[c] && !print_2nd) || g_cnt[c] == 0)
            continue;
        budget = cg_n[c];
        off_a0 = o_loff[g_off[c]];
        na = g_na[c];
        n = mgt_gchain_cigar(ts->o_ax, ts->o_ay, off_a0, na,
                             o_lv, o_loff, o_lcnt, g_off[c], g_cnt[c],
                             b->seg_seqp, b->gseg_len, q,
                             ts->cgb + cg_used, budget, st4);
        if (n < 0) return -1;
        aplen = st4[2];
        if (st4[3] != ex[1] - ex[0] || aplen != ex[3] - ex[2])
            return -1;
        cg_p[c] = ts->cgb + cg_used;
        cg_n[c] = n;
        cg_st[4 * c] = st4[0];
        cg_st[4 * c + 1] = st4[1];
        cg_st[4 * c + 2] = st4[2];
        cg_st[4 * c + 3] = st4[3];
        cg_used += budget;
        /* path target sequence over the chain's vertex run
         * (gchain_gen_ds, align/cigar.py:292-300) */
        {
            int64_t span0 = (int64_t)((ts->o_ay[off_a0] >> 32) & 0xFF);
            int64_t ss = (int32_t)ts->o_ax[off_a0] + 1 - span0;
            int64_t ee = (int32_t)ts->o_ax[off_a0 + na - 1] + 1;
            tl = 0;
            for (j = 0; j < g_cnt[c]; ++j) {
                int64_t v = o_lv[g_off[c] + j];
                int64_t st = j > 0 ? 0 : ss;
                int64_t en = j < g_cnt[c] - 1
                    ? b->gseg_len[v >> 1] : ee;
                if (en - st < 0 || tl + (en - st) > ts->tsq_sz)
                    return -1;
                memcpy(ts->tsq + tl, b->seg_seqp[v] + st,
                       (size_t)(en - st));
                tl += en - st;
            }
            if (tl != aplen) return -1;
        }
        span = aplen + (ex[1] - ex[0]);
        nds = mgt_gen_ds(cg_p[c], n, (const uint8_t *)ts->tsq, aplen,
                         (const uint8_t *)q, ex[0], ex[1],
                         ts->dsb + ds_used, 4 * span + 16 * budget + 64,
                         ts->dob + do_used, 2 * span + budget + 8,
                         &noff);
        if (nds < 0) return -1;
        dsp[c] = ts->dsb + ds_used;
        dsn[c] = nds;
        dop[c] = ts->dob + do_used;
        don[c] = noff;
        ds_used += 4 * span + 16 * budget + 64;
        do_used += 2 * span + budget + 8;
    }
    return 0;
}

/* Env-gated batch-stage profiling (MGT_PROF=1), beside the tail
 * profiler: 0 collect, 1 map_tail, 2 select, 3 cigar, 4 format. */
static int64_t bprof_ns[8];
extern int mgt_tail_prof_on(void);
static inline int64_t bprof_now(void)
{
    struct timespec ts;
    if (!mgt_tail_prof_on()) return 0;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}
static inline void bprof_add(int k, int64_t ns)
{
    __atomic_fetch_add(&bprof_ns[k], ns, __ATOMIC_RELAXED);
}
void mgt_batch_prof_dump(int64_t *out8)
{
    int k;
    for (k = 0; k < 8; ++k) {
        out8[k] = __atomic_load_n(&bprof_ns[k], __ATOMIC_RELAXED);
        __atomic_store_n(&bprof_ns[k], (int64_t)0, __ATOMIC_RELAXED);
    }
}

static void *worker(void *vp)
{
    warg_t *w = (warg_t *)vp;
    batch_t *b = w->b;
    const int64_t *P = b->P;
    const double *PD = b->PD;
    tscratch_t ts;
    memset(&ts, 0, sizeof(ts));
    for (;;) {
        int64_t i = __atomic_fetch_add(&b->next, 1, __ATOMIC_RELAXED);
        if (i >= b->n_reads) break;
        int64_t n_a, n_mv_i, n_mini_i, rep_len_i;
        const int64_t *mini_pos_i;
        b->status[i] = 1;             /* assume fallback until done */
        b->r_tid[i] = w->tid;
        b->r_off[i] = ts.gb_len;
        b->r_len[i] = 0;
        if (b->mode[i] < 0) continue; /* caller-marked: per-read path */
        int64_t tp0 = bprof_now(), tp1;
        /* hybrid batches (device front over reader arenas): reads
         * with device anchors carry axp != 0 and skip the collect */
        if (b->do_collect && !b->axp[i]) {
            /* sketch + probe + anchors inside the worker */
            int64_t sql = b->qseq_off[i + 1] - b->qseq_off[i];
            int64_t meta[4], r2;
            int64_t nsg = b->n_segs ? b->n_segs[i] : 1;
            int64_t soff[3];
            soff[0] = b->qseq_off[i];
            soff[1] = nsg == 2 ? b->seg_mid[i] : b->qseq_off[i + 1];
            soff[2] = b->qseq_off[i + 1];
            if (ts.mv_sz < sql + 128) {
                free(ts.mv); free(ts.mp);
                ts.mv_sz = sql + (sql >> 1) + 256;
                ts.mv = (uint64_t *)malloc(16 * (size_t)ts.mv_sz);
                ts.mp = (int64_t *)malloc(8 * (size_t)ts.mv_sz);
                ts.mp_sz = ts.mv_sz;
                if (!ts.mv || !ts.mp) { ts.mv_sz = ts.mp_sz = 0;
                                        continue; }
            }
            for (;;) {
                r2 = mgt_collect_frag((const uint8_t *)b->qseq_blob,
                                 soff, nsg, b->idx_w,
                                 b->idx_k, b->max_occ, b->use_heap,
                                 b->keys,
                                 b->key_start, b->key_cnt, b->n_keys,
                                 b->pos, b->gseg_len,
                                 b->htab, b->n_slots,
                                 ts.mv, ts.mv_sz,
                                 ts.ax, ts.ay, ts.a_sz,
                                 ts.mp, ts.mp_sz, meta);
                if (r2 == 0) break;
                if (r2 != -1) break;
                if (ts_reserve(&ts, meta[0] + 64) < 0) break;
                if (meta[1] + 64 > ts.mv_sz) {
                    free(ts.mv); free(ts.mp);
                    ts.mv_sz = ts.mp_sz = meta[1] * 2 + 128;
                    ts.mv = (uint64_t *)malloc(16 * (size_t)ts.mv_sz);
                    ts.mp = (int64_t *)malloc(8 * (size_t)ts.mp_sz);
                    if (!ts.mv || !ts.mp) { ts.mv_sz = ts.mp_sz = 0;
                                            r2 = -2; break; }
                }
            }
            if (r2 != 0) continue;
            n_a = meta[0], n_mv_i = meta[1], rep_len_i = meta[2];
            n_mini_i = meta[3];
            mini_pos_i = ts.mp;
            if (ts_reserve(&ts, n_a) < 0) continue;
        } else {
            n_a = b->n_a[i];
            n_mv_i = b->n_mv[i];
            n_mini_i = b->n_minis[i];
            rep_len_i = b->rep_len[i];
            mini_pos_i = (const int64_t *)(uintptr_t)b->mpp[i];
            if (ts_reserve(&ts, n_a) < 0) continue;
            memcpy(ts.ax, (const void *)(uintptr_t)b->axp[i],
                   8 * (size_t)n_a);
            memcpy(ts.ay, (const void *)(uintptr_t)b->ayp[i],
                   8 * (size_t)n_a);
        }
        int64_t *o_lv = ts.tab, *o_loff = o_lv + ts.llc_cap;
        int64_t *o_lcnt = o_loff + ts.llc_cap, *o_lsc = o_lcnt + ts.llc_cap;
        int64_t *o_led = o_lsc + ts.llc_cap;
        int64_t *g_off = o_led + ts.llc_cap, *g_cnt = g_off + ts.gc_cap;
        int64_t *g_na = g_cnt + ts.gc_cap, *g_sc = g_na + ts.gc_cap;
        int64_t *g_extra = g_sc + ts.gc_cap;
        int64_t *sel = g_extra + 8 * ts.gc_cap;   /* 4 rows */
        const char *qs = b->qseq_blob + b->qseq_off[i];
        int64_t qs_len = b->qseq_off[i + 1] - b->qseq_off[i];
        const char *qn = b->qname_blob + b->qname_off[i];
        int64_t qn_len = b->qname_len ? b->qname_len[i]
                         : b->qname_off[i + 1] - b->qname_off[i];
        uint32_t hash0 = bh_hash_str(qn, qn_len);
        hash0 ^= bh_hash32((uint32_t)b->qlen[i])
               + bh_hash32((uint32_t)P[P_SEED]);
        hash0 = bh_hash32(hash0);
        if (tp0) { tp1 = bprof_now(); bprof_add(0, tp1 - tp0); tp0 = tp1; }
        int64_t n_gc = mgt_map_tail(
            b->mode[i],
            (const int32_t *)(uintptr_t)b->fpp[i],
            (const int32_t *)(uintptr_t)b->ppp[i],
            b->mdx[i], b->mdy[i], P[P_BW], P[P_MAX_LC_SKIP],
            P[P_MAX_LC_ITER], P[P_MIN_LC_CNT], P[P_MIN_LC_SCORE],
            PD[D_PEN_GAP], PD[D_PEN_SKIP],
            P[P_IS_CDNA], b->n_segs ? b->n_segs[i] : 1,
            P[P_MAX_GAP_PRE], P[P_RMQ_SIZE_CAP],
            P[P_DO_RESCUE], b->qlen[i], P[P_BW_LONG],
            P[P_RMQ_RESCUE_SIZE], P[P_RESCUE_MAX_DIST],
            PD[D_RESCUE_RATIO],
            n_a, ts.ax, ts.ay,
            mini_pos_i, n_mini_i,
            P[P_LC_MAX_OCC], P[P_LC_MAX_TRIM], P[P_MAX_GAP_HALF],
            b->gidx, b->arc_w, b->arc_lv, b->arc_rank, b->n_vtx,
            b->gseg_len, b->gw_arc_start, b->gw_arc_cnt, b->gw_arc_w,
            b->gw_arc_ow, b->gw_seq_off, b->gw_seq_len, b->gw_seq,
            qs, qs_len,
            P[P_BW_LONG], P[P_MAX_GC_SKIP], P[P_REF_BONUS],
            PD[D_MASK_LEVEL], P[P_MAX_SK], hash0,
            P[P_MIN_GC_CNT], P[P_MIN_GC_SCORE], P[P_GDP_MAX_ED],
            ts.llc_cap, ts.a_cap, ts.gc_cap,
            o_lv, o_loff, o_lcnt, o_lsc, o_led, ts.o_ax, ts.o_ay,
            g_off, g_cnt, g_na, g_sc, ts.g_hash, g_extra);
        if (tp0) { tp1 = bprof_now(); bprof_add(1, tp1 - tp0); tp0 = tp1; }
        if (n_gc < 0) continue;
        int64_t n2 = 0;
        if (n_gc > 0) {
            n2 = mgt_select_chains(
                PD[D_MASK_LEVEL], PD[D_PRI_RATIO], P[P_SEL_MIN_DIFF],
                P[P_SEL_BEST_N], b->qlen[i], n_mv_i,
                P[P_MIN_GC_SCORE], rep_len_i, n_gc,
                g_off, g_cnt, g_na, g_sc, ts.g_hash, g_extra,
                o_lv, o_loff, o_lcnt, o_lsc, o_led, ts.o_ax, ts.o_ay,
                sel, sel + ts.gc_cap, sel + 2 * ts.gc_cap,
                sel + 3 * ts.gc_cap);
            if (n2 < 0) continue;
        }
        if (tp0) { tp1 = bprof_now(); bprof_add(2, tp1 - tp0); tp0 = tp1; }
        const uint32_t *const *f_cgp = 0;
        const int64_t *f_cgn = 0, *f_cgst = 0;
        const char *const *f_dsp = 0;
        const int64_t *f_dsn = 0, *f_don = 0;
        const int64_t *const *f_dop = 0;
        if (b->do_cigar && n2 > 0) {
            if (cigar_stage(b, &ts, i, n2, o_lv, o_loff, o_lcnt,
                            g_off, g_cnt, g_na, g_extra, sel,
                            P[P_GAF_FLAGS] & 1) < 0)
                continue;              /* bail to exact per-read path */
            CTAB_CARVE(&ts);
            f_cgp = cg_p; f_cgn = cg_n; f_cgst = cg_st;
            f_dsp = dsp; f_dsn = dsn; f_dop = dop; f_don = don;
        }
        if (tp0) { tp1 = bprof_now(); bprof_add(3, tp1 - tp0); tp0 = tp1; }
        for (;;) {
            int64_t flags = P[P_GAF_FLAGS];
            int64_t nsg_i = b->n_segs ? b->n_segs[i] : 1;
            int64_t ql2[2];
            ql2[0] = nsg_i == 2 ? b->seg_mid[i] - b->qseq_off[i]
                                : b->qlen[i];
            ql2[1] = nsg_i == 2 ? b->qseq_off[i + 1] - b->seg_mid[i]
                                : 0;
            int64_t n = mgt_format_gaf(
                b->seg_nm, b->seg_nm_off, b->gseg_len, b->seg_snid,
                b->seg_soff, b->ss_nm, b->ss_nm_off, b->ss_min,
                b->ss_max, b->ss_rank,
                qn, qn_len, b->qlen[i], n2,
                o_lv, o_loff, o_lcnt, ts.o_ay,
                g_off, g_cnt, g_na, g_sc, g_extra,
                sel, sel + ts.gc_cap, sel + 3 * ts.gc_cap,
                flags & 1, (flags >> 1) & 1, (flags >> 2) & 1,
                nsg_i, (flags >> 3) & 1, ql2,
                f_cgp, f_cgn, f_cgst, f_dsp, f_dsn, f_dop, f_don,
                ts.gb + ts.gb_len, ts.gb_cap - ts.gb_len);
            if (n >= 0) {
                b->r_len[i] = n;
                ts.gb_len += n;
                b->status[i] = 0;
                if (tp0) bprof_add(4, bprof_now() - tp0);
                break;
            }
            int64_t want = ts.gb_cap ? ts.gb_cap * 2 : (1 << 20);
            char *nb = (char *)realloc(ts.gb, (size_t)want);
            if (!nb) break;
            ts.gb = nb;
            ts.gb_cap = want;
        }
    }
    b->tbuf[w->tid] = ts.gb;
    b->tlen[w->tid] = ts.gb_len;
    free(ts.ax); free(ts.ay); free(ts.tab);
    free(ts.o_ax); free(ts.o_ay); free(ts.g_hash);
    free(ts.mv); free(ts.mp);
    free(ts.cgb); free(ts.dsb); free(ts.dob); free(ts.tsq);
    free(ts.ctab);
    /* the pool spawns fresh threads per batch: release the engines'
     * thread-local scratch or it leaks at every pthread exit */
    mgt_shortk_tls_free();
    mgt_cigar_tls_free();
    mgt_collect_tls_free();
    mgt_lchain_tls_free();
    return 0;
}

void mgt_buf_free(void *p) { free(p); }

/* Returns total GAF bytes (>= 0) and sets *out_buf (caller frees via
 * mgt_buf_free), or -1 on allocation failure (caller falls back to
 * the per-read path).  status[i]: 0 = GAF at out[o_off[i]:+o_len[i]],
 * 1 = engines bailed, re-run read i on the exact per-read path. */
int64_t mgt_map_tail_batch(
    int64_t n_reads, int64_t n_threads,
    const int64_t *P, const double *PD,
    const int64_t *mode, const int64_t *n_a,
    const uint64_t *axp, const uint64_t *ayp,
    const uint64_t *fpp, const uint64_t *ppp,
    const int64_t *n_mv, const int64_t *n_mini_arr,
    const uint64_t *mpp,
    const int64_t *qlen, const int64_t *rep_len,
    const int64_t *mdx, const int64_t *mdy,
    /* host-collect mode (anchors built in the workers); pass
     * do_collect=0 and NULL tables when anchors come precomputed */
    int64_t do_collect, int64_t idx_w, int64_t idx_k, int64_t max_occ,
    const uint64_t *keys, const int64_t *key_start,
    const int64_t *key_cnt, int64_t n_keys, const uint64_t *pos,
    const uint64_t *htab, int64_t n_slots,
    /* fragment support: per-read segment counts (NULL = all single),
     * 2-seg boundary offsets, and the heap-merge collection switch */
    int64_t use_heap, const int64_t *n_segs_arr, const int64_t *seg_mid,
    /* -c mode: non-zero do_cigar + fwd/rc segment byte strings */
    int64_t do_cigar, const char **seg_seqp,
    const char *qseq_blob, const int64_t *qseq_off,
    const char *qname_blob, const int64_t *qname_off,
    const int64_t *qname_len,
    const int64_t *gidx, const int64_t *arc_w, const int64_t *arc_lv,
    const int64_t *arc_rank, int64_t n_vtx, const int64_t *gseg_len,
    int64_t *gw_arc_start, int32_t *gw_arc_cnt, uint32_t *gw_arc_w,
    int32_t *gw_arc_ow, int64_t *gw_seq_off, int32_t *gw_seq_len,
    const char *gw_seq,
    const char *seg_nm, const int64_t *seg_nm_off,
    const int64_t *seg_snid, const int64_t *seg_soff,
    const char *ss_nm, const int64_t *ss_nm_off,
    const int64_t *ss_min, const int64_t *ss_max, const int64_t *ss_rank,
    char **out_buf, int64_t *o_off, int64_t *o_len, int64_t *status)
{
    batch_t b;
    memset(&b, 0, sizeof(b));
    b.n_reads = n_reads;
    b.P = P; b.PD = PD;
    b.mode = mode; b.n_a = n_a; b.n_mv = n_mv;
    b.n_minis = n_mini_arr;
    b.qlen = qlen; b.rep_len = rep_len; b.mdx = mdx; b.mdy = mdy;
    b.axp = axp; b.ayp = ayp; b.fpp = fpp; b.ppp = ppp; b.mpp = mpp;
    b.do_collect = do_collect; b.idx_w = idx_w; b.idx_k = idx_k;
    b.max_occ = max_occ; b.n_keys = n_keys;
    b.keys = keys; b.key_start = key_start; b.key_cnt = key_cnt;
    b.pos = pos;
    b.htab = htab; b.n_slots = n_slots;
    b.use_heap = use_heap; b.n_segs = n_segs_arr; b.seg_mid = seg_mid;
    b.do_cigar = do_cigar; b.seg_seqp = seg_seqp;
    b.qseq_blob = qseq_blob; b.qseq_off = qseq_off;
    b.qname_blob = qname_blob; b.qname_off = qname_off;
    b.qname_len = qname_len;
    b.gidx = gidx; b.arc_w = arc_w; b.arc_lv = arc_lv;
    b.arc_rank = arc_rank; b.n_vtx = n_vtx; b.gseg_len = gseg_len;
    b.gw_arc_start = gw_arc_start; b.gw_arc_cnt = gw_arc_cnt;
    b.gw_arc_w = gw_arc_w; b.gw_arc_ow = gw_arc_ow;
    b.gw_seq_off = gw_seq_off; b.gw_seq_len = gw_seq_len;
    b.gw_seq = gw_seq;
    b.seg_nm = seg_nm; b.seg_nm_off = seg_nm_off;
    b.seg_snid = seg_snid; b.seg_soff = seg_soff;
    b.ss_nm = ss_nm; b.ss_nm_off = ss_nm_off;
    b.ss_min = ss_min; b.ss_max = ss_max; b.ss_rank = ss_rank;
    b.next = 0;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    if (n_threads > n_reads) n_threads = n_reads > 0 ? n_reads : 1;
    b.r_tid = (int64_t *)malloc(8 * (size_t)n_reads);
    b.r_off = o_off;
    b.r_len = o_len;
    b.status = status;
    b.tbuf = (char **)calloc((size_t)n_threads, sizeof(char *));
    b.tlen = (int64_t *)calloc((size_t)n_threads, 8);
    if (!b.r_tid || !b.tbuf || !b.tlen) {
        free(b.r_tid); free(b.tbuf); free(b.tlen);
        return -1;
    }
    if (n_threads == 1) {
        warg_t w = { &b, 0 };
        worker(&w);
    } else {
        pthread_t th[64];
        warg_t wa[64];
        int64_t t;
        int started[64];
        for (t = 0; t < n_threads; ++t) {
            wa[t].b = &b;
            wa[t].tid = (int)t;
            started[t] = pthread_create(&th[t], 0, worker,
                                        &wa[t]) == 0;
            if (!started[t]) worker(&wa[t]);   /* EAGAIN: run inline */
        }
        for (t = 0; t < n_threads; ++t)
            if (started[t]) pthread_join(th[t], 0);
    }
    /* assemble per-thread buffers into one ordered output buffer */
    int64_t total = 0, t, i;
    for (t = 0; t < n_threads; ++t) total += b.tlen[t];
    char *out = (char *)malloc(total > 0 ? (size_t)total : 1);
    if (!out) {
        for (t = 0; t < n_threads; ++t) free(b.tbuf[t]);
        free(b.r_tid); free(b.tbuf); free(b.tlen);
        return -1;
    }
    int64_t opos = 0;
    for (i = 0; i < n_reads; ++i) {
        if (status[i] != 0 || o_len[i] == 0) { o_off[i] = opos; continue; }
        memcpy(out + opos, b.tbuf[b.r_tid[i]] + o_off[i],
               (size_t)o_len[i]);
        o_off[i] = opos;
        opos += o_len[i];
    }
    for (t = 0; t < n_threads; ++t) free(b.tbuf[t]);
    free(b.r_tid); free(b.tbuf); free(b.tlen);
    *out_buf = out;
    return opos;
}
