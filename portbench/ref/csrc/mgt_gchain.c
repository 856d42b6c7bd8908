/* Graph-chaining DP engine (semantics of mg_gchain1_dp,
 * gchain1.c:62-240), one call per read.  The DP walks linear chains
 * sorted by (isolated, qe), collects candidate predecessors with the
 * reference's find_max window, resolves graph reachability through
 * this repo's mgt_shortest_k engine, and backtracks with the shared
 * peak-cut walker (native/mgt_lchain.c).  Tie permutations reuse the
 * reference-exact 128-bit radix sorter so results stay byte-identical
 * to the Python path in mapping/gchain.py.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

/* Env-gated sub-stage profiling (MGT_PROF=1), same scheme as
 * mgt_tail.c: ns totals summed atomically across worker threads.
 * Slots: 0 gchain1_dp, 1 shortest_k-in-DP, 2 gchain_gen, 3 gwfa
 * bridges, 4 shortk bridges, 5 extras; counters: 6 DP shortk calls,
 * 7 gwfa bridge calls. */
static int64_t gcp_ns[8];
extern int mgt_tail_prof_on(void);
static inline int64_t gcp_now(void)
{
    struct timespec ts;
    if (!mgt_tail_prof_on()) return 0;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}
static inline void gcp_add(int k, int64_t ns)
{
    __atomic_fetch_add(&gcp_ns[k], ns, __ATOMIC_RELAXED);
}
void mgt_gchain_prof_dump(int64_t *out8)
{
    int k;
    for (k = 0; k < 8; ++k) {
        out8[k] = __atomic_load_n(&gcp_ns[k], __ATOMIC_RELAXED);
        __atomic_store_n(&gcp_ns[k], (int64_t)0, __ATOMIC_RELAXED);
    }
}

extern void mgt_radix_sort_128x(uint64_t *a, int64_t n);
extern int64_t mgt_chain_backtrack_core(int64_t n, const int64_t *f,
                                        const int64_t *p, int32_t min_cnt,
                                        int32_t min_sc, int32_t max_drop,
                                        uint64_t *u, int32_t *n_u_,
                                        int64_t *v);
extern int64_t mgt_shortest_k(
    const int64_t *gidx, const int64_t *arc_w, const int64_t *arc_lv,
    const int64_t *arc_rank, int64_t n_vtx, int64_t src, int64_t max_dist,
    int64_t max_k, int64_t want_path, int64_t n_dst, const int64_t *dst_v,
    const int64_t *dst_target_dist, const uint32_t *dst_target_hash,
    const int64_t *dst_check_hash, const int64_t *dst_inner,
    int64_t *out_n_path, int64_t *out_dist, uint32_t *out_hash,
    int64_t *out_is0, int64_t *out_path_end, int64_t path_cap, int64_t *pv_v,
    int64_t *pv_d, int64_t *pv_pre);

#define GC_INT32_MIN (-0x7fffffff - 1)

static inline float mg_log2f(float x)
{
    union { float f; uint32_t i; } z = { x };
    float log_2 = (float)(int32_t)(((z.i >> 23) & 255) - 128);
    z.i &= ~(255u << 23);
    z.i += 127u << 23;
    log_2 += (-0.34484843f * z.f + 2.02466578f) * z.f - 0.67487759f;
    return log_2;
}

/* gap between consecutive lchains through the graph
 * (mg_target_dist, gchain1.c:31-36) */
static inline int64_t target_dist(const int64_t *seg_len, const int64_t *lv,
                                  const int64_t *lqs, const int64_t *lqe,
                                  const int64_t *lrs, const int64_t *lre,
                                  int64_t j, int64_t i)
{
    return (lqs[i] - lqe[j]) - (seg_len[lv[j] >> 1] - lre[j])
        + (seg_len[lv[i] >> 1] - lrs[i]);
}

/* transition score (cal_sc, gchain1.c:38-60) */
static inline int64_t cal_sc(int64_t dist, int64_t tdist, int64_t is_0,
                             int64_t li, int64_t lj, const uint64_t *ay,
                             const int64_t *loff, const int64_t *lcnt,
                             const int64_t *lscore, const int64_t *lqs,
                             const int64_t *lqe, int64_t fj, int64_t bw,
                             int64_t ref_bonus, double chn_pen_gap)
{
    int64_t segi = (int64_t)(ay[loff[li]] >> 48 & 0xff);
    int64_t segj = (int64_t)(ay[loff[lj] + lcnt[lj] - 1] >> 48 & 0xff);
    int64_t gap = dist - tdist, sc;
    float lin_pen, log_pen;
    if (gap < 0) gap = -gap;
    if (segi == segj && gap > bw) return GC_INT32_MIN;
    if (lqe[lj] <= lqs[li]) sc = lscore[li];
    else
        sc = (int64_t)((double)(lqe[li] - lqe[lj])
                       / (double)(lqe[li] - lqs[li])
                       * (double)lscore[li] + .499);
    if (is_0) sc += ref_bonus;
    lin_pen = (float)chn_pen_gap * (float)gap;
    log_pen = gap >= 2 ? mg_log2f((float)gap) : 0.0f;
    sc -= (int64_t)(lin_pen + log_pen);
    sc += fj;
    return sc;
}

/* Returns n_u (number of graph chains); u_out[c] = score<<32|n_lc,
 * order_out[] = original lchain index per slot in gchain layout.
 * dist_pre/hash_pre/inner_pre are per ORIGINAL lchain index.
 * Returns -1 on allocation failure (caller falls back to Python). */
int64_t mgt_gchain1_dp(
    /* graph */
    const int64_t *gidx, const int64_t *arc_w, const int64_t *arc_lv,
    const int64_t *arc_rank, int64_t n_vtx, const int64_t *seg_len,
    /* linear chains */
    int64_t n_lc, const int64_t *lv, const int64_t *loff,
    const int64_t *lcnt, const int64_t *lscore, const int64_t *lqs,
    const int64_t *lqe, const int64_t *lrs, const int64_t *lre,
    const uint64_t *ay,
    /* params */
    int64_t qlen, int64_t max_dist_g, int64_t max_dist_q, int64_t bw,
    int64_t max_skip, int64_t ref_bonus, double chn_pen_gap,
    double mask_level, int64_t max_sk,
    /* out */
    uint64_t *u_out, int64_t *order_out, int64_t *dist_pre,
    uint32_t *hash_pre, int64_t *inner_pre)
{
    int64_t i, j, k, n_ext = 0, n_u = 0, n_v, ret = -1;
    int32_t n_u32 = 0;
    uint64_t *z = 0, *u_bt = 0;
    int64_t *a_i = 0, *f = 0, *p = 0, *t = 0, *vv = 0;
    int64_t *dv = 0, *dtd = 0, *dch = 0, *din = 0, *dmeta = 0;
    uint32_t *dth = 0;
    int64_t *onp = 0, *odi = 0, *oi0 = 0, *ope = 0;
    uint32_t *oha = 0;
    int64_t pvd[1] = { 0 };

    if (n_lc <= 0) return 0;
    z = (uint64_t *)malloc(16 * (size_t)n_lc);
    a_i = (int64_t *)malloc(8 * (size_t)n_lc);
    if (!z || !a_i) goto done;
    for (i = 0; i < n_lc; ++i) {
        int64_t med = seg_len[lv[i] >> 1] - lre[i], iso;
        dist_pre[i] = -1, hash_pre[i] = 0, inner_pre[i] = 0;
        if (lrs[i] < med) med = lrs[i];
        iso = (med > max_dist_g || (med >> 3) > lscore[i]) ? 1 : 0;
        z[2 * i] = (uint64_t)(uint32_t)((iso << 31) | (uint32_t)lqe[i]);
        z[2 * i + 1] = (uint64_t)i;
        if (!iso) ++n_ext;
    }
    if (n_ext < 2) {
        for (i = 0; i < n_lc; ++i) {
            u_out[i] = (uint64_t)lscore[i] << 32 | 1;
            order_out[i] = i;
        }
        ret = n_lc;
        goto done;
    }
    mgt_radix_sort_128x(z, n_lc);
    for (i = 0; i < n_lc; ++i) a_i[i] = (int64_t)z[2 * i + 1];

    f = (int64_t *)malloc(8 * (size_t)n_ext);
    p = (int64_t *)malloc(8 * (size_t)n_ext);
    t = (int64_t *)malloc(8 * (size_t)n_ext);
    vv = (int64_t *)malloc(8 * (size_t)n_lc);
    u_bt = (uint64_t *)malloc(8 * (size_t)n_lc);
    dv = (int64_t *)malloc(8 * (size_t)n_ext);
    dtd = (int64_t *)malloc(8 * (size_t)n_ext);
    dch = (int64_t *)calloc((size_t)n_ext, 8);
    din = (int64_t *)malloc(8 * (size_t)n_ext);
    dmeta = (int64_t *)malloc(8 * (size_t)n_ext);
    dth = (uint32_t *)calloc((size_t)n_ext, 4);
    onp = (int64_t *)malloc(8 * (size_t)n_ext);
    odi = (int64_t *)malloc(8 * (size_t)n_ext);
    oi0 = (int64_t *)malloc(8 * (size_t)n_ext);
    ope = (int64_t *)malloc(8 * (size_t)n_ext);
    oha = (uint32_t *)malloc(4 * (size_t)n_ext);
    if (!f || !p || !t || !vv || !u_bt || !dv || !dtd || !dch || !din
        || !dmeta || !dth || !onp || !odi || !oi0 || !ope || !oha)
        goto done;
    for (i = 0; i < n_ext; ++i) t[i] = -1;

    for (i = 0; i < n_ext; ++i) {
        const int64_t li = a_i[i];
        const int64_t segi = (int64_t)(ay[loff[li]] >> 48 & 0xff);
        uint64_t x = (uint64_t)(lqs[li] + bw > qlen ? qlen : lqs[li] + bw);
        int64_t xj, n_dst = 0, n_skip = 0, rsk;
        int64_t max_f = lscore[li], max_j = -1, max_d = -1, max_inner = 0;
        uint32_t max_hash = 0;
        /* find_max (gchain1.c:16-29), n = i over sorted srt keys.
         * NOTE: replicates the reference's actual behavior, which in
         * the mixed case returns the FIRST index with srt >= x (one
         * candidate past the < x run); its own comment says otherwise
         * but byte parity follows the code. */
        if (i == 0) xj = -1;
        else if (z[2 * (i - 1)] < x) xj = i - 1;
        else if (z[0] >= x) xj = -1;
        else {
            int64_t s = 0, e = i, m;
            while (e > s) {
                m = s + (e - s) / 2;
                if (z[2 * m] >= x) e = m;
                else s = m + 1;
            }
            xj = s;
        }
        for (j = xj; j >= 0; --j) {
            const int64_t lj = a_i[j];
            int64_t dq, segj, td;
            if (lqs[lj] >= lqs[li]) continue;
            if (lqe[lj] > lqs[li]) {
                int64_t o = lqe[lj] - lqs[li];
                if ((double)o > (double)(lqe[lj] - lqs[lj]) * mask_level
                    || (double)o > (double)(lqe[li] - lqs[li]) * mask_level)
                    continue;
            }
            dq = lqs[li] - lqe[lj];
            segj = (int64_t)(ay[loff[lj] + lcnt[lj] - 1] >> 48 & 0xff);
            if (segi == segj) {
                if (dq > max_dist_q) break;
            } else if (dq > max_dist_g && dq > max_dist_q) {
                break;
            }
            if (lv[li] != lv[lj]) {
                int64_t min_dist = lrs[li] + (seg_len[lv[lj] >> 1] - lre[lj]);
                if (min_dist > max_dist_g) continue;
                if (segi == segj && min_dist - bw > lqs[li] - lqe[lj])
                    continue;
                td = target_dist(seg_len, lv, lqs, lqe, lrs, lre, lj, li);
                if (td < 0) continue;
            } else if (lrs[lj] >= lrs[li] || lre[lj] >= lre[li]) {
                continue;
            } else {
                int64_t dr = lrs[li] - lre[lj];
                int64_t w = dr > dq ? dr - dq : dq - dr;
                if (segi == segj && w > bw) continue;
                if (dr > max_dist_g || dr < -max_dist_g) continue;
                if (lre[lj] > lrs[li]) {
                    int64_t o = lre[lj] - lrs[li];
                    if ((double)o > (double)(lre[lj] - lrs[lj]) * mask_level
                        || (double)o > (double)(lre[li] - lrs[li])
                            * mask_level)
                        continue;
                }
                td = target_dist(seg_len, lv, lqs, lqe, lrs, lre, lj, li);
            }
            din[n_dst] = (lv[li] == lv[lj]) ? 1 : 0;
            dv[n_dst] = lv[lj] ^ 1;
            dmeta[n_dst] = j;
            dtd[n_dst] = td;
            ++n_dst;
            if (t[j] == i) {
                if (++n_skip > max_skip) break;
            }
            if (p[j] >= 0) t[p[j]] = i;
        }
        {
            int64_t tp = gcp_now();
            rsk = mgt_shortest_k(
                gidx, arc_w, arc_lv, arc_rank, n_vtx, lv[li] ^ 1,
                max_dist_g + (seg_len[lv[li] >> 1] - lrs[li]), max_sk, 0,
                n_dst, dv, dtd, dth, dch, din,
                onp, odi, oha, oi0, ope, 0, pvd, pvd, pvd);
            if (tp) { gcp_add(1, gcp_now() - tp); gcp_add(6, 1); }
        }
        if (rsk == -3) goto done;   /* engine overflow: Python fallback */
        for (k = 0; k < n_dst; ++k) {
            int64_t sc;
            if (onp[k] == 0) continue;
            sc = cal_sc(odi[k], dtd[k], oi0[k], li, a_i[dmeta[k]], ay, loff,
                        lcnt, lscore, lqs, lqe, f[dmeta[k]], bw, ref_bonus,
                        chn_pen_gap);
            if (sc == GC_INT32_MIN) continue;
            if (sc + lscore[li] < 0) continue;
            if (sc > max_f) {
                max_f = sc, max_j = dmeta[k];
                max_d = odi[k], max_hash = oha[k], max_inner = din[k];
            }
        }
        f[i] = max_f, p[i] = max_j;
        dist_pre[li] = max_d;
        hash_pre[li] = max_hash;
        inner_pre[li] = max_inner;
    }

    n_v = mgt_chain_backtrack_core(n_ext, f, p, 0, 0, 0x7fffffff, u_bt,
                                   &n_u32, vv);
    n_u = n_u32;
    for (i = 0; i < n_lc - n_ext; ++i) {
        u_bt[n_u + i] = (uint64_t)lscore[a_i[n_ext + i]] << 32 | 1;
        vv[n_v + i] = n_ext + i;
    }
    n_u += n_lc - n_ext;
    n_v += n_lc - n_ext;
    /* gchain layout: chains in u order, each chain's lchains reversed */
    k = 0;
    for (i = 0; i < n_u; ++i) {
        int64_t ni = (int64_t)(uint32_t)u_bt[i], k0 = k;
        u_out[i] = u_bt[i];
        for (j = 0; j < ni; ++j) order_out[k++] = a_i[vv[k0 + ni - 1 - j]];
    }
    ret = n_u;
done:
    free(z); free(a_i); free(f); free(p); free(t); free(vv); free(u_bt);
    free(dv); free(dtd); free(dch); free(din); free(dmeta); free(dth);
    free(onp); free(odi); free(oi0); free(ope); free(oha);
    return ret;
}

extern void mgt_chain_filters(const uint64_t *ax, uint64_t *ay,
                              int32_t lc_max_occ, int32_t lc_max_trim,
                              int32_t score, int32_t bw, int32_t min_match,
                              int32_t max_gap_half, int64_t *off_io,
                              int64_t *cnt_io);

/* Fused post-DP linear-chain tail, one call per read:
 * mg_lchain_gen (lchain.c:374-408) + the per-chain filter block
 * (map-algo.c:194-330 via mgt_chain_filters) + mg_update_anchors
 * (lchain.c:424-441).  ax/ay are mutated in place (anchor x rewrite,
 * seed flags).  Fills the kept chains' table arrays; returns n_kept,
 * or -1 on allocation failure. */
int64_t mgt_lchain_tail(
    int64_t qlen, int64_t n_u, const uint64_t *u, uint64_t *ax,
    uint64_t *ay, const int64_t *mini_pos, int64_t n_mv,
    /* filter params */
    int64_t lc_max_occ, int64_t lc_max_trim, int64_t bw,
    int64_t max_gap_half, int64_t min_lc_cnt,
    /* out tables (cap n_u) */
    int64_t *t_off, int64_t *t_cnt, int64_t *t_v, int64_t *t_rs,
    int64_t *t_re, int64_t *t_qs, int64_t *t_qe, int64_t *t_score)
{
    int64_t i, k, n_out = 0;
    uint64_t *z;
    (void)qlen;
    if (n_u <= 0) return 0;
    z = (uint64_t *)malloc(16 * (size_t)n_u);
    if (!z) return -1;
    for (i = 0, k = 0; i < n_u; ++i) {
        int64_t span = (int64_t)(ay[k] >> 32 & 0xff);
        int64_t qs = (int32_t)(uint32_t)ay[k] + 1 - span;
        z[2 * i] = (uint64_t)qs << 32 | (u[i] >> 32);
        z[2 * i + 1] = (uint64_t)k << 32 | (uint64_t)(uint32_t)u[i];
        k += (int64_t)(uint32_t)u[i];
    }
    mgt_radix_sort_128x(z, n_u);
    for (i = 0; i < n_u; ++i) {
        int64_t off = (int64_t)(z[2 * i + 1] >> 32);
        int64_t cnt = (int64_t)(uint32_t)z[2 * i + 1];
        int64_t score = (int64_t)(uint32_t)z[2 * i];
        int64_t q_span = (int64_t)(ay[off] >> 32 & 0xff);
        int64_t rs, re, qs, qe, v;
        v = (int64_t)(ax[off] >> 32);
        rs = (int32_t)(uint32_t)ax[off] + 1 - q_span;
        if (rs < 0) rs = 0;
        qs = (int64_t)(z[2 * i] >> 32);
        re = (int32_t)(uint32_t)ax[off + cnt - 1] + 1;
        qe = (int32_t)(uint32_t)ay[off + cnt - 1] + 1;
        if (n_u > 1) {
            /* the mapper's per-chain filter block (map-algo.c tail) */
            mgt_chain_filters(ax, ay, (int32_t)lc_max_occ,
                              (int32_t)lc_max_trim, (int32_t)score,
                              (int32_t)bw, 100, (int32_t)max_gap_half,
                              &off, &cnt);
            if (cnt < min_lc_cnt) continue;
            q_span = (int64_t)(ay[off] >> 32 & 0xff);
            rs = (int32_t)(uint32_t)ax[off] + 1 - q_span;
            qs = (int32_t)(uint32_t)ay[off] + 1 - q_span;
            re = (int32_t)(uint32_t)ax[off + cnt - 1] + 1;
            qe = (int32_t)(uint32_t)ay[off + cnt - 1] + 1;
        }
        t_off[n_out] = off, t_cnt[n_out] = cnt, t_v[n_out] = v;
        t_rs[n_out] = rs, t_re[n_out] = re;
        t_qs[n_out] = qs, t_qe[n_out] = qe;
        t_score[n_out] = score;
        ++n_out;
    }
    free(z);
    /* mg_update_anchors: rewrite anchor x to mini_idx<<32|tpos */
    for (i = 0; i < n_out; ++i) {
        int64_t a;
        for (a = t_off[i]; a < t_off[i] + t_cnt[i]; ++a) {
            int64_t qpos = (int32_t)(uint32_t)ay[a];
            int64_t s = 0, e = n_mv;
            while (e > s) {     /* lower_bound over mini_pos */
                int64_t m = s + (e - s) / 2;
                if (mini_pos[m] < qpos) s = m + 1;
                else e = m;
            }
            ax[a] = (uint64_t)s << 32 | (ax[a] & 0xffffffffULL);
        }
    }
    return n_out;
}

/* ------------------------------------------------------------------ */
/* graph-chain materialization (mg_gchain_gen, gchain1.c:443-520)      */
/* ------------------------------------------------------------------ */

extern int32_t mgt_gwfa_ed(
    int64_t *arc_start, int32_t *arc_cnt, uint32_t *arc_w, int32_t *arc_ow,
    int64_t *seq_off, int32_t *seq_len, const char *seq,
    int32_t ql, const char *q, uint32_t v0, int32_t off0, uint32_t v1,
    int32_t off1, int32_t s_term, int32_t traceback, int32_t max_chk,
    int32_t bw_dyn, int32_t max_lag, int64_t i_term,
    int32_t *walk, int32_t walk_cap, int32_t *n_walk);

extern int64_t mgt_gchain_extra(const uint64_t *ax, const uint64_t *ay,
                                const int64_t *lc_v, const int64_t *lc_off,
                                const int64_t *lc_cnt,
                                const int64_t *seg_len, int64_t gc_off,
                                int64_t gc_cnt, int64_t *out);

static inline uint32_t gg_hash32(uint32_t key)
{
    key += ~(key << 15);
    key ^= key >> 10;
    key += key << 3;
    key ^= key >> 6;
    key += ~(key << 11);
    key ^= key >> 16;
    return key;
}

/* ---- device-GWFA bridge hook (thread-local) -----------------------
 * mode 0: bridges run the inline host engine (default).
 * mode 1: HARVEST — record every gwfa bridge site's job parameters
 *         and pretend the bridge succeeded with an empty walk; the
 *         caller discards the output and re-runs in mode 2.
 * mode 2: INJECT — site k consumes res_s[k]/res_walk[k]: >= 0 uses
 *         the (device-computed) walk, -1 falls back to shortest-k
 *         like a host "not found", -2 runs the inline host engine
 *         (flagged job).  Site enumeration order is identical in
 *         both passes because bridge inputs only depend on the chain
 *         tables, never on earlier bridge results.                   */
typedef struct {
    int64_t mode, n_jobs, job_cap, wcap, res_cap;
    int64_t *jobs;              /* 8 int64 per site */
    const int64_t *res_s;
    const int32_t *res_walk;    /* (res_cap, wcap) */
    const int64_t *res_wn;
} gwf_hook_t;

static __thread gwf_hook_t g_gwf_hook;

void mgt_gwf_hook_set(int64_t mode, int64_t job_cap, int64_t *jobs,
                      int64_t res_cap, const int64_t *res_s,
                      const int32_t *res_walk, const int64_t *res_wn,
                      int64_t wcap)
{
    g_gwf_hook.mode = mode;
    g_gwf_hook.n_jobs = 0;
    g_gwf_hook.job_cap = job_cap;
    g_gwf_hook.jobs = jobs;
    g_gwf_hook.res_cap = res_cap;
    g_gwf_hook.res_s = res_s;
    g_gwf_hook.res_walk = res_walk;
    g_gwf_hook.res_wn = res_wn;
    g_gwf_hook.wcap = wcap;
}

int64_t mgt_gwf_hook_jobs(void) { return g_gwf_hook.n_jobs; }

#define I32A(a, i) ((int64_t)(int32_t)(uint32_t)(a)[i])

/* scratch state for one read's materialization */
typedef struct {
    int64_t n_llc, llc_cap, n_a, a_cap, n_a_total;
    int64_t *lv, *loff, *lcnt, *lsc, *led;
    uint64_t *bx, *by;
    const uint64_t *ax, *ay;
} ggen_t;

static int gg_push_llc(ggen_t *z, int64_t v, int64_t off, int64_t cnt,
                       int64_t sc, int64_t ed)
{
    if (z->n_llc >= z->llc_cap) return -2;
    z->lv[z->n_llc] = v, z->loff[z->n_llc] = off, z->lcnt[z->n_llc] = cnt;
    z->lsc[z->n_llc] = sc, z->led[z->n_llc] = ed;
    ++z->n_llc;
    return 0;
}

static int gg_copy_anchors(ggen_t *z, int64_t src, int64_t cnt)
{
    if (z->n_a + cnt > z->a_cap) return -2;
    memcpy(z->bx + z->n_a, z->ax + src, 8 * (size_t)cnt);
    memcpy(z->by + z->n_a, z->ay + src, 8 * (size_t)cnt);
    z->n_a += cnt;
    return 0;
}

/* copy one lchain into the output (copy_lchain, gchain1.c:300-312) */
static int gg_copy_lchain(ggen_t *z, const int64_t *sv, const int64_t *soff,
                          const int64_t *scnt, const int64_t *ssc,
                          int64_t l, int64_t ed)
{
    int r = gg_push_llc(z, sv[l], z->n_a, scnt[l], ssc[l], ed);
    if (r) return r;
    return gg_copy_anchors(z, soff[l], scnt[l]);
}

/* resolve_overlap (gchain1.c:409-441); -3 signals the reference
 * assert (caller falls back to Python, which raises it the same). */
static int gg_resolve_overlap(int64_t *sv, int64_t *soff, int64_t *scnt,
                              int64_t *sqs, int64_t *sqe, int64_t *srs,
                              int64_t *sre, const uint64_t *ax,
                              const uint64_t *ay, int64_t n_a_total,
                              int64_t l0, int64_t l1)
{
    int64_t x, y, j, shift0, shift1, i0;
    x = I32A(ax, soff[l1]);
    y = I32A(ay, soff[l1]);
    for (j = scnt[l0] - 1; j >= 0; --j)
        if (I32A(ay, soff[l0] + j) <= y
            && (sv[l0] != sv[l1] || I32A(ax, soff[l0] + j) <= x))
            break;
    shift0 = scnt[l0] - 1 - j;
    i0 = soff[l0] + scnt[l0] - 1;
    if (i0 < 0) i0 += n_a_total;    /* Python negative-index wrap */
    x = I32A(ax, i0);
    y = I32A(ay, i0);
    for (j = 0; j < scnt[l1]; ++j)
        if (I32A(ay, soff[l1] + j) >= y
            && (sv[l0] != sv[l1] || I32A(ax, soff[l1] + j) >= x))
            break;
    shift1 = j;
    if (shift1 >= scnt[l1]) return -3;   /* assert(shift1 < l1->cnt) */
    if (shift0 > 0) {
        scnt[l0] -= shift0;
        if (scnt[l0]) {
            sqe[l0] = I32A(ay, soff[l0] + scnt[l0] - 1) + 1;
            sre[l0] = I32A(ax, soff[l0] + scnt[l0] - 1) + 1;
        }
    }
    if (shift1 > 0) {
        int64_t span;
        soff[l1] += shift1;
        scnt[l1] -= shift1;
        span = (int64_t)(ay[soff[l1]] >> 32 & 0xff);
        sqs[l1] = I32A(ay, soff[l1]) + 1 - span;
        srs[l1] = I32A(ax, soff[l1]) + 1 - span;
    }
    if (scnt[l0] == 0) {
        sqs[l0] = sqe[l0] = sqs[l1];
        srs[l0] = sre[l0] = srs[l1];
    }
    return 0;
}

/* Returns n_gc; -1 alloc failure, -2 output cap exceeded, -3 needs
 * the Python path (bridge failure warning / reference assert). */
int64_t mgt_gchain_gen(
    /* shortest-k graph */
    const int64_t *gidx, const int64_t *arc_w, const int64_t *arc_lv,
    const int64_t *arc_rank, int64_t n_vtx, const int64_t *seg_len,
    /* gwfa graph */
    int64_t *gw_arc_start, int32_t *gw_arc_cnt, uint32_t *gw_arc_w,
    int32_t *gw_arc_ow, int64_t *gw_seq_off, int32_t *gw_seq_len,
    const char *gw_seq,
    /* linear chains in gchain layout (slots; mutated in place) */
    int64_t n_u, const uint64_t *u, int64_t *sv, int64_t *soff,
    int64_t *scnt, int64_t *ssc, int64_t *sqs, int64_t *sqe, int64_t *srs,
    int64_t *sre, const int64_t *sdist_pre, const uint32_t *shash_pre,
    /* anchors + query */
    const uint64_t *ax, const uint64_t *ay, int64_t n_a_total,
    const char *qseq, int64_t qseq_len,
    /* params */
    uint32_t hash0, int64_t min_gc_cnt, int64_t min_gc_score,
    int64_t gdp_max_ed, int64_t n_seg, int64_t max_sk,
    /* out (sorted by (score, hash) desc, restore_order applied) */
    int64_t llc_cap, int64_t a_cap, int64_t gc_cap,
    int64_t *o_lv, int64_t *o_loff, int64_t *o_lcnt, int64_t *o_lsc,
    int64_t *o_led, uint64_t *o_ax, uint64_t *o_ay,
    int64_t *g_off, int64_t *g_cnt, int64_t *g_na, int64_t *g_sc,
    uint32_t *g_hash, int64_t *g_extra)
{
    ggen_t z;
    int64_t i, j, k, st, n_gc = 0, kmer, ret = -1;
    int64_t *gc_off0 = 0, *gc_na0 = 0;
    int32_t *walk = 0;
    uint64_t *w = 0;
    int64_t pv_cap = 1 << 16;
    int64_t *pv_v = 0, *pv_d = 0, *pv_p = 0;

    if (n_u == 0) return 0;
    memset(&z, 0, sizeof(z));
    z.llc_cap = llc_cap, z.a_cap = a_cap, z.n_a_total = n_a_total;
    z.ax = ax, z.ay = ay;
    z.lv = (int64_t *)malloc(8 * (size_t)llc_cap);
    z.loff = (int64_t *)malloc(8 * (size_t)llc_cap);
    z.lcnt = (int64_t *)malloc(8 * (size_t)llc_cap);
    z.lsc = (int64_t *)malloc(8 * (size_t)llc_cap);
    z.led = (int64_t *)malloc(8 * (size_t)llc_cap);
    z.bx = (uint64_t *)malloc(8 * (size_t)a_cap);
    z.by = (uint64_t *)malloc(8 * (size_t)a_cap);
    gc_off0 = (int64_t *)malloc(8 * (size_t)gc_cap);
    gc_na0 = (int64_t *)malloc(8 * (size_t)gc_cap);
    /* the optimal bridge walk is bounded by query span + edit
     * distance (net deletions thread extra vertices), not by the
     * query length alone */
    walk = (int32_t *)malloc(4 * ((size_t)qseq_len + (size_t)gdp_max_ed
                                  + 64));
    pv_v = (int64_t *)malloc(8 * (size_t)pv_cap);
    pv_d = (int64_t *)malloc(8 * (size_t)pv_cap);
    pv_p = (int64_t *)malloc(8 * (size_t)pv_cap);
    if (!z.lv || !z.loff || !z.lcnt || !z.lsc || !z.led || !z.bx || !z.by
        || !gc_off0 || !gc_na0 || !walk || !pv_v || !pv_d || !pv_p)
        goto done;
    kmer = (int64_t)(ay[0] >> 32 & 0xff);

    for (i = 0, st = 0; i < n_u; st += (int64_t)(uint32_t)u[i], ++i) {
        int64_t nui = (int64_t)(uint32_t)u[i], m = 0, n_a0, n_llc0, j0;
        uint32_t h = hash0;
        int r;
        for (j = 0; j < nui; ++j) m += scnt[st + j];
        if (m < min_gc_cnt || (int64_t)(u[i] >> 32) < min_gc_score)
            continue;
        if (n_gc >= gc_cap) { ret = -2; goto done; }
        n_a0 = z.n_a, n_llc0 = z.n_llc;
        for (j = 0; j < nui; ++j) {
            h += gg_hash32((uint32_t)sqs[st + j]);
            h += gg_hash32((uint32_t)sre[st + j]);
            h += gg_hash32((uint32_t)sv[st + j]);
        }
        g_hash[n_gc] = gg_hash32(h);
        for (j = 1; j < nui; ++j) {
            r = gg_resolve_overlap(sv, soff, scnt, sqs, sqe, srs, sre,
                                   ax, ay, n_a_total, st + j - 1, st + j);
            if (r) { ret = r; goto done; }
        }
        r = gg_copy_lchain(&z, sv, soff, scnt, ssc, st, -1);
        if (r) { ret = r; goto done; }
        for (j = 1, j0 = 0; j < nui; ++j) {
            int64_t l0 = st + j0, l1 = st + j;
            if (scnt[l1] <= 0) continue;
            if (sv[l1] != sv[l0]) {
                int64_t ed = -1, bridged = 0;
                if (n_seg == 1) {
                    /* bridge_gwfa (gchain1.c:349-381) */
                    int64_t qs = sqe[l0] - kmer, qe = sqs[l1] + kmer;
                    int32_t n_walk = 0, s;
                    int64_t handled = 0;
                    if (g_gwf_hook.mode == 1) {
                        /* harvest the job; output is discarded */
                        if (g_gwf_hook.n_jobs < g_gwf_hook.job_cap) {
                            int64_t *jp = g_gwf_hook.jobs
                                + 8 * g_gwf_hook.n_jobs;
                            jp[0] = qs, jp[1] = qe;
                            jp[2] = sv[l0], jp[3] = sre[l0] - kmer;
                            jp[4] = sv[l1], jp[5] = srs[l1] + kmer - 1;
                            jp[6] = gdp_max_ed, jp[7] = 0;
                        }
                        ++g_gwf_hook.n_jobs;
                        ed = 0, bridged = 1, handled = 1;
                    } else if (g_gwf_hook.mode == 2) {
                        int64_t site = g_gwf_hook.n_jobs++;
                        if (site < g_gwf_hook.res_cap
                            && g_gwf_hook.res_s[site] != -2) {
                            int64_t rs = g_gwf_hook.res_s[site];
                            if (rs >= 0) {
                                const int32_t *wkp = g_gwf_hook.res_walk
                                    + site * g_gwf_hook.wcap;
                                int64_t wn = g_gwf_hook.res_wn[site], q2;
                                for (q2 = 1; q2 < wn - 1; ++q2) {
                                    r = gg_push_llc(&z, wkp[q2], 0, 0, 0,
                                                    -1);
                                    if (r) { ret = r; goto done; }
                                }
                                ed = rs, bridged = 1;
                            }
                            handled = 1;   /* rs == -1: shortk fallback */
                        }
                    }
                    if (!handled) {
                        int64_t tp = gcp_now();
                        s = mgt_gwfa_ed(gw_arc_start, gw_arc_cnt, gw_arc_w,
                                        gw_arc_ow, gw_seq_off, gw_seq_len,
                                        gw_seq, (int32_t)(qe - qs),
                                        qseq + qs,
                                        (uint32_t)sv[l0],
                                        (int32_t)(sre[l0] - kmer),
                                        (uint32_t)sv[l1],
                                        (int32_t)(srs[l1] + kmer - 1),
                                        (int32_t)gdp_max_ed, 1, 1000, 1000,
                                        (int32_t)(gdp_max_ed / 2),
                                        500000000, walk,
                                        (int32_t)(qseq_len + gdp_max_ed
                                                  + 64), &n_walk);
                        if (tp) { gcp_add(3, gcp_now() - tp); gcp_add(7, 1); }
                        if (s == -2) { ret = -3; goto done; }
                        if (s >= 0) {
                            int64_t q2;
                            for (q2 = 1; q2 < (int64_t)n_walk - 1; ++q2) {
                                r = gg_push_llc(&z, walk[q2], 0, 0, 0, -1);
                                if (r) { ret = r; goto done; }
                            }
                            ed = s, bridged = 1;
                        }
                    }
                }
                if (!bridged) {
                    /* bridge_shortk (gchain1.c:314-347) */
                    int64_t dv1 = sv[l0] ^ 1, dtd1 = sdist_pre[l1];
                    int64_t dch1 = 1, din1 = 0;
                    uint32_t dth1 = shash_pre[l1];
                    int64_t onp1, odi1, oi01, ope1, rr;
                    uint32_t oha1;
                    int64_t tp = gcp_now();
                    if (dtd1 < 0) { ret = -3; goto done; }
                    rr = mgt_shortest_k(gidx, arc_w, arc_lv, arc_rank,
                                        n_vtx, sv[l1] ^ 1, dtd1, max_sk, 1,
                                        1, &dv1, &dtd1, &dth1, &dch1,
                                        &din1, &onp1, &odi1, &oha1, &oi01,
                                        &ope1, pv_cap, pv_v, pv_d, pv_p);
                    if (tp) gcp_add(4, gcp_now() - tp);
                    if (rr <= 0 || onp1 == 0 || oha1 != dth1) {
                        ret = -3;   /* [W::bridge] warning in Python */
                        goto done;
                    }
                    for (k = rr - 2; k >= 1; --k) {
                        r = gg_push_llc(&z, pv_v[k] ^ 1, 0, 0, 0, -1);
                        if (r) { ret = r; goto done; }
                    }
                }
                r = gg_copy_lchain(&z, sv, soff, scnt, ssc, l1, ed);
                if (r) { ret = r; goto done; }
            } else {
                /* same vertex: merge anchors into the last llchain */
                int64_t t = z.n_llc - 1, kk = 0;
                while (kk < scnt[l1]) {
                    int64_t akx = I32A(ax, soff[l1] + kk);
                    int64_t aky = I32A(ay, soff[l1] + kk);
                    if (akx > sre[l0] && aky > sqe[l0]) break;
                    ++kk;
                }
                if (kk < scnt[l1]) {
                    z.lcnt[t] += scnt[l1] - kk;
                    z.lsc[t] += ssc[l1];
                    r = gg_copy_anchors(&z, soff[l1] + kk, scnt[l1] - kk);
                    if (r) { ret = r; goto done; }
                }
            }
            j0 = j;
        }
        gc_off0[n_gc] = n_llc0;
        gc_na0[n_gc] = n_a0;
        g_off[n_gc] = n_llc0;   /* pre-sort; rewritten below */
        g_cnt[n_gc] = z.n_llc - n_llc0;
        g_na[n_gc] = z.n_a - n_a0;
        g_sc[n_gc] = (int64_t)(u[i] >> 32);
        ++n_gc;
    }

    /* extras on the pre-sort layout (order-independent) */
    {
        int64_t tp = gcp_now();
        for (i = 0; i < n_gc; ++i) {
            int64_t *row = g_extra + i * 8;
            row[7] = mgt_gchain_extra(z.bx, z.by, z.lv, z.loff, z.lcnt,
                                      seg_len, gc_off0[i], g_cnt[i], row);
        }
        if (tp) gcp_add(5, gcp_now() - tp);
    }

    /* sort by (score<<32|hash) desc + restore_order (gcmisc.c:8-71) */
    w = (uint64_t *)malloc(16 * (size_t)(n_gc ? n_gc : 1));
    if (!w) goto done;
    for (i = 0; i < n_gc; ++i) {
        w[2 * i] = (uint64_t)g_sc[i] << 32 | g_hash[i];
        w[2 * i + 1] = (uint64_t)i;
    }
    mgt_radix_sort_128x(w, n_gc);
    {
        int64_t n_llc2 = 0, n_a2 = 0;
        int64_t *p_off = (int64_t *)malloc(8 * (size_t)(n_gc ? n_gc : 1));
        int64_t *p_cnt = (int64_t *)malloc(8 * (size_t)(n_gc ? n_gc : 1));
        int64_t *p_na = (int64_t *)malloc(8 * (size_t)(n_gc ? n_gc : 1));
        int64_t *p_sc = (int64_t *)malloc(8 * (size_t)(n_gc ? n_gc : 1));
        uint32_t *p_h = (uint32_t *)malloc(4 * (size_t)(n_gc ? n_gc : 1));
        int64_t *p_ex = (int64_t *)malloc(64 * (size_t)(n_gc ? n_gc : 1));
        if (!p_off || !p_cnt || !p_na || !p_sc || !p_h || !p_ex) {
            free(p_off); free(p_cnt); free(p_na); free(p_sc); free(p_h);
            free(p_ex);
            goto done;
        }
        for (i = 0; i < n_gc; ++i) {
            int64_t id = (int64_t)w[2 * (n_gc - 1 - i) + 1];
            int64_t src_llc = gc_off0[id], src_a = gc_na0[id];
            p_off[i] = n_llc2, p_cnt[i] = g_cnt[id], p_na[i] = g_na[id];
            p_sc[i] = g_sc[id], p_h[i] = g_hash[id];
            memcpy(p_ex + i * 8, g_extra + id * 8, 64);
            for (j = 0; j < g_cnt[id]; ++j) {
                o_lv[n_llc2] = z.lv[src_llc + j];
                o_lcnt[n_llc2] = z.lcnt[src_llc + j];
                o_lsc[n_llc2] = z.lsc[src_llc + j];
                o_led[n_llc2] = z.led[src_llc + j];
                o_loff[n_llc2] = n_a2 + (z.loff[src_llc + j] - src_a);
                ++n_llc2;
            }
            memcpy(o_ax + n_a2, z.bx + src_a, 8 * (size_t)g_na[id]);
            memcpy(o_ay + n_a2, z.by + src_a, 8 * (size_t)g_na[id]);
            n_a2 += g_na[id];
        }
        /* restore_order recomputes every llc off as the running
         * anchor count (bridge entries included) */
        n_a2 = 0;
        for (i = 0; i < n_llc2; ++i) {
            o_loff[i] = n_a2;
            n_a2 += o_lcnt[i];
        }
        memcpy(g_off, p_off, 8 * (size_t)n_gc);
        memcpy(g_cnt, p_cnt, 8 * (size_t)n_gc);
        memcpy(g_na, p_na, 8 * (size_t)n_gc);
        memcpy(g_sc, p_sc, 8 * (size_t)n_gc);
        memcpy(g_hash, p_h, 4 * (size_t)n_gc);
        memcpy(g_extra, p_ex, 64 * (size_t)n_gc);
        free(p_off); free(p_cnt); free(p_na); free(p_sc); free(p_h);
        free(p_ex);
    }
    ret = n_gc;
done:
    free(z.lv); free(z.loff); free(z.lcnt); free(z.lsc); free(z.led);
    free(z.bx); free(z.by); free(gc_off0); free(gc_na0); free(walk);
    free(pv_v); free(pv_d); free(pv_p); free(w);
    return ret;
}

/* Whole graph-chain stage in one call: mgt_gchain1_dp + slot gather +
 * mgt_gchain_gen.  Inputs are the kept-lchain tables straight from
 * mgt_lchain_tail; outputs are the final sorted gchain tables.
 * Returns n_gc, or <0 for Python fallback (-1 alloc, -2 caps,
 * -3 bridge warning / reference assert).  n_u_out/u_out let the
 * caller rebuild objects for the fallback DP-result reuse. */
int64_t mgt_gchain_full(
    /* shortest-k graph */
    const int64_t *gidx, const int64_t *arc_w, const int64_t *arc_lv,
    const int64_t *arc_rank, int64_t n_vtx, const int64_t *seg_len,
    /* gwfa graph */
    int64_t *gw_arc_start, int32_t *gw_arc_cnt, uint32_t *gw_arc_w,
    int32_t *gw_arc_ow, int64_t *gw_seq_off, int32_t *gw_seq_len,
    const char *gw_seq,
    /* kept lchains (query-start order, from mgt_lchain_tail) */
    int64_t n_lc, const int64_t *lv, const int64_t *loff,
    const int64_t *lcnt, const int64_t *lscore, const int64_t *lqs,
    const int64_t *lqe, const int64_t *lrs, const int64_t *lre,
    /* anchors + query */
    const uint64_t *ax, const uint64_t *ay, int64_t n_a_total,
    const char *qseq, int64_t qseq_len,
    /* params */
    int64_t qlen, int64_t max_dist_g, int64_t max_dist_q, int64_t bw,
    int64_t max_skip, int64_t ref_bonus, double chn_pen_gap,
    double mask_level, int64_t max_sk, uint32_t hash0,
    int64_t min_gc_cnt, int64_t min_gc_score, int64_t gdp_max_ed,
    int64_t n_seg,
    /* out */
    int64_t llc_cap, int64_t a_cap, int64_t gc_cap,
    int64_t *o_lv, int64_t *o_loff, int64_t *o_lcnt, int64_t *o_lsc,
    int64_t *o_led, uint64_t *o_ax, uint64_t *o_ay,
    int64_t *g_off, int64_t *g_cnt, int64_t *g_na, int64_t *g_sc,
    uint32_t *g_hash, int64_t *g_extra)
{
    int64_t n_u, n_slots = 0, i, k, ret = -1, n_gc;
    uint64_t *u = 0;
    int64_t *order = 0, *dpre = 0, *ipre = 0;
    uint32_t *hpre = 0;
    int64_t *s8 = 0;            /* gathered slot tables, 8 planes */
    int64_t *sdp = 0;
    uint32_t *shp = 0;

    if (n_lc == 0) return 0;
    u = (uint64_t *)malloc(8 * (size_t)n_lc);
    order = (int64_t *)malloc(8 * (size_t)n_lc);
    dpre = (int64_t *)malloc(8 * (size_t)n_lc);
    ipre = (int64_t *)malloc(8 * (size_t)n_lc);
    hpre = (uint32_t *)malloc(4 * (size_t)n_lc);
    if (!u || !order || !dpre || !ipre || !hpre) goto done;
    {
        int64_t tp = gcp_now();
        n_u = mgt_gchain1_dp(gidx, arc_w, arc_lv, arc_rank, n_vtx, seg_len,
                             n_lc, lv, loff, lcnt, lscore, lqs, lqe, lrs,
                             lre, ay, qlen, max_dist_g, max_dist_q, bw,
                             max_skip, ref_bonus, chn_pen_gap, mask_level,
                             max_sk, u, order, dpre, hpre, ipre);
        if (tp) gcp_add(0, gcp_now() - tp);
    }
    if (n_u < 0) goto done;
    for (i = 0; i < n_u; ++i) n_slots += (int64_t)(uint32_t)u[i];
    s8 = (int64_t *)malloc(8 * 8 * (size_t)(n_slots ? n_slots : 1));
    sdp = (int64_t *)malloc(8 * (size_t)(n_slots ? n_slots : 1));
    shp = (uint32_t *)malloc(4 * (size_t)(n_slots ? n_slots : 1));
    if (!s8 || !sdp || !shp) goto done;
    for (k = 0; k < n_slots; ++k) {
        int64_t o = order[k];
        s8[k] = lv[o];
        s8[n_slots + k] = loff[o];
        s8[2 * n_slots + k] = lcnt[o];
        s8[3 * n_slots + k] = lscore[o];
        s8[4 * n_slots + k] = lqs[o];
        s8[5 * n_slots + k] = lqe[o];
        s8[6 * n_slots + k] = lrs[o];
        s8[7 * n_slots + k] = lre[o];
        sdp[k] = dpre[o];
        shp[k] = hpre[o];
    }
    {
        int64_t tp = gcp_now();
        n_gc = mgt_gchain_gen(gidx, arc_w, arc_lv, arc_rank, n_vtx, seg_len,
                              gw_arc_start, gw_arc_cnt, gw_arc_w, gw_arc_ow,
                              gw_seq_off, gw_seq_len, gw_seq,
                              n_u, u, s8, s8 + n_slots, s8 + 2 * n_slots,
                              s8 + 3 * n_slots, s8 + 4 * n_slots,
                              s8 + 5 * n_slots, s8 + 6 * n_slots,
                              s8 + 7 * n_slots, sdp, shp,
                              ax, ay, n_a_total, qseq, qseq_len,
                              hash0, min_gc_cnt, min_gc_score, gdp_max_ed,
                              n_seg, max_sk, llc_cap, a_cap, gc_cap,
                              o_lv, o_loff, o_lcnt, o_lsc, o_led, o_ax, o_ay,
                              g_off, g_cnt, g_na, g_sc, g_hash, g_extra);
        if (tp) gcp_add(2, gcp_now() - tp);
    }
    ret = n_gc;
done:
    free(u); free(order); free(dpre); free(ipre); free(hpre);
    free(s8); free(sdp); free(shp);
    return ret;
}
