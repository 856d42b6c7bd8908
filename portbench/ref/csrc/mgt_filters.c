/* Per-lchain end trimming + bad-seed masking, semantics-equal to
 * map-algo.c:194-330, structured after this repo's formulation
 * (mapping/filters.py): the score-based end shrink runs as a single
 * pass over precomputed gap pairs with a last-flag tracker, and the
 * two seed-masking heuristics scan a collected long-gap index list.
 * One call applies the whole per-chain filter block
 * (mapping/mapper.py tail order): occurrence end trim, score end
 * shrink, unbalanced-indel masking, compensating-gap masking.
 * ay[] is mutated in place (IGNORE/FIXED seed flags).
 */
#include <stdint.h>
#include <stdlib.h>

#define SEED_IGNORE (1ULL << 41)
#define SEED_FIXED (1ULL << 43)

#define I32OF(v) ((int32_t)(uint32_t)(v))
#define MIN2(a, b) ((a) < (b) ? (a) : (b))
#define MAX2(a, b) ((a) > (b) ? (a) : (b))

/* occurrence end trim (map-algo.c:194-205) */
static void occ_trim(const uint64_t *ay, int32_t max_occ, int32_t max_trim,
                     int64_t *off, int64_t *cnt)
{
    int64_t a0 = *off, c0 = *cnt, k;
    for (k = 0; k < max_trim && k < c0; ++k)
        if ((int32_t)(ay[a0 + c0 - 1 - k] >> 56) <= max_occ) break;
    c0 -= k;
    for (k = 0; k < c0 && k < max_trim; ++k)
        if ((int32_t)(ay[a0 + k] >> 56) <= max_occ) break;
    *off = a0 + k;
    *cnt = c0 - k;
}

/* one directional pass of the score-based shrink: steps walk gap
 * pairs (mn, mx) with the running sums l/m; returns the last flagged
 * step at-or-before the stop step, or -1 */
static int64_t shrink_pass(const int64_t *mn, const int64_t *mx,
                           const int64_t *sp, int64_t n, int64_t l0,
                           int32_t score, int32_t bw, int32_t min_match)
{
    int64_t l = l0, m = l0, last_flag = -1, t;
    for (t = 0; t < n; ++t) {
        int64_t before = l;
        l += mn[t];
        m += MIN2(mn[t], sp[t]);
        if (mx[t] - mn[t] > (before >> 1)) last_flag = t;
        if (l >= ((int64_t)bw << 1)
            || (m >= min_match && m >= bw) || m >= (score >> 1))
            break;
    }
    return last_flag;
}

static void score_shrink(const uint64_t *ax, const uint64_t *ay,
                         int32_t score, int32_t bw, int32_t min_match,
                         int64_t *off, int64_t *cnt)
{
    int64_t a0 = *off, c0 = *cnt, i, as = a0, t, nb;
    int64_t *mn, *mx, *sp;
    if (c0 < 3) return;
    mn = (int64_t *)malloc(8 * 3 * (c0 - 1));
    mx = mn + (c0 - 1);
    sp = mx + (c0 - 1);
    for (i = 0; i + 1 < c0; ++i) {
        int64_t lr = I32OF(ax[a0 + i + 1]) - I32OF(ax[a0 + i]);
        int64_t lq = I32OF(ay[a0 + i + 1]) - I32OF(ay[a0 + i]);
        mn[i] = MIN2(lr, lq);
        mx[i] = MAX2(lr, lq);
        sp[i] = (int64_t)(ay[a0 + i + 1] >> 32 & 0xff);  /* span of i+1 */
    }
    /* forward: steps cover anchors a0+1 .. a0+c0-2 */
    t = shrink_pass(mn, mx, sp, c0 - 2, (int64_t)(ay[a0] >> 32 & 0xff),
                    score, bw, min_match);
    if (t >= 0) as = a0 + 1 + t;
    *off = as;
    *cnt = a0 + c0 - as;
    /* backward: reversed gap pairs; span of anchor i+1 at reversed
     * step t is sp[c0-2-t] */
    nb = a0 + c0 - 2 - as;
    if (nb > 0) {
        int64_t *rmn = (int64_t *)malloc(8 * 3 * nb);
        int64_t *rmx = rmn + nb, *rsp = rmx + nb;
        for (i = 0; i < nb; ++i) {
            rmn[i] = mn[c0 - 2 - i];
            rmx[i] = mx[c0 - 2 - i];
            rsp[i] = (int64_t)(ay[a0 + c0 - 2 - i] >> 32 & 0xff);
        }
        t = shrink_pass(rmn, rmx, rsp, nb,
                        (int64_t)(ay[a0 + c0 - 1] >> 32 & 0xff),
                        score, bw, min_match);
        if (t >= 0) *cnt = (a0 + c0 - 2 - t) + 1 - as;
        free(rmn);
    }
    free(mn);
}

/* indices (relative to the chain) whose preceding gap is long */
static int64_t collect_long_gaps(int64_t a0, int64_t c0,
                                 const uint64_t *ax, const uint64_t *ay,
                                 int32_t min_gap, int64_t *K)
{
    int64_t i, n = 0;
    for (i = 1; i < c0; ++i) {
        int64_t g = (I32OF(ay[a0 + i]) - I32OF(ay[a0 + i - 1]))
            - (I32OF(ax[a0 + i]) - I32OF(ax[a0 + i - 1]));
        if (g < -min_gap || g > min_gap) K[n++] = i;
    }
    return n;
}

/* unbalanced-indel cluster masking (map-algo.c:259-294 semantics) */
static void mask_unbalanced(int64_t a0, int64_t c0, const uint64_t *ax,
                            uint64_t *ay, int32_t min_gap,
                            int32_t diff_thres, int32_t max_ext_len,
                            int32_t max_ext_cnt)
{
    int64_t *K, n, k, i, mx = 0, max_st = -1, max_en = -1;
    if (c0 < 2) return;
    K = (int64_t *)malloc(8 * c0);
    n = collect_long_gaps(a0, c0, ax, ay, min_gap, K);
    if (n <= 1) { free(K); return; }
    for (k = 0;; ++k) {
        if (k == n || k >= max_en) {
            if (max_en > 0)
                for (i = K[max_st]; i < K[max_en]; ++i)
                    ay[a0 + i] |= SEED_IGNORE;
            mx = 0;
            max_st = max_en = -1;
            if (k == n) break;
        }
        {
            int64_t i0 = K[k], g, n_ins, n_del, qs, rs, l;
            int64_t max_diff = 0, max_diff_l = -1;
            g = (I32OF(ay[a0 + i0]) - I32OF(ay[a0 + i0 - 1]))
                - (I32OF(ax[a0 + i0]) - I32OF(ax[a0 + i0 - 1]));
            n_ins = g > 0 ? g : 0;
            n_del = g <= 0 ? -g : 0;
            qs = I32OF(ay[a0 + i0 - 1]);
            rs = I32OF(ax[a0 + i0 - 1]);
            for (l = k + 1; l < n && l <= k + max_ext_cnt; ++l) {
                int64_t j = K[l], diff;
                if (I32OF(ay[a0 + j]) - qs > max_ext_len
                    || I32OF(ax[a0 + j]) - rs > max_ext_len) break;
                g = (I32OF(ay[a0 + j]) - I32OF(ay[a0 + j - 1]))
                    - (I32OF(ax[a0 + j]) - I32OF(ax[a0 + j - 1]));
                if (g > 0) n_ins += g;
                else n_del += -g;
                diff = n_ins + n_del
                    - (n_ins > n_del ? n_ins - n_del : n_del - n_ins);
                if (max_diff < diff) max_diff = diff, max_diff_l = l;
            }
            if (max_diff > diff_thres && max_diff > mx)
                mx = max_diff, max_st = k, max_en = max_diff_l;
        }
    }
    free(K);
}

/* compensating-gap masking (map-algo.c:296-330 semantics) */
static void mask_compensating(int64_t a0, int64_t c0, const uint64_t *ax,
                              uint64_t *ay, int32_t min_gap,
                              int32_t max_ext)
{
    int64_t *K, n, k;
    if (c0 < 2) return;
    K = (int64_t *)malloc(8 * c0);
    n = collect_long_gaps(a0, c0, ax, ay, min_gap, K);
    if (n <= 1) { free(K); return; }
    for (k = 0; k < n;) {
        int64_t i0 = K[k], g1, re1, qe1, l;
        g1 = (I32OF(ay[a0 + i0]) - I32OF(ay[a0 + i0 - 1]))
            - (I32OF(ax[a0 + i0]) - I32OF(ax[a0 + i0 - 1]));
        re1 = I32OF(ax[a0 + i0]);
        qe1 = I32OF(ay[a0 + i0]);
        if (g1 < 0) g1 = -g1;
        for (l = k + 1; l < n; ++l) {
            int64_t j = K[l], g2, rs2, qs2, m, sp;
            if (I32OF(ay[a0 + j]) - qe1 > max_ext
                || I32OF(ax[a0 + j]) - re1 > max_ext) break;
            g2 = (I32OF(ay[a0 + j]) - I32OF(ay[a0 + j - 1]))
                - (I32OF(ax[a0 + j]) - I32OF(ax[a0 + j - 1]));
            sp = (int64_t)(ay[a0 + j - 1] >> 32 & 0xff);
            rs2 = I32OF(ax[a0 + j - 1]) + sp;
            qs2 = I32OF(ay[a0 + j - 1]) + sp;
            m = MIN2(rs2 - re1, qs2 - qe1);
            if (g2 < 0) g2 = -g2;
            if (m > g1 + g2) break;
            re1 = I32OF(ax[a0 + j]);
            qe1 = I32OF(ay[a0 + j]);
            g1 = g2;
        }
        if (l > k + 1) {
            int64_t end = K[l - 1], j;
            for (j = K[k]; j < end; ++j) ay[a0 + j] |= SEED_IGNORE;
            ay[a0 + end] |= SEED_FIXED;
        }
        k = l;
    }
    free(K);
}

/* the whole per-chain filter block; returns the trimmed (off, cnt) */
void mgt_chain_filters(const uint64_t *ax, uint64_t *ay,
                       int32_t lc_max_occ, int32_t lc_max_trim,
                       int32_t score, int32_t bw, int32_t min_match,
                       int32_t max_gap_half,
                       int64_t *off_io, int64_t *cnt_io)
{
    occ_trim(ay, lc_max_occ, lc_max_trim, off_io, cnt_io);
    score_shrink(ax, ay, score, bw, min_match, off_io, cnt_io);
    mask_unbalanced(*off_io, *cnt_io, ax, ay, 10, 40, max_gap_half, 10);
    mask_compensating(*off_io, *cnt_io, ax, ay, 30, max_gap_half);
}

/* gchain extras: qs/qe/ps/pe/plen/blen/mlen/n_mini accumulation over
 * one graph chain's lchains (gchain1.c:242-297 semantics, following
 * mapping/gchain.py's formulation).  div stays in Python (float
 * formatting parity).  Returns n_mini; scalars via out[]:
 * [qs, qe, ps, pe, plen, blen, mlen]. */
int64_t mgt_gchain_extra(const uint64_t *ax, const uint64_t *ay,
                         const int64_t *lc_v, const int64_t *lc_off,
                         const int64_t *lc_cnt, const int64_t *seg_len,
                         int64_t gc_off, int64_t gc_cnt,
                         int64_t *out)
{
    int64_t qs, qe, ps, pe, plen = 0, blen = 0, mlen = 0;
    int64_t j, first = lc_off[gc_off], q_span, n_mini, rest_pl = 0;
    int64_t last_x, last_y, tmp;
    const int64_t le = gc_off + gc_cnt - 1;
    int64_t last_off = lc_off[le] + lc_cnt[le] - 1;

    q_span = (int64_t)(ay[first] >> 32 & 0xff);
    qs = (int32_t)(uint32_t)ay[first] + 1 - q_span;
    ps = (int32_t)(uint32_t)ax[first] + 1 - q_span;
    tmp = (int64_t)(ax[first] >> 32);
    qe = (int32_t)(uint32_t)ay[last_off] + 1;
    pe = seg_len[lc_v[le] >> 1] - (int32_t)(uint32_t)ax[last_off] - 1;
    n_mini = (int64_t)(ax[last_off] >> 32) - tmp + 1;

    last_x = (int64_t)ax[first];
    last_y = (int64_t)ay[first];
    for (j = 0; j < gc_cnt; ++j) {
        const int64_t l = gc_off + j, vlen = seg_len[lc_v[l] >> 1];
        int64_t i;
        plen += vlen;
        if (lc_cnt[l] > 0) {
            for (i = 0; i < lc_cnt[l]; ++i) {
                const int64_t o = lc_off[l] + i;
                int64_t rx32 = (int32_t)(uint32_t)ax[o];
                int64_t ry32 = (int32_t)(uint32_t)ay[o];
                int64_t rxm = (int64_t)(ax[o] >> 32);
                int64_t span = (int64_t)(ay[o] >> 32 & 0xff);
                int64_t ql = ry32 - (int32_t)(uint32_t)last_y;
                int64_t pl = rx32 - (int32_t)(uint32_t)last_x;
                if (i == 0) {
                    if (j == 0) pl = ql = span;
                    else pl = rx32 + 1 + rest_pl;
                }
                if (ql < 0) {
                    n_mini += (int64_t)(last_x >> 32) - rxm;
                    ql = -ql;
                }
                blen += pl > ql ? pl : ql;
                mlen += (pl > span && ql > span) ? span
                    : (pl < ql ? pl : ql);
                last_x = (int64_t)ax[o];
                last_y = (int64_t)ay[o];
            }
            rest_pl = vlen
                - (int32_t)(uint32_t)ax[lc_off[l] + lc_cnt[l] - 1] - 1;
        } else {
            rest_pl += vlen;
        }
    }
    pe = plen - pe;
    out[0] = qs; out[1] = qe; out[2] = ps; out[3] = pe;
    out[4] = plen; out[5] = blen; out[6] = mlen;
    return n_mini;
}

/* Batched mg_gchain_extra (gchain1.c:242-297): one call per read.
 * out is (n_gc, 8): qs qe ps pe plen blen mlen n_mini; chains with
 * cnt == 0 get row[0] = INT64_MIN as a skip marker. */
void mgt_gchain_extra_all(const uint64_t *ax, const uint64_t *ay,
                          const int64_t *lc_v, const int64_t *lc_off,
                          const int64_t *lc_cnt, const int64_t *seg_len,
                          const int64_t *gc_off, const int64_t *gc_cnt,
                          int64_t n_gc, int64_t *out)
{
    int64_t i;
    for (i = 0; i < n_gc; ++i) {
        int64_t *row = out + i * 8;
        if (gc_cnt[i] == 0) {
            row[0] = INT64_MIN;
            continue;
        }
        row[7] = mgt_gchain_extra(ax, ay, lc_v, lc_off, lc_cnt, seg_len,
                                  gc_off[i], gc_cnt[i], row);
    }
}
