/* Linear anchor chaining — native host kernels.
 *
 * Exact-semantics implementations of the two chaining DP engines
 * (banded DP and RMQ long-range chaining over an augmented AVL), the
 * shared peak backtrack, and anchor compaction, matching the python
 * engines in mapping/lchain.py / lchain_rmq.py bit for bit (float32
 * penalties with the fast log2 approximation, int truncation, exact
 * radix tie order; compile with -ffp-contract=off).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

#define I32_MIN (-0x80000000LL)

extern void mgt_radix_sort_128x(uint64_t *a, int64_t n);

/* --dbg-lc-prof counters (lchain.c:153,209,361), read via ctypes */
int64_t mgt_lchain_stats[4];

/* Grow-only thread-local scratch: the chain engines run once or
 * twice per READ on the batch pool's worker threads, and a per-call
 * malloc/free of the f/p/t arrays plus the 48 B/anchor RMQ node pool
 * dominates the call cost for 2 kb reads (rescue fires on most lr
 * reads).  Slots are reused across the engines — one thread never
 * runs two chain calls concurrently. */
#define LC_TLS_SLOTS 6
static __thread void *lc_tls[LC_TLS_SLOTS];
static __thread int64_t lc_tls_cap[LC_TLS_SLOTS];

static void *lc_scratch(int slot, int64_t bytes)
{
    if (lc_tls_cap[slot] < bytes) {
        int64_t cap = bytes + (bytes >> 1);
        free(lc_tls[slot]);
        lc_tls[slot] = malloc((size_t)cap);
        lc_tls_cap[slot] = lc_tls[slot] ? cap : 0;
    }
    return lc_tls[slot];
}

void mgt_lchain_tls_free(void)
{
    int k;
    for (k = 0; k < LC_TLS_SLOTS; ++k) {
        free(lc_tls[k]);
        lc_tls[k] = 0;
        lc_tls_cap[k] = 0;
    }
}

static inline float mg_log2f(float x)
{
    union { float f; uint32_t i; } z = { x };
    float log_2 = (float)(int32_t)(((z.i >> 23) & 255) - 128);
    z.i &= ~(255u << 23);
    z.i += 127u << 23;
    log_2 += (-0.34484843f * z.f + 2.02466578f) * z.f - 0.67487759f;
    return log_2;
}

/* ----------------------------------------------------------------- */
/* transition scores                                                  */
/* ----------------------------------------------------------------- */

static inline int64_t comput_sc(uint64_t xi, uint64_t yi, uint64_t xj,
                                uint64_t yj, int32_t max_dist_x,
                                int32_t max_dist_y, int32_t bw,
                                float chn_pen_gap, float chn_pen_skip,
                                int is_cdna, int n_seg)
{
    int32_t dq = (int32_t)yi - (int32_t)yj, dr, dd, dg, q_span;
    int64_t sc;
    int32_t sidi = (int32_t)(yi >> 48 & 0xff), sidj = (int32_t)(yj >> 48 & 0xff);
    if (dq <= 0 || dq > max_dist_x) return I32_MIN;
    dr = (int32_t)(xi - xj);
    if (sidi == sidj && (dr == 0 || dq > max_dist_y)) return I32_MIN;
    dd = dr > dq ? dr - dq : dq - dr;
    if (sidi == sidj && dd > bw) return I32_MIN;
    if (n_seg > 1 && !is_cdna && sidi == sidj && dr > max_dist_y) return I32_MIN;
    dg = dr < dq ? dr : dq;
    q_span = (int32_t)(yj >> 32 & 0xff);
    sc = q_span < dg ? q_span : dg;
    if (dd || dg > q_span) {
        float lin_pen, log_pen;
        lin_pen = chn_pen_gap * (float)dd + chn_pen_skip * (float)dg;
        log_pen = dd >= 1 ? mg_log2f(dd + 1) : 0.0f;
        if (is_cdna || sidi != sidj) {
            if (sidi != sidj && dr == 0) ++sc;
            else if (dr > dq || sidi != sidj)
                sc -= (int)(lin_pen < log_pen ? lin_pen : log_pen);
            else sc -= (int)(lin_pen + .5f * log_pen);
        } else sc -= (int)(lin_pen + .5f * log_pen);
    }
    return sc;
}

static inline int64_t comput_sc_simple(uint64_t xi, uint64_t yi, uint64_t xj,
                                       uint64_t yj, float chn_pen_gap,
                                       float chn_pen_skip, int32_t *exact,
                                       int32_t *width)
{
    int32_t dq = (int32_t)yi - (int32_t)yj, dr, dd, dg, q_span;
    int64_t sc;
    dr = (int32_t)(xi - xj);
    *width = dd = dr > dq ? dr - dq : dq - dr;
    dg = dr < dq ? dr : dq;
    q_span = (int32_t)(yj >> 32 & 0xff);
    sc = q_span < dg ? q_span : dg;
    if (exact) *exact = (dd == 0 && dg <= q_span);
    if (dd || dq > q_span) {
        float lin_pen, log_pen;
        lin_pen = chn_pen_gap * (float)dd + chn_pen_skip * (float)dg;
        log_pen = dd >= 1 ? mg_log2f(dd + 1) : 0.0f;
        sc -= (int)(lin_pen + .5f * log_pen);
    }
    return sc;
}

/* ----------------------------------------------------------------- */
/* peak backtrack + compaction (mg_chain_backtrack / compact_a        */
/* semantics, lchain.c:27-112), restructured: chain starts are        */
/* processed best-score-first; each start gets a READ-ONLY probe walk */
/* down its parent chain to locate the peak cut (the anchor where the */
/* running score-drop exceeds max_drop, or a previously claimed       */
/* anchor), then a commit walk claims the anchors.  Parents are       */
/* strictly decreasing, so a walk can never revisit its own path and  */
/* a plain claimed[] bitmap replaces the reference's tri-state t[].   */
/* ----------------------------------------------------------------- */

/* probe: walk parents from `start` (whose DP score is `sc_start`),
 * return the cut anchor (-1 = chain root) maximizing the score of the
 * suffix chain start..cut, stopping on drop > max_drop or on a
 * claimed anchor. */
static int64_t peak_cut(int64_t start, uint64_t sc_start, const int64_t *f,
                        const int64_t *p, const uint8_t *claimed,
                        int32_t max_drop)
{
    int64_t at = start, best_at = start, best_s = 0;
    for (;;) {
        int64_t s;
        at = p[at];
        s = at < 0 ? (int64_t)sc_start
                   : (int64_t)(int32_t)(uint32_t)sc_start - f[at];
        if (s > best_s) best_s = s, best_at = at;
        else if (best_s - s > max_drop) break;
        if (at < 0 || claimed[at]) break;
    }
    return best_at;
}

/* returns n_v; fills u (score<<32|cnt) and v (anchor indices) */
int64_t mgt_chain_backtrack_core(int64_t n, const int64_t *f, const int64_t *p,
                               int32_t min_cnt, int32_t min_sc,
                               int32_t max_drop, uint64_t *u, int32_t *n_u_,
                               int64_t *v)
{
    int64_t i, k, n_z = 0, n_v = 0;
    int32_t n_u = 0;
    uint64_t *z;
    uint8_t *claimed;

    *n_u_ = 0;
    for (i = 0; i < n; ++i) n_z += (f[i] >= min_sc);
    if (n_z == 0) return 0;
    /* candidate starts keyed by DP score; the radix permutation must
     * match the reference's, so reuse the same 128-bit sorter */
    z = (uint64_t *)malloc(16 * n_z);
    for (i = 0, k = 0; i < n; ++i)
        if (f[i] >= min_sc) z[2 * k] = (uint64_t)f[i], z[2 * k + 1] = i, ++k;
    mgt_radix_sort_128x(z, n_z);
    claimed = (uint8_t *)calloc(n, 1);

    for (k = n_z - 1; k >= 0; --k) {
        int64_t start = (int64_t)z[2 * k + 1], cut, sc, n_v0 = n_v;
        if (claimed[start]) continue;
        cut = peak_cut(start, z[2 * k], f, p, claimed, max_drop);
        for (i = start; i != cut; i = p[i]) v[n_v++] = i, claimed[i] = 1;
        sc = cut < 0 ? (int64_t)z[2 * k]
                     : (int64_t)(int32_t)(uint32_t)z[2 * k] - f[cut];
        if (sc >= min_sc && n_v - n_v0 >= min_cnt && n_v > n_v0)
            u[n_u++] = (uint64_t)sc << 32 | (uint64_t)(n_v - n_v0);
        else  /* rejected chains keep their claims (lchain.c:63-66) */
            n_v = n_v0;
    }
    free(z); free(claimed);
    *n_u_ = n_u;
    return n_v;
}

/* reorder anchors chain-by-chain (each chain's v entries are in
 * backwards order), then sort whole chains by first-anchor x.  Uses a
 * per-chain offset table + one gather loop instead of the reference's
 * staged copies. */
static void compact_a(int32_t n_u, uint64_t *u, int64_t n_v, const int64_t *v,
                      uint64_t *ax, uint64_t *ay)
{
    int64_t *coff = (int64_t *)malloc(8 * ((int64_t)n_u + 1));
    uint64_t *w = (uint64_t *)malloc(16 * (n_u ? n_u : 1));
    uint64_t *bx = (uint64_t *)malloc(8 * n_v);
    uint64_t *by = (uint64_t *)malloc(8 * n_v);
    uint64_t *u2 = (uint64_t *)malloc(8 * (n_u ? n_u : 1));
    int64_t c, j, k;

    coff[0] = 0;
    for (c = 0; c < n_u; ++c) coff[c + 1] = coff[c] + (int32_t)u[c];
    /* chains keyed by their first anchor's x (= the LAST v entry of
     * the chain's block); payload = chain id + source offset */
    for (c = 0; c < n_u; ++c) {
        w[2 * c] = ax[v[coff[c + 1] - 1]];
        w[2 * c + 1] = (uint64_t)coff[c] << 32 | (uint64_t)c;
    }
    mgt_radix_sort_128x(w, n_u);
    for (c = 0, k = 0; c < n_u; ++c) {
        int64_t src0 = (int64_t)(w[2 * c + 1] >> 32);
        int64_t id = (int32_t)w[2 * c + 1], len = (int32_t)u[id];
        u2[c] = u[id];
        for (j = len - 1; j >= 0; --j) {   /* reverse: v is backwards */
            bx[k] = ax[v[src0 + j]];
            by[k] = ay[v[src0 + j]];
            ++k;
        }
    }
    memcpy(u, u2, 8 * n_u);
    memcpy(ax, bx, 8 * n_v);
    memcpy(ay, by, 8 * n_v);
    free(coff); free(w); free(bx); free(by); free(u2);
}

/* ----------------------------------------------------------------- */
/* banded DP chaining (mg_lchain_dp semantics, lchain.c:149-219)      */
/*                                                                    */
/* Restructured around this repo's window formulation (see            */
/* ops/chain_exact.py for the derivation):                            */
/*   window    the predecessor candidates of anchor i are exactly     */
/*             [lo, i) where lo is found by BINARY SEARCH for the     */
/*             first same-vertex anchor within max_dist_x (anchors    */
/*             are x-sorted so the vertex block is contiguous),       */
/*             clamped by the iteration cap;                          */
/*   chunks    candidates are scored into a buffer CHUNK at a time    */
/*             (vector-friendly), then a replay pass runs the skip    */
/*             state machine over the chunk and stops the scan at     */
/*             the reference's early-break point;                     */
/*   marks     child marks use an epoch array stamped with i — a      */
/*             candidate only counts as a "skip" if some already-     */
/*             replayed valid candidate named it as parent;           */
/*   cache     the long-range candidate cache is, by construction,    */
/*             always inside the distance window when live (it is     */
/*             refreshed whenever it falls out), which reduces the    */
/*             staleness test to an index comparison.                 */
/* ----------------------------------------------------------------- */

#define LC_CHUNK 32

int64_t mgt_lchain_dp(int32_t max_dist_x, int32_t max_dist_y, int32_t bw,
                      int32_t max_skip, int32_t max_iter, int32_t min_cnt,
                      int32_t min_sc, float chn_pen_gap, float chn_pen_skip,
                      int32_t is_cdna, int32_t n_seg, int64_t n,
                      uint64_t *ax, uint64_t *ay, uint64_t *u_out,
                      int32_t *n_u_out)
{
    int64_t *p, *f, *vv, i, n_v;
    int64_t blk = 0;          /* start of the current (rid,rev) block */
    int64_t cache = -1;       /* argmax-f cache (max_ii analog)       */
    int32_t *mark;            /* epoch array: mark[j] == i  <=>  t[j] */
    int32_t n_u, max_drop = bw;
    int64_t n_iter = 0, mmax_f = 0;

    *n_u_out = 0;
    if (n == 0) return 0;
    if (max_dist_x < bw) max_dist_x = bw;
    if (max_dist_y < bw && !is_cdna) max_dist_y = bw;
    if (is_cdna) max_drop = 0x7fffffff;
    p = (int64_t *)lc_scratch(0, 8 * n);
    f = (int64_t *)lc_scratch(1, 8 * n);
    vv = (int64_t *)lc_scratch(5, 8 * n);
    mark = (int32_t *)lc_scratch(2, 4 * n);
    memset(mark, 0xff, 4 * n);

    for (i = 0; i < n; ++i) {
        int64_t best = (int64_t)(ay[i] >> 32 & 0xff), best_j = -1;
        int64_t lo_d, lo, stop, j;
        int32_t pending = 0;

        if (ax[i] >> 32 != ax[blk] >> 32) blk = i;
        /* first same-vertex anchor with ax[i] - ax[j] <= max_dist_x */
        {
            int64_t l = blk, r = i;
            while (l < r) {
                int64_t m = (l + r) >> 1;
                if (ax[i] > ax[m] + (uint64_t)max_dist_x) l = m + 1;
                else r = m;
            }
            lo_d = l;
        }
        lo = i - lo_d > max_iter ? i - max_iter : lo_d;

        /* descending scan from i-1; stop = anchor where the scan
         * broke (exclusive), or lo when it ran dry.  Single pass:
         * score + decision fused per candidate so nothing past the
         * skip break is ever scored. */
        stop = lo - 1;
        for (j = i - 1; j >= lo; --j) {
            int64_t sc, tot;
            ++n_iter;
            sc = comput_sc(ax[i], ay[i], ax[j], ay[j],
                           max_dist_x, max_dist_y, bw,
                           chn_pen_gap, chn_pen_skip,
                           is_cdna, n_seg);
            if (sc == I32_MIN) continue;
            tot = sc + f[j];
            if (tot > best) {
                best = tot, best_j = j;
                if (pending > 0) --pending;
            } else if (mark[j] == (int32_t)i) {
                if (++pending > max_skip) { stop = j; break; }
            }
            if (p[j] >= 0) mark[p[j]] = (int32_t)i;
        }

        /* long-range candidate cache (max_ii, lchain.c:191-204): a
         * live cache is always >= lo_d, so staleness is an index test */
        if (cache < lo_d) {
            int64_t fbest = I32_MIN;
            cache = -1;
            /* ascending with >=: ties keep the LARGEST index, matching
             * the reference's descending strict-< scan */
            for (j = lo; j < i; ++j)
                if (f[j] >= fbest) fbest = f[j], cache = j;
        }
        if (cache >= 0 && cache < stop) {
            int64_t tmp = comput_sc(ax[i], ay[i], ax[cache], ay[cache],
                                    max_dist_x, max_dist_y, bw, chn_pen_gap,
                                    chn_pen_skip, is_cdna, n_seg);
            if (tmp != I32_MIN && best < tmp + f[cache])
                best = tmp + f[cache], best_j = cache;
        }
        f[i] = best, p[i] = best_j;
        if (cache < 0 || f[cache] < best) cache = i;
        if (mmax_f < best) mmax_f = best;
    }
    mgt_lchain_stats[0] = n_iter;
    mgt_lchain_stats[1] = mmax_f;
    mgt_lchain_stats[2] = mgt_lchain_stats[3] = 0;

    n_v = mgt_chain_backtrack_core(n, f, p, min_cnt, min_sc, max_drop, u_out, &n_u,
                          vv);
    if (n_u > 0) compact_a(n_u, u_out, n_v, vv, ax, ay);
    *n_u_out = n_u;
    return n_u == 0 ? 0 : n_v;
}

/* ----------------------------------------------------------------- */
/* krmq: AVL with subtree size + subtree-min (utils/krmq.py port)     */
/* ----------------------------------------------------------------- */

typedef struct rnode_s {
    int32_t y;
    int64_t i;
    double pri;
    struct rnode_s *p[2], *s;
    signed char balance;
    uint32_t size;
} rnode_t;

typedef struct {
    rnode_t *pool;
    rnode_t **freev;
    int64_t n_pool, n_free;
} rpool_t;

static inline int rcmp(int32_t ay2, int64_t ai, const rnode_t *b)
{
    if (ay2 != b->y) return ay2 < b->y ? -1 : 1;
    if (ai != b->i) return ai < b->i ? -1 : 1;
    return 0;
}

#define RSIZE(q) ((q) ? (q)->size : 0u)

static inline void r_update_min(rnode_t *p, const rnode_t *q, const rnode_t *r)
{
    p->s = (!q || p->pri < q->s->pri) ? p : q->s;
    p->s = (!r || p->s->pri < r->s->pri) ? p->s : r->s;
}

static rnode_t *r_rotate1(rnode_t *p, int dir)
{
    int opp = 1 - dir;
    rnode_t *q = p->p[opp], *s = p->s;
    uint32_t size_p = p->size;
    p->size -= q->size - RSIZE(q->p[dir]);
    q->size = size_p;
    r_update_min(p, p->p[dir], q->p[dir]);
    q->s = s;
    p->p[opp] = q->p[dir];
    q->p[dir] = p;
    return q;
}

static rnode_t *r_rotate2(rnode_t *p, int dir)
{
    int b1, opp = 1 - dir;
    rnode_t *q = p->p[opp], *r = q->p[dir], *s = p->s;
    uint32_t size_x_dir = RSIZE(r->p[dir]);
    r->size = p->size;
    p->size -= q->size - size_x_dir;
    q->size -= size_x_dir + 1;
    r_update_min(p, p->p[dir], r->p[dir]);
    r_update_min(q, q->p[opp], r->p[opp]);
    r->s = s;
    p->p[opp] = r->p[dir];
    r->p[dir] = p;
    q->p[dir] = r->p[opp];
    r->p[opp] = q;
    b1 = dir == 0 ? +1 : -1;
    if (r->balance == b1) q->balance = 0, p->balance = -b1;
    else if (r->balance == 0) q->balance = p->balance = 0;
    else q->balance = b1, p->balance = 0;
    r->balance = 0;
    return r;
}

#define RMQ_MAX_DEPTH 64

static rnode_t *r_insert(rnode_t **root_, rnode_t *x)
{
    unsigned char stack[RMQ_MAX_DEPTH];
    rnode_t *path[RMQ_MAX_DEPTH];
    rnode_t *bp, *bq, *p, *q, *r = 0;
    int i, which = 0, top, b1, path_len;
    bp = *root_, bq = 0;
    for (p = bp, q = bq, top = path_len = 0; p;
         q = p, p = p->p[which]) {
        int cmp = rcmp(x->y, x->i, p);
        if (cmp == 0) return p;
        if (p->balance != 0) bq = q, bp = p, top = 0;
        stack[top++] = which = (cmp > 0);
        path[path_len++] = p;
    }
    x->balance = 0, x->size = 1, x->p[0] = x->p[1] = 0, x->s = x;
    if (q == 0) *root_ = x;
    else q->p[which] = x;
    if (bp == 0) return x;
    for (i = 0; i < path_len; ++i) ++path[i]->size;
    for (i = path_len - 1; i >= 0; --i) {
        r_update_min(path[i], path[i]->p[0], path[i]->p[1]);
        if (path[i]->s != x) break;
    }
    for (p = bp, top = 0; p != x; p = p->p[stack[top]], ++top)
        if (stack[top] == 0) --p->balance;
        else ++p->balance;
    if (bp->balance > -2 && bp->balance < 2) return x;
    which = (bp->balance < 0);
    b1 = which == 0 ? +1 : -1;
    q = bp->p[1 - which];
    if (q->balance == b1) {
        r = r_rotate1(bp, which);
        q->balance = bp->balance = 0;
    } else r = r_rotate2(bp, which);
    if (bq == 0) *root_ = r;
    else bq->p[bp != bq->p[0]] = r;
    return x;
}

/* Root-to-node path iterator for in-order predecessor walks.  The
 * rescue inner loop steps backwards ~3 nodes per anchor on average;
 * a fresh root descent per step costs O(log n) compares each, while
 * the retained path makes each step amortized O(1) (the walk never
 * mutates the tree, so the path stays valid). */
typedef struct {
    rnode_t *path[RMQ_MAX_DEPTH];
    int top;                      /* path[0..top] = root..current */
} riter_t;

/* Seat the iterator at the greatest node <= (y,i); 0 if none. */
static rnode_t *r_iter_le(rnode_t *root, int32_t y, int64_t i, riter_t *it)
{
    rnode_t *p = root;
    int last_lt = -1;             /* deepest ancestor < key */
    it->top = -1;
    while (p) {
        int cmp = rcmp(y, i, p);
        it->path[++it->top] = p;
        if (cmp < 0) p = p->p[0];
        else if (cmp > 0) { last_lt = it->top; p = p->p[1]; }
        else return p;
    }
    it->top = last_lt;
    return last_lt < 0 ? 0 : it->path[last_lt];
}

/* Step to the in-order predecessor; 0 once the minimum is passed. */
static rnode_t *r_iter_prev(riter_t *it)
{
    rnode_t *p;
    if (it->top < 0) return 0;
    p = it->path[it->top];
    if (p->p[0]) {                /* rightmost of the left subtree */
        for (p = p->p[0]; ; p = p->p[1]) {
            it->path[++it->top] = p;
            if (!p->p[1]) return p;
        }
    }
    while (it->top > 0 && it->path[it->top - 1]->p[0] == it->path[it->top])
        --it->top;                /* climb out of left chains */
    if (it->top == 0) { it->top = -1; return 0; }
    --it->top;
    return it->path[it->top];
}

static rnode_t *r_erase(rnode_t **root_, const rnode_t *x)
{
    rnode_t *p, *path[RMQ_MAX_DEPTH], fake;
    unsigned char dir[RMQ_MAX_DEPTH];
    int i, d = 0, cmp;
    if (*root_ == 0) return 0;
    fake = **root_, fake.p[0] = *root_, fake.p[1] = 0;
    cmp = -1;
    p = &fake;
    while (cmp != 0) {
        int which = (cmp > 0);
        dir[d] = which;
        path[d++] = p;
        p = p->p[which];
        if (p == 0) return 0;
        cmp = rcmp(x->y, x->i, p);
    }
    for (i = 1; i < d; ++i) --path[i]->size;
    if (p->p[1] == 0) {
        path[d - 1]->p[dir[d - 1]] = p->p[0];
    } else {
        rnode_t *q = p->p[1];
        if (q->p[0] == 0) {
            q->p[0] = p->p[0];
            q->balance = p->balance;
            path[d - 1]->p[dir[d - 1]] = q;
            path[d] = q, dir[d++] = 1;
            q->size = p->size - 1;
        } else {
            rnode_t *r;
            int e = d++;
            for (;;) {
                dir[d] = 0;
                path[d++] = q;
                r = q->p[0];
                if (r->p[0] == 0) break;
                q = r;
            }
            r->p[0] = p->p[0];
            q->p[0] = r->p[1];
            r->p[1] = p->p[1];
            r->balance = p->balance;
            path[e - 1]->p[dir[e - 1]] = r;
            path[e] = r, dir[e] = 1;
            for (i = e + 1; i < d; ++i) --path[i]->size;
            r->size = p->size - 1;
        }
    }
    for (i = d - 1; i >= 0; --i)
        r_update_min(path[i], path[i]->p[0], path[i]->p[1]);
    while (--d > 0) {
        rnode_t *q = path[d];
        int which, other, b1 = 1, b2 = 2;
        which = dir[d], other = 1 - which;
        if (which) b1 = -b1, b2 = -b2;
        q->balance += b1;
        if (q->balance == b1) break;
        else if (q->balance == b2) {
            rnode_t *r = q->p[other];
            if (r->balance == -b1) {
                path[d - 1]->p[dir[d - 1]] = r_rotate2(q, which);
            } else {
                path[d - 1]->p[dir[d - 1]] = r_rotate1(q, which);
                if (r->balance == 0) {
                    r->balance = -b1;
                    q->balance = b1;
                    break;
                } else r->balance = q->balance = 0;
            }
        }
    }
    *root_ = fake.p[0];
    return p;
}

static rnode_t *r_rmq(rnode_t *root, int32_t lo_y, int64_t lo_i,
                      int32_t hi_y, int64_t hi_i)
{
    const rnode_t *p = root, *path[2][RMQ_MAX_DEPTH], *mn;
    int plen[2] = {0, 0}, pcmp[2][RMQ_MAX_DEPTH], i, cmp, lca;
    if (root == 0) return 0;
    while (p) {
        cmp = rcmp(lo_y, lo_i, p);
        path[0][plen[0]] = p, pcmp[0][plen[0]++] = cmp;
        if (cmp < 0) p = p->p[0];
        else if (cmp > 0) p = p->p[1];
        else break;
    }
    p = root;
    while (p) {
        cmp = rcmp(hi_y, hi_i, p);
        path[1][plen[1]] = p, pcmp[1][plen[1]++] = cmp;
        if (cmp < 0) p = p->p[0];
        else if (cmp > 0) p = p->p[1];
        else break;
    }
    for (i = 0; i < plen[0] && i < plen[1]; ++i)
        if (path[0][i] == path[1][i] && pcmp[0][i] <= 0 && pcmp[1][i] >= 0)
            break;
    if (i == plen[0] || i == plen[1]) return 0;
    lca = i, mn = path[0][lca];
    for (i = lca + 1; i < plen[0]; ++i) {
        if (pcmp[0][i] <= 0) {
            if (path[0][i]->pri < mn->pri) mn = path[0][i];
            if (path[0][i]->p[1] && path[0][i]->p[1]->s->pri < mn->pri)
                mn = path[0][i]->p[1]->s;
        }
    }
    for (i = lca + 1; i < plen[1]; ++i) {
        if (pcmp[1][i] >= 0) {
            if (path[1][i]->pri < mn->pri) mn = path[1][i];
            if (path[1][i]->p[0] && path[1][i]->p[0]->s->pri < mn->pri)
                mn = path[1][i]->p[0]->s;
        }
    }
    return (rnode_t *)mn;
}

/* ----------------------------------------------------------------- */
/* RMQ chaining (mg_lchain_rmq semantics)                             */
/* ----------------------------------------------------------------- */

int64_t mgt_lchain_rmq(int32_t max_dist, int32_t max_dist_inner, int32_t bw,
                       int32_t max_chn_skip, int32_t cap_rmq_size,
                       int32_t min_cnt, int32_t min_sc, float chn_pen_gap,
                       float chn_pen_skip, int64_t n, uint64_t *ax,
                       uint64_t *ay, uint64_t *u_out, int32_t *n_u_out)
{
    int64_t *p, *f, i, i0, st = 0, st_inner = 0, n_v;
    int32_t *t, n_u;
    int64_t *vv;
    rnode_t *root = 0, *root_inner = 0;
    rnode_t *pool;
    int64_t pool_n = 0;
    rnode_t **freelist;
    int64_t nfree = 0;
    int use_inner;
    double gap_d;

    *n_u_out = 0;
    if (n == 0) return 0;
    if (max_dist < bw) max_dist = bw;
    if (max_dist_inner <= 0 || max_dist_inner >= max_dist) max_dist_inner = 0;
    use_inner = max_dist_inner > 0;
    p = (int64_t *)lc_scratch(0, 8 * n);
    f = (int64_t *)lc_scratch(1, 8 * n);
    t = (int32_t *)lc_scratch(2, 4 * n);
    for (i = 0; i < n; ++i) t[i] = -1;
    pool = (rnode_t *)lc_scratch(3, sizeof(rnode_t) * 2 * (n + 1));
    freelist = (rnode_t **)lc_scratch(4, sizeof(rnode_t *) * 2 * (n + 1));
    gap_d = (double)chn_pen_gap;

    int64_t n_iter = 0, mmax_f = 0, max_rmq_size = 0;
    int64_t live = 0, max_live = 0;
#define POOL_TAKE() (live++, (live > max_live ? (max_live = live) : 0), \
                     nfree ? freelist[--nfree] : &pool[pool_n++])
#define POOL_FREE(q) (live--, freelist[nfree++] = (q))
    for (i = i0 = 0; i < n; ++i) {
        int64_t max_j = -1;
        int64_t q_span = (int64_t)(ay[i] >> 32 & 0xff), max_f = q_span;
        rnode_t *q;
        if (i0 < i && ax[i0] != ax[i]) {
            int64_t j;
            for (j = i0; j < i; ++j) {
                double pri = -((double)f[j]
                               + 0.5 * gap_d * ((double)(int32_t)ax[j]
                                                + (double)(int32_t)ay[j]));
                q = POOL_TAKE();
                q->y = (int32_t)ay[j], q->i = j, q->pri = pri;
                r_insert(&root, q);
                if (use_inner) {
                    rnode_t *r2 = POOL_TAKE();
                    r2->y = (int32_t)ay[j], r2->i = j, r2->pri = pri;
                    r_insert(&root_inner, r2);
                }
            }
            i0 = i;
        }
        while (st < i && (ax[i] >> 32 != ax[st] >> 32
                          || ax[i] > ax[st] + (uint64_t)max_dist
                          || RSIZE(root) > (uint32_t)cap_rmq_size)) {
            rnode_t key;
            key.y = (int32_t)ay[st], key.i = st;
            q = r_erase(&root, &key);
            if (q) POOL_FREE(q);
            ++st;
        }
        if (use_inner) {
            while (st_inner < i
                   && (ax[i] >> 32 != ax[st_inner] >> 32
                       || ax[i] > ax[st_inner] + (uint64_t)max_dist_inner
                       || RSIZE(root_inner) > (uint32_t)cap_rmq_size)) {
                rnode_t key;
                key.y = (int32_t)ay[st_inner], key.i = st_inner;
                q = r_erase(&root_inner, &key);
                if (q) POOL_FREE(q);
                ++st_inner;
            }
        }
        q = r_rmq(root, (int32_t)ay[i] - max_dist, INT32_MAX,
                  (int32_t)ay[i] - 1, 0);
        if (q) {
            int32_t exact, width, n_skip = 0;
            int64_t j = q->i, sc;
            sc = f[j] + comput_sc_simple(ax[i], ay[i], ax[j], ay[j],
                                         chn_pen_gap, chn_pen_skip, &exact,
                                         &width);
            if (width <= bw && sc > max_f) max_f = sc, max_j = j;
            if (!exact && root_inner && (int32_t)ay[i] > 0) {
                riter_t it;
                rnode_t *lo = r_iter_le(root_inner, (int32_t)ay[i] - 1, n,
                                        &it);
                if (lo) {
                    rnode_t *qq = lo;
                    while (qq) {
                        if (qq->y < (int32_t)ay[i] - max_dist_inner) break;
                        ++n_iter;
                        j = qq->i;
                        sc = f[j] + comput_sc_simple(ax[i], ay[i], ax[j],
                                                     ay[j], chn_pen_gap,
                                                     chn_pen_skip, 0, &width);
                        if (width <= bw) {
                            if (sc > max_f) {
                                max_f = sc, max_j = j;
                                if (n_skip > 0) --n_skip;
                            } else if (t[j] == (int32_t)i) {
                                if (++n_skip > max_chn_skip) break;
                            }
                            if (p[j] >= 0) t[p[j]] = (int32_t)i;
                        }
                        qq = r_iter_prev(&it);
                    }
                }
            }
        }
        f[i] = max_f, p[i] = max_j;
        if (mmax_f < max_f) mmax_f = max_f;
        if ((int64_t)RSIZE(root) > max_rmq_size)
            max_rmq_size = (int64_t)RSIZE(root);
    }
    mgt_lchain_stats[0] = n_iter;
    mgt_lchain_stats[1] = mmax_f;
    mgt_lchain_stats[2] = max_rmq_size;
    mgt_lchain_stats[3] = max_live;

    vv = (int64_t *)lc_scratch(5, 8 * n);
    n_v = mgt_chain_backtrack_core(n, f, p, min_cnt, min_sc, bw, u_out, &n_u, vv);
    if (n_u > 0) compact_a(n_u, u_out, n_v, vv, ax, ay);
    *n_u_out = n_u;
    return n_u == 0 ? 0 : n_v;
}

/* Finish the DP from device-computed f/p arrays (ops/chain_exact.py):
 * peak backtrack + chain compaction only.  Same contract as
 * mgt_lchain_dp's tail; f/p are int32 from the device. */
int64_t mgt_lchain_finish(int32_t bw, int32_t is_cdna, int32_t min_cnt,
                          int32_t min_sc, int64_t n, const int32_t *f32v,
                          const int32_t *p32, uint64_t *ax, uint64_t *ay,
                          uint64_t *u_out, int32_t *n_u_out)
{
    int64_t *f, *p, *vv, i, n_v;
    int32_t n_u, max_drop = is_cdna ? 0x7fffffff : bw;

    *n_u_out = 0;
    if (n == 0) return 0;
    f = (int64_t *)lc_scratch(0, 8 * n);
    p = (int64_t *)lc_scratch(1, 8 * n);
    vv = (int64_t *)lc_scratch(5, 8 * n);
    for (i = 0; i < n; ++i) f[i] = f32v[i], p[i] = p32[i];
    n_v = mgt_chain_backtrack_core(n, f, p, min_cnt, min_sc, max_drop, u_out, &n_u,
                          vv);
    if (n_u > 0) compact_a(n_u, u_out, n_v, vv, ax, ay);
    *n_u_out = n_u;
    return n_u == 0 ? 0 : n_v;
}
