/* Graph wavefront alignment (GWFA) — native host kernel.
 *
 * Edit-distance alignment of a query against a sequence graph,
 * semantics-equal to the framework's python engine (align/gwfa_exact.py)
 * and the reference behavior it reproduces: diagonal wavefronts with
 * exact-match extension within and across vertices, forbidden-band
 * bookkeeping for finished vertex-diagonals, out-of-order-aware dedup
 * with exact radix tie order, lag/band pruning, and a traceback of the
 * vertex walk.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#define GWF_SHIFT 0x40000000
#define U32M 0xFFFFFFFFu

typedef struct { uint64_t vd; int32_t k; uint32_t xo; int32_t t; } gdiag_t;
typedef struct { uint64_t vd0, vd1; } gintv_t;
typedef struct { int32_t n, m; gdiag_t *a; } gdiag_v;
typedef struct { int32_t n, m; gintv_t *a; } gintv_v;
typedef struct { int32_t v, pre; } gtrace_t;

typedef struct {   /* graph view (vertex-oriented) */
    int64_t *arc_start;
    int32_t *arc_cnt;
    uint32_t *arc_w;
    int32_t *arc_ow;
    int64_t *seq_off;
    int32_t *seq_len;
    const char *seq;
} ggraph_t;

/* OOM inside the engine must not dereference NULL: failed grows set
 * this per-thread flag, the push is dropped, and mgt_gwfa_ed reports
 * -2 so the caller takes the exact fallback path. */
static __thread int gwf_oom;

static void *gwf_grow(void *p, size_t sz)
{
    void *np = realloc(p, sz);
    if (!np) gwf_oom = 1;
    return np ? np : p;
}

static inline uint64_t gen_vd(uint32_t v, int32_t d)
{
    return (uint64_t)v << 32 | (uint32_t)(GWF_SHIFT + d);
}

static void gd_push(gdiag_v *a, uint32_t v, int32_t d, int32_t k,
                    uint32_t x, uint32_t ooo, int32_t t)
{
    gdiag_t *p;
    if (a->n == a->m) {
        int64_t m2 = a->m + (a->m >> 1) + 16;
        a->a = (gdiag_t *)gwf_grow(a->a, sizeof(gdiag_t) * m2);
        if (gwf_oom) return;
        a->m = m2;
    }
    p = &a->a[a->n++];
    p->vd = gen_vd(v, d), p->k = k, p->xo = x << 1 | ooo, p->t = t;
}

static inline int gd_update(gdiag_t *p, uint32_t v, int32_t d, int32_t k,
                            uint32_t x, uint32_t ooo, int32_t t)
{
    uint64_t vd = gen_vd(v, d);
    if (p->vd == vd) {
        if (!(p->k > k)) p->xo = x << 1 | ooo, p->t = t, p->k = k;
        return 0;
    }
    return 1;
}

static void gi_push(gintv_v *a, uint64_t vd0)
{
    gintv_t *p;
    if (a->n == a->m) {
        int64_t m2 = a->m + (a->m >> 1) + 16;
        a->a = (gintv_t *)gwf_grow(a->a, sizeof(gintv_t) * m2);
        if (gwf_oom) return;
        a->m = m2;
    }
    p = &a->a[a->n++];
    p->vd0 = vd0, p->vd1 = vd0 + 1;
}

/* ---- exact-order radix argsort (shared semantics with mgt_core.c) ---- */
typedef struct { uint64_t key, val; } gpair_t;
extern void mgt_radix_sort_128x(uint64_t *a, int64_t n);

/* ---- simple open-addressing uint64 hash set / map ----
 * Generation-stamped: gh_clear is O(1) (the visited set is cleared
 * every wavefront step, and a memset over the grown capacity used to
 * dominate the bridge engine). */
typedef struct {
    uint64_t *keys;
    int32_t *vals, *gen;
    int64_t cap, n;
    int32_t cur;
} ghash_t;

static void gh_init(ghash_t *h, int64_t cap0)
{
    int64_t c = 16;
    while (c < cap0 * 2) c <<= 1;
    h->cap = c, h->n = 0, h->cur = 1;
    h->keys = (uint64_t *)malloc(sizeof(uint64_t) * c);
    h->vals = (int32_t *)malloc(sizeof(int32_t) * c);
    h->gen = (int32_t *)calloc(c, sizeof(int32_t));
    if (!h->keys || !h->vals || !h->gen) gwf_oom = 1;
}

static void gh_free(ghash_t *h)
{
    free(h->keys); free(h->vals); free(h->gen);
}

static void gh_clear(ghash_t *h)
{
    h->n = 0;
    if (++h->cur == 0x7FFFFFFF) {
        memset(h->gen, 0, sizeof(int32_t) * h->cap);
        h->cur = 1;
    }
}

static inline uint64_t gh_hash(uint64_t k)
{
    k *= 0x9E3779B97F4A7C15ULL;
    return k ^ (k >> 29);
}

static int64_t gh_put(ghash_t *h, uint64_t key, int *absent);

static void gh_grow(ghash_t *h)
{
    ghash_t nh;
    int64_t i;
    gh_init(&nh, h->cap);
    for (i = 0; i < h->cap; ++i)
        if (h->gen[i] == h->cur) {
            int ab;
            int64_t j = gh_put(&nh, h->keys[i], &ab);
            nh.vals[j] = h->vals[i];
        }
    gh_free(h);
    *h = nh;
}

static int64_t gh_put(ghash_t *h, uint64_t key, int *absent)
{
    int64_t mask, i;
    if (h->n * 4 >= h->cap * 3) gh_grow(h);
    mask = h->cap - 1;
    i = gh_hash(key) & mask;
    while (h->gen[i] == h->cur && h->keys[i] != key)
        i = (i + 1) & mask;
    *absent = (h->gen[i] != h->cur);
    if (*absent) h->keys[i] = key, h->gen[i] = h->cur, ++h->n;
    return i;
}

/* ---- engine state ---- */
typedef struct {
    const ggraph_t *g;
    int32_t ql;
    const char *q;
    int32_t traceback, max_chk, bw_dyn, max_lag;
    int64_t i_term;
    int32_t s;
    gdiag_v a;
    gdiag_v As, Bs;     /* per-step scratch, reused across steps */
    gdiag_t *bb;        /* extend_batch neighbour-wave scratch */
    int32_t bb_m;
    gdiag_t *db, *dc;   /* dedup split scratch */
    uint64_t *dpairs;
    int32_t db_m;
    gintv_v intv, tmp;
    gintv_v intv_spare; /* ping-pong buffer for the interval merge */
    ghash_t ha;    /* (w, i) visited */
    ghash_t ht;    /* trace (v,pre) -> idx */
    gtrace_t *trace;
    int32_t n_trace, m_trace;
    int32_t end_tb;
} gwf_t;

static int32_t trace_push(gwf_t *z, int32_t v, int32_t pre)
{
    int absent;
    uint64_t key = (uint64_t)(uint32_t)v << 32 | (uint32_t)pre;
    int64_t i = gh_put(&z->ht, key, &absent);
    if (absent) {
        if (z->n_trace == z->m_trace) {
            z->m_trace += (z->m_trace >> 1) + 16;
            z->trace = (gtrace_t *)realloc(z->trace,
                                           sizeof(gtrace_t) * z->m_trace);
        }
        z->trace[z->n_trace].v = v;
        z->trace[z->n_trace].pre = pre;
        z->ht.vals[i] = z->n_trace;
        return z->n_trace++;
    }
    return z->ht.vals[i];
}

/* Length of the longest common prefix of a[0..n) and b[0..n).
 * Bulk of the scan runs on 8-byte words (memcpy keeps the loads
 * alignment-safe and inside the range); the first differing word is
 * resolved with ctz on the XOR; the sub-word tail is a byte loop.
 * n <= 0 returns 0. */
static inline int32_t lcp_bytes(const char *a, const char *b, int32_t n)
{
    int32_t i = 0, n8 = n > 0 ? n & ~7 : 0;
    for (; i < n8; i += 8) {
        uint64_t wa, wb;
        memcpy(&wa, a + i, 8);
        memcpy(&wb, b + i, 8);
        if (wa != wb)
            return i + (int32_t)(__builtin_ctzll(wa ^ wb) >> 3);
    }
    for (; i < n; ++i)
        if (a[i] != b[i]) break;
    return i;
}

/* Slide diagonal d of the wavefront as far as target/query keep
 * matching: target byte k+1+j must equal query byte d+k+1+j.  The
 * last addressable k on this diagonal is min(ql - d, vl) - 1; the
 * whole extension is one LCP over the remaining span. */
static inline int32_t gextend1(int32_t d, int32_t k, int32_t vl,
                               const char *ts, int32_t ql, const char *qs)
{
    int32_t lim = (ql - d < vl ? ql - d : vl) - 1;
    return k + lcp_bytes(ts + k + 1, qs + d + k + 1, lim - k);
}

static int gintv_cmp(const void *a, const void *b)
{
    const gintv_t *x = (const gintv_t *)a, *y = (const gintv_t *)b;
    return x->vd0 < y->vd0 ? -1 : x->vd0 > y->vd0 ? 1 : 0;
}

/* dedup sub-phase timers (MGT_PROF=1): 0 interval-merge, 1 sort,
 * 2 uniq-max-k, 3 forbidden-bands; 4 sum n_a, 5 calls */
extern int mgt_tail_prof_on(void);
static int64_t gwfd_ns[8];
void mgt_gwfa_dedup_prof_dump(int64_t *out8)
{
    int k;
    for (k = 0; k < 8; ++k) {
        out8[k] = __atomic_load_n(&gwfd_ns[k], __ATOMIC_RELAXED);
        __atomic_store_n(&gwfd_ns[k], (int64_t)0, __ATOMIC_RELAXED);
    }
}
static int64_t gwfd_now(void)
{
    struct timespec ts;
    if (!mgt_tail_prof_on()) return 0;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}
static void gwfd_add(int k, int64_t ns)
{
    __atomic_fetch_add(&gwfd_ns[k], ns, __ATOMIC_RELAXED);
}

static int32_t gwf_dedup(gwf_t *z, int32_t n_a, gdiag_t *a)
{
    int32_t i, n, st;
    int64_t td0 = gwfd_now();
    if (td0) {
        gwfd_add(4, n_a);
        gwfd_add(5, 1);
    }
    /* merge finished-diagonal intervals (skip when nothing new:
     * copying the whole accumulated list every step dominated the
     * dedup phase on bridge-heavy long-read mapping) */
    if (z->tmp.n > 0) {
        gintv_v mg;
        int32_t j, k;
        for (i = 1; i < z->tmp.n; ++i)
            if (z->tmp.a[i - 1].vd0 > z->tmp.a[i].vd0) break;
        if (i < z->tmp.n)
            qsort(z->tmp.a, z->tmp.n, sizeof(gintv_t), gintv_cmp);
        if (z->intv.n + z->tmp.n > z->intv_spare.m) {
            z->intv_spare.m = z->intv.n + z->tmp.n + 64;
            z->intv_spare.a = (gintv_t *)gwf_grow(
                z->intv_spare.a, sizeof(gintv_t) * z->intv_spare.m);
            if (gwf_oom) return 0;
        }
        mg.a = z->intv_spare.a, mg.m = z->intv_spare.m, mg.n = 0;
        for (j = k = 0; j < z->intv.n || k < z->tmp.n;) {
            if (k == z->tmp.n || (j < z->intv.n
                                  && z->intv.a[j].vd0 <= z->tmp.a[k].vd0))
                mg.a[mg.n++] = z->intv.a[j++];
            else
                mg.a[mg.n++] = z->tmp.a[k++];
        }
        /* merge adjacent */
        if (mg.n) {
            uint64_t st0 = mg.a[0].vd0, en0 = mg.a[0].vd1;
            int32_t w = 0;
            for (i = 1; i < mg.n; ++i) {
                if (mg.a[i].vd0 > en0) {
                    mg.a[w].vd0 = st0, mg.a[w++].vd1 = en0;
                    st0 = mg.a[i].vd0, en0 = mg.a[i].vd1;
                } else en0 = en0 > mg.a[i].vd1 ? en0 : mg.a[i].vd1;
            }
            mg.a[w].vd0 = st0, mg.a[w++].vd1 = en0;
            mg.n = w;
        }
        z->intv_spare.a = z->intv.a, z->intv_spare.m = z->intv.m;
        z->intv_spare.n = 0;
        z->intv = mg;
        z->tmp.n = 0;
    }
    if (td0) {
        int64_t t1 = gwfd_now();
        gwfd_add(0, t1 - td0);
        td0 = t1;
    }
    /* sort: in-order prefix + radix-sorted out-of-order, merged */
    for (i = 1; i < n_a; ++i)
        if (a[i - 1].vd > a[i].vd) break;
    if (i < n_a) {
        /* single-copy variant: compact the marked (out-of-order)
         * states out of a[] in place, radix-sort just those, then
         * one BACKWARD merge writes every element once — the old
         * both-sides split + forward merge moved each 24-byte state
         * twice and hit the sorted side through a random index
         * (measured 115 of 127 ms of the dedup phase on the 16 kb
         * bench, ~41% of wave states arriving out of order). */
        int32_t n_b = 0, n_c = 0, j, k, w;
        gdiag_t *c, *cs;
        uint64_t *pairs;
        if (n_a > z->db_m) {
            z->db_m = n_a + 64;
            z->db = (gdiag_t *)gwf_grow(z->db, sizeof(gdiag_t) * z->db_m);
            z->dc = (gdiag_t *)gwf_grow(z->dc, sizeof(gdiag_t) * z->db_m);
            z->dpairs = (uint64_t *)gwf_grow(z->dpairs,
                                             16 * (size_t)z->db_m);
            if (gwf_oom) return 0;
        }
        c = z->dc, cs = z->db, pairs = z->dpairs;
        for (i = w = 0; i < n_a; ++i) {
            if (a[i].xo & 1) c[n_c++] = a[i];
            else { if (w != i) a[w] = a[i]; ++w; }
        }
        n_b = w;
        if (td0) { gwfd_add(6, n_c); gwfd_add(7, 1); }
        /* the MSD radix otherwise burns 4-6 passes over the constant
         * high bytes of vd (vertex ids are small): shift the common
         * prefix off the key — relative order of the varying suffix
         * is unchanged */
        if (n_c > 1) {
            uint64_t varies = 0, vd0 = c[0].vd;
            int32_t sh;
            for (i = 1; i < n_c; ++i) varies |= c[i].vd ^ vd0;
            sh = varies ? (__builtin_clzll(varies) & ~7) : 0;
            for (i = 0; i < n_c; ++i)
                pairs[2 * i] = c[i].vd << sh, pairs[2 * i + 1] = i;
            mgt_radix_sort_128x(pairs, n_c);
        } else if (n_c == 1)
            pairs[0] = c[0].vd, pairs[1] = 0;
        for (i = 0; i < n_c; ++i) {
            cs[i] = c[pairs[2 * i + 1]];
            cs[i].xo &= 0xFFFFFFFEu;
        }
        /* backward merge: on vd ties the in-order side lands first
         * (same tie rule as the old forward b-first merge) */
        j = n_b - 1, k = n_c - 1;
        for (i = n_a - 1; i >= 0; --i) {
            if (k < 0 || (j >= 0 && a[j].vd > cs[k].vd))
                a[i] = a[j--];
            else
                a[i] = cs[k--];
        }
    }
    if (td0) {
        int64_t t1 = gwfd_now();
        gwfd_add(1, t1 - td0);
        td0 = t1;
    }
    /* keep the far end per (v,d) */
    for (i = 1, st = 0, n = 0; i <= n_a; ++i) {
        if (i == n_a || a[i].vd != a[st].vd) {
            int32_t j, max_j = st;
            for (j = st + 1; j < i; ++j)
                if (a[max_j].k < a[j].k) max_j = j;
            a[n++] = a[max_j];
            st = i;
        }
    }
    n_a = n;
    if (td0) {
        int64_t t1 = gwfd_now();
        gwfd_add(2, t1 - td0);
        td0 = t1;
    }
    /* forbidden bands */
    if (z->intv.n > 0) {
        int32_t j = 0, k2 = 0;
        for (i = 0; i < n_a && j < z->intv.n; ) {
            if (a[i].vd >= z->intv.a[j].vd0 && a[i].vd < z->intv.a[j].vd1) ++i;
            else if (a[i].vd >= z->intv.a[j].vd1) ++j;
            else a[k2++] = a[i++];
        }
        while (i < n_a) a[k2++] = a[i++];
        n_a = k2;
    }
    if (td0) gwfd_add(3, gwfd_now() - td0);
    return n_a;
}

static int32_t gwf_prune(int32_t n_a, gdiag_t *a, uint32_t max_lag,
                         int32_t bw_dyn)
{
    int32_t i, j, iq, dq, max_i = -1;
    uint32_t max_x = 0;
    gdiag_t *q;
    for (i = 0; i < n_a; ++i)
        if (a[i].xo >> 1 > max_x) max_x = a[i].xo >> 1, max_i = i;
    q = &a[max_i];
    iq = (int32_t)q->vd - GWF_SHIFT + q->k;
    dq = (int32_t)(q->xo >> 1) - iq - iq;
    for (i = j = 0; i < n_a; ++i) {
        gdiag_t *p = &a[i];
        int32_t ip = (int32_t)p->vd - GWF_SHIFT + p->k;
        int32_t dp = (int32_t)(p->xo >> 1) - ip - ip;
        int32_t w = dp > dq ? dp - dq : dq - dp;
        if (bw_dyn >= 0 && w > bw_dyn) continue;
        if ((p->xo >> 1) + max_lag < max_x) continue;
        a[j++] = *p;
    }
    return j;
}

static void extend_batch(gwf_t *z, int32_t n, gdiag_t *a, gdiag_v *B,
                         gdiag_v *A)
{
    const ggraph_t *g = z->g;
    int32_t j, ql = z->ql;
    uint32_t v = a->vd >> 32;
    int32_t vl = g->seq_len[v];
    const char *ts = g->seq + g->seq_off[v];
    gdiag_v bb;

    for (j = 0; j < n; ++j) {
        int32_t k = gextend1((int32_t)a[j].vd - GWF_SHIFT, a[j].k, vl, ts,
                             ql, z->q);
        a[j].xo += (uint32_t)(k - a[j].k) << 2;
        a[j].k = k;
    }
    if (n + 2 > z->bb_m) {
        z->bb_m = n + 2 + 64;
        z->bb = (gdiag_t *)gwf_grow(z->bb, sizeof(gdiag_t) * z->bb_m);
        if (gwf_oom) return;
    }
    bb.a = z->bb, bb.m = z->bb_m, bb.n = 0;
    bb.a[0].vd = a[0].vd - 1;
    bb.a[0].xo = a[0].xo + 2;
    bb.a[0].k = a[0].k + 1;
    bb.a[0].t = a[0].t;
    if (n == 1 || a[0].k > a[1].k) {
        bb.a[1].vd = a[0].vd, bb.a[1].xo = a[0].xo + 4;
        bb.a[1].t = a[0].t, bb.a[1].k = a[0].k + 1;
    } else {
        bb.a[1].vd = a[0].vd, bb.a[1].xo = a[1].xo + 2;
        bb.a[1].t = a[1].t, bb.a[1].k = a[1].k + 1;
    }
    for (j = 1; j < n - 1; ++j) {
        uint32_t x = a[j - 1].xo + 2;
        int32_t k = a[j - 1].k, t = a[j - 1].t;
        if (!(k > a[j].k + 1)) x = a[j].xo + 4, t = a[j].t, k = a[j].k + 1;
        if (!(k > a[j + 1].k + 1))
            x = a[j + 1].xo + 2, t = a[j + 1].t, k = a[j + 1].k + 1;
        bb.a[j + 1].vd = a[j].vd, bb.a[j + 1].k = k;
        bb.a[j + 1].xo = x, bb.a[j + 1].t = t;
    }
    if (n >= 2) {
        if (a[n - 2].k > a[n - 1].k + 1) {
            bb.a[n].vd = a[n - 1].vd, bb.a[n].xo = a[n - 2].xo + 2;
            bb.a[n].t = a[n - 2].t, bb.a[n].k = a[n - 2].k;
        } else {
            bb.a[n].vd = a[n - 1].vd, bb.a[n].xo = a[n - 1].xo + 4;
            bb.a[n].t = a[n - 1].t, bb.a[n].k = a[n - 1].k + 1;
        }
    }
    bb.a[n + 1].vd = a[n - 1].vd + 1;
    bb.a[n + 1].xo = a[n - 1].xo + 2;
    bb.a[n + 1].t = a[n - 1].t;
    bb.a[n + 1].k = a[n - 1].k;

    for (j = 0; j < n; ++j) {
        gdiag_t *p = &a[j];
        int32_t d = (int32_t)p->vd - GWF_SHIFT;
        if (p->k == vl - 1 || d + p->k == ql - 1) {
            p->xo |= 1;
            if (A->n == A->m) {
                A->m += (A->m >> 1) + 16;
                A->a = (gdiag_t *)realloc(A->a, sizeof(gdiag_t) * A->m);
            }
            A->a[A->n++] = *p;
        }
    }
    for (j = 0; j < n + 2; ++j) {
        gdiag_t *p = &bb.a[j];
        int32_t d = (int32_t)p->vd - GWF_SHIFT;
        if (d + p->k < ql && p->k < vl) {
            if (B->n == B->m) {
                B->m += (B->m >> 1) + 16;
                B->a = (gdiag_t *)realloc(B->a, sizeof(gdiag_t) * B->m);
            }
            B->a[B->n++] = *p;
        } else if (p->k == vl) {
            gi_push(&z->tmp, gen_vd(v, d));
        }
    }
}

/* Env-gated phase profiling (MGT_PROF=1): 0 extend, 1 dedup,
 * 2 prune; counters: 3 steps, 4 peak wave size. */
#include <time.h>
static int64_t gwp_ns[8];
extern int mgt_tail_prof_on(void);
static inline int64_t gwp_now(void)
{
    struct timespec ts;
    if (!mgt_tail_prof_on()) return 0;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}
void mgt_gwfa_prof_dump(int64_t *out8)
{
    int k;
    for (k = 0; k < 8; ++k) {
        out8[k] = __atomic_load_n(&gwp_ns[k], __ATOMIC_RELAXED);
        __atomic_store_n(&gwp_ns[k], (int64_t)0, __ATOMIC_RELAXED);
    }
}

/* one score step; returns 1 if the end condition was reached */
static int gwf_step1(gwf_t *z, uint32_t v1, int32_t off1, uint32_t *end_v,
                     int32_t *end_off)
{
    const ggraph_t *g = z->g;
    int32_t ql = z->ql;
    gdiag_v A, B;
    int32_t i, x, n = z->a.n, do_dedup, head = 0;

    /* reuse the step scratch buffers (A) and ping-pong the wave
     * buffer (B <- spare, spare <- old a at the end) so the hot loop
     * does no malloc/free churn */
    A = z->As, A.n = 0;
    B = z->Bs, B.n = 0;

    int64_t tw0 = gwp_now();
    if (tw0) {
        __atomic_fetch_add(&gwp_ns[3], (int64_t)1, __ATOMIC_RELAXED);
        if (n > __atomic_load_n(&gwp_ns[4], __ATOMIC_RELAXED))
            __atomic_store_n(&gwp_ns[4], (int64_t)n, __ATOMIC_RELAXED);
    }
    z->tmp.n = 0;
    gh_clear(&z->ha);
    for (x = 0, i = 1; i <= n; ++i) {
        if (i == n || z->a.a[i].vd != z->a.a[i - 1].vd + 1) {
            extend_batch(z, i - x, &z->a.a[x], &B, &A);
            x = i;
        }
    }
    do_dedup = (A.n > 0);

    while (head < A.n) {
        gdiag_t t = A.a[head++];
        uint32_t v = t.vd >> 32, ooo = t.xo & 1, x0;
        int32_t d = (int32_t)t.vd - GWF_SHIFT, k = t.k;
        int32_t vl = g->seq_len[v];
        const char *ts = g->seq + g->seq_off[v];
        int32_t iq;
        k = gextend1(d, k, vl, ts, ql, z->q);
        iq = k + d;
        x0 = (t.xo >> 1) + ((uint32_t)(k - t.k) << 1);

        if (k + 1 < vl && iq + 1 < ql) {
            int32_t push1 = 1, push2 = 1;
            if (B.n >= 2) push1 = gd_update(&B.a[B.n - 2], v, d - 1, k + 1,
                                            x0 + 1, ooo, t.t);
            if (B.n >= 1) push2 = gd_update(&B.a[B.n - 1], v, d, k + 1,
                                            x0 + 2, ooo, t.t);
            if (push1) gd_push(&B, v, d - 1, k + 1, x0 + 1, 1, t.t);
            if (push2 || push1) gd_push(&B, v, d, k + 1, x0 + 2, 1, t.t);
            gd_push(&B, v, d + 1, k, x0 + 1, ooo, t.t);
        } else if (iq + 1 < ql) {
            int64_t st = g->arc_start[v];
            int32_t nv = g->arc_cnt[v], j, n_ext = 0, tw = -1;
            gi_push(&z->tmp, gen_vd(v, d));
            if (z->traceback) tw = trace_push(z, v, t.t);
            for (j = 0; j < nv; ++j) {
                uint32_t w = g->arc_w[st + j];
                int32_t ol = g->arc_ow[st + j];
                int absent;
                gh_put(&z->ha, (uint64_t)w << 32 | (uint32_t)(iq + 1),
                       &absent);
                if (z->q[iq + 1] == g->seq[g->seq_off[w] + ol]) {
                    ++n_ext;
                    if (absent)
                        gd_push(&A, w, iq + 1 - ol, ol, x0 + 2, 1, tw);
                } else if (absent) {
                    gd_push(&B, w, iq - ol, ol, x0 + 1, 1, tw);
                    gd_push(&B, w, iq + 1 - ol, ol, x0 + 2, 1, tw);
                }
            }
            if (nv == 0 || n_ext != nv)
                gd_push(&B, v, d + 1, k, x0 + 1, 1, t.t);
        } else if (v1 == (uint32_t)-1 || (v == v1 && k == off1)) {
            *end_v = v, *end_off = k;
            z->end_tb = t.t;
            z->a.n = 0;
            z->As = A, z->Bs = B;
            return 1;
        } else if (k + 1 < vl) {
            gd_push(&B, v, d - 1, k + 1, x0 + 1, ooo, t.t);
        } else if (v != v1) {
            int64_t st = g->arc_start[v];
            int32_t nv = g->arc_cnt[v], j, tw = -1;
            if (z->traceback) tw = trace_push(z, v, t.t);
            for (j = 0; j < nv; ++j)
                gd_push(&B, g->arc_w[st + j], iq - g->arc_ow[st + j],
                        g->arc_ow[st + j], x0 + 1, 1, tw);
        }
    }
    z->As = A;
    n = B.n;
    if (tw0) {
        int64_t t1 = gwp_now();
        __atomic_fetch_add(&gwp_ns[0], t1 - tw0, __ATOMIC_RELAXED);
        tw0 = t1;
    }
    if (do_dedup) n = gwf_dedup(z, n, B.a);
    if (tw0) {
        int64_t t1 = gwp_now();
        __atomic_fetch_add(&gwp_ns[1], t1 - tw0, __ATOMIC_RELAXED);
        tw0 = t1;
    }
    if (z->max_lag > 0 && n > z->max_chk && ((z->s + 1) & 0xf) == 0)
        n = gwf_prune(n, B.a, z->max_lag, z->bw_dyn);
    if (tw0)
        __atomic_fetch_add(&gwp_ns[2], gwp_now() - tw0, __ATOMIC_RELAXED);
    z->Bs.a = z->a.a, z->Bs.m = z->a.m, z->Bs.n = 0;
    z->a.a = B.a;
    z->a.n = n;
    z->a.m = B.m;
    return 0;
}

/* Full search.  Returns score s >= 0 on success, -1 when no
 * alignment was found, -2 when the optimal walk exceeds walk_cap
 * (caller must fall back; the walk length is bounded only by
 * query_len + edit_distance, not by query_len). */
int32_t mgt_gwfa_ed(
    /* graph */
    int64_t *arc_start, int32_t *arc_cnt, uint32_t *arc_w, int32_t *arc_ow,
    int64_t *seq_off, int32_t *seq_len, const char *seq,
    /* query + endpoints */
    int32_t ql, const char *q, uint32_t v0, int32_t off0, uint32_t v1,
    int32_t off1,
    /* options */
    int32_t s_term, int32_t traceback, int32_t max_chk, int32_t bw_dyn,
    int32_t max_lag, int64_t i_term,
    /* out */
    int32_t *walk, int32_t walk_cap, int32_t *n_walk)
{
    ggraph_t g = {arc_start, arc_cnt, arc_w, arc_ow, seq_off, seq_len, seq};
    gwf_t z;
    uint32_t end_v = (uint32_t)-1;
    int32_t end_off = -1, found = 0, ret;
    int64_t n_iter = 0;

    gwf_oom = 0;
    memset(&z, 0, sizeof(z));
    z.g = &g, z.ql = ql, z.q = q;
    z.traceback = traceback, z.max_chk = max_chk;
    z.bw_dyn = bw_dyn, z.max_lag = max_lag, z.i_term = i_term;
    gh_init(&z.ha, 64);
    gh_init(&z.ht, 64);
    z.a.m = 4;
    z.a.a = (gdiag_t *)malloc(sizeof(gdiag_t) * z.a.m);
    z.a.n = 1;
    z.a.a[0].vd = gen_vd(v0, -off0);
    z.a.a[0].k = off0 - 1;
    z.a.a[0].xo = 0;
    z.a.a[0].t = traceback ? trace_push(&z, -1, -1) : 0;

    *n_walk = 0;
    while (z.a.n > 0) {
        found = gwf_step1(&z, v1, off1, &end_v, &end_off);
        n_iter += z.a.n;
        if (found || z.a.n == 0) break;
        if (s_term >= 0 && z.s >= s_term) break;
        if (z.i_term > 0 && n_iter > z.i_term) break;
        ++z.s;
    }
    if (traceback && found) {
        int32_t i = z.end_tb, n = 0, j, ovf = 0;
        if (walk_cap < 1) { ovf = 1; i = -1; }
        else walk[n++] = end_v;
        while (i >= 0 && z.trace[i].v >= 0) {
            if (n >= walk_cap) { ovf = 1; break; }
            walk[n++] = z.trace[i].v;
            i = z.trace[i].pre;
        }
        if (ovf) found = -1;          /* walk truncated: overflow */
        for (j = 0; j < n >> 1; ++j) {
            int32_t t2 = walk[j];
            walk[j] = walk[n - 1 - j];
            walk[n - 1 - j] = t2;
        }
        *n_walk = n;
    }
    ret = found > 0 ? z.s : found < 0 ? -2 : -1;
    if (gwf_oom) ret = -2;          /* engine state unreliable */
    free(z.a.a);
    free(z.As.a);
    free(z.Bs.a);
    free(z.bb);
    free(z.db);
    free(z.dc);
    free(z.dpairs);
    free(z.intv.a);
    free(z.intv_spare.a);
    free(z.tmp.a);
    free(z.trace);
    gh_free(&z.ha);
    gh_free(&z.ht);
    return ret;
}
