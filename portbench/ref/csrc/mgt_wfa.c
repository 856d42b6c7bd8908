/* Exact 2-piece affine-gap wavefront alignment (WFA), semantics-equal
 * to the reference library (miniwfa.c) and to align/wfa.py, including
 * the low-memory segmented mode.  Oracle-diffed by
 * tests/test_native_engines.py.
 *
 * Architecture (this repo's own; see also ops/wfa_pallas.py for the
 * device derivation of the same recurrences):
 *
 *  - waves live in a ROTATING POOL of max_pen+1 slots whose buffers
 *    only ever grow (no per-wave malloc/free churn); each slot holds
 *    the five component arrays H/E1/F1/E2/F2 over [lo-pad, hi+pad]
 *    with pad = max_pen+1 so neighbour reads off older, narrower
 *    waves land in -inf flanks;
 *  - the wave recurrence runs as SEPARATE vectorizable component
 *    passes (E1, F1, E2, F2, then the H combine which also derives
 *    the traceback byte);
 *  - traceback bytes use this repo's encoding: low 3 bits = winning
 *    state (0 M, 1 E1, 2 F1, 3 E2, 4 F2), bits 4..7 = "gap extended"
 *    per component (E1, F1, E2, F2 respectively);
 *  - the segmented (low-memory) mode tracks, for every live cell, a
 *    PACKED ORIGIN id (slice << 26 | cell) pointing at its ancestor
 *    cell in the last snapshot; snapshots archive the origin planes
 *    and reset them to self-ids, so a backward walk over the archives
 *    yields one (score, diagonal) checkpoint per snapshot, and the
 *    final banded re-run collapses its band to those checkpoints.
 *
 * Scoring model: mismatch x; gap open o1+e1 / extend e1 (short piece);
 * open o2+e2 / extend e2 (long piece); matches free.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define NEG_INF (-0x40000000)
#define WF_MAX(a, b) ((a) >= (b) ? (a) : (b))

typedef struct { int32_t x, o1, e1, o2, e2; } wf_pen_t;

/* ------------------------------------------------------------------ */
/* rotating wave pool                                                  */
/* ------------------------------------------------------------------ */

enum { C_H, C_E1, C_F1, C_E2, C_F2 };

typedef struct {
    int32_t lo, hi;       /* valid diagonal range of this wave */
    int32_t cap;          /* allocated width incl. pads */
    int32_t *buf;         /* 5 * cap int32 */
    int32_t *c[5];        /* c[comp][d] valid for d in [lo-pad, hi+pad] */
} wave_t;

typedef struct {
    int32_t s;            /* score of the newest wave */
    int32_t head;         /* pool slot of the newest wave */
    int32_t n;            /* pool size = max_pen + 1 */
    int32_t pad;          /* flank width = max_pen + 1 */
    int32_t blo, bhi;     /* live band bounds (across the pool) */
    wave_t *w;
} pool_t;

/* slot of the wave at score (pool->s - back) */
static inline wave_t *pool_at(pool_t *p, int32_t back)
{
    int32_t i = p->head - back;
    return &p->w[i < 0 ? i + p->n : i];
}

/* rotate in a fresh wave covering [lo, hi]; all flanks -inf */
static wave_t *pool_push(pool_t *p, int32_t lo, int32_t hi)
{
    int32_t need = (hi - lo + 1) + 2 * p->pad, i, co;
    wave_t *w;
    ++p->s;
    p->head = (p->head + 1 == p->n) ? 0 : p->head + 1;
    w = &p->w[p->head];
    if (need > w->cap) {
        int32_t cap = need + (need >> 1) + 16;
        free(w->buf);
        w->buf = (int32_t *)malloc(5 * sizeof(int32_t) * cap);
        w->cap = cap;
    }
    w->lo = lo, w->hi = hi;
    for (co = 0; co < 5; ++co) {
        int32_t *a = w->buf + (int64_t)co * w->cap;
        w->c[co] = a + p->pad - lo;
        for (i = 0; i < p->pad; ++i) {
            w->c[co][lo - 1 - i] = NEG_INF;
            w->c[co][hi + 1 + i] = NEG_INF;
        }
    }
    return w;
}

static pool_t *pool_init(int32_t max_pen)
{
    int32_t i, co;
    pool_t *p = (pool_t *)calloc(1, sizeof(pool_t));
    p->n = max_pen + 1;
    p->pad = max_pen + 1;
    p->w = (wave_t *)calloc(p->n, sizeof(wave_t));
    p->head = -1;
    p->s = -1;
    for (i = 0; i < p->n; ++i) {
        wave_t *w = pool_push(p, 0, 0);
        for (co = 0; co < 5; ++co) w->c[co][0] = NEG_INF;
    }
    p->s = 0;
    p->blo = p->bhi = 0;
    pool_at(p, 0)->c[C_H][0] = -1;
    return p;
}

static void pool_destroy(pool_t *p)
{
    int32_t i;
    for (i = 0; i < p->n; ++i) free(p->w[i].buf);
    free(p->w);
    free(p);
}

/* ------------------------------------------------------------------ */
/* diagonal extension and band maintenance                             */
/* ------------------------------------------------------------------ */

/* is (d, k) inside the DP matrix (incl. the -1 origin row/col)? */
static inline int in_matrix(int32_t d, int32_t k, int32_t tl, int32_t ql)
{
    return k >= -1 && k < tl && d + k >= -1 && d + k < ql;
}

/* longest common extension along diagonal d from offset k; the
 * strings carry 8 distinct pad bytes so the scan cannot overrun */
static inline int32_t lce(const char *ts, const char *qs, int32_t k,
                          int32_t d)
{
    const char *a = ts + k + 1, *b = qs + d + k + 1;
    uint64_t u, v;
    for (;;) {
        memcpy(&u, a, 8);
        memcpy(&v, b, 8);
        if (u != v) break;
        a += 8, b += 8, k += 8;
    }
    return k + (__builtin_ctzll(u ^ v) >> 3);
}

/* does any component of any pooled wave have a live cell on d? */
static int band_live(pool_t *p, int32_t d, int32_t tl, int32_t ql)
{
    int32_t j, co;
    for (j = 0; j < p->n; ++j) {
        const wave_t *w = pool_at(p, j);
        if (d < w->lo || d > w->hi) continue;
        for (co = 0; co < 5; ++co)
            if (in_matrix(d, w->c[co][d], tl, ql)) return 1;
    }
    return 0;
}

/* tighten the live band to diagonals with any in-matrix cell
 * (wf_stripe_shrink semantics, miniwfa.c:144-171) */
static void band_tighten(pool_t *p, int32_t tl, int32_t ql)
{
    int32_t d;
    for (d = p->blo; d <= p->bhi; ++d)
        if (band_live(p, d, tl, ql)) break;
    p->blo = d;
    for (d = p->bhi; d >= p->blo; --d)
        if (band_live(p, d, tl, ql)) break;
    p->bhi = d;
}

/* ------------------------------------------------------------------ */
/* wave recurrence: component passes                                   */
/* ------------------------------------------------------------------ */

/* traceback byte: low 3 bits = state, bits 4..7 = gap-extend flags */
#define TB_STATE(x) ((x) & 7)
#define TB_EXT(x, st) ((x) >> (3 + (st)) & 1)
#define TB_X_E1 0x10
#define TB_X_F1 0x20
#define TB_X_E2 0x40
#define TB_X_F2 0x80

typedef struct {          /* source waves for one new wave at score s */
    const int32_t *Hx;    /* H at s - x       */
    const int32_t *Ho1;   /* H at s - o1 - e1 */
    const int32_t *Ho2;   /* H at s - o2 - e2 */
    const int32_t *E1, *F1;  /* at s - e1 */
    const int32_t *E2, *F2;  /* at s - e2 */
} src_t;

static void wave_sources(pool_t *p, const wf_pen_t *pen, src_t *sr)
{
    /* relative to the just-pushed head (score s): back = pen */
    sr->Hx = pool_at(p, pen->x)->c[C_H];
    sr->Ho1 = pool_at(p, pen->o1 + pen->e1)->c[C_H];
    sr->Ho2 = pool_at(p, pen->o2 + pen->e2)->c[C_H];
    sr->E1 = pool_at(p, pen->e1)->c[C_E1];
    sr->F1 = pool_at(p, pen->e1)->c[C_F1];
    sr->E2 = pool_at(p, pen->e2)->c[C_E2];
    sr->F2 = pool_at(p, pen->e2)->c[C_F2];
}

#if defined(__clang__)
#define VEC_LOOP _Pragma("clang loop vectorize(enable)")
#elif defined(__GNUC__)
#define VEC_LOOP _Pragma("GCC ivdep")
#else
#define VEC_LOOP
#endif

/* score-only wave: component passes then combine */
static void wave_fill(wave_t *w, const src_t *sr, int32_t lo, int32_t hi)
{
    int32_t *E1 = w->c[C_E1], *F1 = w->c[C_F1];
    int32_t *E2 = w->c[C_E2], *F2 = w->c[C_F2], *H = w->c[C_H];
    int32_t d;
    VEC_LOOP
    for (d = lo; d <= hi; ++d) E1[d] = WF_MAX(sr->Ho1[d - 1], sr->E1[d - 1]);
    VEC_LOOP
    for (d = lo; d <= hi; ++d) E2[d] = WF_MAX(sr->Ho2[d - 1], sr->E2[d - 1]);
    VEC_LOOP
    for (d = lo; d <= hi; ++d)
        F1[d] = WF_MAX(sr->Ho1[d + 1], sr->F1[d + 1]) + 1;
    VEC_LOOP
    for (d = lo; d <= hi; ++d)
        F2[d] = WF_MAX(sr->Ho2[d + 1], sr->F2[d + 1]) + 1;
    VEC_LOOP
    for (d = lo; d <= hi; ++d) {
        int32_t g = WF_MAX(WF_MAX(E1[d], E2[d]), WF_MAX(F1[d], F2[d]));
        H[d] = WF_MAX(sr->Hx[d] + 1, g);
    }
}

/* traceback wave: the same passes also derive the decision byte;
 * tie order matches the reference (miniwfa.c:283-307): on equality a
 * gap OPEN beats an extension, E beats F, piece 1 beats piece 2, and
 * mismatch beats any gap. */
static void wave_fill_tb(wave_t *w, const src_t *sr, int32_t lo, int32_t hi,
                         uint8_t *bits0 /* indexed by d */)
{
    /* vectorized component passes first, then derive the decision
     * byte elementwise from sources + results (semantically the
     * fused recurrence; tie order matches miniwfa.c:283-307: on
     * equality a gap OPEN beats an extension, E beats F, piece 1
     * beats piece 2, and mismatch beats any gap).  restrict on every
     * pointer: a plain uint8_t store aliases the int32 planes in the
     * C model and forces the whole loop scalar. */
    const int32_t *restrict E1 = w->c[C_E1];
    const int32_t *restrict F1 = w->c[C_F1];
    const int32_t *restrict E2 = w->c[C_E2];
    const int32_t *restrict F2 = w->c[C_F2];
    const int32_t *restrict Hx = sr->Hx;
    const int32_t *restrict Ho1 = sr->Ho1;
    const int32_t *restrict Ho2 = sr->Ho2;
    const int32_t *restrict sE1 = sr->E1;
    const int32_t *restrict sF1 = sr->F1;
    const int32_t *restrict sE2 = sr->E2;
    const int32_t *restrict sF2 = sr->F2;
    uint8_t *restrict bits = bits0;
    int32_t d;
    wave_fill(w, sr, lo, hi);
    VEC_LOOP
    for (d = lo; d <= hi; ++d) {
        int32_t x, e, f, st_e, st_f, st;
        x  = (int32_t)(Ho1[d - 1] < sE1[d - 1]) << 4;
        x |= (int32_t)(Ho2[d - 1] < sE2[d - 1]) << 6;
        x |= (int32_t)(Ho1[d + 1] < sF1[d + 1]) << 5;
        x |= (int32_t)(Ho2[d + 1] < sF2[d + 1]) << 7;
        st_e = 1 + ((int32_t)(E1[d] < E2[d]) << 1);
        e = WF_MAX(E1[d], E2[d]);
        st_f = 2 + ((int32_t)(F1[d] < F2[d]) << 1);
        f = WF_MAX(F1[d], F2[d]);
        st = e >= f ? st_e : st_f;
        st = Hx[d] + 1 >= WF_MAX(e, f) ? 0 : st;
        bits[d] = (uint8_t)(x | st);
    }
}

/* update the live band edges after a new wave (wf_next_basic tail) */
static void band_note_edges(pool_t *p, const wave_t *w, int32_t lo,
                            int32_t hi)
{
    int32_t co, lv;
    for (co = 0, lv = 0; co < 5 && !lv; ++co) lv = w->c[co][lo] >= -1;
    if (lv) p->blo = lo;
    for (co = 0, lv = 0; co < 5 && !lv; ++co) lv = w->c[co][hi] >= -1;
    if (lv) p->bhi = hi;
}

/* ------------------------------------------------------------------ */
/* traceback byte archive (one strip per score)                        */
/* ------------------------------------------------------------------ */

typedef struct { int32_t lo, hi; int64_t off; } tb_strip_t;

typedef struct {
    int32_t n, m;
    tb_strip_t *a;
    uint8_t *pool;        /* arena backing every strip */
    int64_t used, cap;
} tb_log_t;

static uint8_t *tb_log_push(tb_log_t *g, int32_t lo, int32_t hi)
{
    tb_strip_t *t;
    int64_t need = hi - lo + 1;
    if (g->n == g->m) {
        g->m += (g->m >> 1) + 8;
        g->a = (tb_strip_t *)realloc(g->a, g->m * sizeof(tb_strip_t));
    }
    if (g->used + need > g->cap) {
        /* arena may move: strips store offsets, fixed up on read */
        int64_t want = g->used + need;
        g->cap = want + (want >> 1) + 4096;
        g->pool = (uint8_t *)realloc(g->pool, (size_t)g->cap);
    }
    t = &g->a[g->n++];
    t->lo = lo, t->hi = hi;
    t->off = g->used;
    g->used += need;
    return g->pool + t->off - lo;
}

/* strip base pointer (indexed by absolute diagonal) */
static inline const uint8_t *tb_strip_b(const tb_log_t *g,
                                        const tb_strip_t *t)
{
    return g->pool + t->off - t->lo;
}

static void tb_log_free(tb_log_t *g)
{
    free(g->pool);
    free(g->a);
}

/* ------------------------------------------------------------------ */
/* CIGAR builder + traceback walk                                      */
/* ------------------------------------------------------------------ */

typedef struct { int32_t n, m; uint32_t *ops; } cig_t;

static void cig_add(cig_t *c, int32_t op, int32_t len)
{
    if (c->n && (int32_t)(c->ops[c->n - 1] & 0xf) == op) {
        c->ops[c->n - 1] += (uint32_t)len << 4;
        return;
    }
    if (c->n == c->m) {
        c->m += (c->m >> 1) + 8;
        c->ops = (uint32_t *)realloc(c->ops, 4 * c->m);
    }
    c->ops[c->n++] = (uint32_t)len << 4 | op;
}

/* walk the archived decision bytes from the end cell back to the
 * origin (wf_traceback semantics, miniwfa.c:330-377) */
static uint32_t *tb_walk(const wf_pen_t *pen, const tb_log_t *g,
                         int32_t t_end, const char *ts, int32_t q_end,
                         const char *qs, int32_t state0, int32_t *n_out)
{
    cig_t c = {0, 0, 0};
    int32_t i = q_end, k = t_end, s = g->n - 1, last = state0;
    while (i >= 0 && k >= 0) {
        const tb_strip_t *t;
        int32_t st, ext;
        uint8_t x;
        if (last == 0) {            /* run of exact matches first */
            int32_t k0 = k;
            while (i >= 0 && k >= 0 && qs[i] == ts[k]) --i, --k;
            if (k0 > k) cig_add(&c, 7, k0 - k);
            if (i < 0 || k < 0) break;
        }
        t = &g->a[s];
        x = tb_strip_b(g, t)[i - k];
        st = last == 0 ? TB_STATE(x) : last;
        ext = st > 0 ? TB_EXT(x, st) : 0;
        switch (st) {
        case 0: cig_add(&c, 8, 1); --i; --k; s -= pen->x; break;
        case 1: cig_add(&c, 1, 1); --i;
                s -= ext ? pen->e1 : pen->o1 + pen->e1; break;
        case 3: cig_add(&c, 1, 1); --i;
                s -= ext ? pen->e2 : pen->o2 + pen->e2; break;
        case 2: cig_add(&c, 2, 1); --k;
                s -= ext ? pen->e1 : pen->o1 + pen->e1; break;
        case 4: cig_add(&c, 2, 1); --k;
                s -= ext ? pen->e2 : pen->o2 + pen->e2; break;
        }
        last = (st > 0 && ext) ? st : 0;
    }
    if (i >= 0) cig_add(&c, 1, i + 1);
    else if (k >= 0) cig_add(&c, 2, k + 1);
    /* built backwards: reverse */
    for (i = 0, k = c.n - 1; i < k; ++i, --k) {
        uint32_t tmp = c.ops[i];
        c.ops[i] = c.ops[k];
        c.ops[k] = tmp;
    }
    *n_out = c.n;
    return c.ops;
}

/* ------------------------------------------------------------------ */
/* segmented (low-memory) mode: origin tracking + snapshots            */
/* ------------------------------------------------------------------ */

/* packed origin id: slice (0 = oldest pooled wave) << 26 | cell,
 * cell = (d - slice_lo) * 5 + component */
#define ORG(slice, cell) ((int32_t)((slice) << 26 | (cell)))
#define ORG_SLICE(o) ((o) >> 26)
#define ORG_CELL(o) ((o) & ((1 << 26) - 1))

typedef struct {
    int32_t score;        /* pool score when archived */
    int32_t n_sl;
    int32_t *lo;          /* per slice */
    int32_t *width;
    int32_t **vals;       /* archived origin planes, cell-indexed */
} snap_t;

typedef struct { int32_t n, m; snap_t *a; } snaps_t;

/* archive the origin pool and reset it to self-ids */
static void snap_take(snaps_t *ss, pool_t *org)
{
    snap_t *sn;
    int32_t j;
    if (ss->n == ss->m) {
        ss->m += (ss->m >> 1) + 8;
        ss->a = (snap_t *)realloc(ss->a, ss->m * sizeof(snap_t));
    }
    sn = &ss->a[ss->n++];
    sn->score = org->s;
    sn->n_sl = org->n;
    sn->lo = (int32_t *)malloc(4 * org->n);
    sn->width = (int32_t *)malloc(4 * org->n);
    sn->vals = (int32_t **)malloc(sizeof(void *) * org->n);
    for (j = 0; j < org->n; ++j) {
        /* slice j = oldest + j = back (n - 1 - j) */
        wave_t *w = pool_at(org, org->n - 1 - j);
        int32_t d, co, wd = w->hi - w->lo + 1, cell = 0;
        int32_t *save = (int32_t *)malloc(4 * (int64_t)wd * 5);
        sn->lo[j] = w->lo, sn->width[j] = wd;
        sn->vals[j] = save;
        for (d = w->lo; d <= w->hi; ++d)
            for (co = 0; co < 5; ++co, ++cell) {
                save[cell] = w->c[co][d];
                w->c[co][d] = ORG(j, cell);
            }
    }
}

static void snaps_free(snaps_t *ss)
{
    int32_t i, j;
    for (i = 0; i < ss->n; ++i) {
        for (j = 0; j < ss->a[i].n_sl; ++j) free(ss->a[i].vals[j]);
        free(ss->a[i].lo);
        free(ss->a[i].width);
        free(ss->a[i].vals);
    }
    free(ss->a);
}

/* propagate origins through one wave using the decision bits */
static void wave_fill_org(wave_t *w, const src_t *sr, int32_t lo,
                          int32_t hi, const uint8_t *bits)
{
    int32_t *E1 = w->c[C_E1], *F1 = w->c[C_F1];
    int32_t *E2 = w->c[C_E2], *F2 = w->c[C_F2], *H = w->c[C_H];
    int32_t d;
    VEC_LOOP
    for (d = lo; d <= hi; ++d) {
        uint8_t x = bits[d];
        int32_t e1, f1, e2, f2, h, st;
        e1 = E1[d] = (x & TB_X_E1) ? sr->E1[d - 1] : sr->Ho1[d - 1];
        f1 = F1[d] = (x & TB_X_F1) ? sr->F1[d + 1] : sr->Ho1[d + 1];
        e2 = E2[d] = (x & TB_X_E2) ? sr->E2[d - 1] : sr->Ho2[d - 1];
        f2 = F2[d] = (x & TB_X_F2) ? sr->F2[d + 1] : sr->Ho2[d + 1];
        st = TB_STATE(x);
        h = sr->Hx[d];
        h = st == 1 ? e1 : h;
        h = st == 2 ? f1 : h;
        h = st == 3 ? e2 : h;
        h = st == 4 ? f2 : h;
        H[d] = h;
    }
}

typedef struct { int32_t s, d; } chk_t;

/* walk archived origins: one (score, diagonal) checkpoint per
 * snapshot, newest to oldest */
static chk_t *snaps_to_checkpoints(snaps_t *ss, int32_t last,
                                   int32_t *n_out)
{
    int32_t j;
    chk_t *seg = (chk_t *)malloc(sizeof(chk_t) * (ss->n ? ss->n : 1));
    *n_out = ss->n;
    for (j = ss->n - 1; j >= 0; --j) {
        snap_t *sn = &ss->a[j];
        int32_t sl = ORG_SLICE(last), cell = ORG_CELL(last);
        seg[j].s = sn->score - (sn->n_sl - 1 - sl);
        seg[j].d = sn->lo[sl] + cell / 5;
        last = sn->vals[sl][cell];
    }
    return seg;
}

/* phase 1: score pass with origin tracking; returns checkpoints */
static chk_t *seg_pass(const wf_pen_t *pen, int32_t max_pen, int32_t tl,
                       const char *pts, int32_t ql, const char *pqs,
                       int32_t step, int32_t *n_seg)
{
    pool_t *val = pool_init(max_pen);
    pool_t *org = pool_init(max_pen);
    uint8_t *bitbuf = (uint8_t *)malloc((int64_t)tl + ql + 1);
    snaps_t ss = {0, 0, 0};
    chk_t *seg;
    int32_t last = 0;

    for (;;) {
        wave_t *p = pool_at(val, 0);
        int32_t d, lo, hi, *H = p->c[C_H];
        int done = 0;
        for (d = p->lo; d <= p->hi; ++d) {
            int32_t k = H[d];
            if (!in_matrix(d, k, tl, ql)) continue;
            k = lce(pts, pqs, k, d);
            if (k == tl - 1 && d + k == ql - 1) {
                last = pool_at(org, 0)->c[C_H][d];
                done = 1;
                break;
            }
            H[d] = k;
        }
        if (done) break;
        lo = val->blo > -tl ? val->blo - 1 : -tl;
        hi = val->bhi < ql ? val->bhi + 1 : ql;
        if ((val->s + 1) % step == 0) snap_take(&ss, org);
        {
            uint8_t *bits = bitbuf - lo;
            src_t sv, so;
            wave_t *nv, *no;
            nv = pool_push(val, lo, hi);
            wave_sources(val, pen, &sv);
            wave_fill_tb(nv, &sv, lo, hi, bits);
            no = pool_push(org, lo, hi);
            wave_sources(org, pen, &so);
            wave_fill_org(no, &so, lo, hi, bits);
            band_note_edges(val, nv, lo, hi);
        }
        if ((val->s & 0xff) == 0) band_tighten(val, tl, ql);
    }
    seg = snaps_to_checkpoints(&ss, last, n_seg);
    snaps_free(&ss);
    free(bitbuf);
    pool_destroy(val);
    pool_destroy(org);
    return seg;
}

/* ------------------------------------------------------------------ */
/* public entry points (ABI consumed by align/wfa.py + mgt_cigar.c)    */
/* ------------------------------------------------------------------ */

int32_t mgt_wfa_exact2(const char *ts0, int32_t tl, const char *qs0,
                       int32_t ql, int32_t px, int32_t po1, int32_t pe1,
                       int32_t po2, int32_t pe2, int32_t is_tb,
                       int32_t max_s, int64_t max_iter, int32_t step,
                       uint32_t **cigar_out, int32_t *n_cigar_out,
                       int64_t *n_iter_out)
{
    wf_pen_t pen = {px, po1, pe1, po2, pe2};
    int32_t max_pen, last_state = 0, stopped = 0, score, i, sid = 0;
    int32_t n_seg = 0;
    int64_t n_iter = 0;
    pool_t *wp;
    tb_log_t tb = {0, 0, 0, 0, 0, 0};
    chk_t *seg = 0;
    char *pts, *pqs;
    uint8_t used[256];
    int c1 = -1, c2 = -1;

    if (cigar_out) *cigar_out = 0;
    if (n_cigar_out) *n_cigar_out = 0;

    /* pad both strings with 8 bytes of distinct unused characters so
     * the 8-byte extension scan terminates in-bounds */
    memset(used, 0, 256);
    for (i = 0; i < tl; ++i) used[(uint8_t)ts0[i]] = 1;
    for (i = 0; i < ql; ++i) used[(uint8_t)qs0[i]] = 1;
    for (i = 0; i < 256; ++i)
        if (!used[i]) { if (c1 < 0) c1 = i; else if (c2 < 0) { c2 = i; break; } }
    pts = (char *)malloc((int64_t)tl + ql + 16);
    pqs = pts + tl + 8;
    memcpy(pts, ts0, tl);
    memset(pts + tl, c1, 8);
    memcpy(pqs, qs0, ql);
    memset(pqs + ql, c2, 8);

    max_pen = px;
    max_pen = WF_MAX(max_pen, po1 + pe1);
    max_pen = WF_MAX(max_pen, po2 + pe2);
    if (step > 0 && is_tb)
        seg = seg_pass(&pen, max_pen, tl, pts, ql, pqs, step, &n_seg);
    wp = pool_init(max_pen);

    for (;;) {
        wave_t *p = pool_at(wp, 0);
        int32_t d, lo, hi, *H = p->c[C_H];
        int done = 0;
        for (d = p->lo; d <= p->hi; ++d) {
            int32_t k = H[d];
            if (!in_matrix(d, k, tl, ql)) continue;
            k = lce(pts, pqs, k, d);
            if (k == tl - 1 && d + k == ql - 1) {
                if (k == H[d] && is_tb && tb.n > 0) {
                    const tb_strip_t *t = &tb.a[tb.n - 1];
                    last_state = TB_STATE(tb_strip_b(&tb, t)[d]);
                }
                done = 1;
                break;
            }
            H[d] = k;
        }
        if (done) break;
        if (is_tb && seg && sid < n_seg && seg[sid].s == wp->s)
            wp->blo = wp->bhi = seg[sid++].d;   /* collapse to checkpoint */
        lo = wp->blo > -tl ? wp->blo - 1 : -tl;
        hi = wp->bhi < ql ? wp->bhi + 1 : ql;
        {
            src_t sr;
            wave_t *nw = pool_push(wp, lo, hi);
            wave_sources(wp, &pen, &sr);
            if (is_tb) wave_fill_tb(nw, &sr, lo, hi, tb_log_push(&tb, lo, hi));
            else wave_fill(nw, &sr, lo, hi);
            band_note_edges(wp, nw, lo, hi);
        }
        if ((wp->s & 0xff) == 0) band_tighten(wp, tl, ql);
        n_iter += hi - lo + 1;
        if ((max_iter > 0 && n_iter > max_iter)
            || (max_s > 0 && wp->s > max_s)) {
            stopped = 1;
            break;
        }
    }
    free(seg);
    score = stopped ? -1 : wp->s;
    if (is_tb && !stopped && cigar_out)
        *cigar_out = tb_walk(&pen, &tb, tl - 1, pts, ql - 1, pqs,
                             last_state, n_cigar_out);
    if (n_iter_out) *n_iter_out = n_iter;
    tb_log_free(&tb);
    pool_destroy(wp);
    free(pts);
    return score;
}

void mgt_wfa_free(uint32_t *p)
{
    free(p);
}

/* legacy entry point (no checkpoint mode) */
int32_t mgt_wfa_exact(const char *ts0, int32_t tl, const char *qs0,
                      int32_t ql, int32_t px, int32_t po1, int32_t pe1,
                      int32_t po2, int32_t pe2, int32_t is_tb,
                      int32_t max_s, int64_t max_iter, uint32_t **cigar_out,
                      int32_t *n_cigar_out, int64_t *n_iter_out)
{
    return mgt_wfa_exact2(ts0, tl, qs0, ql, px, po1, pe1, po2, pe2, is_tb,
                          max_s, max_iter, 0, cigar_out, n_cigar_out,
                          n_iter_out);
}
