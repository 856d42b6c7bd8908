/* Symmetric (w,k)-minimizer sketching, semantics-equal to the reference
 * (sketch.c:56-109) but structured after this repo's position-aligned
 * device derivation (ops/sketch_jax4.py): per step we classify the
 * window transition into named rules —
 *
 *   FW  first full window: emit every tie of the current minimum
 *       (equal hash+span key, different payload), ascending;
 *   A   the new event is <= the running minimum: emit the old minimum
 *       (once the window has fully slid) and adopt the new event;
 *   B   the running minimum just slid out of the window: emit it,
 *       rescan the live window ascending with >= so the CLOSEST equal
 *       key wins, then emit the new minimum's ties ascending.
 *
 * The window is stored as a step-indexed array (win[step % w]) and all
 * scans are single ascending loops over the last w steps; expiry is a
 * step-arithmetic test (min_step == step - w).  Steps count non-skipped
 * events only: strand-symmetric k-mers (possible for even k) consume a
 * sequence position but no step, exactly like the reference's
 * `continue`.  Emitted records pack x = hash<<8 | span,
 * y = rid<<32 | last_pos<<1 | strand.
 */
#include <stdint.h>
#include <stddef.h>
#include <string.h>

static uint8_t nt4[256];
static int nt4_ready = 0;

static void nt4_init(void)
{
    int i;
    for (i = 0; i < 256; ++i) nt4[i] = 4;
    nt4[0] = 0; nt4[1] = 1; nt4[2] = 2; nt4[3] = 3;
    nt4['A'] = nt4['a'] = 0;
    nt4['C'] = nt4['c'] = 1;
    nt4['G'] = nt4['g'] = 2;
    nt4['T'] = nt4['t'] = 3;
    nt4['U'] = nt4['u'] = 3;
    nt4_ready = 1;
}

static inline uint64_t mgt_hash64(uint64_t key, uint64_t mask)
{
    key = (~key + (key << 21)) & mask;
    key = key ^ key >> 24;
    key = ((key + (key << 3)) + (key << 8)) & mask;
    key = key ^ key >> 14;
    key = ((key + (key << 2)) + (key << 4)) & mask;
    key = key ^ key >> 28;
    key = (key + (key << 31)) & mask;
    return key;
}

typedef struct { uint64_t key, pay; } ev_t;   /* hash<<8|span, rid|pos|z */

#define EV_EMPTY UINT64_MAX

/* out holds cap records of 2 uint64; returns #records or -1 on overflow */
int64_t mgt_sketch(const uint8_t *seq, int64_t len, int w, int k,
                   uint32_t rid, uint64_t *out, int64_t cap)
{
    uint64_t mask, fwd = 0, rc = 0;
    ev_t win[256], cur;             /* window of the last w events */
    int64_t i, step, n = 0, cur_step = -1;
    int p, run = 0, span = 0;

    if (!nt4_ready) nt4_init();
    if (len <= 0 || w <= 0 || w >= 256 || k <= 0 || k > 28) return 0;
    mask = (1ULL << (2 * k)) - 1;
    for (p = 0; p < w; ++p) win[p].key = EV_EMPTY, win[p].pay = EV_EMPTY;
    cur.key = EV_EMPTY; cur.pay = EV_EMPTY;

#define PUT(e) do { \
        if (n >= cap) return -1; \
        out[2 * n] = (e).key; out[2 * n + 1] = (e).pay; ++n; \
    } while (0)

    /* ascending scan over the last w steps, skipping slot `skip` */
#define SCAN_TIES(ref_, skip_, s_) do { \
        int64_t q_ = (s_) - w + 1 < 0 ? 0 : (s_) - w + 1; \
        for (; q_ <= (s_); ++q_) { \
            const ev_t *e_ = &win[q_ % w]; \
            if (q_ == (skip_)) continue; \
            if (e_->key == (ref_).key && e_->pay != (ref_).pay) PUT(*e_); \
        } \
    } while (0)

    for (i = 0, step = -1; i < len; ++i) {
        int c = nt4[seq[i]];
        ev_t e;
        e.key = EV_EMPTY; e.pay = EV_EMPTY;
        if (c < 4) {
            int z;
            span = run + 1 < k ? run + 1 : k;
            fwd = (fwd << 2 | (uint64_t)c) & mask;
            rc = (rc >> 2) | ((uint64_t)(3 ^ c) << (2 * (k - 1)));
            if (fwd == rc) continue;             /* strand-symmetric */
            z = fwd < rc ? 0 : 1;
            ++run;
            if (run >= k && span < 256) {
                e.key = mgt_hash64(z ? rc : fwd, mask) << 8 | (uint64_t)span;
                e.pay = (uint64_t)rid << 32 | (uint64_t)((uint32_t)i << 1 | z);
            }
        } else run = 0, span = 0;
        ++step;
        win[step % w] = e;

        if (run == w + k - 1 && cur.key != EV_EMPTY)       /* FW rule */
            SCAN_TIES(cur, step, step);

        if (e.key <= cur.key) {                            /* A rule */
            if (run >= w + k && cur.key != EV_EMPTY) PUT(cur);
            cur = e;
            cur_step = step;
        } else if (cur_step == step - w) {                 /* B rule */
            int64_t q = step - w + 1 < 0 ? 0 : step - w + 1;
            if (run >= w + k - 1 && cur.key != EV_EMPTY) PUT(cur);
            cur.key = EV_EMPTY; cur.pay = EV_EMPTY;
            for (; q <= step; ++q) {
                const ev_t *t = &win[q % w];
                if (t->key <= cur.key)             /* <=: closest wins */
                    cur = *t, cur_step = q;
            }
            if (run >= w + k - 1 && cur.key != EV_EMPTY)
                SCAN_TIES(cur, cur_step, step);
        }
    }
    if (cur.key != EV_EMPTY) PUT(cur);
#undef SCAN_TIES
#undef PUT
    return n;
}

/* ------------------------------------------------------------------ */
/* parallel many-segment sketch (the reference parallelizes bucket    */
/* build with kt_for, index.c:207; here a pthread pool sweeps the     */
/* segment list with an atomic work counter)                          */
/* ------------------------------------------------------------------ */
#include <pthread.h>

typedef struct {
    const uint8_t *seqs;
    const int64_t *off, *len, *rid, *out_off, *cap;
    int64_t n_seg, next;
    int w, k;
    uint64_t *out;
    int64_t *out_n;
    pthread_mutex_t mtx;
} skm_t;

static void *skm_worker(void *arg)
{
    skm_t *z = (skm_t *)arg;
    for (;;) {
        int64_t i;
        pthread_mutex_lock(&z->mtx);
        i = z->next++;
        pthread_mutex_unlock(&z->mtx);
        if (i >= z->n_seg) break;
        /* on cap overflow out_n[i] = -1 and the caller re-sketches
         * that segment through the doubling single-segment path */
        z->out_n[i] = mgt_sketch(z->seqs + z->off[i], z->len[i], z->w,
                                 z->k, (uint32_t)z->rid[i],
                                 z->out + 2 * z->out_off[i],
                                 z->cap[i]);
    }
    return 0;
}

/* out has 2*(out_off[i] + len[i] + 16) capacity per segment region
 * (interleaved x,y).  out_n[i] = record count or -1 on cap overflow. */
void mgt_sketch_many(const uint8_t *seqs, const int64_t *off,
                     const int64_t *len, const int64_t *rid,
                     const int64_t *out_off, const int64_t *cap,
                     int64_t n_seg, int32_t w, int32_t k,
                     int32_t n_threads, uint64_t *out, int64_t *out_n)
{
    skm_t z;
    pthread_t th[64];
    int i, nt = n_threads;

    if (!nt4_ready) nt4_init();   /* once, before the pool starts */
    if (nt < 1) nt = 1;
    if (nt > 64) nt = 64;
    if (nt > n_seg) nt = (int)(n_seg > 0 ? n_seg : 1);
    z.seqs = seqs, z.off = off, z.len = len, z.rid = rid;
    z.out_off = out_off, z.cap = cap, z.n_seg = n_seg, z.next = 0;
    z.w = w, z.k = k, z.out = out, z.out_n = out_n;
    pthread_mutex_init(&z.mtx, 0);
    if (nt == 1) {
        skm_worker(&z);
    } else {
        for (i = 0; i < nt; ++i) pthread_create(&th[i], 0, skm_worker, &z);
        for (i = 0; i < nt; ++i) pthread_join(th[i], 0);
    }
    pthread_mutex_destroy(&z.mtx);
}
