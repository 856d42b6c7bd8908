/* Per-read seed collection: sketch -> index probe -> anchor build ->
 * reference-exact sort, in one native call (collect_minimizers +
 * collect_seed_hits, map-algo.c:34-45 and 58-192).  Single-segment
 * reads only; multi-segment fragments and the -D self-diagonal filter
 * stay on the Python path (the caller gates).
 *
 * The index is probed by binary search over the flat sorted key
 * table (index/midx.py layout: keys / key_start / key_cnt / pos).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

extern int64_t mgt_sketch(const uint8_t *seq, int64_t len, int w, int k,
                          uint32_t rid, uint64_t *out, int64_t cap);
extern void mgt_radix_sort_128x(uint64_t *a, int64_t n);

#define SEED_TANDEM (1ULL << 42)
#define SEG_SHIFT 48
#define OCC_SHIFT 56

static inline int64_t key_find(const uint64_t *keys, int64_t n,
                               uint64_t m)
{
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (keys[mid] < m) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

/* Open-addressing probe table over the sorted key array: one O(1)
 * lookup instead of a ~19-step cache-missy binary search per
 * minimizer (the reference probes a bucket hash, index.c:77).
 * Slot = (key, start<<24 | cnt) with cnt saturated at 2^24-1
 * (occ_max caps far below); empty slots hold key = ~0. */
#define HSLOT_EMPTY (~0ULL)

static inline uint64_t h64(uint64_t key)
{                                      /* kh_hash64 finalizer */
    key = ~key + (key << 21);
    key = key ^ (key >> 24);
    key = (key + (key << 3)) + (key << 8);
    key = key ^ (key >> 14);
    key = (key + (key << 2)) + (key << 4);
    key = key ^ (key >> 28);
    key = key + (key << 31);
    return key;
}

/* Fill `tab` (2*n_slots u64, n_slots a power of two >= 2*n_keys). */
void mgt_collect_hash_build(const uint64_t *keys,
                            const int64_t *key_start,
                            const int64_t *key_cnt, int64_t n_keys,
                            uint64_t *tab, int64_t n_slots)
{
    int64_t i;
    uint64_t mask = (uint64_t)n_slots - 1;
    for (i = 0; i < 2 * n_slots; i += 2) tab[i] = HSLOT_EMPTY;
    for (i = 0; i < n_keys; ++i) {
        uint64_t s = h64(keys[i]) & mask;
        uint64_t cnt = key_cnt[i] < 0xFFFFFF
            ? (uint64_t)key_cnt[i] : 0xFFFFFFULL;
        while (tab[2 * s] != HSLOT_EMPTY) s = (s + 1) & mask;
        tab[2 * s] = keys[i];
        tab[2 * s + 1] = (uint64_t)key_start[i] << 24 | cnt;
    }
}

static inline void hash_probe(const uint64_t *tab, uint64_t mask,
                              uint64_t m, int64_t *st, int64_t *cnt)
{
    uint64_t s = h64(m) & mask;
    for (;;) {
        uint64_t k = tab[2 * s];
        if (k == m) {
            uint64_t v = tab[2 * s + 1];
            *st = (int64_t)(v >> 24);
            *cnt = (int64_t)(v & 0xFFFFFF);
            return;
        }
        if (k == HSLOT_EMPTY) { *st = *cnt = 0; return; }
        s = (s + 1) & mask;
    }
}

/* Probe + anchor build + order stage shared by the single-read and
 * fragment entries.  use_heap selects the short-read heap-merge
 * emission (collect_seed_hits_heap, map-algo.c:93-150) instead of
 * the build-then-radix-sort order. */
/* Thread-local grow-only scratch: collect runs once per read inside
 * the batch workers, and 5 malloc/free pairs per 150 bp short read
 * are measurable.  Freed via mgt_collect_tls_free at worker exit. */
static __thread uint64_t *cs_mini;     /* minier + pcnt + pstart rows */
static __thread int64_t cs_mini_m;
static __thread uint64_t *cs_z;
static __thread int64_t cs_z_m;
static __thread uint64_t *cs_ay2;
static __thread int64_t cs_ay2_m;
static __thread void *cs_heap;
static __thread int64_t cs_heap_m;

void mgt_collect_tls_free(void)
{
    free(cs_mini); cs_mini = 0; cs_mini_m = 0;
    free(cs_z); cs_z = 0; cs_z_m = 0;
    free(cs_ay2); cs_ay2 = 0; cs_ay2_m = 0;
    free(cs_heap); cs_heap = 0; cs_heap_m = 0;
}

static int64_t collect_body(
    uint64_t *mv, int64_t n_mv, int64_t max_occ,
    const uint64_t *keys, const int64_t *key_start,
    const int64_t *key_cnt, int64_t n_keys, const uint64_t *pos,
    const int64_t *seg_len,
    const uint64_t *htab, int64_t n_slots, int64_t use_heap,
    uint64_t *ax, uint64_t *ay, int64_t a_cap,
    int64_t *mini_pos, int64_t mp_cap,
    int64_t *out_meta)
{
    int64_t i, j, n_a = 0, n_mini = 0, need_a = 0;
    int64_t rep_len = 0, rep_st = 0, rep_en = 0, ret = -2;
    uint64_t *z = 0, *minier = 0, *ay2 = 0;
    int64_t *pcnt = 0, *pstart = 0;

    if (3 * n_mv > cs_mini_m) {
        free(cs_mini);
        cs_mini_m = 3 * n_mv + 192;
        cs_mini = (uint64_t *)malloc(8 * (size_t)cs_mini_m);
        if (!cs_mini) { cs_mini_m = 0; goto done; }
    }
    minier = cs_mini;
    pcnt = (int64_t *)(cs_mini + n_mv);
    pstart = (int64_t *)(cs_mini + 2 * n_mv);

    /* pass 1: probe + repeat-length accounting + output sizes */
    for (i = 0; i < n_mv; ++i) {
        uint64_t m = mv[2 * i] >> 8;
        int64_t cnt = 0, st = 0;
        if (htab != 0) {
            hash_probe(htab, (uint64_t)n_slots - 1, m, &st, &cnt);
        } else {
            int64_t p = key_find(keys, n_keys, m);
            if (p < n_keys && keys[p] == m)
                cnt = key_cnt[p], st = key_start[p];
        }
        minier[i] = m, pcnt[i] = cnt, pstart[i] = st;
        if (cnt >= max_occ) {
            /* repeat-length over high-occ minimizers (map-algo.c:72) */
            int64_t q_pos = (int64_t)(uint32_t)mv[2 * i + 1];
            int64_t span = (int64_t)(mv[2 * i] & 0xFF);
            int64_t en = (q_pos >> 1) + 1, st2 = en - span;
            if (st2 > rep_en) {
                rep_len += rep_en - rep_st;
                rep_st = st2, rep_en = en;
            } else rep_en = en;
        } else {
            need_a += cnt;
            ++n_mini;
        }
    }
    rep_len += rep_en - rep_st;
    out_meta[0] = need_a;
    out_meta[2] = rep_len;
    out_meta[3] = n_mini;
    if (need_a > a_cap || n_mini > mp_cap) { ret = -1; goto done; }

    if (use_heap) {
        /* heap-merge emission (collect_seed_hits_heap,
         * map-algo.c:93-150): anchors come out sorted by construction
         * — forward filled from the front, reverse from the back in
         * pop order.  The heap compares hit values only, with the
         * ksort heapdown shape, so tie layout matches the
         * reference/Python emulation exactly. */
        typedef struct { uint64_t x, y; } he_t;
        he_t *hp = 0;
        int64_t *k_idx = 0;
        int64_t hs = 0, n_for = 0, n_rev = 0;
        int64_t heap_need = (8 + (int64_t)sizeof(he_t)) * out_meta[3] + 64;
        n_mini = 0;
        if (heap_need > cs_heap_m) {
            free(cs_heap);
            cs_heap_m = heap_need + (heap_need >> 1);
            cs_heap = malloc((size_t)cs_heap_m);
            if (!cs_heap) { cs_heap_m = 0; goto done; }
        }
        k_idx = (int64_t *)cs_heap;
        hp = (he_t *)(k_idx + out_meta[3] + 1);
        for (i = 0; i < n_mv; ++i) {
            if (pcnt[i] >= max_occ) continue;
            mini_pos[n_mini] = (int64_t)((uint32_t)mv[2 * i + 1]) >> 1;
            k_idx[n_mini] = i;
            if (pcnt[i] > 0) {
                hp[hs].x = pos[pstart[i]];
                hp[hs].y = (uint64_t)n_mini << 32;
                ++hs;
            }
            ++n_mini;
        }
        /* ks_heapmake/ks_heapdown with lt = (x >) */
#define HP_DOWN(i0, n) do {                                         \
            int64_t ii = (i0), kk = (i0);                           \
            he_t tmp = hp[ii];                                      \
            for (;;) {                                              \
                kk = (kk << 1) + 1;                                 \
                if (kk >= (n)) break;                               \
                if (kk != (n) - 1 && hp[kk].x > hp[kk + 1].x) ++kk; \
                if (hp[kk].x > tmp.x) break;                        \
                hp[ii] = hp[kk];                                    \
                ii = kk;                                            \
            }                                                       \
            hp[ii] = tmp;                                           \
        } while (0)
        for (i = (hs >> 1) - 1; i >= 0; --i) HP_DOWN(i, hs);
        while (hs > 0) {
            int64_t kmi = (int64_t)(hp[0].y >> 32);
            int64_t im = k_idx[kmi];
            uint64_t r = hp[0].x;
            int64_t rid = (int64_t)(r >> 32);
            int64_t rpos = (int64_t)((uint32_t)r >> 1);
            int64_t q_pos = (int64_t)(uint32_t)mv[2 * im + 1];
            int64_t span = (int64_t)(mv[2 * im] & 0xFF);
            int64_t seg = (int64_t)(mv[2 * im + 1] >> 32);
            int64_t occ = pcnt[im] < 255 ? pcnt[im] : 255;
            int tandem = (im > 0 && minier[im - 1] == minier[im])
                || (im + 1 < n_mv && minier[im + 1] == minier[im]);
            int64_t po;
            uint64_t x;
            if (((r ^ (uint64_t)q_pos) & 1) == 0) {
                x = (uint64_t)rid << 33 | (uint64_t)rpos;
                po = n_for++;
            } else {
                x = (uint64_t)rid << 33 | (1ULL << 32)
                    | (uint64_t)(seg_len[rid] - (rpos + 1 - span) - 1);
                po = need_a - ++n_rev;
            }
            ax[po] = x;
            ay[po] = (uint64_t)occ << OCC_SHIFT
                | (uint64_t)seg << SEG_SHIFT
                | (tandem ? SEED_TANDEM : 0)
                | (uint64_t)span << 32
                | (uint64_t)(q_pos >> 1);
            {
                int64_t hit = (int64_t)(uint32_t)hp[0].y;
                if (hit < pcnt[im] - 1) {
                    hp[0].y = (uint64_t)kmi << 32
                        | (uint64_t)(hit + 1);
                    hp[0].x = pos[pstart[im] + hit + 1];
                } else {
                    hp[0] = hp[hs - 1];
                    --hs;
                }
            }
            HP_DOWN(0, hs);
        }
#undef HP_DOWN
        if (need_a > n_for + n_rev) {
            memmove(ax + n_for, ax + need_a - n_rev,
                    8 * (size_t)n_rev);
            memmove(ay + n_for, ay + need_a - n_rev,
                    8 * (size_t)n_rev);
        }
        out_meta[0] = n_for + n_rev;
        ret = 0;
        goto done;
    }
    if (need_a > 0) {
        if (2 * need_a > cs_z_m) {
            free(cs_z);
            cs_z_m = 2 * need_a + 128;
            cs_z = (uint64_t *)malloc(8 * (size_t)cs_z_m);
            if (!cs_z) { cs_z_m = 0; goto done; }
        }
        z = cs_z;
    }
    /* pass 2: anchors + kept minimizer positions */
    n_mini = 0;
    for (i = 0; i < n_mv; ++i) {
        int64_t cnt = pcnt[i];
        int64_t span = (int64_t)(mv[2 * i] & 0xFF);
        int64_t q_pos = (int64_t)(uint32_t)mv[2 * i + 1];
        int64_t seg = (int64_t)(mv[2 * i + 1] >> 32);
        int tandem;
        if (cnt >= max_occ) continue;
        mini_pos[n_mini++] = q_pos >> 1;
        if (cnt == 0) continue;
        /* same minimizer as an adjacent query minimizer */
        tandem = (i > 0 && minier[i - 1] == minier[i])
              || (i + 1 < n_mv && minier[i + 1] == minier[i]);
        {
            int64_t occ = cnt < 255 ? cnt : 255;
            for (j = 0; j < cnt; ++j) {
                uint64_t r = pos[pstart[i] + j];
                int64_t rid = (int64_t)(r >> 32);
                int64_t rpos = (int64_t)((uint32_t)r >> 1);
                int64_t rev = (int64_t)((r ^ (uint64_t)q_pos) & 1);
                int64_t tpos = rev == 0 ? rpos
                    : seg_len[rid] - (rpos + 1 - span) - 1;
                z[2 * n_a] = (uint64_t)rid << 33
                    | (uint64_t)rev << 32 | (uint64_t)tpos;
                ay[n_a] = (uint64_t)occ << OCC_SHIFT
                    | (uint64_t)seg << SEG_SHIFT
                    | (tandem ? SEED_TANDEM : 0)
                    | (uint64_t)span << 32
                    | (uint64_t)(q_pos >> 1);
                z[2 * n_a + 1] = (uint64_t)n_a;
                ++n_a;
            }
        }
    }

    if (n_a > 0) {
        if (n_a > cs_ay2_m) {
            free(cs_ay2);
            cs_ay2_m = n_a + (n_a >> 1) + 64;
            cs_ay2 = (uint64_t *)malloc(8 * (size_t)cs_ay2_m);
            if (!cs_ay2) { cs_ay2_m = 0; goto done; }
        }
        ay2 = cs_ay2;
        mgt_radix_sort_128x(z, n_a);   /* reference-exact permutation */
        for (i = 0; i < n_a; ++i) {
            ax[i] = z[2 * i];
            ay2[i] = ay[(int64_t)z[2 * i + 1]];
        }
        memcpy(ay, ay2, 8 * (size_t)n_a);
    }
    out_meta[0] = n_a;
    ret = 0;
done:
    return ret;
}

/* out_meta: [0]=n_a, [1]=n_mv, [2]=rep_len, [3]=n_mini.
 * Returns 0 ok, -1 caps too small (needed sizes in out_meta; caller
 * grows + retries), -2 allocation failure. */
int64_t mgt_collect(
    const uint8_t *seq, int64_t qlen, int64_t w, int64_t k,
    int64_t max_occ,
    const uint64_t *keys, const int64_t *key_start,
    const int64_t *key_cnt, int64_t n_keys, const uint64_t *pos,
    const int64_t *seg_len,
    const uint64_t *htab, int64_t n_slots,
    uint64_t *mv, int64_t mv_cap,
    uint64_t *ax, uint64_t *ay, int64_t a_cap,
    int64_t *mini_pos, int64_t mp_cap,
    int64_t *out_meta)
{
    int64_t n_mv;
    out_meta[0] = out_meta[1] = out_meta[2] = out_meta[3] = 0;
    n_mv = mgt_sketch(seq, qlen, w, k, 0, mv, mv_cap);
    /* overflow estimate must be an upper bound: low-complexity runs
     * emit ~1 record per base plus first-window ties */
    if (n_mv < 0) { out_meta[1] = qlen + w + 64; return -1; }
    out_meta[1] = n_mv;
    if (n_mv == 0) return 0;
    return collect_body(mv, n_mv, max_occ, keys, key_start, key_cnt,
                        n_keys, pos, seg_len, htab, n_slots, 0,
                        ax, ay, a_cap, mini_pos, mp_cap, out_meta);
}

/* Multi-segment fragment entry (collect_minimizers, map-algo.c:34-45):
 * each segment is sketched with its ordinal as rid and positions are
 * offset by the cumulative length; use_heap selects the short-read
 * heap emission.  seg_off has n_segs+1 offsets into seq_blob. */
int64_t mgt_collect_frag(
    const uint8_t *seq_blob, const int64_t *seg_off, int64_t n_segs,
    int64_t w, int64_t k, int64_t max_occ, int64_t use_heap,
    const uint64_t *keys, const int64_t *key_start,
    const int64_t *key_cnt, int64_t n_keys, const uint64_t *pos,
    const int64_t *seg_len,
    const uint64_t *htab, int64_t n_slots,
    uint64_t *mv, int64_t mv_cap,
    uint64_t *ax, uint64_t *ay, int64_t a_cap,
    int64_t *mini_pos, int64_t mp_cap,
    int64_t *out_meta)
{
    int64_t n_mv = 0, s, total = 0, qlen_sum;
    out_meta[0] = out_meta[1] = out_meta[2] = out_meta[3] = 0;
    qlen_sum = seg_off[n_segs] - seg_off[0];
    for (s = 0; s < n_segs; ++s) {
        int64_t sl = seg_off[s + 1] - seg_off[s];
        int64_t n1 = mgt_sketch(seq_blob + seg_off[s], sl, w, k,
                                (uint32_t)s, mv + 2 * n_mv,
                                mv_cap - n_mv);
        /* upper bound, not an estimate (see mgt_collect) */
        if (n1 < 0) { out_meta[1] = qlen_sum + n_segs * (w + 64); return -1; }
        if (total > 0) {
            int64_t i;
            for (i = 0; i < n1; ++i)
                mv[2 * (n_mv + i) + 1] += (uint64_t)(total << 1);
        }
        n_mv += n1;
        total += sl;
    }
    out_meta[1] = n_mv;
    if (n_mv == 0) return 0;
    return collect_body(mv, n_mv, max_occ, keys, key_start, key_cnt,
                        n_keys, pos, seg_len, htab, n_slots, use_heap,
                        ax, ay, a_cap, mini_pos, mp_cap, out_meta);
}
