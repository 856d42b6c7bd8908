/* minigraph-tpu native host runtime: exact-order sorting kernels.
 *
 * The mapping pipeline's output parity depends on the *permutation* the
 * reference's in-place MSD radix sort produces for tied keys (it is
 * deterministic but not stable; cf. index.c:156 which re-sorts positions
 * precisely because of this).  We therefore reproduce the same algorithm:
 * 8-bit-digit most-significant-first in-place distribution ("American
 * flag" cycling) with a stable insertion sort for ranges of <= 64
 * elements.  This file is an original implementation of that textbook
 * algorithm, exposed as an argsort so Python/numpy callers can permute
 * arbitrary payloads.
 */
#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

typedef struct { uint64_t key, val; } mgt_pair_t;

#define MGT_RS_SMALL 64

static void mgt_insertion(mgt_pair_t *lo, mgt_pair_t *hi)
{
    mgt_pair_t *p, *q, t;
    for (p = lo + 1; p < hi; ++p) {
        if (p->key < (p - 1)->key) {
            t = *p;
            for (q = p; q > lo && t.key < (q - 1)->key; --q)
                *q = *(q - 1);
            *q = t;
        }
    }
}

static void mgt_flag_sort(mgt_pair_t *lo, mgt_pair_t *hi, int shift)
{
    mgt_pair_t *nxt[256]; /* next unplaced slot per bucket */
    mgt_pair_t *end[256]; /* end of each bucket's range    */
    mgt_pair_t *p, *start;
    int d;

    for (d = 0; d < 256; ++d) nxt[d] = end[d] = lo;
    for (p = lo; p < hi; ++p) ++end[(p->key >> shift) & 255];
    /* end[] currently holds counts as pointer offsets from lo; turn into
     * exclusive prefix ranges: bucket d occupies [nxt[d], end[d]) */
    start = lo;
    for (d = 0; d < 256; ++d) {
        ptrdiff_t cnt = end[d] - lo;
        nxt[d] = start;
        end[d] = start + cnt;
        start += cnt;
    }
    /* in-place cycling: for each bucket in order, place elements */
    for (d = 0; d < 256; ) {
        if (nxt[d] == end[d]) { ++d; continue; }
        int t = (int)((nxt[d]->key >> shift) & 255);
        if (t == d) { ++nxt[d]; continue; }
        {
            mgt_pair_t hold = *nxt[d], swap;
            do {
                swap = hold;
                hold = *nxt[t];
                *nxt[t]++ = swap;
                t = (int)((hold.key >> shift) & 255);
            } while (t != d);
            *nxt[d]++ = hold;
        }
    }
    /* recompute bucket starts and recurse into the next digit */
    if (shift) {
        int sub = shift > 8 ? shift - 8 : 0;
        start = lo;
        for (d = 0; d < 256; ++d) {
            mgt_pair_t *e = end[d];
            if (e - start > MGT_RS_SMALL) mgt_flag_sort(start, e, sub);
            else if (e - start > 1) mgt_insertion(start, e);
            start = e;
        }
    }
}

static void mgt_pair_sort(mgt_pair_t *a, int64_t n)
{
    if (n <= MGT_RS_SMALL) mgt_insertion(a, a + n);
    else {
        /* start the MSD recursion at the first VARYING byte: most
         * callers' keys share a long constant prefix (small vertex
         * ids / chain scores in the top bytes), and a constant-byte
         * level is an order-preserving full pass over the data —
         * skipping it yields the identical permutation for a
         * fraction of the work */
        uint64_t varies = 0, k0 = a[0].key;
        int64_t i;
        int shift;
        for (i = 1; i < n; ++i) varies |= a[i].key ^ k0;
        if (!varies) return;
        shift = 56 - (__builtin_clzll(varies) & ~7);
        mgt_flag_sort(a, a + n, shift);
    }
}

/* Argsort of uint64 keys with the reference-exact tie permutation.
 * idx[] receives the permutation (idx[i] = original position of the
 * element now at rank i). */
void mgt_radix_argsort_u64(const uint64_t *keys, uint64_t *idx, int64_t n)
{
    int64_t i;
    mgt_pair_t *a = (mgt_pair_t *)malloc(sizeof(mgt_pair_t) * (size_t)n);
    if (!a) return;
    for (i = 0; i < n; ++i) { a[i].key = keys[i]; a[i].val = (uint64_t)i; }
    mgt_pair_sort(a, n);
    for (i = 0; i < n; ++i) idx[i] = a[i].val;
    free(a);
}

/* In-place sort of (x, y) pairs by x, matching radix_sort_128x. a has
 * 2*n uint64s laid out as x0,y0,x1,y1,... */
void mgt_radix_sort_128x(uint64_t *a, int64_t n)
{
    mgt_pair_sort((mgt_pair_t *)a, n);
}
