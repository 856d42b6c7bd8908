/* ds:Z difference-string generation from a graph CIGAR, semantics-equal
 * to the reference (mg_gchain_gen_ds, galign.c:182-293, and write_indel,
 * galign.c:153-180): runs of matches emit ":len", mismatches "*tq",
 * indels "+/-" followed by the inserted/deleted bases with microhomology
 * brackets.  Token start offsets are recorded for per-lchain splitting
 * of the ds string at GAF output time.
 */
#include <stdint.h>
#include <stddef.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static uint8_t ds_nt4[256];
static int ds_nt4_ready = 0;
static const char ds_acgtn[] = "acgtn";

static void ds_nt4_init(void)
{
    int i;
    for (i = 0; i < 256; ++i) ds_nt4[i] = 4;
    ds_nt4[0] = 0; ds_nt4[1] = 1; ds_nt4[2] = 2; ds_nt4[3] = 3;
    ds_nt4['A'] = ds_nt4['a'] = 0;
    ds_nt4['C'] = ds_nt4['c'] = 1;
    ds_nt4['G'] = ds_nt4['g'] = 2;
    ds_nt4['T'] = ds_nt4['t'] = 3;
    ds_nt4['U'] = ds_nt4['u'] = 3;
    ds_nt4_ready = 1;
}

/* Emit one indel's bases with microhomology brackets.  The indel of
 * length ln has ll bases of homology with the sequence following it
 * and lr bases with the sequence preceding it; the bracketed spans are
 * the movable prefix/suffix.  Expressed as a segment list: up to three
 * (start, end, bracketed) spans — prefix [0,ll), core [ll,ln-lr),
 * suffix [ln-lr,ln) — collapsing to one fully-bracketed span when the
 * homologies cover the whole indel. */
static int64_t ds_indel(char *out, const uint8_t *seq, int64_t ln,
                        int64_t ll, int64_t lr)
{
    int64_t seg[3][2], br[3];
    int64_t n = 0, s, i, n_seg;
    if (ll + lr >= ln) {
        seg[0][0] = 0; seg[0][1] = ln; br[0] = 1; n_seg = 1;
    } else {
        seg[0][0] = 0;       seg[0][1] = ll;      br[0] = 1;
        seg[1][0] = ll;      seg[1][1] = ln - lr; br[1] = 0;
        seg[2][0] = ln - lr; seg[2][1] = ln;      br[2] = 1;
        n_seg = 3;
    }
    for (s = 0; s < n_seg; ++s) {
        if (seg[s][0] == seg[s][1]) continue;
        if (br[s]) out[n++] = '[';
        for (i = seg[s][0]; i < seg[s][1]; ++i)
            out[n++] = ds_acgtn[ds_nt4[seq[i]]];
        if (br[s]) out[n++] = ']';
    }
    return n;
}

/* Longest prefix of the indel that matches the sequence continuing
 * after it (bases s[0..) vs s[ln..), scanning forward within bound). */
static int64_t ds_homol_fwd(const uint8_t *s, int64_t at, int64_t ln,
                            int64_t hi)
{
    int64_t h = 0;
    while (h < ln && at + ln + h < hi && s[at + h] == s[at + ln + h]) ++h;
    return h;
}

/* Longest suffix of the indel matching the sequence just before it. */
static int64_t ds_homol_bwd(const uint8_t *s, int64_t at, int64_t ln,
                            int64_t lo)
{
    int64_t h = 0;
    while (h < ln && at - 1 - h >= lo
           && s[at + ln - 1 - h] == s[at - 1 - h]) ++h;
    return h;
}

/* Returns the ds length written, or -1 if a capacity is exceeded.
 * tseq: the aligned target sequence (length aplen); qseq: the FULL
 * query, walked from qs to qe.  off_out gets the ds offset of each
 * token start; *n_off_out its count.  Token stream per reference
 * semantics (mg_gchain_gen_ds, galign.c:182-293): ":N" match runs,
 * "*tq" mismatches, "+/-" indels via ds_indel above. */
int64_t mgt_gen_ds(const uint32_t *cigar, int64_t n_cigar,
                   const uint8_t *tseq, int64_t aplen,
                   const uint8_t *qseq, int64_t qs, int64_t qe,
                   char *ds_out, int64_t ds_cap,
                   int64_t *off_out, int64_t off_cap,
                   int64_t *n_off_out)
{
    int64_t x = 0, y = qs, n = 0, n_off = 0, c;
    if (!ds_nt4_ready) ds_nt4_init();

#define TOKEN(need_) do { \
        if (n_off >= off_cap || n + (need_) > ds_cap) return -1; \
        off_out[n_off++] = n; \
    } while (0)

    for (c = 0; c < n_cigar; ++c) {
        int64_t op = cigar[c] & 0xf, ln = cigar[c] >> 4;
        if (op == 0 || op == 7 || op == 8) {
            /* two-pointer scan: a maximal match run, then one
             * mismatch, repeated */
            int64_t z = 0;
            while (z < ln) {
                int64_t r = z;
                while (r < ln && ds_nt4[tseq[x + r]] == ds_nt4[qseq[y + r]])
                    ++r;
                if (r > z) {
                    TOKEN(14);
                    n += snprintf(ds_out + n, 14, ":%lld",
                                  (long long)(r - z));
                }
                if (r < ln) {
                    TOKEN(3);
                    ds_out[n++] = '*';
                    ds_out[n++] = ds_acgtn[ds_nt4[tseq[x + r]]];
                    ds_out[n++] = ds_acgtn[ds_nt4[qseq[y + r]]];
                    ++r;
                }
                z = r;
            }
            x += ln, y += ln;
        } else if (op == 1) { /* insertion to the query */
            int64_t ll = ds_homol_fwd(qseq, y, ln, qe);
            int64_t lr = ds_homol_bwd(qseq, y, ln, qs);
            TOKEN(ln + 5);
            ds_out[n++] = '+';
            n += ds_indel(ds_out + n, qseq + y, ln, ll, lr);
            y += ln;
        } else if (op == 2) { /* deletion from the target */
            int64_t ll = ds_homol_fwd(tseq, x, ln, aplen);
            int64_t lr = ds_homol_bwd(tseq, x, ln, 0);
            TOKEN(ln + 5);
            ds_out[n++] = '-';
            n += ds_indel(ds_out + n, tseq + x, ln, ll, lr);
            x += ln;
        }
    }
#undef TOKEN
    *n_off_out = n_off;
    return n;
}

/* ------------------------------------------------------------------ */
/* Graph-chain base alignment: walk the anchors of one gchain, align
 * every inter-anchor gap with the exact wavefront engine and merge
 * into a single graph CIGAR (mg_gchain_cigar, galign.c:39-145).
 * Falls back to the Python path (return -1) when a gap exceeds the
 * WFA iteration budget (the reference then switches to the chained
 * heuristic) or a buffer capacity is hit; returns -2 on an internal
 * inconsistency the Python path would assert on. */

int32_t mgt_wfa_exact2(const char *ts0, int32_t tl, const char *qs0,
                       int32_t ql, int32_t px, int32_t po1, int32_t pe1,
                       int32_t po2, int32_t pe2, int32_t is_tb,
                       int32_t max_s, int64_t max_iter, int32_t step,
                       uint32_t **cigar_out, int32_t *n_cigar_out,
                       int64_t *n_iter_out);
void mgt_wfa_free(uint32_t *p);

#define MGT_SEED_IGNORE (1ULL << 41)

/* whole-path scratch for multi-vertex gaps; per worker thread */
static __thread char *tls_cig_scratch;
static __thread int64_t tls_cig_cap;

void mgt_cigar_tls_free(void)
{
    free(tls_cig_scratch);
    tls_cig_scratch = 0;
    tls_cig_cap = 0;
}

static void gc_push1(uint32_t *cig, int64_t *n, int64_t op, int64_t ln)
{
    if (*n > 0 && (int64_t)(cig[*n - 1] & 0xf) == op)
        cig[*n - 1] += (uint32_t)(ln << 4);
    else
        cig[(*n)++] = (uint32_t)(ln << 4 | op);
}

int64_t mgt_gchain_cigar(
    const uint64_t *ax, const uint64_t *ay,
    int64_t off_a0, int64_t n_anchor,
    const int64_t *lc_v, const int64_t *lc_off, const int64_t *lc_cnt,
    int64_t gc_off, int64_t gc_cnt,
    const char **seqp, const int64_t *seg_len,
    const char *q,
    uint32_t *cig_out, int64_t cig_cap,
    int64_t *stats_out /* [4]: mlen, blen, aplen, qtot */)
{

    int64_t l0 = gc_off, j0 = 0, j, n = 0, i;
    int64_t mlen = 0, blen = 0, aplen = 0, qtot = 0;

    if (n >= cig_cap) return -1;
    gc_push1(cig_out, &n, 7, (int64_t)((ay[off_a0] >> 32) & 0xFF));
    for (j = 1; j < n_anchor; ++j) {
        uint64_t py = ay[off_a0 + j], px = ax[off_a0 + j];
        int64_t l, qx32, px32, qy32, py32, l_seq, qlen;
        uint64_t qx, qy;
        const char *tseq;
        if ((py & MGT_SEED_IGNORE) && j != n_anchor - 1) continue;
        qx = ax[off_a0 + j0], qy = ay[off_a0 + j0];
        qx32 = (int32_t)qx, px32 = (int32_t)px;
        qy32 = (int32_t)qy, py32 = (int32_t)py;
        for (l = l0; l < gc_off + gc_cnt; ++l)
            if (lc_off[l] <= off_a0 + j &&
                off_a0 + j < lc_off[l] + lc_cnt[l]) break;
        if (l >= gc_off + gc_cnt) return -2;
        if (qx32 >= seg_len[lc_v[l0] >> 1]) return -2;
        if (l == l0) {
            l_seq = px32 - qx32;
            tseq = seqp[lc_v[l0]] + qx32 + 1;
        } else {
            int64_t need = seg_len[lc_v[l0] >> 1] - (qx32 + 1), k;
            for (k = l0 + 1; k < l; ++k) need += seg_len[lc_v[k] >> 1];
            need += px32 + 1;
            if (need > tls_cig_cap) {
                tls_cig_cap = need + (need >> 1) + 64;
                tls_cig_scratch = (char *)realloc(tls_cig_scratch,
                                                  tls_cig_cap);
                if (!tls_cig_scratch) { tls_cig_cap = 0; return -1; }
            }
            l_seq = seg_len[lc_v[l0] >> 1] - (qx32 + 1);
            memcpy(tls_cig_scratch, seqp[lc_v[l0]] + qx32 + 1,
                   l_seq);
            for (k = l0 + 1; k < l; ++k) {
                memcpy(tls_cig_scratch + l_seq, seqp[lc_v[k]],
                       seg_len[lc_v[k] >> 1]);
                l_seq += seg_len[lc_v[k] >> 1];
            }
            memcpy(tls_cig_scratch + l_seq, seqp[lc_v[l]],
                   px32 + 1);
            l_seq += px32 + 1;
            tseq = tls_cig_scratch;
        }
        qlen = py32 - qy32;
        if (l_seq <= 0 && qlen <= 0) return -2;
        if (n + 4 > cig_cap) return -1;
        if (l_seq == 0) gc_push1(cig_out, &n, 1, qlen);
        else if (qlen == 0) gc_push1(cig_out, &n, 2, l_seq);
        else if (l_seq == qlen && qlen <= (int64_t)((qy >> 32) & 0xFF))
            gc_push1(cig_out, &n, 7, qlen);
        else {
            uint32_t *wc = 0;
            int32_t n_wc = 0, s;
            int64_t n_it = 0;
            s = mgt_wfa_exact2(tseq, (int32_t)l_seq, q + qy32 + 1,
                               (int32_t)qlen, 4, 4, 2, 15, 1,
                               1 /* cigar */, 0, 100000000LL, 0,
                               &wc, &n_wc, &n_it);
            if (s < 0) {
                if (n_wc > 0) mgt_wfa_free(wc);
                return -1; /* over budget: python chain heuristic */
            }
            if (n_wc > 0) {
                if (n + n_wc + 1 > cig_cap) { mgt_wfa_free(wc); return -1; }
                gc_push1(cig_out, &n, wc[0] & 0xf, wc[0] >> 4);
                for (i = 1; i < n_wc; ++i) cig_out[n++] = wc[i];
                mgt_wfa_free(wc);
            }
        }
        j0 = j, l0 = l;
    }
    for (i = 0; i < n; ++i) {
        int64_t op = cig_out[i] & 0xf, ln = cig_out[i] >> 4;
        if (op == 7) mlen += ln, blen += ln;
        else blen += ln;
        if (op != 1) aplen += ln;
        if (op != 2) qtot += ln;
    }
    stats_out[0] = mlen, stats_out[1] = blen;
    stats_out[2] = aplen, stats_out[3] = qtot;
    return n;
}
