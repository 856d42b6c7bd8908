/* GAF serialization straight off the native chain-table scratch
 * (mg_write_gaf, format.c:121-291): the per-read fast path goes
 * anchors -> chains -> selection -> GAF bytes without ever building
 * Python objects.  Only the plain single-segment GAF shape is
 * handled (no CIGAR/ds, no per-chain -S dump, no vertex coords, no
 * fragment merging) -- the caller gates on those flags and routes
 * such reads through the Python serializer instead.
 */
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

typedef struct {
    char *p, *end;
    int ovf;
} gbuf_t;

static inline void gb_mem(gbuf_t *b, const char *s, int64_t n)
{
    if (b->p + n > b->end) { b->ovf = 1; return; }
    memcpy(b->p, s, (size_t)n);
    b->p += n;
}

static inline void gb_c(gbuf_t *b, char c)
{
    if (b->p >= b->end) { b->ovf = 1; return; }
    *b->p++ = c;
}

static inline void gb_i(gbuf_t *b, int64_t v)
{
    char tmp[24];
    int n = snprintf(tmp, sizeof(tmp), "%lld", (long long)v);
    gb_mem(b, tmp, n);
}

/* dv:f formatting: "0" when exactly zero, else %.4f of the f32 value
 * (format.c uses %g-compatible %.4f; the Python serializer pins the
 * same rule in seqio/gaf.py:_fmt_div) */
static inline void gb_div(gbuf_t *b, float dv)
{
    if (dv == 0.0f) { gb_c(b, '0'); return; }
    char tmp[32];
    int n = snprintf(tmp, sizeof(tmp), "%.4f", (double)dv);
    if (n > 15) n = 15;
    gb_mem(b, tmp, n);
}

/* IUPAC complement (graph/gfa.py COMP_TABLE: identity outside the
 * alphabet, case preserved) */
static inline char gaf_comp(uint8_t ch)
{
    static const char dst[] = "TVGHEFCDIJMLKNOPQYSAABWXRZ";
    if (ch >= 'A' && ch <= 'Z') return dst[ch - 'A'];
    if (ch >= 'a' && ch <= 'z') return (char)(dst[ch - 'a'] + 32);
    return (char)ch;
}


/* Returns bytes written, or -1 when `cap` is too small (caller grows
 * the buffer and retries). */
int64_t mgt_format_gaf(
    /* graph name context (built once per Graph by the caller) */
    const char *seg_nm, const int64_t *seg_nm_off,
    const int64_t *seg_len, const int64_t *seg_snid,
    const int64_t *seg_soff,
    const char *ss_nm, const int64_t *ss_nm_off,
    const int64_t *ss_min, const int64_t *ss_max, const int64_t *ss_rank,
    /* read + selected chain tables (mgt_gchain_full/mgt_select layout) */
    const char *qname, int64_t qname_len, int64_t qlen,
    int64_t n_gc,
    const int64_t *lv, const int64_t *loff, const int64_t *lcnt,
    const uint64_t *o_ay,
    const int64_t *g_off, const int64_t *g_cnt, const int64_t *g_na,
    const int64_t *g_sc, const int64_t *g_extra /* (n_gc, 8) */,
    const int64_t *sel_parent, const int64_t *sel_mapq,
    const int64_t *sel_subsc,
    int64_t print_2nd, int64_t no_comp_path, int64_t show_unmap,
    /* fragment shape: n_seg query segments (paired-end = 2) with
     * lengths qlens[]; frag_merge trims a trailing "/1" from the
     * name and emits the ql:B:i tag (format.c frag rules) */
    int64_t n_seg, int64_t frag_merge, const int64_t *qlens,
    /* optional per-chain base-level results (-c mode); all NULL when
     * absent.  cig_p[c]: CIGAR words, cig_n[c] their count;
     * cig_stats[4c..]: mlen, blen, aplen, qtot; ds_p[c]: ds token
     * stream, ds_n[c] its length, ds_off_p[c]/ds_noff[c] the token
     * offsets (for the reverse-complement transform). */
    const uint32_t *const *cig_p, const int64_t *cig_n,
    const int64_t *cig_stats,
    const char *const *ds_p, const int64_t *ds_n,
    const int64_t *const *ds_off_p, const int64_t *ds_noff,
    char *buf, int64_t cap)
{
    gbuf_t b = { buf, buf + cap, 0 };
    int64_t c;

    if (frag_merge && n_seg == 2 && qname_len > 2
        && qname[qname_len - 1] == '1' && qname[qname_len - 2] == '/')
        qname_len -= 2;
    if (n_gc == 0) {
        if (show_unmap) {
            gb_mem(&b, qname, qname_len);
            gb_c(&b, '\t');
            gb_i(&b, qlen);
            gb_mem(&b, "\t0\t0\t*\t*\t0\t0\t0\t0\t0\t0\n",
                   (int64_t)sizeof("\t0\t0\t*\t*\t0\t0\t0\t0\t0\t0\n") - 1);
        }
        return b.ovf ? -1 : (int64_t)(b.p - buf);
    }
    for (c = 0; c < n_gc; ++c) {
        const int64_t *ex = g_extra + 8 * c;
        int64_t cnt = g_cnt[c], off = g_off[c];
        int64_t last_pnid = -1, st = -1, en = -1, rev = -1;
        int compact, rev_sign = 0;
        char *sign_pos;
        int64_t j;

        if (c != sel_parent[c] && !print_2nd) continue;
        if (cnt == 0) continue;
        gb_mem(&b, qname, qname_len);
        gb_c(&b, '\t');
        gb_i(&b, qlen);
        gb_c(&b, '\t');
        gb_i(&b, ex[0]);               /* qs */
        gb_c(&b, '\t');
        gb_i(&b, ex[1]);               /* qe */
        gb_c(&b, '\t');
        sign_pos = b.p;
        gb_c(&b, '+');
        gb_c(&b, '\t');
        /* path column: run-compacted stable coordinates
         * (write_gaf, format.c:160-213) */
        compact = no_comp_path ? 0 : 1;
        for (j = 0; j < cnt; ++j) {
            int64_t v = lv[off + j], sid = v >> 1;
            int64_t snid = seg_snid[sid];
            if (snid < 0) {
                compact = 0;
                if (last_pnid >= 0) {
                    gb_c(&b, rev ? '<' : '>');
                    gb_mem(&b, ss_nm + ss_nm_off[last_pnid],
                           ss_nm_off[last_pnid + 1] - ss_nm_off[last_pnid]);
                    gb_c(&b, ':');
                    gb_i(&b, st);
                    gb_c(&b, '-');
                    gb_i(&b, en);
                }
                last_pnid = -1, st = en = rev = -1;
                gb_c(&b, (v & 1) ? '<' : '>');
                gb_mem(&b, seg_nm + seg_nm_off[sid],
                       seg_nm_off[sid + 1] - seg_nm_off[sid]);
            } else {
                int cont = 0;
                if (last_pnid >= 0 && snid == last_pnid && (v & 1) == rev) {
                    if (!(v & 1)) {
                        if (seg_soff[sid] == en)
                            en = seg_soff[sid] + seg_len[sid], cont = 1;
                    } else {
                        if (seg_soff[sid] + seg_len[sid] == st)
                            st = seg_soff[sid], cont = 1;
                    }
                }
                if (cont == 0) {
                    if (last_pnid >= 0) {
                        compact = 0;
                        gb_c(&b, rev ? '<' : '>');
                        gb_mem(&b, ss_nm + ss_nm_off[last_pnid],
                               ss_nm_off[last_pnid + 1]
                                   - ss_nm_off[last_pnid]);
                        gb_c(&b, ':');
                        gb_i(&b, st);
                        gb_c(&b, '-');
                        gb_i(&b, en);
                    }
                    last_pnid = snid, rev = v & 1;
                    st = seg_soff[sid];
                    en = st + seg_len[sid];
                }
            }
        }
        if (last_pnid >= 0) {
            if (ss_rank[last_pnid] != 0 || ss_min[last_pnid] != 0)
                compact = 0;
            if (!compact) {
                gb_c(&b, rev ? '<' : '>');
                gb_mem(&b, ss_nm + ss_nm_off[last_pnid],
                       ss_nm_off[last_pnid + 1] - ss_nm_off[last_pnid]);
                gb_c(&b, ':');
                gb_i(&b, st);
                gb_c(&b, '-');
                gb_i(&b, en);
            }
        } else compact = 0;
        if (compact) {
            /* single rank-0 stable run: PAF-style stable coordinates */
            int64_t v0 = lv[off], sid;
            int64_t vrev = v0 & 1;
            sid = lv[off + (vrev ? cnt - 1 : 0)] >> 1;
            int64_t snid = seg_snid[sid];
            gb_mem(&b, ss_nm + ss_nm_off[snid],
                   ss_nm_off[snid + 1] - ss_nm_off[snid]);
            gb_c(&b, '\t');
            gb_i(&b, ss_max[snid]);
            gb_c(&b, '\t');
            if (vrev) {
                rev_sign = 1;
                /* flip the already-written '+': guarded because on
                 * the grow-and-retry pass the buffer may have been
                 * too small for even the columns before it */
                if (sign_pos < b.end) *sign_pos = '-';
                gb_i(&b, seg_soff[sid] + (ex[4] - ex[3]));  /* plen-pe */
                gb_c(&b, '\t');
                gb_i(&b, seg_soff[sid] + (ex[4] - ex[2]));  /* plen-ps */
            } else {
                gb_i(&b, seg_soff[sid] + ex[2]);            /* ps */
                gb_c(&b, '\t');
                gb_i(&b, seg_soff[sid] + ex[3]);            /* pe */
            }
        } else {
            gb_c(&b, '\t');
            gb_i(&b, ex[4]);           /* plen */
            gb_c(&b, '\t');
            gb_i(&b, ex[2]);           /* ps */
            gb_c(&b, '\t');
            gb_i(&b, ex[3]);           /* pe */
        }
        {
            int has_cig = cig_p != 0 && cig_p[c] != 0;
            int64_t mlen = has_cig ? cig_stats[4 * c] : ex[6];
            int64_t blen = has_cig ? cig_stats[4 * c + 1] : ex[5];
            gb_c(&b, '\t');
            gb_i(&b, mlen);
            gb_c(&b, '\t');
            gb_i(&b, blen);
            gb_c(&b, '\t');
            gb_i(&b, sel_mapq[c]);
            gb_mem(&b, "\ttp:A:", 6);
            gb_c(&b, c == sel_parent[c] ? 'P' : 'S');
            if (has_cig) {
                gb_mem(&b, "\tNM:i:", 6);
                gb_i(&b, blen - mlen);
            }
        }
        gb_mem(&b, "\tcm:i:", 6);
        gb_i(&b, g_na[c]);
        gb_mem(&b, "\ts1:i:", 6);
        gb_i(&b, g_sc[c]);
        gb_mem(&b, "\ts2:i:", 6);
        gb_i(&b, sel_subsc[c]);
        {
            /* divergence estimate (gchain1.c:289-296): f32 of
             * log(max/min)/q_span, printed only inside [0, 1] */
            int64_t n_mini = ex[7], n_anchor = g_na[c];
            int64_t q_span =
                (int64_t)((o_ay[loff[off]] >> 32) & 0xFF);
            double r = n_mini >= n_anchor
                ? (double)n_mini / (double)n_anchor
                : (double)n_anchor / (double)n_mini;
            float dv = (float)(log(r) / (double)q_span);
            if (dv >= 0.0f && dv <= 1.0f) {
                gb_mem(&b, "\tdv:f:", 6);
                gb_div(&b, dv);
            }
        }
        if (n_seg > 1) {
            int64_t s;
            gb_mem(&b, "\tql:B:i", 7);
            for (s = 0; s < n_seg; ++s) {
                gb_c(&b, ',');
                gb_i(&b, qlens[s]);
            }
        }
        if (cig_p != 0 && cig_p[c] != 0) {
            /* cg:Z (reversed on a compact reverse-strand line) and
             * ds:Z (token-wise reverse complement likewise); mirrors
             * seqio/gaf.py write_gaf / format.c:221-249 */
            static const char ops[] = "MIDNSHP=XB";
            const uint32_t *cg = cig_p[c];
            int64_t ncg = cig_n[c], j;
            gb_mem(&b, "\tcg:Z:", 6);
            for (j = 0; j < ncg; ++j) {
                uint32_t w = cg[rev_sign ? ncg - 1 - j : j];
                gb_i(&b, (int64_t)(w >> 4));
                gb_c(&b, ops[w & 0xF]);
            }
            if (ds_p != 0 && ds_p[c] != 0 && ds_n[c] > 0) {
                const char *ds = ds_p[c];
                gb_mem(&b, "\tds:Z:", 6);
                if (!rev_sign) gb_mem(&b, ds, ds_n[c]);
                else {
                    const int64_t *doff = ds_off_p[c];
                    int64_t no = ds_noff[c], t;
                    for (t = no - 1; t >= 0; --t) {
                        int64_t st = doff[t];
                        int64_t en = t + 1 < no ? doff[t + 1] : ds_n[c];
                        char tok = ds[st];
                        gb_c(&b, tok);
                        if (tok == ':') gb_mem(&b, ds + st + 1,
                                               en - st - 1);
                        else if (tok == '*') {
                            for (j = st + 1; j < en; ++j)
                                gb_c(&b, gaf_comp((uint8_t)ds[j]));
                        } else {
                            for (j = en - 1; j > st; --j) {
                                char ch = ds[j];
                                gb_c(&b, ch == '[' ? ']'
                                     : ch == ']' ? '['
                                     : gaf_comp((uint8_t)ch));
                            }
                        }
                    }
                }
            }
        }
        gb_c(&b, '\n');
    }
    return b.ovf ? -1 : (int64_t)(b.p - buf);
}
