/* Native FASTA/FASTQ batch reader (bseq.c:61-98 semantics, gzip
 * transparent via zlib).  Feeds the batch mapping driver directly:
 * records land in reusable name/sequence arenas (offset-indexed),
 * already uppercased with U->T, so the hot path never builds
 * per-read Python objects.  Batch boundary rule matches
 * seqio/bseq.py BSeqFile.read_batch (append records until total
 * bases >= max_bp, including the crossing record; no pending).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

typedef struct {                /* one output arena set */
    char *sq;                   /* sequence arena (transformed) */
    int64_t sq_cap;
    char *nm;                   /* name arena */
    int64_t nm_cap;
    int64_t *sq_off, *nm_off;
    int64_t off_cap;
} sr_arena_t;

typedef struct {
    gzFile fp;
    char *buf;                  /* raw line buffer window */
    int64_t len, pos, cap;
    int eof, err;
    sr_arena_t ar[3];           /* triple-buffered: batches k and k-1
                                 * stay valid while k+1 is read, so a
                                 * pipelined consumer can hold one
                                 * finished batch (device tails) while
                                 * the prefetch thread decodes ahead */
    int cur;
    int have_hdr;               /* lookahead: header line pending */
    char *hdr; int64_t hdr_len, hdr_cap;
    /* frag mode: a record read past the batch boundary whose name
     * broke the same-name run belongs to the NEXT batch */
    int have_pend;
    char *pn, *ps; int64_t pn_len, ps_len, pn_cap, ps_cap;
} mgt_sr_t;

static unsigned char sr_map[256];
static int sr_map_ready = 0;

static void sr_map_init(void)
{
    int i;
    for (i = 0; i < 256; ++i)
        sr_map[i] = (unsigned char)(i >= 'a' && i <= 'z' ? i - 32 : i);
    sr_map['u'] = sr_map['U'] = 'T';
    sr_map_ready = 1;
}

void *mgt_seq_open(const char *fn)
{
    mgt_sr_t *r = (mgt_sr_t *)calloc(1, sizeof(mgt_sr_t));
    if (!r) return 0;
    if (!sr_map_ready) sr_map_init();
    r->fp = gzopen(fn, "rb");
    if (!r->fp) { free(r); return 0; }
    gzbuffer(r->fp, 1 << 20);
    r->cap = 1 << 20;
    r->buf = (char *)malloc((size_t)r->cap);
    if (!r->buf) { gzclose(r->fp); free(r); return 0; }
    return r;
}

void mgt_seq_close(void *h)
{
    mgt_sr_t *r = (mgt_sr_t *)h;
    int i;
    if (!r) return;
    if (r->fp) gzclose(r->fp);
    for (i = 0; i < 3; ++i) {
        free(r->ar[i].sq); free(r->ar[i].nm);
        free(r->ar[i].sq_off); free(r->ar[i].nm_off);
    }
    free(r->buf); free(r->hdr);
    free(r->pn); free(r->ps);
    free(r);
}

/* Next line [start, end) within r->buf (trailing \n / \r stripped);
 * returns 0 at EOF.  The window is compacted+refilled as needed, so
 * returned pointers are valid only until the next call. */
static int sr_line(mgt_sr_t *r, char **st, int64_t *ln)
{
    for (;;) {
        char *nl = memchr(r->buf + r->pos, '\n',
                          (size_t)(r->len - r->pos));
        if (nl) {
            char *s = r->buf + r->pos;
            int64_t n = nl - s;
            r->pos = (nl - r->buf) + 1;
            if (n > 0 && s[n - 1] == '\r') --n;
            *st = s, *ln = n;
            return 1;
        }
        if (r->eof) {
            if (r->len > r->pos) {      /* last line without \n */
                char *s = r->buf + r->pos;
                int64_t n = r->len - r->pos;
                r->pos = r->len;
                if (n > 0 && s[n - 1] == '\r') --n;
                *st = s, *ln = n;
                return 1;
            }
            return 0;
        }
        /* compact + refill */
        if (r->pos > 0) {
            memmove(r->buf, r->buf + r->pos,
                    (size_t)(r->len - r->pos));
            r->len -= r->pos;
            r->pos = 0;
        }
        if (r->len == r->cap) {         /* line longer than window */
            char *nb = (char *)realloc(r->buf, (size_t)(r->cap * 2));
            if (!nb) return 0;
            r->buf = nb;
            r->cap *= 2;
        }
        {
            int64_t want64 = r->cap - r->len;
            unsigned want = want64 > (1 << 30) ? (1u << 30)
                                               : (unsigned)want64;
            int n = gzread(r->fp, r->buf + r->len, want);
            if (n < 0) { r->eof = 1; r->err = 1; }
            else if (n == 0) {
                int gzerr = 0;
                gzerror(r->fp, &gzerr);
                if (gzerr != Z_OK && gzerr != Z_STREAM_END) r->err = 1;
                r->eof = 1;
            } else r->len += n;
        }
    }
}

static int sr_grow(void **p, int64_t *cap, int64_t need, int64_t esz)
{
    if (need <= *cap) return 0;
    int64_t want = need + (need >> 1) + 4096;
    void *np = realloc(*p, (size_t)(want * esz));
    if (!np) return -1;
    *p = np;
    *cap = want;
    return 0;
}

/* Read ONE record into arena a.  Returns 1 on success, 0 at EOF,
 * -1 on alloc failure.  On success, updates *n_/*sq_len_/*nm_len_
 * and the offset arrays. */
static int sr_read_rec(mgt_sr_t *r, sr_arena_t *a, int64_t *n_,
                       int64_t *sq_len_, int64_t *nm_len_)
{
    int64_t n = *n_, sq_len = *sq_len_, nm_len = *nm_len_;
    char *line; int64_t ln;
    int64_t i, name_len;
    char fq;

    /* header: either the lookahead or the next line */
    if (r->have_hdr) {
        line = r->hdr, ln = r->hdr_len;
        r->have_hdr = 0;
    } else {
        int got = 0;
        while ((got = sr_line(r, &line, &ln)) != 0)
            if (ln > 0 && (line[0] == '>' || line[0] == '@'))
                break;
        if (!got) return 0;             /* EOF */
    }
    fq = line[0] == '@';
    for (name_len = 0; name_len + 1 < ln; ++name_len)
        if (line[1 + name_len] == ' ' || line[1 + name_len] == '\t')
            break;
    if (sr_grow((void **)&a->nm, &a->nm_cap, nm_len + name_len + 1,
                1) < 0)
        return -1;
    memcpy(a->nm + nm_len, line + 1, (size_t)name_len);
    nm_len += name_len;
    /* sequence lines */
    {
        int64_t rec_len = 0;
        if (!fq) {
            while (sr_line(r, &line, &ln)) {
                if (ln > 0 && (line[0] == '>' || line[0] == '@')) {
                    /* stash the header: `line` dies on refill */
                    if (sr_grow((void **)&r->hdr, &r->hdr_cap, ln,
                                1) < 0)
                        return -1;
                    memcpy(r->hdr, line, (size_t)ln);
                    r->hdr_len = ln;
                    r->have_hdr = 1;
                    break;
                }
                if (sr_grow((void **)&a->sq, &a->sq_cap,
                            sq_len + rec_len + ln, 1) < 0)
                    return -1;
                for (i = 0; i < ln; ++i)
                    a->sq[sq_len + rec_len + i] =
                        (char)sr_map[(unsigned char)line[i]];
                rec_len += ln;
            }
        } else {
            while (sr_line(r, &line, &ln)) {
                if (ln > 0 && line[0] == '+') break;
                if (sr_grow((void **)&a->sq, &a->sq_cap,
                            sq_len + rec_len + ln, 1) < 0)
                    return -1;
                for (i = 0; i < ln; ++i)
                    a->sq[sq_len + rec_len + i] =
                        (char)sr_map[(unsigned char)line[i]];
                rec_len += ln;
            }
            /* skip quality bytes totaling rec_len */
            {
                int64_t q = 0;
                while (q < rec_len && sr_line(r, &line, &ln))
                    q += ln;
            }
        }
        sq_len += rec_len;
        ++n;
        if (n + 1 > a->off_cap) {          /* grow both offset arrays */
            if (sr_grow((void **)&a->sq_off, &a->off_cap, n + 1,
                        8) < 0)
                return -1;
            {
                int64_t *no = (int64_t *)realloc(
                    a->nm_off, (size_t)(a->off_cap * 8));
                if (!no) return -1;
                a->nm_off = no;
            }
        }
        a->sq_off[n] = sq_len;
        a->nm_off[n] = nm_len;
    }
    *n_ = n, *sq_len_ = sq_len, *nm_len_ = nm_len;
    return 1;
}

/* Same-fragment name rule (bseq.h:35-41): names identical after
 * stripping a trailing "/[0-9]". */
static int64_t sr_qn_len(const char *s, int64_t l)
{
    if (l >= 3 && s[l - 2] == '/' && s[l - 1] >= '0' && s[l - 1] <= '9')
        return l - 2;
    return l;
}

static int sr_qname_same(const char *a, int64_t la, const char *b,
                         int64_t lb)
{
    la = sr_qn_len(a, la), lb = sr_qn_len(b, lb);
    return la == lb && memcmp(a, b, (size_t)la) == 0;
}

#define SR_CHECK_PAIR_THRES 1000000

/* Read records until total bases >= max_bp or EOF.  Returns the
 * record count (0 at EOF, -1 on alloc failure) and writes arena
 * addresses into out_ptrs[0..3]: seq blob, seq offsets (n+1), name
 * blob, name offsets (n+1).  Arenas are double-buffered: the returned
 * set stays valid across ONE further call (batch k usable while
 * batch k+1 is read).
 *
 * frag_mode != 0 keeps same-name fragment runs together (bseq.c
 * mg_bseq_read semantics, mirrored from BSeqFile.read_batch): once
 * the boundary crosses, records are pulled while their name matches
 * the previous one; the first non-matching record is held over for
 * the next batch. */
int64_t mgt_seq_read_batch2(void *h, int64_t max_bp, int64_t frag_mode,
                            uint64_t *out_ptrs)
{
    mgt_sr_t *r = (mgt_sr_t *)h;
    sr_arena_t *a;
    int64_t n = 0, sq_len = 0, nm_len = 0;
    int got;

    r->cur = (r->cur + 1) % 3;
    a = &r->ar[r->cur];
    if (sr_grow((void **)&a->sq_off, &a->off_cap, 1, 8) < 0) return -1;
    /* nm_off shares off_cap bookkeeping: allocate together */
    if (!a->nm_off) {
        a->nm_off = (int64_t *)malloc((size_t)(a->off_cap * 8));
        if (!a->nm_off) return -1;
    }
    a->sq_off[0] = a->nm_off[0] = 0;

    if (r->have_pend) {                 /* held-over frag head */
        if (sr_grow((void **)&a->nm, &a->nm_cap, r->pn_len + 1, 1) < 0)
            return -1;
        if (sr_grow((void **)&a->sq, &a->sq_cap, r->ps_len + 1, 1) < 0)
            return -1;
        memcpy(a->nm, r->pn, (size_t)r->pn_len);
        memcpy(a->sq, r->ps, (size_t)r->ps_len);
        nm_len = r->pn_len, sq_len = r->ps_len, n = 1;
        if (sr_grow((void **)&a->sq_off, &a->off_cap, 2, 8) < 0)
            return -1;
        if (a->off_cap * 8 > 0) {
            int64_t *no = (int64_t *)realloc(a->nm_off,
                                             (size_t)(a->off_cap * 8));
            if (!no) return -1;
            a->nm_off = no;
        }
        a->sq_off[1] = sq_len;
        a->nm_off[1] = nm_len;
        r->have_pend = 0;
    }

    while (sq_len < max_bp) {
        got = sr_read_rec(r, a, &n, &sq_len, &nm_len);
        if (got <= 0) {
            if (got < 0) return -1;
            break;                      /* EOF */
        }
    }
    if (frag_mode && n > 0
        && a->sq_off[n] - a->sq_off[n - 1] < SR_CHECK_PAIR_THRES) {
        /* keep pulling while the name matches the last record */
        for (;;) {
            got = sr_read_rec(r, a, &n, &sq_len, &nm_len);
            if (got <= 0) {
                if (got < 0) return -1;
                break;
            }
            if (!sr_qname_same(
                    a->nm + a->nm_off[n - 2],
                    a->nm_off[n - 1] - a->nm_off[n - 2],
                    a->nm + a->nm_off[n - 1],
                    a->nm_off[n] - a->nm_off[n - 1])) {
                /* name run broke: hold the record over */
                int64_t pl = a->nm_off[n] - a->nm_off[n - 1];
                int64_t sl = a->sq_off[n] - a->sq_off[n - 1];
                if (sr_grow((void **)&r->pn, &r->pn_cap, pl + 1, 1) < 0)
                    return -1;
                if (sr_grow((void **)&r->ps, &r->ps_cap, sl + 1, 1) < 0)
                    return -1;
                memcpy(r->pn, a->nm + a->nm_off[n - 1], (size_t)pl);
                memcpy(r->ps, a->sq + a->sq_off[n - 1], (size_t)sl);
                r->pn_len = pl, r->ps_len = sl;
                r->have_pend = 1;
                --n;
                sq_len = a->sq_off[n];
                nm_len = a->nm_off[n];
                break;
            }
        }
    }
    out_ptrs[0] = (uint64_t)(uintptr_t)a->sq;
    out_ptrs[1] = (uint64_t)(uintptr_t)a->sq_off;
    out_ptrs[2] = (uint64_t)(uintptr_t)a->nm;
    out_ptrs[3] = (uint64_t)(uintptr_t)a->nm_off;
    /* a decompress/read error must not look like EOF: silent
     * truncation of the input would emit a partial GAF with rc 0 */
    if (r->err) return -2;
    return n;
}

int64_t mgt_seq_read_batch(void *h, int64_t max_bp, uint64_t *out_ptrs)
{
    return mgt_seq_read_batch2(h, max_bp, 0, out_ptrs);
}

/* Consecutive same-name grouping over a name arena (the fragment
 * grouping loop of gmap.c mg_map_frag dispatch).  first[] receives
 * the start read index of each fragment plus an n sentinel; returns
 * the fragment count. */
int64_t mgt_frag_group(const char *nm, const int64_t *nm_off, int64_t n,
                       int64_t *first)
{
    int64_t i, nf = 0;
    if (n <= 0) return 0;
    first[nf++] = 0;
    for (i = 1; i < n; ++i)
        if (!sr_qname_same(nm + nm_off[i - 1], nm_off[i] - nm_off[i - 1],
                           nm + nm_off[i], nm_off[i + 1] - nm_off[i]))
            first[nf++] = i;
    first[nf] = n;
    return nf;
}

/* In-place reverse complement of n byte spans [st[i], en[i]) of sq
 * (paired-end orientation flips, gmap.c:38-43). */
void mgt_revcomp_spans(char *sq, const int64_t *st, const int64_t *en,
                       int64_t n)
{
    /* IUPAC complement, same mapping as gfa_comp_table
     * (gfa-base.c:509) / graph.gfa.COMP_TABLE */
    static unsigned char C[256];
    static int ready = 0;
    if (!ready) {
        static const char *s = "ABCDEFGHIJKLMNOPQRSTUVWXYZ";
        static const char *d = "TVGHEFCDIJMLKNOPQYSAABWXRZ";
        int i;
        for (i = 0; i < 256; ++i) C[i] = (unsigned char)i;
        for (i = 0; s[i]; ++i) {
            C[(unsigned char)s[i]] = (unsigned char)d[i];
            C[(unsigned char)(s[i] + 32)] = (unsigned char)(d[i] + 32);
        }
        ready = 1;
    }
    int64_t i;
    for (i = 0; i < n; ++i) {
        char *l = sq + st[i], *r_ = sq + en[i] - 1;
        while (l < r_) {
            unsigned char a = (unsigned char)*l, b = (unsigned char)*r_;
            *l++ = (char)C[b];
            *r_-- = (char)C[a];
        }
        if (l == r_) *l = (char)C[(unsigned char)*l];
    }
}
