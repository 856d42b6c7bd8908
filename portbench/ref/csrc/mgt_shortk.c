/* K best shortest paths — native host engine.
 *
 * Exact-semantics implementation of mg_shortest_k (shortk.c:41-242),
 * matching graph/shortk.py node for node: di ordering is
 * dist<<32|node_id (creation order) rewritten to the out-list index on
 * visit, per-vertex states keep <= max_k nodes with in-place worst
 * replacement, destination bookkeeping follows the reference's copy /
 * done rules, and the optional predecessor array is compressed with
 * the same trans[] marking.
 *
 * Returns: >=0 number of PathV entries written (0 when !want_path),
 * -2 when the reference's "logical bug" guard trips (caller must treat
 * the search as failed), -3 when an internal cap is exceeded (caller
 * falls back to the python engine).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define U32C 0xFFFFFFFFu
#define SHORT_K_EXT 1000

static inline uint32_t kh_hash_u32(uint32_t key)
{
    key += ~(key << 15);
    key ^= key >> 10;
    key += key << 3;
    key ^= key >> 6;
    key += ~(key << 11);
    key ^= key >> 16;
    return key;
}

typedef struct {
    int64_t v;
    uint64_t di;       /* dist<<32 | id (rewritten to out index on visit) */
    int64_t pre;
    uint32_t hash;
    uint8_t is_0, removed, visited;
} node_t;

/* ---- binary min-heap of (di, node index) ---- */
typedef struct { uint64_t di; int64_t ni; } hent_t;

typedef struct {
    hent_t *a;
    int64_t n, cap;
} heap_t;

static int heap_push(heap_t *h, uint64_t di, int64_t ni)
{
    if (h->n == h->cap) {
        h->cap = h->cap ? h->cap << 1 : 64;
        h->a = (hent_t *)realloc(h->a, h->cap * sizeof(hent_t));
        if (!h->a) return -1;
    }
    int64_t i = h->n++;
    h->a[i].di = di, h->a[i].ni = ni;
    while (i > 0) {
        int64_t p = (i - 1) >> 1;
        if (h->a[p].di <= h->a[i].di) break;
        hent_t t = h->a[p]; h->a[p] = h->a[i]; h->a[i] = t;
        i = p;
    }
    return 0;
}

static int64_t heap_pop(heap_t *h)
{
    int64_t ret = h->a[0].ni;
    h->a[0] = h->a[--h->n];
    int64_t i = 0;
    for (;;) {
        int64_t l = 2 * i + 1, r = l + 1, m = i;
        if (l < h->n && h->a[l].di < h->a[m].di) m = l;
        if (r < h->n && h->a[r].di < h->a[m].di) m = r;
        if (m == i) break;
        hent_t t = h->a[m]; h->a[m] = h->a[i]; h->a[i] = t;
        i = m;
    }
    return ret;
}

/* ---- open-addressing map: vertex -> per-vertex state slot ----
 * Generation-stamped so the thread-local instance resets in O(1)
 * per call instead of a memset: a slot is live iff stamp == gen. */
typedef struct {
    int64_t *key;      /* vertex */
    int32_t *cnt;      /* nodes held */
    int32_t *stamp;    /* generation mark */
    int64_t *nodes;    /* hcap * max_k node indices */
    int64_t hcap, used;
    int32_t max_k, gen;
} vmap_t;

static int vmap_init(vmap_t *m, int64_t cap0, int32_t max_k)
{
    int64_t c = 64;
    while (c < cap0 * 2) c <<= 1;
    m->hcap = c, m->used = 0, m->max_k = max_k, m->gen = 1;
    m->key = (int64_t *)malloc(c * sizeof(int64_t));
    m->cnt = (int32_t *)malloc(c * sizeof(int32_t));
    m->stamp = (int32_t *)calloc(c, sizeof(int32_t));
    m->nodes = (int64_t *)malloc(c * max_k * sizeof(int64_t));
    if (!m->key || !m->cnt || !m->stamp || !m->nodes) {
        free(m->key); free(m->cnt); free(m->stamp); free(m->nodes);
        memset(m, 0, sizeof(*m));   /* hcap 0: not initialized */
        return -1;
    }
    return 0;
}

static void vmap_reset(vmap_t *m)
{
    m->used = 0;
    if (++m->gen == 0x7FFFFFFF) {
        memset(m->stamp, 0, m->hcap * sizeof(int32_t));
        m->gen = 1;
    }
}

static int64_t vmap_slot(vmap_t *m, int64_t v, int create);

static int vmap_grow(vmap_t *m)
{
    vmap_t nm;
    if (vmap_init(&nm, m->hcap * 2, m->max_k) < 0) return -1;
    for (int64_t i = 0; i < m->hcap; ++i) {
        if (m->stamp[i] != m->gen) continue;
        int64_t s = vmap_slot(&nm, m->key[i], 1);
        nm.cnt[s] = m->cnt[i];
        memcpy(nm.nodes + s * m->max_k, m->nodes + i * m->max_k,
               m->cnt[i] * sizeof(int64_t));
    }
    free(m->key); free(m->cnt); free(m->stamp); free(m->nodes);
    *m = nm;
    return 0;
}

static int64_t vmap_slot(vmap_t *m, int64_t v, int create)
{
    uint64_t h = kh_hash_u32((uint32_t)v) & (uint64_t)(m->hcap - 1);
    for (;;) {
        if (m->stamp[h] == m->gen) {
            if (m->key[h] == v) return (int64_t)h;
        } else {
            if (!create) return -1;
            m->key[h] = v;
            m->cnt[h] = 0;
            m->stamp[h] = m->gen;
            m->used++;
            return (int64_t)h;
        }
        h = (h + 1) & (uint64_t)(m->hcap - 1);
    }
}

/* Per-thread reusable scratch: mgt_shortest_k runs once per linear
 * chain, so per-call malloc/free of every buffer dominated the graph
 * DP on long reads. */
static __thread vmap_t tls_vm;
static __thread heap_t tls_heap;
static __thread node_t *tls_nodes;
static __thread int64_t tls_m_nodes;
static __thread int64_t *tls_outl;
static __thread int64_t tls_m_out;
static __thread int64_t *tls_ord;
static __thread int8_t *tls_done;
static __thread int64_t tls_m_ord;
static __thread int64_t *tls_trans;
static __thread int64_t tls_m_trans;

int64_t mgt_shortest_k(
    const int64_t *gidx,       /* (n_vtx, 2) [start, cnt] */
    const int64_t *arc_w, const int64_t *arc_lv, const int64_t *arc_rank,
    int64_t n_vtx,
    int64_t src, int64_t max_dist, int64_t max_k, int64_t want_path,
    int64_t n_dst,
    const int64_t *dst_v, const int64_t *dst_target_dist,
    const uint32_t *dst_target_hash, const int64_t *dst_check_hash,
    const int64_t *dst_inner,
    int64_t *out_n_path, int64_t *out_dist, uint32_t *out_hash,
    int64_t *out_is0, int64_t *out_path_end,
    int64_t path_cap, int64_t *pv_v, int64_t *pv_d, int64_t *pv_pre)
{
    if (n_dst <= 0) return 0;
    int64_t i, j, ret = -3;
    for (i = 0; i < n_dst; ++i) {
        if (dst_inner[i]) {
            out_dist[i] = 0, out_n_path[i] = 1;
        } else {
            out_dist[i] = -1, out_n_path[i] = 0;
        }
        out_path_end[i] = -1;
        out_hash[i] = 0;
        out_is0[i] = 0;
    }
    if (max_k > 15) max_k = 15;

    /* stable order of destinations by vertex */
    if (n_dst > tls_m_ord) {
        tls_m_ord = n_dst + (n_dst >> 1) + 16;
        tls_ord = (int64_t *)realloc(tls_ord,
                                     tls_m_ord * sizeof(int64_t));
        tls_done = (int8_t *)realloc(tls_done, (size_t)tls_m_ord);
        if (!tls_ord || !tls_done) { tls_m_ord = 0; return -3; }
    }
    int64_t *order = tls_ord;
    for (i = 0; i < n_dst; ++i) order[i] = i;
    for (i = 1; i < n_dst; ++i) {        /* insertion sort, stable */
        int64_t t = order[i];
        for (j = i; j > 0 && dst_v[order[j - 1]] > dst_v[t]; --j)
            order[j] = order[j - 1];
        order[j] = t;
    }
    int8_t *dst_done = tls_done;
    memset(dst_done, 0, (size_t)n_dst);

    node_t *nodes = tls_nodes;
    int64_t n_nodes = 0, m_nodes = tls_m_nodes;
    int64_t *outl = tls_outl;
    int64_t n_out = 0, m_out = tls_m_out;
    heap_t heap = tls_heap;
    heap.n = 0;
    vmap_t vm;
    if (tls_vm.hcap == 0) {
        /* stride is fixed at 16 (max_k is clamped to 15) so the map
         * can be reused across calls with differing max_k.  On init
         * failure return BEFORE the write-back at done: would copy
         * the uninitialized local vm over the thread-local state. */
        if (vmap_init(&tls_vm, 64, 16) < 0) return -3;
    }
    vmap_reset(&tls_vm);
    vm = tls_vm;

#define NEW_NODE(vv, dd, pp, hh, z0) ({ \
    if (n_nodes == m_nodes) { \
        m_nodes = m_nodes ? m_nodes << 1 : 256; \
        nodes = (node_t *)realloc(nodes, m_nodes * sizeof(node_t)); \
    } \
    node_t *np_ = &nodes[n_nodes]; \
    np_->v = (vv); np_->di = ((uint64_t)(dd) << 32) | (uint32_t)n_nodes; \
    np_->pre = (pp); np_->hash = (hh); np_->is_0 = (z0); \
    np_->removed = np_->visited = 0; \
    n_nodes++; np_ - nodes; })

    {
        int64_t ni = NEW_NODE(src, 0, -1, kh_hash_u32((uint32_t)src), 1);
        if (heap_push(&heap, nodes[ni].di, ni) < 0) goto done;
        int64_t s = vmap_slot(&vm, src, 1);
        vm.nodes[s * vm.max_k + vm.cnt[s]++] = ni;
    }

    int64_t n_done = 0;
    while (heap.n > 0) {
        int64_t ri = heap_pop(&heap);
        node_t *r = &nodes[ri];
        if (r->removed) continue;
        r->visited = 1;
        if (n_out == m_out) {
            m_out = m_out ? m_out << 1 : 256;
            outl = (int64_t *)realloc(outl, m_out * sizeof(int64_t));
        }
        r->di = (r->di >> 32 << 32) | (uint32_t)n_out;
        outl[n_out++] = ri;

        /* destination bookkeeping (shortk.c:118-161) */
        {
            /* find the dst group for r->v via binary search on order */
            int64_t lo = 0, hi = n_dst;
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if (dst_v[order[mid]] < r->v) lo = mid + 1;
                else hi = mid;
            }
            int64_t off = lo;
            if (off < n_dst && dst_v[order[off]] == r->v) {
                int64_t dist = (int64_t)(r->di >> 32);
                for (j = off; j < n_dst && dst_v[order[j]] == r->v; ++j) {
                    int64_t t = order[j];
                    int done_f = 0;
                    if (dst_inner[t]) {
                        done_f = 1;
                    } else {
                        int copy = 0;
                        if (out_n_path[t] == 0) copy = 1;
                        else if (dst_target_dist[t] >= 0) {
                            if (dist == dst_target_dist[t]
                                && dst_check_hash[t]
                                && r->hash == dst_target_hash[t]) {
                                copy = 1, done_f = 1;
                            } else {
                                int64_t d0 = out_dist[t] - dst_target_dist[t];
                                int64_t d1 = dist - dst_target_dist[t];
                                if (d0 < 0) d0 = -d0;
                                if (d1 < 0) d1 = -d1;
                                if (d1 < d0) copy = 1;
                            }
                        }
                        if (copy) {
                            out_path_end[t] = n_out - 1;
                            out_dist[t] = dist;
                            out_hash[t] = r->hash;
                            out_is0[t] = r->is_0;
                            if (dst_target_dist[t] >= 0) {
                                if (dist == dst_target_dist[t]
                                    && dst_check_hash[t]
                                    && r->hash == dst_target_hash[t])
                                    done_f = 1;
                                else if (dist > dst_target_dist[t]
                                         + SHORT_K_EXT)
                                    done_f = 1;
                            }
                        }
                        out_n_path[t]++;
                        if (out_n_path[t] >= max_k) done_f = 1;
                    }
                    if (!dst_done[j] && done_f) {
                        dst_done[j] = 1;
                        n_done++;
                    }
                }
                if (n_done == n_dst) break;
            }
        }

        /* expand arcs; copy r's fields first: NEW_NODE may realloc
         * the node array and invalidate the pointer */
        {
            int64_t r_v = r->v, r_pre = (int64_t)(r->di & U32C);
            int64_t r_dist = (int64_t)(r->di >> 32);
            uint32_t r_hash = r->hash;
            uint8_t r_is0 = r->is_0;
            if (r_v >= n_vtx) continue;
            int64_t st = gidx[2 * r_v], cnt = gidx[2 * r_v + 1];
            for (int64_t ai = st; ai < st + cnt; ++ai) {
                int64_t w = arc_w[ai];
                int64_t d = r_dist + arc_lv[ai];
                if (d > max_dist) continue;
                int64_t s = vmap_slot(&vm, w, 1);
                if (vm.used * 2 > vm.hcap) {
                    if (vmap_grow(&vm) < 0) goto done;
                    s = vmap_slot(&vm, w, 1);
                }
                int64_t *q = vm.nodes + s * vm.max_k;
                uint32_t nh = (uint32_t)(r_hash
                                         + kh_hash_u32((uint32_t)w));
                uint8_t z0 = arc_rank[ai] > 0 ? 0 : r_is0;
                int64_t rpre = r_pre;
                if (vm.cnt[s] < max_k) {
                    int64_t ni = NEW_NODE(w, d, rpre, nh, z0);
                    if (heap_push(&heap, nodes[ni].di, ni) < 0) goto done;
                    q[vm.cnt[s]++] = ni;
                } else {
                    /* worst = max di among held nodes */
                    int64_t wi = 0;
                    for (int64_t k2 = 1; k2 < vm.cnt[s]; ++k2)
                        if (nodes[q[k2]].di > nodes[q[wi]].di) wi = k2;
                    if ((nodes[q[wi]].di >> 32) > (uint64_t)d) {
                        if (nodes[q[wi]].visited) { ret = -2; goto done; }
                        nodes[q[wi]].removed = 1;
                        int64_t ni = NEW_NODE(w, d, rpre, nh, z0);
                        if (heap_push(&heap, nodes[ni].di, ni) < 0)
                            goto done;
                        q[wi] = ni;
                    }
                }
            }
        }
    }

    /* path compression (shortk.c:202-238) */
    ret = 0;
    {
        int64_t n_found = 0;
        for (i = 0; i < n_dst; ++i)
            if (out_n_path[i] > 0) n_found++;
        if (n_found > 0 && want_path) {
            int64_t *trans;
            if (n_out > tls_m_trans) {
                tls_m_trans = n_out + (n_out >> 1) + 64;
                tls_trans = (int64_t *)realloc(
                    tls_trans, tls_m_trans * sizeof(int64_t));
                if (!tls_trans) { tls_m_trans = 0; ret = -3; goto done; }
            }
            trans = tls_trans;
            memset(trans, 0, (size_t)n_out * sizeof(int64_t));
            for (i = 0; i < n_dst; ++i)
                if (out_n_path[i] > 0 && dst_target_dist[i] >= 0
                    && out_path_end[i] >= 0)
                    trans[nodes[outl[out_path_end[i]]].di & U32C] = 1;
            /* destinations with no target: mark every visit of their v */
            for (i = 0; i < n_out; ++i) {
                int64_t v = nodes[outl[i]].v;
                int64_t lo = 0, hi = n_dst;
                while (lo < hi) {
                    int64_t mid = (lo + hi) >> 1;
                    if (dst_v[order[mid]] < v) lo = mid + 1;
                    else hi = mid;
                }
                for (j = lo; j < n_dst && dst_v[order[j]] == v; ++j)
                    if (dst_target_dist[order[j]] < 0) trans[i] = 1;
            }
            for (i = n_out - 1; i >= 0; --i)
                if (trans[i] && nodes[outl[i]].pre >= 0)
                    trans[nodes[outl[i]].pre] = 1;
            int64_t n = 0;
            for (i = 0; i < n_out; ++i)
                trans[i] = trans[i] ? n++ : -1;
            if (n > path_cap) { ret = -3; goto done; }
            for (i = 0; i < n_out; ++i) {
                if (trans[i] < 0) continue;
                node_t *nd = &nodes[outl[i]];
                pv_v[trans[i]] = nd->v;
                pv_d[trans[i]] = (int64_t)(nd->di >> 32);
                pv_pre[trans[i]] = nd->pre < 0 ? nd->pre : trans[nd->pre];
            }
            for (i = 0; i < n_dst; ++i)
                if (out_path_end[i] >= 0)
                    out_path_end[i] = trans[out_path_end[i]];
            ret = n;
        }
    }

done:
    /* write back the (possibly reallocated) thread-local scratch */
    tls_nodes = nodes, tls_m_nodes = m_nodes;
    tls_outl = outl, tls_m_out = m_out;
    tls_heap = heap;
    tls_vm = vm;
    return ret;
}


/* Free this thread's scratch: the batch driver spawns fresh worker
 * threads per call, and thread-local buffers would otherwise leak at
 * every pthread exit. */
void mgt_shortk_tls_free(void)
{
    free(tls_vm.key); free(tls_vm.cnt); free(tls_vm.stamp);
    free(tls_vm.nodes);
    memset(&tls_vm, 0, sizeof(tls_vm));
    free(tls_heap.a);
    tls_heap.a = 0, tls_heap.n = tls_heap.cap = 0;
    free(tls_nodes); tls_nodes = 0; tls_m_nodes = 0;
    free(tls_outl); tls_outl = 0; tls_m_out = 0;
    free(tls_ord); tls_ord = 0;
    free(tls_done); tls_done = 0; tls_m_ord = 0;
    free(tls_trans); tls_trans = 0; tls_m_trans = 0;
}
