// Batched GWFA (graph wavefront edit distance) with its traceback walk:
// the bridge engine of the device GWFA pool (--gwfa-device).
//
// Replaces the XLA stage minigraph_tpu/ops/gwfa_jax.py gwfa_batch (its
// lax.while_loops over steps, hop waves, extension runs and the walk; no
// Pallas kernel) and is held bitwise against the plain PyTorch version
// ops/gwfa.py gwfa_batch_ref on all four outputs (s, flags, walk,
// n_walk), flags included.
//
// What bounds it on an H100: latency, not bytes or arithmetic.  A job
// is a chain of dependent steps (extend every state, generate children,
// run the hop waves of the A queue, dedup the candidates); the bytes are
// the query, the graph bases extension compares and four small outputs.
//
// Design: one block of NT threads a job; the job's whole state lives in
// shared memory (105-107 KB at the default caps, QCAP 256-1024): the
// frontier and the hop wave (two buffers of dcap states), the
// candidates (ccap), the forbidden stage (4 dcap) and table (fcap), the
// visited table (2 dcap), the events (evcap x degcap), the trace (tcap)
// and the query.  Per-state
// work (extension, children, tests) runs one thread a state; every
// append keeps the JAX push order with a block prefix sum
// (ordered_append), so candidates, trace slots and the next wave sit
// where the JAX cumsum-and-scatter puts them; the sorts are block-wide
// bitonic sorts over index arrays whose comparator ends in the entry's
// position, a total order (the plain version's stable sorts); the sorted
// sets (visited, forbidden) are merged in parallel by rank and cut at
// their caps as the JAX sorted-insert cuts them; the walk runs on one
// thread.
//
// Places where the translation could go wrong, handled here:
//  1. Gathers out of range clamp in JAX (arc_cnt[v], seq_len[v] for pad
//     rows).  Here only real states are touched; v is clamped where the
//     JAX program clamps (cvc) and never out of range elsewhere.
//  2. Scatters with mode="drop" into pad slots (candidates at ccap, trace
//     at tcap, walk at wcap): ordered_append hands the emitter every slot
//     and the emitter writes only below the cap; the walk overwrites slot
//     wcap - 1 past the cap as the JAX walk does.  tie_run's scatter-max
//     becomes an OR over the run, computed by its head's thread.
//  3. uint32 arithmetic of _mk_vd / _vd_d: mk_vd adds in unsigned and
//     zero-extends; vd_d reads the low word as unsigned then int.
//  4. lax.sort is not stable: ties on every key occur only among pads and
//     same-(vd, k) candidates; the comparator breaks them by position, as
//     the plain version's stable sorts do.
//  5. First-in-queue-order picks (argmax of the hits, the stable argsorts
//     of the vend states and the new arrivals) are an atomicMin over the
//     position and ordered appends over position / event order.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                     // threads a job
constexpr long long BIG = 0x7FFFFFFFFFFFFFFFLL;
constexpr unsigned DIAG_SHIFT = 1u << 30;

constexpr int F_TIE = 1, F_DCAP = 2, F_TCAP = 4, F_DEG = 8, F_HOP = 16,
              F_FCAP = 32, F_STEPS = 128;

// per-position bits of the hop wave
constexpr unsigned char P_ACT = 1, P_VEND0 = 2, P_QEND0 = 4, P_HIT = 8,
                        P_QD = 16, P_VEND = 32, P_QV = 64;

__host__ __device__ inline int pow2ceil(int n)
{
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

struct Caps {
    int QCAP, n_vtx, dcap, ccap, tcap, fcap, wcap, degcap, hopcap, evcap,
        max_steps;
};

// byte offsets of the shared arrays (8-byte words first)
struct Layout {
    int c_vd, st, vis0, vis1, forb0, forb1, evk, nk, bvd0, bvd1;
    int c_k, c_t, c_n, bk0, bk1, bt0, bt1, bn0, bn1, tw, n_ext, cvp, sidx,
        tr_v, tr_pre, wbuf;
    int q;
    int pf, evm, eva;
    int bytes;
};

// the next n elements of sz bytes at offset o, 8-byte aligned
__host__ __device__ inline int take(int &o, int n, int sz)
{
    const int r = o;
    o += ((n * sz + 7) / 8) * 8;
    return r;
}

__host__ __device__ inline Layout make_layout(const Caps &c)
{
    Layout L;
    const int ecap = c.evcap * c.degcap;
    const int p2s = pow2ceil(4 * c.dcap);
    int o = 0;
    L.c_vd = take(o, c.ccap, 8);
    L.st = take(o, p2s, 8);
    L.vis0 = take(o, 2 * c.dcap, 8);
    L.vis1 = take(o, 2 * c.dcap, 8);
    L.forb0 = take(o, c.fcap, 8);
    L.forb1 = take(o, c.fcap, 8);
    L.evk = take(o, ecap, 8);
    L.nk = take(o, ecap > p2s ? ecap : p2s, 8);
    L.bvd0 = take(o, c.dcap, 8);
    L.bvd1 = take(o, c.dcap, 8);
    L.c_k = take(o, c.ccap, 4);
    L.c_t = take(o, c.ccap, 4);
    L.c_n = take(o, c.ccap, 4);
    L.bk0 = take(o, c.dcap, 4);
    L.bk1 = take(o, c.dcap, 4);
    L.bt0 = take(o, c.dcap, 4);
    L.bt1 = take(o, c.dcap, 4);
    L.bn0 = take(o, c.dcap, 4);
    L.bn1 = take(o, c.dcap, 4);
    L.tw = take(o, c.dcap, 4);
    L.n_ext = take(o, c.dcap, 4);
    L.cvp = take(o, c.evcap, 4);
    const int p2c = pow2ceil(c.ccap), p2e = pow2ceil(ecap);
    L.sidx = take(o, p2c > p2e ? p2c : p2e, 4);
    L.tr_v = take(o, c.tcap, 4);
    L.tr_pre = take(o, c.tcap, 4);
    L.wbuf = take(o, c.wcap, 4);
    L.q = take(o, c.QCAP, 2);
    L.pf = take(o, c.dcap, 1);
    L.evm = take(o, ecap, 1);
    L.eva = take(o, ecap, 1);
    L.bytes = o;
    return L;
}

// block-uniform scalars of one job
struct Scal {
    int n_a, n_c, nf_n, n_vis, n_forb, tr_n, flags, found, dead, s, end_t,
        end_v, end_tn, first, n_cv, n_next, n_nk, n_cand, n_keep;
    int warp[NT / 32];
};

__device__ __forceinline__ long long mk_vd(int v, int d)
{
    return ((long long)v << 32)
        | (long long)(unsigned)(DIAG_SHIFT + (unsigned)d);
}

__device__ __forceinline__ int vd_v(long long vd) { return (int)(vd >> 32); }

__device__ __forceinline__ int vd_d(long long vd)
{
    return (int)(unsigned)(vd & 0xFFFFFFFFLL) - (int)DIAG_SHIFT;
}

// exclusive block prefix sum of x; *total gets the block's sum
__device__ int block_scan(int x, int *total, int *s_warp)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int v = x;
    for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += y;
    }
    if (lane == 31) s_warp[warp] = v;
    __syncthreads();
    if (warp == 0) {
        int w = lane < NT / 32 ? s_warp[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            int y = __shfl_up_sync(0xffffffffu, w, o);
            if (lane >= o) w += y;
        }
        if (lane < NT / 32) s_warp[lane] = w;
    }
    __syncthreads();
    const int before = warp ? s_warp[warp - 1] : 0;
    *total = s_warp[NT / 32 - 1];
    __syncthreads();
    return before + v - x;
}

// Append the items i < n with pred(i), in order of i, after *count:
// emit(i, slot) for each, slot possibly >= cap (the emitter writes only
// below it: JAX's scatter into the pad slot).  *count ends at
// min(count + appended, cap).  Returns whether any slot reached the cap.
// Called by every thread; *count must be settled (a barrier) before.
template <class Pred, class Emit>
__device__ bool ordered_append(int n, int *count, int cap, int *s_warp,
                               Pred pred, Emit emit)
{
    int c = *count;
    int over = 0;
    for (int base = 0; base < n; base += NT) {
        const int i = base + threadIdx.x;
        const int p = (i < n && pred(i)) ? 1 : 0;
        int tot;
        const int pos = block_scan(p, &tot, s_warp);
        if (p) {
            const int slot = c + pos;
            if (slot >= cap) over = 1;
            emit(i, slot);
        }
        c += tot;
    }
    __syncthreads();
    if (threadIdx.x == 0) *count = c < cap ? c : cap;
    return __syncthreads_or(over) != 0;
}

// bitonic sort of n (a power of two) int keys under less()
template <class Less>
__device__ void bitonic(int *a, int n, Less less)
{
    for (int k = 2; k <= n; k <<= 1)
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < n; i += NT) {
                const int ixj = i ^ j;
                if (ixj > i) {
                    const int x = a[i], y = a[ixj];
                    const bool sw = (i & k) == 0 ? less(y, x) : less(x, y);
                    if (sw) { a[i] = y; a[ixj] = x; }
                }
            }
            __syncthreads();
        }
}

__device__ void bitonic64(long long *a, int n)
{
    for (int k = 2; k <= n; k <<= 1)
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < n; i += NT) {
                const int ixj = i ^ j;
                if (ixj > i) {
                    const long long x = a[i], y = a[ixj];
                    const bool sw = (i & k) == 0 ? y < x : x < y;
                    if (sw) { a[i] = y; a[ixj] = x; }
                }
            }
            __syncthreads();
        }
}

__device__ __forceinline__ int lower_bound64(const long long *a, int n,
                                             long long x)
{
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ bool member64(const long long *a, int n,
                                         long long x)
{
    const int p = lower_bound64(a, n, x);
    return p < n && a[p] == x;
}

// merge the disjoint sorted sets a and b into out, cut at cap (the
// smallest cap values: JAX's sorted-insert keeps tab's width)
__device__ void merge_cut(const long long *a, int na, const long long *b,
                          int nb, long long *out, int cap)
{
    for (int i = threadIdx.x; i < na; i += NT) {
        const int r = i + lower_bound64(b, nb, a[i]);
        if (r < cap) out[r] = a[i];
    }
    for (int i = threadIdx.x; i < nb; i += NT) {
        const int r = i + lower_bound64(a, na, b[i]);
        if (r < cap) out[r] = b[i];
    }
}

// gwf_extend1: exact matches along the state's diagonal
__device__ __forceinline__ int extend1(long long vd, int k, int ql,
                                       const short *q,
                                       const int32_t *__restrict__ seq_off,
                                       const int32_t *__restrict__ seq_len,
                                       const int32_t *__restrict__ seq)
{
    const int v = vd_v(vd), d = vd_d(vd);
    const int max_k = min(ql - d, seq_len[v]) - 1;
    const int32_t *t = seq + seq_off[v];
    while (k < max_k && t[k + 1] == (int)q[d + k + 1]) ++k;
    return k;
}

__global__ void __launch_bounds__(NT) gwfa_kernel(
    const int32_t *__restrict__ q_g, const int32_t *__restrict__ ql_g,
    const int32_t *__restrict__ v0_g, const int32_t *__restrict__ off0_g,
    const int32_t *__restrict__ v1_g, const int32_t *__restrict__ off1_g,
    const int32_t *__restrict__ med_g, const int32_t *__restrict__ arc_w,
    const int32_t *__restrict__ arc_ow, const int32_t *__restrict__ arc_cnt,
    const int32_t *__restrict__ seq_off, const int32_t *__restrict__ seq_len,
    const int32_t *__restrict__ seq, Caps cp, int32_t *__restrict__ s_o,
    int32_t *__restrict__ flags_o, int32_t *__restrict__ walk_o,
    int32_t *__restrict__ nwalk_o)
{
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ Scal S;
    const Layout L = make_layout(cp);
    long long *c_vd = (long long *)(smem + L.c_vd);
    long long *st = (long long *)(smem + L.st);
    long long *vis = (long long *)(smem + L.vis0);
    long long *vis2 = (long long *)(smem + L.vis1);
    long long *forb = (long long *)(smem + L.forb0);
    long long *forb2 = (long long *)(smem + L.forb1);
    long long *evk = (long long *)(smem + L.evk);
    long long *nk = (long long *)(smem + L.nk);
    long long *bvd[2] = {(long long *)(smem + L.bvd0),
                         (long long *)(smem + L.bvd1)};
    int *c_k = (int *)(smem + L.c_k), *c_t = (int *)(smem + L.c_t),
        *c_n = (int *)(smem + L.c_n);
    int *bk[2] = {(int *)(smem + L.bk0), (int *)(smem + L.bk1)};
    int *bt[2] = {(int *)(smem + L.bt0), (int *)(smem + L.bt1)};
    int *bn[2] = {(int *)(smem + L.bn0), (int *)(smem + L.bn1)};
    int *tw = (int *)(smem + L.tw), *n_ext = (int *)(smem + L.n_ext),
        *cvp = (int *)(smem + L.cvp), *sidx = (int *)(smem + L.sidx),
        *tr_v = (int *)(smem + L.tr_v), *tr_pre = (int *)(smem + L.tr_pre);
    short *q = (short *)(smem + L.q);
    unsigned char *pf = smem + L.pf, *evm = smem + L.evm,
                  *eva = smem + L.eva;

    const int job = blockIdx.x, tid = threadIdx.x;
    const int dcap = cp.dcap, ccap = cp.ccap, tcap = cp.tcap,
              fcap = cp.fcap, degcap = cp.degcap, n_vtx = cp.n_vtx;
    const int ql = ql_g[job], v1 = v1_g[job], off1 = off1_g[job],
              max_ed = med_g[job];
    for (int i = tid; i < cp.QCAP; i += NT)
        q[i] = (short)q_g[(size_t)job * cp.QCAP + i];
    for (int i = tid; i < tcap; i += NT) { tr_v[i] = -1; tr_pre[i] = -1; }
    if (tid == 0) {
        // initial frontier (gfa_ed_init, gfa-ed.c:552-560)
        bvd[0][0] = mk_vd(v0_g[job], -off0_g[job]);
        bk[0][0] = off0_g[job] - 1;
        bt[0][0] = 0;
        bn[0][0] = 0;
        S.n_a = 1; S.n_forb = 0; S.tr_n = 1; S.flags = 0; S.found = 0;
        S.dead = 0; S.s = 0; S.end_t = -1; S.end_v = -1; S.end_tn = 0;
    }
    __syncthreads();

    // push_cand: the candidate emitter (writes below ccap only)
    auto cand_emit = [&](int slot, long long vd, int k, int t, int tn) {
        if (slot < ccap) {
            c_vd[slot] = vd; c_k[slot] = k; c_t[slot] = t; c_n[slot] = tn;
        }
    };
    auto stage_add = [&](long long vd) {
        const int p = atomicAdd(&S.nf_n, 1);
        if (p < 4 * dcap) st[p] = vd;
    };
    auto clampv = [&](int v) { return min(max(v, 0), n_vtx - 1); };

    while (true) {
        __syncthreads();
        if (S.found || S.dead || S.flags) break;
        if (tid == 0) { S.n_c = 0; S.nf_n = 0; S.n_vis = 0; }
        // ---- batch-extension phase over the whole frontier (buffer 0)
        const int nA = S.n_a;
        long long *avd = bvd[0];
        int *ak = bk[0], *at = bt[0], *an = bn[0];
        int bnd_any = 0;
        for (int p = tid; p < nA; p += NT) {
            const int k = extend1(avd[p], ak[p], ql, q, seq_off, seq_len,
                                  seq);
            ak[p] = k;
            const int vl = seq_len[vd_v(avd[p])];
            const bool b = k == vl - 1 || vd_d(avd[p]) + k == ql - 1;
            pf[p] = b ? P_ACT : 0;
            bnd_any |= b;
        }
        const bool had_a = __syncthreads_or(bnd_any) != 0;

        // wavefront children: the in-run merge, then the left and the
        // right edge child of each run, each pass in position order
        auto has_l = [&](int p) { return p > 0 && avd[p] == avd[p - 1] + 1; };
        auto has_r = [&](int p) {
            return p + 1 < nA && avd[p + 1] == avd[p] + 1;
        };
        auto merged = [&](int p, int &ck, int &ct, int &cn) {
            const int k = ak[p];
            if (has_l(p)) { ck = ak[p - 1]; ct = at[p - 1]; cn = an[p - 1]; }
            else { ck = -(1 << 30); ct = 0; cn = 0; }
            if (k + 1 >= ck) { ck = k + 1; ct = at[p]; cn = an[p]; }
            if (has_r(p) && ak[p + 1] + 1 >= ck) {
                ck = ak[p + 1] + 1; ct = at[p + 1]; cn = an[p + 1];
            }
        };
        for (int p = tid; p < nA; p += NT) {
            const long long vd = avd[p];
            const int k = ak[p], vl = seq_len[vd_v(vd)];
            int ck, ct, cn;
            merged(p, ck, ct, cn);
            if (ck == vl) stage_add(vd);
            if (!has_l(p) && k + 1 == vl) stage_add(vd - 1);
            if (!has_r(p) && k == vl) stage_add(vd + 1);
        }
        bool ovf = ordered_append(nA, &S.n_c, ccap, S.warp,
            [&](int p) {
                int ck, ct, cn;
                merged(p, ck, ct, cn);
                return vd_d(avd[p]) + ck < ql
                    && ck < seq_len[vd_v(avd[p])];
            },
            [&](int p, int slot) {
                int ck, ct, cn;
                merged(p, ck, ct, cn);
                cand_emit(slot, avd[p], ck, ct, cn);
            });
        ovf |= ordered_append(nA, &S.n_c, ccap, S.warp,
            [&](int p) {
                const int d = vd_d(avd[p]), k = ak[p];
                return !has_l(p) && (d - 1) + (k + 1) < ql
                    && k + 1 < seq_len[vd_v(avd[p])];
            },
            [&](int p, int slot) {
                cand_emit(slot, avd[p] - 1, ak[p] + 1, at[p], an[p]);
            });
        ovf |= ordered_append(nA, &S.n_c, ccap, S.warp,
            [&](int p) {
                const int d = vd_d(avd[p]), k = ak[p];
                return !has_r(p) && (d + 1) + k < ql
                    && k < seq_len[vd_v(avd[p])];
            },
            [&](int p, int slot) {
                cand_emit(slot, avd[p] + 1, ak[p], at[p], an[p]);
            });
        if (ovf && tid == 0) S.flags |= F_DCAP;

        // ---- queue phase: boundary states wave by wave (the A queue)
        int cur = 0, nB = nA;
        bool any_act = had_a;
        int hop = 0;
        while (any_act && hop < cp.hopcap) {
            long long *Bvd = bvd[cur];
            int *Bk = bk[cur], *Bt = bt[cur], *Bn = bn[cur];
            long long *Nvd = bvd[cur ^ 1];
            int *Nk = bk[cur ^ 1], *Nt = bt[cur ^ 1], *Nn = bn[cur ^ 1];
            if (tid == 0) S.first = INT_MAX;
            for (int p = tid; p < nB; p += NT) {
                const int v = clampv(vd_v(Bvd[p]));
                unsigned char f = pf[p] & P_ACT;
                if (Bk[p] == seq_len[v] - 1) f |= P_VEND0;
                if (vd_d(Bvd[p]) + Bk[p] == ql - 1) f |= P_QEND0;
                pf[p] = f;
                n_ext[p] = 0;
                tw[p] = Bt[p];
            }
            __syncthreads();
            // (a) re-interior states: 3 children, no run
            ovf = false;
            for (int a = 0; a < 3; ++a) {
                const int dd = a - 1, kk = a < 2 ? 1 : 0;
                ovf |= ordered_append(nB, &S.n_c, ccap, S.warp,
                    [&](int p) {
                        return (pf[p] & (P_ACT | P_VEND0 | P_QEND0)) == P_ACT;
                    },
                    [&](int p, int slot) {
                        cand_emit(slot, mk_vd(vd_v(Bvd[p]),
                                              vd_d(Bvd[p]) + dd),
                                  Bk[p] + kk, Bt[p], Bn[p]);
                    });
            }
            // (b) target check at query end: the first hit in position
            // order wins
            for (int p = tid; p < nB; p += NT) {
                if ((pf[p] & (P_ACT | P_QEND0)) == (P_ACT | P_QEND0)
                    && vd_v(Bvd[p]) == v1 && Bk[p] == off1) {
                    pf[p] |= P_HIT;
                    atomicMin(&S.first, p);
                }
            }
            __syncthreads();
            if (tid == 0 && S.first != INT_MAX) {
                if (!S.found) {
                    S.end_t = Bt[S.first];
                    S.end_v = vd_v(Bvd[S.first]);
                    S.end_tn = Bn[S.first];
                }
                S.found = 1;
            }
            __syncthreads();
            const bool found = S.found != 0;
            int deg = 0;
            for (int p = tid; p < nB; p += NT) {
                unsigned char f = pf[p];
                const int v = vd_v(Bvd[p]), vc = clampv(v);
                const bool qend = (f & (P_ACT | P_QEND0)) == (P_ACT | P_QEND0);
                const bool hit = f & P_HIT;
                const bool qd = qend && !hit && Bk[p] + 1 < seq_len[vc]
                    && !found;
                const bool vend = (f & (P_ACT | P_VEND0 | P_QEND0))
                    == (P_ACT | P_VEND0) && !found;
                const bool qv = qend && !hit && !qd && v != v1 && !found;
                if (qd) f |= P_QD;
                if (vend) {
                    f |= P_VEND;
                    stage_add(Bvd[p]);
                    if (arc_cnt[vc] > degcap) deg = 1;
                }
                if (qv) {
                    f |= P_QV;
                    if (arc_cnt[vc] > degcap) deg = 1;
                }
                pf[p] = f;
            }
            if (__syncthreads_or(deg) && tid == 0) S.flags |= F_DEG;
            // query end, vertex unfinished, not the target: deletion
            ovf |= ordered_append(nB, &S.n_c, ccap, S.warp,
                [&](int p) { return (pf[p] & P_QD) != 0; },
                [&](int p, int slot) {
                    cand_emit(slot, mk_vd(vd_v(Bvd[p]), vd_d(Bvd[p]) - 1),
                              Bk[p] + 1, Bt[p], Bn[p]);
                });
            // (c) expansion trace pushes: one per expanding state; past
            // tcap the state's trace index is tcap - 1
            const bool tovf = ordered_append(nB, &S.tr_n, tcap, S.warp,
                [&](int p) { return (pf[p] & (P_VEND | P_QV)) != 0; },
                [&](int p, int slot) {
                    if (slot < tcap) {
                        tr_v[slot] = vd_v(Bvd[p]);
                        tr_pre[slot] = Bt[p];
                        tw[p] = slot;
                    } else {
                        tw[p] = tcap - 1;
                    }
                });
            if (tovf && tid == 0) S.flags |= F_TCAP;
            // (d) arc events of the first evcap vend states
            if (tid == 0) S.n_cv = 0;
            __syncthreads();
            const bool eovf = ordered_append(nB, &S.n_cv, cp.evcap, S.warp,
                [&](int p) { return (pf[p] & P_VEND) != 0; },
                [&](int p, int slot) { if (slot < cp.evcap) cvp[slot] = p; });
            if (eovf && tid == 0) S.flags |= F_DCAP;
            __syncthreads();
            const int n_ev = S.n_cv * degcap;
            for (int e = tid; e < n_ev; e += NT) {
                const int p = cvp[e / degcap], ai = e % degcap;
                const int vc = clampv(vd_v(Bvd[p]));
                const int i = vd_d(Bvd[p]) + Bk[p];
                long long key = BIG;
                unsigned char m = 0;
                if (ai < arc_cnt[vc]) {
                    const int w = arc_w[vc * degcap + ai];
                    const int ow = arc_ow[vc * degcap + ai];
                    m = i + 1 < ql && ow < seq_len[w]
                        && seq[seq_off[w] + ow] == (int)q[i + 1];
                    if (m) atomicAdd(&n_ext[p], 1);
                    key = ((long long)w << 32) | (long long)(i + 1);
                }
                evk[e] = key;
                evm[e] = m;
                eva[e] = 0;
            }
            const int p2e = n_ev > 1 ? pow2ceil(n_ev) : n_ev;
            for (int e = tid; e < p2e; e += NT)
                sidx[e] = e < n_ev ? e : INT_MAX;
            __syncthreads();
            // sort events by (key, order): event index order is the
            // host's (position, arc) order
            bitonic(sidx, p2e, [&](int a, int b) {
                if (b == INT_MAX) return a != INT_MAX;
                if (a == INT_MAX) return false;
                return evk[a] < evk[b] || (evk[a] == evk[b] && a < b);
            });
            // the head of each key run acts unless visited this step
            for (int jj = tid; jj < n_ev; jj += NT) {
                const int e = sidx[jj];
                const long long key = evk[e];
                if (key != BIG && (jj == 0 || evk[sidx[jj - 1]] != key)
                    && !member64(vis, S.n_vis, key))
                    eva[e] = 1;
            }
            if (tid == 0) S.n_nk = 0;
            __syncthreads();
            ordered_append(n_ev, &S.n_nk, n_ev, S.warp,
                [&](int jj) { return eva[sidx[jj]] != 0; },
                [&](int jj, int slot) { nk[slot] = evk[sidx[jj]]; });
            {
                const int nv = S.n_vis, nn = S.n_nk, cap = 2 * dcap;
                merge_cut(vis, nv, nk, nn, vis2, cap);
                long long *t = vis; vis = vis2; vis2 = t;
                __syncthreads();
                if (tid == 0) {
                    S.n_vis = min(nv + nn, cap);
                    if (nv + nn > cap) S.flags |= F_FCAP;
                    S.n_next = 0;
                }
                __syncthreads();
            }
            // matching winners become the next wave, in event order
            const bool novf = ordered_append(n_ev, &S.n_next, dcap, S.warp,
                [&](int e) { return eva[e] && evm[e]; },
                [&](int e, int slot) {
                    if (slot >= dcap) return;
                    const int p = cvp[e / degcap], ai = e % degcap;
                    const int vc = clampv(vd_v(Bvd[p]));
                    const int w = arc_w[vc * degcap + ai];
                    const int ow = arc_ow[vc * degcap + ai];
                    const int i = vd_d(Bvd[p]) + Bk[p];
                    Nvd[slot] = mk_vd(w, i + 1 - ow);
                    Nk[slot] = ow;
                    Nt[slot] = tw[p];
                    Nn[slot] = Bn[p];
                });
            if (novf && tid == 0) S.flags |= F_DCAP;
            // mismatching winners push the two cross-vertex children, in
            // sorted event order
            for (int dd = 0; dd < 2; ++dd) {
                auto ev_child = [&](int jj, int &w, int &ow, int &ch_d,
                                    int &p) {
                    const int e = sidx[jj];
                    p = cvp[e / degcap];
                    const int ai = e % degcap;
                    const int vc = clampv(vd_v(Bvd[p]));
                    w = arc_w[vc * degcap + ai];
                    ow = arc_ow[vc * degcap + ai];
                    ch_d = vd_d(Bvd[p]) + Bk[p] + dd - ow;
                };
                ovf |= ordered_append(n_ev, &S.n_c, ccap, S.warp,
                    [&](int jj) {
                        const int e = sidx[jj];
                        if (!eva[e] || evm[e]) return false;
                        int w, ow, ch_d, p;
                        ev_child(jj, w, ow, ch_d, p);
                        return ch_d + ow < ql;
                    },
                    [&](int jj, int slot) {
                        int w, ow, ch_d, p;
                        ev_child(jj, w, ow, ch_d, p);
                        cand_emit(slot, mk_vd(w, ch_d), ow, tw[p], Bn[p]);
                    });
            }
            // residual child (v, d+1, k) when not every arc matched
            ovf |= ordered_append(nB, &S.n_c, ccap, S.warp,
                [&](int p) {
                    if (!(pf[p] & P_VEND)) return false;
                    const int cnt = arc_cnt[clampv(vd_v(Bvd[p]))];
                    return cnt == 0 || n_ext[p] != min(cnt, degcap);
                },
                [&](int p, int slot) {
                    cand_emit(slot, mk_vd(vd_v(Bvd[p]), vd_d(Bvd[p]) + 1),
                              Bk[p], Bt[p], Bn[p]);
                });
            // (e) query end at a non-target vertex end: one child an
            // arc, not visited-checked (gfa-ed.c:351-357)
            for (int ai = 0; ai < degcap; ++ai)
                ovf |= ordered_append(nB, &S.n_c, ccap, S.warp,
                    [&](int p) {
                        return (pf[p] & P_QV)
                            && ai < arc_cnt[clampv(vd_v(Bvd[p]))];
                    },
                    [&](int p, int slot) {
                        const int vc = clampv(vd_v(Bvd[p]));
                        const int w = arc_w[vc * degcap + ai];
                        const int ow = arc_ow[vc * degcap + ai];
                        cand_emit(slot,
                                  mk_vd(w, vd_d(Bvd[p]) + Bk[p] - ow), ow,
                                  tw[p], Bn[p]);
                    });
            if (ovf && tid == 0) S.flags |= F_DCAP;
            __syncthreads();
            // next wave: extend the fresh arrivals
            const int nN = S.n_next;
            for (int p = tid; p < nN; p += NT) {
                if (!found)
                    Nk[p] = extend1(Nvd[p], Nk[p], ql, q, seq_off, seq_len,
                                    seq);
                pf[p] = P_ACT;
            }
            if (tid == 0 && hop + 1 >= cp.hopcap && nN > 0 && !found)
                S.flags |= F_HOP;
            any_act = nN > 0 && !found;
            nB = nN;
            cur ^= 1;
            ++hop;
            __syncthreads();
        }
        __syncthreads();
        // ---- forbidden bands
        const int found = S.found;
        const int nf = min(S.nf_n, 4 * dcap);
        if (tid == 0 && S.nf_n > 4 * dcap && !found) S.flags |= F_FCAP;
        const int p2s = nf > 1 ? pow2ceil(nf) : nf;
        for (int i = nf + tid; i < p2s; i += NT) st[i] = BIG;
        if (tid == 0) S.n_nk = 0;
        __syncthreads();
        bitonic64(st, p2s);
        ordered_append(nf, &S.n_nk, nf, S.warp,
            [&](int i) {
                return (i == 0 || st[i] != st[i - 1])
                    && !member64(forb, S.n_forb, st[i]);
            },
            [&](int i, int slot) { nk[slot] = st[i]; });
        {
            const int nv = S.n_forb, nn = S.n_nk;
            merge_cut(forb, nv, nk, nn, forb2, fcap);
            long long *t = forb; forb = forb2; forb2 = t;
            __syncthreads();
            if (tid == 0) {
                S.n_forb = min(nv + nn, fcap);
                if (nv + nn > fcap && !found) S.flags |= F_FCAP;
                S.n_cand = 0;
                S.n_keep = 0;
            }
            __syncthreads();
        }
        // ---- dedup + forbidden filter -> next frontier (buffer 0)
        if (!found && S.flags == 0) {
            ordered_append(S.n_c, &S.n_cand, S.n_c, S.warp,
                [&](int c) { return !member64(forb, S.n_forb, c_vd[c]); },
                [&](int c, int slot) { sidx[slot] = c; });
            __syncthreads();
            const int nc = S.n_cand;
            const int p2c = nc > 1 ? pow2ceil(nc) : nc;
            for (int i = nc + tid; i < p2c; i += NT) sidx[i] = INT_MAX;
            __syncthreads();
            // (vd asc, k desc, position): the winner is the run head
            bitonic(sidx, p2c, [&](int a, int b) {
                if (b == INT_MAX) return a != INT_MAX;
                if (a == INT_MAX) return false;
                if (c_vd[a] != c_vd[b]) return c_vd[a] < c_vd[b];
                if (c_k[a] != c_k[b]) return c_k[a] > c_k[b];
                return a < b;
            });
            // a same-(vd, k) duplicate with a different trace taints the
            // run; without boundary states any different-trace duplicate
            // does (the host only dedups on steps with an A queue)
            const bool keep_ovf = ordered_append(nc, &S.n_keep, dcap, S.warp,
                [&](int jj) {
                    return jj == 0 || c_vd[sidx[jj]] != c_vd[sidx[jj - 1]];
                },
                [&](int jj, int slot) {
                    if (slot >= dcap) return;
                    const int h = sidx[jj];
                    int taint = 0;
                    for (int e = jj + 1; e < nc && c_vd[sidx[e]] == c_vd[h];
                         ++e) {
                        const int x = sidx[e];
                        if (c_t[x] != c_t[h]
                            && (c_k[x] == c_k[h] || !had_a))
                            taint = 1;
                    }
                    bvd[0][slot] = c_vd[h];
                    bk[0][slot] = c_k[h];
                    bt[0][slot] = c_t[h];
                    bn[0][slot] = c_n[h] | taint;
                });
            // n_keep counts every head: the append's count is capped, so
            // count the overflow separately
            if (keep_ovf && tid == 0) S.flags |= F_DCAP;
        }
        __syncthreads();
        if (tid == 0) {
            const int n_keep = S.n_keep;
            S.n_a = n_keep;
            int dead = S.dead | (!found && n_keep == 0);
            int s = S.s;
            if (!(found || dead) && S.flags == 0) ++s;
            if (s > max_ed && !found) dead = 1;
            if (s >= cp.max_steps && s <= max_ed && !found && !dead
                && S.flags == 0)
                S.flags |= F_STEPS;
            S.s = s;
            S.dead = dead;
        }
    }
    __syncthreads();
    if (tid != 0) return;
    // ---- walk reconstruction (gfa_ed_step traceback), one thread
    int flags = S.flags;
    const bool found = S.found != 0;
    if (found && S.end_tn != 0) flags |= F_TIE;
    const int wcap = cp.wcap;
    int32_t *walk = walk_o + (size_t)job * wcap;
    int32_t *wbuf = (int32_t *)(smem + L.wbuf);
    for (int i = 0; i < wcap; ++i) wbuf[i] = -1;
    int wn = 0;
    if (found && flags == 0) {
        wbuf[0] = S.end_v;
        wn = 1;
        int c = S.end_t;
        while (true) {
            const int cc = min(max(c, 0), tcap - 1);
            const int pv = tr_v[cc];
            if (c < 0 || pv < 0) break;
            wbuf[min(wn, wcap - 1)] = pv;
            c = tr_pre[cc];
            ++wn;
        }
    }
    if (wn > wcap) flags |= F_TCAP;
    for (int i = 0; i < wcap; ++i)
        walk[i] = i < wn ? wbuf[min(max(wn - 1 - i, 0), wcap - 1)] : -1;
    s_o[job] = found ? S.s : -1;
    flags_o[job] = flags;
    nwalk_o[job] = wn;
}

}  // namespace

extern "C" int mgt_cuda_gwfa(
    const int32_t *q, const int32_t *ql, const int32_t *v0,
    const int32_t *off0, const int32_t *v1, const int32_t *off1,
    const int32_t *max_ed, const int32_t *arc_w, const int32_t *arc_ow,
    const int32_t *arc_cnt, const int32_t *seq_off, const int32_t *seq_len,
    const int32_t *seq, int J, int QCAP, int n_vtx, int dcap, int ccap,
    int tcap, int fcap, int wcap, int degcap, int hopcap, int evcap,
    int max_steps, int32_t *s_o, int32_t *flags_o, int32_t *walk_o,
    int32_t *nwalk_o, cudaStream_t stream)
{
    Caps c{QCAP, n_vtx, dcap, ccap, tcap, fcap, wcap, degcap, hopcap, evcap,
           max_steps};
    const int bytes = make_layout(c).bytes;
    cudaError_t err = cudaFuncSetAttribute(
        gwfa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    if (J == 0) return 0;
    gwfa_kernel<<<J, NT, bytes, stream>>>(
        q, ql, v0, off0, v1, off1, max_ed, arc_w, arc_ow, arc_cnt, seq_off,
        seq_len, seq, c, s_o, flags_o, walk_o, nwalk_o);
    return (int)cudaGetLastError();
}
