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
// A wave of a job holds few live states (the bridge jobs of a 5 Mb
// graph's reads: at most 87 at QCAP 256, mostly under 32; 90-173 at
// QCAP 1024) and runs up to twenty ordered appends, three sorts and two
// sorted-set merges one after the other, so a wave's time is the latency
// of those dependent steps (~10k cycles on eight warps, PERF.md).
//
// Design: one block of NT = 256 threads (eight warps) a job at both
// query buckets (one warp a job was slower at every launch shape: it
// runs the loops over candidates, events and groups in 8x the chunks;
// PERF.md).  The job's whole state lives in shared memory
// (113-115 KB at the default caps, QCAP 256-1024; one block an SM): the
// frontier and the hop wave (two buffers of dcap states, each state's
// vertex length and arc count), the candidates (ccap), the forbidden
// stage (4 dcap) and table (fcap), the visited table (2 dcap), the
// events (evcap x degcap, each with its arc), the trace (tcap) and the
// query.  The job's scalars (counts, flags, found, the winner) are the
// same in every thread and live in registers.
//  - Per-state work (extension, children, tests) runs one thread a
//    state; a state's thread is the same in every pass (p mod NT).  A
//    wave reads each state's vertex length and arc count, and each
//    event's arc, from device memory once; a team OR of what its states
//    hold skips the appends, sorts and merges it has nothing for.
//  - Every append keeps the JAX push order: a ballot of the team's
//    predicates and the popcount of the lanes below, the warps' counts
//    through shared memory (one barrier a chunk of 256), so candidates,
//    trace slots and the next wave sit where the JAX cumsum-and-scatter
//    puts them.
//  - The dedup groups the candidates by vd in a shared hash table
//    (atomicCAS on the key, atomicMax on (k, -position) for the winner),
//    so only the groups are sorted; past 2 dcap candidates it sorts them
//    all.  Sorts of up to 512 unique keys go by rank: each entry counts
//    the smaller keys, all threads reading the same key at once; longer
//    ones are shared-memory bitonic sorts.  Every key ends in the entry's
//    position, a total order (the plain version's stable sorts).
//  - The sorted sets (visited, forbidden) are merged in parallel by rank
//    and cut at their caps as the JAX sorted-insert cuts them; the walk
//    runs on one thread.
// Every synchronisation is a __syncthreads (or its OR).  The outputs go
// into one int32 buffer (s, flags, n_walk, then the walks), copied back
// in one copy.
//
// Places where the translation could go wrong, handled here:
//  1. Gathers out of range clamp in JAX (arc_cnt[v], seq_len[v] for pad
//     rows).  Here only real states are touched; v is clamped where the
//     JAX program clamps (cvc) and never out of range elsewhere.
//  2. Scatters with mode="drop" into pad slots (candidates at ccap, trace
//     at tcap, walk at wcap): an append hands the emitter every slot and
//     the emitter writes only below the cap; the walk overwrites slot
//     wcap - 1 past the cap as the JAX walk does.  tie_run's scatter-max
//     becomes an OR over the run, computed by its head's thread.
//  3. uint32 arithmetic of _mk_vd / _vd_d: mk_vd adds in unsigned and
//     zero-extends; vd_d reads the low word as unsigned then int.
//  4. lax.sort is not stable: ties on every key occur only among pads and
//     same-(vd, k) candidates; the comparator breaks them by position, as
//     the plain version's stable sorts do.
//  5. First-in-queue-order picks (argmax of the hits, the stable argsorts
//     of the vend states and the new arrivals) are a team minimum over
//     the position and ordered appends over position / event order.
//
// An optional clock buffer (null on every entry point's path; a template
// instance of its own) takes each job's clock64() cycles a phase, summed
// over its waves, and counts its synchronisations and waves.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace {

constexpr long long BIG = 0x7FFFFFFFFFFFFFFFLL;
constexpr unsigned DIAG_SHIFT = 1u << 30;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int NT = 256;         // threads a job
constexpr int NW = NT / 32;

constexpr int F_TIE = 1, F_DCAP = 2, F_TCAP = 4, F_DEG = 8, F_HOP = 16,
              F_FCAP = 32, F_STEPS = 128;

// per-position bits of the hop wave
constexpr unsigned char P_ACT = 1, P_VEND0 = 2, P_QEND0 = 4, P_HIT = 8,
                        P_QD = 16, P_VEND = 32, P_QV = 64;

// what the states of a hop wave hold, one bit each (a team OR)
constexpr unsigned B_INTER = 1, B_QD = 2, B_VEND = 4, B_QV = 8, B_DEG = 16;

// the clock buffer's columns (ops/gwfa.py CLK_COLUMNS): cycles a phase,
// then synchronisations, waves (steps plus hop waves), steps, and the
// cycles of the dedup phase's grouping (its hash table or its sort)
enum { PH_EXT, PH_CHILD, PH_EVENT, PH_FORB, PH_DEDUP, PH_WALK, CLK_SYNCS,
       CLK_WAVES, CLK_STEPS, CLK_DGROUP, CLK_N };

// an empty slot of the dedup phase's hash table (no vd has every bit set)
constexpr unsigned long long H_EMPTY = ~0ull;

__host__ __device__ inline int pow2ceil(int n)
{
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

struct Caps {
    int J, QCAP, n_vtx, dcap, ccap, tcap, fcap, wcap, degcap, hopcap, evcap,
        max_steps;
};

// byte offsets of the shared arrays (8-byte words first)
struct Layout {
    int c_vd, st, vis0, vis1, forb0, forb1, evk, nk, bvd0, bvd1;
    int c_k, c_t, c_n, bk0, bk1, bt0, bt1, bn0, bn1, tw, n_ext, svl, scnt,
        ev_w, ev_ow, cvp, sidx, tr_v, tr_pre, wbuf;
    int q;
    int pf, evm, eva;
    int hcap;           // the dedup hash table's largest size
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
    L.svl = take(o, c.dcap, 4);
    L.scnt = take(o, c.dcap, 4);
    L.ev_w = take(o, ecap, 4);
    L.ev_ow = take(o, ecap, 4);
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
    // the table's keys fill st, its winners nk, its taints the visited
    // buffers (4 dcap ints)
    L.hcap = 1;
    while (2 * L.hcap <= 4 * c.dcap) L.hcap *= 2;
    return L;
}

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

// The team of one job: the NT threads of its block.  Its collective
// operations are called by every thread with the same arguments.  CLK:
// thread 0 sums the cycles of each phase and counts the
// synchronisations into clk (shared).
template <bool CLK>
struct Team {
    // arrays of up to RMAX unique keys sort by rank: each entry counts
    // the smaller keys, every thread reading the same key at once (a
    // broadcast), n / NT entries of n reads a thread; longer ones take a
    // shared-memory bitonic sort
    static constexpr int RMAX = 2 * NT;
    int *s_warp;            // two slots of 2 NW ints in turn: warps' values
    int par;
    long long *clk;
    long long last;
    int cur;

    __device__ __forceinline__ void sync()
    {
        __syncthreads();
        if constexpr (CLK) if (threadIdx.x == 0) ++clk[CLK_SYNCS];
    }

    __device__ __forceinline__ bool any(bool x)
    {
        const bool r = __syncthreads_or(x) != 0;
        if constexpr (CLK) if (threadIdx.x == 0) ++clk[CLK_SYNCS];
        return r;
    }

    // each warp's value of one collective, into one of two slots in turn:
    // a slot is written again two collectives later, behind a barrier
    // that every thread passes only after reading it
    __device__ __forceinline__ const int *publish(int x)
    {
        int *sw = s_warp + par * 2 * NW;
        par ^= 1;
        if ((threadIdx.x & 31) == 0) sw[threadIdx.x >> 5] = x;
        sync();
        return sw;
    }

    // the team's minimum of x and OR of bits, in one collective
    __device__ __forceinline__ void min_or(int &x, unsigned &bits)
    {
        x = __reduce_min_sync(FULL, x);
        bits = __reduce_or_sync(FULL, bits);
        int *sw = s_warp + par * 2 * NW;
        par ^= 1;
        const int w = threadIdx.x >> 5;
        if ((threadIdx.x & 31) == 0) {
            sw[2 * w] = x;
            sw[2 * w + 1] = (int)bits;
        }
        sync();
        x = INT_MAX;
        bits = 0;
#pragma unroll
        for (int i = 0; i < NW; ++i) {
            x = min(x, sw[2 * i]);
            bits |= (unsigned)sw[2 * i + 1];
        }
    }

    __device__ __forceinline__ unsigned or_all(unsigned bits)
    {
        int x = INT_MAX;
        min_or(x, bits);
        return bits;
    }

    // exclusive prefix count of a 0/1 predicate in thread order; tot gets
    // the team's count
    __device__ __forceinline__ int scan01(int p, int &tot)
    {
        const unsigned m = __ballot_sync(FULL, p);
        const int lane = threadIdx.x & 31;
        const int below = __popc(m & ((1u << lane) - 1u));
        const int *sw = publish(__popc(m));
        const int w = threadIdx.x >> 5;
        int before = 0, t = 0;
#pragma unroll
        for (int i = 0; i < NW; ++i) {
            const int c = sw[i];
            if (i < w) before += c;
            t += c;
        }
        tot = t;
        return before + below;
    }

    // Append the items i < n with pred(i), in order of i, after count:
    // emit(i, slot) for each, slot possibly >= cap (the emitter writes
    // only below it: JAX's scatter into the pad slot).  Returns
    // min(count + appended, cap); sets over when a slot reached the cap.
    // Item i is thread i mod NT's; nothing is synchronised after the
    // emits.
    template <class Pred, class Emit>
    __device__ __forceinline__ int append(int n, int count, int cap,
                                          bool &over, Pred pred, Emit emit)
    {
        int c = count;
        for (int base = 0; base < n; base += NT) {
            const int i = base + threadIdx.x;
            const int p = i < n && pred(i) ? 1 : 0;
            int tot;
            const int pos = scan01(p, tot);
            if (p) emit(i, c + pos);
            over |= c + tot > cap;
            c += tot;
        }
        return c < cap ? c : cap;
    }

    // append() of npass passes that share one predicate: emit(i, a,
    // slot) for pass a.  On one chunk (n <= NT) one scan serves every
    // pass: pass a's slots follow the a earlier passes' tot items each.
    template <class Pred, class Emit>
    __device__ __forceinline__ int append_same(int n, int count, int cap,
                                               bool &over, int npass,
                                               Pred pred, Emit emit)
    {
        if (n > NT) {
            for (int a = 0; a < npass; ++a)
                count = append(n, count, cap, over, pred,
                               [&](int i, int slot) { emit(i, a, slot); });
            return count;
        }
        const int i = threadIdx.x;
        const int p = i < n && pred(i) ? 1 : 0;
        int tot;
        const int pos = scan01(p, tot);
        if (p)
            for (int a = 0; a < npass; ++a) emit(i, a, count + a * tot + pos);
        const int c = count + npass * tot;
        over |= c > cap;
        return c < cap ? c : cap;
    }

    // shared-memory bitonic sort of a (n a power of two) under less
    template <class V, class Less>
    __device__ __forceinline__ void bitonic(V *a, int n, Less less)
    {
        for (int k = 2; k <= n; k <<= 1)
            for (int j = k >> 1; j > 0; j >>= 1) {
                for (int i = threadIdx.x; i < n; i += NT) {
                    const int ixj = i ^ j;
                    if (ixj > i) {
                        const V x = a[i], y = a[ixj];
                        const bool sw = (i & k) == 0 ? less(y, x)
                                                     : less(x, y);
                        if (sw) { a[i] = y; a[ixj] = x; }
                    }
                }
                sync();
            }
    }

    // merge the disjoint sorted sets a and b into out, cut at cap (the
    // smallest cap values: JAX's sorted-insert keeps tab's width)
    __device__ __forceinline__ void merge_cut(const long long *a, int na,
                                              const long long *b, int nb,
                                              long long *out, int cap)
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

    // the clock: close the open phase, open ph
    __device__ __forceinline__ void mark(int ph)
    {
        if constexpr (CLK) {
            if (threadIdx.x == 0) {
                const long long now = clock64();
                clk[cur] += now - last;
                last = now;
                cur = ph;
            }
        }
    }
};

template <bool CLK>
__global__ void __launch_bounds__(NT, 1) gwfa_kernel(
    const int32_t *__restrict__ q_g, const int32_t *__restrict__ ql_g,
    const int32_t *__restrict__ v0_g, const int32_t *__restrict__ off0_g,
    const int32_t *__restrict__ v1_g, const int32_t *__restrict__ off1_g,
    const int32_t *__restrict__ med_g, const int32_t *__restrict__ arc_w,
    const int32_t *__restrict__ arc_ow, const int32_t *__restrict__ arc_cnt,
    const int32_t *__restrict__ seq_off, const int32_t *__restrict__ seq_len,
    const int32_t *__restrict__ seq, Caps cp, int32_t *__restrict__ out,
    long long *__restrict__ clk_o)
{
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int s_warp[4 * NW];
    __shared__ int s_nf, s_wn, s_flags;
    __shared__ long long s_clk[CLK_N];
    const Layout L = make_layout(cp);
    long long *c_vd = (long long *)(smem + L.c_vd);
    long long *st = (long long *)(smem + L.st);
    long long *vis = (long long *)(smem + L.vis0);
    long long *vis2 = (long long *)(smem + L.vis1);
    long long *forb = (long long *)(smem + L.forb0);
    long long *forb2 = (long long *)(smem + L.forb1);
    long long *evk = (long long *)(smem + L.evk);
    long long *nk = (long long *)(smem + L.nk);
    long long *bvd0 = (long long *)(smem + L.bvd0),
              *bvd1 = (long long *)(smem + L.bvd1);
    int *c_k = (int *)(smem + L.c_k), *c_t = (int *)(smem + L.c_t),
        *c_n = (int *)(smem + L.c_n);
    int *bk0 = (int *)(smem + L.bk0), *bk1 = (int *)(smem + L.bk1);
    int *bt0 = (int *)(smem + L.bt0), *bt1 = (int *)(smem + L.bt1);
    int *bn0 = (int *)(smem + L.bn0), *bn1 = (int *)(smem + L.bn1);
    int *tw = (int *)(smem + L.tw), *n_ext = (int *)(smem + L.n_ext),
        *svl = (int *)(smem + L.svl), *scnt = (int *)(smem + L.scnt),
        *ev_w = (int *)(smem + L.ev_w), *ev_ow = (int *)(smem + L.ev_ow),
        *cvp = (int *)(smem + L.cvp), *sidx = (int *)(smem + L.sidx),
        *tr_v = (int *)(smem + L.tr_v), *tr_pre = (int *)(smem + L.tr_pre),
        *wbuf = (int *)(smem + L.wbuf);
    short *q = (short *)(smem + L.q);
    unsigned char *pf = smem + L.pf, *evm = smem + L.evm,
                  *eva = smem + L.eva;

    Team<CLK> T{s_warp, 0, s_clk, 0, PH_EXT};
    const int job = blockIdx.x, tid = threadIdx.x;
    const int J = cp.J, dcap = cp.dcap, ccap = cp.ccap, tcap = cp.tcap,
              fcap = cp.fcap, degcap = cp.degcap, n_vtx = cp.n_vtx;
    const int ql = ql_g[job], v1 = v1_g[job], off1 = off1_g[job],
              max_ed = med_g[job];
    for (int i = tid; i < cp.QCAP; i += NT)
        q[i] = (short)q_g[(size_t)job * cp.QCAP + i];
    for (int i = tid; i < tcap; i += NT) { tr_v[i] = -1; tr_pre[i] = -1; }
    if (tid == 0) {
        // initial frontier (gfa_ed_init, gfa-ed.c:552-560)
        bvd0[0] = mk_vd(v0_g[job], -off0_g[job]);
        bk0[0] = off0_g[job] - 1;
        bt0[0] = 0;
        bn0[0] = 0;
        if constexpr (CLK) {
            for (int i = 0; i < CLK_N; ++i) s_clk[i] = 0;
            T.last = clock64();
        }
    }
    T.sync();
    // the job's scalars, the same in every thread
    int n_a = 1, n_forb = 0, tr_n = 1, flags = 0, s = 0;
    int end_t = -1, end_v = -1, end_tn = 0;
    bool found = false, dead = false;

    // the candidate emitter (writes below ccap only)
    auto cand_emit = [&](int slot, long long vd, int k, int t, int tn) {
        if (slot < ccap) {
            c_vd[slot] = vd; c_k[slot] = k; c_t[slot] = t; c_n[slot] = tn;
        }
    };
    auto stage_add = [&](long long vd) {
        const int p = atomicAdd(&s_nf, 1);
        if (p < 4 * dcap) st[p] = vd;
    };
    auto clampv = [&](int v) { return min(max(v, 0), n_vtx - 1); };

    while (!(found || dead || flags)) {
        T.mark(PH_EXT);
        if (tid == 0) {
            s_nf = 0;
            if constexpr (CLK) {
                ++s_clk[CLK_WAVES];
                ++s_clk[CLK_STEPS];
            }
        }
        int n_c = 0, n_vis = 0;
        // ---- batch-extension phase over the whole frontier (buffer 0)
        const int nA = n_a;
        const long long *avd = bvd0;
        int *ak = bk0;
        const int *at = bt0, *an = bn0;
        int bnd_any = 0;
        for (int p = tid; p < nA; p += NT) {
            const int k = extend1(avd[p], ak[p], ql, q, seq_off, seq_len,
                                  seq);
            ak[p] = k;
            const int vl = seq_len[vd_v(avd[p])];
            svl[p] = vl;
            const bool b = k == vl - 1 || vd_d(avd[p]) + k == ql - 1;
            pf[p] = b ? P_ACT : 0;
            bnd_any |= b;
        }
        const bool had_a = T.any(bnd_any);
        T.mark(PH_CHILD);

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
            const int k = ak[p], vl = svl[p];
            int ck, ct, cn;
            merged(p, ck, ct, cn);
            if (ck == vl) stage_add(vd);
            if (!has_l(p) && k + 1 == vl) stage_add(vd - 1);
            if (!has_r(p) && k == vl) stage_add(vd + 1);
        }
        bool ovf = false;
        n_c = T.append(nA, n_c, ccap, ovf,
            [&](int p) {
                int ck, ct, cn;
                merged(p, ck, ct, cn);
                return vd_d(avd[p]) + ck < ql && ck < svl[p];
            },
            [&](int p, int slot) {
                int ck, ct, cn;
                merged(p, ck, ct, cn);
                cand_emit(slot, avd[p], ck, ct, cn);
            });
        n_c = T.append(nA, n_c, ccap, ovf,
            [&](int p) {
                const int d = vd_d(avd[p]), k = ak[p];
                return !has_l(p) && (d - 1) + (k + 1) < ql
                    && k + 1 < svl[p];
            },
            [&](int p, int slot) {
                cand_emit(slot, avd[p] - 1, ak[p] + 1, at[p], an[p]);
            });
        n_c = T.append(nA, n_c, ccap, ovf,
            [&](int p) {
                const int d = vd_d(avd[p]), k = ak[p];
                return !has_r(p) && (d + 1) + k < ql && k < svl[p];
            },
            [&](int p, int slot) {
                cand_emit(slot, avd[p] + 1, ak[p], at[p], an[p]);
            });
        if (ovf) flags |= F_DCAP;

        // ---- queue phase: boundary states wave by wave (the A queue)
        int cur = 0, nB = nA;
        bool any_act = had_a;
        int hop = 0;
        while (any_act && hop < cp.hopcap) {
            if constexpr (CLK) if (tid == 0) ++s_clk[CLK_WAVES];
            const long long *Bvd = cur ? bvd1 : bvd0;
            const int *Bk = cur ? bk1 : bk0, *Bt = cur ? bt1 : bt0,
                      *Bn = cur ? bn1 : bn0;
            long long *Nvd = cur ? bvd0 : bvd1;
            int *Nk = cur ? bk0 : bk1, *Nt = cur ? bt0 : bt1,
                *Nn = cur ? bn0 : bn1;
            // each state's vertex length and arc count, once a wave
            int first = INT_MAX;
            unsigned bits = 0;
            for (int p = tid; p < nB; p += NT) {
                const int v = clampv(vd_v(Bvd[p]));
                const int vl = seq_len[v];
                svl[p] = vl;
                scnt[p] = arc_cnt[v];
                unsigned char f = pf[p] & P_ACT;
                if (Bk[p] == vl - 1) f |= P_VEND0;
                if (vd_d(Bvd[p]) + Bk[p] == ql - 1) f |= P_QEND0;
                // (b) target check at query end: the first hit in
                // position order wins
                if ((f & (P_ACT | P_QEND0)) == (P_ACT | P_QEND0)
                    && vd_v(Bvd[p]) == v1 && Bk[p] == off1) {
                    f |= P_HIT;
                    first = min(first, p);
                }
                if ((f & (P_ACT | P_VEND0 | P_QEND0)) == P_ACT)
                    bits |= B_INTER;
                pf[p] = f;
                n_ext[p] = 0;
                tw[p] = Bt[p];
            }
            T.min_or(first, bits);
            // (a) re-interior states: 3 children, no run
            ovf = false;
            if (bits & B_INTER)
                n_c = T.append_same(nB, n_c, ccap, ovf, 3,
                    [&](int p) {
                        return (pf[p] & (P_ACT | P_VEND0 | P_QEND0)) == P_ACT;
                    },
                    [&](int p, int a, int slot) {
                        cand_emit(slot, mk_vd(vd_v(Bvd[p]),
                                              vd_d(Bvd[p]) + a - 1),
                                  Bk[p] + (a < 2 ? 1 : 0), Bt[p], Bn[p]);
                    });
            if (first != INT_MAX) {
                if (!found) {
                    end_t = Bt[first];
                    end_v = vd_v(Bvd[first]);
                    end_tn = Bn[first];
                }
                found = true;
            }
            unsigned mine = 0;
            for (int p = tid; p < nB; p += NT) {
                unsigned char f = pf[p];
                const int v = vd_v(Bvd[p]);
                const bool qend = (f & (P_ACT | P_QEND0)) == (P_ACT | P_QEND0);
                const bool hit = f & P_HIT;
                const bool qd = qend && !hit && Bk[p] + 1 < svl[p] && !found;
                const bool vend = (f & (P_ACT | P_VEND0 | P_QEND0))
                    == (P_ACT | P_VEND0) && !found;
                const bool qv = qend && !hit && !qd && v != v1 && !found;
                if (qd) {
                    f |= P_QD;
                    mine |= B_QD;
                }
                if (vend) {
                    f |= P_VEND;
                    mine |= B_VEND;
                    stage_add(Bvd[p]);
                }
                if (qv) {
                    f |= P_QV;
                    mine |= B_QV;
                }
                if ((vend || qv) && scnt[p] > degcap) mine |= B_DEG;
                pf[p] = f;
            }
            bits = T.or_all(mine);
            if (bits & B_DEG) flags |= F_DEG;
            // query end, vertex unfinished, not the target: deletion
            if (bits & B_QD)
                n_c = T.append(nB, n_c, ccap, ovf,
                    [&](int p) { return (pf[p] & P_QD) != 0; },
                    [&](int p, int slot) {
                        cand_emit(slot, mk_vd(vd_v(Bvd[p]), vd_d(Bvd[p]) - 1),
                                  Bk[p] + 1, Bt[p], Bn[p]);
                    });
            // (c) expansion trace pushes: one per expanding state; past
            // tcap the state's trace index is tcap - 1
            bool tovf = false;
            if (bits & (B_VEND | B_QV))
                tr_n = T.append(nB, tr_n, tcap, tovf,
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
            if (tovf) flags |= F_TCAP;
            int n_next = 0;
            if (bits & B_VEND) {
                // (d) arc events of the first evcap vend states
                T.mark(PH_EVENT);
                bool eovf = false;
                const int n_cv = T.append(nB, 0, cp.evcap, eovf,
                    [&](int p) { return (pf[p] & P_VEND) != 0; },
                    [&](int p, int slot) {
                        if (slot < cp.evcap) cvp[slot] = p;
                    });
                if (eovf) flags |= F_DCAP;
                T.sync();
                const int n_ev = n_cv * degcap;
                for (int e = tid; e < n_ev; e += NT) {
                    const int p = cvp[e / degcap], ai = e % degcap;
                    const int vc = clampv(vd_v(Bvd[p]));
                    const int i = vd_d(Bvd[p]) + Bk[p];
                    long long key = BIG;
                    unsigned char m = 0;
                    if (ai < scnt[p]) {
                        const int w = arc_w[vc * degcap + ai];
                        const int ow = arc_ow[vc * degcap + ai];
                        m = i + 1 < ql && ow < seq_len[w]
                            && seq[seq_off[w] + ow] == (int)q[i + 1];
                        if (m) atomicAdd(&n_ext[p], 1);
                        key = ((long long)w << 32) | (long long)(i + 1);
                        ev_w[e] = w;
                        ev_ow[e] = ow;
                    }
                    evk[e] = key;
                    evm[e] = m;
                    eva[e] = 0;
                }
                T.sync();
                // sort events by (key, order): event index order is the
                // host's (position, arc) order
                if (n_ev <= T.RMAX) {
                    for (int e = tid; e < n_ev; e += NT) {
                        const long long k = evk[e];
                        int r = 0;
                        for (int j = 0; j < n_ev; ++j) {
                            const long long kj = evk[j];
                            r += (kj < k) | ((kj == k) & (j < e));
                        }
                        sidx[r] = e;
                    }
                    T.sync();
                } else {
                    const int p2e = pow2ceil(n_ev);
                    for (int e = tid; e < p2e; e += NT)
                        sidx[e] = e < n_ev ? e : INT_MAX;
                    T.sync();
                    T.bitonic(sidx, p2e, [&](int a, int b) {
                        if (b == INT_MAX) return a != INT_MAX;
                        if (a == INT_MAX) return false;
                        return evk[a] < evk[b]
                            || (evk[a] == evk[b] && a < b);
                    });
                }
                // the head of each key run acts unless visited this step
                for (int jj = tid; jj < n_ev; jj += NT) {
                    const int e = sidx[jj];
                    const long long key = evk[e];
                    if (key != BIG && (jj == 0 || evk[sidx[jj - 1]] != key)
                        && !member64(vis, n_vis, key))
                        eva[e] = 1;
                }
                T.sync();
                bool unused = false;
                const int n_nk = T.append(n_ev, 0, n_ev, unused,
                    [&](int jj) { return eva[sidx[jj]] != 0; },
                    [&](int jj, int slot) { nk[slot] = evk[sidx[jj]]; });
                if (n_nk) {
                    T.sync();
                    T.merge_cut(vis, n_vis, nk, n_nk, vis2, 2 * dcap);
                    long long *t = vis; vis = vis2; vis2 = t;
                }
                if (n_vis + n_nk > 2 * dcap) flags |= F_FCAP;
                n_vis = min(n_vis + n_nk, 2 * dcap);
                // matching winners become the next wave, in event order
                bool novf = false;
                n_next = T.append(n_ev, 0, dcap, novf,
                    [&](int e) { return eva[e] && evm[e]; },
                    [&](int e, int slot) {
                        if (slot >= dcap) return;
                        const int p = cvp[e / degcap];
                        const int ow = ev_ow[e];
                        const int i = vd_d(Bvd[p]) + Bk[p];
                        Nvd[slot] = mk_vd(ev_w[e], i + 1 - ow);
                        Nk[slot] = ow;
                        Nt[slot] = tw[p];
                        Nn[slot] = Bn[p];
                    });
                if (novf) flags |= F_DCAP;
                // mismatching winners push the two cross-vertex children,
                // in sorted event order
                T.mark(PH_CHILD);
                for (int dd = 0; dd < 2; ++dd) {
                    auto ch_d = [&](int e, int p) {
                        return vd_d(Bvd[p]) + Bk[p] + dd - ev_ow[e];
                    };
                    n_c = T.append(n_ev, n_c, ccap, ovf,
                        [&](int jj) {
                            const int e = sidx[jj];
                            if (!eva[e] || evm[e]) return false;
                            return ch_d(e, cvp[e / degcap]) + ev_ow[e] < ql;
                        },
                        [&](int jj, int slot) {
                            const int e = sidx[jj], p = cvp[e / degcap];
                            cand_emit(slot, mk_vd(ev_w[e], ch_d(e, p)),
                                      ev_ow[e], tw[p], Bn[p]);
                        });
                }
                // residual child (v, d+1, k) when not every arc matched
                n_c = T.append(nB, n_c, ccap, ovf,
                    [&](int p) {
                        if (!(pf[p] & P_VEND)) return false;
                        const int cnt = scnt[p];
                        return cnt == 0 || n_ext[p] != min(cnt, degcap);
                    },
                    [&](int p, int slot) {
                        cand_emit(slot,
                                  mk_vd(vd_v(Bvd[p]), vd_d(Bvd[p]) + 1),
                                  Bk[p], Bt[p], Bn[p]);
                    });
            }
            // (e) query end at a non-target vertex end: one child an
            // arc, not visited-checked (gfa-ed.c:351-357)
            if (bits & B_QV)
                for (int ai = 0; ai < degcap; ++ai)
                    n_c = T.append(nB, n_c, ccap, ovf,
                        [&](int p) { return (pf[p] & P_QV) && ai < scnt[p]; },
                        [&](int p, int slot) {
                            const int vc = clampv(vd_v(Bvd[p]));
                            const int w = arc_w[vc * degcap + ai];
                            const int ow = arc_ow[vc * degcap + ai];
                            cand_emit(slot,
                                      mk_vd(w, vd_d(Bvd[p]) + Bk[p] - ow),
                                      ow, tw[p], Bn[p]);
                        });
            if (ovf) flags |= F_DCAP;
            T.sync();
            // next wave: extend the fresh arrivals
            T.mark(PH_EXT);
            for (int p = tid; p < n_next; p += NT) {
                if (!found)
                    Nk[p] = extend1(Nvd[p], Nk[p], ql, q, seq_off, seq_len,
                                    seq);
                pf[p] = P_ACT;
            }
            if (hop + 1 >= cp.hopcap && n_next > 0 && !found)
                flags |= F_HOP;
            any_act = n_next > 0 && !found;
            nB = n_next;
            cur ^= 1;
            ++hop;
            T.sync();
            T.mark(PH_CHILD);
        }
        // ---- forbidden bands
        T.sync();
        T.mark(PH_FORB);
        const int nf_all = s_nf;
        const int nf = min(nf_all, 4 * dcap);
        if (nf_all > 4 * dcap && !found) flags |= F_FCAP;
        // sidx: the staged vds' order, (vd, index) by rank, or the
        // identity after an in-place bitonic sort
        if (nf <= T.RMAX) {
            for (int i = tid; i < nf; i += NT) {
                const long long v = st[i];
                int r = 0;
                for (int j = 0; j < nf; ++j) {
                    const long long vj = st[j];
                    r += (vj < v) | ((vj == v) & (j < i));
                }
                sidx[r] = i;
            }
        } else {
            const int p2s = pow2ceil(nf);
            for (int i = nf + tid; i < p2s; i += NT) st[i] = BIG;
            T.sync();
            T.bitonic(st, p2s,
                      [](long long a, long long b) { return a < b; });
            for (int i = tid; i < nf; i += NT) sidx[i] = i;
        }
        T.sync();
        bool unused = false;
        const int n_nk = T.append(nf, 0, nf, unused,
            [&](int i) {
                const long long v = st[sidx[i]];
                return (i == 0 || v != st[sidx[i - 1]])
                    && !member64(forb, n_forb, v);
            },
            [&](int i, int slot) { nk[slot] = st[sidx[i]]; });
        if (n_nk) {
            T.sync();
            T.merge_cut(forb, n_forb, nk, n_nk, forb2, fcap);
            long long *t = forb; forb = forb2; forb2 = t;
        }
        if (n_forb + n_nk > fcap && !found) flags |= F_FCAP;
        n_forb = min(n_forb + n_nk, fcap);
        T.sync();
        // ---- dedup + forbidden filter -> next frontier (buffer 0)
        T.mark(PH_DEDUP);
        int n_keep = 0;
        if (!found && flags == 0) {
            const int nc = T.append(n_c, 0, n_c, unused,
                [&](int c) { return !member64(forb, n_forb, c_vd[c]); },
                [&](int c, int slot) { sidx[slot] = c; });
            T.sync();
            long long t_group = 0;
            if constexpr (CLK) t_group = clock64();
            const int H = pow2ceil(2 * nc);
            if (nc > 0 && H <= L.hcap) {
                // Group the candidates by vd in a hash table (open
                // addressing; keys in st, each group's winner in nk, its
                // taint in the visited buffers, all free here).  The
                // winner is the largest (k, -position), as the run head
                // of the sort below; then the groups sort by vd.
                unsigned long long *hkey = (unsigned long long *)st;
                unsigned long long *hbest = (unsigned long long *)nk;
                int *htaint = (int *)(smem + L.vis0);
                const int lg = __ffs(H) - 1;
                auto home = [&](long long vd) {
                    return (int)(((unsigned long long)vd
                                  * 0x9E3779B97F4A7C15ull) >> (64 - lg));
                };
                auto find = [&](long long vd) {
                    int h = home(vd);
                    while (hkey[h] != (unsigned long long)vd)
                        h = (h + 1) & (H - 1);
                    return h;
                };
                for (int h = tid; h < H; h += NT) {
                    hkey[h] = H_EMPTY;
                    hbest[h] = 0;
                    htaint[h] = 0;
                }
                T.sync();
                for (int j = tid; j < nc; j += NT) {
                    const int c = sidx[j];
                    const unsigned long long vd = (unsigned long long)c_vd[c];
                    int h = home(c_vd[c]);
                    while (true) {
                        const unsigned long long was =
                            atomicCAS(&hkey[h], H_EMPTY, vd);
                        if (was == H_EMPTY || was == vd) break;
                        h = (h + 1) & (H - 1);
                    }
                    atomicMax(&hbest[h],
                              ((unsigned long long)((unsigned)c_k[c]
                                                    ^ 0x80000000u) << 32)
                              | (0xFFFFFFFFu - (unsigned)c));
                }
                T.sync();
                // a same-(vd, k) duplicate with a different trace taints
                // the group; without boundary states any different-trace
                // duplicate does (the host only dedups on steps with an A
                // queue)
                for (int j = tid; j < nc; j += NT) {
                    const int c = sidx[j], h = find(c_vd[c]);
                    const int w = (int)(0xFFFFFFFFu - (unsigned)hbest[h]);
                    if (c_t[c] != c_t[w] && (c_k[c] == c_k[w] || !had_a))
                        htaint[h] = 1;
                }
                T.sync();
                // the groups, their vds beside them (in the visited
                // buffers' second half)
                long long *gkey = (long long *)(smem + L.vis1);
                const int ng = T.append(H, 0, H, unused,
                    [&](int h) { return hkey[h] != H_EMPTY; },
                    [&](int h, int slot) {
                        sidx[slot] = h;
                        gkey[slot] = (long long)hkey[h];
                    });
                T.sync();
                // group g's frontier slot is its vd's rank
                auto keep = [&](int r, int h) {
                    if (r >= dcap) return;
                    const int w = (int)(0xFFFFFFFFu - (unsigned)hbest[h]);
                    bvd0[r] = c_vd[w];
                    bk0[r] = c_k[w];
                    bt0[r] = c_t[w];
                    bn0[r] = c_n[w] | htaint[h];
                };
                if (ng <= T.RMAX) {
                    for (int g = tid; g < ng; g += NT) {
                        const long long k = gkey[g];
                        int r = 0;
                        for (int j = 0; j < ng; ++j) r += gkey[j] < k;
                        keep(r, sidx[g]);
                    }
                } else {
                    const int p2g = pow2ceil(ng);
                    for (int i = ng + tid; i < p2g; i += NT)
                        sidx[i] = INT_MAX;
                    T.sync();
                    T.bitonic(sidx, p2g, [&](int a, int b) {
                        if (b == INT_MAX) return a != INT_MAX;
                        if (a == INT_MAX) return false;
                        return (long long)hkey[a] < (long long)hkey[b];
                    });
                    for (int g = tid; g < ng; g += NT) keep(g, sidx[g]);
                }
                n_keep = min(ng, dcap);
                if (ng > dcap) flags |= F_DCAP;
            } else {
                // (vd asc, k desc, position): the winner is the run head
                const int p2c = pow2ceil(nc);
                for (int i = nc + tid; i < p2c; i += NT) sidx[i] = INT_MAX;
                T.sync();
                T.bitonic(sidx, p2c, [&](int a, int b) {
                    if (b == INT_MAX) return a != INT_MAX;
                    if (a == INT_MAX) return false;
                    if (c_vd[a] != c_vd[b]) return c_vd[a] < c_vd[b];
                    if (c_k[a] != c_k[b]) return c_k[a] > c_k[b];
                    return a < b;
                });
                // the taint of a run, as in the table above
                bool keep_ovf = false;
                n_keep = T.append(nc, 0, dcap, keep_ovf,
                    [&](int jj) {
                        return jj == 0
                            || c_vd[sidx[jj]] != c_vd[sidx[jj - 1]];
                    },
                    [&](int jj, int slot) {
                        if (slot >= dcap) return;
                        const int h = sidx[jj];
                        int taint = 0;
                        for (int e = jj + 1;
                             e < nc && c_vd[sidx[e]] == c_vd[h]; ++e) {
                            const int x = sidx[e];
                            if (c_t[x] != c_t[h]
                                && (c_k[x] == c_k[h] || !had_a))
                                taint = 1;
                        }
                        bvd0[slot] = c_vd[h];
                        bk0[slot] = c_k[h];
                        bt0[slot] = c_t[h];
                        bn0[slot] = c_n[h] | taint;
                    });
                if (keep_ovf) flags |= F_DCAP;
            }
            if constexpr (CLK)
                if (tid == 0) s_clk[CLK_DGROUP] += clock64() - t_group;
        }
        n_a = n_keep;
        dead = dead || (!found && n_keep == 0);
        if (!(found || dead) && flags == 0) ++s;
        if (s > max_ed && !found) dead = true;
        if (s >= cp.max_steps && s <= max_ed && !found && !dead
            && flags == 0)
            flags |= F_STEPS;
        T.sync();
    }
    // ---- walk reconstruction (gfa_ed_step traceback), one thread
    T.mark(PH_WALK);
    const int wcap = cp.wcap;
    if (tid == 0) {
        int fl = flags;
        if (found && end_tn != 0) fl |= F_TIE;
        for (int i = 0; i < wcap; ++i) wbuf[i] = -1;
        int wn = 0;
        if (found && fl == 0) {
            wbuf[0] = end_v;
            wn = 1;
            int c = end_t;
            while (true) {
                const int cc = min(max(c, 0), tcap - 1);
                const int pv = tr_v[cc];
                if (c < 0 || pv < 0) break;
                wbuf[min(wn, wcap - 1)] = pv;
                c = tr_pre[cc];
                ++wn;
            }
        }
        if (wn > wcap) fl |= F_TCAP;
        s_wn = wn;
        s_flags = fl;
    }
    T.sync();
    // one int32 buffer: s (J), flags (J), n_walk (J), then the walks
    const int wn = s_wn;
    int32_t *walk = out + 3 * (size_t)J + (size_t)job * wcap;
    for (int i = tid; i < wcap; i += NT)
        walk[i] = i < wn ? wbuf[min(max(wn - 1 - i, 0), wcap - 1)] : -1;
    if (tid == 0) {
        out[job] = found ? s : -1;
        out[J + job] = s_flags;
        out[2 * J + job] = wn;
    }
    if constexpr (CLK) {
        T.mark(PH_WALK);
        if (tid == 0)
            for (int i = 0; i < CLK_N; ++i)
                clk_o[(size_t)job * CLK_N + i] = s_clk[i];
    }
}

constexpr int MAX_DEV = 64;

template <bool CLK>
cudaError_t launch(const int32_t *q, const int32_t *ql, const int32_t *v0,
                   const int32_t *off0, const int32_t *v1,
                   const int32_t *off1, const int32_t *max_ed,
                   const int32_t *arc_w, const int32_t *arc_ow,
                   const int32_t *arc_cnt, const int32_t *seq_off,
                   const int32_t *seq_len, const int32_t *seq,
                   const Caps &c, int32_t *out, long long *clk,
                   cudaStream_t stream)
{
    // the dynamic shared memory limit is set once a device and size: the
    // largest size set so far covers every smaller one.  The lock keeps
    // the attribute and set_bytes together when threads launch at once.
    static std::mutex mu;
    static int set_bytes[MAX_DEV];
    const int bytes = make_layout(c).bytes;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    {
        std::lock_guard<std::mutex> hold(mu);
        if (dev >= MAX_DEV || bytes > set_bytes[dev]) {
            err = cudaFuncSetAttribute(
                gwfa_kernel<CLK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                bytes);
            if (err != cudaSuccess) return err;
            if (dev < MAX_DEV) set_bytes[dev] = bytes;
        }
    }
    gwfa_kernel<CLK><<<c.J, NT, bytes, stream>>>(
        q, ql, v0, off0, v1, off1, max_ed, arc_w, arc_ow, arc_cnt, seq_off,
        seq_len, seq, c, out, clk);
    return cudaGetLastError();
}

}  // namespace

// out: J * (3 + wcap) int32.  clk: null, or J * CLK_N int64 for each
// job's phase cycles, synchronisations and waves.
extern "C" int mgt_cuda_gwfa(
    const int32_t *q, const int32_t *ql, const int32_t *v0,
    const int32_t *off0, const int32_t *v1, const int32_t *off1,
    const int32_t *max_ed, const int32_t *arc_w, const int32_t *arc_ow,
    const int32_t *arc_cnt, const int32_t *seq_off, const int32_t *seq_len,
    const int32_t *seq, int J, int QCAP, int n_vtx, int dcap, int ccap,
    int tcap, int fcap, int wcap, int degcap, int hopcap, int evcap,
    int max_steps, int32_t *out, long long *clk,
    cudaStream_t stream)
{
    const Caps c{J, QCAP, n_vtx, dcap, ccap, tcap, fcap, wcap, degcap,
                 hopcap, evcap, max_steps};
    if (J == 0) return 0;
    auto go = [&](auto fn) {
        return (int)fn(q, ql, v0, off0, v1, off1, max_ed, arc_w, arc_ow,
                       arc_cnt, seq_off, seq_len, seq, c, out, clk, stream);
    };
    return clk ? go(launch<true>) : go(launch<false>);
}
