// Chunked-walk exact-or-flag linear-chaining DP (mg_lchain_dp,
// lchain.c:149-219): the contract of chain_exact.cu, but each anchor
// scores the top TOP rows of its window and then walks deeper BLK-row
// blocks only while a block bound says a deeper row could still win.
//
// Replaces the Pallas kernel minigraph_tpu/ops/chain_chunked_pallas.py
// _make_kernel (called through chain_chunked_pallas_traced) and is held
// bitwise against the plain PyTorch version ops/chain_chunked.py
// lchain_dp_chunked_ref on f, p and sure of every read.
//
// What bounds it on an H100: latency, not a peak.  A read is a chain of
// n_a dependent anchor steps; a batch holds only 128-256 reads, about
// one per SM, so the time is the longest read's n_a steps times the
// latency of one.  Each step scores TOP rows (comput_sc, ~40 operations
// a row) plus, rarely, a few blocks of BLK rows.
//
// Design: chain_exact.cu's two passes on this contract.  One block of 16
// warps a read; the read's rows (xh, tp, qp, sp, f) sit in a shared ring
// of CAP >= W + 2T rows (row j in slot (j + W) & (CAP - 1); rows below 0
// are never candidates and are tested as such).  The anchors of a tile
// are taken in groups of at most G; fb is the start of the group before.
//  (a) part A of group k, twelve warps, one warp an anchor i: over the
//      top rows [i - TOP, i) it writes the valid rows as four ballot
//      words, tests the candidate row i - TOP (whether a walk may go on
//      below the top rows) and the overflow row i0 - W, reduces the
//      lexicographic (sc + f, row) max over the rows below fb, whose f
//      is final, and stores sc and validity of the rows [fb, i) (at most
//      2G - 1) into the group's tables.  Refused rows count as
//      (NEG_BIG, INT_MIN), so the value is the max over all top rows and
//      the row the largest valid row of that value: the TPU kernel's max
//      and masked argmax.
//  (b) warp 0, sequential: for each anchor it scores the rows [fb, i)
//      from the tables (two a lane), combines them with (a)'s maximum
//      (two redux.sync) and writes f to the ring and the output.  The
//      step is one chain of dependent latencies, so that chain holds only
//      what f needs: lane l keeps f of the rows fb + l and fb + l + 32 in
//      registers (f_i is uniform, so the owner lane just takes it), all
//      the step reads from the tables and the ring is loaded one step
//      ahead, and the rest of step t -- the skip count (valid & marked
//      rows of the top chunk above the chosen row, popcounts), the flag,
//      p and p's mark -- is settled during step t + 1.  Lanes 0-4 hold the
//      marked bits of the rows [g0 - TOP, g0 + G) in registers, so marks
//      made while the group is chained count at once; they are ORed into
//      the read's shared mask before a walk and at the group's end.
// Part A of group k reads f only below group k - 1, so it runs while
// warp 0 chains group k - 1; each phase ends at one __syncthreads.  The
// warps that share warp 0's scheduler (4, 8, 12) stay idle.
//
// The deep walk runs on warp 0 inside the step (it is rare: tens to a few
// thousand blocks a batch on real reads), two rows a lane, from blocks
// just below the top chunk downwards; it stops when the bound
// pm + 31 <= M, when the block's deepest row is no candidate, or below
// block 0.  A block that beats M strictly takes over M and the row, and
// the skip count becomes the walked rows above it: every counted row of
// the top chunk and the blocks before, plus the block's rows above its
// argmax.  The marked bits of walked rows come from the read's marked
// bitmask in shared memory (rows [-MOFF, A)).
//
// The bound pm of block b is the prefix max of f over the tile's window
// rows [i0 - W, i0 - W + BLK (b + 1)), masked to the vertex of the tile's
// first or last anchor.  Schedule: at t = i - i0 < 65 the walk starts at
// block (W - TOP - 1 + t) / BLK <= W / BLK - 2, whose rows lie below
// i0 - 64, below the previous group; so part A of the tile's group 0
// computes the prefix maxima of blocks 0 .. W/BLK - 2.  The top block
// [i0 - 64, i0) is needed only from t = 65 (group 2 when G = 32), and
// part A of group 1 (fb = i0: every row below i0 is final) folds it in.
// The maxima are kept twice, by tile parity, so that the next tile's
// group 0 writes while warp 0 still walks the last group of this one.
// tests/test_torch_chain_chunked_split.py models this schedule on the CPU.
#include "chain_sc.cuh"

namespace {

constexpr int TOP = 128;
constexpr int BLK = 64;
constexpr int MAX_WINDOW = 32 * BLK;   // the prefix scan: one block a lane
constexpr int G = 32;            // anchors per group
constexpr int NU = 2 * G;        // table rows [fb, i) of an anchor
constexpr int TW = TOP / 32;     // valid words of an anchor's top rows
constexpr int NWARPS = 16;
constexpr int THREADS = 32 * NWARPS;
constexpr int A_WARPS = 12;      // part A: the warps with warp % 4 != 0
constexpr int A_THREADS = 32 * A_WARPS;
constexpr int MOFF = MAX_WINDOW; // marked-bit offset, >= W
// per-anchor results of part A: best, its row, cand_lo | overflow << 1
constexpr int NPRE = 3;
constexpr int NPM = 2 * 2 * 32;  // prefix maxima [parity][first, last][block]

__host__ __device__ inline int ring_rows(int W, int T)
{
    int cap = 32;
    while (cap < W + 2 * T) cap <<= 1;
    return cap;
}

// the read's marked mask: rows [-MOFF, A + TOP)
__host__ __device__ inline int marked_words(int A)
{
    return ((A + MOFF) >> 5) + 2 + TW;
}

constexpr int SET_WORDS = G * TW + G * NU + NPRE * G;

// in 4-byte words, then the validity bytes: ring, prefix maxima, the
// tiles' first and last x-hi, marked mask, two table sets
__host__ __device__ inline int64_t smem_bytes(int W, int T, int A)
{
    return 4 * (5 * (int64_t)ring_rows(W, T) + NPM + 4 + marked_words(A)
                + 2 * SET_WORDS) + 2 * G * NU;
}

// the 32 marked bits of rows [r0, r0 + 32) (r0 >= -MOFF)
__device__ __forceinline__ unsigned marked_at(const unsigned *marked, int r0)
{
    const int pos = r0 + MOFF;
    return __funnelshift_r(marked[pos >> 5], marked[(pos >> 5) + 1], pos & 31);
}

__device__ __forceinline__ bool marked_bit(const unsigned *marked, int j)
{
    const int pos = j + MOFF;
    return (marked[pos >> 5] >> (pos & 31)) & 1u;
}

struct Step {                    // what warp 0 reads for one anchor
    int xh, tp, qp, sp;          // the anchor's row
    int v, vj, flags;            // part A's results
    int sc0, sc1, ok;            // rows fb + lane, fb + lane + 32
    unsigned valid;              // lane l < TW: valid word l
    int pmf, pml;                // bounds of the walk's first block
};

struct Tables {                  // one set of per-group tables
    unsigned *valid;             // [G][TW] valid top rows
    int *sc;                     // [G][NU] sc of rows [fb, i)
    int *pre;                    // [NPRE][G]
    unsigned char *ok;           // [G][NU] validity of rows [fb, i)
};

__global__ void __launch_bounds__(THREADS)
chunked_kernel(const int32_t *__restrict__ xh, const int32_t *__restrict__ tp,
               const int32_t *__restrict__ qp, const int32_t *__restrict__ sp,
               const int32_t *__restrict__ n_a, int A, int W, int T, int mdx,
               int mdy, int bw, int max_skip, float pen_gap, float pen_skip,
               int32_t *f, int32_t *p, int32_t *unc_out)
{
    extern __shared__ __align__(16) int sm[];
    const int CAP = ring_rows(W, T), mask = CAP - 1;
    int *bxh = sm, *btp = bxh + CAP, *bqp = btp + CAP, *bsp = bqp + CAP,
        *bf = bsp + CAP;
    int *const pmx = bf + CAP;
    int *const txh = pmx + NPM;
    unsigned *marked = (unsigned *)(txh + 4);
    int *const tab0 = (int *)(marked + marked_words(A));
    unsigned char *const ok0 = (unsigned char *)(tab0 + 2 * SET_WORDS);
    auto tables = [&](int s) {
        int *at = tab0 + s * SET_WORDS;
        return Tables{(unsigned *)at, at + G * TW, at + G * TW + G * NU,
                      ok0 + s * G * NU};
    };

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t base = (int64_t)blockIdx.x * A;
    const int32_t *rxh = xh + base, *rtp = tp + base, *rqp = qp + base,
                  *rsp = sp + base;
    int32_t *rf = f + base, *rp = p + base;
    const int n = min(max(n_a[blockIdx.x], 0), A);
    for (int r = n + tid; r < A; r += THREADS) { rf[r] = 0; rp[r] = -1; }
    for (int w = tid; w < marked_words(A); w += THREADS) marked[w] = 0;
    __syncthreads();

    const int GT = min(G, T), NB = W / BLK;
    const unsigned umdx = (unsigned)mdx;
    // the group of part A (a_*) and of pass (b) (b_*) in this phase
    int a_i0 = 0, a_g0 = 0, a_fb = 0;
    bool have_b = false;
    int b_i0 = 0, b_g0 = 0, b_fb = 0;
    bool uncertain = false;      // kept by warp 0
    for (int ph = 0;; ++ph) {
        const bool have_a = a_g0 < n;
        if (!have_a && !have_b) break;
        if (warp == 0 && have_b) {
            // ---- (b) sequential pass over group b, warp 0
            const Tables tb = tables((ph - 1) & 1);
            const int i0 = b_i0, g0 = b_g0, fb = b_fb;
            const int gn = min(min(GT, i0 + T - g0), n - g0);
            const int par = (i0 / T) & 1;
            const int *pmf = pmx + 64 * par, *pml = pmf + 32;
            const int xh_first = txh[2 * par], xh_last = txh[2 * par + 1];
            // lane l <= TW: marked bits of rows [mlo + 32 l, mlo + 32 l + 32)
            // (mk0) and the next 32 (mk1), kept here while the group is
            // chained and ORed into the shared mask before a walk and at
            // the group's end
            const int mlo = g0 - TOP;
            unsigned mk0 = marked_at(marked, mlo + 32 * min(lane, TW));
            unsigned mk1 = marked_at(marked, mlo + 32 * min(lane + 1, TW));
            auto flush_marks = [&]() {
                if (lane <= TW) {
                    const int pos = mlo + 32 * lane + MOFF;
                    atomicOr(&marked[pos >> 5], mk0 << (pos & 31));
                    if (pos & 31)
                        atomicOr(&marked[(pos >> 5) + 1],
                                 mk0 >> (32 - (pos & 31)));
                }
            };
            auto mark = [&](int pj) {
                if (pj < 0) return;
                const int rel = pj - mlo;
                if (rel >= 0) {
                    const unsigned bit = 1u << (rel & 31);
                    if ((rel >> 5) == lane) mk0 |= bit;
                    if ((rel >> 5) == lane + 1) mk1 |= bit;
                } else if (lane == 0) {  // a walked row below the window
                    atomicOr(&marked[(pj + MOFF) >> 5],
                             1u << ((pj + MOFF) & 31));
                }
            };
            // lane l: f of rows fb + l and fb + l + 32; rows [fb, g0) are
            // final, the group's own rows are set as they are chained
            int fr0 = lane < g0 - fb ? bf[(fb + lane + W) & mask] : 0;
            int fr1 = 0;
            // what step t reads and no step writes, loaded a step ahead
            auto load = [&](int t) {
                const int i = g0 + t, si = (i + W) & mask;
                Step s;
                s.xh = bxh[si]; s.tp = btp[si]; s.qp = bqp[si];
                s.sp = bsp[si];
                s.v = tb.pre[t]; s.vj = tb.pre[G + t];
                s.flags = tb.pre[2 * G + t];
                s.sc0 = tb.sc[t * NU + lane];
                s.sc1 = tb.sc[t * NU + lane + 32];
                s.ok = tb.ok[t * NU + lane] | tb.ok[t * NU + lane + 32] << 1;
                s.valid = tb.valid[t * TW + min(lane, TW - 1)];
                // the bounds of the walk's first block
                const int bk = max(W - TOP + (i - i0) - 1, 0) / BLK;
                s.pmf = pmf[bk];
                s.pml = pml[bk];
                return s;
            };
            // the rest of a step that f does not wait for: the skip count
            // above its row, the flag, p and the mark.  It runs during the
            // next step, while that step's reductions are in flight.
            auto settle = [&](int t, int idx, bool best, unsigned valid) {
                const int i = g0 + t;
                int acc = 0;
                if (lane < TW)
                    acc = __popc(valid & __funnelshift_r(mk0, mk1, t)
                                 & above(idx - (i - TOP + 32 * lane)));
                acc = __reduce_add_sync(FULL, acc);
                uncertain = uncertain || (best && acc > max_skip);
                const int pj = best ? idx : -1;
                if (lane == 0) rp[i] = pj;
                mark(pj);
            };
            bool pend = false;           // a step waiting to be settled
            int pend_t = 0, pend_j = 0;
            bool pend_best = false;
            unsigned pend_valid = 0;
            Step cur = load(0);
            for (int t = 0; t < gn; ++t) {
                const Step nx = load(min(t + 1, gn - 1));
                const int i = g0 + t, si = (i + W) & mask, ui = i - fb;
                const int xh_i = cur.xh, tp_i = cur.tp, qp_i = cur.qp,
                          sp_i = cur.sp;
                // the rows [fb, i): (INT_MIN, INT_MIN) leaves the max as it
                // is, a refused row counts as (NEG_BIG, INT_MIN)
                int v = cur.v, vj = cur.vj;
                {
                    const bool in = lane < ui, ok = in && (cur.ok & 1);
                    lex_max(v, vj, ok ? wrap_add(cur.sc0, fr0)
                                      : (in ? NEG_BIG : INT_MIN32),
                            ok ? fb + lane : INT_MIN32);
                }
                {
                    const bool in = lane + 32 < ui, ok = in && (cur.ok & 2);
                    lex_max(v, vj, ok ? wrap_add(cur.sc1, fr1)
                                      : (in ? NEG_BIG : INT_MIN32),
                            ok ? fb + lane + 32 : INT_MIN32);
                }
                int M = __reduce_max_sync(FULL, v);
                const int J = __reduce_max_sync(FULL, v == M ? vj : INT_MIN32);
                int idx = J == INT_MIN32 ? -1 : J;
                const int pm = xh_i == xh_first ? cur.pmf
                             : (xh_i == xh_last ? cur.pml : 0x3FFFFFFF);

                // ---- deep walk over BLK-row blocks below the top chunk;
                // it goes on only if the chunk's deepest row is still a
                // candidate (same-vertex rows are contiguous)
                const int rows_below = W - TOP + (i - i0);
                if ((cur.flags & 1) && rows_below > 0
                    && wrap_add(pm, 31) > M) {
                    if (pend) settle(pend_t, pend_j, pend_best, pend_valid);
                    pend = false;
                    flush_marks();
                    __syncwarp();      // the marks, for every lane
                    // valid & marked rows of the top chunk: all, above idx
                    int acc = 0;
                    if (lane < TW) {
                        const unsigned vm = cur.valid
                            & __funnelshift_r(mk0, mk1, t);
                        acc = __popc(vm & above(idx - (i - TOP + 32 * lane)))
                            + (__popc(vm) << 16);
                    }
                    acc = __reduce_add_sync(FULL, acc);
                    int cnt_above = acc & 0xFFFF, cnt_seen = acc >> 16;
                    const bool vm1 = xh_i == xh_first, vm2 = xh_i == xh_last;
                    const int jcap = i - TOP;
                    for (int bk = (rows_below - 1) / BLK; bk >= 0; --bk) {
                        const int pb = vm1 ? pmf[bk]
                                           : (vm2 ? pml[bk] : 0x3FFFFFFF);
                        if (!(wrap_add(pb, 31) > M)) break;
                        const int jb = i0 - W + BLK * bk;
                        int mb = INT_MIN32, ib = INT_MIN32, ab = 0, sb = 0;
                        bool cand_b = false;
#pragma unroll
                        for (int kk = 0; kk < BLK / 32; ++kk) {
                            const int j = jb + lane + 32 * kk;
                            const int s = (j + W) & mask;
                            bool cand = false, ok = false;
                            int st = NEG_BIG;
                            if (j >= 0 && j < jcap && bxh[s] == xh_i
                                && (unsigned)wrap_sub(tp_i, btp[s]) <= umdx) {
                                cand = true;
                                const int sc = sc_valid(
                                    tp_i, qp_i, btp[s], bqp[s], bsp[s], mdx,
                                    mdy, bw, pen_gap, pen_skip, &ok);
                                if (ok) st = wrap_add(sc, bf[s]);
                            }
                            lex_max(mb, ib, st, ok ? j : INT_MIN32);
                            if (ok && marked_bit(marked, j)) sb |= 1 << kk;
                            if (kk == 0) cand_b = cand;
                        }
                        warp_lexmax(mb, ib);
                        if (ib == INT_MIN32) ib = -1;
#pragma unroll
                        for (int kk = 0; kk < BLK / 32; ++kk)
                            ab += ((sb >> kk) & 1) && jb + lane + 32 * kk > ib;
                        const int c2 = __reduce_add_sync(
                            FULL, ab + (__popc(sb) << 16));
                        if (mb > M) {
                            M = mb;
                            idx = ib;
                            cnt_above = cnt_seen + (c2 & 0xFFFF);
                        }
                        cnt_seen += c2 >> 16;
                        if (!__shfl_sync(FULL, (int)cand_b, 0)) break;
                    }
                    const bool best = M > sp_i;
                    const int f_i = best ? M : sp_i;
                    const int p_i = best ? idx : -1;
                    uncertain = uncertain || (best && cnt_above > max_skip)
                        || (cur.flags & 2);
                    if (lane == 0) {
                        bf[si] = f_i;
                        rf[i] = f_i;
                        rp[i] = p_i;
                    }
                    if (ui == lane) fr0 = f_i;
                    if (ui == lane + 32) fr1 = f_i;
                    mark(p_i);
                } else {
                    const bool best = M > sp_i;
                    const int f_i = best ? M : sp_i;
                    uncertain = uncertain || (cur.flags & 2);
                    if (lane == 0) {
                        bf[si] = f_i;
                        rf[i] = f_i;
                    }
                    if (ui == lane) fr0 = f_i;
                    if (ui == lane + 32) fr1 = f_i;
                    if (pend) settle(pend_t, pend_j, pend_best, pend_valid);
                    pend = true;
                    pend_t = t; pend_j = idx; pend_best = best;
                    pend_valid = cur.valid;
                }
                cur = nx;
            }
            if (pend) settle(pend_t, pend_j, pend_best, pend_valid);
            flush_marks();
        } else if ((warp & 3) && have_a) {
            // ---- (a) part A of group a, twelve warps
            const int aw = (warp >> 2) * 3 + (warp & 3) - 1;
            const Tables ta = tables(ph & 1);
            const int i0 = a_i0, g0 = a_g0, fb = a_fb;
            const int gn = min(min(GT, i0 + T - g0), n - g0);
            const int par = (i0 / T) & 1;
            int *const pmf = pmx + 64 * par, *const pml = pmf + 32;
            if (g0 == i0) {
                // a new tile: its rows enter the ring (the rows of the
                // group in pass (b) sit CAP - W - 2T rows or more away)
                const int i1 = min(i0 + T, n);
                for (int j = i0 + aw * 32 + lane; j < i1; j += A_THREADS) {
                    const int s = (j + W) & mask;
                    bxh[s] = rxh[j]; btp[s] = rtp[j]; bqp[s] = rqp[j];
                    bsp[s] = rsp[j];
                }
                if (aw == 0 && lane == 0) {
                    txh[2 * par] = rxh[i0];
                    txh[2 * par + 1] = rxh[i0 + T - 1];
                }
                asm volatile("bar.sync 1, %0;" :: "r"(A_THREADS));
                // block maxima of blocks 0 .. NB - 2: rows below i0 - 64
                const int xf = txh[2 * par], xl = txh[2 * par + 1];
                for (int bk = aw; bk < NB - 1; bk += A_WARPS) {
                    int m1 = NEG_BIG, m2 = NEG_BIG;
#pragma unroll
                    for (int kk = 0; kk < BLK / 32; ++kk) {
                        const int j = i0 - W + BLK * bk + lane + 32 * kk;
                        if (j >= 0) {
                            const int s = (j + W) & mask;
                            if (bxh[s] == xf) m1 = max(m1, bf[s]);
                            if (bxh[s] == xl) m2 = max(m2, bf[s]);
                        }
                    }
                    m1 = __reduce_max_sync(FULL, m1);
                    m2 = __reduce_max_sync(FULL, m2);
                    if (lane == 0) { pmf[bk] = m1; pml[bk] = m2; }
                }
                asm volatile("bar.sync 1, %0;" :: "r"(A_THREADS));
                if (aw == 0) {          // prefix max over the blocks
                    int m1 = lane < NB - 1 ? pmf[lane] : NEG_BIG;
                    int m2 = lane < NB - 1 ? pml[lane] : NEG_BIG;
                    for (int o = 1; o < 32; o <<= 1) {
                        const int u1 = __shfl_up_sync(FULL, m1, o);
                        const int u2 = __shfl_up_sync(FULL, m2, o);
                        if (lane >= o) { m1 = max(m1, u1); m2 = max(m2, u2); }
                    }
                    if (lane < NB - 1) { pmf[lane] = m1; pml[lane] = m2; }
                }
            } else if (g0 == i0 + GT && aw == A_WARPS - 1) {
                // the tile's top block [i0 - 64, i0): final below fb = i0
                const int xf = txh[2 * par], xl = txh[2 * par + 1];
                int m1 = NEG_BIG, m2 = NEG_BIG;
#pragma unroll
                for (int kk = 0; kk < BLK / 32; ++kk) {
                    const int j = i0 - BLK + lane + 32 * kk;
                    if (j >= 0) {
                        const int s = (j + W) & mask;
                        if (bxh[s] == xf) m1 = max(m1, bf[s]);
                        if (bxh[s] == xl) m2 = max(m2, bf[s]);
                    }
                }
                m1 = __reduce_max_sync(FULL, m1);
                m2 = __reduce_max_sync(FULL, m2);
                if (lane == 0) {
                    pmf[NB - 1] = max(pmf[NB - 2], m1);
                    pml[NB - 1] = max(pml[NB - 2], m2);
                }
            }
            for (int t = aw; t < gn; t += A_WARPS) {
                const int i = g0 + t, si = (i + W) & mask;
                const int xh_i = bxh[si], tp_i = btp[si], qp_i = bqp[si];
                int v = INT_MIN32, vj = INT_MIN32;   // top rows below fb
                int cand_lo = 0;
#pragma unroll
                for (int w = 0; w < TW; ++w) {
                    const int j = i - TOP + 32 * w + lane;
                    const int s = (j + W) & mask;
                    bool cand = false, ok = false;
                    int sc = NEG_BIG;
                    if (j >= 0 && bxh[s] == xh_i
                        && (unsigned)wrap_sub(tp_i, btp[s]) <= umdx) {
                        cand = true;
                        sc = sc_valid(tp_i, qp_i, btp[s], bqp[s], bsp[s], mdx,
                                      mdy, bw, pen_gap, pen_skip, &ok);
                    }
                    if (j < fb) {
                        lex_max(v, vj, ok ? wrap_add(sc, bf[s]) : NEG_BIG,
                                ok ? j : INT_MIN32);
                    } else {           // rows [fb, i) of pass (b)
                        ta.ok[t * NU + (j - fb)] = ok;
                        ta.sc[t * NU + (j - fb)] = sc;
                    }
                    const unsigned vb = __ballot_sync(FULL, ok);
                    if (lane == 0) ta.valid[t * TW + w] = vb;
                    if (w == 0) cand_lo = __shfl_sync(FULL, (int)cand, 0);
                }
                warp_lexmax(v, vj);
                // the window reaches below buffer row 0 (row i0 - W): flag
                const int r0 = i0 - W, s0 = (r0 + W) & mask;
                const bool ovf = r0 >= 0 && bxh[s0] == xh_i
                    && (unsigned)wrap_sub(tp_i, btp[s0]) <= umdx;
                if (lane == 0) {
                    ta.pre[t] = v;
                    ta.pre[G + t] = vj;
                    ta.pre[2 * G + t] = cand_lo | (int)ovf << 1;
                }
            }
        }
        __syncthreads();
        // the next phase: pass (b) takes group a, part A the one after
        have_b = have_a;
        if (have_a) {
            b_i0 = a_i0; b_g0 = a_g0; b_fb = a_fb;
            a_fb = a_g0;
            a_g0 += GT;
            if (a_g0 >= min(a_i0 + T, n)) { a_i0 += T; a_g0 = a_i0; }
        }
    }
    if (tid == 0) unc_out[blockIdx.x] = uncertain ? 1 : 0;
}

}  // namespace

extern "C" int mgt_cuda_chain_chunked(
    const int32_t *xh, const int32_t *tp, const int32_t *qp,
    const int32_t *sp, const int32_t *n_a, int B, int A, int W, int T,
    int mdx, int mdy, int bw, int max_skip, float pen_gap, float pen_skip,
    int32_t *f, int32_t *p, int32_t *unc, cudaStream_t stream)
{
    if (B < 0 || A < 0 || T < 1 || T > TOP || W < TOP || W % BLK
        || W > MAX_WINDOW || A % T)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    const int64_t smem = smem_bytes(W, T, A);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    chunked_kernel<<<(unsigned)B, THREADS, (size_t)smem, stream>>>(
        xh, tp, qp, sp, n_a, A, W, T, mdx, mdy, bw, max_skip, pen_gap,
        pen_skip, f, p, unc);
    return (int)cudaGetLastError();
}
