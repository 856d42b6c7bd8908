// Exact-or-flag linear-chaining DP fill (mg_lchain_dp, lchain.c:165-207).
//
// Replaces the Pallas kernel minigraph_tpu/ops/chain_exact_pallas.py
// _make_kernel (called through chain_exact_pallas_traced) and is held
// bitwise against the plain PyTorch version ops/chain_exact.py
// lchain_dp_exact_win_ref (a port of ops/chain_exact.py
// lchain_dp_exact_win) at the same (window W, tile T).
//
// What bounds it on an H100: latency, not a peak.  Anchor i of a read
// depends on the f values of the anchors before it, so a read is a
// chain of n_a dependent steps, each scoring the W + (i mod T) candidate
// rows [(i/T)*T - W, i) (comput_sc: ~40 integer and float32 operations,
// one fast log2).  A batch holds only 128-256 reads, about one per SM,
// so the time is the longest read's n_a steps times the latency of one.
//
// Design: one block of 16 warps per read, and each step's work split by
// what depends on f.  Validity, comput_sc, the distance and window counts
// (st_dist, st_win), the window-overflow row and the valid mask depend
// only on the anchor planes, and f is final for every row below the
// anchor's group.  The anchors of each tile are taken in groups of at
// most G, and group k goes through two passes:
//  (a) part A, twelve warps, one warp per anchor: over the rows [lo, i)
//      it counts c_dist and c_win, tests the overflow row and writes the
//      valid rows as a bitmask (one ballot per 32 rows); over the rows
//      below the previous group's start fb it reduces the best
//      (sc + f, j) and the window (f, j) max; for the rows [fb, i) it
//      stores sc, its validity and the window/valid state.
//  (b) the sequential pass, warp 0: for each anchor it scores the rows
//      [fb, i) (at most 2G - 1, two a lane) from those tables and the f
//      values just written, and combines them with (a)'s maxima (these
//      rows have larger j, so the largest-j tie-break needs no special
//      case).
// Part A of group k needs f only below group k-1, so it runs while warp
// 0 runs pass (b) of group k-1: a block runs one phase per group, and
// each phase ends at one __syncthreads.  The three warps that share warp
// 0's scheduler (4, 8, 12) stay idle, so that warp 0, whose step is one
// chain of dependent latencies, is never kept waiting for an issue slot.
// The step itself is kept short: the (value, row) maxima are two
// redux.sync each; the current max_ii's score comes from the tables or
// is computed before them (a max_ii replaced at this step is the window
// max row, a valid row or a refused one, whose sc + f the best already
// covers: it cannot apply, so its score is never needed); each lane holds
// the marked bits of its two window words in registers, so the two skip
// counts (valid & marked rows above the chosen row, and above max_ii
// without the chosen row) are popcounts and one packed redux.sync.  Lane
// 0 writes f and p; the owner lane marks p's row.
//
// Shared memory: the read's rows (xh, tp, qp, sp, f: 20 bytes a row) in a
// ring of CAP >= W + 2T rows, so that the next tile's rows load during
// the last group of the current one; "marked" (the reference's cnt > 0)
// as a bitmask over the read's rows, offset by MOFF so that rows below 0
// index it too; the per-group tables twice (group k written, group k-1
// read).  No global memory is touched inside the sequential loop except
// the f and p outputs.  comput_sc is shared with the other chain kernels
// (chain_sc.cuh).
#include "chain_sc.cuh"

namespace {

constexpr int G = 32;            // anchors per group
constexpr int NU = 2 * G;        // table rows [fb, i) of an anchor: 2 a lane
constexpr int NWARPS = 16;
constexpr int THREADS = 32 * NWARPS;
constexpr int A_THREADS = 32 * 12;   // part A: the warps with warp % 4 != 0
constexpr int MAX_ROWS = 2048;   // W + T
constexpr int MOFF = MAX_ROWS;   // marked-bit offset, > W
// per-anchor results of part A: best, its row, f max, its row, counts,
// overflow
constexpr int NPRE = 6;

__host__ __device__ inline int ring_rows(int W, int T)
{
    int cap = 32;
    while (cap < W + 2 * T) cap <<= 1;
    return cap;
}

// the read's marked mask: rows [-MOFF, A + MAX_ROWS), so that a window
// word read at any group stays inside
__host__ __device__ inline int marked_words(int A)
{
    return (A + MOFF + MAX_ROWS + 63) >> 5;
}

__host__ __device__ inline int valid_words(int W, int T)
{
    return (W + T + 31) >> 5;
}

// in 4-byte words, then the state bytes: ring, marked mask, and for each
// of the two table sets the valid masks, scores, part A results
__host__ __device__ inline int64_t smem_bytes(int W, int T, int A)
{
    const int64_t set = (int64_t)G * valid_words(W, T) + G * NU + NPRE * G;
    return 4 * (5 * (int64_t)ring_rows(W, T) + marked_words(A) + 2 * set)
        + 2 * G * NU;
}

// the 32 marked bits of rows [r0, r0 + 32) (r0 >= -MOFF)
__device__ __forceinline__ unsigned marked_at(const unsigned *marked, int r0)
{
    const int pos = r0 + MOFF;
    return __funnelshift_r(marked[pos >> 5], marked[(pos >> 5) + 1], pos & 31);
}

struct Tables {                  // one set of per-group tables
    unsigned *valid;             // [G][NW] valid rows of [lo, i)
    int *sc;                     // [G][NU] sc of rows [fb, i)
    unsigned char *st;           // [G][NU] 1 window, 2 valid, 4 sc valid
    int *pre;                    // [NPRE][G]
};

__global__ void __launch_bounds__(THREADS)
chain_kernel(const int32_t *__restrict__ xh, const int32_t *__restrict__ tp,
             const int32_t *__restrict__ qp, const int32_t *__restrict__ sp,
             const int32_t *__restrict__ n_a, int A, int W, int T, int mdx,
             int mdy, int bw, int max_skip, int max_iter, float pen_gap,
             float pen_skip, int32_t *f, int32_t *p, int32_t *unc_out)
{
    extern __shared__ __align__(16) int sm[];
    const int CAP = ring_rows(W, T), mask = CAP - 1;
    const int NW = valid_words(W, T);
    // ring slot of row j >= -W: (j + W) & mask
    int *bxh = sm, *btp = bxh + CAP, *bqp = btp + CAP, *bsp = bqp + CAP,
        *bf = bsp + CAP;
    unsigned *marked = (unsigned *)(bf + CAP);
    int *const tab0 = (int *)(marked + marked_words(A));
    const int set_words = G * NW + G * NU + NPRE * G;
    unsigned char *const st0 = (unsigned char *)(tab0 + 2 * set_words);
    auto tables = [&](int s) {
        int *at = tab0 + s * set_words;
        return Tables{(unsigned *)at, at + G * NW, st0 + s * G * NU,
                      at + G * NW + G * NU};
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

    // the group of part A (a_*) and of pass (b) (b_*) in this phase
    const int GT = min(G, T);
    int a_i0 = 0, a_g0 = 0, a_fb = 0;
    bool have_b = false;
    int b_i0 = 0, b_g0 = 0, b_fb = 0;
    // per-read state, kept (uniform) by warp 0
    int max_ii = -1, f_mii = 0;
    bool uncertain = false;
    for (int ph = 0;; ++ph) {
        const bool have_a = a_g0 < n;
        if (!have_a && !have_b) break;
        if (warp == 0 && have_b) {
            // ---- (b) sequential pass over group b, warp 0
            const Tables tb = tables((ph - 1) & 1);
            const int lo = b_i0 - W, g0 = b_g0, fb = b_fb;
            const int gn = min(min(GT, b_i0 + T - g0), n - g0);
            const int off = g0 - fb;        // table row of the group start
            // lane l holds the marked bits of window words l and l + 32
            unsigned mk0 = marked_at(marked, lo + 32 * lane);
            unsigned mk1 = marked_at(marked, lo + 32 * (lane + 32));
            for (int t = 0; t < gn; ++t) {
                const int i = g0 + t, ri = i - lo, si = (i + W) & mask;
                const int tp_i = btp[si], qp_i = bqp[si], sp_i = bsp[si];
                int v = tb.pre[t], vj = tb.pre[G + t];
                int fm = tb.pre[2 * G + t], fj = tb.pre[3 * G + t];
                const int cnt = tb.pre[4 * G + t];
                const bool ovf = tb.pre[5 * G + t] != 0;
                const int c_dist = cnt & 0xFFFF, c_win = cnt >> 16;
                const int st_dist = i - c_dist, st_win = i - c_win;
                const unsigned w0 = tb.valid[t * NW + lane];
                const unsigned w1 = tb.valid[t * NW + min(lane + 32, NW - 1)];
                // max_ii long-range candidate (lchain.c:191-198); a stale
                // max_ii is replaced by the window max row, which cannot
                // apply (its sc + f is covered by the best)
                const bool stale = max_ii < 0 || max_ii < st_dist;
                const bool cand = !stale && max_ii >= lo;   // in the slice
                int tmp = NEG_BIG;
                const int um = max_ii - fb;
                if (cand && um < 0) {
                    // validity only: the candidate may sit below the
                    // max_iter clamp, which is the point of it
                    const int r = (max_ii + W) & mask;
                    bool ok;
                    const int sc = sc_valid(tp_i, qp_i, btp[r], bqp[r],
                                            bsp[r], mdx, mdy, bw, pen_gap,
                                            pen_skip, &ok);
                    if (ok) tmp = sc;
                }
                {
                    const int at = t * NU + max(um, 0);
                    const int s = tb.st[at], sc = tb.sc[at];
                    if (cand && um >= 0 && (s & 4)) tmp = sc;
                }
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                    // table rows: [max(fb, lo), i); part A writes no others
                    const int u = lane + 32 * k;
                    if (u < off + t && fb + u >= lo) {
                        const int s = tb.st[t * NU + u];
                        const int j = fb + u, fv = bf[(j + W) & mask];
                        const int sc = tb.sc[t * NU + u];
                        if (s & 1) lex_max(fm, fj, fv, j);
                        if (s & 2) lex_max(v, vj, wrap_add(sc, fv), j);
                    }
                }
                warp_lexmax(v, vj);
                warp_lexmax(fm, fj);
                const int M = v, idx = vj;
                const bool best = M > sp_i;
                const int max_f = best ? M : sp_i;
                const int max_j = best ? idx : -1;
                if (stale) {
                    max_ii = c_win > 0 ? fj : -1;
                    f_mii = c_win > 0 ? fm : 0;
                }
                const bool has_mii = max_ii >= 0;
                // valid & marked rows above idx (low half) and above
                // max_ii (high half); the argmax row is not a skip row
                // when it is taken
                const int dI = idx - lo, dM = max_ii - lo;
                const int nw = (ri + 31) >> 5;
                int acc = 0;
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                    const int w = lane + 32 * k;
                    const unsigned vm = (w < nw ? (k ? w1 : w0) : 0u)
                        & (k ? mk1 : mk0);
                    const unsigned taken = best && (dI >> 5) == w
                        ? 1u << (dI & 31) : 0u;
                    acc += __popc(vm & above(dI - 32 * w))
                        + (__popc(vm & ~taken & above(dM - 32 * w)) << 16);
                }
                acc = __reduce_add_sync(FULL, acc);
                const int cnt_above_idx = acc & 0xFFFF;
                const int cnt_above_mii = acc >> 16;
                bool step_unc = (best && cnt_above_idx > max_skip) || ovf;
                const bool cand_ok = has_mii && tmp > NEG_BIG;
                const int tsum = wrap_add(tmp, f_mii);
                const bool delta = cand_ok && max_f < tsum;
                const bool fire_sure = has_mii && max_ii < st_win - 1;
                const bool fire_maybe = has_mii && !fire_sure
                    && cnt_above_mii > max_skip;
                const bool apply = fire_sure && delta;
                step_unc = step_unc || (fire_maybe && delta);
                const int f_i = apply ? tsum : max_f;
                const int p_i = apply ? max_ii : max_j;
                if (max_ii < 0 || f_mii < f_i) { max_ii = i; f_mii = f_i; }
                uncertain = uncertain || step_unc;
                if (lane == 0) {
                    bf[si] = f_i;
                    rf[i] = f_i;
                    rp[i] = p_i;
                }
                if (p_i >= 0) {        // p_i >= lo: a window row
                    const int rel = p_i - lo;
                    const unsigned bit = 1u << (rel & 31);
                    if (((rel >> 5) & 31) == lane) {
                        if (rel >> 10) mk1 |= bit; else mk0 |= bit;
                    }
                    if (lane == 0)
                        marked[(p_i + MOFF) >> 5] |= 1u << ((p_i + MOFF) & 31);
                }
                __syncwarp();          // f_i visible to every lane
            }
        } else if ((warp & 3) && have_a) {
            // ---- (a) part A of group a, twelve warps
            const int aw = (warp >> 2) * 3 + (warp & 3) - 1;
            const Tables ta = tables(ph & 1);
            const int lo = a_i0 - W, g0 = a_g0, fb = a_fb;
            const int gn = min(min(GT, a_i0 + T - g0), n - g0);
            if (g0 == a_i0) {
                // a new tile: its rows enter the ring (the rows of the
                // group in pass (b) sit CAP - W - 2T rows or more away)
                const int i1 = min(a_i0 + T, n);
                for (int j = a_i0 + aw * 32 + lane; j < i1; j += A_THREADS) {
                    const int s = (j + W) & mask;
                    bxh[s] = rxh[j]; btp[s] = rtp[j]; bqp[s] = rqp[j];
                    bsp[s] = rsp[j];
                }
                asm volatile("bar.sync 1, %0;" :: "r"(A_THREADS));
            }
            for (int t = aw; t < gn; t += A_THREADS / 32) {
                const int i = g0 + t, ri = i - lo, si = (i + W) & mask;
                const int xh_i = bxh[si], tp_i = btp[si], qp_i = bqp[si];
                const long long xl_i = (long long)(unsigned)tp_i;
                int v = NEG_BIG, vj = -1;       // best sc + f, rows < fb
                int fm = NEG_BIG, fj = -1;      // window f max, rows < fb
                int cnt = 0;                    // c_dist | c_win << 16
                bool ovf = false;
                for (int w = 0; w < (ri + 31) >> 5; ++w) {
                    const int r = 32 * w + lane, j = lo + r;
                    const int s = (j + W) & mask;
                    bool win = false, ok = false;
                    int sc = NEG_BIG;
                    if (j >= 0 && j < i && bxh[s] == xh_i) {
                        const long long dx = xl_i
                            - (long long)(unsigned)btp[s];
                        if (dx >= 0 && dx <= mdx) {
                            cnt += 1;
                            ovf = ovf || r == 0;
                            if (j >= i - max_iter) {
                                cnt += 1 << 16;
                                win = true;
                                sc = sc_valid(tp_i, qp_i, btp[s], bqp[s],
                                              bsp[s], mdx, mdy, bw, pen_gap,
                                              pen_skip, &ok);
                                if (j < fb) {
                                    const int fv = bf[s];
                                    lex_max(fm, fj, fv, j);
                                    if (ok)
                                        lex_max(v, vj, wrap_add(sc, fv), j);
                                }
                            }
                        }
                    }
                    const unsigned vb = __ballot_sync(FULL, ok);
                    if (lane == 0) ta.valid[t * NW + w] = vb;
                    if (j >= fb && j >= 0 && j < i) {
                        // rows of pass (b): the score and its validity
                        // whatever the window says (max_ii's candidate)
                        bool ok0 = ok;
                        if (!win)
                            sc = sc_valid(tp_i, qp_i, btp[s], bqp[s], bsp[s],
                                          mdx, mdy, bw, pen_gap, pen_skip,
                                          &ok0);
                        ta.st[t * NU + (j - fb)] =
                            (unsigned char)(win | ok << 1 | ok0 << 2);
                        ta.sc[t * NU + (j - fb)] = sc;
                    }
                }
                warp_lexmax(v, vj);
                warp_lexmax(fm, fj);
                cnt = __reduce_add_sync(FULL, cnt);
                ovf = __any_sync(FULL, ovf);
                if (lane == 0) {
                    ta.pre[t] = v; ta.pre[G + t] = vj; ta.pre[2 * G + t] = fm;
                    ta.pre[3 * G + t] = fj; ta.pre[4 * G + t] = cnt;
                    ta.pre[5 * G + t] = ovf;
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

extern "C" int mgt_cuda_chain_exact(
    const int32_t *xh, const int32_t *tp, const int32_t *qp,
    const int32_t *sp, const int32_t *n_a, int B, int A, int W, int T,
    int mdx, int mdy, int bw, int max_skip, int max_iter, float pen_gap,
    float pen_skip, int32_t *f, int32_t *p, int32_t *unc,
    cudaStream_t stream)
{
    if (B < 0 || A < 0 || W < 0 || T < 1 || W + T > MAX_ROWS)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    const int64_t smem = smem_bytes(W, T, A);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    chain_kernel<<<(unsigned)B, THREADS, (size_t)smem, stream>>>(
        xh, tp, qp, sp, n_a, A, W, T, mdx, mdy, bw, max_skip, max_iter,
        pen_gap, pen_skip, f, p, unc);
    return (int)cudaGetLastError();
}
