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
// n_a dependent anchor steps; a batch of 128-256 reads is one warp per
// read, far fewer than the card keeps in flight.  Each step is TOP rows
// of comput_sc (~40 operations each) plus ~2 blocks of BLK rows on real
// reads, four shuffle reductions for the top chunk and four per block.
//
// Design: one warp per read, as chain_exact.cu.  The TPU kernel's W + T
// row buffer is the read's own rows of the global planes: buffer row r
// of tile a is anchor a*T - W + r, and rows before the read's first
// anchor are virtual rows with the buffer's initial values (x-hi
// 0xFFFFFFFF, positions 0, f NEG_BIG, no children).  f, p and the child
// counts live in global memory (L1/L2 resident), written by lane 0 and
// made visible to the other lanes by __syncwarp.
//  - Top chunk, rows [i - TOP, i): four rows a lane.  A row's candidate
//    test is the TPU's: same x-hi and (tpos_i - tpos_j) mod 2^32 <= mdx.
//    The lexicographic (sc_tot, row) max runs with refused rows as
//    (NEG_BIG, INT_MIN), so the value is the max over all rows, refused
//    ones at NEG_BIG, and the row the largest valid row of that value,
//    exactly the TPU kernel's max and masked argmax.
//  - Block bound: the per-tile prefix maxima of f over the frozen rows
//    [0, W), masked to the vertices of the tile's first and last anchor,
//    change only at tile boundaries.  Lane l < W / BLK holds the value
//    of block l, computed once per tile and prefix-maxed by a shuffle
//    scan; the walk reads it with one shuffle.
//  - Walk: blocks from the one just below the top chunk downwards, two
//    rows a lane; it stops when the bound pm + 31 <= M, when the block's
//    deepest row is no candidate, or below row 0.  A block that beats M
//    strictly takes over M and the row, and the skip count becomes the
//    walked rows above it: every counted row of the top chunk and the
//    blocks before, plus the block's rows above its argmax.
#include "chain_sc.cuh"

namespace {

constexpr int TOP = 128;
constexpr int BLK = 64;
constexpr int INT_MIN32 = -0x7FFFFFFF - 1;

struct Row {
    int xh, tp, qp, sp, f, cnt;
};

// row j of the read's buffer; j < 0 is a virtual row before the read
__device__ __forceinline__ Row load_row(const int32_t *rxh,
                                        const int32_t *rtp,
                                        const int32_t *rqp,
                                        const int32_t *rsp,
                                        const int32_t *rf,
                                        const int32_t *rc, int j)
{
    if (j < 0) return Row{-1, 0, 0, 0, NEG_BIG, 0};
    return Row{rxh[j], rtp[j], rqp[j], rsp[j], rf[j], rc[j]};
}

__global__ void chunked_kernel(const int32_t *__restrict__ xh,
                               const int32_t *__restrict__ tp,
                               const int32_t *__restrict__ qp,
                               const int32_t *__restrict__ sp,
                               const int32_t *__restrict__ n_a,
                               int B, int A, int W, int T, int mdx, int mdy,
                               int bw, int max_skip, float pen_gap,
                               float pen_skip, int32_t *f, int32_t *p,
                               int32_t *cnt, int32_t *unc_out)
{
    const int lane = threadIdx.x & 31;
    const int b = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x)
                        >> 5);
    if (b >= B) return;
    const int64_t base = (int64_t)b * A;
    const int32_t *rxh = xh + base, *rtp = tp + base, *rqp = qp + base,
                  *rsp = sp + base;
    int32_t *rf = f + base, *rp = p + base, *rc = cnt + base;
    const int n = min(max(n_a[b], 0), A);
    for (int r = n + lane; r < A; r += 32) { rf[r] = 0; rp[r] = -1; }
    const int NB = W / BLK;
    const unsigned umdx = (unsigned)mdx;

    int pmf = NEG_BIG, pml = NEG_BIG;   // lane l: prefix max of block l
    int xh_first = 0, xh_last = 0;
    bool uncertain = false;
    for (int i = 0; i < n; ++i) {
        const int t = i % T, i0 = i - t;
        if (t == 0) {
            xh_first = rxh[i0];
            xh_last = rxh[i0 + T - 1];
            pmf = pml = NEG_BIG;
            if (lane < NB) {
                // virtual rows hold f = NEG_BIG: they never raise a max
                const int j0 = i0 - W + BLK * lane;
                for (int r = max(0, -j0); r < BLK; ++r) {
                    const int xj = rxh[j0 + r], fj = rf[j0 + r];
                    if (xj == xh_first) pmf = max(pmf, fj);
                    if (xj == xh_last) pml = max(pml, fj);
                }
            }
            for (int o = 1; o < 32; o <<= 1) {
                const int u1 = __shfl_up_sync(FULL, pmf, o);
                const int u2 = __shfl_up_sync(FULL, pml, o);
                if (lane >= o) { pmf = max(pmf, u1); pml = max(pml, u2); }
            }
        }
        const int xh_i = rxh[i], tp_i = rtp[i], qp_i = rqp[i],
                  sp_i = rsp[i];

        // the window reaches below buffer row 0: flag
        const Row r0 = load_row(rxh, rtp, rqp, rsp, rf, rc, i0 - W);
        const bool overflow = r0.xh == xh_i
            && (unsigned)wrap_sub(tp_i, r0.tp) <= umdx;

        // ---- top chunk: rows [i - TOP, i), four a lane
        int v = INT_MIN32, vj = INT_MIN32;
        unsigned sbits = 0;
        bool cand_lo = false;
#pragma unroll
        for (int kk = 0; kk < TOP / 32; ++kk) {
            const int j = i - TOP + lane + 32 * kk;
            const Row r = load_row(rxh, rtp, rqp, rsp, rf, rc, j);
            const bool cand = r.xh == xh_i
                && (unsigned)wrap_sub(tp_i, r.tp) <= umdx;
            bool ok;
            const int sc = sc_valid(tp_i, qp_i, r.tp, r.qp, r.sp, mdx, mdy,
                                    bw, pen_gap, pen_skip, &ok);
            const bool valid = cand && ok;
            const int st = valid ? wrap_add(sc, r.f) : NEG_BIG;
            const int sj = valid ? j : INT_MIN32;
            if (st > v || (st == v && sj > vj)) { v = st; vj = sj; }
            if (valid && r.cnt > 0) sbits |= 1u << kk;
            if (kk == 0) cand_lo = cand;
        }
        warp_argmax(v, vj);
        int M = v;
        int idx = vj == INT_MIN32 ? -1 : vj;
        int above = 0;
#pragma unroll
        for (int kk = 0; kk < TOP / 32; ++kk)
            above += ((sbits >> kk) & 1u) && i - TOP + lane + 32 * kk > idx;
        int cnt_above = warp_sum(above);
        int cnt_seen = warp_sum(__popc(sbits));
        // the window goes on below the chunk only if its deepest row is
        // still a candidate (same-vertex rows are contiguous)
        bool going = __shfl_sync(FULL, (int)cand_lo, 0) != 0;

        // ---- deep walk over BLK-row blocks below the top chunk
        const int rows_below = W - TOP + t;
        if (going && rows_below > 0) {
            const bool vm1 = xh_i == xh_first, vm2 = xh_i == xh_last;
            const int jcap = i - TOP;
            for (int bk = (rows_below - 1) / BLK; bk >= 0; --bk) {
                const int b1 = __shfl_sync(FULL, pmf, bk);
                const int b2 = __shfl_sync(FULL, pml, bk);
                const int pm = vm1 ? b1 : (vm2 ? b2 : 0x3FFFFFFF);
                if (!(pm + 31 > M)) break;
                const int jb = i0 - W + BLK * bk;
                int mb = INT_MIN32, ib = INT_MIN32;
                unsigned bbits = 0;
                bool cand_b = false;
#pragma unroll
                for (int kk = 0; kk < BLK / 32; ++kk) {
                    const int j = jb + lane + 32 * kk;
                    const Row r = load_row(rxh, rtp, rqp, rsp, rf, rc, j);
                    const bool cand = r.xh == xh_i
                        && (unsigned)wrap_sub(tp_i, r.tp) <= umdx
                        && j < jcap;
                    bool ok;
                    const int sc = sc_valid(tp_i, qp_i, r.tp, r.qp, r.sp,
                                            mdx, mdy, bw, pen_gap, pen_skip,
                                            &ok);
                    const bool valid = cand && ok;
                    const int st = valid ? wrap_add(sc, r.f) : NEG_BIG;
                    const int sj = valid ? j : INT_MIN32;
                    if (st > mb || (st == mb && sj > ib)) { mb = st; ib = sj; }
                    if (valid && r.cnt > 0) bbits |= 1u << kk;
                    if (kk == 0) cand_b = cand;
                }
                warp_argmax(mb, ib);
                if (ib == INT_MIN32) ib = -1;
                int ab = 0;
#pragma unroll
                for (int kk = 0; kk < BLK / 32; ++kk)
                    ab += ((bbits >> kk) & 1u) && jb + lane + 32 * kk > ib;
                ab = warp_sum(ab);
                const int sb = warp_sum(__popc(bbits));
                if (mb > M) {
                    M = mb;
                    idx = ib;
                    cnt_above = cnt_seen + ab;
                }
                cnt_seen += sb;
                if (!__shfl_sync(FULL, (int)cand_b, 0)) break;
            }
        }

        const bool best = M > sp_i;
        const int f_i = best ? M : sp_i;
        const int p_i = best ? idx : -1;
        uncertain = uncertain || (best && cnt_above > max_skip) || overflow;
        __syncwarp();          // every lane has read the rows above
        if (lane == 0) {
            rf[i] = f_i;
            rp[i] = p_i;
            if (p_i >= 0) rc[p_i] += 1;
        }
        __syncwarp();
    }
    if (lane == 0) unc_out[b] = uncertain ? 1 : 0;
}

}  // namespace

extern "C" int mgt_cuda_chain_chunked(
    const int32_t *xh, const int32_t *tp, const int32_t *qp,
    const int32_t *sp, const int32_t *n_a, int B, int A, int W, int T,
    int mdx, int mdy, int bw, int max_skip, float pen_gap, float pen_skip,
    int32_t *f, int32_t *p, int32_t *cnt, int32_t *unc, cudaStream_t stream)
{
    if (B < 0 || A < 0 || T < 1 || T > TOP || W < TOP || W % BLK
        || W > 32 * BLK || A % T)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    const int warps_per_block = 4;
    const unsigned grid = (unsigned)((B + warps_per_block - 1)
                                     / warps_per_block);
    chunked_kernel<<<grid, 32 * warps_per_block, 0, stream>>>(
        xh, tp, qp, sp, n_a, B, A, W, T, mdx, mdy, bw, max_skip, pen_gap,
        pen_skip, f, p, cnt, unc);
    return (int)cudaGetLastError();
}
