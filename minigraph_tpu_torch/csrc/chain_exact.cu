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
// chain of n_a dependent steps, each scoring W + (i mod T) candidate
// rows (comput_sc: ~40 integer and float32 operations, one fast log2).
// A batch holds only 128-256 reads, far fewer warps than the card can
// keep in flight, so the time is n_a steps times the latency of one
// step: the candidate loads (L1/L2 hits) and the warp reductions.
//
// Design: one warp per read.  The lanes split the candidate rows
// [(i/T)*T - W, i) -- the XLA slice's W + t rows, so the sure flags
// equal the reference's at the same (W, T) -- and combine with
// shuffles: the max sc_tot with the largest-j tie-break, the max f over
// the window for the max_ii candidate, the counts that give st_dist and
// st_win, and the window-overflow test on the slice's lowest row.  Each
// lane keeps one bit per row it owns for "valid and marked", so the
// two skip counts (rows above the chosen predecessor, rows above
// max_ii) are popcounts once the reductions have fixed both rows.  The
// per-read state (max_ii, f_mii, uncertain) stays in registers; f, p
// and the child counts live in global memory (L1/L2 resident), made
// visible to the warp's other lanes by __syncwarp after lane 0 writes
// them.  comput_sc and the warp reductions are shared with the other
// chain kernels (chain_sc.cuh).
#include "chain_sc.cuh"

namespace {

// rows owned by this lane (lo + lane + 32*kk) that lie above row J
__device__ __forceinline__ int bits_above(unsigned long long vm, int J,
                                          int lo, int lane)
{
    const int d = J - lo - lane;
    const int kmin = d < 0 ? 0 : d / 32 + 1;
    return kmin >= 64 ? 0 : __popcll(vm >> kmin);
}

__global__ void chain_kernel(const int32_t *__restrict__ xh,
                             const int32_t *__restrict__ tp,
                             const int32_t *__restrict__ qp,
                             const int32_t *__restrict__ sp,
                             const int32_t *__restrict__ n_a,
                             int B, int A, int W, int T, int mdx, int mdy,
                             int bw, int max_skip, int max_iter,
                             float pen_gap, float pen_skip,
                             int32_t *f, int32_t *p, int32_t *cnt,
                             int32_t *unc_out)
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

    int max_ii = -1, f_mii = 0;
    bool uncertain = false;
    for (int i = 0; i < n; ++i) {
        const int lo = (i / T) * T - W;
        const int xh_i = rxh[i], tp_i = rtp[i], qp_i = rqp[i],
                  sp_i = rsp[i];
        const long long xl_i = (long long)(unsigned)tp_i;
        int c_dist = 0, c_win = 0;
        int v = NEG_BIG, vj = -1;       // max sc_tot over valid rows
        int fm = NEG_BIG, fj = -1;      // max f over window rows
        bool ovf = false;
        unsigned long long vm = 0;      // valid & marked, one bit per row
        for (int kk = 0;; ++kk) {
            const int j = lo + lane + 32 * kk;
            if (j >= i) break;
            if (j < 0) continue;
            if (rxh[j] != xh_i) continue;
            const long long dx = xl_i - (long long)(unsigned)rtp[j];
            if (dx < 0 || dx > mdx) continue;
            ++c_dist;
            if (j == lo) ovf = true;
            if (j < i - max_iter) continue;
            ++c_win;
            const int fj_val = rf[j];
            if (fj_val > fm || (fj_val == fm && j > fj)) { fm = fj_val; fj = j; }
            bool ok;
            const int sc = sc_valid(tp_i, qp_i, rtp[j], rqp[j], rsp[j], mdx,
                                    mdy, bw, pen_gap, pen_skip, &ok);
            if (!ok) continue;
            const int st = wrap_add(sc, fj_val);
            if (st > v || (st == v && j > vj)) { v = st; vj = j; }
            if (rc[j] > 0) vm |= 1ull << kk;
        }
        c_dist = warp_sum(c_dist);
        c_win = warp_sum(c_win);
        warp_argmax(v, vj);
        warp_argmax(fm, fj);
        ovf = __any_sync(FULL, ovf);
        const int M = v, idx = vj;
        const int st_dist = i - c_dist, st_win = i - c_win;
        const bool best = M > sp_i;
        const int cnt_above_idx = warp_sum(bits_above(vm, idx, lo, lane));
        const int max_f = best ? M : sp_i;
        const int max_j = best ? idx : -1;
        bool step_unc = (best && cnt_above_idx > max_skip) || ovf;

        // max_ii long-range candidate (lchain.c:191-198)
        if (max_ii < 0 || max_ii < st_dist) {
            max_ii = c_win > 0 ? fj : -1;
            f_mii = c_win > 0 ? fm : 0;
        }
        const bool has_mii = max_ii >= 0;
        int tmp = NEG_BIG;
        if (has_mii && max_ii >= lo) {
            // score validity only: the candidate may sit below the
            // max_iter clamp, which is the point of it
            bool ok;
            const int sc = sc_valid(tp_i, qp_i, rtp[max_ii], rqp[max_ii],
                                    rsp[max_ii], mdx, mdy, bw, pen_gap,
                                    pen_skip, &ok);
            if (ok) tmp = sc;
        }
        const bool cand_ok = has_mii && tmp > NEG_BIG;
        const int tsum = wrap_add(tmp, f_mii);
        const bool delta = cand_ok && max_f < tsum;
        const bool fire_sure = has_mii && max_ii < st_win - 1;
        int cnt_above_mii = 0;
        if (has_mii) {
            cnt_above_mii = warp_sum(bits_above(vm, max_ii, lo, lane));
            // the argmax row is not a skip row when it is taken
            if (best && idx > max_ii && rc[idx] > 0) --cnt_above_mii;
        }
        const bool fire_maybe = has_mii && !fire_sure
            && cnt_above_mii > max_skip;
        const bool apply = fire_sure && delta;
        step_unc = step_unc || (fire_maybe && delta);
        const int f_i = apply ? tsum : max_f;
        const int p_i = apply ? max_ii : max_j;
        if (max_ii < 0 || f_mii < f_i) { max_ii = i; f_mii = f_i; }
        uncertain = uncertain || step_unc;
        __syncwarp();          // every lane has read cnt[idx] above
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

extern "C" int mgt_cuda_chain_exact(
    const int32_t *xh, const int32_t *tp, const int32_t *qp,
    const int32_t *sp, const int32_t *n_a, int B, int A, int W, int T,
    int mdx, int mdy, int bw, int max_skip, int max_iter, float pen_gap,
    float pen_skip, int32_t *f, int32_t *p, int32_t *cnt, int32_t *unc,
    cudaStream_t stream)
{
    if (B < 0 || A < 0 || W < 0 || T < 1 || W + T > 2048)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    const int warps_per_block = 4;
    const unsigned grid = (unsigned)((B + warps_per_block - 1)
                                     / warps_per_block);
    chain_kernel<<<grid, 32 * warps_per_block, 0, stream>>>(
        xh, tp, qp, sp, n_a, B, A, W, T, mdx, mdy, bw, max_skip, max_iter,
        pen_gap, pen_skip, f, p, cnt, unc);
    return (int)cudaGetLastError();
}
