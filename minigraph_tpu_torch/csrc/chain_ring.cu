// Ring-buffer linear-chaining DP of the batched map step (comput_sc,
// lchain.c:114-139).
//
// Replaces the Pallas kernel minigraph_tpu/ops/chain_pallas.py
// _make_kernel (called through chain_planes_traced) and is held bitwise
// against the plain PyTorch version ops/chain.py lchain_dp_tiled_ref (a
// port of ops/chain_jax.py lchain_dp_tiled).
//
// What bounds it on an H100: latency, not a peak.  Anchor i of a read
// needs the f values of the W anchors before it, so a read is a chain
// of n_a dependent steps; the batch's time is its longest read's steps
// times the latency of one step.
//
// Design: the transition scores do not depend on f, so they leave the
// sequential step (the split of chain_exact.cu).  One block a read:
// warp 0 chains, the other warps are part A.  Part A scores anchor
// group k + 1 (G anchors) while warp 0 chains group k: for anchor i and
// each anchor j of its window [i - W, i) it writes comput_sc(i, j), or
// REFUSED for a refused pair, a key mismatch or j < 0, into a
// double-buffered shared table at column j mod W, the ring slot that
// holds j.  Warp 0 keeps the ring's f values in registers (lane l owns
// slots l, l + 32, ...: SPL = ceil(W / 32) of them, a template
// parameter, so no index is dynamic) and its step is only what f
// needs: a shared load and an add a slot (a select keeps a refused or
// empty slot at NEG_BIG, so it never wins and never overflows), one
// __reduce_max_sync for best = max(sc + f), f_i = max(best, span_i) and
// the owner lane's slot update.  The predecessor (the smallest anchor
// index among equal maxima) is one __reduce_min_sync that nothing on
// the f chain waits for.  comput_sc is shared with the other chain
// kernels (chain_sc.cuh).
#include "chain_sc.cuh"

namespace {

constexpr int MAX_SPL = 8;          // window <= 256
constexpr int NT = 128;             // warp 0 chains, warps 1-3 are part A
constexpr int REFUSED = INT_MIN32;
constexpr int NO_J = 0x7FFFFFFF;

// part A of anchor group g: every (anchor, window row) pair into table
// buffer g & 1; threads th, th + nth, ... of the block take part
template <int G, int WP>
__device__ __forceinline__ void score_group(
    int g, int th, int nth, int n, int W, const int32_t *__restrict__ xh,
    const int32_t *__restrict__ tp, const int32_t *__restrict__ qp,
    const int32_t *__restrict__ sp, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, int (*tab)[G][WP], int (*spv)[G])
{
    const int buf = g & 1, i0 = g * G;
    const int rows = min(G, n - i0);
    for (int it = th; it < rows * W; it += nth) {
        const int t = it / W, c = it - t * W;
        const int i = i0 + t, j = i - W + c;
        int v = REFUSED;
        if (j >= 0 && __ldg(xh + j) == __ldg(xh + i)) {
            bool ok;
            const int sc = sc_valid(__ldg(tp + i), __ldg(qp + i),
                                    __ldg(tp + j), __ldg(qp + j),
                                    __ldg(sp + j), mdx, mdy, bw, pen_gap,
                                    pen_skip, &ok);
            if (ok) v = sc;
        }
        tab[buf][t][(i + c) % W] = v;       // (i + c) % W == j mod W
        if (c == 0) spv[buf][t] = __ldg(sp + i);
    }
}

template <int SPL>
__global__ void __launch_bounds__(NT)
chain_ring_kernel(const int32_t *__restrict__ xh,
                  const int32_t *__restrict__ tp,
                  const int32_t *__restrict__ qp,
                  const int32_t *__restrict__ sp,
                  const int32_t *__restrict__ n_a, int A, int W, int mdx,
                  int mdy, int bw, float pen_gap, float pen_skip,
                  int32_t *__restrict__ f, int32_t *__restrict__ p)
{
    constexpr int WP = 32 * SPL;
    constexpr int G = SPL <= 2 ? 32 : 64 / SPL;   // 8-16 KB of table
    __shared__ int tab[2][G][WP];
    __shared__ int spv[2][G];
    const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
    const int64_t base = (int64_t)b * A;
    const int32_t *rxh = xh + base, *rtp = tp + base, *rqp = qp + base,
                  *rsp = sp + base;
    int32_t *rf = f + base, *rp = p + base;
    const int n = min(max(n_a[b], 0), A);
    for (int r = n + tid; r < A; r += NT) { rf[r] = NEG_BIG; rp[r] = -1; }
    const int n_groups = (n + G - 1) / G;
    if (n_groups == 0) return;

    score_group<G, WP>(0, tid, NT, n, W, rxh, rtp, rqp, rsp, mdx, mdy, bw,
                       pen_gap, pen_skip, tab, spv);
    __syncthreads();
    // warp 0's ring: f and the anchor index of slot lane + 32 s
    int wf[SPL], wai[SPL];
    bool live[SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
        wf[s] = NEG_BIG;
        wai[s] = NO_J;
        live[s] = lane + 32 * s < W;
    }
    int slot = 0;                           // i mod W
    for (int g = 0; g < n_groups; ++g) {
        if (tid < 32) {
            const int buf = g & 1, i0 = g * G, i1 = min(i0 + G, n);
            for (int i = i0; i < i1; ++i) {
                const int t = i - i0;
                int v = NEG_BIG, vj = NO_J;
#pragma unroll
                for (int s = 0; s < SPL; ++s) {
                    const int sc = tab[buf][t][lane + 32 * s];
                    const int tot = live[s] && sc != REFUSED ? sc + wf[s]
                                                             : NEG_BIG;
                    // slots are scanned in no index order: ties go to
                    // the smaller anchor index
                    if (tot > v || (tot == v && wai[s] < vj)) {
                        v = tot;
                        vj = wai[s];
                    }
                }
                const int best = __reduce_max_sync(FULL, v);
                const int sp_i = spv[buf][t];
                const bool use = best > sp_i;
                const int f_i = use ? best : sp_i;
#pragma unroll
                for (int s = 0; s < SPL; ++s)
                    if (lane + 32 * s == slot) { wf[s] = f_i; wai[s] = i; }
                if (++slot == W) slot = 0;
                const int pj = __reduce_min_sync(FULL, v == best ? vj : NO_J);
                if (lane == 0) {
                    rf[i] = f_i;
                    rp[i] = use ? pj : -1;
                }
            }
        } else if (g + 1 < n_groups) {
            score_group<G, WP>(g + 1, tid - 32, NT - 32, n, W, rxh, rtp,
                               rqp, rsp, mdx, mdy, bw, pen_gap, pen_skip,
                               tab, spv);
        }
        __syncthreads();
    }
}

template <int SPL>
void launch(const int32_t *xh, const int32_t *tp, const int32_t *qp,
            const int32_t *sp, const int32_t *n_a, int B, int A, int W,
            int mdx, int mdy, int bw, float pen_gap, float pen_skip,
            int32_t *f, int32_t *p, cudaStream_t stream)
{
    chain_ring_kernel<SPL><<<(unsigned)B, NT, 0, stream>>>(
        xh, tp, qp, sp, n_a, A, W, mdx, mdy, bw, pen_gap, pen_skip, f, p);
}

}  // namespace

extern "C" int mgt_cuda_chain_ring(
    const int32_t *xh, const int32_t *tp, const int32_t *qp,
    const int32_t *sp, const int32_t *n_a, int B, int A, int W, int mdx,
    int mdy, int bw, float pen_gap, float pen_skip, int32_t *f, int32_t *p,
    cudaStream_t stream)
{
    if (B < 0 || A < 0 || W < 1 || W > 32 * MAX_SPL)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    const int spl = (W + 31) / 32;
    if (spl == 1)
        launch<1>(xh, tp, qp, sp, n_a, B, A, W, mdx, mdy, bw, pen_gap,
                  pen_skip, f, p, stream);
    else if (spl == 2)
        launch<2>(xh, tp, qp, sp, n_a, B, A, W, mdx, mdy, bw, pen_gap,
                  pen_skip, f, p, stream);
    else if (spl <= 4)
        launch<4>(xh, tp, qp, sp, n_a, B, A, W, mdx, mdy, bw, pen_gap,
                  pen_skip, f, p, stream);
    else
        launch<8>(xh, tp, qp, sp, n_a, B, A, W, mdx, mdy, bw, pen_gap,
                  pen_skip, f, p, stream);
    return (int)cudaGetLastError();
}
