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
// of n_a dependent steps of W transition scores each (~40 integer and
// float32 operations, one fast log2).  A 512-read batch is 512 warps,
// about one per scheduler of the card's 132 SMs, so the time is n_a
// steps times the latency of one step: the anchor's loads, the scores
// and a five-round shuffle reduction.
//
// Design: one warp per read, the TPU kernel's ring held in registers.
// Lane l owns ring slots l, l + 32, ... (SPL = ceil(W / 32) of them,
// a template parameter, so every slot index is static and nothing
// spills to local memory).  Each lane scores its slots, a shuffle
// reduction keeps the largest sc + f and, among equal values, the
// smallest anchor index, and the lane that owns slot i % W overwrites
// it with anchor i.  The loads of anchor i + 1 are issued before the
// scores of anchor i.  No grid step carries state: the anchor loop runs
// inside the warp.  comput_sc is shared with the other chain kernels
// (chain_sc.cuh).
#include "chain_sc.cuh"

namespace {

constexpr int MAX_SPL = 8;          // window <= 256

template <int SPL>
__global__ void chain_ring_kernel(const int32_t *__restrict__ xh,
                                  const int32_t *__restrict__ tp,
                                  const int32_t *__restrict__ qp,
                                  const int32_t *__restrict__ sp,
                                  const int32_t *__restrict__ n_a,
                                  int B, int A, int W, int mdx, int mdy,
                                  int bw, float pen_gap, float pen_skip,
                                  int32_t *__restrict__ f,
                                  int32_t *__restrict__ p)
{
    const int lane = threadIdx.x & 31;
    const int b = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x)
                        >> 5);
    if (b >= B) return;
    const int64_t base = (int64_t)b * A;
    const int32_t *rxh = xh + base, *rtp = tp + base, *rqp = qp + base,
                  *rsp = sp + base;
    int32_t *rf = f + base, *rp = p + base;
    const int n = min(max(n_a[b], 0), A);
    for (int r = n + lane; r < A; r += 32) { rf[r] = NEG_BIG; rp[r] = -1; }

    // the ring: slot lane + 32*s; ai < 0 marks a slot never written
    int wxh[SPL], wtp[SPL], wqp[SPL], wsp[SPL], wf[SPL], wai[SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
        wxh[s] = 0; wtp[s] = 0; wqp[s] = 0; wsp[s] = 0;
        wf[s] = NEG_BIG; wai[s] = -1;
    }
    int nxh = 0, ntp = 0, nqp = 0, nsp = 0;
    if (n > 0) { nxh = rxh[0]; ntp = rtp[0]; nqp = rqp[0]; nsp = rsp[0]; }
    for (int i = 0; i < n; ++i) {
        const int xh_i = nxh, tp_i = ntp, qp_i = nqp, sp_i = nsp;
        if (i + 1 < n) {
            nxh = rxh[i + 1]; ntp = rtp[i + 1]; nqp = rqp[i + 1];
            nsp = rsp[i + 1];
        }
        int v = NEG_BIG, vj = 0x7FFFFFFF;
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
            bool ok = false;
            int sc = 0;
            if (wai[s] >= 0 && wxh[s] == xh_i)
                sc = sc_valid(tp_i, qp_i, wtp[s], wqp[s], wsp[s], mdx, mdy,
                              bw, pen_gap, pen_skip, &ok);
            if (ok) {
                const int tot = sc + wf[s];
                if (tot > v || (tot == v && wai[s] < vj)) {
                    v = tot;
                    vj = wai[s];
                }
            }
        }
        for (int o = 16; o > 0; o >>= 1) {
            const int v2 = __shfl_xor_sync(FULL, v, o);
            const int j2 = __shfl_xor_sync(FULL, vj, o);
            if (v2 > v || (v2 == v && j2 < vj)) { v = v2; vj = j2; }
        }
        const bool use = v > sp_i;
        const int f_i = use ? v : sp_i;
        if (lane == 0) {
            rf[i] = f_i;
            rp[i] = use ? vj : -1;
        }
        const int slot = i % W;
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
            if (slot == lane + 32 * s) {
                wxh[s] = xh_i; wtp[s] = tp_i; wqp[s] = qp_i; wsp[s] = sp_i;
                wf[s] = f_i; wai[s] = i;
            }
        }
    }
}

template <int SPL>
void launch(const int32_t *xh, const int32_t *tp, const int32_t *qp,
            const int32_t *sp, const int32_t *n_a, int B, int A, int W,
            int mdx, int mdy, int bw, float pen_gap, float pen_skip,
            int32_t *f, int32_t *p, cudaStream_t stream)
{
    const int warps_per_block = 4;
    const unsigned grid = (unsigned)((B + warps_per_block - 1)
                                     / warps_per_block);
    chain_ring_kernel<SPL><<<grid, 32 * warps_per_block, 0, stream>>>(
        xh, tp, qp, sp, n_a, B, A, W, mdx, mdy, bw, pen_gap, pen_skip, f, p);
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
