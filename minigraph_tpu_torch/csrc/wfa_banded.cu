// Banded dual-affine gap alignment score (min-plus, miniwfa's penalty
// model: mismatch x, gap of length l min(o1 + l*e1, o2 + l*e2)).
//
// Replaces the Pallas kernel minigraph_tpu/ops/wfa_pallas.py
// _banded_kernel (called through banded_score_traced) and is held
// bitwise against the plain PyTorch version ops/wfa_banded.py
// banded_score_ref.
//
// What bounds it on an H100: latency, not a peak.  A pair is a chain of
// tl + ql + 1 dependent anti-diagonal steps of wa cells (~19 integer
// operations a cell); a few thousand pairs fill the card with warps,
// but each warp's steps wait on the previous step's shuffles.
//
// Design: one warp per pair, the band on the lanes.  Lane l owns the
// S = wa / 32 contiguous band slots l*S .. l*S + S - 1 (S a template
// parameter, so every plane stays in registers): H of the last two
// anti-diagonals and the four gap planes.  The TPU kernel's roll of a
// plane by +-1 slot with the wrapped slot re-masked becomes a shift
// inside the lane plus one __shfl_down_sync (shift +1, lane 31 takes
// INF) or __shfl_up_sync (shift -1, lane 0 takes INF) for the slot that
// crosses lanes; anti-diagonal k's parity P = k & 1 picks the shifts,
// so steps run in pairs with P static.  The substitution scores of the
// next pair of steps are loaded before the current pair is computed.
// A pair stops at its end anti-diagonal tl + ql, the only one at which
// the TPU kernel takes its min.  All arithmetic is exact int32: INF =
// 0x3F000000 plus at most a few penalties a step cannot overflow.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = 0x3F000000;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Pens {
    int x, o1e1, e1, o2e2, e2;
};

// substitution scores of anti-diagonal k for this lane's slots;
// cells outside the table get INF (they are masked anyway)
template <int S>
__device__ __forceinline__ void load_sub(const uint8_t *__restrict__ t,
                                         const uint8_t *__restrict__ q,
                                         int tl, int ql, int k, int a0,
                                         int half, int x, int (&sub)[S])
{
    const int m = k >> 1, P = k & 1;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int i = m + P - half + a0 + s, j = m + half - a0 - s;
        sub[s] = (i >= 0 && j >= 0 && i <= tl && j <= ql)
            ? (__ldg(t + i) == __ldg(q + j) ? 0 : x) : INF;
    }
}

// one anti-diagonal step of parity P
template <int S, int P>
__device__ __forceinline__ void step(int k, int a0, int half, int tl, int ql,
                                     int lane, const Pens &pn,
                                     const int (&sub)[S], int (&h1)[S],
                                     int (&h2)[S], int (&e1s)[S],
                                     int (&f1s)[S], int (&e2s)[S],
                                     int (&f2s)[S], int &sc)
{
    // E source: slot a + P; F source: slot a + P - 1 (previous plane)
    int he[S], hf[S], ee1[S], ee2[S], ff1[S], ff2[S];
    if (P == 1) {
        int nh = __shfl_down_sync(FULL, h1[0], 1);
        int ne1 = __shfl_down_sync(FULL, e1s[0], 1);
        int ne2 = __shfl_down_sync(FULL, e2s[0], 1);
        if (lane == 31) nh = ne1 = ne2 = INF;
#pragma unroll
        for (int s = 0; s < S; ++s) {
            he[s] = s + 1 < S ? h1[s + 1] : nh;
            ee1[s] = s + 1 < S ? e1s[s + 1] : ne1;
            ee2[s] = s + 1 < S ? e2s[s + 1] : ne2;
            hf[s] = h1[s];
            ff1[s] = f1s[s];
            ff2[s] = f2s[s];
        }
    } else {
        int ph = __shfl_up_sync(FULL, h1[S - 1], 1);
        int pf1 = __shfl_up_sync(FULL, f1s[S - 1], 1);
        int pf2 = __shfl_up_sync(FULL, f2s[S - 1], 1);
        if (lane == 0) ph = pf1 = pf2 = INF;
#pragma unroll
        for (int s = 0; s < S; ++s) {
            he[s] = h1[s];
            ee1[s] = e1s[s];
            ee2[s] = e2s[s];
            hf[s] = s > 0 ? h1[s - 1] : ph;
            ff1[s] = s > 0 ? f1s[s - 1] : pf1;
            ff2[s] = s > 0 ? f2s[s - 1] : pf2;
        }
    }
    const int m = k >> 1;
    const bool at_end = k == tl + ql;
    const int a_end = (tl - ql + (32 * S - P)) >> 1;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int a = a0 + s;
        const int i = m + P - half + a, j = m + half - a;
        const bool valid = i >= 0 && j >= 0 && i <= tl && j <= ql;
        const int e1n = min(ee1[s] + pn.e1, he[s] + pn.o1e1);
        const int e2n = min(ee2[s] + pn.e2, he[s] + pn.o2e2);
        const int f1n = min(ff1[s] + pn.e1, hf[s] + pn.o1e1);
        const int f2n = min(ff2[s] + pn.e2, hf[s] + pn.o2e2);
        const int hn = min(min(min(e1n, f1n), min(e2n, f2n)),
                           h2[s] + sub[s]);
        h2[s] = h1[s];
        h1[s] = valid ? hn : INF;
        e1s[s] = valid ? e1n : INF;
        f1s[s] = valid ? f1n : INF;
        e2s[s] = valid ? e2n : INF;
        f2s[s] = valid ? f2n : INF;
        if (at_end && a == a_end) sc = min(sc, h1[s]);
    }
}

template <int S>
__global__ void banded_kernel(const uint8_t *__restrict__ tseq,
                              const uint8_t *__restrict__ qseq,
                              const int32_t *__restrict__ tl_,
                              const int32_t *__restrict__ ql_, int B, int L,
                              Pens pn, int32_t *__restrict__ out)
{
    const int lane = threadIdx.x & 31;
    const int b = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x)
                        >> 5);
    if (b >= B) return;
    const uint8_t *t = tseq + (int64_t)b * L, *q = qseq + (int64_t)b * L;
    const int tl = tl_[b], ql = ql_[b];
    const int half = 16 * S, a0 = lane * S;
    int h1[S], h2[S], e1s[S], f1s[S], e2s[S], f2s[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        h1[s] = e1s[s] = f1s[s] = e2s[s] = f2s[s] = INF;
        h2[s] = a0 + s == half ? 0 : INF;    // the virtual (-1, -1) = 0
    }
    int sc = INF;
    const int K = tl + ql;
    int s0[S], s1[S], n0[S] = {}, n1[S] = {};
    load_sub<S>(t, q, tl, ql, 0, a0, half, pn.x, s0);
    load_sub<S>(t, q, tl, ql, 1, a0, half, pn.x, s1);
    for (int k = 0; k <= K; k += 2) {
        if (k + 2 <= K) {
            load_sub<S>(t, q, tl, ql, k + 2, a0, half, pn.x, n0);
            load_sub<S>(t, q, tl, ql, k + 3, a0, half, pn.x, n1);
        }
        step<S, 0>(k, a0, half, tl, ql, lane, pn, s0, h1, h2, e1s, f1s, e2s,
                   f2s, sc);
        if (k + 1 <= K)
            step<S, 1>(k + 1, a0, half, tl, ql, lane, pn, s1, h1, h2, e1s,
                       f1s, e2s, f2s, sc);
#pragma unroll
        for (int s = 0; s < S; ++s) { s0[s] = n0[s]; s1[s] = n1[s]; }
    }
    for (int o = 16; o > 0; o >>= 1)
        sc = min(sc, __shfl_xor_sync(FULL, sc, o));
    if (lane == 0) out[b] = sc;
}

template <int S>
void launch(const uint8_t *tseq, const uint8_t *qseq, const int32_t *tl,
            const int32_t *ql, int B, int L, Pens pn, int32_t *out,
            cudaStream_t stream)
{
    const int warps_per_block = 4;
    const unsigned grid = (unsigned)((B + warps_per_block - 1)
                                     / warps_per_block);
    banded_kernel<S><<<grid, 32 * warps_per_block, 0, stream>>>(
        tseq, qseq, tl, ql, B, L, pn, out);
}

}  // namespace

extern "C" int mgt_cuda_wfa_banded(const uint8_t *tseq, const uint8_t *qseq,
                                   const int32_t *tl, const int32_t *ql,
                                   int B, int L, int wa, int x, int o1,
                                   int e1, int o2, int e2, int32_t *out,
                                   cudaStream_t stream)
{
    if (B < 0 || L < 1 || wa < 32 || wa > 128 || wa % 32)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    const Pens pn{x, o1 + e1, e1, o2 + e2, e2};
    switch (wa / 32) {
    case 1: launch<1>(tseq, qseq, tl, ql, B, L, pn, out, stream); break;
    case 2: launch<2>(tseq, qseq, tl, ql, B, L, pn, out, stream); break;
    case 3: launch<3>(tseq, qseq, tl, ql, B, L, pn, out, stream); break;
    default: launch<4>(tseq, qseq, tl, ql, B, L, pn, out, stream); break;
    }
    return (int)cudaGetLastError();
}
