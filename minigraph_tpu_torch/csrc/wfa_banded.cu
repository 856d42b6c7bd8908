// Banded dual-affine gap alignment score (min-plus, miniwfa's penalty
// model: mismatch x, gap of length l min(o1 + l*e1, o2 + l*e2)).
//
// Replaces the Pallas kernel minigraph_tpu/ops/wfa_pallas.py
// _banded_kernel (called through banded_score_traced) and is held
// bitwise against the plain PyTorch version ops/wfa_banded.py
// banded_score_ref.
//
// What bounds it on an H100: integer issue.  A pair is a chain of
// tl + ql + 1 dependent anti-diagonal steps of wa cells; 4096 pairs of
// ~2300 steps are ~3e8 cell updates of ~13 integer instructions, and an
// SM issues 64 integer lanes a cycle (half its float32 rate), so the
// cost is what each cell issues and the steps a warp spends past its
// shorter pairs' ends.
//
// Design: G lanes a pair (32/G pairs a warp), each lane owning C = wa/G
// contiguous band slots a0 .. a0 + C - 1, a0 = C * (lane mod G), with
// H of the last two anti-diagonals and the four gap planes in
// registers.  The TPU kernel's roll of a plane by +-1 slot becomes a
// shift inside the lane plus one __shfl_{down,up}_sync of width G for
// the slot that crosses lanes (the group's last or first lane takes
// INF): three shuffles a step for C cells.  Anti-diagonal k = 2m + P
// keeps slot a at i = m + P - wa/2 + a, j = m + wa/2 - a, so a lane's
// cells read t'[m - wa/2 + a0 .. + C] and q'[m + wa/2 - a0 - C + 1 ..
// m + wa/2 - a0]: both windows live in registers and slide by one base
// each pair of steps (one byte load each).  No cell is masked, unlike
// the plain version's INF outside the table: a cell inside it reads
// only cells (i', j') with i' <= i and j' <= j, so never one past the
// table's end, and the cells before it (i < 0 or j < 0) read only each
// other and INF, so they stay at INF or above; every cell inside the
// table that lies in the band is reached from (0, 0) inside the band
// with a finite score, which no value at INF or above can beat.  So the
// end cell, the only one read out, is bitwise the plain version's.  A
// block of G warps takes 32 pairs and hands them to its lane groups in
// the order of their end anti-diagonal, so a warp's pairs are of
// near-equal length (a warp runs to its longest pair).
// The gap planes and H's five-way min use Hopper's DPX min-plus
// instructions (__viaddmin_s32, __vimin3_s32; plain min and add ran as
// fast, PERF.md), exact int32 like the rest: INF = 0x3F000000 plus a
// few penalties a step for the first wa steps (the only ones with cells
// before the table) cannot overflow.  A lane stops updating after its
// pair's end anti-diagonal tl + ql (the only one at which the TPU
// kernel takes its min) and reads the end slot afterwards.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = 0x3F000000;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int NP = 32;      // pairs a block: G warps

struct Pens {
    int x, o1e1, e1, o2e2, e2;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi)
{
    return min(max(v, lo), hi);
}

// one anti-diagonal step k = 2m + P for this lane's C slots.  P = 1:
// E from slot a + 1, F from slot a (cells updated in ascending order);
// P = 0: E from slot a, F from slot a - 1 (descending), so every read
// sees the previous plane.
template <int G, int C, int P>
__device__ __forceinline__ void step(int k, int K, int gl, const Pens &pn,
                                     const int (&tw)[C + 1],
                                     const int (&qr)[C],
                                     int (&h1)[C], int (&h2)[C],
                                     int (&e1s)[C], int (&f1s)[C],
                                     int (&e2s)[C], int (&f2s)[C])
{
    int xh, x1, x2;     // the slot shifted in from the neighbouring lane
    if (P == 1) {
        xh = __shfl_down_sync(FULL, h1[0], 1, G);
        x1 = __shfl_down_sync(FULL, e1s[0], 1, G);
        x2 = __shfl_down_sync(FULL, e2s[0], 1, G);
        if (gl == G - 1) xh = x1 = x2 = INF;
    } else {
        xh = __shfl_up_sync(FULL, h1[C - 1], 1, G);
        x1 = __shfl_up_sync(FULL, f1s[C - 1], 1, G);
        x2 = __shfl_up_sync(FULL, f2s[C - 1], 1, G);
        if (gl == 0) xh = x1 = x2 = INF;
    }
    if (k > K) return;
#pragma unroll
    for (int r = 0; r < C; ++r) {
        const int s = P == 1 ? r : C - 1 - r;
        int he, hf, ee1, ee2, ff1, ff2;
        if (P == 1) {
            he = s + 1 < C ? h1[s + 1] : xh;
            ee1 = s + 1 < C ? e1s[s + 1] : x1;
            ee2 = s + 1 < C ? e2s[s + 1] : x2;
            hf = h1[s];
            ff1 = f1s[s];
            ff2 = f2s[s];
        } else {
            he = h1[s];
            ee1 = e1s[s];
            ee2 = e2s[s];
            hf = s > 0 ? h1[s - 1] : xh;
            ff1 = s > 0 ? f1s[s - 1] : x1;
            ff2 = s > 0 ? f2s[s - 1] : x2;
        }
        const int e1n = __viaddmin_s32(ee1, pn.e1, he + pn.o1e1);
        const int e2n = __viaddmin_s32(ee2, pn.e2, he + pn.o2e2);
        const int f1n = __viaddmin_s32(ff1, pn.e1, hf + pn.o1e1);
        const int f2n = __viaddmin_s32(ff2, pn.e2, hf + pn.o2e2);
        const int sub = tw[s + P] != qr[s] ? pn.x : 0;
        const int hn = min(__vimin3_s32(e1n, f1n, e2n),
                           __viaddmin_s32(h2[s], sub, f2n));
        h2[s] = h1[s];
        h1[s] = hn;
        e1s[s] = e1n;
        f1s[s] = f1n;
        e2s[s] = e2n;
        f2s[s] = f2n;
    }
}

template <int G, int C>
__global__ void __launch_bounds__(32 * G)
banded_kernel(const uint8_t *__restrict__ tseq,
              const uint8_t *__restrict__ qseq,
              const int32_t *__restrict__ tl_, const int32_t *__restrict__ ql_,
              int B, int L, Pens pn, int32_t *__restrict__ out)
{
    constexpr int half = G * C / 2;
    const int gl = threadIdx.x % G, grp = threadIdx.x / G;
    // the block's NP pairs go to its lane groups in the order of their
    // end anti-diagonal, so each warp runs pairs of near-equal length
    __shared__ int kk[NP], order[NP];
    const int bo = blockIdx.x * NP + grp;
    const int ko = bo < B ? tl_[bo] + ql_[bo] : 0x7FFFFFFF;
    if (gl == 0) kk[grp] = ko;
    __syncthreads();
    int rank = 0;
    for (int g = 0; g < NP; ++g) {
        const int kg = kk[g];
        rank += kg < ko || (kg == ko && g < grp);
    }
    if (gl == 0) order[rank] = bo;
    __syncthreads();
    const int b = order[grp];
    const bool live = b < B;
    // every lane of a warp takes part in the shuffles: a lane past the
    // last pair reads pair B - 1 and never updates (K = -1)
    const int bb = live ? b : B - 1;
    const uint8_t *t = tseq + (int64_t)bb * L, *q = qseq + (int64_t)bb * L;
    const int tl = tl_[bb], ql = ql_[bb];
    const int K = live ? tl + ql : -1;
    const int Kw = __reduce_max_sync(FULL, K);
    const int a0 = gl * C;

    int h1[C], h2[C], e1s[C], f1s[C], e2s[C], f2s[C];
    int tw[C + 1], qr[C];
#pragma unroll
    for (int s = 0; s < C; ++s) {
        const int a = a0 + s;
        h1[s] = e1s[s] = f1s[s] = e2s[s] = f2s[s] = INF;
        h2[s] = a == half ? 0 : INF;    // the virtual (-1, -1) = 0
        qr[s] = __ldg(q + clampi(half - a, 0, L - 1));
    }
#pragma unroll
    for (int s = 0; s <= C; ++s)
        tw[s] = __ldg(t + clampi(a0 + s - half, 0, L - 1));

    for (int m = 0; 2 * m <= Kw; ++m) {
        // the windows' next bases (an index outside the table is clamped:
        // only cells outside it read that base)
        const int nt = __ldg(t + clampi(m + 1 - half + a0 + C, 0, L - 1));
        const int nq = __ldg(q + clampi(m + 1 + half - a0, 0, L - 1));
        step<G, C, 0>(2 * m, K, gl, pn, tw, qr, h1, h2, e1s, f1s, e2s, f2s);
        if (2 * m + 1 <= Kw)
            step<G, C, 1>(2 * m + 1, K, gl, pn, tw, qr, h1, h2, e1s, f1s,
                          e2s, f2s);
#pragma unroll
        for (int s = 0; s < C; ++s) tw[s] = tw[s + 1];
        tw[C] = nt;
#pragma unroll
        for (int s = C - 1; s > 0; --s) qr[s] = qr[s - 1];
        qr[0] = nq;
    }
    // h1 holds anti-diagonal K; the score is its slot a_end
    int sc = INF;
    if (K >= 0) {
        const int a_end = (tl - ql + (2 * half - (K & 1))) >> 1;
#pragma unroll
        for (int s = 0; s < C; ++s)
            if (a0 + s == a_end) sc = h1[s];
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
        sc = min(sc, __shfl_xor_sync(FULL, sc, o, G));
    if (live && gl == 0) out[b] = sc;
}

template <int G, int C>
void launch(const uint8_t *tseq, const uint8_t *qseq, const int32_t *tl,
            const int32_t *ql, int B, int L, Pens pn, int32_t *out,
            cudaStream_t stream)
{
    const unsigned grid = (unsigned)((B + NP - 1) / NP);
    banded_kernel<G, C><<<grid, NP * G, 0, stream>>>(tseq, qseq, tl, ql, B,
                                                     L, pn, out);
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
    // (G, C): C band slots a lane, G lanes a pair.  At wa = 32, (8, 4)
    // ran 0.52 ms against 0.56 for (4, 8) and 0.54 for (16, 2) on the
    // H100 (PERF.md): four cells a lane, two warps a scheduler
    switch (wa / 32) {
    case 1: launch<8, 4>(tseq, qseq, tl, ql, B, L, pn, out, stream); break;
    case 2: launch<8, 8>(tseq, qseq, tl, ql, B, L, pn, out, stream); break;
    case 3: launch<16, 6>(tseq, qseq, tl, ql, B, L, pn, out, stream); break;
    default: launch<16, 8>(tseq, qseq, tl, ql, B, L, pn, out, stream); break;
    }
    return (int)cudaGetLastError();
}
