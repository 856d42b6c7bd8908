// comput_sc (lchain.c:115-140) and the warp helpers shared by the chain
// kernels (chain_exact.cu, chain_chunked.cu, chain_ring.cu).
//
// Float arithmetic is spelled with __fmul_rn/__fadd_rn and the library
// is built with --fmad=false: contracting the linear penalty or the
// fast log2 into FMAs would move the integer penalty by one.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG_BIG = -0x3FFFFFFF;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int INT_MIN32 = -0x7FFFFFFF - 1;

// mg_log2 (mgpriv.h:63-71), one rounding per operation; valid for z >= 2
__device__ __forceinline__ float mg_log2(float z)
{
    const unsigned i = __float_as_uint(z);
    const float log2 = (float)((int)((i >> 23) & 255u) - 128);
    const float zf = __uint_as_float((i & 0x807FFFFFu) + (127u << 23));
    const float c1 = -0.34484843f, c2 = 2.02466578f, c3 = 0.67487759f;
    return __fadd_rn(log2, __fsub_rn(
        __fmul_rn(__fadd_rn(__fmul_rn(c1, zf), c2), zf), c3));
}

__device__ __forceinline__ int wrap_sub(int a, int b)
{
    return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int wrap_add(int a, int b)
{
    return (int)((unsigned)a + (unsigned)b);
}

// comput_sc in int32 with wrap-around -> (sc, ok); sc is NEG_BIG when
// the pair is refused
__device__ __forceinline__ int sc_valid(int tp_i, int qp_i, int tp_j,
                                        int qp_j, int sp_j, int mdx,
                                        int mdy, int bw, float pen_gap,
                                        float pen_skip, bool *ok)
{
    const int dq = wrap_sub(qp_i, qp_j);
    const int dr = wrap_sub(tp_i, tp_j);
    bool bad = dq <= 0 || dq > mdx || dr == 0 || dq > mdy;
    const int diff = wrap_sub(dr, dq);
    const int dd = diff < 0 ? (int)(0u - (unsigned)diff) : diff;
    bad = bad || dd > bw;
    const int dg = min(dr, dq);
    int sc = min(sp_j, dg);
    const float lin = __fadd_rn(__fmul_rn(pen_gap, (float)dd),
                                __fmul_rn(pen_skip, (float)dg));
    const float logp = dd >= 1 ? mg_log2((float)(int)((unsigned)dd + 1u))
                               : 0.0f;
    const int pen = (int)__fadd_rn(lin, __fmul_rn(0.5f, logp));
    if (dd != 0 || dg > sp_j) sc = wrap_sub(sc, pen);
    *ok = !bad;
    return bad ? NEG_BIG : sc;
}

// bits of a 32-row word whose position is above d
__device__ __forceinline__ unsigned above(int d)
{
    return d < 0 ? FULL : d >= 31 ? 0u : FULL << (d + 1);
}

__device__ __forceinline__ void lex_max(int &v, int &vj, int x, int j)
{
    if (x > v || (x == v && j > vj)) { v = x; vj = j; }
}

// lexicographic (value, row) max over the warp, two redux.sync
__device__ __forceinline__ void warp_lexmax(int &v, int &j)
{
    const int m = __reduce_max_sync(FULL, v);
    j = __reduce_max_sync(FULL, v == m ? j : INT_MIN32);
    v = m;
}

}  // namespace
