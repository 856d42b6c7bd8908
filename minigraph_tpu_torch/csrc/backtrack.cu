// Exact chain backtrack and compaction of the device front, one fused
// kernel a batch (ops/backtrack.py backtrack_compact on the card).
//
// Replaces the XLA stage minigraph_tpu/ops/backtrack_jax.py
// backtrack_compact (its candidate sorts, its lax.while_loop
// interpreter and its compaction; no Pallas kernel) and is held bitwise
// against the plain PyTorch version ops/backtrack.py
// backtrack_compact_ref on every output, the step counts included.
//
// What bounds it on an H100: latency, not a peak.  A read's walk is a
// chain of dependent steps (select a start, follow parents, undo past
// the cut), each a few dependent shared-memory accesses; the batch's
// time is its longest read's steps times one step's latency.  The
// bytes it moves (six planes in, four compacted planes out) take
// microseconds.  So everything between the planes coming in and the
// compacted planes going out stays in shared memory, in one launch.
//
// Design: one block of 256 threads a read, four phases.
//  1. Candidate order.  Each anchor's key is (cand ? f : INT_MAX) in
//     u32 order, shifted left 32, OR its index: every key is unique, so
//     a bitonic sort over the next power of two of A gives the stable
//     (f, index) order of the plain version.  The sorted buffer then
//     holds s_idx (the low words) and r_of (the high words, free after
//     the sort).  f and pk = p + 1 are stored side by side (int2), so
//     one load serves a walk step.
//  2. The walk: warp 0 runs the read's state machine (modes 0 select,
//     1 walk, 2 undo, 3 done) one step per iteration whatever the mode,
//     so the step budget counts the steps the plain version counts.
//     Its scalars live in registers.  All 32 lanes run the same machine
//     on the same values and store the same words, so every lane reads
//     back its own stores; the lanes part only in the select, where
//     the claimed ranks are one bit a rank and each lane tests one
//     32-bit word below k, 1024 ranks a ballot.  A step's one critical
//     chain is load f/pk (and r_of beside it), test, store: lane 0
//     sets and clears the rank bits with shared atomics whose result
//     nobody waits for, and the select, once a chain, syncs the warp
//     before it reads them.
//  3. The flags: a candidate claimed mid-path by an equal-f chain
//     (__syncthreads_or over the block); the walk's own (> ucap chains,
//     tie hits, the step budget).
//  4. The compaction: the <= ucap chains ranked by the first anchor's
//     x (ties in build order, as a stable sort), the x-tie flag, the
//     exclusive scans of the counts, then every output position read
//     from vbuf in reverse within its chain, the four int64 planes
//     gathered from device memory.
// An optional clock buffer (null on the main path) takes each block's
// clock64() cycles of the four phases.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PK_P = 0x3FFF;
constexpr int PK_CLAIMED = 1 << 14;
constexpr int PK_START = 1 << 15;
constexpr int PK_VIS = 1 << 16;
constexpr int F15 = 0x7FFF;
constexpr int NT = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr size_t SMEM_LIMIT = 232448;

__host__ __device__ __forceinline__ int pow2_at_least(int a)
{
    int n = 1;
    while (n < a) n <<= 1;
    return n;
}

__host__ __device__ __forceinline__ int rank_words(int a)
{
    return a > 32 ? (a + 31) / 32 : 1;
}

// the block's shared memory: the sort's keys (np x 8), f/pk (A x 8),
// the chain keys (ucap x 8), five clock stamps, vbuf (A x 4), the rank
// bits, seven int arrays of ucap and eight int scalars
// (ops/backtrack.py walk_smem_bytes)
__host__ __device__ __forceinline__ size_t smem_bytes(int A, int ucap)
{
    return (size_t)8 * pow2_at_least(A) + (size_t)12 * A
        + (size_t)4 * rank_words(A) + (size_t)36 * ucap + 72;
}

__device__ __forceinline__ int claimer_f(int pk) { return (pk >> 17) & F15; }

// packed word of a claimed anchor: parent field, claim bits and the low
// 15 bits of the claiming chain's start f (bits 17..31)
__device__ __forceinline__ int claim_word(int base, int sc0, int start)
{
    return (base & PK_P) | PK_CLAIMED | PK_VIS | start
        | ((sc0 & F15) << 17);
}

__global__ void __launch_bounds__(NT) backtrack_kernel(
    const int32_t *__restrict__ f_g, const int32_t *__restrict__ p_g,
    const int32_t *__restrict__ na_g, const int64_t *__restrict__ axh_g,
    const int64_t *__restrict__ axl_g, const int64_t *__restrict__ ayh_g,
    const int64_t *__restrict__ ayl_g, int A, int ucap, int min_cnt,
    int min_sc, int max_drop, int max_steps, int64_t *__restrict__ caxh_o,
    int64_t *__restrict__ caxl_o, int64_t *__restrict__ cayh_o,
    int64_t *__restrict__ cayl_o, int32_t *__restrict__ usc_o,
    int32_t *__restrict__ ucnt_o, int32_t *__restrict__ nu_o,
    int32_t *__restrict__ nv_o, uint8_t *__restrict__ unsure_o,
    int32_t *__restrict__ steps_o, long long *__restrict__ clk_o)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int np = pow2_at_least(A), nw = rank_words(A);
    unsigned long long *skey = (unsigned long long *)smem;
    // after the sort: [2 r] = s_idx[r], [2 a + 1] = r_of[a]
    int *sord = (int *)smem;
    int2 *sfp = (int2 *)(skey + np);
    long long *skx = (long long *)(sfp + A);
    long long *sclk = skx + ucap;   // clock64() at the phase edges
    int *svb = (int *)(sclk + 5);
    unsigned *sbits = (unsigned *)(svb + A);
    int *susc = (int *)(sbits + nw), *sucnt = susc + ucap;
    int *scoff = sucnt + ucap, *sperm = scoff + ucap, *scnt = sperm + ucap;
    int *scsrc = scnt + ucap, *sstart = scsrc + ucap;
    int *sscal = sstart + ucap;   // n_z, n_u, n_v, unsure, steps
    const int b = blockIdx.x, tid = threadIdx.x;
    const size_t row = (size_t)b * A;
    if (clk_o && tid == 0) sclk[0] = clock64();

    // ---- 1. the planes in, the candidate keys, the sort
    const int n_a = na_g[b];
    if (tid == 0) sscal[0] = 0;
    int ncand = 0;
#pragma unroll 4
    for (int i = tid; i < np; i += NT) {
        unsigned long long key = ~0ull;
        if (i < A) {
            const int fi = f_g[row + i];
            sfp[i] = make_int2(fi, p_g[row + i] + 1);
            svb[i] = 0;
            const bool cand = i < n_a && fi >= min_sc;
            ncand += cand;
            const unsigned u = (unsigned)(cand ? fi : INT_MAX) ^ 0x80000000u;
            key = ((unsigned long long)u << 32) | (unsigned)i;
        }
        skey[i] = key;
    }
    for (int i = tid; i < ucap; i += NT) susc[i] = sucnt[i] = 0;
    __syncthreads();
    ncand = __reduce_add_sync(FULL, ncand);
    if ((tid & 31) == 0 && ncand) atomicAdd(&sscal[0], ncand);
    // a thread's pairs of a pass are loaded SW at a time before any
    // store; measured, a pair at a time left the sort's cycles the same
    // but the walk's ~15% higher (ptxas schedules the kernel as one)
    constexpr int SW = 4;
    for (int k = 2; k <= np; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i0 = tid; i0 < np / 2; i0 += SW * NT) {
                unsigned long long x[SW], y[SW];
                int lo[SW];
#pragma unroll
                for (int u = 0; u < SW; ++u) {
                    const int i = i0 + u * NT;
                    lo[u] = 2 * i - (i & (j - 1));
                    if (i < np / 2) {
                        x[u] = skey[lo[u]];
                        y[u] = skey[lo[u] + j];
                    }
                }
#pragma unroll
                for (int u = 0; u < SW; ++u) {
                    if (i0 + u * NT < np / 2
                        && (x[u] > y[u]) == ((lo[u] & k) == 0)) {
                        skey[lo[u]] = y[u];
                        skey[lo[u] + j] = x[u];
                    }
                }
            }
            __syncthreads();
        }
    }
    __syncthreads();
    const int nz = sscal[0];
    for (int r = tid; r < A; r += NT) sord[2 * sord[2 * r] + 1] = r;
    // rank bits: ranks >= n_z start claimed (the select never reads them)
    for (int w = tid; w < nw; w += NT) {
        const int lo = 32 * w;
        sbits[w] = nz <= lo ? FULL : nz >= lo + 32 ? 0u : FULL << (nz - lo);
    }
    __syncthreads();
    if (clk_o && tid == 0) sclk[1] = clock64();

    // ---- 2. the walk (warp 0)
    if (tid < 32) {
        const int lane = tid;
        int mode = nz > 0 ? 0 : 3, k = nz - 1;
        int pk_at = 0, best_s = 0, best_at = 0, best_pos = 0, sc0 = 0;
        int cut = 0, nv0 = 0, n_u = 0, n_v = 0, steps = 0;
        bool unsure = false;
        for (; steps < max_steps && mode != 3; ++steps) {
            int fin = 0, nv_keep = 0;
            if (mode == 0) {
                // highest rank <= k whose bit is clear: lane l tests word
                // (k >> 5) - l, the lowest lane with a clear bit wins
                __syncwarp();   // lane 0's bit updates, to every lane
                int kf = -1;
                const int wk = k >> 5;
                for (int top = wk; top >= 0; top -= 32) {
                    const int w = top - lane;
                    unsigned clr = 0;
                    if (w >= 0) {
                        clr = ~sbits[w];
                        if (w == wk) clr &= (2u << (k & 31)) - 1u;
                    }
                    const unsigned m = __ballot_sync(FULL, clr != 0);
                    if (m) {
                        const int lead = __ffs(m) - 1;
                        const unsigned c = __shfl_sync(FULL, clr, lead);
                        kf = ((top - lead) << 5) + 31 - __clz(c);
                        break;
                    }
                }
                if (kf < 0) {
                    mode = 3;
                    continue;
                }
                const int ci = sord[2 * kf];
                const int2 v = sfp[ci];
                const int fc = v.x, pkc = v.y;
                if ((pkc & PK_VIS) && claimer_f(pkc) == (fc & F15))
                    unsure = true;
                sfp[ci].y = claim_word(pkc, fc, PK_START);
                if (lane == 0) atomicOr(&sbits[kf >> 5], 1u << (kf & 31));
                svb[n_v] = ci;
                sc0 = fc;
                best_s = 0;
                best_at = ci;
                best_pos = nv0 = n_v;
                ++n_v;
                k = kf;
                mode = 1;
                pk_at = pkc;
            } else if (mode == 1) {
                // one walk step from pk_at's anchor to its parent at2,
                // appending and claiming at2 unless the walk ends there
                const int at2 = (pk_at & PK_P) - 1;
                const bool root = at2 < 0;
                const int2 v = root ? make_int2(0, 0) : sfp[at2];
                const int r = root ? 0 : sord[2 * at2 + 1];
                const int pk2 = v.y;
                const int s = root ? sc0 : sc0 - v.x;
                const bool better = s > best_s;
                const bool drop = !better && best_s - s > max_drop;
                const bool at2c = !root && (pk2 & PK_CLAIMED);
                if (at2c && claimer_f(pk2) == (sc0 & F15)) unsure = true;
                if (better) {
                    best_s = s;
                    best_at = at2;
                }
                if (!(drop || root || at2c)) {
                    if (better) best_pos = n_v;
                    if ((pk2 & PK_VIS) && claimer_f(pk2) == (sc0 & F15))
                        unsure = true;
                    sfp[at2].y = claim_word(pk2, sc0, 0);
                    if (lane == 0) atomicOr(&sbits[r >> 5], 1u << (r & 31));
                    svb[n_v] = at2;
                    ++n_v;
                    pk_at = pk2;
                } else {
                    cut = best_at;
                    const bool keep_all = best_at == at2 || best_at < 0;
                    if (!keep_all && n_v > best_pos) {
                        mode = 2;
                    } else {
                        fin = 1;
                        nv_keep = keep_all ? n_v : best_pos;
                    }
                }
            } else {
                // one undo step: the claim and start bits go, the
                // visited bit and the claimer f stay
                const int u_at = svb[n_v - 1];
                const int r = sord[2 * u_at + 1];
                sfp[u_at].y &= ~(PK_CLAIMED | PK_START);
                if (lane == 0) atomicAnd(&sbits[r >> 5], ~(1u << (r & 31)));
                --n_v;
                if (n_v <= best_pos) {
                    fin = 1;
                    nv_keep = n_v;
                }
            }
            if (fin) {
                // accept (record) or reject the chain; a rejected
                // chain's anchors stay claimed
                const int sc = cut < 0 ? sc0 : sc0 - sfp[cut].x;
                const int cnt = nv_keep - nv0;
                const bool acc = sc >= min_sc && cnt >= min_cnt && cnt > 0;
                if (acc) {
                    if (n_u >= ucap) {
                        unsure = true;
                    } else {
                        susc[n_u] = sc;
                        sucnt[n_u] = cnt;
                        ++n_u;
                    }
                }
                n_v = acc ? nv_keep : nv0;
                --k;
                mode = 0;
            }
        }
        if (lane == 0) {
            sscal[1] = n_u;
            sscal[2] = n_v;
            sscal[3] = unsure || mode != 3;
            sscal[4] = steps;
        }
    }
    __syncthreads();
    if (clk_o && tid == 0) sclk[2] = clock64();

    // ---- 3. a candidate claimed mid-path by an equal-f chain was
    // skipped by the select (15-bit f compare)
    int flag = 0;
    for (int a = tid; a < A; a += NT) {
        const int2 v = sfp[a];
        flag |= a < n_a && v.x >= min_sc && (v.y & PK_CLAIMED)
            && claimer_f(v.y) == (v.x & F15) && !(v.y & PK_START);
    }
    const int skipped = __syncthreads_or(flag);
    if (clk_o && tid == 0) sclk[3] = clock64();

    // ---- 4. the compaction: chains by first-anchor x (stable)
    const int n_u = sscal[1], n_v = sscal[2];
    if (tid < ucap) {
        int coff = 0;
        for (int j = 0; j < tid; ++j) coff += sucnt[j];
        scoff[tid] = coff;
        long long kx = LLONG_MAX;
        if (tid < n_u) {
            const int first = svb[max(coff + sucnt[tid] - 1, 0)];
            const size_t fv = row + min(first, A - 1);
            kx = (long long)(((unsigned long long)axh_g[fv] << 32)
                             | (unsigned long long)axl_g[fv]);
        }
        skx[tid] = kx;
    }
    __syncthreads();
    if (tid < ucap) {
        const long long x = skx[tid];
        int r = 0;
        for (int j = 0; j < ucap; ++j) {
            const long long y = skx[j];
            r += y < x || (y == x && j < tid);
        }
        sperm[r] = tid;
    }
    __syncthreads();
    int tie = 0;
    if (tid < ucap) {
        const int c = sperm[tid];
        scnt[tid] = sucnt[c];
        scsrc[tid] = scoff[c];
        usc_o[(size_t)b * ucap + tid] = susc[c];
        ucnt_o[(size_t)b * ucap + tid] = sucnt[c];
        tie = tid >= 1 && tid < n_u && skx[c] == skx[sperm[tid - 1]];
    }
    tie = __syncthreads_or(tie);
    if (tid < ucap) {
        int co = 0;
        for (int j = 0; j < tid; ++j) co += scnt[j];
        scoff[tid] = co;                       // now the output offsets
        sstart[tid] = tid < n_u ? co : INT_MAX;
    }
    __syncthreads();
    for (int t = tid; t < A; t += NT) {
        int64_t xh = 0, xl = 0, yh = 0, yl = 0;
        if (t < n_v) {
            // the chain whose output block holds t: the last start <= t
            int lo = 0, hi = ucap;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (sstart[mid] <= t) lo = mid + 1;
                else hi = mid;
            }
            const int rk = min(max(lo - 1, 0), ucap - 1);
            const int src = scsrc[rk] + scnt[rk] - 1 - (t - scoff[rk]);
            const int a = min(max(svb[min(max(src, 0), A - 1)], 0), A - 1);
            xh = axh_g[row + a];
            xl = axl_g[row + a];
            yh = ayh_g[row + a];
            yl = ayl_g[row + a];
        }
        caxh_o[row + t] = xh;
        caxl_o[row + t] = xl;
        cayh_o[row + t] = yh;
        cayl_o[row + t] = yl;
    }
    if (tid == 0) {
        nu_o[b] = n_u;
        nv_o[b] = n_v;
        unsure_o[b] = (sscal[3] || skipped || tie) ? 1 : 0;
        steps_o[b] = sscal[4];
    }
    if (clk_o) {
        __syncthreads();
        if (tid == 0) {
            sclk[4] = clock64();
            for (int i = 0; i < 4; ++i)
                clk_o[4 * b + i] = sclk[i + 1] - sclk[i];
        }
    }
}

}  // namespace

extern "C" int mgt_cuda_backtrack_compact(
    const int32_t *f, const int32_t *p, const int32_t *n_a,
    const int64_t *axh, const int64_t *axl, const int64_t *ayh,
    const int64_t *ayl, int B, int A, int ucap, int min_cnt, int min_sc,
    int max_drop, int max_steps, int64_t *c_axh, int64_t *c_axl,
    int64_t *c_ayh, int64_t *c_ayl, int32_t *u_sc, int32_t *u_cnt,
    int32_t *n_u, int32_t *n_v, uint8_t *unsure, int32_t *steps,
    long long *clk, cudaStream_t stream)
{
    // the wrapper refuses these shapes first
    if (A < 0 || A >= (1 << 14) || ucap < 1 || ucap > NT)
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(A, ucap);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            backtrack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    if (B > 0)
        backtrack_kernel<<<B, NT, smem, stream>>>(
            f, p, n_a, axh, axl, ayh, ayl, A, ucap, min_cnt, min_sc,
            max_drop, max_steps, c_axh, c_axl, c_ayh, c_ayl, u_sc, u_cnt,
            n_u, n_v, unsure, steps, clk);
    return (int)cudaGetLastError();
}
