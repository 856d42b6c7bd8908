// Batched exact 2-piece-affine WFA of the -c gap pool (wfa_wave) and its
// traceback walk (wfa_walk).
//
// Replace the XLA stages minigraph_tpu/ops/wfa_jax.py wfa_device (a
// lax.while_loop over the score with an extension while_loop inside
// each step; no Pallas kernel) and wfa_tb_walk (+ no_ext_state), and
// are held bitwise against the plain PyTorch versions
// ops/wfa_exact.py wfa_device_ref and wfa_tb_walk_ref: score, end_d,
// no_ext, the ops trace and fin_i/fin_k whole, the tb planes on the
// rows below each pair's score (the only rows the walk reads).
//
// What bounds them on an H100: latency and integer issue, not bytes.
// A pair is a chain of dependent score steps (each: extend every
// diagonal, test the end cell, compute the next wave of D = 2 d_cap + 1
// diagonals, about 20 integer operations a cell), and the walk is a
// chain of dependent tb reads.  The bytes are the sequences in and the
// tb rows out (D bytes a step).
//
// wfa_wave: one block of NT threads a pair, thread j owning diagonals
// j, j + NT, ...  The pair's two sequences sit in shared memory.  The
// ring of waves lives in global memory (per pair H 17 x D, E1/F1 3 x D,
// E2/F2 2 x D int32 at the default penalties: the depths each array is
// read back, 27 rows where the JAX ring keeps 5 x 17), too large for
// shared memory at these widths (523 KB a pair at D = 1537 for the JAX
// layout).  A wave read before wave 0 is NEG_INF, as the JAX ring's
// unwritten slots are; a diagonal off the plane is NEG_INF, as its edge
// pads are.  Each step a thread extends its diagonals greedily (the
// JAX loop extends the whole batch one base a round until no diagonal
// moves; a diagonal that fails once never moves again, so per diagonal
// the result is the same), marks an end cell with an atomicMin of
// (diagonal << 1 | not extended) in shared memory, so the first
// diagonal in increasing order wins; after a barrier the block stops
// at its pair's end, else computes wave s + 1 with the JAX integer
// recurrences unclamped (the NEG_INF + 1 drift included) and writes tb
// row s.  A pair stops at its own score: it writes no tb row at or
// past it.  One block a pair runs on at most B SMs (64 and 16 at the
// pool's two buckets); keeping only the reachable band or H's ring in
// shared memory is later work.
//
// wfa_walk: one thread a pair, the JAX walk step for step, its ops
// column written end first (the wrapper zeroes the ops plane).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF = -0x40000000;
constexpr int NT = 512;         // threads a pair in wfa_wave
constexpr int NW = 64;          // pairs a block in wfa_walk

__device__ __forceinline__ int clampi(int v, int lo, int hi)
{
    return min(max(v, lo), hi);
}

// wave w, diagonal index j of a ring of `depth` waves; NEG_INF before
// wave 0 and off the plane
__device__ __forceinline__ int ring_at(const int32_t *a, int depth, int w,
                                       int j, int D)
{
    if (w < 0 || j < 0 || j >= D) return NEG_INF;
    return a[(w % depth) * D + j];
}

__global__ void __launch_bounds__(NT) wfa_wave_kernel(
    const uint8_t *__restrict__ ts_g, const uint8_t *__restrict__ qs_g,
    const int32_t *__restrict__ tl_g, const int32_t *__restrict__ ql_g,
    int B, int L, int d_cap, int s_cap, int px, int po1, int pe1, int po2,
    int pe2, int dh, int de1, int de2, int32_t *__restrict__ ring_g,
    uint8_t *__restrict__ tb, int32_t *__restrict__ score_o,
    int32_t *__restrict__ endd_o, uint8_t *__restrict__ noext_o)
{
    extern __shared__ uint8_t sseq[];
    __shared__ int first[2];
    uint8_t *st = sseq, *sq = sseq + L;
    const int b = blockIdx.x, tid = threadIdx.x;
    const int D = 2 * d_cap + 1;
    const int tl = tl_g[b], ql = ql_g[b];
    for (int i = tid; i < L; i += NT) {
        st[i] = ts_g[(size_t)b * L + i];
        sq[i] = qs_g[(size_t)b * L + i];
    }
    int32_t *H = ring_g + (size_t)b * (dh + 2 * de1 + 2 * de2) * D;
    int32_t *E1 = H + (size_t)dh * D, *F1 = E1 + (size_t)de1 * D;
    int32_t *E2 = F1 + (size_t)de1 * D, *F2 = E2 + (size_t)de2 * D;
    for (int j = tid; j < D; j += NT) {     // wave 0: the seed at d = 0
        H[j] = j == d_cap ? -1 : NEG_INF;
        E1[j] = F1[j] = E2[j] = F2[j] = NEG_INF;
    }
    if (tid == 0) first[0] = first[1] = INT_MAX;
    __syncthreads();

    const int wo1 = po1 + pe1, wo2 = po2 + pe2;
    for (int s = 0; s < s_cap; ++s) {
        const int fb = s & 1;
        int32_t *Hc = H + (size_t)(s % dh) * D;
        for (int j = tid; j < D; j += NT) {
            int k = Hc[j];
            const int k0 = k, d = j - d_cap;
            if (k >= -1 && k < tl && d + k >= -1 && d + k < ql) {
                while (k + 1 < tl && d + k + 1 < ql
                       && st[min(k + 1, L - 1)] == sq[min(d + k + 1, L - 1)])
                    ++k;
                if (k != k0) Hc[j] = k;
            }
            if (k == tl - 1 && d + k == ql - 1 && k > NEG_INF)
                atomicMin(&first[fb], (j << 1) | (k == k0));
        }
        __syncthreads();
        const int f = first[fb];
        if (f != INT_MAX) {
            if (tid == 0) {
                score_o[b] = s;
                endd_o[b] = f >> 1;
                noext_o[b] = (uint8_t)(f & 1);
            }
            return;
        }
        if (tid == 0) first[fb ^ 1] = INT_MAX;

        const int w = s + 1;
        int32_t *Hn = H + (size_t)(w % dh) * D;
        int32_t *E1n = E1 + (size_t)(w % de1) * D;
        int32_t *F1n = F1 + (size_t)(w % de1) * D;
        int32_t *E2n = E2 + (size_t)(w % de2) * D;
        int32_t *F2n = F2 + (size_t)(w % de2) * D;
        uint8_t *tbr = tb + ((size_t)s * B + b) * D;
        for (int j = tid; j < D; j += NT) {
            const int hx = ring_at(H, dh, w - px, j, D);
            const int ho1m = ring_at(H, dh, w - wo1, j - 1, D);
            const int ho1p = ring_at(H, dh, w - wo1, j + 1, D);
            const int ho2m = ring_at(H, dh, w - wo2, j - 1, D);
            const int ho2p = ring_at(H, dh, w - wo2, j + 1, D);
            const int e1m = ring_at(E1, de1, w - pe1, j - 1, D);
            const int f1p = ring_at(F1, de1, w - pe1, j + 1, D);
            const int e2m = ring_at(E2, de2, w - pe2, j - 1, D);
            const int f2p = ring_at(F2, de2, w - pe2, j + 1, D);
            const int nE1 = max(ho1m, e1m), nE2 = max(ho2m, e2m);
            const int e = max(nE1, nE2);
            const int nF1 = max(ho1p, f1p) + 1, nF2 = max(ho2p, f2p) + 1;
            const int fv = max(nF1, nF2);
            const int h = max(e, fv);
            int x = (ho1m >= e1m ? 0 : 0x08) | (ho2m >= e2m ? 0 : 0x20)
                | (ho1p >= f1p ? 0 : 0x10) | (ho2p >= f2p ? 0 : 0x40);
            int z = e >= fv ? (nE1 >= nE2 ? 1 : 3) : (nF1 >= nF2 ? 2 : 4);
            if (hx + 1 >= h) z = 0;
            tbr[j] = (uint8_t)(x | z);
            Hn[j] = max(hx + 1, h);
            E1n[j] = nE1;
            F1n[j] = nF1;
            E2n[j] = nE2;
            F2n[j] = nF2;
        }
        __syncthreads();
    }
    if (tid == 0) {
        score_o[b] = -1;
        endd_o[b] = 0;
        noext_o[b] = 0;
    }
}

__global__ void __launch_bounds__(NW) wfa_walk_kernel(
    const uint8_t *__restrict__ ts_g, const uint8_t *__restrict__ qs_g,
    const int32_t *__restrict__ tl_g, const int32_t *__restrict__ ql_g,
    const uint8_t *__restrict__ tb, const int32_t *__restrict__ score_g,
    const int32_t *__restrict__ endd_g, const uint8_t *__restrict__ noext_g,
    int B, int L, int S, int d_cap, int t_cap, int px, int po1, int pe1,
    int po2, int pe2, uint8_t *__restrict__ ops, int32_t *__restrict__ fi_o,
    int32_t *__restrict__ fk_o)
{
    const int b = blockIdx.x * NW + threadIdx.x;
    if (b >= B) return;
    const int D = 2 * d_cap + 1;
    const uint8_t *trow = ts_g + (size_t)b * L, *qrow = qs_g + (size_t)b * L;
    const int sc = score_g[b];
    int i = ql_g[b] - 1, k = tl_g[b] - 1, sx = sc - 1;
    int fi = i, fk = k;
    // no_ext_state: continue in the final row's recorded state
    int last = 0;
    if (noext_g[b] && sc > 0)
        last = tb[((size_t)clampi(sc - 1, 0, S - 1) * B + b) * D
                  + clampi(endd_g[b], 0, D - 1)] & 7;
    bool active = sc >= 0;
    for (int t = 0; t < t_cap && active; ++t) {
        if (i < 0 || k < 0) {           // out before a step: nothing moves
            fi = i;
            fk = k;
            break;
        }
        int op;
        if (last == 0
            && trow[clampi(k, 0, L - 1)] == qrow[clampi(i, 0, L - 1)]) {
            op = 7;
            --i;
            --k;
        } else {
            const int x = tb[((size_t)clampi(sx, 0, S - 1) * B + b) * D
                             + clampi(i - k + d_cap, 0, D - 1)];
            const int state = last == 0 ? (x & 7) : last;
            const int ext = state > 0 ? (x >> (state + 2)) & 1 : 0;
            op = state == 0 ? 8 : (state == 1 || state == 3) ? 1 : 2;
            const int st = min(state, 4);       // the JAX gather clamps
            const int pen = st == 0 ? px
                : st <= 2 ? (ext ? pe1 : po1 + pe1)
                : (ext ? pe2 : po2 + pe2);
            i -= (state == 0 || state == 1 || state == 3);
            k -= (state == 0 || state == 2 || state == 4);
            sx -= pen;
            last = (state > 0 && ext == 1) ? state : 0;
        }
        ops[(size_t)t * B + b] = (uint8_t)op;
        if (i < 0 || k < 0) {
            fi = i;
            fk = k;
            active = false;
        }
    }
    fi_o[b] = fi;
    fk_o[b] = fk;
}

}  // namespace

extern "C" int mgt_cuda_wfa_wave(
    const uint8_t *ts, const uint8_t *qs, const int32_t *tl,
    const int32_t *ql, int B, int L, int d_cap, int s_cap, int px, int po1,
    int pe1, int po2, int pe2, int dh, int de1, int de2, int32_t *ring,
    uint8_t *tb, int32_t *score, int32_t *end_d, uint8_t *no_ext,
    cudaStream_t stream)
{
    if (B < 0 || L < 1 || d_cap < 0 || s_cap < 0 || dh < 1 || de1 < 1
        || de2 < 1)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    const size_t smem = (size_t)2 * L;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            wfa_wave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    wfa_wave_kernel<<<B, NT, smem, stream>>>(
        ts, qs, tl, ql, B, L, d_cap, s_cap, px, po1, pe1, po2, pe2, dh, de1,
        de2, ring, tb, score, end_d, no_ext);
    return (int)cudaGetLastError();
}

extern "C" int mgt_cuda_wfa_walk(
    const uint8_t *ts, const uint8_t *qs, const int32_t *tl,
    const int32_t *ql, const uint8_t *tb, const int32_t *score,
    const int32_t *end_d, const uint8_t *no_ext, int B, int L, int S,
    int d_cap, int t_cap, int px, int po1, int pe1, int po2, int pe2,
    uint8_t *ops, int32_t *fin_i, int32_t *fin_k, cudaStream_t stream)
{
    if (B < 0 || L < 1 || S < 1 || d_cap < 0 || t_cap < 0)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    wfa_walk_kernel<<<(B + NW - 1) / NW, NW, 0, stream>>>(
        ts, qs, tl, ql, tb, score, end_d, no_ext, B, L, S, d_cap, t_cap, px,
        po1, pe1, po2, pe2, ops, fin_i, fin_k);
    return (int)cudaGetLastError();
}
