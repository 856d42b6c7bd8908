// Exact chain backtrack walk of the device front (step (b) of
// ops/backtrack.py backtrack_compact).
//
// Replaces the XLA stage minigraph_tpu/ops/backtrack_jax.py
// backtrack_compact (its lax.while_loop interpreter; no Pallas kernel)
// and is held bitwise against the plain PyTorch version ops/backtrack.py
// walk_ref on every output, the step counts included.
//
// What bounds it on an H100: latency, not a peak.  A read's walk is a
// chain of dependent steps (select a start, follow parents, undo past
// the cut), each a few dependent shared-memory accesses; the batch's
// time is its longest read's steps times one step's latency.  The
// bytes it moves (the planes in, the walk's planes out) take
// microseconds.
//
// Design: one block a read.  The block's threads copy the read's f,
// pk = p + 1, the candidate order s_idx, its inverse r_of and the
// rank-indexed claimed bytes into shared memory; then warp 0 runs the
// read's state machine (modes 0 select, 1 walk, 2 undo, 3 done) one
// step per iteration whatever the mode, so the step budget counts the
// steps the plain version counts.  All 32 lanes of warp 0 run the same
// scalar machine on the same values and store the same words, so every
// lane reads back its own stores; the only step that uses the lanes
// apart is the select, where each lane tests one rank of 32 below k
// and a ballot picks the highest unclaimed one (k only decreases, so
// the scans cost O(candidates) a read in all).  Everything is int32,
// as in the JAX version.  The block then writes the planes back for
// step (c) (flags and compaction in PyTorch).
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
    const int32_t *__restrict__ sidx_g, const int32_t *__restrict__ rof_g,
    const int32_t *__restrict__ nz_g, int A, int ucap, int min_cnt,
    int min_sc, int max_drop, int max_steps, int32_t *__restrict__ pk_o,
    int32_t *__restrict__ vbuf_o, int32_t *__restrict__ usc_o,
    int32_t *__restrict__ ucnt_o, int32_t *__restrict__ nu_o,
    int32_t *__restrict__ nv_o, int32_t *__restrict__ unsure_o,
    int32_t *__restrict__ steps_o)
{
    extern __shared__ __align__(16) int sm[];
    int *sf = sm, *spk = sf + A, *ssi = spk + A, *sro = ssi + A,
        *svb = sro + A, *susc = svb + A, *sucnt = susc + ucap;
    unsigned char *claimed = (unsigned char *)(sucnt + ucap);
    const int b = blockIdx.x;
    const size_t row = (size_t)b * A;
    const int nz = nz_g[b];
    for (int i = threadIdx.x; i < A; i += NT) {
        sf[i] = f_g[row + i];
        spk[i] = p_g[row + i] + 1;
        ssi[i] = sidx_g[row + i];
        sro[i] = rof_g[row + i];
        svb[i] = 0;
        claimed[i] = i >= nz;
    }
    for (int i = threadIdx.x; i < ucap; i += NT) susc[i] = sucnt[i] = 0;
    __syncthreads();

    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        int mode = nz > 0 ? 0 : 3, k = nz - 1;
        int pk_at = 0, best_s = 0, best_at = 0, best_pos = 0, sc0 = 0;
        int cut = 0, nv0 = 0, n_u = 0, n_v = 0, steps = 0;
        bool unsure = false;
        for (; steps < max_steps && mode != 3; ++steps) {
            int fin = 0, nv_keep = 0;
            if (mode == 0) {
                // highest rank <= k whose claimed byte is clear
                int kf = -1;
                for (int base = k; base >= 0; base -= 32) {
                    const int i = base - lane;
                    const unsigned m =
                        __ballot_sync(FULL, i >= 0 && !claimed[i]);
                    if (m) {
                        kf = base - (__ffs(m) - 1);
                        break;
                    }
                }
                if (kf < 0) {
                    mode = 3;
                    continue;
                }
                const int ci = ssi[kf], fc = sf[ci], pkc = spk[ci];
                if ((pkc & PK_VIS) && claimer_f(pkc) == (fc & F15))
                    unsure = true;
                spk[ci] = claim_word(pkc, fc, PK_START);
                claimed[sro[ci]] = 1;
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
                const int pk2 = root ? 0 : spk[at2];
                const int s = root ? sc0 : sc0 - sf[at2];
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
                    spk[at2] = claim_word(pk2, sc0, 0);
                    claimed[sro[at2]] = 1;
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
                spk[u_at] = spk[u_at] & ~(PK_CLAIMED | PK_START);
                claimed[sro[u_at]] = 0;
                --n_v;
                if (n_v <= best_pos) {
                    fin = 1;
                    nv_keep = n_v;
                }
            }
            if (fin) {
                // accept (record) or reject the chain; a rejected
                // chain's anchors stay claimed
                const int sc = cut < 0 ? sc0 : sc0 - sf[cut];
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
            nu_o[b] = n_u;
            nv_o[b] = n_v;
            unsure_o[b] = unsure || mode != 3;
            steps_o[b] = steps;
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < A; i += NT) {
        pk_o[row + i] = spk[i];
        vbuf_o[row + i] = svb[i];
    }
    for (int i = threadIdx.x; i < ucap; i += NT) {
        usc_o[(size_t)b * ucap + i] = susc[i];
        ucnt_o[(size_t)b * ucap + i] = sucnt[i];
    }
}

}  // namespace

extern "C" int mgt_cuda_backtrack(
    const int32_t *f, const int32_t *p, const int32_t *s_idx,
    const int32_t *r_of, const int32_t *n_z, int B, int A, int ucap,
    int min_cnt, int min_sc, int max_drop, int max_steps, int32_t *pk,
    int32_t *vbuf, int32_t *u_sc, int32_t *u_cnt, int32_t *n_u,
    int32_t *n_v, int32_t *unsure, int32_t *steps, cudaStream_t stream)
{
    // the wrapper refuses what exceeds a block's 227 KB
    const size_t smem = (size_t)5 * 4 * A + (size_t)2 * 4 * ucap
        + (size_t)(A + 15) / 16 * 16;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            backtrack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    backtrack_kernel<<<B, NT, smem, stream>>>(
        f, p, s_idx, r_of, n_z, A, ucap, min_cnt, min_sc, max_drop,
        max_steps, pk, vbuf, u_sc, u_cnt, n_u, n_v, unsure, steps);
    return (int)cudaGetLastError();
}
