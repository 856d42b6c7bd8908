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
// What bounds them on an H100: not bytes (the sequences in, the tb rows
// out, D bytes a step).  A pair is a chain of dependent score steps
// (each: extend every diagonal, test the end cell, compute the next
// wave of D = 2 d_cap + 1 diagonals), and a step is bound by the
// block's integer issue, ~50 instructions a cell computed in full (an
// integer instruction takes a warp two cycles on a scheduler's 16
// lanes); the walk is a chain of dependent tb reads.  So the wave cuts
// the instructions of a step and the walk the round trips.
//
// wfa_wave: one block of NT threads a pair, thread t owning diagonals
// t, t + NT, ... in every phase.  The pair's sequences and its
// whole ring of waves sit in shared memory: H 17 rows, E1/F1 3 each,
// E2/F2 2 each at the default penalties (the depths each array is read
// back), as int16 in an encoding that keeps order, max and +1: every
// ring value is a reachable k in [-1, L + s_cap] (kept as it is) or
// NEG_INF + d with 0 <= d <= s_cap, the sentinel plus the 1 a step the
// recurrences add to it (stored as -32768 + d).  27 rows x 4097
// diagonals x 2 bytes fit one block at the pool's widest bucket; the
// wrapper refuses a shape where the zones could meet or the ring would
// not fit.  Each row has two -32768 pads at both ends (the NEG_INF of a
// diagonal off the plane), and every slot starts at -32768, which is
// what a wave before wave 0 reads; the ring slots are stepped, never
// divided for.  A step: each thread extends in place those of its
// diagonals within s of the seed's (no other holds a k >= -1 at step
// s), comparing 8 bytes at a time (the first differing byte ends the
// run, cut where either sequence ends); an end cell marks an atomicMin
// of (diagonal << 1 | not extended), so the first diagonal in
// increasing order wins; one barrier; the block stops at its pair's
// end, else computes wave w = s + 1 with the JAX integer recurrences
// (the NEG_INF + 1 drift included) and writes tb row s.
//
// Far cells.  A cell of wave w reads cells at most one diagonal away
// in older waves, so what it holds depends only on the cells within w
// diagonals of it at wave 0.  A cell at least w diagonals from both
// edges of the plane and more than w from the seed's diagonal reads no
// pad and no cell the seed reaches, back to wave 0: it holds what every
// diagonal of a plane without a seed and without edges holds at wave w.
// The last thread computes that plane's next wave (one cell, with the
// same recurrences) after its cells of this one; a far cell takes
// its tb byte from it, and its five ring values where a cell computed
// in full may read them: within dh diagonals of those cells, since the
// cells computed in full grow by one diagonal a wave on each side and
// read dh - 1 waves back at most.  At the pool's scores 73-83% of a
// slowest pair's cells are far.
//
// One barrier a step is enough: a thread's extension reads only its
// own diagonals, which it wrote in the wave before; the wave reads rows
// at least one wave old, which the barrier closes; a wave slot is
// overwritten one step after its last read, across the barrier; the
// end marks and the plane's waves rotate over three and two words.  A
// pair stops at its own score: it writes no tb row at or past it.
//
// wfa_walk: one warp a pair, the pair's sequences staged in shared
// memory.  The lanes carry the walk's state alike; a run of match
// steps is found 32 bases at a time (each lane compares one base, a
// ballot finds the first mismatch) and its ops (7) are written by the
// lanes at once; each other step reads one tb byte, and the read that
// lane 0 makes for it, lanes 1-9 make for the nine cells the next such
// step can read, so that step waits for no read (two tb steps a round
// trip).  The ops column is written end first (the wrapper zeroes the
// ops plane).
//
// An optional clock buffer (null on the main path) takes each pair's
// clock64() split: wfa_wave's cycles of a step, read at the barrier
// from the block's latest wave end and extension end, in the wave (from
// the last barrier until its slowest thread ended), in extension (the
// extensions that ended after), in the end test and the barrier, its
// steps, its extension iterations (8-byte compares, all threads) and
// its cycles; wfa_walk's cycles, steps and tb reads.
#include <climits>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int NEG16 = -32768;   // NEG_INF in the ring's int16 encoding
constexpr int NT = 1024;        // threads a pair in wfa_wave
constexpr int WAVE_CLK_N = 6, WALK_CLK_N = 3;   // ops/wfa_exact.py
constexpr int MAX_DEV = 64;

// a pair's wave clock row: cycles in the wave (until its slowest
// thread), in extension (the part that ended after), in the end test and
// the barrier; steps; extension compares (all threads); cycles in all
__device__ void wave_clock_out(long long *clock, int b, long long c_ext,
                               long long c_end, long long c_wave, int steps,
                               long long n_iter, long long base)
{
    long long *c = clock + (size_t)b * WAVE_CLK_N;
    atomicAdd((unsigned long long *)&c[4], (unsigned long long)n_iter);
    if (threadIdx.x == 0) {
        c[0] = c_ext;
        c[1] = c_end;
        c[2] = c_wave;
        c[3] = steps;
        c[5] = clock64() - base;
    }
}

__device__ __forceinline__ int clampi(int v, int lo, int hi)
{
    return min(max(v, lo), hi);
}

__host__ __device__ inline int ring_stride(int D)
{
    return (D + 4 + 7) & ~7;    // two pads each side, 16-byte rows
}

__host__ __device__ inline int seq_stride(int L)
{
    return ((L + 15) & ~15) + 16;   // slack for the 12-byte reads
}

// the ring slot `back` waves before slot `slot` (0 <= back < depth)
__device__ __forceinline__ int slot_back(int slot, int back, int depth)
{
    const int r = slot - back;
    return r < 0 ? r + depth : r;
}

__device__ __forceinline__ int slot_next(int slot, int depth)
{
    return slot + 1 == depth ? 0 : slot + 1;
}

// bytes p .. p + 7 of a 4-byte aligned sequence in shared memory
__device__ __forceinline__ unsigned long long ld8(const uint8_t *s, int p)
{
    const uint32_t *w = reinterpret_cast<const uint32_t *>(s) + (p >> 2);
    const uint32_t sh = (p & 3) * 8;
    const uint32_t a = w[0], b = w[1], c = w[2];
    return (unsigned long long)__funnelshift_r(a, b, sh)
        | (unsigned long long)__funnelshift_r(b, c, sh) << 32;
}

// the greedy extension of diagonal d from k (k >= -1, d + k >= -1):
// the k the byte loop `while (k + 1 < tl && d + k + 1 < ql && st[k + 1]
// == sq[d + k + 1]) ++k` stops at, 8 bytes a compare
__device__ __forceinline__ int extend(const uint8_t *st, const uint8_t *sq,
                                      int k, int d, int tl, int ql,
                                      long long &n_iter)
{
    int n = min(tl - 1 - k, ql - 1 - d - k);    // bases that may match
    while (n > 0) {
        const unsigned long long x = ld8(st, k + 1) ^ ld8(sq, d + k + 1);
        ++n_iter;
        if (x) return k + min((__ffsll((long long)x) - 1) >> 3, n);
        if (n <= 8) return k + n;
        k += 8;
        n -= 8;
    }
    return k;
}

// one cell of the next wave from its nine reads, with the JAX integer
// recurrences (the NEG_INF drift included): its five values and tb byte
struct Cell {
    int h, e1, f1, e2, f2, tb;
};

__device__ __forceinline__ Cell wave_cell(int hx, int ho1m, int ho1p,
                                          int ho2m, int ho2p, int e1m,
                                          int f1p, int e2m, int f2p)
{
    Cell c;
    c.e1 = max(ho1m, e1m);
    c.e2 = max(ho2m, e2m);
    const int e = max(c.e1, c.e2);
    c.f1 = max(ho1p, f1p) + 1;
    c.f2 = max(ho2p, f2p) + 1;
    const int fv = max(c.f1, c.f2);
    const int h = max(e, fv);
    const int x = (ho1m >= e1m ? 0 : 0x08) | (ho2m >= e2m ? 0 : 0x20)
        | (ho1p >= f1p ? 0 : 0x10) | (ho2p >= f2p ? 0 : 0x40);
    int z = e >= fv ? (c.e1 >= c.e2 ? 1 : 3) : (c.f1 >= c.f2 ? 2 : 4);
    if (hx + 1 >= h) z = 0;
    c.h = max(hx + 1, h);
    c.tb = x | z;
    return c;
}

// a wave of the plane without a seed and without edges, where every
// diagonal holds the same values: a far cell's (see wfa_wave_kernel).
// vr holds its waves in the ring's slots, one value a row (every slot
// NEG16 at the start, as the ring's); hn, e1n, e2n are the wave's slots;
// out takes the five values and the tb byte.  One thread, wave by wave.
__device__ void plane_wave(int16_t *vr, int hn, int e1n, int e2n, int px,
                           int po1, int pe1, int po2, int pe2, int dh,
                           int de1, int de2, int *out)
{
    int16_t *vH = vr, *vE1 = vH + dh, *vF1 = vE1 + de1;
    int16_t *vE2 = vF1 + de1, *vF2 = vE2 + de2;
    const int ho1 = vH[slot_back(hn, po1 + pe1, dh)];
    const int ho2 = vH[slot_back(hn, po2 + pe2, dh)];
    const Cell c = wave_cell(vH[slot_back(hn, px, dh)], ho1, ho1, ho2, ho2,
                             vE1[slot_back(e1n, pe1, de1)],
                             vF1[slot_back(e1n, pe1, de1)],
                             vE2[slot_back(e2n, pe2, de2)],
                             vF2[slot_back(e2n, pe2, de2)]);
    vH[hn] = (int16_t)c.h;
    vE1[e1n] = (int16_t)c.e1;
    vF1[e1n] = (int16_t)c.f1;
    vE2[e2n] = (int16_t)c.e2;
    vF2[e2n] = (int16_t)c.f2;
    out[0] = c.h;
    out[1] = c.e1;
    out[2] = c.f1;
    out[3] = c.e2;
    out[4] = c.f2;
    out[5] = c.tb;
}

// the block's latest clock64() at this point of a step, in cycles past
// `base`: a warp's max, one atomic a warp (every thread calls it)
__device__ __forceinline__ void mark_latest(unsigned *slot, long long base)
{
    const unsigned m = __reduce_max_sync(0xffffffffu,
                                         (unsigned)(clock64() - base));
    if ((threadIdx.x & 31) == 0) atomicMax(slot, m);
}

__global__ void __launch_bounds__(NT, 1) wfa_wave_kernel(
    const uint8_t *__restrict__ ts_g, const uint8_t *__restrict__ qs_g,
    const int32_t *__restrict__ tl_g, const int32_t *__restrict__ ql_g,
    int B, int L, int d_cap, int s_cap, int px, int po1, int pe1, int po2,
    int pe2, int dh, int de1, int de2, uint8_t *__restrict__ tb,
    int32_t *__restrict__ score_o, int32_t *__restrict__ endd_o,
    uint8_t *__restrict__ noext_o, long long *__restrict__ clock)
{
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ int first[3];
    // the clock: the latest wave end and extension end of a step
    __shared__ unsigned wave_end[3], ext_end[3];
    __shared__ long long base;
    __shared__ int vpub[2][6];          // a far cell's values, by parity
    const int b = blockIdx.x, tid = threadIdx.x;
    const int D = 2 * d_cap + 1, RS = ring_stride(D);
    const int rows = dh + 2 * de1 + 2 * de2;
    // ring row r: int16 slots, diagonal j at slot j + 2, pads NEG16
    int16_t *ring = reinterpret_cast<int16_t *>(smem);
    int16_t *H = ring + 2;              // diagonal j of row r: H[r * RS + j]
    int16_t *E1 = H + dh * RS, *F1 = E1 + de1 * RS;
    int16_t *E2 = F1 + de1 * RS, *F2 = E2 + de2 * RS;
    uint8_t *st = smem + (size_t)rows * RS * 2, *sq = st + seq_stride(L);
    int16_t *vr = reinterpret_cast<int16_t *>(sq + seq_stride(L));
    const int tl = tl_g[b], ql = ql_g[b];
    for (int i = tid; i < L; i += NT) {
        st[i] = ts_g[(size_t)b * L + i];
        sq[i] = qs_g[(size_t)b * L + i];
    }
    // every slot and pad NEG_INF (rows * RS is even), then the seed
    uint32_t *ring32 = reinterpret_cast<uint32_t *>(ring);
    for (int i = tid; i < rows * RS / 2; i += NT) ring32[i] = 0x80008000u;
    for (int i = tid; i < rows; i += NT) vr[i] = NEG16;
    if (tid < 3) {
        first[tid] = INT_MAX;
        wave_end[tid] = ext_end[tid] = 0;
    }
    if (tid == 0 && clock) base = clock64();
    __syncthreads();
    if (tid == 0) H[d_cap] = -1;        // wave 0: the seed at d = 0
    if (tid == NT - 1)                  // wave 1 of the edgeless plane
        plane_wave(vr, 1, 1, 1, px, po1, pe1, po2, pe2, dh, de1, de2,
                   vpub[1]);
    __syncthreads();
    long long c_ext = 0, c_end = 0, c_wave = 0, n_iter = 0;
    unsigned c_bar = 0;                 // thread 0: the last barrier's exit
    if (clock && tid == 0) c_bar = (unsigned)(clock64() - base);

    const int wo1 = po1 + pe1, wo2 = po2 + pe2;
    // wave s's slots in H, E1/F1 and E2/F2, and its end-mark word,
    // stepped without a division
    int hs = 0, e1s = 0, e2s = 0, fb = 0;
    for (int s = 0; s < s_cap; ++s) {
        int16_t *Hc = H + hs * RS;
        // a k >= -1 at wave s lies within s diagonals of the seed's (each
        // wave reads diagonals j - 1, j and j + 1 of older waves): no
        // other diagonal can extend or end
        const int lo = d_cap - s, hi = d_cap + s;
        for (int j = tid; j < D; j += NT) {
            if (j < lo || j > hi) continue;
            int k = Hc[j];
            const int k0 = k, d = j - d_cap;
            if (k >= -1 && k < tl && d + k >= -1 && d + k < ql) {
                k = extend(st, sq, k, d, tl, ql, n_iter);
                if (k != k0) Hc[j] = (int16_t)k;
            }
            if (k == tl - 1 && d + k == ql - 1 && k > NEG16)
                atomicMin(&first[fb], (j << 1) | (k == k0));
        }
        if (clock) mark_latest(&ext_end[fb], base);
        __syncthreads();
        const int f = first[fb];
        const int fp = fb == 0 ? 2 : fb - 1;    // step s - 1's word
        if (clock && tid == 0) {
            // the step from the last barrier: the wave of step s - 1
            // until its slowest thread ended, the extensions that ended
            // after, the end test and the barrier
            const unsigned now = (unsigned)(clock64() - base);
            const unsigned we = s ? max(wave_end[fp], c_bar) : c_bar;
            const unsigned xe = max(ext_end[fb], we);
            c_wave += we - c_bar;
            c_ext += xe - we;
            c_end += now - xe;
            c_bar = now;
            wave_end[fp] = ext_end[fb] = 0;
        }
        if (f != INT_MAX) {
            if (tid == 0) {
                score_o[b] = s;
                endd_o[b] = f >> 1;
                noext_o[b] = (uint8_t)(f & 1);
            }
            if (clock) wave_clock_out(clock, b, c_ext, c_end, c_wave,
                                      s + 1, n_iter, base);
            return;
        }
        if (tid == 0) first[fp] = INT_MAX;      // read last at step s - 1

        // wave w = s + 1 from waves px, wo1, wo2 (H), pe1 (E1/F1) and
        // pe2 (E2/F2) back
        const int hn = slot_next(hs, dh), e1n = slot_next(e1s, de1);
        const int e2n = slot_next(e2s, de2);
        const int16_t *Hx = H + slot_back(hn, px, dh) * RS;
        const int16_t *Ho1 = H + slot_back(hn, wo1, dh) * RS;
        const int16_t *Ho2 = H + slot_back(hn, wo2, dh) * RS;
        const int16_t *E1p = E1 + slot_back(e1n, pe1, de1) * RS;
        const int16_t *F1p = F1 + slot_back(e1n, pe1, de1) * RS;
        const int16_t *E2p = E2 + slot_back(e2n, pe2, de2) * RS;
        const int16_t *F2p = F2 + slot_back(e2n, pe2, de2) * RS;
        int16_t *Hn = H + hn * RS;
        int16_t *E1n = E1 + e1n * RS, *F1n = F1 + e1n * RS;
        int16_t *E2n = E2 + e2n * RS, *F2n = F2 + e2n * RS;
        uint8_t *tbr = tb + ((size_t)s * B + b) * D;
        const int w = s + 1, *V = vpub[w & 1];
        for (int j = tid; j < D; j += NT) {
            const int dist = abs(j - d_cap);
            if (j >= w && j <= D - 1 - w && dist > w) {
                // a far cell (see the notes at the top)
                tbr[j] = (uint8_t)V[5];
                if (j < w + dh || j > D - 1 - w - dh || dist <= w + dh) {
                    Hn[j] = (int16_t)V[0];
                    E1n[j] = (int16_t)V[1];
                    F1n[j] = (int16_t)V[2];
                    E2n[j] = (int16_t)V[3];
                    F2n[j] = (int16_t)V[4];
                }
                continue;
            }
            const Cell c = wave_cell(Hx[j], Ho1[j - 1], Ho1[j + 1],
                                     Ho2[j - 1], Ho2[j + 1], E1p[j - 1],
                                     F1p[j + 1], E2p[j - 1], F2p[j + 1]);
            tbr[j] = (uint8_t)c.tb;
            Hn[j] = (int16_t)c.h;
            E1n[j] = (int16_t)c.e1;
            F1n[j] = (int16_t)c.f1;
            E2n[j] = (int16_t)c.e2;
            F2n[j] = (int16_t)c.f2;
        }
        if (tid == NT - 1)      // the plane's next wave, for step s + 1
            plane_wave(vr, slot_next(hn, dh), slot_next(e1n, de1),
                       slot_next(e2n, de2), px, po1, pe1, po2, pe2, dh, de1,
                       de2, vpub[(w + 1) & 1]);
        if (clock) mark_latest(&wave_end[fb], base);
        hs = hn;
        e1s = e1n;
        e2s = e2n;
        fb = fb == 2 ? 0 : fb + 1;
    }
    if (tid == 0) {
        score_o[b] = -1;
        endd_o[b] = 0;
        noext_o[b] = 0;
    }
    if (clock) wave_clock_out(clock, b, c_ext, c_end, c_wave, s_cap,
                              n_iter, base);
}

__global__ void __launch_bounds__(32) wfa_walk_kernel(
    const uint8_t *__restrict__ ts_g, const uint8_t *__restrict__ qs_g,
    const int32_t *__restrict__ tl_g, const int32_t *__restrict__ ql_g,
    const uint8_t *__restrict__ tb, const int32_t *__restrict__ score_g,
    const int32_t *__restrict__ endd_g, const uint8_t *__restrict__ noext_g,
    int B, int L, int S, int d_cap, int t_cap, int px, int po1, int pe1,
    int po2, int pe2, uint8_t *__restrict__ ops, int32_t *__restrict__ fi_o,
    int32_t *__restrict__ fk_o, long long *__restrict__ clock)
{
    extern __shared__ __align__(16) uint8_t smem[];
    const int b = blockIdx.x, lane = threadIdx.x;
    const long long c_start = clock ? clock64() : 0;
    const int D = 2 * d_cap + 1;
    uint8_t *st = smem, *sq = smem + seq_stride(L);
    const uint8_t *tg = ts_g + (size_t)b * L, *qg = qs_g + (size_t)b * L;
    if (((reinterpret_cast<uintptr_t>(tg) | reinterpret_cast<uintptr_t>(qg)
          | L) & 7) == 0) {             // 8 bytes a lane and a load
        const uint2 *t8 = reinterpret_cast<const uint2 *>(tg);
        const uint2 *q8 = reinterpret_cast<const uint2 *>(qg);
#pragma unroll 4
        for (int p = lane; p < L / 8; p += 32) {
            reinterpret_cast<uint2 *>(st)[p] = t8[p];
            reinterpret_cast<uint2 *>(sq)[p] = q8[p];
        }
    } else {
        for (int p = lane; p < L; p += 32) {
            st[p] = tg[p];
            sq[p] = qg[p];
        }
    }
    __syncwarp();
    const int sc = score_g[b];
    int i = ql_g[b] - 1, k = tl_g[b] - 1, sx = sc - 1;
    int fi = i, fk = k, t = 0, n_tb = 0;
    // lane 0 reads a tb step's cell; lanes 1-9 read, in the same round
    // trip, the nine cells the next tb step can read: (penalty, change
    // of the diagonal) of state 0; 1 and 3 (i - 1), open and extend; 2
    // and 4 (k - 1).  The match run between leaves (sx, i - k) as it is.
    const int wo1 = po1 + pe1, wo2 = po2 + pe2;
    const int mv_pen = lane == 0 ? 0 : lane == 1 ? px
        : lane <= 5 ? ((lane & 1) ? pe1 : wo1)
        : lane <= 9 ? ((lane & 1) ? pe2 : wo2) : 0;
    const int mv_dd = lane < 2 ? 0 : lane == 2 || lane == 3 || lane == 6
        || lane == 7 ? -1 : 1;
    int v = 0, x_next = 0;
    bool have_next = false;
    // no_ext_state: continue in the final row's recorded state
    int last = 0;
    if (noext_g[b] && sc > 0) {
        ++n_tb;
        last = tb[((size_t)clampi(sc - 1, 0, S - 1) * B + b) * D
                  + clampi(endd_g[b], 0, D - 1)] & 7;
    }
    while (sc >= 0 && t < t_cap) {
        if (i < 0 || k < 0) {           // out before a step: nothing moves
            fi = i;
            fk = k;
            break;
        }
        if (last == 0) {
            // the run of match steps from (k, i) down, 32 bases a round;
            // it ends at a mismatch, the sequences' start or t_cap
            const int lim = min(min(i, k) + 1, t_cap - t);
            int r = 0;
            for (;;) {
                const int u = r + lane;
                const unsigned m = __ballot_sync(
                    0xffffffffu, u >= lim || st[k - u] != sq[i - u]);
                if (m) {
                    r += __ffs(m) - 1;
                    break;
                }
                r += 32;
            }
            for (int u = lane; u < r; u += 32)
                ops[(size_t)(t + u) * B + b] = 7;
            i -= r;
            k -= r;
            t += r;
            if (i < 0 || k < 0) {
                fi = i;
                fk = k;
                break;
            }
            if (t >= t_cap) break;
            // else (k, i) mismatches: a step through the tb
        }
        ++n_tb;
        int x;
        const bool fetched = !have_next;
        if (have_next) {
            x = x_next;
            have_next = false;
        } else {
            if (lane < 10)
                v = tb[((size_t)clampi(sx - mv_pen, 0, S - 1) * B + b) * D
                       + clampi(i - k + mv_dd + d_cap, 0, D - 1)];
            x = __shfl_sync(0xffffffffu, v, 0);
        }
        const int state = last == 0 ? (x & 7) : last;
        const int ext = state > 0 ? (x >> (state + 2)) & 1 : 0;
        if (fetched && state <= 4) {    // the lane that read the next cell
            x_next = __shfl_sync(0xffffffffu, v,
                                 state == 0 ? 1 : 2 * state + ext);
            have_next = true;
        }
        const int op = state == 0 ? 8 : (state == 1 || state == 3) ? 1 : 2;
        const int stc = min(state, 4);          // the JAX gather clamps
        const int pen = stc == 0 ? px
            : stc <= 2 ? (ext ? pe1 : po1 + pe1)
            : (ext ? pe2 : po2 + pe2);
        i -= (state == 0 || state == 1 || state == 3);
        k -= (state == 0 || state == 2 || state == 4);
        sx -= pen;
        last = (state > 0 && ext == 1) ? state : 0;
        if (lane == 0) ops[(size_t)t * B + b] = (uint8_t)op;
        ++t;
        if (i < 0 || k < 0) {
            fi = i;
            fk = k;
            break;
        }
    }
    if (lane == 0) {
        fi_o[b] = fi;
        fk_o[b] = fk;
        if (clock) {
            clock[(size_t)b * WALK_CLK_N] = clock64() - c_start;
            clock[(size_t)b * WALK_CLK_N + 1] = t;
            clock[(size_t)b * WALK_CLK_N + 2] = n_tb;
        }
    }
}

// raise a kernel's dynamic shared memory limit to `bytes` on the current
// device, once a size, under a lock (the mapping threads share a card)
cudaError_t smem_limit(const void *kernel, int bytes, int *set_bytes)
{
    static std::mutex mu;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> hold(mu);
    if (dev >= MAX_DEV || bytes > set_bytes[dev]) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return err;
        if (dev < MAX_DEV) set_bytes[dev] = bytes;
    }
    return cudaSuccess;
}

}  // namespace

extern "C" int mgt_cuda_wfa_wave(
    const uint8_t *ts, const uint8_t *qs, const int32_t *tl,
    const int32_t *ql, int B, int L, int d_cap, int s_cap, int px, int po1,
    int pe1, int po2, int pe2, int dh, int de1, int de2, uint8_t *tb,
    int32_t *score, int32_t *end_d, uint8_t *no_ext, long long *clock,
    cudaStream_t stream)
{
    // the wrapper refuses these first (ops/wfa_exact.py ring16_bytes)
    if (B < 0 || L < 1 || d_cap < 0 || s_cap < 0 || px < 1 || pe1 < 1
        || pe2 < 1 || po1 < 0 || po2 < 0 || dh < 2 || de1 < 2 || de2 < 2
        || L + s_cap > 32767)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    static int set_bytes[MAX_DEV];
    const int D = 2 * d_cap + 1;
    const int rows = dh + 2 * de1 + 2 * de2;
    const size_t smem = (size_t)rows * ring_stride(D) * 2
        + 2 * (size_t)seq_stride(L) + 2 * rows;
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    const cudaError_t err = smem_limit((const void *)wfa_wave_kernel,
                                       (int)smem, set_bytes);
    if (err != cudaSuccess) return (int)err;
    wfa_wave_kernel<<<B, NT, smem, stream>>>(
        ts, qs, tl, ql, B, L, d_cap, s_cap, px, po1, pe1, po2, pe2, dh, de1,
        de2, tb, score, end_d, no_ext, clock);
    return (int)cudaGetLastError();
}

extern "C" int mgt_cuda_wfa_walk(
    const uint8_t *ts, const uint8_t *qs, const int32_t *tl,
    const int32_t *ql, const uint8_t *tb, const int32_t *score,
    const int32_t *end_d, const uint8_t *no_ext, int B, int L, int S,
    int d_cap, int t_cap, int px, int po1, int pe1, int po2, int pe2,
    uint8_t *ops, int32_t *fin_i, int32_t *fin_k, long long *clock,
    cudaStream_t stream)
{
    if (B < 0 || L < 1 || S < 1 || d_cap < 0 || t_cap < 0)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    static int set_bytes[MAX_DEV];
    const size_t smem = 2 * (size_t)seq_stride(L);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    const cudaError_t err = smem_limit((const void *)wfa_walk_kernel,
                                       (int)smem, set_bytes);
    if (err != cudaSuccess) return (int)err;
    wfa_walk_kernel<<<B, 32, smem, stream>>>(
        ts, qs, tl, ql, tb, score, end_d, no_ext, B, L, S, d_cap, t_cap, px,
        po1, pe1, po2, pe2, ops, fin_i, fin_k, clock);
    return (int)cudaGetLastError();
}
