// Whole minimizer sketch to position-aligned planes, one launch.
//
// Replaces the Pallas kernel minigraph_tpu/ops/sketch_pallas.py
// _make_kernel (called through sketch_planes_pallas_traced) and is held
// bitwise against the plain PyTorch version ops/sketch.py
// sketch_planes_ref (a port of ops/sketch_jax4.py sketch_planes).
//
// What bounds it on an H100: the bytes.  The kernel reads one byte per
// base and writes six plane words per slot (int64 words holding u32
// values, the port's convention: ~49 B a slot, ~25 MB for a 256 x 2 kb
// batch, ~7.5 us at HBM rate); the work is ~40 integer operations a
// base for the k-mer and the 64-bit hash plus ~2w compares for the two
// window minima and the tie rules.
//
// Design: one thread a slot, one block a (read, S-slot tile), with no
// state carried between slots.  Every quantity the emission rules read
// is local, as in the TPU kernel: the run length l of valid bases is
// only used clamped to w + k, the k-mer needs the last k bases, and the
// window minima at t and t - 1 need the events t - w .. t.  So a block
//  1. stages the bases [p0 - H, p0 + S), H = w + k + 1, in shared memory
//     (one coalesced byte load a base; positions outside [0, n_len) and
//     codes >= 4 staged as 4, invalid);
//  2. computes the event (hash << 8 | span, meta) of each slot of the
//     tile and of the w positions before it from the staged bases, one
//     thread each, into shared memory;
//  3. per slot, takes the newest minimum M' of the events t - w + 1 ..
//     t - 1 in one pass of w - 1 compares, and from it the minima at t
//     (event t against M') and at t - 1 (M' against event t - w): ties
//     go to the newer event, as the reference's scan;
//  4. applies the emission and tie rules of sketch_planes_ref (the end
//     of read at slot n_len, the widening slot L included) and stores the
//     six planes coalesced, neighbouring threads on neighbouring slots;
//  5. sums the read's emissions and ORs its overflow within the block,
//     one integer atomic each a block (order-independent).
// No array is indexed at run time outside shared memory, so nothing
// lands in a local-memory stack frame.  The 64-bit hash is native
// uint64 arithmetic (the TPU kernel needed (hi, lo) u32 pairs).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S = 256;           // slots a block, one a thread
constexpr int MAXW = 32;
constexpr int MAXK = 27;
constexpr int MAXH = MAXW + MAXK + 1;
constexpr uint64_t EMPTY = (1ull << 62) | 0xFFull;   // ops/sketch.py _EMPTY
constexpr uint32_t UMAX = 0xFFFFFFFFu;
constexpr int META_Q_BITS = 25;

__device__ __forceinline__ uint64_t hash64(uint64_t key, uint64_t mask)
{
    key = (~key + (key << 21)) & mask;
    key = key ^ (key >> 24);
    key = (key + (key << 3) + (key << 8)) & mask;
    key = key ^ (key >> 14);
    key = (key + (key << 2) + (key << 4)) & mask;
    key = key ^ (key >> 28);
    key = (key + (key << 31)) & mask;
    return key;
}

__device__ __forceinline__ void put(int64_t *hh, int64_t *hl, int64_t *mm,
                                    int64_t o, uint64_t x, uint32_t m)
{
    if (m == UMAX) {
        hh[o] = UMAX; hl[o] = UMAX; mm[o] = UMAX;
    } else {
        const uint64_t h = x >> 8;
        hh[o] = (int64_t)(h >> 32);
        hl[o] = (int64_t)(h & 0xFFFFFFFFull);
        mm[o] = (int64_t)m;
    }
}

// the event at position q, staged at sb[e]: l = the valid bases ending
// at q, clamped to lmax (>= k)
__device__ __forceinline__ void event(const uint8_t *sb, int e, int q, int k,
                                      int lmax, uint64_t mask, uint64_t &x,
                                      uint32_t &m, int &l)
{
    uint64_t kf = 0, kr = 0;
    int run = 0;
    for (; run < lmax; ++run) {
        const uint32_t c = sb[e - run];
        if (c >= 4) break;
        if (run < k) {
            kf |= (uint64_t)c << (2 * run);
            kr |= (uint64_t)(3u ^ c) << (2 * (k - 1 - run));
        }
    }
    l = run;
    if (run >= k) {
        const bool z = kf >= kr;
        const uint64_t h = hash64(z ? kr : kf, mask);
        x = (h << 8) | (uint64_t)k;            // span = min(l, k) = k
        m = ((uint32_t)k << (META_Q_BITS + 1)) | ((uint32_t)q << 1)
            | (uint32_t)z;
    } else {
        x = EMPTY;
        m = UMAX;
    }
}

__global__ void __launch_bounds__(S)
sketch_kernel(const uint8_t *__restrict__ codes,
              const int32_t *__restrict__ lens, int L, int w, int k,
              int ntile, int64_t *hh, int64_t *hl, int64_t *meta,
              int64_t *thh, int64_t *thl, int64_t *tmeta, int32_t *n_out,
              int32_t *ovf_out)
{
    __shared__ uint8_t sb[MAXH + S];        // bases [p0 - H, p0 + S)
    __shared__ uint64_t sx[MAXW + S];       // events [p0 - w, p0 + S)
    __shared__ uint32_t sm[MAXW + S];
    __shared__ int red[2 * (S / 32)];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x / ntile;
    const int p0 = (blockIdx.x % ntile) * S;
    const int H = w + k + 1, wk = w + k;
    const int n_len = lens[b];
    const uint8_t *row = codes + (int64_t)b * L;
    const uint64_t mask = (1ull << (2 * k)) - 1;

    for (int e = tid; e < H + S; e += S) {
        const int q = p0 - H + e;
        uint32_t c = 4;
        if (q >= 0 && q < n_len && q < L) c = row[q];
        sb[e] = c < 4 ? (uint8_t)c : (uint8_t)4;
    }
    __syncthreads();

    const int t = p0 + tid;              // this thread's slot
    uint64_t ex;
    uint32_t em;
    int l;
    event(sb, H + tid, t, k, wk, mask, ex, em, l);
    sx[w + tid] = ex;
    sm[w + tid] = em;
    if (tid < w) {                       // the w positions before the tile
        uint64_t x;
        uint32_t m;
        int l2;
        event(sb, H - w + tid, p0 - w + tid, k, k, mask, x, m, l2);
        sx[tid] = x;
        sm[tid] = m;
    }
    __syncthreads();

    // event j of this slot's windows sits at sx[tid + j], position
    // t - w + j: the window at t is j = 1 .. w, the one at t - 1 j = 0 ..
    // w - 1.  M' = the newest minimum of j = 1 .. w - 1 (EMPTY sorts
    // last, so the first compare always takes).
    uint64_t mx = EMPTY;
    int mj = -1;
    for (int j = 1; j < w; ++j) {
        const uint64_t x = sx[tid + j];
        if (x <= mx) { mx = x; mj = j; }
    }
    const bool cur_new = ex <= mx;       // the window minimum at t
    const uint64_t m_x = cur_new ? ex : mx;
    const int m_j = cur_new ? w : mj;
    const uint64_t x0 = sx[tid];         // the window minimum at t - 1
    const bool prev_old = mj < 0 || x0 < mx;
    const uint64_t pm_x = prev_old ? x0 : mx;
    const int pm_j = prev_old ? 0 : mj;
    const uint32_t m_m = sm[tid + m_j], pm_m = sm[tid + pm_j];

    const bool in_range = t < n_len;
    const bool pmv_ok = pm_x != EMPTY;
    uint32_t o_m = UMAX;                 // main plane: pm_x, or empty
    uint64_t t_x = EMPTY;                // tie plane
    uint32_t t_m = UMAX;
    int cnt = 0, flag = 0;
    if (t == n_len) {
        // end-of-read emission parked at slot n_len (slot L when the read
        // fills the batch width)
        const bool fin_ok = n_len > 0 && pmv_ok;
        if (fin_ok) o_m = pm_m;
        cnt = fin_ok;
    } else if (in_range) {
        const bool A = ex <= pm_x;
        const bool Bc = !A && pm_j == 0;     // the old minimum left
        const bool emitA = A && l >= wk && pmv_ok;
        const bool emitB = Bc && l >= wk - 1 && pmv_ok;
        const bool b_base = Bc && l >= wk - 1 && m_x != EMPTY;
        const bool fw = l == wk - 1 && pmv_ok;
        int tie_n = 0;
        bool tie_fw = false;
        if (fw || b_base) {
            // the first-window fold scans the w - 1 newest events of the
            // window at t - 1 against its minimum; b_base the window at t
            for (int j = 1; j <= w; ++j) {
                const uint64_t x = sx[tid + j];
                const uint32_t m = sm[tid + j];
                if (j < w && fw && x == pm_x && m != pm_m) {
                    if (tie_n == 0) { t_x = x; t_m = m; }
                    ++tie_n;
                    tie_fw = true;
                }
                if (b_base && x == m_x && m != m_m) {
                    if (tie_n == 0) { t_x = x; t_m = m; }
                    ++tie_n;
                }
            }
        }
        const bool main_emit = emitA || emitB;
        if (main_emit) o_m = pm_m;
        cnt = (int)main_emit + (tie_n > 0);
        flag = (tie_n > 1) || (tie_fw && main_emit);
    }
    if (t <= L) {
        const int64_t o = (int64_t)b * (L + 1) + t;
        put(hh, hl, meta, o, pm_x, o_m);
        put(thh, thl, tmeta, o, t_x, t_m);
    }

    cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
    flag = (int)__reduce_or_sync(0xFFFFFFFFu, (unsigned)flag);
    if (lane == 0) { red[warp] = cnt; red[S / 32 + warp] = flag; }
    __syncthreads();
    if (tid == 0) {
        int c = 0, fl = 0;
        for (int i = 0; i < S / 32; ++i) { c += red[i]; fl |= red[S / 32 + i]; }
        if (c) atomicAdd(n_out + b, c);
        if (fl) atomicOr(ovf_out + b, 1);
    }
}

}  // namespace

extern "C" int mgt_cuda_sketch_planes(
    const uint8_t *codes, const int32_t *lens, int B, int L, int w, int k,
    int64_t *hh, int64_t *hl, int64_t *meta, int64_t *thh, int64_t *thl,
    int64_t *tmeta, int32_t *n_out, int32_t *ovf_out, cudaStream_t stream)
{
    if (w < 1 || w > MAXW || k < 1 || k > MAXK || B < 0 || L < 0)
        return (int)cudaErrorInvalidValue;
    const int ntile = (L + 1 + S - 1) / S;   // slots 0 .. L
    const int64_t nblocks = (int64_t)B * ntile;
    if (nblocks == 0) return (int)cudaSuccess;
    if (nblocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    sketch_kernel<<<(unsigned)nblocks, S, 0, stream>>>(
        codes, lens, L, w, k, ntile, hh, hl, meta, thh, thl, tmeta, n_out,
        ovf_out);
    return (int)cudaGetLastError();
}
