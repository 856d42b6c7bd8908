// Equality-join probe with payload extraction: the bucketed probe and
// the flat probe of the batched map step.
//
// Replaces the Pallas kernels minigraph_tpu/ops/probe_pallas.py
// _make_kernel (probe_bucketed_pallas) and _make_flat_kernel
// (probe_flat_traced), and is held against the plain PyTorch versions
// ops/probe.py probe_bucketed_ref / probe_flat_ref.  The flat probe is
// the bucketed one with a single bucket, so both C entry points launch
// the same kernels.
//
// The function: query slot n of bucket v carries 9 features q (sQ,
// plane-major); key k of the bucket carries a column km[v, :, k] of the
// join matrix and a payload column ke[v, :, k].  The distance
// D = sum_f km[f] q[f] is zero exactly when the slot's minimizer equals
// the key, and the output column is the sum of the payload columns of
// the keys with D == 0.  Keys are unique in a bucket, so a present slot
// matches at most one key and its output is exact.  An empty slot of
// the spread grid has all-zero features, so it matches every key of its
// bucket, padding included, and its output is the bucket's payload
// column sum.
//
// Exactness of the fused form: the features are 9-bit limbs, their
// squares and +-1 (ops/anchors.py join_features, flat_queries), the key
// columns 1, -2*limb and the sum of the squared limbs, so every product
// and every partial sum of D, in feature order, is an integer below 2^24
// (tests/test_torch_probe.py checks this on real tables).  A fused
// multiply-add then rounds nothing, and D is the same integer as the
// separately rounded sum: the FMAs are spelled out (__fmaf_rn) because
// the library builds with --fmad=false.
//
// What bounds it on an H100: the 9-term distances, 18 operations (9
// FMAs) per (present slot, key) pair; at the step's shapes that is more
// time at the float32 peak than moving the tables and the output once.
// So the design keeps the FMA pipes fed: each key read from shared
// memory feeds the R slots a thread holds in registers, and no load,
// index or branch other than the rare match sits between the FMAs.
//
// Design, four steps per call, all on the caller's stream:
//  1. colsum: one block per (bucket, payload row) sums the row in
//     double.  The payload values are integers below 2^24 and a bucket
//     holds far fewer than 2^29 keys, so the double sum is exact and
//     the one rounding to float gives the correctly rounded sum.
//  2. the per-bucket present counts are zeroed (cudaMemsetAsync).
//  3. compact: one thread per (bucket, slot).  An all-zero slot is
//     written from the column sums; a present slot is appended to its
//     bucket's list (one atomic per warp; the order is free, since a
//     slot's output depends on no other slot).
//  4. probe: one block of S = 4 warps per (bucket, tile of TILE = 128
//     listed slots).  Every warp holds the tile's slots, R = 4 a lane
//     with their 9 features in registers, and compares them with its
//     quarter of each chunk of keys, so a bucket of ~1800 present slots
//     (the bucketed probe) still gives ~56 warps of work.  Blocks are
//     numbered tile-major over the buckets, so the busy ones (the low
//     tiles) are dispatched first and spread evenly over the SMs.  The
//     bucket's key matrix streams through shared memory in chunks of KC
//     keys, key major (KSTRIDE floats a key: two 16-byte and one 4-byte
//     broadcast load per key), double-buffered with cp.async so that
//     chunk c+1 lands while chunk c is compared.  U keys x R slots give
//     16 independent FMA chains a thread and share one match test (the
//     least |D|), so a pair costs about 11 issued instructions for its
//     9 FMAs.  Unused register slots and keys past KB hold NaN features,
//     which match nothing.  A match only records its key; after the key
//     loop the warps pool what they found per slot and write zeros, the
//     one matched key's payload column (all of its loads in flight at
//     once), or, for a slot that matched several keys, the payloads
//     summed in key order by a rescan of the bucket.  The two products
//     of the TPU kernel are these loops; no library product is called.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 9;              // join features
constexpr int THREADS = 256;       // threads per colsum / compact block
constexpr int S = 4;               // warps per probe block: key quarters
constexpr int PROBE_THREADS = 32 * S;
constexpr int R = 4;               // present slots per probe thread
constexpr int TILE = 32 * R;       // present slots per probe block
constexpr int KC = 256;            // keys per shared-memory chunk
constexpr int U = 4;               // keys per match test (KC % U == 0)
constexpr int KSTRIDE = 12;        // floats per key in shared memory
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void colsum_kernel(const float *__restrict__ ke, int KB,
                              float *__restrict__ cs)
{
    const int64_t row = blockIdx.x;             // bucket * EXT + e
    const float *r = ke + row * KB;
    double s = 0.0;
    for (int k = threadIdx.x; k < KB; k += blockDim.x) s += (double)r[k];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    __shared__ double part[32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) part[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        double t = 0.0;
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += part[w];
        cs[row] = __double2float_rn(t);
    }
}

// column of slot n (of B * qb) of bucket v in the (., B, SB) planes
__device__ __forceinline__ int64_t slot_col(int64_t n, int v, int SB, int qb)
{
    const int64_t b = n / qb;
    return b * SB + (int64_t)v * qb + (n - b * qb);
}

__global__ void compact_kernel(const float *__restrict__ sq,
                               const float *__restrict__ cs,
                               float *__restrict__ out, int *count,
                               int *__restrict__ list, int B, int SB,
                               int qb, int EXT)
{
    const int v = blockIdx.y;
    const int64_t plane = (int64_t)B * SB;
    const int64_t n_slots = (int64_t)B * qb;
    const int64_t n = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    bool present = false;
    if (n < n_slots) {
        const int64_t col = slot_col(n, v, SB, qb);
        bool zero = true;
#pragma unroll
        for (int f = 0; f < NF; ++f)
            zero = zero && sq[f * plane + col] == 0.0f;
        if (zero) {
            for (int e = 0; e < EXT; ++e)
                out[e * plane + col] = cs[(int64_t)v * EXT + e];
        }
        present = !zero;
    }
    const unsigned ball = __ballot_sync(FULL, present);
    if (ball == 0) return;                      // the whole warp
    const int lane = threadIdx.x & 31, leader = __ffs(ball) - 1;
    int at = 0;
    if (lane == leader) at = atomicAdd(count + v, __popc(ball));
    at = __shfl_sync(FULL, at, leader);
    if (present)
        list[(int64_t)v * n_slots + at + __popc(ball & ((1u << lane) - 1u))]
            = (int)n;
}

// chunk of keys [k0, k0 + KC) of one bucket's (9, KB) key matrix into
// dst[key][feature] with 4-byte cp.async; keys past KB get NaN features,
// which match no slot, so every chunk is KC keys long
__device__ __forceinline__ void load_chunk(float *dst,
                                           const float *__restrict__ kmv,
                                           int KB, int k0)
{
    for (int k = threadIdx.x; k < KC; k += PROBE_THREADS) {
        float *row = dst + k * KSTRIDE;
        if (k0 + k < KB) {
            const unsigned d = (unsigned)__cvta_generic_to_shared(row);
            const float *src = kmv + k0 + k;
#pragma unroll
            for (int f = 0; f < NF; ++f)
                asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                             :: "r"(d + 4u * f), "l"(src + (int64_t)f * KB));
        } else {
#pragma unroll
            for (int f = 0; f < NF; ++f) row[f] = __int_as_float(0x7FC00000);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// out column po += payload column pk, row by row (po = 0 + pk if first)
__device__ __forceinline__ void add_payload(float *po, int64_t plane,
                                            const float *pk, int KB, int EXT,
                                            bool first)
{
#pragma unroll 5
    for (int e = 0; e < EXT; ++e) {
        const float x = __ldg(pk + (int64_t)e * KB);
        po[e * plane] = __fadd_rn(first ? 0.0f : po[e * plane], x);
    }
}

// D of one slot against key column k, in feature order
__device__ __forceinline__ float distance(const float *q,
                                          const float *__restrict__ kmv,
                                          int KB, int k)
{
    float x = __fmul_rn(__ldg(kmv + k), q[0]);
#pragma unroll
    for (int f = 1; f < NF; ++f)
        x = __fmaf_rn(__ldg(kmv + (int64_t)f * KB + k), q[f], x);
    return x;
}

__global__ void __launch_bounds__(PROBE_THREADS)
probe_kernel(const float *__restrict__ sq, const float *__restrict__ km,
             const float *__restrict__ ke, const int *__restrict__ count,
             const int *__restrict__ list, float *__restrict__ out, int B,
             int SB, int qb, int KB, int EXT, int nb)
{
    __shared__ __align__(16) float keys[2][KC * KSTRIDE];
    __shared__ int hits[S][TILE];
    // tile-major over the buckets: the busy blocks (low tiles) are
    // dispatched first and spread evenly over the SMs
    const int v = (int)(blockIdx.x % nb);
    const int n_present = count[v];
    const int t0 = (int)(blockIdx.x / nb) * TILE;
    if (t0 >= n_present) return;                // the whole block
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t plane = (int64_t)B * SB;
    const int64_t n_slots = (int64_t)B * qb;
    const int *lv = list + (int64_t)v * n_slots;
    const float *kmv = km + (int64_t)v * NF * KB;
    const float *kev = ke + (int64_t)v * EXT * KB;
    const int n_chunks = (KB + KC - 1) / KC;
    load_chunk(keys[0], kmv, KB, 0);

    // every warp holds the tile's slots; warp w compares them with the
    // keys [w * KC / S, (w + 1) * KC / S) of each chunk
    float q[R][NF];
    int64_t col[R];            // -1: no slot
    int hit[R];                // this warp's one match, -1 none, -2 several
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int at = t0 + r * 32 + lane;
        col[r] = -1;
        hit[r] = -1;
        if (at < n_present) {
            col[r] = slot_col(lv[at], v, SB, qb);
#pragma unroll
            for (int f = 0; f < NF; ++f) q[r][f] = sq[f * plane + col[r]];
        } else {
#pragma unroll
            for (int f = 0; f < NF; ++f) q[r][f] = __int_as_float(0x7FC00000);
        }
    }

    for (int c = 0; c < n_chunks; ++c) {
        if (c + 1 < n_chunks) {
            load_chunk(keys[(c + 1) & 1], kmv, KB, (c + 1) * KC);
            asm volatile("cp.async.wait_group 1;\n" ::);
        } else {
            asm volatile("cp.async.wait_group 0;\n" ::);
        }
        __syncthreads();                        // chunk c has landed
        const float *s = keys[c & 1];
        const int k0 = c * KC;
        for (int kk = warp * (KC / S); kk < (warp + 1) * (KC / S); kk += U) {
            float d[U][R];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const float *kr = s + (kk + u) * KSTRIDE;
                const float4 a = *reinterpret_cast<const float4 *>(kr);
                const float4 b = *reinterpret_cast<const float4 *>(kr + 4);
                const float z = kr[8];
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    float x = __fmul_rn(a.x, q[r][0]);
                    x = __fmaf_rn(a.y, q[r][1], x);
                    x = __fmaf_rn(a.z, q[r][2], x);
                    x = __fmaf_rn(a.w, q[r][3], x);
                    x = __fmaf_rn(b.x, q[r][4], x);
                    x = __fmaf_rn(b.y, q[r][5], x);
                    x = __fmaf_rn(b.z, q[r][6], x);
                    x = __fmaf_rn(b.w, q[r][7], x);
                    d[u][r] = __fmaf_rn(z, q[r][8], x);
                }
            }
            // one test for U keys x R slots: the least |D| (fminf skips
            // the NaN of unused slots and padding keys)
            float mu[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
                mu[u] = fminf(fminf(fabsf(d[u][0]), fabsf(d[u][1])),
                              fminf(fabsf(d[u][2]), fabsf(d[u][3])));
            const float m = fminf(fminf(mu[0], mu[1]), fminf(mu[2], mu[3]));
            if (m != 0.0f) continue;
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int r = 0; r < R; ++r)
                    if (d[u][r] == 0.0f)
                        hit[r] = hit[r] == -1 ? k0 + kk + u : -2;
        }
        __syncthreads();                        // buffer c & 1 is free
    }
#pragma unroll
    for (int r = 0; r < R; ++r) hits[warp][r * 32 + lane] = hit[r];
    __syncthreads();
    // warp w writes the slots r == w (mod S) of every lane: a single
    // match's payload column, zeros, or for a slot that matched several
    // keys the in-order sum of their payloads (a rescan of the bucket)
    for (int r = warp; r < R; r += S) {
        const int at = t0 + r * 32 + lane;
        if (at >= n_present) continue;
        const int64_t cl = slot_col(lv[at], v, SB, qb);
        int one = -1, n_hit = 0;
        for (int w = 0; w < S; ++w) {
            const int h = hits[w][r * 32 + lane];
            n_hit += h >= 0 ? 1 : h == -2 ? 2 : 0;
            if (h >= 0) one = h;
        }
        if (n_hit == 0) {
            for (int e = 0; e < EXT; ++e) out[e * plane + cl] = 0.0f;
        } else if (n_hit == 1) {
            add_payload(out + cl, plane, kev + one, KB, EXT, true);
        } else {
            float qs[NF];
#pragma unroll
            for (int f = 0; f < NF; ++f) qs[f] = sq[f * plane + cl];
            bool first = true;
            for (int k = 0; k < KB; ++k) {
                if (distance(qs, kmv, KB, k) != 0.0f) continue;
                add_payload(out + cl, plane, kev + k, KB, EXT, first);
                first = false;
            }
        }
    }
}

int run(const float *sq, const float *km, const float *ke, int B, int SB,
        int nb, int KB, int EXT, float *colsum, int *work, float *out,
        cudaStream_t stream)
{
    if (B < 0 || nb < 1 || nb > 65535 || SB < 0 || SB % nb || KB < 1
        || EXT < 1)
        return (int)cudaErrorInvalidValue;
    if (B == 0 || SB == 0) return (int)cudaSuccess;
    // slot indices and the block count fit an int
    if ((int64_t)B * SB >= ((int64_t)1 << 31))
        return (int)cudaErrorInvalidValue;
    const int qb = SB / nb;
    const int64_t n_slots = (int64_t)B * qb;
    int *count = work, *list = work + nb;
    colsum_kernel<<<(unsigned)(nb * EXT), THREADS, 0, stream>>>(ke, KB,
                                                                colsum);
    cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * nb, stream);
    if (err != cudaSuccess) return (int)err;
    compact_kernel<<<dim3((unsigned)((n_slots + THREADS - 1) / THREADS),
                          (unsigned)nb), THREADS, 0, stream>>>(
        sq, colsum, out, count, list, B, SB, qb, EXT);
    probe_kernel<<<(unsigned)((n_slots + TILE - 1) / TILE * nb),
                   PROBE_THREADS, 0, stream>>>(
        sq, km, ke, count, list, out, B, SB, qb, KB, EXT, nb);
    return (int)cudaGetLastError();
}

}  // namespace

// sq (9, B, nb*qb), km (nb, 9, KB), ke (nb, EXT, KB) -> out (EXT, B, nb*qb);
// colsum is (nb, EXT) float scratch, work (nb + nb*B*qb) int32 scratch
extern "C" int mgt_cuda_probe_bucketed(
    const float *sq, const float *km, const float *ke, int B, int SB, int nb,
    int KB, int EXT, float *colsum, int *work, float *out,
    cudaStream_t stream)
{
    return run(sq, km, ke, B, SB, nb, KB, EXT, colsum, work, out, stream);
}

// sq (9, B, qcap), km (9, Kpad), ke (EXT, Kpad) -> out (EXT, B, qcap);
// colsum is (EXT,) float scratch, work (1 + B*qcap) int32 scratch
extern "C" int mgt_cuda_probe_flat(
    const float *sq, const float *km, const float *ke, int B, int qcap,
    int Kpad, int EXT, float *colsum, int *work, float *out,
    cudaStream_t stream)
{
    return run(sq, km, ke, B, qcap, 1, Kpad, EXT, colsum, work, out, stream);
}
