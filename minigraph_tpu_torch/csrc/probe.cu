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
// the key (every value is an integer below 2^24, so D is exact in
// float32 in any order), and the output column is the sum of the
// payload columns of the keys with D == 0.  Keys are unique in a
// bucket, so a present slot matches at most one key and its output is
// exact.  An empty slot of the spread grid has all-zero features, so it
// matches every key of its bucket, padding included, and its output is
// the bucket's payload column sum.
//
// What bounds it on an H100: the 9-term distances, ~20 operations per
// (present slot, key) pair; at the step's shapes that is more time at
// the float32 peak than moving the tables and the output once.
//
// Design, two kernels per call:
//  1. colsum: one block per (bucket, payload row) sums the row in
//     double.  The payload values are integers below 2^24 and a bucket
//     holds far fewer than 2^29 keys, so the double sum is exact and
//     the one rounding to float gives the correctly rounded sum.
//  2. probe: one block per (bucket, tile of 256 query slots).  Each
//     thread loads its slot's features; an all-zero slot is written
//     from the column sums at once, and the block packs the present
//     slots into the first threads through a shared-memory list, so
//     only warps that hold a present slot walk the bucket's keys (the
//     key columns are read through the read-only cache: every lane of
//     a warp reads the same key, one broadcast load per feature).  A
//     match adds the key's payload column to the slot's output in key
//     order.  The two products of the TPU kernel are these loops; no
//     library product is called.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 9;          // join features
constexpr int TILE = 256;      // query slots per block

__global__ void colsum_kernel(const float *__restrict__ ke, int KB,
                              float *__restrict__ cs)
{
    const int64_t row = blockIdx.x;             // bucket * EXT + e
    const float *r = ke + row * KB;
    double s = 0.0;
    for (int k = threadIdx.x; k < KB; k += blockDim.x) s += (double)r[k];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
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

__global__ void probe_kernel(const float *__restrict__ sq,
                             const float *__restrict__ km,
                             const float *__restrict__ ke,
                             const float *__restrict__ cs,
                             float *__restrict__ out, int B, int SB, int qb,
                             int KB, int EXT)
{
    __shared__ int list[TILE];
    __shared__ int n_present;
    const int v = blockIdx.y;
    const int64_t plane = (int64_t)B * SB;
    const int64_t n_slots = (int64_t)B * qb;
    if (threadIdx.x == 0) n_present = 0;
    __syncthreads();
    const int64_t n = (int64_t)blockIdx.x * TILE + threadIdx.x;
    if (n < n_slots) {
        const int64_t b = n / qb;
        const int64_t col = b * SB + (int64_t)v * qb + (n - b * qb);
        bool zero = true;
#pragma unroll
        for (int f = 0; f < NF; ++f) zero = zero && sq[f * plane + col] == 0.0f;
        if (zero) {
            for (int e = 0; e < EXT; ++e)
                out[e * plane + col] = cs[(int64_t)v * EXT + e];
        } else {
            list[atomicAdd(&n_present, 1)] = (int)threadIdx.x;
        }
    }
    __syncthreads();
    if ((int)threadIdx.x >= n_present) return;
    const int64_t m = (int64_t)blockIdx.x * TILE + list[threadIdx.x];
    const int64_t b = m / qb;
    const int64_t col = b * SB + (int64_t)v * qb + (m - b * qb);
    float q[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) q[f] = sq[f * plane + col];
    for (int e = 0; e < EXT; ++e) out[e * plane + col] = 0.0f;
    const float *kmv = km + (int64_t)v * NF * KB;
    const float *kev = ke + (int64_t)v * EXT * KB;
    for (int k = 0; k < KB; ++k) {
        float d = 0.0f;
#pragma unroll
        for (int f = 0; f < NF; ++f)
            d = __fadd_rn(d, __fmul_rn(__ldg(kmv + (int64_t)f * KB + k), q[f]));
        if (d == 0.0f) {
            for (int e = 0; e < EXT; ++e)
                out[e * plane + col] = __fadd_rn(out[e * plane + col],
                                                 __ldg(kev + (int64_t)e * KB + k));
        }
    }
}

int run(const float *sq, const float *km, const float *ke, int B, int SB,
        int nb, int KB, int EXT, float *colsum, float *out,
        cudaStream_t stream)
{
    if (B < 0 || nb < 1 || SB < 0 || SB % nb || KB < 1 || EXT < 1)
        return (int)cudaErrorInvalidValue;
    if (B == 0 || SB == 0) return (int)cudaSuccess;
    const int qb = SB / nb;
    colsum_kernel<<<(unsigned)(nb * EXT), 256, 0, stream>>>(ke, KB, colsum);
    const int64_t n_slots = (int64_t)B * qb;
    const dim3 grid((unsigned)((n_slots + TILE - 1) / TILE), (unsigned)nb);
    probe_kernel<<<grid, TILE, 0, stream>>>(sq, km, ke, colsum, out, B, SB,
                                            qb, KB, EXT);
    return (int)cudaGetLastError();
}

}  // namespace

// sq (9, B, nb*qb), km (nb, 9, KB), ke (nb, EXT, KB) -> out (EXT, B, nb*qb);
// colsum is (nb, EXT) scratch
extern "C" int mgt_cuda_probe_bucketed(
    const float *sq, const float *km, const float *ke, int B, int SB, int nb,
    int KB, int EXT, float *colsum, float *out, cudaStream_t stream)
{
    return run(sq, km, ke, B, SB, nb, KB, EXT, colsum, out, stream);
}

// sq (9, B, qcap), km (9, Kpad), ke (EXT, Kpad) -> out (EXT, B, qcap);
// colsum is (EXT,) scratch
extern "C" int mgt_cuda_probe_flat(
    const float *sq, const float *km, const float *ke, int B, int qcap,
    int Kpad, int EXT, float *colsum, float *out, cudaStream_t stream)
{
    return run(sq, km, ke, B, qcap, 1, Kpad, EXT, colsum, out, stream);
}
