// All-pairs coverage-overlap counts of `compare`: the Hopper port of
// instrain_tpu/kernels/compare.py:_overlap_counts_device (:38-48).
//
// Input: N samples' bit-packed coverage masks, uint64 words [N, Mg, W]
// (64 positions a word, the bits past L zero). Output: both[m, i, j] =
// popcount(t_i & t_j) over the positions and single[m, i] = popcount(t_i),
// int64 (unsigned long long bits), zeroed by the wrapper.
//
// The JAX version unpacks the bits to bf16 and lets the MXU compute the
// Gram matrix einsum("nml,kml->mnk") with f32 sums, chunking the position
// axis at 2^22 to keep them exact. Here the natural primitive is integer
// AND + __popcll on the packed words, exact for any L: there is no
// position chunking.
//
// One block per (mm level, slab of kSlab words), looping over the slabs
// blockIdx.y, blockIdx.y + gridDim.y, ... It stages the slab's words of all
// N samples in shared memory, transposed ([word][sample]) so that the
// threads of a warp, which hold neighbouring pairs (i, j), (i, j + 1), ...,
// read neighbouring words. Each thread owns up to kPairsPerThread of the
// N(N+1)/2 pairs i <= j and sums their counts in 64-bit registers over
// all of its block's slabs; at the end each pair's count goes to both[m,
// i, j] and both[m, j, i] (or, on the diagonal, to both[m, i, i] and
// single[m, i]) with one atomicAdd on unsigned long long. The counts are
// integers, so the order of the atomics does not change the result.
//
// Bound: integer operations. The kernel reads N * Mg * W * 8 bytes once
// and does N(N+1)/2 * Mg * W 64-bit AND + popcount (two 32-bit POPC each,
// which issue at 16 per clock per SM on cc 9.0, against 64 for the AND and
// the add); from N = 2 on the popcounts outlast the bytes at 3.35 TB/s.
// The design keeps the popcounts the only per-word work: the words come
// from shared memory (each is loaded from device memory once per block),
// and the sums stay in registers until one atomic per pair and block.
// Threads past N(N+1)/2 pairs idle (at N = 16, 120 of 256): a later
// version could split the slab among them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlab = 32;        // words of one sample per staged slab
constexpr int kMaxN = 64;
constexpr int kPairsPerThread =
    (kMaxN * (kMaxN + 1) / 2 + kThreads - 1) / kThreads;   // 9

__global__ void __launch_bounds__(kThreads)
overlap_counts_kernel(const unsigned long long* __restrict__ words, int N,
                      int Mg, long long W,
                      unsigned long long* __restrict__ both,
                      unsigned long long* __restrict__ single) {
    __shared__ unsigned long long sh[kSlab * kMaxN];      // [word][sample]
    const int m = blockIdx.x;
    const int n_pairs = N * (N + 1) / 2;

    // this thread's pairs (i <= j), in row-major order of the upper
    // triangle: pair p = threadIdx.x + q * kThreads
    int pi[kPairsPerThread], pj[kPairsPerThread];
    unsigned long long acc[kPairsPerThread];
#pragma unroll
    for (int q = 0; q < kPairsPerThread; ++q) {
        int rem = threadIdx.x + q * kThreads, i = 0;
        while (i < N && rem >= N - i) { rem -= N - i; ++i; }
        pi[q] = i;
        pj[q] = i + rem;
        acc[q] = 0ull;
    }

    for (long long w0 = (long long)blockIdx.y * kSlab; w0 < W;
         w0 += (long long)gridDim.y * kSlab) {
        __syncthreads();
        // stage: thread t reads word k of sample n (k fastest: coalesced)
        for (int t = threadIdx.x; t < N * kSlab; t += kThreads) {
            const int n = t / kSlab, k = t - n * kSlab;
            const long long w = w0 + k;
            sh[k * N + n] =
                w < W ? words[((long long)n * Mg + m) * W + w] : 0ull;
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kPairsPerThread; ++q) {
            if (threadIdx.x + q * kThreads < n_pairs) {
                const int i = pi[q], j = pj[q];
                unsigned int c = 0;
#pragma unroll 8
                for (int k = 0; k < kSlab; ++k)
                    c += __popcll(sh[k * N + i] & sh[k * N + j]);
                acc[q] += c;
            }
        }
    }

#pragma unroll
    for (int q = 0; q < kPairsPerThread; ++q) {
        if (threadIdx.x + q * kThreads < n_pairs && acc[q] != 0ull) {
            const int i = pi[q], j = pj[q];
            atomicAdd(both + ((long long)m * N + i) * N + j, acc[q]);
            if (i != j)
                atomicAdd(both + ((long long)m * N + j) * N + i, acc[q]);
            else
                atomicAdd(single + (long long)m * N + i, acc[q]);
        }
    }
}

}  // namespace

// Blocks per mm level: enough slabs in flight to fill the card (8 blocks
// of 256 threads per SM on 132 SMs), never more than there are slabs.
extern "C" int instrain_overlap_counts(const void* words, int N, int Mg,
                                       long long W, void* both, void* single,
                                       int n_sm, void* stream) {
    if (N < 1 || N > kMaxN || Mg < 1 || W < 1) return (int)cudaErrorInvalidValue;
    const long long slabs = (W + kSlab - 1) / kSlab;
    long long per_m = ((long long)n_sm * 8 + Mg - 1) / Mg;
    if (per_m > slabs) per_m = slabs;
    if (per_m > 65535) per_m = 65535;
    if (per_m < 1) per_m = 1;
    const dim3 grid((unsigned)Mg, (unsigned)per_m);
    overlap_counts_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)words, N, Mg, W,
        (unsigned long long*)both, (unsigned long long*)single);
    return (int)cudaGetLastError();
}
