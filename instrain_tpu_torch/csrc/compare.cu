// All-pairs coverage-overlap counts of `compare` for a comparison group
// of scaffolds, in one launch: the Hopper port of
// instrain_tpu/kernels/compare.py:_overlap_counts_device (:38-48).
//
// Input: per scaffold s of the group, N_s samples' bit-packed coverage
// masks, uint64 words [N_s, Mg_s, W_s] (64 positions a word, the bits past
// L zero), laid end to end in one buffer. Output, per scaffold at its
// offset in one int64 buffer: both[m, i, j] = popcount(t_i & t_j) over
// the positions, [Mg_s, N_s, N_s], then single[m, i] = popcount(t_i),
// [Mg_s, N_s]; exact for any L and N_s <= 64.
//
// The JAX version unpacks the bits to bf16 and lets the MXU compute the
// Gram matrix einsum("nml,kml->mnk") with f32 sums, chunking the position
// axis at 2^22 to keep them exact. Here the packed words themselves go
// to the tensor cores' binary product (AND + popcount): integers, exact
// for any L.
//
// The group table (kernels/compare.py:group_plan) is int64, 7 fields of
// S + 1 entries each: N, Mg, W, chunk (words of a row per block), the
// word offset, the output offset and the first block of each scaffold
// (the last entry of the last three: the totals). A row is one (scaffold,
// mm level); each row is cut into blocks of `chunk` words, chunk set per
// scaffold so that every block reads about as many bytes (short rows, as
// at 8 samples x 40 kb, are one block each).
//
// The counts are a Gram matrix of bits, which Hopper's tensor cores take
// directly: mma.sync m16n8k256 with b1 operands and .and.popc adds
// popcount(A_i & B_j) over 256 positions for a 16 x 8 tile of sample
// pairs in one instruction (about 40 times the bit operations a second
// of the CUDA cores' 64-bit AND + POPC on this card: k7_peak.cu). A
// block's units are the I-tiles of 16 samples, each with a pair of
// J-tiles of 8 samples on or right of the diagonal: one unit for N <= 16,
// three for N <= 32, ten for N = 64. A unit's warps (all 8 of the block
// for N <= 16) take every wp-th run of 4 steps of 256 positions of the
// block's chunk. A lane loads its operands straight from device memory,
// 64-bit words: word t of each step of 4 words, for samples g and g + 8
// of the I-tile (g = lane / 4, t = lane % 4), whose halves are the A
// fragment; the J-tiles on the I-tile's own samples reuse them as B,
// the others load a word a lane each. Two tiles of 32-bit sums a unit
// keep the registers few (a block of 256 threads fills the SM with
// others). The sums stay in registers over the warp's runs, then go into
// the block's per-pair sums in shared memory, and each nonzero sum into the output with one
// 64-bit atomicAdd (both[i, j], both[j, i]; on the diagonal both[i, i]
// and single[i]); the entry point zeroes the group's output first (one
// memset for the group). The counts are integers, so the order of the
// atomics does not change the result.
//
// Bound: the words' bytes, each read once from device memory (the tensor
// cores' bit rate is far above what 3.35 TB/s feeds them at N <= 64).
//
// Tried before it: the same grouping on the CUDA cores (a slab of all
// samples in shared memory, a warp per strip of 4 pairs with its lanes
// over the words, one REDUX per pair and slab): 0.1062 ms at (16, 4,
// 2^23), 1.54x the design before it, and 2.2x slower than it at (64, 3,
// 100,000) (PERF.md, PR 6).
//
// The previous design (one block per (mm level, slab of 32 words) of one
// scaffold, a thread per pair over whole slabs, zeroed outputs from the
// wrapper): a launch and two torch.zeros per scaffold, 128 per compare of
// the 8-sample study, and at N = 16 120 of 256 threads idle: 0.1583 ms
// at (16, 4, 2^23) on an NVIDIA H100 80GB HBM3 at 700 W.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 64;
constexpr int kUnroll = 4;         // steps of 256 positions a run
constexpr int kRunWords = 4 * kUnroll;

struct Row {
    int N, s;
    int64_t Mg, W, m, w0, w1, out;
    const unsigned long long* base;   // sample 0's words of the row
};

__device__ __forceinline__ int64_t field(const int64_t* table, int S,
                                         int f, int s) {
    return table[(int64_t)f * (S + 1) + s];
}

// This block's row and word range: the scaffold is the last s whose first
// block is <= blockIdx.x
__device__ Row block_row(const int64_t* table, int S,
                         const unsigned long long* words) {
    const int64_t b = blockIdx.x;
    int lo = 0, hi = S - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (field(table, S, 6, mid) <= b) lo = mid; else hi = mid - 1;
    }
    Row r;
    r.s = lo;
    r.N = (int)field(table, S, 0, lo);
    r.Mg = field(table, S, 1, lo);
    r.W = field(table, S, 2, lo);
    const int64_t chunk = field(table, S, 3, lo);
    const int64_t nb = (r.W + chunk - 1) / chunk;
    const int64_t local = b - field(table, S, 6, lo);
    r.m = local / nb;
    r.w0 = (local - r.m * nb) * chunk;
    r.w1 = r.w0 + chunk < r.W ? r.w0 + chunk : r.W;
    r.out = field(table, S, 5, lo);
    r.base = words + field(table, S, 4, lo) + r.m * r.W;
    return r;
}

// D += popc(A & B) over 256 positions: A 16 samples x 256 bits (a0, a1:
// rows g and g + 8 of the first 128 bits, a2, a3 of the last), B 256
// bits x 8 samples (b0, b1: column g), D 16 x 8 (d0, d1: row g, columns
// 2t and 2t + 1; d2, d3: row g + 8), g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma_and_popc(int (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned long long load_word(
        const unsigned long long* base, int64_t stride, int n, int N,
        int64_t w, int64_t w1) {
    return (n < N && w < w1) ? __ldg(base + n * stride + w) : 0ull;
}

__global__ void __launch_bounds__(kThreads)
overlap_group_kernel(const int64_t* __restrict__ table, int S,
                     const unsigned long long* __restrict__ words,
                     unsigned long long* __restrict__ out) {
    __shared__ unsigned int acc[kMaxN * kMaxN];      // [i][j], i <= j
    const Row r = block_row(table, S, words);
    const int N = r.N, NI = (N + 15) / 16, NJ = (N + 7) / 8;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int64_t stride = r.Mg * r.W;               // sample to sample
    for (int p = threadIdx.x; p < N * N; p += kThreads) acc[p] = 0u;
    __syncthreads();

    // a unit: I-tile ti (samples 16 ti ..) and the pair of J-tiles
    // 2 ti + 2 jp, + 1 (8 samples each) on or right of the diagonal; a
    // unit's warps take every wp-th run of kUnroll steps of 256 positions
    int n_units = 0;
    for (int ti = 0; ti < NI; ++ti) n_units += (NJ - 2 * ti + 1) / 2;
    const int wp = n_units < kWarps ? kWarps / n_units : 1;   // 8, 4, 2, 1
    for (int u = warp / wp; u < n_units; u += kWarps / wp) {
        int ti = 0, jp = u;
        while (jp >= (NJ - 2 * ti + 1) / 2) jp -= (NJ - 2 * ti + 1) / 2, ++ti;
        const int ia = ti * 16 + g, ib = ia + 8;
        const int tj0 = 2 * ti + 2 * jp;
        const int j0 = tj0 * 8 + g, j1 = j0 + 8;
        int d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
        for (int64_t w0 = r.w0 + (int64_t)(warp % wp) * kRunWords;
             w0 < r.w1; w0 += (int64_t)wp * kRunWords) {
            // lane t takes word t of each step of 4: its low half is bits
            // 32t..32t+31 of the step's 256, its high half bits 128 + 32t..
            // (any one bijection serves, as A and B share it)
            unsigned long long xa[kUnroll], xb[kUnroll], y0[kUnroll],
                y1[kUnroll];
#pragma unroll
            for (int k = 0; k < kUnroll; ++k) {
                const int64_t w = w0 + 4 * k + t;
                xa[k] = load_word(r.base, stride, ia, N, w, r.w1);
                xb[k] = load_word(r.base, stride, ib, N, w, r.w1);
                // the diagonal pair of J-tiles is the I-tile's own samples
                y0[k] = jp == 0 ? xa[k]
                                : load_word(r.base, stride, j0, N, w, r.w1);
                y1[k] = jp == 0 ? xb[k]
                                : load_word(r.base, stride, j1, N, w, r.w1);
            }
#pragma unroll
            for (int k = 0; k < kUnroll; ++k) {
                const uint32_t a0 = (uint32_t)xa[k], a1 = (uint32_t)xb[k];
                const uint32_t a2 = (uint32_t)(xa[k] >> 32);
                const uint32_t a3 = (uint32_t)(xb[k] >> 32);
                mma_and_popc(d[0], a0, a1, a2, a3, (uint32_t)y0[k],
                             (uint32_t)(y0[k] >> 32));
                if (tj0 + 1 < NJ)                     // warp-uniform
                    mma_and_popc(d[1], a0, a1, a2, a3, (uint32_t)y1[k],
                                 (uint32_t)(y1[k] >> 32));
            }
        }
        // the unit's tiles into the block's sums: d[q][e] is (row g + 8
        // (e / 2), column 2t + e % 2) of tile (ti, tj0 + q)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = ia + 8 * (e >> 1);
                const int j = (tj0 + q) * 8 + 2 * t + (e & 1);
                if (i <= j && j < N && d[q][e] != 0)
                    atomicAdd(acc + i * N + j, (unsigned int)d[q][e]);
            }
        }
    }
    __syncthreads();

    unsigned long long* both = out + r.out + r.m * N * N;
    unsigned long long* single = out + r.out + r.Mg * N * N + r.m * N;
    for (int p = threadIdx.x; p < N * N; p += kThreads) {
        const int i = p / N, j = p - i * N;
        if (j < i) continue;
        const unsigned long long v = acc[p];
        if (v == 0ull) continue;
        atomicAdd(both + i * N + j, v);
        if (i != j) atomicAdd(both + j * N + i, v);
        else atomicAdd(single + i, v);
    }
}

}  // namespace

// The group's counts: n_out int64 zeroed here, then one launch of n_blocks
// blocks (the table's last first-block entry)
extern "C" int instrain_overlap_counts_group(const void* table, int S,
                                             const void* words,
                                             long long n_blocks, void* out,
                                             long long n_out, void* stream) {
    if (S < 1 || n_blocks < 1 || n_blocks > 0x7fffffffLL || n_out < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(out, 0, (size_t)n_out * 8, s);
    if (e != cudaSuccess) return (int)e;
    overlap_group_kernel<<<(unsigned)n_blocks, kThreads, 0, s>>>(
        (const int64_t*)table, S, (const unsigned long long*)words,
        (unsigned long long*)out);
    return (int)cudaGetLastError();
}
