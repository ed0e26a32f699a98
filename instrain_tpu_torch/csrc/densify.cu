// K8: the hybrid and batch engines' sparse count wire densified on the
// card — the Hopper port of instrain_tpu/kernels/sitestats.py:
// _densify_sparse (:665-685), which site_stats_compact_sparse (:693-741)
// and site_stats_compact_batch_sparse (:875-908) call, for a chunk of
// scaffolds laid end to end (segments.cuh's layout, one scaffold a chunk of
// one).
//
// The wire (native/bam.cc:bd_pack_counts_sparse_d16, packed on the host per
// scaffold): for each nonzero cell of a scaffold's int16 [Mc, 4, Lp]
// counts, in flat order, a uint16 delta from the previous entry's flat
// index (the first from -1; gaps over 65,535 are chained through entries of
// value 0) and its count saturated at 255 as uint8; each cell over 255 also
// an int32 correction (its flat index, count - 255). The table
// (kernels/sitestats.py:SparseWire, int64 rows of S + 1) holds per scaffold
// its first entry, first correction, first tile of kTileEntries entries,
// flat stride Lp and first position in the chunk. The output is the
// chunk's int32 counts [M, 4, Ltot], scaffold s's positions at
// [off[s], off[s + 1]): the padding of the packed tensor (p >= L, m >= M),
// where only zero-value entries can land, is never written.
//
// Four launches and a memset:
//  (a) tile_sums: a block per tile of kTileEntries entries of one scaffold
//      (a tile never spans two) sums its deltas;
//  (b) tile_scan: one block scans the tile sums (int64) into exclusive
//      offsets, kScanRun tiles a thread a round;
//  (c) scatter: a block per tile stages its deltas in shared memory, scans
//      them (kPer consecutive entries a thread, then the block scan of
//      scan.cuh), adds the tile's offset within its scaffold (its offset
//      less the scaffold's first tile's) and lists each entry's flat index
//      in shared memory; then consecutive threads take consecutive entries,
//      skip those of value 0 and store the count at (m, b, off[s] + p).
//      The packer emits each nonzero cell once, so a store suffices;
//  (d) corrections: a thread per correction adds its value (atomically:
//      one per cell as well, but the adds cost nothing beside the stores).
// The idea of the TPU version is kept (idx = cumsum(delta) - 1, then one
// scatter), but the cumsum is a three-step scan over tiles in place of
// XLA's: a block per scaffold would leave an isolate of some 10^7 entries
// on one SM.
//
// Bound: bytes. The wire is read twice (3 bytes an entry, 8 a correction)
// and the output written once in full by the memset (4 bytes a cell) and
// again at the nonzero cells; at 5-15 % density the memset's bytes are
// most of it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

using instrain::block_exclusive_scan;
using instrain::warp_sum;

constexpr int kThreads = 256;                    // (a), (c), (d)
constexpr int kPer = 8;                          // (c): entries a thread
constexpr int kTileEntries = kThreads * kPer;    // sitestats.WIRE_TILE
constexpr int kScanThreads = 1024;               // (b)
constexpr int kScanRun = 8;                      // (b): tiles a thread

// The wire's table: rows e_off, c_off, tile0, Lp, off of S + 1 each
struct Wire {
    const int64_t* t;
    int S;
    __device__ __forceinline__ const int64_t* row(int r) const {
        return t + (int64_t)r * (S + 1);
    }
};

// the last s < S with row[s] <= x: the scaffold holding item x of a row of
// first items (a scaffold with none shares its first item with the next)
__device__ __forceinline__ int scaffold_of(const int64_t* row, int S,
                                           int64_t x) {
    int lo = 0, hi = S - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (row[mid] <= x) lo = mid; else hi = mid - 1;
    }
    return lo;
}

// Where flat index idx of scaffold s's packed tensor lies in the chunk's
// [M, 4, Ltot] counts, or -1 where it lies in the tensor's padding
__device__ __forceinline__ int64_t cell_of(const Wire& w, int s, int64_t idx,
                                           int M, int64_t Ltot) {
    const int64_t lp = w.row(3)[s], off = w.row(4)[s];
    const int64_t len = w.row(4)[s + 1] - off;
    if (idx < 0 || idx >= 4 * lp * M) return -1;
    // idx < 2^31 (the wrapper checks 4 * Lp * M), so 32-bit divisions
    const uint32_t i = (uint32_t)idx, l = (uint32_t)lp;
    const uint32_t m = i / (4u * l), r = i - m * 4u * l;
    const uint32_t b = r / l, p = r - b * l;
    if (p >= len) return -1;
    return ((int64_t)m * 4 + b) * Ltot + off + p;
}

// A tile's scaffold and its entries [e0, e0 + n)
struct TileSpan {
    int s;
    int64_t e0;
    int n;
};

__device__ __forceinline__ TileSpan tile_span(const Wire& w, int64_t tile) {
    TileSpan t;
    t.s = scaffold_of(w.row(2), w.S, tile);
    t.e0 = w.row(0)[t.s] + (tile - w.row(2)[t.s]) * kTileEntries;
    const int64_t left = w.row(0)[t.s + 1] - t.e0;
    t.n = left < kTileEntries ? (int)left : kTileEntries;
    return t;
}

__global__ void __launch_bounds__(kThreads) tile_sums_kernel(
        const uint16_t* __restrict__ deltas, Wire w,
        int64_t* __restrict__ sums) {
    __shared__ int part[kThreads / 32];
    const TileSpan t = tile_span(w, blockIdx.x);
    int acc = 0;                        // at most 2048 * 65535 < 2^31
    for (int j = threadIdx.x; j < t.n; j += kThreads) acc += deltas[t.e0 + j];
    acc = warp_sum(acc);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x < 32) {
        int v = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0;
        v = warp_sum(v);
        if (threadIdx.x == 0) sums[blockIdx.x] = v;
    }
}

// Exclusive scan of sums[0, n) in place; sums[n] receives the total
__global__ void __launch_bounds__(kScanThreads) tile_scan_kernel(
        int64_t* __restrict__ sums, int64_t n) {
    __shared__ int64_t smem[kScanThreads / 32 + 1];
    int64_t carry = 0;
    for (int64_t a0 = 0; a0 < n; a0 += (int64_t)kScanThreads * kScanRun) {
        const int64_t a = a0 + (int64_t)threadIdx.x * kScanRun;
        int64_t v[kScanRun], run = 0;
#pragma unroll
        for (int k = 0; k < kScanRun; ++k) {
            v[k] = a + k < n ? sums[a + k] : 0;
            run += v[k];
        }
        int64_t total;
        int64_t ex = carry + block_exclusive_scan<kScanThreads>(run, &total,
                                                               smem);
#pragma unroll
        for (int k = 0; k < kScanRun; ++k) {
            if (a + k < n) sums[a + k] = ex;
            ex += v[k];
        }
        carry += total;
    }
    if (threadIdx.x == 0) sums[n] = carry;
}

__global__ void __launch_bounds__(kThreads) scatter_kernel(
        const uint16_t* __restrict__ deltas, const uint8_t* __restrict__ vals,
        Wire w, const int64_t* __restrict__ tile_off, int M, int64_t Ltot,
        int32_t* __restrict__ out) {
    static_assert(kPer == 8, "a thread's deltas are one 16-byte word");
    __shared__ __align__(16) uint16_t sd[kTileEntries];
    __shared__ __align__(16) int32_t sidx[kTileEntries];
    __shared__ int smem[kThreads / 32 + 1];
    const int64_t tile = blockIdx.x;
    const TileSpan t = tile_span(w, tile);
    for (int j = threadIdx.x; j < kTileEntries; j += kThreads)
        sd[j] = j < t.n ? deltas[t.e0 + j] : 0;
    __syncthreads();
    // the thread's kPer consecutive deltas in one 16-byte shared load
    const uint4 q = reinterpret_cast<const uint4*>(sd)[threadIdx.x];
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    int run[kPer], acc = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        acc += (int)((words[k >> 1] >> (16 * (k & 1))) & 0xFFFFu);
        run[k] = acc;
    }
    int unused;
    const int ex = block_exclusive_scan<kThreads>(acc, &unused, smem);
    // the flat index of the tile's entry before its first, in its scaffold
    const int64_t base = tile_off[tile] - tile_off[w.row(2)[t.s]] + ex - 1;
    // a real entry's index is below 4 * Lp * Mc < 2^31; a padding slot's
    // repeats the tile's last
    int4* dst = reinterpret_cast<int4*>(sidx) + 2 * threadIdx.x;
    dst[0] = make_int4((int)(base + run[0]), (int)(base + run[1]),
                       (int)(base + run[2]), (int)(base + run[3]));
    dst[1] = make_int4((int)(base + run[4]), (int)(base + run[5]),
                       (int)(base + run[6]), (int)(base + run[7]));
    __syncthreads();
    for (int j = threadIdx.x; j < t.n; j += kThreads) {
        const uint8_t v = vals[t.e0 + j];
        if (v == 0) continue;
        const int64_t c = cell_of(w, t.s, sidx[j], M, Ltot);
        if (c >= 0) out[c] = v;
    }
}

__global__ void __launch_bounds__(kThreads) corrections_kernel(
        const int32_t* __restrict__ corr_idx,
        const int32_t* __restrict__ corr_val, int64_t n_corr, Wire w, int M,
        int64_t Ltot, int32_t* __restrict__ out) {
    const int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (k >= n_corr) return;
    const int32_t v = corr_val[k];
    if (v == 0) return;
    const int s = scaffold_of(w.row(1), w.S, k);
    const int64_t c = cell_of(w, s, corr_idx[k], M, Ltot);
    if (c >= 0) atomicAdd(out + c, v);
}

}  // namespace

// The chunk's counts [M, 4, Ltot] int32 from its wire, on `stream`:
// zeroed, then (a)-(d). tile_scratch holds n_tiles + 1 int64.
extern "C" int instrain_densify(const void* table, int S, int64_t n_tiles,
                                const void* deltas, const void* vals,
                                const void* corr_idx, const void* corr_val,
                                int64_t n_corr, int M, int64_t Ltot,
                                void* tile_scratch, void* out,
                                void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const Wire w{(const int64_t*)table, S};
    cudaError_t e = cudaMemsetAsync(out, 0, (size_t)M * 4 * Ltot * 4, st);
    if (e != cudaSuccess) return (int)e;
    int64_t* sums = (int64_t*)tile_scratch;
    if (n_tiles > 0) {
        tile_sums_kernel<<<(unsigned)n_tiles, kThreads, 0, st>>>(
            (const uint16_t*)deltas, w, sums);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        tile_scan_kernel<<<1, kScanThreads, 0, st>>>(sums, n_tiles);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        scatter_kernel<<<(unsigned)n_tiles, kThreads, 0, st>>>(
            (const uint16_t*)deltas, (const uint8_t*)vals, w, sums, M, Ltot,
            (int32_t*)out);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    if (n_corr > 0) {
        corrections_kernel<<<(unsigned)((n_corr + kThreads - 1) / kThreads),
                             kThreads, 0, st>>>(
            (const int32_t*)corr_idx, (const int32_t*)corr_val, n_corr, w, M,
            Ltot, (int32_t*)out);
    }
    return (int)cudaGetLastError();
}
