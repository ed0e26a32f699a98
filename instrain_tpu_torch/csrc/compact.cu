// Device compaction (K4) over a chunk of scaffolds: the Hopper port of
// instrain_tpu/kernels/sitestats.py:_compact_from_full (:533-646) with its
// helpers _first_set_indices (:325-343), _ffill_expand (:346-375) and
// _median_select (:379-423), and of its batched form
// site_stats_compact_batch (:446-465, K5). The chunk's scaffolds lie end
// to end on the position axis (segments.cuh; one scaffold is a chunk of
// one segment). It reads the dense [M, Ltot] outputs of site_stats.cu and
// clonr.cu, which stay on the device, and writes only what the tables
// need: per segment the SNP rows, per-mm aggregates, the linkage count
// profiles at SNV positions and the three medians per mm level.
//
// Position-tiled kernels (C1, C2) run one block per tile of 256 (C1) or
// 2048 (C2) positions of one segment, so a block's reductions and scans
// never mix scaffolds;
// positions are counted from the segment's start, as the JAX batch engine
// counts them per scaffold.
//
// Three kernels, each bound by device memory (a few integer operations per
// byte):
//
//  C1 select_rows — a two-pass stream compaction sized exactly, in place
//     of the TPU's lax.top_k. Bound: the bytes of `row` (read whole) and of
//     the records, which on dense inputs outweigh `row` many times.
//     (a) rows_count: one warp per tile counts the set cells of `row` and
//     the set positions of `any_snp` in it, with 16-byte loads masked at
//     the ragged edges (neither the rows at m * Ltot nor the segments
//     start 16-byte aligned); (b) rows_scan: one block scans the per-tile
//     counts into offsets (each thread a run of tiles loaded at once) and
//     writes the two totals, the wrapper's one 8-byte read that sizes the
//     outputs, and each segment's first row and first SNV position; (c)
//     rows_gather: a block whose tile selects nothing returns at once; the
//     others stage the tile's `row` bytes in shared memory (16-byte loads
//     again), build there the ordered list of the tile's selected
//     (position, mm) cells, and then write each record column as one
//     contiguous run: consecutive threads take consecutive records j (two
//     in flight each), so every warp store fills whole sectors. The records
//     come out in ascending (segment, position, mm) order (per scaffold
//     JAX's flat index p * Mp + m). Linkage profiles go the same way: the
//     tile's SNV positions listed in shared memory, consecutive threads on
//     consecutive k. mm levels are staged in slabs of kSlab (M has no cap);
//     past one slab each position's records are placed from its count over
//     all levels, read first.
//     The previous design: one thread per position walked m = 0..M-1
//     writing up to M records M apart, with byte loads, and one block
//     scanned the tiles serially: 1.5982 ms at a 52 x 40 kb chunk (M = 8)
//     on an NVIDIA H100 80GB HBM3 at 700 W, 26 % of its bytes bound.
//  C2 mm_aggregates — one block per big tile of 2048 positions of one
//     segment, each of its 256 threads taking kAggPer = 8 of them, 256
//     apart (so that every load and store of a warp covers consecutive
//     cells: rows at m * Ltot and segment starts are not aligned, and a
//     warp's 32 consecutive cells need no masking but the segment's end). Each thread walks m =
//     0..M-1 and keeps, per position, three forward-fill states in
//     registers (clon, clonR, and the packed morphia << 3 | class code over
//     `row`), in place of the TPU's log2(M) doubling passes; it writes the
//     filled clon and clonR (+inf where nothing is set) to f32 scratch for
//     C3. Per mm level a thread sums its positions' parts in registers: the
//     nine 0/1 counts (at most 256 a warp) packed three to a 32-bit word
//     at 10 bits each and folded across the warp by one __reduce_add_sync
//     per word; the two integer and two f64 sums by 64-bit shuffles. The
//     warps' parts meet in shared memory (double-buffered by level: one
//     barrier a level), and one thread per quantity adds the block's sum
//     into the [S, M] aggregates with one global atomic: one per (block,
//     level, quantity) over 2048 positions. A chunk of fewer than two
//     big tiles an SM (one 250 kb segment: 123) takes one position a
//     thread on the table's 256-position tiles instead (the wrapper's
//     aggregates_per_thread), so that enough blocks hide the levels'
//     latency. The entry point zeroes the aggregates, one buffer, with
//     one memset. The f64 sums are exact in
//     any order and grouping (each value is a multiple of 2^-27 in
//     [0.125, 1], and a segment has far fewer than 2^26 positions, so every
//     partial sum is exact), so f64 atomicAdd gives the JAX sums bit for
//     bit; each position is still one term. Bound: the bytes of the seven
//     inputs and two outputs, 28 a cell.
//     The previous design: one thread per position and a block of 256
//     positions, whose reductions per level (ten 64-bit and two f64 warp
//     sums, 120 shuffles a warp, and up to 13 atomics a block) made it
//     instruction-bound, with three zero-fill launches in the wrapper:
//     0.4322 ms at a 52 x 40 kb chunk (M = 8) on an NVIDIA H100 80GB HBM3
//     at 700 W, 32 % of its bytes bound.
//  C3 masked_median — the exact (k1, k2)-th smallest of every (segment,
//     mm level, value set) row, k2 = k1 or k1 + 1, by a radix select on
//     32-bit keys: coverage as f32 (one conversion per value per read) or
//     the filled f32 clonalities. Every value is >= 0 or +inf, so the
//     unsigned order of the keys is the value order. Bound: the bytes of
//     the rows, read once. Digits of 11, 11 and 10 bits from the top; both
//     ranks narrow together while they share a digit, and once their
//     digits differ k1 is the largest key of its bin's group and k2 the
//     smallest of its own, which one min/max read finds: no pass is spent
//     on the upper statistic alone. Each thread adds a run of equal digits
//     to the histogram as one shared atomic: coverages and clonalities
//     cluster on few values (most clonalities are 1.0), and an atomic per
//     key made the passes instruction-bound. The median is (v1 + v2) / 2
//     with one rounded f32 addition, NaN where nothing is counted.
//     Short rows (segments of at most 49,152 positions,
//     cuda_compact.MEDIAN_SHORT_KEYS: every chunk of the metagenome): one
//     block per row loads its keys into shared memory once with 16-byte
//     loads, counting the first digit as they pass, and runs the other
//     passes there.
//     Long rows (the isolate, the deep input, any longer scaffold): each
//     row is split over enough blocks to fill the card; a pass reads the
//     row from device memory (three at most, two when the ranks split
//     after the first), each block adds its histogram into the row's in
//     global memory, and the row's last block to finish (a ticket) picks
//     the digits and advances the row's state in a small device buffer for
//     the next launch: no host round trip.
//     The previous design: one block per (segment, mm level, value set)
//     read its row five times from device memory (four 8-bit passes and
//     one for the upper statistic), so a one-segment launch ran 3 * M
//     blocks on 132 SMs: 1.4061 ms at one segment of M = 8, L = 2^20 and
//     0.5400 ms at a 52 x 40 kb chunk on an NVIDIA H100 80GB HBM3 at 700 W.
//
// M has no fixed cap: C1 stages mm levels in slabs, C2 reduces one mm
// level at a time and C3 takes one row per (segment, level, set).
// Indices into [M, Ltot] arrays are 64-bit; record counts are 32-bit (the
// wrapper checks M * Ltot < 2^31).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "segments.cuh"

namespace {

using instrain::Segments;
using instrain::TilePos;
using instrain::tile_position;

constexpr int kThreads = instrain::kTile;     // C1 and C2: positions/block
constexpr int kWarps = kThreads / 32;
constexpr int kWords = kThreads / 16 + 1;     // 16-byte words over a tile
constexpr int kSlab = 32;                     // C1 (c): mm levels staged
constexpr int kScanThreads = 1024;            // C1 (b)
constexpr int kScanRun = 8;                   // C1 (b): tiles per thread
constexpr int kShortThreads = 1024;           // C3, short rows
constexpr int kShortKeysMax = 49152;          // C3: MEDIAN_SHORT_KEYS
constexpr int kBins = 2048;                   // C3: 11 + 11 + 10-bit digits
constexpr int kLongThreads = 512;             // C3, long rows
constexpr int kUnroll = 4;                    // C3: 16-byte loads in flight
constexpr uint32_t kInfBits = 0x7F800000u;
constexpr int kNumInt = 10;                   // integer aggregates, C2
constexpr int kAggThreads = 256;              // C2
constexpr int kAggWarps = kAggThreads / 32;
constexpr int kAggPer = 8;                    // C2: positions per thread
static_assert(kAggThreads == instrain::kTile &&
              kAggThreads * kAggPer == instrain::kBigTile,
              "C2's blocks are the table's tiles or big tiles");
constexpr int8_t kSNS = 0, kConSNV = 2, kPopSNV = 3;

__device__ __forceinline__ int warp_inclusive_scan(int v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += n;
    }
    return v;
}

// Exclusive scan of one int per thread over a block of NT threads;
// *total receives the block's sum. smem holds NT / 32 + 1 ints.
template <int NT>
__device__ int block_exclusive_scan(int v, int* total, int* smem) {
    constexpr int W = NT / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int inc = warp_inclusive_scan(v);
    if (lane == 31) smem[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        const int w = lane < W ? smem[lane] : 0;
        const int winc = warp_inclusive_scan(w);
        if (lane < W) smem[lane] = winc - w;
        if (lane == W - 1) smem[W] = winc;
    }
    __syncthreads();
    const int res = smem[warp] + inc - v;
    *total = smem[W];
    __syncthreads();                      // smem is reused by the caller
    return res;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// ------------------------------------------------------------------ C1

// Tile t of positions: its start on the chunk's axis, its start within
// its segment and its length (<= kThreads)
struct Tile {
    int64_t g0, p0;
    int len;
};

__device__ __forceinline__ Tile tile_of(const Segments& g, int64_t t) {
    const int s = instrain::segment_of_tile(g, t);
    const int64_t off = instrain::seg_off(g, s);
    Tile r;
    r.p0 = (t - instrain::seg_tile0(g, s)) * kThreads;
    r.g0 = off + r.p0;
    const int64_t left = instrain::seg_off(g, s + 1) - off - r.p0;
    r.len = left < kThreads ? (int)left : kThreads;
    return r;
}

// The q-th aligned 16-byte word over the bytes [lo, lo + n), or null past
// them. The words before and after the range share its 16-byte blocks, so
// they lie within the allocation.
__device__ __forceinline__ const uint8_t* word_at(const uint8_t* lo, int n,
                                                  int q) {
    const uint8_t* w = (const uint8_t*)((uintptr_t)lo & ~(uintptr_t)15) +
                       16 * q;
    return w < lo + n ? w : nullptr;
}

// The set bools (bytes 0 or 1) of the aligned word w that lie in [lo, hi)
__device__ __forceinline__ int count_word(const uint8_t* w, const uint8_t* lo,
                                          const uint8_t* hi) {
    const uint4 v = __ldg((const uint4*)w);
    const uint32_t x[4] = {v.x, v.y, v.z, v.w};
    int c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint8_t* q = w + 4 * k;
        uint32_t keep = 0xFFFFFFFFu;
        if (q < lo) {
            const int64_t d = lo - q;
            keep = d >= 4 ? 0u : keep << (8 * d);
        }
        if (q + 4 > hi) {
            const int64_t e = hi - q;
            keep = e <= 0 ? 0u : keep & (0xFFFFFFFFu >> (8 * (4 - e)));
        }
        c += __popc(x[k] & keep);
    }
    return c;
}

// One warp per tile (a tile's M + 1 rows are (M + 1) * kWords words)
__global__ void __launch_bounds__(kThreads) rows_count_kernel(
        const bool* __restrict__ row, const bool* __restrict__ any_snp,
        int M, int64_t L, Segments g, int64_t n_tiles,
        int* __restrict__ block_rows, int* __restrict__ block_pos) {
    const int64_t tile = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (tile >= n_tiles) return;
    const int lane = threadIdx.x & 31;
    const Tile t = tile_of(g, tile);
    int cr = 0, cp = 0;
    for (int it = lane; it < (M + 1) * kWords; it += 32) {
        const int m = it / kWords, q = it - m * kWords;
        const uint8_t* lo = (const uint8_t*)(m < M ? row + (int64_t)m * L
                                                   : any_snp) + t.g0;
        const uint8_t* w = word_at(lo, t.len, q);
        if (!w) continue;
        const int c = count_word(w, lo, lo + t.len);
        if (m < M) cr += c; else cp += c;
    }
    cr = warp_sum(cr);
    cp = warp_sum(cp);
    if (lane == 0) {
        block_rows[tile] = cr;
        block_pos[tile] = cp;
    }
}

// One block: the n per-tile counts -> exclusive offsets in place, with
// entry n the total; sizes [n_rows, n_pos]; each segment's first row and
// first SNV position -> seg_rows / seg_pos [S + 1] (entry S: the totals).
// Each thread scans a run of kScanRun consecutive tiles, loaded at once,
// in rounds of kScanThreads * kScanRun tiles.
__global__ void __launch_bounds__(kScanThreads) rows_scan_kernel(
        int* __restrict__ block_rows, int* __restrict__ block_pos, int n,
        Segments g, int* __restrict__ sizes, int* __restrict__ seg_rows,
        int* __restrict__ seg_pos) {
    __shared__ int smem[kScanThreads / 32 + 1];
    int carry_r = 0, carry_p = 0;
    for (int base = 0; base < n; base += kScanThreads * kScanRun) {
        const int a = base + threadIdx.x * kScanRun;
        int r[kScanRun], q[kScanRun], sr = 0, sp = 0;
#pragma unroll
        for (int k = 0; k < kScanRun; ++k) {
            r[k] = a + k < n ? block_rows[a + k] : 0;
            q[k] = a + k < n ? block_pos[a + k] : 0;
            sr += r[k];
            sp += q[k];
        }
        int tr, tp;
        int er = carry_r + block_exclusive_scan<kScanThreads>(sr, &tr, smem);
        int ep = carry_p + block_exclusive_scan<kScanThreads>(sp, &tp, smem);
#pragma unroll
        for (int k = 0; k < kScanRun; ++k) {
            if (a + k < n) {
                block_rows[a + k] = er;
                block_pos[a + k] = ep;
            }
            er += r[k];
            ep += q[k];
        }
        carry_r += tr;
        carry_p += tp;
    }
    if (threadIdx.x == 0) {
        block_rows[n] = carry_r;
        block_pos[n] = carry_p;
        sizes[0] = carry_r;
        sizes[1] = carry_p;
    }
    __syncthreads();                       // the offsets are written
    for (int s = threadIdx.x; s <= g.S; s += kScanThreads) {
        const int64_t t = instrain::seg_tile0(g, s);
        seg_rows[s] = block_rows[t];
        seg_pos[s] = block_pos[t];
    }
}

// The tile's bytes of rows m0 .. m0 + ms - 1 of `row` -> rb[ml * kThreads
// + x], by 16-byte loads
__device__ __forceinline__ void stage_rows(const bool* __restrict__ row,
                                           int m0, int ms, int64_t L,
                                           const Tile& t,
                                           uint8_t* __restrict__ rb) {
    for (int it = threadIdx.x; it < ms * kWords; it += kThreads) {
        const int ml = it / kWords, q = it - ml * kWords;
        const uint8_t* lo = (const uint8_t*)(row + (int64_t)(m0 + ml) * L +
                                             t.g0);
        const uint8_t* w = word_at(lo, t.len, q);
        if (!w) continue;
        const uint4 v = __ldg((const uint4*)w);
        const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            const int64_t d = (w + k) - lo;
            if (d >= 0 && d < t.len)
                rb[ml * kThreads + d] = (uint8_t)(x[k >> 2] >> (8 * (k & 3)));
        }
    }
}

// One SNP record: its output index j and its 12 columns
struct Record {
    int j, pos, m;
    int32_t acgt[4];
    int64_t total;
    int8_t code[4];
    bool cryptic;

    __device__ __forceinline__ void load(
            const Tile& t, int p, int m_, int64_t L,
            const int32_t* __restrict__ cum, const int64_t* __restrict__ tot,
            const int8_t* __restrict__ con, const int8_t* __restrict__ var,
            const int8_t* __restrict__ morphia,
            const int8_t* __restrict__ cls,
            const bool* __restrict__ cry) {
        const int64_t gp = t.g0 + p;
        const int64_t cell = (int64_t)m_ * L + gp;
        const int64_t c4 = (int64_t)m_ * 4 * L + gp;
        pos = (int)(t.p0 + p);
        m = m_;
#pragma unroll
        for (int b = 0; b < 4; ++b) acgt[b] = cum[c4 + b * L];
        total = tot[cell];
        code[0] = con[cell];
        code[1] = var[cell];
        code[2] = morphia[cell];
        code[3] = cls[cell];
        cryptic = cry[gp];
    }

    __device__ __forceinline__ void store(
            int n_rows, int32_t* __restrict__ r_i32,
            int64_t* __restrict__ r_total, int8_t* __restrict__ r_codes,
            bool* __restrict__ r_cryptic) const {
        r_i32[j] = pos;
        r_i32[(int64_t)n_rows + j] = m;
#pragma unroll
        for (int b = 0; b < 4; ++b)
            r_i32[(int64_t)(2 + b) * n_rows + j] = acgt[b];
        r_total[j] = total;
#pragma unroll
        for (int b = 0; b < 4; ++b)
            r_codes[(int64_t)b * n_rows + j] = code[b];
        r_cryptic[j] = cryptic;
    }
};

__global__ void __launch_bounds__(kThreads) rows_gather_kernel(
        const bool* __restrict__ row, const bool* __restrict__ any_snp,
        const int32_t* __restrict__ cum, const int64_t* __restrict__ total,
        const int8_t* __restrict__ con, const int8_t* __restrict__ var,
        const int8_t* __restrict__ morphia, const int8_t* __restrict__ cls,
        const bool* __restrict__ cryptic, const bool* __restrict__ present,
        int M, int64_t L, Segments g, int slab,
        const int* __restrict__ row_off, const int* __restrict__ pos_off,
        int n_rows, int n_pos,
        int32_t* __restrict__ r_i32,      // [6, n_rows] pos mm A C T G
        int64_t* __restrict__ r_total,    // [n_rows]
        int8_t* __restrict__ r_codes,     // [4, n_rows] con var morphia cls
        bool* __restrict__ r_cryptic,     // [n_rows]
        int32_t* __restrict__ l_pos,      // [n_pos]
        int32_t* __restrict__ l_cum,      // [M, 4, n_pos]
        bool* __restrict__ l_present) {   // [M, n_pos]
    // dynamic: next, start [kThreads]; cells [slab * kThreads]; rb [slab *
    // kThreads] bytes
    extern __shared__ __align__(16) int dyn[];
    __shared__ int smem[kWarps + 1];
    __shared__ int snp[kThreads];
    int* next = dyn;              // each position's next record (tile)
    int* start = next + kThreads; // each position's first entry in cells
    int* cells = start + kThreads;                    // (ml << 8) | x
    uint8_t* rb = (uint8_t*)(cells + slab * kThreads);
    const int r0 = row_off[blockIdx.x], nr = row_off[blockIdx.x + 1] - r0;
    const int k0 = pos_off[blockIdx.x], nk = pos_off[blockIdx.x + 1] - k0;
    if (nr == 0 && nk == 0) return;
    const Tile t = tile_of(g, blockIdx.x);
    const int x = threadIdx.x;
    const bool valid = x < t.len;
    int unused;

    if (nr > 0) {
        // past one slab, each position's records start at its count over
        // all levels, scanned
        int nx = 0;
        if (M > slab) {
            int c = 0;
            if (valid)
                for (int m = 0; m < M; ++m)
                    c += row[(int64_t)m * L + t.g0 + x];
            nx = block_exclusive_scan<kThreads>(c, &unused, smem);
        }
        for (int m0 = 0; m0 < M; m0 += slab) {
            const int ms = min(slab, M - m0);
            stage_rows(row, m0, ms, L, t, rb);
            __syncthreads();
            int cs = 0;
            if (valid)
                for (int ml = 0; ml < ms; ++ml) cs += rb[ml * kThreads + x];
            int n_slab;
            const int st = block_exclusive_scan<kThreads>(cs, &n_slab, smem);
            if (M <= slab) nx = st;
            next[x] = nx;
            start[x] = st;
            if (valid) {
                int e = st;
                for (int ml = 0; ml < ms; ++ml)
                    if (rb[ml * kThreads + x]) cells[e++] = (ml << 8) | x;
            }
            __syncthreads();
            // two records in flight per thread: all loads, then the stores
            for (int i = x; i < n_slab; i += 2 * kThreads) {
                Record rec[2];
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int e = i + u * kThreads;
                    if (e >= n_slab) break;
                    const int c = cells[e], p = c & 255;
                    rec[u].j = r0 + next[p] + (e - start[p]);
                    rec[u].load(t, p, m0 + (c >> 8), L, cum, total, con, var,
                                morphia, cls, cryptic);
                }
#pragma unroll
                for (int u = 0; u < 2; ++u)
                    if (i + u * kThreads < n_slab)
                        rec[u].store(n_rows, r_i32, r_total, r_codes,
                                     r_cryptic);
            }
            nx += cs;
            __syncthreads();               // before rb, cells, next reuse
        }
    }
    if (nk > 0) {
        const int f = valid && any_snp[t.g0 + x];
        const int k = block_exclusive_scan<kThreads>(f, &unused, smem);
        if (f) snp[k] = x;
        __syncthreads();
        // nk <= kThreads: thread x takes SNV position x of the tile down
        // every [M, 4] count row and [M] present row, consecutive threads
        // on consecutive k
        if (x < nk) {
            const int64_t gp = t.g0 + snp[x], k = k0 + x;
            l_pos[k] = (int32_t)(t.p0 + snp[x]);
            for (int r = 0; r < 4 * M; ++r)
                l_cum[(int64_t)r * n_pos + k] = cum[(int64_t)r * L + gp];
            for (int m = 0; m < M; ++m)
                l_present[(int64_t)m * n_pos + k] = present[(int64_t)m * L +
                                                            gp];
        }
    }
}

// ------------------------------------------------------------------ C2

// Per thread and mm level, what its kAggPer positions add to the block's
// aggregates: the 64-bit sums, and the nine 0/1 counts (each at most
// kAggPer a thread, 32 * kAggPer a warp: 10 bits) packed three to a word
struct AggPart {
    unsigned long long sum, sumsq;
    double f0, f1;
    uint32_t c[3];   // nonzeros, counted, rarefied | div_sites, sns, snv |
                     // con_snps, pop_snps, present; 10 bits each
};

// C2's tiles: PER positions a thread, kAggThreads * PER a block, on the
// segment table's tiles (PER = 1: kTile) or big tiles (PER = kAggPer)
template <int PER>
__device__ __forceinline__ int64_t agg_tile0(const Segments& g, int s) {
    return PER == 1 ? instrain::seg_tile0(g, s) : instrain::seg_btile0(g, s);
}

template <int PER>
__device__ __forceinline__ int agg_segment(const Segments& g, int64_t t) {
    return PER == 1 ? instrain::segment_of_tile(g, t)
                    : instrain::segment_of_btile(g, t);
}

template <int PER>
__global__ void __launch_bounds__(kAggThreads) mm_aggregates_kernel(
        const int64_t* __restrict__ total, const float* __restrict__ clon,
        const float* __restrict__ clonR, const bool* __restrict__ row,
        const int8_t* __restrict__ morphia, const int8_t* __restrict__ cls,
        const bool* __restrict__ present, int M, int64_t L, Segments g,
        unsigned long long* __restrict__ agg_i,   // [kNumInt, S, M], zeroed
        double* __restrict__ agg_f,               // [2, S, M], zeroed
        bool* __restrict__ mm_active,             // [S, M], zeroed
        float* __restrict__ clon_f, float* __restrict__ clonR_f) {
    // the warps' parts, double-buffered by mm level: one barrier a level
    __shared__ unsigned long long s_l[2][kAggWarps][2];
    __shared__ double s_d[2][kAggWarps][2];
    __shared__ uint32_t s_c[2][kAggWarps][3];
    const int s = agg_segment<PER>(g, blockIdx.x);
    const int64_t off = instrain::seg_off(g, s);
    const int64_t len = instrain::seg_off(g, s + 1) - off;
    // this thread's positions within the segment: p0 + v * kAggThreads
    const int64_t p0 = (blockIdx.x - agg_tile0<PER>(g, s)) *
                       (kAggThreads * PER) + threadIdx.x;
    const int64_t SM = (int64_t)g.S * M, sm0 = (int64_t)s * M;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float inf = __uint_as_float(kInfBits);
    float cf[PER], rf[PER];                // filled clon / clonR
    int enc[PER];                          // filled morphia << 3 | cls
#pragma unroll
    for (int v = 0; v < PER; ++v) {
        cf[v] = inf;
        rf[v] = inf;
        enc[v] = -1;
    }

    for (int m = 0; m < M; ++m) {
        const int64_t base = (int64_t)m * L + off;
        AggPart a = {0ull, 0ull, 0.0, 0.0, {0u, 0u, 0u}};
#pragma unroll
        for (int v = 0; v < PER; ++v) {
            const int64_t p = p0 + v * kAggThreads;
            if (p >= len) continue;
            const int64_t cell = base + p;
            const int64_t t = total[cell];
            const float c = clon[cell], r = clonR[cell];
            const bool rw = row[cell];
            const int code = ((int)morphia[cell] << 3) | (int)cls[cell];
            const bool pr = present[cell];
            if (c == c) cf[v] = c;         // set where not NaN
            if (r == r) rf[v] = r;
            if (rw) enc[v] = code;
            clon_f[cell] = cf[v];
            clonR_f[cell] = rf[v];
            const bool has_c = cf[v] != inf, has_r = rf[v] != inf;
            const bool have_row = enc[v] >= 0;
            const int mor = enc[v] >> 3, k = enc[v] & 7;
            a.sum += (unsigned long long)t;
            a.sumsq += (unsigned long long)(t * t);
            if (has_c) a.f0 += (double)cf[v];
            if (has_r) a.f1 += (double)rf[v];
            a.c[0] += (uint32_t)(t > 0) | ((uint32_t)has_c << 10) |
                      ((uint32_t)has_r << 20);
            a.c[1] += (uint32_t)have_row |
                      ((uint32_t)(have_row && mor == 1) << 10) |
                      ((uint32_t)(have_row && mor > 1) << 20);
            a.c[2] += (uint32_t)(have_row && (k == kSNS || k == kConSNV ||
                                              k == kPopSNV)) |
                      ((uint32_t)(have_row && (k == kSNS || k == kPopSNV))
                       << 10) |
                      ((uint32_t)pr << 20);
        }
        // the warp's parts: one REDUX per packed word, 64-bit shuffles for
        // the sums alone
#pragma unroll
        for (int q = 0; q < 3; ++q)
            a.c[q] = __reduce_add_sync(0xffffffffu, a.c[q]);
        a.sum = warp_sum(a.sum);
        a.sumsq = warp_sum(a.sumsq);
        a.f0 = warp_sum(a.f0);
        a.f1 = warp_sum(a.f1);
        const int buf = m & 1;
        if (lane == 0) {
            s_l[buf][warp][0] = a.sum;
            s_l[buf][warp][1] = a.sumsq;
            s_d[buf][warp][0] = a.f0;
            s_d[buf][warp][1] = a.f1;
#pragma unroll
            for (int q = 0; q < 3; ++q) s_c[buf][warp][q] = a.c[q];
        }
        __syncthreads();
        // one thread per quantity: the block's sum, one global atomic
        const int q = threadIdx.x;
        if (q < 2) {
            unsigned long long x = 0;
            for (int w = 0; w < kAggWarps; ++w) x += s_l[buf][w][q];
            if (x) atomicAdd(agg_i + q * SM + sm0 + m, x);
        } else if (q < kNumInt + 1) {        // the nine counts
            const int word = (q - 2) / 3, shift = 10 * ((q - 2) % 3);
            unsigned long long x = 0;
            for (int w = 0; w < kAggWarps; ++w)
                x += (s_c[buf][w][word] >> shift) & 1023u;
            if (q < kNumInt) {
                if (x) atomicAdd(agg_i + q * SM + sm0 + m, x);
            } else if (x) {                  // present: mm_active
                mm_active[sm0 + m] = true;
            }
        } else if (q < kNumInt + 3) {
            const int f = q - kNumInt - 1;
            double x = 0.0;
            for (int w = 0; w < kAggWarps; ++w) x += s_d[buf][w][f];
            if (x != 0.0) atomicAdd(agg_f + f * SM + sm0 + m, x);
        }
    }
}

// ------------------------------------------------------------------ C3

// The select's digits, from the top of the 32-bit key: 11, 11 and 10 bits
__device__ __forceinline__ int digit_shift(int pass) {
    return pass == 0 ? 21 : pass == 1 ? 10 : 0;
}
__device__ __forceinline__ int digit_width(int pass) {
    return pass == 2 ? 10 : 11;
}

// A row's select: the key prefixes of the k1-th and k2-th smallest (equal
// until their digits differ), the bits resolved so far, both ranks within
// the prefix's group (1-based) and the phase: narrowing; split (v1 is the
// largest key of prefix's group, v2 the smallest of prefix2's); done (v1 =
// prefix, v2 = prefix2). The long rows keep it in global memory between
// launches as 8 words: these 6, then the split's max and min.
enum : uint32_t { kNarrow = 0, kSplit = 1, kDone = 2 };

struct Sel {
    uint32_t prefix, prefix2, mask, k1, k2, phase;
};

__device__ __forceinline__ Sel sel_start(int64_t count) {
    Sel s;
    s.prefix = s.prefix2 = s.mask = 0;
    s.k1 = (uint32_t)((count - 1) / 2 + 1);
    s.k2 = (uint32_t)(count / 2 + 1);
    s.phase = kNarrow;
    return s;
}

// After the histogram of pass `pass`: k1 lies in bin d1, above the b1 keys
// of the group's lower bins, and k2 in bin d2 (d2 = d1, or the next bin
// that holds any key, and then k2 = k1 + 1 is its smallest)
__device__ __forceinline__ void sel_narrow(Sel& s, int pass, uint32_t d1,
                                           uint32_t b1, uint32_t d2) {
    const int shift = digit_shift(pass);
    const uint32_t p = s.prefix;
    s.prefix = p | (d1 << shift);
    s.prefix2 = p | (d2 << shift);
    s.mask |= ((1u << digit_width(pass)) - 1) << shift;
    if (pass == 2) {
        s.phase = kDone;
    } else if (d1 != d2) {
        s.phase = kSplit;
    } else {
        s.k1 -= b1;
        s.k2 -= b1;
    }
}

__device__ __forceinline__ float median_of(uint32_t v1, uint32_t v2) {
    return __fmul_rn(__fadd_rn(__uint_as_float(v1), __uint_as_float(v2)),
                     0.5f);
}

// The bins of ranks k1 and k2 in the kBins-bin histogram h (shared
// memory): res = {d1, b1, d2}. Run by all NT threads; smem holds NT / 32 +
// 1 ints.
template <int NT>
__device__ void find_bins(const uint32_t* h, uint32_t k1, uint32_t k2,
                          uint32_t* res, int* smem) {
    constexpr int PER = kBins / NT;
    const int lo = threadIdx.x * PER;
    uint32_t mine = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) mine += h[lo + i];
    int unused;
    uint32_t below = (uint32_t)block_exclusive_scan<NT>((int)mine, &unused,
                                                        smem);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const uint32_t c = h[lo + i];
        if (below < k1 && k1 <= below + c) {
            res[0] = lo + i;
            res[1] = below;
        }
        if (below < k2 && k2 <= below + c) res[2] = lo + i;
        below += c;
    }
    __syncthreads();
}

// The largest and smallest of one value a thread, over the block (every
// thread receives both). smem holds 2 * NT / 32 words.
template <int NT>
__device__ void block_minmax(uint32_t& mx, uint32_t& mn, uint32_t* smem) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    mx = __reduce_max_sync(0xffffffffu, mx);
    mn = __reduce_min_sync(0xffffffffu, mn);
    if (lane == 0) {
        smem[warp] = mx;
        smem[NT / 32 + warp] = mn;
    }
    __syncthreads();
    mx = 0;
    mn = 0xFFFFFFFFu;
    for (int w = 0; w < NT / 32; ++w) {
        mx = max(mx, smem[w]);
        mn = min(mn, smem[NT / 32 + w]);
    }
    __syncthreads();
}

// A thread's run of equal digits, added to a shared histogram as one
// atomic when the digit changes: keys cluster on few values (coverages
// near the depth, clonalities at 1.0), so most keys cost a compare and an
// increment instead of a shared atomic. Keys outside the prefix's group
// are skipped and do not end a run.
struct DigitRun {
    uint32_t d = 0, n = 0;

    __device__ __forceinline__ void add(uint32_t* h, uint32_t digit,
                                        bool in_group) {
        if (!in_group) return;
        if (digit == d) {
            ++n;
            return;
        }
        if (n) atomicAdd(h + d, n);
        d = digit;
        n = 1;
    }
    __device__ __forceinline__ void flush(uint32_t* h) {
        if (n) atomicAdd(h + d, n);
    }
};

// The key of a value: coverage as f32 (rounded to nearest, as the plain
// version converts it), clonality as it is
__device__ __forceinline__ uint32_t key_of(int64_t t) {
    return __float_as_uint((float)t);
}
__device__ __forceinline__ uint32_t key_of(float v) {
    return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t key_in(const uint4& w, int e, int64_t) {
    const uint32_t lo = e ? w.z : w.x, hi = e ? w.w : w.y;
    return key_of((int64_t)(((uint64_t)hi << 32) | lo));
}
__device__ __forceinline__ uint32_t key_in(const uint4& w, int e, float) {
    return e == 0 ? w.x : e == 1 ? w.y : e == 2 ? w.z : w.w;
}

// f(i, key) for every value i of src[0, n): the 16-byte-aligned body by
// 16-byte loads, kUnroll in flight per thread, and the unaligned head and
// tail one value a thread.
template <int NT, typename T, typename F>
__device__ __forceinline__ void for_keys(const T* __restrict__ src,
                                         int64_t n, F f) {
    constexpr int V = 16 / sizeof(T);
    int64_t head = (int64_t)(((16 - ((uintptr_t)src & 15)) & 15) / sizeof(T));
    if (head > n) head = n;
    const int64_t nv = (n - head) / V, tail = head + nv * V;
    {
        const int64_t e = threadIdx.x;           // head and tail: < 2V values
        if (e < head + (n - tail)) {
            const int64_t i = e < head ? e : tail + (e - head);
            f(i, key_of(src[i]));
        }
    }
    const uint4* body = (const uint4*)(src + head);
    for (int64_t q0 = 0; q0 < nv; q0 += (int64_t)NT * kUnroll) {
        uint4 w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int64_t q = q0 + u * NT + threadIdx.x;
            w[u] = q < nv ? __ldg(body + q) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int64_t q = q0 + u * NT + threadIdx.x;
            if (q < nv) {
#pragma unroll
                for (int e = 0; e < V; ++e)
                    f(head + q * V + e, key_in(w[u], e, T()));
            }
        }
    }
}

// A row of the launch: (segment, mm level, value set), its count and its
// output
struct MedianRow {
    int s, m, which;
    int64_t off, n, count;
    float* out;
};

__device__ __forceinline__ MedianRow median_row(
        const Segments& g, int M, int s, int rr, const int64_t* counted,
        const int64_t* rarefied, float* out) {
    MedianRow r;
    r.s = s;
    r.m = rr / 3;
    r.which = rr - 3 * r.m;
    r.off = instrain::seg_off(g, s);
    r.n = instrain::seg_off(g, s + 1) - r.off;
    const int64_t sm = (int64_t)s * M + r.m;
    r.count = r.which == 0 ? r.n : r.which == 1 ? counted[sm] : rarefied[sm];
    r.out = out + (int64_t)r.which * g.S * M + sm;
    return r;
}

// One block per (segment, mm level, value set) row; rows of segments
// longer than short_keys are the long kernel's. The block loads its row's
// keys into shared memory once (dynamic, short_keys a multiple of 4),
// counting their first digit as they pass, and runs the other passes, and
// the min/max pass once the ranks split, on shared memory.
__global__ void __launch_bounds__(kShortThreads) median_short_kernel(
        const int64_t* __restrict__ total, const float* __restrict__ clon_f,
        const float* __restrict__ clonR_f,
        const int64_t* __restrict__ counted,
        const int64_t* __restrict__ rarefied, int M, int64_t L, Segments g,
        int short_keys, float* __restrict__ out) {   // [3, S, M]
    extern __shared__ __align__(16) uint32_t keys[];
    __shared__ uint32_t h[kBins];
    __shared__ int smem[kShortThreads / 32 + 1];
    __shared__ uint32_t res[4];
    __shared__ uint32_t mm[2 * kShortThreads / 32];
    const int R3 = 3 * M;
    const MedianRow r = median_row(g, M, blockIdx.x / R3, blockIdx.x % R3,
                                   counted, rarefied, out);
    if (r.n > short_keys) return;
    if (r.count <= 0) {
        if (threadIdx.x == 0) *r.out = __uint_as_float(0x7fc00000u);
        return;
    }
    const int n = (int)r.n;
    Sel s = sel_start(r.count);
    for (int pass = 0; pass < 3 && s.phase == kNarrow; ++pass) {
        const int shift = digit_shift(pass);
        const uint32_t digit = (1u << digit_width(pass)) - 1;
        for (int k = threadIdx.x; k < kBins; k += kShortThreads) h[k] = 0;
        __syncthreads();
        DigitRun run;
        if (pass == 0) {
            // the row's keys into shared memory, their first digit counted
            const int64_t row0 = (int64_t)r.m * L + r.off;
            const auto put = [&](int64_t i, uint32_t key) {
                keys[i] = key;
                run.add(h, key >> shift, true);
            };
            if (r.which == 0) {
                for_keys<kShortThreads>(total + row0, n, put);
            } else {
                for_keys<kShortThreads>(
                    (r.which == 1 ? clon_f : clonR_f) + row0, n, put);
            }
        } else {
            // four keys at a time by 16-byte reads
            const auto count = [&](uint32_t key) {
                run.add(h, (key >> shift) & digit,
                        (key & s.mask) == s.prefix);
            };
            const uint4* kv = (const uint4*)keys;
#pragma unroll 2
            for (int q = threadIdx.x; q < n >> 2; q += kShortThreads) {
                const uint4 v = kv[q];
                count(v.x);
                count(v.y);
                count(v.z);
                count(v.w);
            }
            for (int i = (n & ~3) + threadIdx.x; i < n; i += kShortThreads)
                count(keys[i]);
        }
        run.flush(h);
        __syncthreads();
        find_bins<kShortThreads>(h, s.k1, s.k2, res, smem);
        sel_narrow(s, pass, res[0], res[1], res[2]);
        __syncthreads();                   // res and h are reused
    }
    uint32_t v1 = s.prefix, v2 = s.prefix2;
    if (s.phase == kSplit) {
        v1 = 0;
        v2 = 0xFFFFFFFFu;
        for (int i = threadIdx.x; i < n; i += kShortThreads) {
            const uint32_t key = keys[i];
            if ((key & s.mask) == s.prefix) v1 = max(v1, key);
            if ((key & s.mask) == s.prefix2) v2 = min(v2, key);
        }
        block_minmax<kShortThreads>(v1, v2, mm);
    }
    if (threadIdx.x == 0) *r.out = median_of(v1, v2);
}

// One pass of a long row's select over this block's range of it: the
// histogram of the pass's digit added into the row's global histogram gh,
// or, once split, the block's largest key of prefix's group and smallest
// of prefix2's into the row's state st[6], st[7]
template <typename T>
__device__ void long_block(const T* __restrict__ src, int64_t n, const Sel& s,
                           int pass, uint32_t* h, uint32_t* mm, uint32_t* st,
                           uint32_t* gh) {
    if (s.phase == kSplit) {
        uint32_t mx = 0, mn = 0xFFFFFFFFu;
        const auto minmax = [&](int64_t, uint32_t key) {
            if ((key & s.mask) == s.prefix) mx = max(mx, key);
            if ((key & s.mask) == s.prefix2) mn = min(mn, key);
        };
        for_keys<kLongThreads>(src, n, minmax);
        block_minmax<kLongThreads>(mx, mn, mm);
        if (threadIdx.x == 0) {
            atomicMax(st + 6, mx);
            atomicMin(st + 7, mn);
        }
        return;
    }
    for (int k = threadIdx.x; k < kBins; k += kLongThreads) h[k] = 0;
    __syncthreads();
    const int shift = digit_shift(pass);
    const uint32_t digit = (1u << digit_width(pass)) - 1;
    DigitRun run;
    const auto count = [&](int64_t, uint32_t key) {
        run.add(h, (key >> shift) & digit, (key & s.mask) == s.prefix);
    };
    for_keys<kLongThreads>(src, n, count);
    run.flush(h);
    __syncthreads();
    for (int k = threadIdx.x; k < kBins; k += kLongThreads)
        if (h[k]) atomicAdd(gh + k, h[k]);
}

// Pass `pass` over the long rows: blockIdx.x = chunk block * 3M + (mm
// level, value set). The plan lists the long segments and each one's first
// chunk block ([n_long] ids, [n_long + 1] first blocks); null: segment 0
// alone. The row's last block to finish (a ticket) resolves the pass: it
// picks the digits from the row's histogram (and clears it for the next
// pass), advances the row's state and, once the median is known, writes
// it. Rows already done return at once.
__global__ void __launch_bounds__(kLongThreads) median_long_kernel(
        const int64_t* __restrict__ total, const float* __restrict__ clon_f,
        const float* __restrict__ clonR_f,
        const int64_t* __restrict__ counted,
        const int64_t* __restrict__ rarefied, int M, int64_t L, Segments g,
        const int64_t* __restrict__ plan, int n_long, int64_t chunk,
        int pass, uint32_t* __restrict__ state,   // [R, 8]
        uint32_t* __restrict__ hist,              // [R, kBins], zeroed
        uint32_t* __restrict__ tickets,           // [R], zeroed
        float* __restrict__ out) {                // [3, S, M]
    __shared__ uint32_t h[kBins];
    __shared__ int smem[kLongThreads / 32 + 1];
    __shared__ uint32_t res[4];
    __shared__ uint32_t mm[2 * kLongThreads / 32];
    __shared__ int s_last;
    const int R3 = 3 * M;
    const int rr = blockIdx.x % R3;
    const int64_t cbg = blockIdx.x / R3;
    int i = 0, s = 0;
    int64_t first = 0, nb = gridDim.x / R3;
    if (plan) {
        const int64_t* fb = plan + n_long;
        int a = 0, b = n_long - 1;
        while (a < b) {
            const int mid = (a + b + 1) >> 1;
            if (fb[mid] <= cbg) a = mid; else b = mid - 1;
        }
        i = a;
        s = (int)plan[i];
        first = fb[i];
        nb = fb[i + 1] - first;
    }
    const int64_t cb = cbg - first;
    const MedianRow r = median_row(g, M, s, rr, counted, rarefied, out);
    if (r.count <= 0) {
        if (pass == 0 && cb == 0 && threadIdx.x == 0)
            *r.out = __uint_as_float(0x7fc00000u);
        return;
    }
    const int64_t lr = (int64_t)i * R3 + rr;
    uint32_t* st = state + lr * 8;
    uint32_t* gh = hist + lr * kBins;
    Sel sel = sel_start(r.count);
    if (pass > 0) {
        sel.prefix = st[0];
        sel.prefix2 = st[1];
        sel.mask = st[2];
        sel.k1 = st[3];
        sel.k2 = st[4];
        sel.phase = st[5];
    }
    if (sel.phase == kDone) return;
    const int64_t a = cb * chunk, n = min(r.n, a + chunk) - a;
    const int64_t row0 = (int64_t)r.m * L + r.off + a;
    if (r.which == 0)
        long_block(total + row0, n, sel, pass, h, mm, st, gh);
    else
        long_block((r.which == 1 ? clon_f : clonR_f) + row0, n, sel, pass, h,
                   mm, st, gh);
    // the row's last block to finish resolves the pass
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(tickets + lr, 1u) == nb - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    if (sel.phase == kSplit) {
        if (threadIdx.x == 0) {
            *r.out = median_of(__ldcg(st + 6), __ldcg(st + 7));
            st[5] = kDone;
            tickets[lr] = 0;
        }
        return;
    }
    for (int k = threadIdx.x; k < kBins; k += kLongThreads) {
        h[k] = __ldcg(gh + k);
        gh[k] = 0;
    }
    __syncthreads();
    find_bins<kLongThreads>(h, sel.k1, sel.k2, res, smem);
    sel_narrow(sel, pass, res[0], res[1], res[2]);
    if (threadIdx.x == 0) {
        tickets[lr] = 0;
        if (sel.phase == kDone) *r.out = median_of(sel.prefix, sel.prefix2);
        st[0] = sel.prefix;
        st[1] = sel.prefix2;
        st[2] = sel.mask;
        st[3] = sel.k1;
        st[4] = sel.k2;
        st[5] = sel.phase;
        st[6] = 0;
        st[7] = 0xFFFFFFFFu;
    }
}

}  // namespace

extern "C" int instrain_rows_count(const void* row, const void* any_snp,
                                   int M, int64_t L, const void* seg_table,
                                   int S, int64_t n_tiles, void* block_rows,
                                   void* block_pos, void* sizes,
                                   void* seg_rows, void* seg_pos,
                                   void* stream) {
    const Segments g = instrain::segments(seg_table, S, L);
    cudaStream_t s = (cudaStream_t)stream;
    rows_count_kernel<<<(unsigned)((n_tiles + kWarps - 1) / kWarps), kThreads,
                        0, s>>>(
        (const bool*)row, (const bool*)any_snp, M, L, g, n_tiles,
        (int*)block_rows, (int*)block_pos);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    rows_scan_kernel<<<1, kScanThreads, 0, s>>>(
        (int*)block_rows, (int*)block_pos, (int)n_tiles, g, (int*)sizes,
        (int*)seg_rows, (int*)seg_pos);
    return (int)cudaGetLastError();
}

extern "C" int instrain_rows_gather(
        const void* row, const void* any_snp, const void* cum,
        const void* total, const void* con, const void* var,
        const void* morphia, const void* cls, const void* cryptic,
        const void* present, int M, int64_t L, const void* seg_table, int S,
        int64_t n_tiles, const void* row_off, const void* pos_off,
        int n_rows, int n_pos, void* r_i32, void* r_total, void* r_codes,
        void* r_cryptic, void* l_pos, void* l_cum, void* l_present,
        void* stream) {
    const int slab = M < kSlab ? M : kSlab;
    const size_t smem = (size_t)(2 + slab) * kThreads * sizeof(int) +
                        (size_t)slab * kThreads;
    rows_gather_kernel<<<(unsigned)n_tiles, kThreads, smem,
                         (cudaStream_t)stream>>>(
        (const bool*)row, (const bool*)any_snp, (const int32_t*)cum,
        (const int64_t*)total, (const int8_t*)con, (const int8_t*)var,
        (const int8_t*)morphia, (const int8_t*)cls, (const bool*)cryptic,
        (const bool*)present, M, L, instrain::segments(seg_table, S, L),
        slab, (const int*)row_off, (const int*)pos_off, n_rows, n_pos,
        (int32_t*)r_i32, (int64_t*)r_total, (int8_t*)r_codes,
        (bool*)r_cryptic, (int32_t*)l_pos, (int32_t*)l_cum,
        (bool*)l_present);
    return (int)cudaGetLastError();
}

// agg: one buffer of the [kNumInt, S, M] integer aggregates, then the
// [2, S, M] f64 sums, then [S, M] mm_active, zeroed here. per: positions
// a thread, 1 (n_blocks: the table's tiles) or kAggPer (its big tiles)
extern "C" int instrain_mm_aggregates(
        const void* total, const void* clon, const void* clonR,
        const void* row, const void* morphia, const void* cls,
        const void* present, int M, int64_t L, const void* seg_table, int S,
        int per, int64_t n_blocks, void* agg, void* clon_f, void* clonR_f,
        void* stream) {
    if (per != 1 && per != kAggPer) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t SM = (int64_t)S * M;
    cudaError_t e = cudaMemsetAsync(agg, 0, (size_t)SM * (8 * (kNumInt + 2)
                                                          + 1), st);
    if (e != cudaSuccess) return (int)e;
    unsigned long long* agg_i = (unsigned long long*)agg;
    double* agg_f = (double*)(agg_i + kNumInt * SM);
    auto kernel = per == 1 ? mm_aggregates_kernel<1>
                           : mm_aggregates_kernel<kAggPer>;
    kernel<<<(unsigned)n_blocks, kAggThreads, 0, st>>>(
        (const int64_t*)total, (const float*)clon, (const float*)clonR,
        (const bool*)row, (const int8_t*)morphia, (const int8_t*)cls,
        (const bool*)present, M, L, instrain::segments(seg_table, S, L),
        agg_i, agg_f, (bool*)(agg_f + 2 * SM), (float*)clon_f,
        (float*)clonR_f);
    return (int)cudaGetLastError();
}

// The short rows: one block per (segment, mm level, value set) row of the
// chunk, short_keys the longest short segment rounded up to a multiple of 4
extern "C" int instrain_median_short(
        const void* total, const void* clon_f, const void* clonR_f,
        const void* counted, const void* rarefied, int M, int64_t L,
        const void* seg_table, int S, int short_keys, void* out,
        void* stream) {
    if (short_keys < 1 || short_keys > kShortKeysMax)
        return (int)cudaErrorInvalidValue;
    // the kernel's dynamic shared memory limit, raised once per device to
    // what the longest short row takes (devices past 63: at every call)
    static std::atomic<uint64_t> raised{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const uint64_t bit = dev < 64 ? 1ull << dev : 0;
    if (!(raised.load() & bit)) {
        e = cudaFuncSetAttribute(
            median_short_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            kShortKeysMax * (int)sizeof(uint32_t));
        if (e != cudaSuccess) return (int)e;
        raised.fetch_or(bit);
    }
    const int smem = short_keys * (int)sizeof(uint32_t);
    median_short_kernel<<<(unsigned)((int64_t)S * 3 * M), kShortThreads, smem,
                          (cudaStream_t)stream>>>(
        (const int64_t*)total, (const float*)clon_f, (const float*)clonR_f,
        (const int64_t*)counted, (const int64_t*)rarefied, M, L,
        instrain::segments(seg_table, S, L), short_keys, (float*)out);
    return (int)cudaGetLastError();
}

// The long rows: n_long segments of n_blocks chunk blocks in all, each
// (segment, mm level, value set) row through three launches on the
// stream. scratch: [R, 8] states, [R, kBins] histograms and [R] tickets
// (R = n_long * 3 * M), the last two zeroed here.
extern "C" int instrain_median_long(
        const void* total, const void* clon_f, const void* clonR_f,
        const void* counted, const void* rarefied, int M, int64_t L,
        const void* seg_table, int S, const void* plan, int n_long,
        int64_t chunk, int64_t n_blocks, void* scratch, void* out,
        void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t R = (int64_t)n_long * 3 * M;
    uint32_t* state = (uint32_t*)scratch;
    uint32_t* hist = state + R * 8;
    uint32_t* tickets = hist + R * kBins;
    cudaError_t e = cudaMemsetAsync(hist, 0, (size_t)R * (kBins + 1) *
                                    sizeof(uint32_t), s);
    if (e != cudaSuccess) return (int)e;
    const Segments g = instrain::segments(seg_table, S, L);
    for (int pass = 0; pass < 3; ++pass) {
        median_long_kernel<<<(unsigned)(n_blocks * 3 * M), kLongThreads, 0,
                             s>>>(
            (const int64_t*)total, (const float*)clon_f,
            (const float*)clonR_f, (const int64_t*)counted,
            (const int64_t*)rarefied, M, L, g, (const int64_t*)plan, n_long,
            chunk, pass, state, hist, tickets, (float*)out);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}
