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
// Position-tiled kernels (C1, C2) run one block per tile of 256 positions
// of one segment, so a block's reductions and scans never mix scaffolds;
// positions are counted from the segment's start, as the JAX batch engine
// counts them per scaffold.
//
// Three kernels, each memory-bound (a few integer operations per byte):
//
//  C1 select_rows — a two-pass stream compaction sized exactly, in place
//     of the TPU's lax.top_k. (a) rows_count: each block counts the set
//     cells of `row` and the set positions of `any_snp` in its tile of
//     positions; (b) rows_scan: one block scans the per-block counts into
//     offsets and writes the two totals (one 8-byte read for the host,
//     which then allocates the outputs); (c) rows_gather: each block
//     recounts, scans within the block (warp shuffles) and writes each SNP
//     record, and the linkage profile of each SNV position, at its offset.
//     One thread per position walks m = 0..M-1, so the records come out in
//     ascending (segment, position, mm) order: per scaffold, JAX's flat
//     index p * Mp + m. The scan also writes each segment's first row and
//     first SNV position (the offsets of its first tile), so the host
//     splits the records by scaffold exactly.
//  C2 mm_aggregates — one thread per position walks m = 0..M-1 and keeps
//     three forward-fill states in registers (clon, clonR, and the packed
//     morphia << 3 | class code over `row`), in place of the TPU's
//     log2(M) doubling passes. Per mm level the block reduces its values
//     with warp shuffles and shared memory and then adds them into the
//     [S, M] aggregates with one global atomic per block and quantity. The
//     f64 sums are exact in any order (each value is a multiple of 2^-27
//     in [0.125, 1], and a segment has far fewer than 2^26 positions), so
//     f64 atomicAdd gives the JAX sums bit for bit. It also writes the
//     forward-filled clon and clonR (+inf where nothing is set) to f32
//     scratch for C3.
//  C3 masked_median — one block per (segment, mm level, value set) runs a
//     radix select on the f32 bit pattern: four 8-bit histogram passes narrow
//     the prefix to the k1-th smallest value; one more pass counts the
//     values <= v1 and finds the smallest above it, which gives the
//     adjacent k2-th. Every value is >= 0 or +inf, so the unsigned bit
//     order is the value order. Shared histograms use warp-aggregated
//     atomics (__match_any_sync), because coverages cluster on few values.
//     The median is (v1 + v2) / 2 with one rounded f32 addition. The
//     select is a template on the value set (int64 coverage or f32
//     clonality), so each instance's loops read one type: with the set
//     chosen per load inside one loop, the kernel took 20 % longer at
//     M = 8, L = 2^20 on an NVIDIA H100 80GB HBM3 at 700 W.
//
// M has no fixed cap: C2 reduces one mm level at a time and C3 takes one
// block per level. Indices into [M, Ltot] arrays are 64-bit; record counts
// are 32-bit (the wrapper checks M * Ltot < 2^31).

#include <cuda_runtime.h>
#include <stdint.h>

#include "segments.cuh"

namespace {

using instrain::Segments;
using instrain::TilePos;
using instrain::tile_position;

constexpr int kThreads = instrain::kTile;     // C1 and C2: positions/block
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;            // C1 (b)
constexpr int kMedianThreads = 1024;          // C3
constexpr int kMedianUnroll = 8;              // loads in flight per thread
constexpr uint32_t kInfBits = 0x7F800000u;
constexpr int kNumInt = 10;                   // integer aggregates, C2
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

__device__ __forceinline__ int row_count_at(const bool* __restrict__ row,
                                            int M, int64_t L,
                                            const TilePos& t) {
    int c = 0;
    if (t.p_local < t.len)
        for (int m = 0; m < M; ++m) c += row[(int64_t)m * L + t.p];
    return c;
}

__global__ void rows_count_kernel(const bool* __restrict__ row,
                                  const bool* __restrict__ any_snp, int M,
                                  int64_t L, Segments g,
                                  int* __restrict__ block_rows,
                                  int* __restrict__ block_pos) {
    __shared__ int s_rows[kWarps], s_pos[kWarps];
    const TilePos t = tile_position(g, blockIdx.x);
    const int cr = warp_sum(row_count_at(row, M, L, t));
    const int cp = warp_sum((int)(t.p_local < t.len && any_snp[t.p]));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) { s_rows[warp] = cr; s_pos[warp] = cp; }
    __syncthreads();
    if (threadIdx.x == 0) {
        int a = 0, b = 0;
        for (int w = 0; w < kWarps; ++w) { a += s_rows[w]; b += s_pos[w]; }
        block_rows[blockIdx.x] = a;
        block_pos[blockIdx.x] = b;
    }
}

// One block: block counts -> exclusive offsets (in place), totals -> sizes
// [n_rows, n_pos], and each segment's first row and first SNV position ->
// seg_rows / seg_pos [S + 1] (entry S: the totals)
__global__ void rows_scan_kernel(int* __restrict__ block_rows,
                                 int* __restrict__ block_pos, int nblocks,
                                 Segments g, int* __restrict__ sizes,
                                 int* __restrict__ seg_rows,
                                 int* __restrict__ seg_pos) {
    __shared__ int smem[kScanThreads / 32 + 1];
    int carry_rows = 0, carry_pos = 0;
    for (int base = 0; base < nblocks; base += kScanThreads) {
        const int i = base + threadIdx.x;
        const int r = i < nblocks ? block_rows[i] : 0;
        const int q = i < nblocks ? block_pos[i] : 0;
        int tr, tq;
        const int er = block_exclusive_scan<kScanThreads>(r, &tr, smem);
        const int eq = block_exclusive_scan<kScanThreads>(q, &tq, smem);
        if (i < nblocks) {
            block_rows[i] = carry_rows + er;
            block_pos[i] = carry_pos + eq;
        }
        carry_rows += tr;
        carry_pos += tq;
    }
    if (threadIdx.x == 0) { sizes[0] = carry_rows; sizes[1] = carry_pos; }
    __syncthreads();                       // the offsets are written
    for (int s = threadIdx.x; s <= g.S; s += kScanThreads) {
        const int64_t b = instrain::seg_tile0(g, s);
        seg_rows[s] = b < nblocks ? block_rows[b] : carry_rows;
        seg_pos[s] = b < nblocks ? block_pos[b] : carry_pos;
    }
}

__global__ void rows_gather_kernel(
        const bool* __restrict__ row, const bool* __restrict__ any_snp,
        const int32_t* __restrict__ cum, const int64_t* __restrict__ total,
        const int8_t* __restrict__ con, const int8_t* __restrict__ var,
        const int8_t* __restrict__ morphia, const int8_t* __restrict__ cls,
        const bool* __restrict__ cryptic, const bool* __restrict__ present,
        int M, int64_t L, Segments g, const int* __restrict__ row_off,
        const int* __restrict__ pos_off, int n_rows, int n_pos,
        int32_t* __restrict__ r_i32,      // [6, n_rows] pos mm A C T G
        int64_t* __restrict__ r_total,    // [n_rows]
        int8_t* __restrict__ r_codes,     // [4, n_rows] con var morphia cls
        bool* __restrict__ r_cryptic,     // [n_rows]
        int32_t* __restrict__ l_pos,      // [n_pos]
        int32_t* __restrict__ l_cum,      // [M, 4, n_pos]
        bool* __restrict__ l_present) {   // [M, n_pos]
    __shared__ int smem[kWarps + 1];
    const TilePos t = tile_position(g, blockIdx.x);
    const int64_t p = t.p;
    const int cr = row_count_at(row, M, L, t);
    const int cp = (int)(t.p_local < t.len && any_snp[p]);
    int unused;
    int j = row_off[blockIdx.x] +
            block_exclusive_scan<kThreads>(cr, &unused, smem);
    const int k = pos_off[blockIdx.x] +
                  block_exclusive_scan<kThreads>(cp, &unused, smem);
    if (t.p_local >= t.len) return;
    if (cr > 0) {
        const bool cry = cryptic[p];
        for (int m = 0; m < M; ++m) {
            const int64_t cell = (int64_t)m * L + p;
            if (!row[cell]) continue;
            const int64_t c4 = (int64_t)m * 4 * L + p;
            r_i32[j] = (int32_t)t.p_local;
            r_i32[(int64_t)n_rows + j] = m;
            for (int b = 0; b < 4; ++b)
                r_i32[(int64_t)(2 + b) * n_rows + j] = cum[c4 + b * L];
            r_total[j] = total[cell];
            r_codes[j] = con[cell];
            r_codes[(int64_t)n_rows + j] = var[cell];
            r_codes[(int64_t)2 * n_rows + j] = morphia[cell];
            r_codes[(int64_t)3 * n_rows + j] = cls[cell];
            r_cryptic[j] = cry;
            ++j;
        }
    }
    if (cp) {
        l_pos[k] = (int32_t)t.p_local;
        for (int m = 0; m < M; ++m) {
            for (int b = 0; b < 4; ++b)
                l_cum[((int64_t)m * 4 + b) * n_pos + k] =
                    cum[((int64_t)m * 4 + b) * L + p];
            l_present[(int64_t)m * n_pos + k] = present[(int64_t)m * L + p];
        }
    }
}

// ------------------------------------------------------------------ C2

__global__ void mm_aggregates_kernel(
        const int64_t* __restrict__ total, const float* __restrict__ clon,
        const float* __restrict__ clonR, const bool* __restrict__ row,
        const int8_t* __restrict__ morphia, const int8_t* __restrict__ cls,
        const bool* __restrict__ present, int M, int64_t L, Segments g,
        unsigned long long* __restrict__ agg_i,   // [kNumInt, S, M], zeroed
        double* __restrict__ agg_f,               // [2, S, M], zeroed
        bool* __restrict__ mm_active,             // [S, M], zeroed
        float* __restrict__ clon_f, float* __restrict__ clonR_f) {
    __shared__ unsigned long long s_i[kWarps][kNumInt];
    __shared__ double s_f[kWarps][2];
    const TilePos tp = tile_position(g, blockIdx.x);
    const int64_t p = tp.p;
    const bool valid = tp.p_local < tp.len;
    const int64_t SM = (int64_t)g.S * M, sm0 = (int64_t)tp.s * M;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float inf = __uint_as_float(kInfBits);
    float cf = inf, rf = inf;              // filled clon / clonR
    int enc = -1;                          // filled morphia << 3 | cls

    for (int m = 0; m < M; ++m) {
        const int64_t cell = (int64_t)m * L + p;
        unsigned long long v[kNumInt];
        double f[2] = {0.0, 0.0};
        bool pr = false;
        for (int q = 0; q < kNumInt; ++q) v[q] = 0;
        if (valid) {
            const int64_t t = total[cell];
            const float c = clon[cell], r = clonR[cell];
            if (c == c) cf = c;            // set where not NaN
            if (r == r) rf = r;
            if (row[cell]) enc = ((int)morphia[cell] << 3) | (int)cls[cell];
            pr = present[cell];
            clon_f[cell] = cf;
            clonR_f[cell] = rf;
            const bool has_c = cf != inf, has_r = rf != inf;
            const bool have_row = enc >= 0;
            const int mor = enc >> 3, k = enc & 7;
            v[0] = (unsigned long long)t;
            v[1] = (unsigned long long)(t * t);
            v[2] = t > 0;
            v[3] = has_c;
            v[4] = has_r;
            v[5] = have_row;
            v[6] = have_row && mor == 1;
            v[7] = have_row && mor > 1;
            v[8] = have_row && (k == kSNS || k == kConSNV || k == kPopSNV);
            v[9] = have_row && (k == kSNS || k == kPopSNV);
            if (has_c) f[0] = (double)cf;
            if (has_r) f[1] = (double)rf;
        }
        for (int q = 0; q < kNumInt; ++q) v[q] = warp_sum(v[q]);
        f[0] = warp_sum(f[0]);
        f[1] = warp_sum(f[1]);
        if (lane == 0) {
            for (int q = 0; q < kNumInt; ++q) s_i[warp][q] = v[q];
            s_f[warp][0] = f[0];
            s_f[warp][1] = f[1];
        }
        const int active = __syncthreads_or(pr);    // also the barrier
        if (threadIdx.x < kNumInt) {
            unsigned long long s = 0;
            for (int w = 0; w < kWarps; ++w) s += s_i[w][threadIdx.x];
            if (s) atomicAdd(agg_i + threadIdx.x * SM + sm0 + m, s);
        } else if (threadIdx.x < kNumInt + 2) {
            const int q = threadIdx.x - kNumInt;
            double s = 0.0;
            for (int w = 0; w < kWarps; ++w) s += s_f[w][q];
            if (s != 0.0) atomicAdd(agg_f + q * SM + sm0 + m, s);
        } else if (threadIdx.x == kNumInt + 2 && active) {
            mm_active[sm0 + m] = true;
        }
        __syncthreads();                   // before s_i / s_f are reused
    }
}

// ------------------------------------------------------------------ C3

// bit pattern of value p of a row: int64 coverage as f32 (kTotal) or the
// f32 filled clon / clonR; every value is >= 0 or +inf, so the unsigned
// bit order is the value order
template <bool kTotal>
__device__ __forceinline__ uint32_t row_bits(const int64_t* __restrict__ t,
                                             const float* __restrict__ v,
                                             int64_t p) {
    if (kTotal) return __float_as_uint((float)t[p]);
    return __float_as_uint(v[p]);
}

// The (k1, k2)-th smallest of the n values of one row, averaged: a radix
// select on the bit pattern (four 8-bit histogram passes narrow the
// prefix to the k1-th; one more pass counts the values <= v1 and finds
// the smallest above it). Run by a whole block of kMedianThreads.
template <bool kTotal>
__device__ float row_median(const int64_t* __restrict__ t,
                            const float* __restrict__ v, int64_t n,
                            int64_t k1, int64_t k2) {
    __shared__ unsigned int hist[256];
    __shared__ unsigned int s_digit, s_below;
    __shared__ unsigned long long s_cnt[kMedianThreads / 32];
    __shared__ uint32_t s_min[kMedianThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t step = (int64_t)kMedianThreads * kMedianUnroll;

    uint32_t prefix = 0, mask = 0;
    unsigned int k = (unsigned int)k1;     // rank within the prefix's set
    for (int shift = 24; shift >= 0; shift -= 8) {
        for (int i = threadIdx.x; i < 256; i += kMedianThreads) hist[i] = 0;
        __syncthreads();
        for (int64_t base = 0; base < n; base += step) {
            uint32_t b[kMedianUnroll];
#pragma unroll
            for (int u = 0; u < kMedianUnroll; ++u) {
                const int64_t p = base + (int64_t)u * kMedianThreads +
                                  threadIdx.x;
                b[u] = p < n ? row_bits<kTotal>(t, v, p) : 0xFFFFFFFFu;
            }
#pragma unroll
            for (int u = 0; u < kMedianUnroll; ++u) {
                const int64_t p = base + (int64_t)u * kMedianThreads +
                                  threadIdx.x;
                const unsigned key = (p < n && (b[u] & mask) == prefix)
                                     ? (b[u] >> shift) & 255u : 256u;
                const unsigned peers = __match_any_sync(0xffffffffu, key);
                if (key < 256u && lane == __ffs(peers) - 1)
                    atomicAdd(&hist[key], (unsigned)__popc(peers));
            }
        }
        __syncthreads();
        if (warp == 0) {
            // lane l holds bins 8l .. 8l+7; find the bin holding rank k
            unsigned int h[8], sum = 0;
            for (int i = 0; i < 8; ++i) {
                h[i] = hist[lane * 8 + i];
                sum += h[i];
            }
            unsigned int inc = sum;
            for (int o = 1; o < 32; o <<= 1) {
                const unsigned int x = __shfl_up_sync(0xffffffffu, inc, o);
                if (lane >= o) inc += x;
            }
            const unsigned int before = inc - sum;
            const unsigned hit = __ballot_sync(0xffffffffu,
                                               before < k && k <= inc);
            if (lane == __ffs(hit) - 1) {
                unsigned int below = before;
                int d = lane * 8;
                for (int i = 0; i < 8; ++i, ++d) {
                    if (below + h[i] >= k) break;
                    below += h[i];
                }
                s_digit = (unsigned)d;
                s_below = below;
            }
        }
        __syncthreads();
        prefix |= s_digit << shift;
        mask |= 255u << shift;
        k -= s_below;
        __syncthreads();                   // s_digit / s_below reused
    }
    const uint32_t v1 = prefix;

    // the upper middle statistic is v1 or the smallest value above it
    unsigned long long le = 0;
    uint32_t above = kInfBits;
    for (int64_t p = threadIdx.x; p < n; p += kMedianThreads) {
        const uint32_t b = row_bits<kTotal>(t, v, p);
        if (b <= v1) ++le;
        else if (b < above) above = b;
    }
    le = warp_sum(le);
    for (int o = 16; o > 0; o >>= 1)
        above = min(above, __shfl_down_sync(0xffffffffu, above, o));
    if (lane == 0) { s_cnt[warp] = le; s_min[warp] = above; }
    __syncthreads();
    unsigned long long cnt = 0;
    uint32_t mn = kInfBits;
    for (int w = 0; w < kMedianThreads / 32; ++w) {
        cnt += s_cnt[w];
        mn = min(mn, s_min[w]);
    }
    const uint32_t v2 = (int64_t)cnt >= k2 ? v1 : mn;
    return __fmul_rn(__fadd_rn(__uint_as_float(v1), __uint_as_float(v2)),
                     0.5f);
}

__global__ void masked_median_kernel(
        const int64_t* __restrict__ total, const float* __restrict__ clon_f,
        const float* __restrict__ clonR_f,
        const int64_t* __restrict__ counted,
        const int64_t* __restrict__ rarefied, int M, int64_t L, Segments g,
        float* __restrict__ out) {                 // [3, S, M]
    const int sm = blockIdx.x, which = blockIdx.y;  // sm = s * M + m
    const int s = sm / M, m = sm - s * M;
    const int64_t off = instrain::seg_off(g, s);
    const int64_t n = instrain::seg_off(g, s + 1) - off;
    const int64_t count = which == 0 ? n
                          : which == 1 ? counted[sm] : rarefied[sm];
    float med = __uint_as_float(0x7fc00000u);      // NaN: nothing counted
    if (count > 0) {
        const int64_t row0 = (int64_t)m * L + off;
        const int64_t k1 = (count - 1) / 2 + 1, k2 = count / 2 + 1;
        med = which == 0
              ? row_median<true>(total + row0, nullptr, n, k1, k2)
              : row_median<false>(nullptr, (which == 1 ? clon_f : clonR_f)
                                  + row0, n, k1, k2);
    }
    if (threadIdx.x == 0) out[(int64_t)which * g.S * M + sm] = med;
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
    rows_count_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
        (const bool*)row, (const bool*)any_snp, M, L, g, (int*)block_rows,
        (int*)block_pos);
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
    rows_gather_kernel<<<(unsigned)n_tiles, kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const bool*)row, (const bool*)any_snp, (const int32_t*)cum,
        (const int64_t*)total, (const int8_t*)con, (const int8_t*)var,
        (const int8_t*)morphia, (const int8_t*)cls, (const bool*)cryptic,
        (const bool*)present, M, L, instrain::segments(seg_table, S, L),
        (const int*)row_off, (const int*)pos_off, n_rows, n_pos,
        (int32_t*)r_i32, (int64_t*)r_total, (int8_t*)r_codes,
        (bool*)r_cryptic, (int32_t*)l_pos, (int32_t*)l_cum,
        (bool*)l_present);
    return (int)cudaGetLastError();
}

extern "C" int instrain_mm_aggregates(
        const void* total, const void* clon, const void* clonR,
        const void* row, const void* morphia, const void* cls,
        const void* present, int M, int64_t L, const void* seg_table, int S,
        int64_t n_tiles, void* agg_i, void* agg_f, void* mm_active,
        void* clon_f, void* clonR_f, void* stream) {
    mm_aggregates_kernel<<<(unsigned)n_tiles, kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const int64_t*)total, (const float*)clon, (const float*)clonR,
        (const bool*)row, (const int8_t*)morphia, (const int8_t*)cls,
        (const bool*)present, M, L, instrain::segments(seg_table, S, L),
        (unsigned long long*)agg_i, (double*)agg_f, (bool*)mm_active,
        (float*)clon_f, (float*)clonR_f);
    return (int)cudaGetLastError();
}

extern "C" int instrain_masked_median(
        const void* total, const void* clon_f, const void* clonR_f,
        const void* counted, const void* rarefied, int M, int64_t L,
        const void* seg_table, int S, void* out, void* stream) {
    masked_median_kernel<<<dim3((unsigned)(S * M), 3), kMedianThreads, 0,
                           (cudaStream_t)stream>>>(
        (const int64_t*)total, (const float*)clon_f, (const float*)clonR_f,
        (const int64_t*)counted, (const int64_t*)rarefied, M, L,
        instrain::segments(seg_table, S, L), (float*)out);
    return (int)cudaGetLastError();
}
