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
// an int32 correction (its flat index, count - 255), in flat order. The
// table (kernels/sitestats.py:SparseWire, int64 rows of S + 1) holds per
// scaffold its first entry, first correction, first tile of kTileEntries
// entries, flat stride Lp and first position in the chunk. The output is
// the chunk's int32 counts [M, 4, Ltot], scaffold s's positions at
// [off[s], off[s + 1]): the padding of the packed tensor (p >= L, m >= M),
// where only zero-value entries can land, never reaches it.
//
// Bound: bytes. The output is 4 bytes a cell and the wire 3 bytes an entry
// (8 a correction); at the 5-15 % density of the main paths the output is
// nine tenths of them, so K8 is at best as fast as a memset of its output.
// An earlier design zeroed the output with a memset, then stored the
// nonzero cells one by one, 4 bytes each, into sectors the memset had
// already pushed out of L2 (42-48 % of the bound). This one stores every
// cell exactly once, in 16-byte stores of whole windows, with no memset
// and no atomics, in four launches, each after the first started while the
// one before it runs (programmatic dependent launch):
//  (a) sums: a block a tile of kTileEntries entries of one scaffold (a
//      tile never spans two) sums its deltas.
//  (b) index: a block a tile adds the sums of its scaffold's tiles before
//      it, scans its deltas (kPer consecutive entries a thread, then the
//      block scan of scan.cuh; the deltas mostly hit L2 the second time)
//      and writes each entry's flat index cumsum(delta) - 1 to the int32
//      scratch idx[V].
//  (c) marks: a warp a query finds, by a search of 32 probes a round, the
//      first entry and the first correction at or past a flat index: for
//      each window's first cell (and the scaffold holding it), and for each
//      row start r * Lp of each scaffold (r <= 4 M).
//  (d) fill: the flat output cut into windows of kWindow cells (32 KB),
//      aligned to the buffer, so every window costs the same whatever the
//      density and only the buffer's end is ragged (4 M Ltot cells, a
//      multiple of 4); a block a window, launched in order as a memset's
//      blocks are, so the windows being written at any time lie together.
//      A window is a run of segments, each one row of one scaffold, whose
//      first and end items are marks of (c). The block zeroes the window in
//      shared memory, places the entries of nonzero value, then after a
//      barrier adds the corrections (one entry and one correction at most a
//      cell, so plain stores), and stores the window with int4 stores.
//      Entries of value 0 (a gap's links, a zero-padded tail that repeats
//      the last index) place nothing, and the padding is no segment's.
// What shaped it (measured on an NVIDIA H100 80GB HBM3): a block a window
// that only zeroes and stores its window runs at a memset's rate, so the
// fill's cost over a memset is the chain of dependent reads a window waits
// on (its marks, then its items) under the write traffic. The fill keeps
// that chain to two loads, and the searches for the marks run apart, in
// (c), where every query's latency overlaps every other's. A search inside
// each window, runs of windows a block carrying their pointers, and a
// tile-by-tile decoupled look-back in one launch were all slower (with
// every tile looking back at once, the prefixes spread 32 tiles a round).

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

using instrain::block_exclusive_scan;
using instrain::warp_sum;

constexpr int kThreads = 256;                    // (a), (b), (c)
constexpr int kPer = 8;                          // (b): entries a thread
constexpr int kTileEntries = kThreads * kPer;    // sitestats.WIRE_TILE
constexpr int kWindow = 8192;                    // cuda_compact.DENSIFY_WINDOW
constexpr int kFillThreads = 128;                // (d)
constexpr int kFillBlocks = 6;                   // (d): blocks an SM
constexpr int kAhead = 4;                        // (d): items a thread loads at once
constexpr int kBatch = kAhead * kFillThreads;    // (d): items a block loads at once

// The wire's table: rows e_off, c_off, tile0, Lp, off of S + 1 each
struct Wire {
    const int64_t* t;
    int S;
    __device__ __forceinline__ const int64_t* row(int r) const {
        return t + (int64_t)r * (S + 1);
    }
};

// (c)'s marks of the entries or of the corrections: the first item at or
// past each row start of each scaffold (rows [S, R + 1]: flat r * Lp, the
// last R * Lp) and past each window's first cell, in the scaffold holding
// it (windows [n_windows])
struct Marks {
    int64_t* rows;
    int64_t* windows;
};

// One round of a search by a warp for the first i in [*lo, *hi) with
// a[i] >= x (*hi where none does; a non-decreasing there): the lanes probe
// 32 items spaced evenly, and the span left is past the last below x and
// at or before the next. *more is set while a span is left.
template <typename T>
__device__ __forceinline__ void warp_narrow(const T* a, int64_t* lo,
                                            int64_t* hi, int64_t x,
                                            bool* more) {
    const int64_t n = *hi - *lo;
    const int64_t step = (n + 31) / 32;
    const int64_t p = *lo + (threadIdx.x & 31) * step;
    const unsigned below = __ballot_sync(~0u, n > 0 && p < *hi &&
                                               (int64_t)a[p] < x);
    if (n > 0) {
        if (!below) {
            *hi = *lo;
        } else {
            const int64_t last = *lo + (int64_t)(__popc(below) - 1) * step;
            *hi = last + step < *hi ? last + step : *hi;
            *lo = last + 1;
        }
    }
    *more |= *lo < *hi;
}

// The first i in [lo, hi) with a[i] >= x, or hi, to every lane of the warp
template <typename T>
__device__ __forceinline__ int64_t warp_lower_bound(const T* a, int64_t lo,
                                                    int64_t hi, int64_t x) {
    for (bool more = lo < hi; more;) {
        more = false;
        warp_narrow(a, &lo, &hi, x, &more);
    }
    return lo;
}

// Programmatic dependent launch (sm_90): a kernel launched with
// launch_after() after another of the same call starts while that one
// runs, reads only the call's inputs and writes nothing to global memory
// until it has waited for all of that one's output (every earlier kernel
// of the call has finished by then); each lets the next start as soon as
// it has started itself
__device__ __forceinline__ void start_next() {
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_previous() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Sum of the block's values, to every thread
__device__ __forceinline__ int64_t block_sum(int64_t v, int64_t* red) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    int64_t t = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) t += red[k];
    __syncthreads();
    return t;
}

// A tile's scaffold s, the scaffold's first tile, the tile's entries
// [e0, e0 + n) and the scaffold's end
struct Tile {
    int s;
    int64_t first, e0, e_end;
    int n;
};

__device__ __forceinline__ Tile tile_of(const Wire& w, int64_t tile) {
    Tile t;
    // the last scaffold with tile0[s] <= tile
    t.s = (int)warp_lower_bound(w.row(2), 0, w.S + 1, tile + 1) - 1;
    t.first = w.row(2)[t.s];
    t.e0 = w.row(0)[t.s] + (tile - t.first) * kTileEntries;
    t.e_end = w.row(0)[t.s + 1];
    t.n = t.e_end - t.e0 < kTileEntries ? (int)(t.e_end - t.e0)
                                        : kTileEntries;
    return t;
}

// (a) a block a tile: its sum of deltas (< 2048 * 65536)
__global__ void __launch_bounds__(kThreads) sums_kernel(
        const uint16_t* __restrict__ deltas, Wire w,
        int32_t* __restrict__ sums) {
    __shared__ int64_t red[kThreads / 32];
    start_next();
    const Tile t = tile_of(w, blockIdx.x);
    int64_t acc = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int j = k * kThreads + threadIdx.x;
        if (j < t.n) acc += deltas[t.e0 + j];
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) sums[blockIdx.x] = (int32_t)acc;
}

// (b) a block a tile: the sum of its scaffold's tiles before it, then its
// entries' flat indices
__global__ void __launch_bounds__(kThreads) index_kernel(
        const uint16_t* __restrict__ deltas,
        const int32_t* __restrict__ sums, Wire w,
        int32_t* __restrict__ idx) {
    static_assert(kPer == 8, "a thread's deltas are one 16-byte word");
    __shared__ __align__(16) uint16_t sd[kTileEntries];
    __shared__ __align__(16) int32_t sidx[kTileEntries];
    __shared__ int smem[kThreads / 32 + 1];
    __shared__ int64_t red[kThreads / 32];
    start_next();
    const int64_t tile = blockIdx.x;
    const Tile t = tile_of(w, tile);
    for (int j = threadIdx.x; j < kTileEntries; j += kThreads)
        sd[j] = j < t.n ? deltas[t.e0 + j] : 0;
    wait_previous();                    // (a)'s sums
    int64_t before = 0;
    for (int64_t k = t.first + threadIdx.x; k < tile; k += kThreads)
        before += sums[k];
    before = block_sum(before, red);    // its barrier orders sd too
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
    // the index of the entry before the thread's first; a real entry's is
    // below 4 * Lp * Mc < 2^31, and an index past 2^31 - 1 (only a
    // malformed wire's) is held there, so idx stays non-decreasing
    const int64_t base = before + ex - 1;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int64_t i = base + run[k];
        sidx[kPer * threadIdx.x + k] = i < INT32_MAX ? (int32_t)i : INT32_MAX;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < t.n; j += kThreads) idx[t.e0 + j] = sidx[j];
}

// (c) a warp a query: for each window, the scaffold holding its first cell
// and the first entry and correction at or past that cell; then for each
// row start r * Lp (r <= R) of each scaffold, the first entry and
// correction at or past it
__global__ void __launch_bounds__(kThreads) marks_kernel(
        const int32_t* __restrict__ idx,
        const int32_t* __restrict__ corr_idx, Wire w, int R, int64_t Ltot,
        int64_t n_windows, Marks me, Marks mc,
        int32_t* __restrict__ window_scaffold) {
    start_next();
    const int64_t qi = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
    const int64_t* off = w.row(4);
    int s;
    int64_t x, *e_at, *c_at;
    if (qi < n_windows) {
        const int64_t c = qi * kWindow, r = c / Ltot, q = c - r * Ltot;
        s = (int)warp_lower_bound(off, 0, w.S + 1, q + 1) - 1;
        x = r * w.row(3)[s] + (q - off[s]);
        e_at = me.windows + qi;
        c_at = mc.windows + qi;
    } else {
        const int64_t k = qi - n_windows;
        if (k >= (int64_t)w.S * (R + 1)) return;
        s = (int)(k / (R + 1));
        x = (k - (int64_t)s * (R + 1)) * w.row(3)[s];
        e_at = me.rows + k;
        c_at = mc.rows + k;
    }
    wait_previous();                    // (b)'s indices
    if (qi < n_windows && (threadIdx.x & 31) == 0) window_scaffold[qi] = s;
    // the two searches in the same rounds
    int64_t e = w.row(0)[s], e_hi = w.row(0)[s + 1];
    int64_t c = w.row(1)[s], c_hi = w.row(1)[s + 1];
    for (bool more = e < e_hi || c < c_hi; more;) {
        more = false;
        warp_narrow(idx, &e, &e_hi, x, &more);
        warp_narrow(corr_idx, &c, &c_hi, x, &more);
    }
    if ((threadIdx.x & 31) == 0) {
        *e_at = e;
        *c_at = c;
    }
}

// Calls fn(r, s, q, c, n, x0) for each segment of the window [c0, c1)
// whose first cell scaffold s0 holds: n cells from cell c, positions q.. of
// row r of scaffold s, whose flat indices start at x0. The same for every
// thread of the block.
template <typename Fn>
__device__ __forceinline__ void for_segments(const Wire& w, int64_t Ltot,
                                             int64_t c0, int64_t c1, int s0,
                                             Fn fn) {
    const int64_t* off = w.row(4);
    int64_t r = c0 / Ltot, q = c0 - r * Ltot;
    int s = s0;
    for (int64_t c = c0; c < c1;) {
        while (off[s + 1] <= q) ++s;    // scaffolds of no positions
        const int64_t n = c1 - c < off[s + 1] - q ? c1 - c : off[s + 1] - q;
        fn(r, s, q, c, n, r * w.row(3)[s] + (q - off[s]));
        c += n;
        q += n;
        if (q == Ltot) {
            q = 0;
            ++r;
            s = 0;
        }
    }
}

// The items [*first, *end) of a segment in row r of scaffold s: from
// `from` (the window's mark) where the segment starts the window inside a
// row, else from its row's mark; to `to` (the next window's) where it runs
// on past the window inside the row, else to the next row's
__device__ __forceinline__ void segment_items(
        const int64_t* rows_of, const int64_t* first_of, int R, int s,
        int64_t r, bool mid_start, bool mid_end, int64_t from, int64_t to,
        int64_t* first, int64_t* end) {
    if (first_of[s] == first_of[s + 1]) {   // the scaffold has none
        *first = *end = 0;
        return;
    }
    const int64_t* rows = rows_of + (int64_t)s * (R + 1);
    *first = mid_start ? from : rows[r];
    *end = mid_end ? to : rows[r + 1];
}

// kBatch items [j, j + kBatch) of one kind (those before end), kAhead a
// thread, loaded at once: their flat indices and values (0 past end)
struct Batch {
    int32_t i[kAhead], v[kAhead];

    template <typename V>
    __device__ __forceinline__ void load(const int32_t* __restrict__ ix,
                                         const V* __restrict__ vs, int64_t j,
                                         int64_t end) {
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            const int64_t k = j + u * kFillThreads + threadIdx.x;
            i[u] = k < end ? ix[k] : 0;
            v[u] = k < end ? (int32_t)vs[k] : 0;
        }
    }
    // entries: their values stored in the segment's cells [0, n) from
    // flat x0 (values 0 place nothing)
    __device__ __forceinline__ void place(int32_t* seg, int64_t x0,
                                          int64_t n) const {
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            const int64_t c = i[u] - x0;
            if (v[u] && c >= 0 && c < n) seg[c] = v[u];
        }
    }
    // corrections: their values added
    __device__ __forceinline__ void add(int32_t* seg, int64_t x0,
                                        int64_t n) const {
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            const int64_t c = i[u] - x0;
            if (v[u] && c >= 0 && c < n) seg[c] += v[u];
        }
    }
};

// (d) a block a window
__global__ void __launch_bounds__(kFillThreads, kFillBlocks) fill_kernel(
        const int32_t* __restrict__ idx, const uint8_t* __restrict__ vals,
        const int32_t* __restrict__ corr_idx,
        const int32_t* __restrict__ corr_val, Wire w, int M, int64_t Ltot,
        int64_t n_windows, Marks me, Marks mc,
        const int32_t* __restrict__ window_scaffold,
        int32_t* __restrict__ out) {
    __shared__ int4 win4[kWindow / 4];
    int32_t* win = reinterpret_cast<int32_t*>(win4);
    const int64_t wi = blockIdx.x;
    const int64_t n_cells = (int64_t)M * 4 * Ltot;
    const int64_t c0 = wi * kWindow;
    const int64_t c1 = c0 + kWindow < n_cells ? c0 + kWindow : n_cells;
    const int R = 4 * M;
    for (int k = threadIdx.x; k < kWindow / 4; k += kFillThreads)
        win4[k] = make_int4(0, 0, 0, 0);
    wait_previous();                    // (c)'s marks
    // the window's scaffold and marks, loaded at once (a mark is
    // unwritten, and unused, where the scaffold has no items)
    const bool next = wi + 1 < n_windows;
    const int s0 = window_scaffold[wi];
    const int64_t e_from = me.windows[wi], c_from = mc.windows[wi];
    const int64_t e_to = next ? me.windows[wi + 1] : 0;
    const int64_t c_to = next ? mc.windows[wi + 1] : 0;
    __syncthreads();
    const int64_t* off = w.row(4);
    for_segments(w, Ltot, c0, c1, s0, [&](int64_t r, int s, int64_t q,
                                          int64_t c, int64_t n,
                                          int64_t x0) {
        const bool mid_start = c == c0 && q != off[s];
        const bool mid_end = c + n == c1 && q + n != off[s + 1];
        int64_t a, b, ka, kb;
        segment_items(me.rows, w.row(0), R, s, r, mid_start, mid_end, e_from,
                      e_to, &a, &b);
        segment_items(mc.rows, w.row(1), R, s, r, mid_start, mid_end, c_from,
                      c_to, &ka, &kb);
        int32_t* seg = win + (c - c0);
        // the first batches of both kinds load at once
        Batch be, bc;
        be.load(idx, vals, a, b);
        bc.load(corr_idx, corr_val, ka, kb);
        be.place(seg, x0, n);
        for (int64_t j = a + kBatch; j < b; j += kBatch) {
            be.load(idx, vals, j, b);
            be.place(seg, x0, n);
        }
        if (ka < kb) {
            __syncthreads();            // the entries are placed
            bc.add(seg, x0, n);
            for (int64_t j = ka + kBatch; j < kb; j += kBatch) {
                bc.load(corr_idx, corr_val, j, kb);
                bc.add(seg, x0, n);
            }
        }
    });
    __syncthreads();
    int4* dst = reinterpret_cast<int4*>(out + c0);
    const int n_vec = (int)((c1 - c0) >> 2);
    for (int k = threadIdx.x; k < n_vec; k += kFillThreads) dst[k] = win4[k];
}

// Launches kernel k on st so that it may start before the kernel before it
// on st ends (programmatic dependent launch; k waits in wait_previous())
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*k)(Params...), int64_t grid, int threads,
                         cudaStream_t st, Args&&... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3(threads);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, k, static_cast<Args&&>(args)...);
}

}  // namespace

// The chunk's counts [M, 4, Ltot] int32 from its wire, on `stream`: (a)
// and (b) where there are entries, (c), then (d), a block for each of
// `n_windows` windows of `window` cells. scratch holds the window marks of
// the entries and of the corrections (n_windows int64 each), their row
// marks (S * (4 M + 1) int64 each), the windows' scaffolds (n_windows
// int32), the tiles' sums (n_tiles int32) and the entries' indices (V
// int32).
extern "C" int instrain_densify(const void* table, int S, int64_t n_tiles,
                                const void* deltas, const void* vals,
                                const void* corr_idx, const void* corr_val,
                                int M, int64_t Ltot, int64_t window,
                                int64_t n_windows, void* scratch, void* out,
                                void* stream) {
    if (window != kWindow || S < 1 || M < 1 || M > (1 << 28) || Ltot < 1 ||
        n_windows != ((int64_t)M * 4 * Ltot + kWindow - 1) / kWindow ||
        n_windows >= INT32_MAX || n_tiles < 0 || n_tiles >= INT32_MAX ||
        ((uintptr_t)out & 15) != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const Wire w{(const int64_t*)table, S};
    const int R = 4 * M;
    const int64_t n_rows = (int64_t)S * (R + 1);
    int64_t* p = (int64_t*)scratch;
    const Marks me{p + 2 * n_windows, p};
    const Marks mc{p + 2 * n_windows + n_rows, p + n_windows};
    int32_t* window_scaffold = (int32_t*)(p + 2 * n_windows + 2 * n_rows);
    int32_t* sums = window_scaffold + n_windows;
    int32_t* idx = sums + n_tiles;
    const int64_t warps = n_windows + n_rows;
    const int64_t mark_blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
    if (mark_blocks >= INT32_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSuccess;
    if (n_tiles > 0) {
        sums_kernel<<<(unsigned)n_tiles, kThreads, 0, st>>>(
            (const uint16_t*)deltas, w, sums);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        e = launch_after(index_kernel, n_tiles, kThreads, st,
                         (const uint16_t*)deltas, (const int32_t*)sums, w,
                         idx);
        if (e != cudaSuccess) return (int)e;
    }
    if (n_tiles > 0) {
        e = launch_after(marks_kernel, mark_blocks, kThreads, st,
                         (const int32_t*)idx, (const int32_t*)corr_idx, w, R,
                         Ltot, n_windows, me, mc, window_scaffold);
    } else {                            // after no kernel of this call
        marks_kernel<<<(unsigned)mark_blocks, kThreads, 0, st>>>(
            idx, (const int32_t*)corr_idx, w, R, Ltot, n_windows, me, mc,
            window_scaffold);
        e = cudaGetLastError();
    }
    if (e != cudaSuccess) return (int)e;
    e = launch_after(fill_kernel, n_windows, kFillThreads, st,
                     (const int32_t*)idx, (const uint8_t*)vals,
                     (const int32_t*)corr_idx, (const int32_t*)corr_val, w, M,
                     Ltot, n_windows, me, mc,
                     (const int32_t*)window_scaffold, (int32_t*)out);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
