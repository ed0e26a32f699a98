// Device linkage disequilibrium for one scaffold: the Hopper port of
// instrain_tpu/kernels/linkage.py:ld_device (:28-100) with _ld_math_jnp
// (:103-120).
//
// One cooperative launch per call, every block resident, its phases
// apart by grid.sync():
//  1. zero a histogram cnt[cell, 16] in device memory (scratch after the
//     outputs), its lines kept in L2 (evict-last) for phases 2 and 3;
//  2. half of each block's threads add the captured pairs into it with
//     red.add (pairs loaded four at a time, streamed past the caches'
//     kept lines), while the other half make the draws of the block's
//     first n_pre cells ahead (predraw) and keep their high Threefry words
//     in shared memory (with n_pre = 0, every thread adds pairs): the
//     draws do not depend on the histogram, and the adds are bound by the
//     L2's atomics, not by the SMs' integer units;
//  3. each block computes the cells of the edges it owns, [b * epb, (b +
//     1) * epb) (kernels/cuda_linkage.py:ld_plan sizes the grid to what
//     fits on the card and sets n_pre).
// A block computes its cells in tiles of 256 consecutive cells, one a
// thread (the first tile's inputs loaded before phase 1). The mm
// prefix of the 16 combo counts is a segmented scan: over each warp's
// lanes by shuffles (a segment per edge), then across the warps and tiles
// through shared memory, so each row is read once and an edge may span
// warps and tiles. Every thread then does its own cell: the major/minor
// allele at each end (a stable descending sort of four counts: the first
// maximum, then the first maximum of the other three, which is
// argsort(-c, stable)'s order), the gates, r2 and D', and `min_snp`
// categorical draws (made ahead, or here four at a time as independent
// chains) with r2 / D' of the drawn frequencies. Every cell is computed,
// gated or not, as in the JAX version, so each output array equals it
// element for element.
// Measured and dropped (PERF.md, section 6): a histogram in one cluster's
// shared memory, its pairs read on 8 SMs, lost at every shape but E * M =
// 1; a counting sort of the pairs to the block owning their edge, its
// rows in shared memory, lost at every shape (its bucket writes were
// slower than the red.adds).
//
// The 14 outputs are planar columns of one byte buffer, each column
// starting at a multiple of kAlign bytes: r2, d', r2n, d'n (f64), A, a, B,
// b (int64), AB, Ab, aB, ab, total (int32), valid (bool)
// (cuda_linkage.ld_layout).
//
// Bound: integer ALU in the draws. Each draw is one Threefry-2x32 (about
// 90 32-bit operations) and a cell makes min_snp (20) of them; the bytes
// are the pairs once, the cells' inputs and outputs once. In practice the
// adds of phase 2, bound by the L2's atomics on scattered addresses, take
// about as long as the cells where pairs outnumber cells tenfold.
//
// Floats follow XLA's CPU backend bit for bit, with explicit intrinsics so
// that nvcc contracts nothing of its own: frequencies are IEEE f64
// divisions by max(total, 1); linkD = fAB - fA * fB in r2 and linkd =
// fab - fa * fb are single-rounding FMAs (XLA contracts exactly these),
// while the sign test of D' (linkD > 0) uses a rounded product (XLA
// recomputes linkD there without contracting it; the two differ where
// linkD is 0 exactly); the denominators are products in the JAX order
// ((fA * fa) * fB) * fb; the rarefied frequencies are draws times the
// correctly rounded f64 reciprocal of min_snp (XLA's rewrite of the
// division by a constant).
//
// The draws reproduce jax.random.uniform(key, (Ep, Mp, min_snp), f64):
// element (e, m, s) is Threefry-2x32 of its flat index
// (e * m_stride + m) * min_snp + s as (hi, lo) words; the output words
// (hi first) make 64 bits, shifted right by 12 and ORed with the bits of
// 1.0, minus 1.0. m_stride is the JAX caller's padded mm extent
// ceil8(M); the padded edge extent does not enter the counter.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kAlign = 128;      // bytes: where each output column starts
constexpr unsigned kFull = 0xffffffffu;

struct Inputs {
    const int32_t* e_idx;
    const int32_t* mm_idx;
    const int32_t* combo;
    int64_t n;
    const int4* c1;          // [E * M] cells of 4 counts
    const int4* c2;
    const bool* present1;
    const bool* present2;
    int E, M, min_snp;
    uint32_t m_stride, k0, k1;
};

struct Outputs {
    double* f[4];            // r2, d', r2n, d'n
    int64_t* alleles[4];     // A, a, B, b
    int32_t* counts[5];      // AB, Ab, aB, ab, total
    bool* valid;
};

int64_t column_bytes(int64_t n, int64_t size) {
    return (n * size + kAlign - 1) / kAlign * kAlign;
}

// the columns of `buf` for n cells; returns the bytes they take
int64_t layout(char* buf, int64_t n, Outputs* o) {
    int64_t off = 0;
    for (int k = 0; k < 4; ++k, off += column_bytes(n, 8))
        o->f[k] = (double*)(buf + off);
    for (int k = 0; k < 4; ++k, off += column_bytes(n, 8))
        o->alleles[k] = (int64_t*)(buf + off);
    for (int k = 0; k < 5; ++k, off += column_bytes(n, 4))
        o->counts[k] = (int32_t*)(buf + off);
    o->valid = (bool*)(buf + off);
    return off + column_bytes(n, 1);
}

// index of the first maximum of c[0..3], skipping index `skip` (-1: none)
__device__ __forceinline__ int first_max4(const int* c, int skip) {
    int best = -1, bv = 0;
    for (int k = 0; k < 4; ++k) {
        if (k == skip) continue;
        if (best < 0 || c[k] > bv) { best = k; bv = c[k]; }
    }
    return best;
}

// c[i] for a run-time i < N (a power of 2), by a tree of selects on the
// bits of i: an indexed read would keep c in local memory
template <int N>
__device__ __forceinline__ int pick(const int* c, int i) {
    int v[N];
    for (int k = 0; k < N; ++k) v[k] = c[k];
    for (int w = N / 2, bit = 0; w >= 1; w /= 2, ++bit)
        for (int k = 0; k < w; ++k)
            v[k] = (i >> bit) & 1 ? v[2 * k + 1] : v[2 * k];
    return v[0];
}

__device__ __forceinline__ void ld_math(double fAB, double fAb, double faB,
                                        double fab, double* r2,
                                        double* d_prime) {
    const double nan = __longlong_as_double(0x7FF8000000000000ll);
    const double fA = __dadd_rn(fAB, fAb), fa = __dadd_rn(fab, faB);
    const double fB = __dadd_rn(fAB, faB), fb = __dadd_rn(fab, fAb);
    const double linkD = __fma_rn(-fA, fB, fAB);
    *r2 = (fa == 0.0 || fA == 0.0 || fB == 0.0 || fb == 0.0)
          ? nan
          : __ddiv_rn(__dmul_rn(linkD, linkD),
                      __dmul_rn(__dmul_rn(__dmul_rn(fA, fa), fB), fb));
    const double linkd = __fma_rn(-fa, fb, fab);
    double dp = nan;
    if (linkd < 0.0)
        dp = __ddiv_rn(linkd, fmax(__dmul_rn(-fA, fB), __dmul_rn(-fa, fb)));
    else if (__dadd_rn(fAB, -__dmul_rn(fA, fB)) > 0.0)   // no FMA here
        dp = __ddiv_rn(linkd, fmin(__dmul_rn(fA, fb), __dmul_rn(fa, fB)));
    *d_prime = dp;
}

// A cell's per-position inputs: base counts at both ends, both present
struct CellIn {
    int4 c1, c2;
    bool present;
};

__device__ __forceinline__ CellIn load_cell(const Inputs& in, int64_t cell) {
    const bool p1 = in.present1[cell], p2 = in.present2[cell];
    return {in.c1[cell], in.c2[cell], p1 & p2};
}

// Add the uniform of Threefry output words (x0, x1) to the draws above
// each of the three (ascending) cumulative probabilities
__device__ __forceinline__ void draw(uint32_t x0, uint32_t x1,
                                     const double* cdf, int* above) {
    const uint64_t bits = ((uint64_t)x0 << 32) | x1;
    const double u = __dadd_rn(
        __longlong_as_double((long long)((bits >> 12) |
                                         0x3FF0000000000000ull)), -1.0);
    for (int k = 0; k < 3; ++k) above[k] += u > cdf[k];
}

// One (edge, mm level) cell from its inputs, its cumulative combo counts
// `cum` and whether its own level holds a pair (`exact`); `pre`, where not
// null, holds the high Threefry words of its draws, every `stride`-th
// word (predraw).
__device__ __forceinline__ void ld_cell(const Inputs& in, const Outputs& out,
                                        int64_t cell, int e, int m,
                                        const CellIn& ci, const int* cum,
                                        bool exact, const uint32_t* pre,
                                        int stride) {
    const int a1[4] = {ci.c1.x, ci.c1.y, ci.c1.z, ci.c1.w};
    const int a2[4] = {ci.c2.x, ci.c2.y, ci.c2.z, ci.c2.w};
    const int A = first_max4(a1, -1), a = first_max4(a1, A);
    const int B = first_max4(a2, -1), b = first_max4(a2, B);
    const int AB = pick<16>(cum, A * 4 + B), Ab = pick<16>(cum, A * 4 + b);
    const int aB = pick<16>(cum, a * 4 + B), ab = pick<16>(cum, a * 4 + b);
    const int total = AB + Ab + aB + ab;
    const bool sums_ok = (a1[0] + a1[1] + a1[2] + a1[3] +
                          a2[0] + a2[1] + a2[2] + a2[3]) >= in.min_snp;
    const bool nonzero_ok = pick<4>(a1, A) > 0 && pick<4>(a1, a) > 0 &&
                            pick<4>(a2, B) > 0 && pick<4>(a2, b) > 0;
    out.valid[cell] = ci.present && sums_ok && nonzero_ok &&
                      total > in.min_snp && exact;
    out.counts[0][cell] = AB;
    out.counts[1][cell] = Ab;
    out.counts[2][cell] = aB;
    out.counts[3][cell] = ab;
    out.counts[4][cell] = total;
    out.alleles[0][cell] = A;
    out.alleles[1][cell] = a;
    out.alleles[2][cell] = B;
    out.alleles[3][cell] = b;

    const double tot = (double)(total > 1 ? total : 1);
    const double fAB = __ddiv_rn((double)AB, tot);
    const double fAb = __ddiv_rn((double)Ab, tot);
    const double faB = __ddiv_rn((double)aB, tot);
    const double fab = __ddiv_rn((double)ab, tot);
    ld_math(fAB, fAb, faB, fab, out.f[0] + cell, out.f[1] + cell);

    // the draws, four at a time as independent chains; category k holds
    // the draws above cdf[k - 1] and not above cdf[k]
    const double cdf[3] = {fAB, __dadd_rn(fAB, fAb),
                           __dadd_rn(__dadd_rn(fAB, fAb), faB)};
    int above[3] = {0, 0, 0};
    const uint64_t base = ((uint64_t)e * in.m_stride + (uint64_t)m) *
                          (uint64_t)in.min_snp;
    if (pre) {
        // u = m 2^-52 with m = x0 2^20 + (x1 >> 12), so u > c holds where
        // x0 > floor(c 2^32) and fails where x0 < it; at equality the
        // draw is made again in full
        uint32_t t[3];
        for (int k = 0; k < 3; ++k)
            t[k] = cdf[k] >= 1.0 ? 0xFFFFFFFFu
                                 : __double2uint_rz(cdf[k] * 4294967296.0);
        for (int s = 0; s < in.min_snp; ++s) {
            const uint32_t x0 = pre[(int64_t)s * stride];
            if (x0 == t[0] || x0 == t[1] || x0 == t[2]) {
                const uint64_t ctr = base + (uint64_t)s;
                uint32_t y0 = (uint32_t)(ctr >> 32), y1 = (uint32_t)ctr;
                instrain::threefry2x32(in.k0, in.k1, y0, y1);
                draw(y0, y1, cdf, above);
            } else {
                for (int k = 0; k < 3; ++k) above[k] += x0 > t[k];
            }
        }
    } else {
        int s = 0;
        for (; s + 4 <= in.min_snp; s += 4) {
            uint32_t x0[4], x1[4];
            for (int j = 0; j < 4; ++j) {
                const uint64_t ctr = base + (uint64_t)(s + j);
                x0[j] = (uint32_t)(ctr >> 32);
                x1[j] = (uint32_t)ctr;
                instrain::threefry2x32(in.k0, in.k1, x0[j], x1[j]);
            }
            for (int j = 0; j < 4; ++j) draw(x0[j], x1[j], cdf, above);
        }
        for (; s < in.min_snp; ++s) {
            const uint64_t ctr = base + (uint64_t)s;
            uint32_t x0 = (uint32_t)(ctr >> 32), x1 = (uint32_t)ctr;
            instrain::threefry2x32(in.k0, in.k1, x0, x1);
            draw(x0, x1, cdf, above);
        }
    }
    const int n[4] = {in.min_snp - above[0], above[0] - above[1],
                      above[1] - above[2], above[2]};
    const double inv = __drcp_rn((double)in.min_snp);
    ld_math(__dmul_rn((double)n[0], inv), __dmul_rn((double)n[1], inv),
            __dmul_rn((double)n[2], inv), __dmul_rn((double)n[3], inv),
            out.f[2] + cell, out.f[3] + cell);
}

// Add a cell's histogram row to h: 16 counts written by other SMs in this
// launch, read at L2, past the SM's own L1
__device__ __forceinline__ void add_row(int* h, const int4* hist,
                                        int64_t cell) {
    for (int q = 0; q < 4; ++q) {
        const int4 v = __ldcg(hist + cell * 4 + q);
        h[4 * q] += v.x; h[4 * q + 1] += v.y;
        h[4 * q + 2] += v.z; h[4 * q + 3] += v.w;
    }
}

// The high Threefry words of a cell's draws, every `stride`-th word of
// `pre` (four draws at a time, as independent chains)
__device__ __forceinline__ void predraw(const Inputs& in, int64_t cell,
                                        uint32_t* pre, int stride) {
    const int e = (int)(cell / in.M), m = (int)(cell - (int64_t)e * in.M);
    const uint64_t base = ((uint64_t)e * in.m_stride + (uint64_t)m) *
                          (uint64_t)in.min_snp;
    int s = 0;
    for (; s + 4 <= in.min_snp; s += 4) {
        uint32_t x0[4], x1[4];
        for (int j = 0; j < 4; ++j) {
            const uint64_t ctr = base + (uint64_t)(s + j);
            x0[j] = (uint32_t)(ctr >> 32);
            x1[j] = (uint32_t)ctr;
            instrain::threefry2x32(in.k0, in.k1, x0[j], x1[j]);
        }
        for (int j = 0; j < 4; ++j) pre[(int64_t)(s + j) * stride] = x0[j];
    }
    for (; s < in.min_snp; ++s) {
        const uint64_t ctr = base + (uint64_t)s;
        uint32_t x0 = (uint32_t)(ctr >> 32), x1 = (uint32_t)ctr;
        instrain::threefry2x32(in.k0, in.k1, x0, x1);
        pre[(int64_t)s * stride] = x0;
    }
}

// The cells [lo, hi) of one block, lo an edge's first cell, in tiles of
// kThreads consecutive cells, one a thread (an edge may span warps and
// tiles); `first` holds the thread's first cell's inputs, loaded early;
// the first n_pre cells' draws are in `pre` (predraw, stride n_pre).
// Each warp scans its lanes' histogram rows per edge; the warps' last lanes
// (double-buffered by tile, so a warp may run one tile ahead) carry into
// the next warps, and the tile's last cell into the next tile.
__device__ void ld_block(const Inputs& in, const Outputs& out,
                         const int4* hist, int64_t lo, int64_t hi,
                         CellIn first, const uint32_t* pre, int n_pre) {
    __shared__ int last[2][kWarps][16];
    __shared__ int tail[2][16];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, M = in.M;
    CellIn ci = first;
    int h[16];
    for (int k = 0; k < 16; ++k) h[k] = 0;
    if (lo + threadIdx.x < hi) add_row(h, hist, lo + threadIdx.x);
    int buf = 0;
    for (int64_t base = lo; base < hi; base += kThreads, buf ^= 1) {
        const int64_t cell = base + threadIdx.x;
        const bool active = cell < hi;
        int e = -1, m = 0;
        if (active) {
            e = (int)(cell / M);
            m = (int)(cell - (int64_t)e * M);
        }
        bool exact = false;
        for (int k = 0; k < 16; ++k) exact |= h[k] > 0;
        // inclusive scan within each edge's lanes: lane - d holds the same
        // edge exactly when m >= d
        for (int d = 1; d < 32 && d < M; d <<= 1) {
            const bool take = lane >= d && m >= d;
            for (int k = 0; k < 16; ++k) {
                const int t = __shfl_up_sync(kFull, h[k], d);
                if (take) h[k] += t;
            }
        }
        if (lane == 31)
            for (int k = 0; k < 16; ++k) last[buf][warp][k] = h[k];
        __syncthreads();
        // the warp's first edge, when it began before the warp: add what
        // the earlier warps of the tile (back to where it began) and the
        // earlier tiles hold of it
        const int e_first = __shfl_sync(kFull, e, 0);
        if (__shfl_sync(kFull, m, 0) > 0) {
            const int64_t start = (int64_t)e_first * M;
            int c[16];
            for (int k = 0; k < 16; ++k) c[k] = 0;
            int w = warp - 1;
            for (; w >= 0; --w) {
                for (int k = 0; k < 16; ++k) c[k] += last[buf][w][k];
                if (base + 32 * w <= start) break;
            }
            if (w < 0)
                for (int k = 0; k < 16; ++k) c[k] += tail[buf ^ 1][k];
            if (e == e_first)
                for (int k = 0; k < 16; ++k) h[k] += c[k];
        }
        if (threadIdx.x == kThreads - 1)
            for (int k = 0; k < 16; ++k) tail[buf][k] = h[k];
        if (active)
            ld_cell(in, out, cell, e, m, ci, h, exact,
                    cell - lo < n_pre ? pre + (cell - lo) : nullptr, n_pre);
        if (cell + kThreads < hi) {
            ci = load_cell(in, cell + kThreads);
            for (int k = 0; k < 16; ++k) h[k] = 0;
            add_row(h, hist, cell + kThreads);
        }
    }
}

// The inputs of the thread's first cell of [lo, hi)
__device__ __forceinline__ CellIn prefetch(const Inputs& in, int64_t lo,
                                           int64_t hi) {
    const int64_t cell = lo + threadIdx.x;
    return cell < hi ? load_cell(in, cell) : CellIn{};
}

// Every pair, add(e, mm, combo), the thread `first` of `step` (int4
// loads where the pairs come in whole fours: the pointers are 16-byte
// aligned; streamed past the caches' kept lines)
template <class Add>
__device__ __forceinline__ void for_pairs(const Inputs& in, int64_t first,
                                          int64_t step, Add add) {
    const int64_t n4 = in.n / 4;
    const int4* e4 = reinterpret_cast<const int4*>(in.e_idx);
    const int4* m4 = reinterpret_cast<const int4*>(in.mm_idx);
    const int4* k4 = reinterpret_cast<const int4*>(in.combo);
#pragma unroll 4
    for (int64_t i = first; i < n4; i += step) {
        const int4 e = __ldcs(e4 + i), m = __ldcs(m4 + i), k = __ldcs(k4 + i);
        add(e.x, m.x, k.x); add(e.y, m.y, k.y);
        add(e.z, m.z, k.z); add(e.w, m.w, k.w);
    }
    for (int64_t i = n4 * 4 + first; i < in.n; i += step)
        add(in.e_idx[i], in.mm_idx[i], in.combo[i]);
}

// Block b owns the edges [b * epb, (b + 1) * epb): the first n_pre of
// their cells have their draws' high words in dynamic shared memory
// [min_snp, n_pre], made by half the block's warps while the other half
// add the pairs (all of them add pairs where n_pre is 0).
__global__ void __launch_bounds__(kThreads, 3)
ld_kernel(Inputs in, Outputs out, int4* hist, int epb, int n_pre) {
    extern __shared__ uint32_t pre[];
    cg::grid_group grid = cg::this_grid();
    const int M = in.M;
    const int64_t e0 = (int64_t)blockIdx.x * epb < in.E
                       ? (int64_t)blockIdx.x * epb : in.E;
    const int64_t e1 = e0 + epb < in.E ? e0 + epb : in.E;
    const int64_t lo = e0 * M, hi = e1 * M;
    const CellIn first = prefetch(in, lo, hi);
    const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    const int64_t cells = (int64_t)in.E * M;
    // the histogram stays in L2 while the pairs stream past it
    uint64_t keep;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
    for (int64_t i = tid; i < cells * 4; i += stride)
        asm volatile("st.global.L2::cache_hint.v4.s32 [%0], {%1, %1, %1, %1}, "
                     "%2;" :: "l"(hist + i), "r"(0), "l"(keep) : "memory");
    __threadfence();
    grid.sync();
    const int adders = n_pre > 0 ? kThreads / 2 : kThreads;
    if (threadIdx.x < adders) {
        int* h = reinterpret_cast<int*>(hist);
        for_pairs(in, (int64_t)blockIdx.x * adders + threadIdx.x,
                  (int64_t)gridDim.x * adders, [&](int e, int m, int k) {
            asm volatile("red.relaxed.gpu.global.add.L2::cache_hint.s32 "
                         "[%0], %1, %2;" :: "l"(h + ((int64_t)e * M + m) * 16 +
                         k), "r"(1), "l"(keep));
        });
    } else {
        const int64_t np = hi - lo < n_pre ? hi - lo : n_pre;
        for (int64_t c = threadIdx.x - adders; c < np;
             c += kThreads - adders)
            predraw(in, lo + c, pre + c, n_pre);
    }
    __threadfence();
    grid.sync();
    ld_block(in, out, hist, lo, hi, first, pre, n_pre);
}

}  // namespace

// Blocks of the kernel that fit on one SM with `smem` bytes of dynamic
// shared memory, after raising its limit to that (once per device;
// devices past 63: at every call)
extern "C" int instrain_ld_occupancy(int smem, int* per_sm) {
    static std::atomic<uint64_t> raised{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const uint64_t bit = dev < 64 ? 1ull << dev : 0;
    if (!(raised.load() & bit)) {
        e = cudaFuncSetAttribute(
            ld_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        raised.fetch_or(bit);
    }
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, ld_kernel, kThreads, (size_t)smem);
}

// A cooperative grid of `grid` blocks, `epb` edges a block, the draws of
// `n_pre` cells a block made ahead; the histogram after the outputs in
// `out`.
extern "C" int instrain_ld(const void* e_idx, const void* mm_idx,
                           const void* combo, int64_t n, const void* c1,
                           const void* c2, const void* present1,
                           const void* present2, int E, int M, int min_snp,
                           uint32_t m_stride, uint32_t k0, uint32_t k1,
                           int grid, int epb, int n_pre, void* out,
                           void* stream) {
    if (grid < 1 || epb < 1 || (int64_t)grid * epb < E || n_pre < 0)
        return (int)cudaErrorInvalidValue;
    const Inputs in{(const int32_t*)e_idx, (const int32_t*)mm_idx,
                    (const int32_t*)combo, n, (const int4*)c1,
                    (const int4*)c2, (const bool*)present1,
                    (const bool*)present2, E, M, min_snp, m_stride, k0, k1};
    Outputs o;
    int4* hist = (int4*)((char*)out + layout((char*)out, (int64_t)E * M, &o));
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)n_pre * min_snp * sizeof(uint32_t);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, ld_kernel, in, o, hist,
                                             epb, n_pre);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
