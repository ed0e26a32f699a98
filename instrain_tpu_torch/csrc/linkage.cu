// Device linkage disequilibrium for one scaffold: the Hopper port of
// instrain_tpu/kernels/linkage.py:ld_device (:28-100) with _ld_math_jnp
// (:103-120).
//
// Two kernels on one stream:
//  L1 ld_scatter — one thread per captured within-read SNV base pair adds
//     one into the combo histogram cnt[E, M, 16] (global int32 atomics;
//     the histogram is zeroed by the wrapper). The JAX version is one
//     scatter-add; pairs are not grouped by edge, so a shared-memory
//     histogram per edge would first need a sort on the host.
//  L2 ld_cells — one thread per (edge, mm level) cell: the combo counts
//     cumulated over mm' <= m (a prefix over the histogram's mm axis, in
//     registers), the major/minor allele at each end (a stable descending
//     sort of four counts: the first maximum, then the first maximum of
//     the other three, which is argsort(-c, stable)'s order), the gates,
//     r2 and D', then `min_snp` categorical draws and r2 / D' of the drawn
//     frequencies. Every cell is computed, gated or not, as in the JAX
//     version, so each output array equals it element for element.
//
// Bound: integer ALU in L2. Each draw is one Threefry-2x32 (about 90
// 32-bit operations) and a cell makes min_snp (20) of them; the loads are
// 16 * (m + 1) ints of the histogram and 2 x 4 counts per cell. L1 is a
// few microseconds of atomics.
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

// index of the first maximum of c[0..3], skipping index `skip` (-1: none)
__device__ __forceinline__ int first_max4(const int* c, int skip) {
    int best = -1, bv = 0;
    for (int k = 0; k < 4; ++k) {
        if (k == skip) continue;
        if (best < 0 || c[k] > bv) { best = k; bv = c[k]; }
    }
    return best;
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

__global__ void ld_scatter_kernel(const int32_t* __restrict__ e_idx,
                                  const int32_t* __restrict__ mm_idx,
                                  const int32_t* __restrict__ combo, int n,
                                  int M, int32_t* __restrict__ cnt) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    atomicAdd(cnt + ((int64_t)e_idx[i] * M + mm_idx[i]) * 16 + combo[i], 1);
}

__global__ void ld_cells_kernel(
        const int32_t* __restrict__ cnt, const int32_t* __restrict__ c1,
        const int32_t* __restrict__ c2, const bool* __restrict__ present1,
        const bool* __restrict__ present2, int E, int M, int min_snp,
        uint32_t m_stride, uint32_t k0, uint32_t k1,
        bool* __restrict__ valid_out,
        int32_t* __restrict__ counts_out,    // [5, E, M] AB Ab aB ab total
        int64_t* __restrict__ alleles_out,   // [4, E, M] A a B b
        double* __restrict__ f_out) {        // [4, E, M] r2 d' r2n d'n
    const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t n_cells = (int64_t)E * M;
    if (cell >= n_cells) return;
    const int e = (int)(cell / M), m = (int)(cell - (int64_t)e * M);

    int cum[16];
    for (int k = 0; k < 16; ++k) cum[k] = 0;
    bool exact = false;
    for (int mm = 0; mm <= m; ++mm) {
        const int32_t* h = cnt + ((int64_t)e * M + mm) * 16;
        for (int k = 0; k < 16; ++k) {
            const int v = h[k];
            cum[k] += v;
            if (mm == m && v > 0) exact = true;
        }
    }
    int a1[4], a2[4];
    for (int k = 0; k < 4; ++k) {
        a1[k] = c1[cell * 4 + k];
        a2[k] = c2[cell * 4 + k];
    }
    const int A = first_max4(a1, -1), a = first_max4(a1, A);
    const int B = first_max4(a2, -1), b = first_max4(a2, B);
    const int AB = cum[A * 4 + B], Ab = cum[A * 4 + b];
    const int aB = cum[a * 4 + B], ab = cum[a * 4 + b];
    const int total = AB + Ab + aB + ab;
    const bool sums_ok = (a1[0] + a1[1] + a1[2] + a1[3] +
                          a2[0] + a2[1] + a2[2] + a2[3]) >= min_snp;
    const bool nonzero_ok = a1[A] > 0 && a1[a] > 0 && a2[B] > 0 &&
                            a2[b] > 0;
    valid_out[cell] = present1[cell] && present2[cell] && sums_ok &&
                      nonzero_ok && total > min_snp && exact;

    counts_out[cell] = AB;
    counts_out[n_cells + cell] = Ab;
    counts_out[2 * n_cells + cell] = aB;
    counts_out[3 * n_cells + cell] = ab;
    counts_out[4 * n_cells + cell] = total;
    alleles_out[cell] = A;
    alleles_out[n_cells + cell] = a;
    alleles_out[2 * n_cells + cell] = B;
    alleles_out[3 * n_cells + cell] = b;

    const double tot = (double)(total > 1 ? total : 1);
    const double fAB = __ddiv_rn((double)AB, tot);
    const double fAb = __ddiv_rn((double)Ab, tot);
    const double faB = __ddiv_rn((double)aB, tot);
    const double fab = __ddiv_rn((double)ab, tot);
    ld_math(fAB, fAb, faB, fab, f_out + cell, f_out + n_cells + cell);

    const double cdf0 = fAB, cdf1 = __dadd_rn(fAB, fAb);
    const double cdf2 = __dadd_rn(cdf1, faB);
    int n0 = 0, n1 = 0, n2 = 0, n3 = 0;
    const uint64_t base = ((uint64_t)e * m_stride + (uint64_t)m) *
                          (uint64_t)min_snp;
    for (int s = 0; s < min_snp; ++s) {
        const uint64_t ctr = base + (uint64_t)s;
        uint32_t x0 = (uint32_t)(ctr >> 32), x1 = (uint32_t)ctr;
        instrain::threefry2x32(k0, k1, x0, x1);
        const uint64_t bits = ((uint64_t)x0 << 32) | x1;
        const double u = __dadd_rn(
            __longlong_as_double((long long)((bits >> 12) |
                                             0x3FF0000000000000ull)),
            -1.0);
        const int cat = (u > cdf0) + (u > cdf1) + (u > cdf2);
        n0 += cat == 0; n1 += cat == 1; n2 += cat == 2; n3 += cat == 3;
    }
    const double inv = __drcp_rn((double)min_snp);
    ld_math(__dmul_rn((double)n0, inv), __dmul_rn((double)n1, inv),
            __dmul_rn((double)n2, inv), __dmul_rn((double)n3, inv),
            f_out + 2 * n_cells + cell, f_out + 3 * n_cells + cell);
}

}  // namespace

extern "C" int instrain_ld(const void* e_idx, const void* mm_idx,
                           const void* combo, int n, const void* c1,
                           const void* c2, const void* present1,
                           const void* present2, int E, int M, int min_snp,
                           uint32_t m_stride, uint32_t k0, uint32_t k1,
                           void* cnt, void* valid, void* counts,
                           void* alleles, void* f, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n > 0) {
        ld_scatter_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
            (const int32_t*)e_idx, (const int32_t*)mm_idx,
            (const int32_t*)combo, n, M, (int32_t*)cnt);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    const int64_t cells = (int64_t)E * M;
    ld_cells_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads), kThreads,
                      0, s>>>(
        (const int32_t*)cnt, (const int32_t*)c1, (const int32_t*)c2,
        (const bool*)present1, (const bool*)present2, E, M, min_snp,
        m_stride, k0, k1, (bool*)valid, (int32_t*)counts, (int64_t*)alleles,
        (double*)f);
    return (int)cudaGetLastError();
}
