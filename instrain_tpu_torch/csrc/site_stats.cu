// Fused per-site statistics for one scaffold (chunk): the Hopper port of
// instrain_tpu/kernels/pallas_sitestats.py:_kernel (its pallas_call is at
// pallas_sitestats.py:247), fused with the rest of
// instrain_tpu/kernels/sitestats.py:site_stats (:173-299): the cumulative
// counts, present/call/ref_count/clonR_set, the cryptic-SNV scan over
// ascending mm levels, any_snp and the linkage bases mask.
//
// Layout: counts[M, 4, L] int32, positions contiguous. One thread per
// position; neighbouring threads touch neighbouring positions, so every
// load and store of a warp is one coalesced transaction per array. The
// thread walks m = 0..M-1 and keeps the running A/C/T/G sums, the any_snp
// and cryptic state and the bases-mask bits in registers: that loop takes
// the place of jnp.cumsum over mm, of the TPU kernel's unrolled adds, and
// of the two scans the XLA version runs.
//
// The null-model and min-freq thresholds are read from the two
// [maxcov + 1] LUTs with __ldg at min(total, maxcov) (on the TPU these
// gathers ran in XLA outside the kernel: Mosaic could not lower them).
// 2 x 40 KB stays resident in L1/L2; the index depends on the coverage, so
// neighbouring threads usually read neighbouring or equal entries.
//
// Bound: memory. Per (m, position) cell it reads 16 bytes of counts and
// writes about 44 (cum 16, total and ref_count 8 each, clon 4, six 1-byte
// codes and masks, clonR_set 1) — a few integer compares per byte, far
// below the compute roofline. The design therefore does one pass: every
// input byte is read once, every output written once, no intermediate
// goes to device memory. Narrower outputs (int32 total, bit-packed masks)
// would cut the bytes further but change the dict the tables consume.
//
// Floats: p = cum / max(total, 1) with IEEE division (no
// --use_fast_math), and sum(p^2) as the chain fma(p3, p3, fma(p2, p2,
// fma(p1, p1, p0 * p0))) written with the explicit intrinsics
// __fmaf_rn / __fmul_rn, never left to nvcc's contraction: that chain is
// what XLA's CPU backend computes for the JAX function's reduce of
// squares, so clon is bit-identical to the reference. `--engine pallas`
// runs the kPallasOrder instance: the JAX package's Pallas core sums the
// squares left to right, ((p0^2 + p1^2) + p2^2) + p3^2 (:_kernel, :95-100),
// which XLA's CPU backend contracts, in interpret mode, into fma(p3, p3,
// fma(p2, p2, fma(p0, p0, p1 * p1))): only the innermost step differs,
// and with it clon's last bit at some cells; every other output is the
// same in both instances.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int8_t kSNS = 0, kSNV = 1, kConSNV = 2, kPopSNV = 3,
                 kDivergent = 4, kAmbig = 5;
constexpr int8_t kCallUncounted = -2, kCallNoSNP = -1;

// index of the first maximum of (a, c, t, g): ACTG order, like argmax
__device__ __forceinline__ int first_max4(int a, int c, int t, int g) {
    if (a >= c && a >= t && a >= g) return 0;
    if (c >= t && c >= g) return 1;
    if (t >= g) return 2;
    return 3;
}

template <bool kPallasOrder>
__global__ void site_stats_kernel(
        const int32_t* __restrict__ counts, const uint8_t* __restrict__ ref,
        const int32_t* __restrict__ null_lut,
        const int32_t* __restrict__ freq_lut, int maxcov,
        int M, int64_t L, int min_cov, int min_covR,
        int32_t* __restrict__ cum_out, bool* __restrict__ present_out,
        int64_t* __restrict__ total_out, int8_t* __restrict__ morphia_out,
        int8_t* __restrict__ con_out, int8_t* __restrict__ var_out,
        int8_t* __restrict__ call_out, bool* __restrict__ row_out,
        int8_t* __restrict__ cls_out, float* __restrict__ clon_out,
        int64_t* __restrict__ ref_count_out,
        bool* __restrict__ clonR_set_out, bool* __restrict__ cryptic_out,
        bool* __restrict__ any_snp_out, bool* __restrict__ bases_mask_out) {
    const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= L) return;
    const int refb = __ldg(ref + p);

    int a = 0, c = 0, t = 0, g = 0;      // cumulative counts over mm' <= m
    bool any_before = false;             // an SNV row emitted at mm' < m
    bool cryptic = false;
    unsigned bases = 0;                  // bit b: base b in a linkage call

    for (int m = 0; m < M; ++m) {
        const int64_t cell = (int64_t)m * L + p;         // [M, L] index
        const int64_t c4 = (int64_t)m * 4 * L + p;       // [M, 4, L] index
        const int e0 = __ldg(counts + c4);
        const int e1 = __ldg(counts + c4 + L);
        const int e2 = __ldg(counts + c4 + 2 * L);
        const int e3 = __ldg(counts + c4 + 3 * L);
        a += e0; c += e1; t += e2; g += e3;
        cum_out[c4] = a;
        cum_out[c4 + L] = c;
        cum_out[c4 + 2 * L] = t;
        cum_out[c4 + 3 * L] = g;

        const bool present =
            ((int64_t)e0 + e1 + e2 + e3) > 0;
        const int64_t total = (int64_t)a + c + t + g;
        const int tc = (int)(total < maxcov ? total : maxcov);
        const int min_bases = __ldg(null_lut + tc);
        const int freq_min = __ldg(freq_lut + tc);
        const int thresh = min_bases > freq_min ? min_bases : freq_min;
        const int morphia = (a >= thresh) + (c >= thresh) + (t >= thresh) +
                            (g >= thresh);

        const int con = first_max4(a, c, t, g);
        const int var = first_max4(con == 0 ? 0 : a, con == 1 ? 0 : c,
                                   con == 2 ? 0 : t, con == 3 ? 0 : g);

        const bool counted = total >= min_cov;
        const bool con_is_ref = con == refb;
        const bool is_base_call = morphia > 1 ||
                                  (morphia == 1 && !con_is_ref) ||
                                  morphia == 0;
        const int8_t call = !counted ? kCallUncounted
                            : (is_base_call ? (int8_t)con : kCallNoSNP);
        const bool row = present && counted && is_base_call;

        // reference base count; code 4 (not ACTG) reads G, like the
        // clip(ref, 0, 3) one-hot of the JAX version
        const int ref_count = refb == 0 ? a : refb == 1 ? c
                              : refb == 2 ? t : g;
        const bool ref_present = ref_count >= min_bases &&
                                 ref_count >= freq_min;
        const bool var_is_ref = var == refb;
        int8_t cls;
        if (refb >= 4) cls = kAmbig;
        else if (morphia == 0) cls = kDivergent;
        else if (morphia == 1) cls = kSNS;
        else if (con_is_ref) cls = kSNV;
        else if (var_is_ref || ref_present) cls = kConSNV;
        else cls = kPopSNV;

        float clon = __int_as_float(0x7fc00000);         // NaN
        if (present && counted) {
            const float denom = fmaxf((float)total, 1.0f);
            const float p0 = __fdiv_rn((float)a, denom);
            const float p1 = __fdiv_rn((float)c, denom);
            const float p2 = __fdiv_rn((float)t, denom);
            const float p3 = __fdiv_rn((float)g, denom);
            const float inner =
                kPallasOrder ? __fmaf_rn(p0, p0, __fmul_rn(p1, p1))
                             : __fmaf_rn(p1, p1, __fmul_rn(p0, p0));
            clon = __fmaf_rn(p3, p3, __fmaf_rn(p2, p2, inner));
        }

        // cryptic-SNV state machine (sitestats.py:273-288)
        const bool emits_snp = row && morphia >= 2;
        if (present && counted && any_before &&
            (call == kCallNoSNP || morphia == 1))
            cryptic = true;
        if (emits_snp) {
            any_before = true;
            bases |= (1u << con) | (1u << var);
        }

        present_out[cell] = present;
        total_out[cell] = total;
        morphia_out[cell] = (int8_t)morphia;
        con_out[cell] = (int8_t)con;
        var_out[cell] = (int8_t)var;
        call_out[cell] = call;
        row_out[cell] = row;
        cls_out[cell] = cls;
        clon_out[cell] = clon;
        ref_count_out[cell] = ref_count;
        clonR_set_out[cell] = present && total >= min_covR;
    }
    cryptic_out[p] = cryptic;
    any_snp_out[p] = any_before;
    for (int b = 0; b < 4; ++b)
        bases_mask_out[(int64_t)b * L + p] = (bases >> b) & 1u;
}

}  // namespace

extern "C" int instrain_site_stats(
        const void* counts, const void* ref, const void* null_lut,
        const void* freq_lut, int maxcov, int M, int64_t L, int min_cov,
        int min_covR, int pallas_order, void* cum, void* present,
        void* total, void* morphia, void* con, void* var, void* call,
        void* row, void* cls, void* clon, void* ref_count, void* clonR_set,
        void* cryptic, void* any_snp, void* bases_mask, void* stream) {
    const int threads = 256;
    const int64_t blocks = (L + threads - 1) / threads;
    auto kernel = pallas_order ? site_stats_kernel<true>
                               : site_stats_kernel<false>;
    kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)counts, (const uint8_t*)ref,
        (const int32_t*)null_lut, (const int32_t*)freq_lut, maxcov, M, L,
        min_cov, min_covR, (int32_t*)cum, (bool*)present, (int64_t*)total,
        (int8_t*)morphia, (int8_t*)con, (int8_t*)var, (int8_t*)call,
        (bool*)row, (int8_t*)cls, (float*)clon, (int64_t*)ref_count,
        (bool*)clonR_set, (bool*)cryptic, (bool*)any_snp,
        (bool*)bases_mask);
    return (int)cudaGetLastError();
}

extern "C" const char* instrain_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
