// Rarefied clonality: the Hopper port of
// instrain_tpu/kernels/sitestats.py:_clonR_values (:136-166) with its
// counter-based generator _threefry2x32 / _ctr_uniform (:75-133), over a
// chunk of scaffolds laid end to end (segments.cuh): the batched form of
// site_stats_compact_batch (:446-465), one key per scaffold.
//
// One thread per (m, position) cell: one block per (tile of a segment's
// positions, mm level). A cell outside clonR_set (absent
// level, or coverage below the rarefied coverage) gets NaN and draws
// nothing. A set cell rebuilds its f32 cdf from cum and total (p0,
// p0 + p1, (p0 + p1) + p2 — the JAX order), then takes `draws`
// categorical draws: draw d uses the first Threefry-2x32 word at counter
// (d * m_stride + m, pos0 + p) under the segment's key, with p counted from
// the segment's start (as the JAX batch engine counts it per scaffold) and
// pos0 the base passed beside the table (0 for a whole scaffold; a shard of
// a scaffold's positions draws at the scaffold's positions, as the JAX
// package's position-sharded run does with its global iota), turned into a
// uniform as
// bitcast((b0 >> 9) | 0x3F800000) - 1; its category is the number of
// k < 3 with u > cdf[k]. The result is sum((count_b / draws)^2) in the
// order XLA's CPU backend evaluates the JAX function: r_b = count_b times
// the f32 reciprocal of draws, then fma(r3, r3, fma(r2, r2, fma(r1, r1,
// r0 * r0))) with explicit single-rounding FMAs. Because the value at a
// counter does not depend on array shapes, this is bit-identical to the
// JAX function (m_stride is the padded mm extent that function counts
// in).
//
// Bound: integer ALU. Each draw is 20 Threefry rounds (add, rotate, xor)
// plus 6 key injections, about 90 32-bit integer operations; 50 draws per
// cell make ~4,500 operations per 12 bytes read — compute-bound by three
// orders of magnitude. The design keeps everything in registers (the
// category counts are four ints), makes no memory traffic in the draw
// loop, and skips cells that do not qualify. Divergence between set and
// unset cells of a warp is the known cost; gathering the qualifying
// cells first is work for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segments.cuh"
#include "threefry.cuh"

namespace {

// the first output word of Threefry-2x32 (threefry.cuh)
__device__ __forceinline__ uint32_t threefry2x32_w0(uint32_t k0, uint32_t k1,
                                                   uint32_t x0, uint32_t x1) {
    instrain::threefry2x32(k0, k1, x0, x1);
    return x0;
}

__global__ void clonr_kernel(const int32_t* __restrict__ cum,
                             const int64_t* __restrict__ total,
                             const bool* __restrict__ clonR_set, int M,
                             int64_t L, instrain::Segments g,
                             uint32_t m_stride, int draws,
                             float* __restrict__ clonR_out) {
    const instrain::TilePos t = instrain::tile_position(g, blockIdx.x);
    if (t.p_local >= t.len) return;
    const int m = blockIdx.y;
    const int64_t cell = (int64_t)m * L + t.p;
    if (!clonR_set[cell]) {
        clonR_out[cell] = __int_as_float(0x7fc00000);    // NaN
        return;
    }
    const uint64_t key = instrain::seg_key(g, t.s);
    const uint32_t k0 = (uint32_t)(key >> 32), k1 = (uint32_t)key;
    const int64_t c4 = (int64_t)m * 4 * L + t.p;
    const float denom = fmaxf((float)total[cell], 1.0f);
    const float p0 = __fdiv_rn((float)cum[c4], denom);
    const float p1 = __fdiv_rn((float)cum[c4 + L], denom);
    const float p2 = __fdiv_rn((float)cum[c4 + 2 * L], denom);
    const float cdf0 = p0;
    const float cdf1 = __fadd_rn(p0, p1);
    const float cdf2 = __fadd_rn(cdf1, p2);

    int n0 = 0, n1 = 0, n2 = 0, n3 = 0;
    for (int d = 0; d < draws; ++d) {
        const uint32_t b0 = threefry2x32_w0(
            k0, k1, (uint32_t)d * m_stride + (uint32_t)m,
            (uint32_t)(g.pos0 + t.p_local));
        const float u = __fsub_rn(__uint_as_float((b0 >> 9) | 0x3F800000u),
                                  1.0f);
        const int cat = (u > cdf0) + (u > cdf1) + (u > cdf2);
        n0 += cat == 0; n1 += cat == 1; n2 += cat == 2; n3 += cat == 3;
    }
    // count / draws as the reference evaluates it: XLA rewrites the
    // division by the constant draw count into a product with its
    // correctly rounded f32 reciprocal
    const float inv = __frcp_rn((float)draws);
    const float r0 = __fmul_rn((float)n0, inv);
    const float r1 = __fmul_rn((float)n1, inv);
    const float r2 = __fmul_rn((float)n2, inv);
    const float r3 = __fmul_rn((float)n3, inv);
    clonR_out[cell] = __fmaf_rn(r3, r3, __fmaf_rn(r2, r2, __fmaf_rn(
                          r1, r1, __fmul_rn(r0, r0))));
}

}  // namespace

extern "C" int instrain_clonr(const void* cum, const void* total,
                              const void* clonR_set, int M, int64_t L,
                              const void* seg_table, int S, int64_t n_tiles,
                              uint64_t key0, int64_t pos0,
                              uint32_t m_stride, int draws, void* clonR,
                              void* stream) {
    clonr_kernel<<<dim3((unsigned)n_tiles, (unsigned)M), instrain::kTile, 0,
                   (cudaStream_t)stream>>>(
        (const int32_t*)cum, (const int64_t*)total, (const bool*)clonR_set,
        M, L, instrain::segments(seg_table, S, L, key0, pos0), m_stride, draws,
        (float*)clonR);
    return (int)cudaGetLastError();
}
