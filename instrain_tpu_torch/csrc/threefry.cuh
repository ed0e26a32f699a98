// Threefry-2x32, 20 rounds (Salmon et al., SC'11): the counter-based
// permutation JAX's default PRNG uses (instrain_tpu/kernels/sitestats.py:
// _threefry2x32, :75-118, and jax.random's threefry2x32_p). Shared by the
// rarefied-clonality kernel (clonr.cu) and the linkage kernel
// (linkage.cu).

#pragma once

#include <stdint.h>

namespace instrain {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1,
                                            int r0, int r1, int r2, int r3) {
    x0 += x1; x1 = rotl32(x1, r0); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, r1); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, r2); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, r3); x1 ^= x0;
}

// Both output words of Threefry-2x32 at counter (x0, x1) under key (k0, k1)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
    const uint32_t k2 = 0x1BD11BDAu ^ k0 ^ k1;
    x0 += k0; x1 += k1;
    four_rounds(x0, x1, 13, 15, 26, 6);
    x0 += k1; x1 += k2 + 1u;
    four_rounds(x0, x1, 17, 29, 16, 24);
    x0 += k2; x1 += k0 + 2u;
    four_rounds(x0, x1, 13, 15, 26, 6);
    x0 += k0; x1 += k1 + 3u;
    four_rounds(x0, x1, 17, 29, 16, 24);
    x0 += k1; x1 += k2 + 4u;
    four_rounds(x0, x1, 13, 15, 26, 6);
    x0 += k2; x1 += k0 + 5u;
}

}  // namespace instrain
