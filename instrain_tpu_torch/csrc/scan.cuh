// Warp and block scans and sums shared by the port's kernels (compact.cu's
// select_rows and masked_median, densify.cu's K8), over any integer type
// the warp shuffles take (int, int64_t).

#pragma once

#include <stdint.h>

namespace instrain {

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const T n = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += n;
    }
    return v;
}

// Exclusive scan of one value per thread over a block of NT threads;
// *total receives the block's sum. smem holds NT / 32 + 1 values.
template <int NT, typename T>
__device__ T block_exclusive_scan(T v, T* total, T* smem) {
    constexpr int W = NT / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const T inc = warp_inclusive_scan(v);
    if (lane == 31) smem[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        const T w = lane < W ? smem[lane] : T(0);
        const T winc = warp_inclusive_scan(w);
        if (lane < W) smem[lane] = winc - w;
        if (lane == W - 1) smem[W] = winc;
    }
    __syncthreads();
    const T res = smem[warp] + inc - v;
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

}  // namespace instrain
