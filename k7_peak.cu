// Peak issue rates of one card: the binary tensor-core product that
// csrc/compare.cu uses (mma.sync m16n8k256 b1, AND + popcount) against
// the CUDA cores' 64-bit AND + POPC, in bit operations a second, and a
// check of the product's fragment layout. Built and run by compact_ab.py.
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void mma_b1(int iters, int* out) {
    uint32_t a[4], b[2];
    for (int q = 0; q < 4; ++q) a[q] = threadIdx.x * 2654435761u + q;
    for (int q = 0; q < 2; ++q) b[q] = threadIdx.x * 40503u + q;
    int d[4][4] = {};
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            asm volatile(
                "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+r"(d[u][0]), "+r"(d[u][1]), "+r"(d[u][2]), "+r"(d[u][3])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                  "r"(b[1]));
        }
    }
    int s = 0;
    for (int u = 0; u < 4; ++u) for (int q = 0; q < 4; ++q) s += d[u][q];
    if (s == 0x7fffffff) out[0] = s;
}

__global__ void popc64(int iters, int* out) {
    unsigned long long x = threadIdx.x * 0x9E3779B97F4A7C15ull;
    unsigned long long y[8];
    for (int q = 0; q < 8; ++q) y[q] = x ^ (q * 0x1234567ull);
    unsigned c[8] = {};
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int q = 0; q < 8; ++q) { c[q] += __popcll(x & y[q]); y[q] += c[q]; }
    }
    unsigned s = 0;
    for (int q = 0; q < 8; ++q) s += c[q];
    if (s == 0x7fffffffu) out[0] = s;
}

// Check the fragment layout: A = 16 rows x 256 bits (row-major), B = 256 x
// 8 (col-major), D[r][c] = popc(A[r] & B[:, c]).
__global__ void mma_check(const uint32_t* A, const uint32_t* B, int* D) {
    const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
    uint32_t a0 = A[g * 8 + t], a1 = A[(g + 8) * 8 + t];
    uint32_t a2 = A[g * 8 + t + 4], a3 = A[(g + 8) * 8 + t + 4];
    uint32_t b0 = B[g * 8 + t], b1 = B[g * 8 + t + 4];
    int d0 = 0, d1 = 0, d2 = 0, d3 = 0;
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d0), "+r"(d1), "+r"(d2), "+r"(d3)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    D[g * 8 + t * 2] = d0; D[g * 8 + t * 2 + 1] = d1;
    D[(g + 8) * 8 + t * 2] = d2; D[(g + 8) * 8 + t * 2 + 1] = d3;
}

int main() {
    int* out; cudaMalloc(&out, 4);
    int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
    const int iters = 20000, blocks = sms * 8, threads = 256;
    for (int rep = 0; rep < 2; ++rep) {
        cudaEventRecord(e0);
        mma_b1<<<blocks, threads>>>(iters, out);
        cudaEventRecord(e1); cudaEventSynchronize(e1);
        float ms; cudaEventElapsedTime(&ms, e0, e1);
        double mmas = (double)blocks * (threads / 32) * iters * 4;
        printf("mma b1 m16n8k256: %.3f ms, %.4g mma/s, %.4g bit-and-popc/s\n",
               ms, mmas / ms * 1e3, mmas * 16 * 8 * 256 / ms * 1e3);
        cudaEventRecord(e0);
        popc64<<<blocks, threads>>>(iters, out);
        cudaEventRecord(e1); cudaEventSynchronize(e1);
        cudaEventElapsedTime(&ms, e0, e1);
        double pops = (double)blocks * threads * iters * 8;
        printf("popc64 CUDA cores: %.3f ms, %.4g popc64/s, %.4g bit-and-popc/s\n",
               ms, pops / ms * 1e3, pops * 64 / ms * 1e3);
    }
    uint32_t hA[16 * 8], hB[8 * 8]; int hD[128];
    for (int i = 0; i < 128; ++i) hA[i] = 0x9E3779B9u * (i + 1) ^ (i * 77);
    for (int i = 0; i < 64; ++i) hB[i] = 0x85EBCA6Bu * (i + 3) ^ (i * 31);
    uint32_t *dA, *dB; int* dD;
    cudaMalloc(&dA, sizeof hA); cudaMalloc(&dB, sizeof hB); cudaMalloc(&dD, sizeof hD);
    cudaMemcpy(dA, hA, sizeof hA, cudaMemcpyHostToDevice);
    cudaMemcpy(dB, hB, sizeof hB, cudaMemcpyHostToDevice);
    mma_check<<<1, 32>>>(dA, dB, dD);
    cudaMemcpy(hD, dD, sizeof hD, cudaMemcpyDeviceToHost);
    int bad = 0;
    for (int r = 0; r < 16; ++r) for (int c = 0; c < 8; ++c) {
        int w = 0;
        for (int k = 0; k < 8; ++k) w += __builtin_popcount(hA[r * 8 + k] & hB[c * 8 + k]);
        bad += w != hD[r * 8 + c];
    }
    printf("mma b1 layout check: %d of 128 wrong; %s\n", bad,
           cudaGetErrorString(cudaGetLastError()));
    return 0;
}
